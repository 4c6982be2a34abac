"""``repro``'s own results on the full-size coloring paths that
``chip_smoke.py`` runs on the card (phases 9-12), kept small in
``tests/data/repro_fullsize.json`` so that the card, whose machine has no
JAX, is held to them field for field.

Each entry holds the graph's recipe, the options, and for each graph it
colours (one; a batch's each; a session's open and each churn round) the
sha256 of the graph's ``row_offsets`` and ``col_indices`` and of the
``colors`` (little-endian int32), and ``num_colors``, ``iterations``,
``work_items``, ``padded_work``, ``class_cells`` and ``converged``.  A path
that ``repro`` cannot run on a CPU within ``TIMEOUT`` seconds is listed
with that reason instead.

Write the record (needs JAX; each path in a process of its own, ``--jobs``
at a time, ``--only`` for some keys, which are merged into the file):

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/repro_fullsize_record.py

Run the CPU port through the same entries and compare (no JAX; ``--only``
and ``--timeout`` as above):

    PYTHONPATH=src python tests/repro_fullsize_record.py --check-port

``PATHS`` is the one list of the full-size paths: ``chip_smoke.py``
imports this module (nothing of ``repro`` or JAX is imported at module
level), compares each result it computes with ``check`` and counts with
``Tally``.
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
RECORD = Path(__file__).resolve().parent / "data" / "repro_fullsize.json"
FIELDS = ("num_colors", "iterations", "work_items", "padded_work", "class_cells",
          "converged")
TIMEOUT = 900.0    # seconds a path may take
CHURN, CHURN_SEED, STREAM_ROUNDS = 0.01, 14, 4
BATCH_SEEDS = (2, 12, 22, 32)

# graph name -> (recipe, builder over a graphs namespace)
GRAPHS = {
    "rmat-er": ("rmat(1 << 20, 10.0, RMAT_ER, seed=2)",
                lambda G: G.rmat(1 << 20, 10.0, G.RMAT_ER, seed=2)),
    "rmat-g": ("rmat(1 << 20, 10.0, RMAT_G, seed=3)",
               lambda G: G.rmat(1 << 20, 10.0, G.RMAT_G, seed=3)),
    "thermal2": ("grid2d(3125, 384, diagonals=True)",
                 lambda G: G.grid2d(3125, 384, diagonals=True)),
    "kkt_power": ('build_graph("kkt_power", 21.4)',
                  lambda G: G.build_graph("kkt_power", 21.4)),
    "jacobian_band": ("jacobian_band(1 << 20, band=3)",
                      lambda G: G.jacobian_band(1 << 20, band=3)),
    "batch-rmat-er": ("rmat(1 << 20, 10.0, RMAT_ER, seed=s) for s in (2, 12, 22, 32); a "
                      "seed whose pow2 width bucket differs from seed 2's takes s + 10",
                      lambda G: batch_graphs(G)),
    "serving_mix(16, 40)": ("serving_mix(16, 40)", lambda G: G.serving_mix(16, 40)),
    "serving_mix(8, 10)": ("serving_mix(8, 10)", lambda G: G.serving_mix(8, 10)),
}


@dataclasses.dataclass(frozen=True)
class FullPath:
    """One full-size path: ``kind`` is ``color`` (``color(g, algorithm,
    **options)``), ``d2_sgr_step`` (the step driven to convergence by
    ``run_workefficient_loop``), ``batch`` (``color_batch``) or
    ``session`` (``open_session``, then ``STREAM_ROUNDS`` churn rounds)."""
    key: str
    phase: int
    kind: str
    graph: str
    algorithm: str | None = None
    options: tuple = ()


PAPER = ("rmat-er", "rmat-g", "thermal2")
PATHS = (
    *(FullPath(f"ragged {g}", 9, "color", g) for g in PAPER),
    *(FullPath(f"classic {g}", 9, "color", g, options=(("engine", "classic"),)) for g in PAPER),
    *(FullPath(f"padded {g}", 9, "color", g, options=(("engine", "padded"),)) for g in PAPER),
    FullPath("ragged kkt_power", 9, "color", "kkt_power"),
    FullPath("chunked rmat-er", 9, "color", "rmat-er", options=(("coarsen_lanes", 65536),)),
    FullPath("fused rmat-er", 9, "color", "rmat-er", options=(("mode", "fused"),)),
    FullPath("distance2 rmat-er", 10, "color", "rmat-er", "distance2"),
    FullPath("distance2 thermal2", 10, "color", "thermal2", "distance2"),
    FullPath("distance2 precomputed thermal2", 10, "color", "thermal2", "distance2",
          (("strategy", "precomputed"),)),
    FullPath("bipartite jacobian_band", 10, "color", "jacobian_band", "bipartite"),
    FullPath("d2_sgr_step rmat-er", 10, "d2_sgr_step", "rmat-er"),
    *(FullPath(f"{a} {g}", 11, "color", g, a)
      for g in PAPER for a in ("serial", "topology", "jp", "multihash", "threestep")),
    FullPath("batch four rmat-er", 12, "batch", "batch-rmat-er"),
    FullPath("serving mix", 12, "batch", "serving_mix(16, 40)"),
    FullPath("batched distance-2", 12, "batch", "serving_mix(8, 10)", "distance2"),
    *(FullPath(f"stream {g}", 12, "session", g) for g in ("rmat-g", "thermal2")),
)
BY_KEY = {p.key: p for p in PATHS}


def graphs_namespace(pkg: str):
    """The graph builders of ``pkg`` (``repro`` or ``repro_torch``)."""
    import importlib
    import types

    G = importlib.import_module(f"{pkg}.graphs")
    R = importlib.import_module(f"{pkg}.graphs.rmat")
    return types.SimpleNamespace(
        rmat=G.rmat, RMAT_ER=R.RMAT_ER, RMAT_G=R.RMAT_G, grid2d=G.grid2d,
        build_graph=G.build_graph, jacobian_band=G.jacobian_band,
        serving_mix=G.serving_mix)


def width_key(g) -> int:
    """A graph's pow2 width bucket (``core.batch._width_key``)."""
    x = max(int(g.max_degree), 1)
    return 1 << (x - 1).bit_length()


def batch_graphs(G, first=None, pending=()) -> list:
    """The four rmat-er graphs of phase 12's batch: ``first`` (seed 2) and
    seeds 12, 22, 32 (``pending``: their graphs, if built already); a
    graph outside the first's width bucket is replaced by the next seed by
    10, up to five times."""
    first = first if first is not None else G.rmat(1 << 20, 10.0, G.RMAT_ER, seed=2)
    graphs = [first]
    pending = list(pending) or [None] * (len(BATCH_SEEDS) - 1)
    for seed, g in zip(BATCH_SEEDS[1:], pending):
        g = g if g is not None else G.rmat(1 << 20, 10.0, G.RMAT_ER, seed=seed)
        for _ in range(5):
            if width_key(g) == width_key(first):
                break
            seed += 10
            g = G.rmat(1 << 20, 10.0, G.RMAT_ER, seed=seed)
        graphs.append(g)
    return graphs


# ---------------------------------------------------------------------------
# the digest of a result
# ---------------------------------------------------------------------------

def sha256_i32(*arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(np.asarray(a), dtype="<i4").tobytes())
    return h.hexdigest()


def graph_sha256(g) -> str:
    """The digest of a graph's ``row_offsets`` and ``col_indices`` (a
    bipartite pattern's rows-to-columns half: ``row_offsets`` and
    ``row_to_col``)."""
    cols = g.col_indices if hasattr(g, "col_indices") else g.row_to_col
    return sha256_i32(g.row_offsets, cols)


def item(graph, result, label: str) -> dict:
    """One coloured graph's record: digests first, then ``FIELDS``."""
    cc = getattr(result, "class_cells", None)
    return {"label": label,
            "graph_sha256": graph_sha256(graph),
            "colors_sha256": sha256_i32(result.colors),
            "num_colors": int(result.num_colors),
            "iterations": int(result.iterations),
            "work_items": int(result.work_items),
            "padded_work": int(result.padded_work),
            "class_cells": _plain(cc),
            "converged": bool(result.converged)}


def _plain(x):
    """Nested tuples of integers as JSON's nested lists."""
    if x is None or isinstance(x, (bool, str)):
        return x
    if isinstance(x, (tuple, list, np.ndarray)):
        return [_plain(v) for v in x]
    return int(x)


def first_difference(want: dict, got: dict):
    """``(field, want, got)`` of the first field that differs, the graph
    digest first, then the colours' and ``FIELDS``; None where none does."""
    for f in ("graph_sha256", "colors_sha256", *FIELDS):
        if want.get(f) != got.get(f):
            return f, want.get(f), got.get(f)
    return None


def load(path=RECORD) -> dict:
    """``{key: entry}`` of the record."""
    with open(path) as fh:
        return {e["key"]: e for e in json.load(fh)["entries"]}


class Mismatch(AssertionError):
    pass


def check(record: dict, key: str, items: list) -> bool:
    """Hold ``items`` (``item`` dicts, in the entry's order) to the record's
    entry for ``key``.  Raises ``Mismatch`` naming the path, the item, the
    first field that differs and both values; returns False where the path
    is listed without an entry (its reason recorded), True where compared."""
    entry = record.get(key)
    if entry is None:
        raise Mismatch(f"reference {key}: no entry and no reason in the record")
    if "results" not in entry:
        return False
    want = entry["results"]
    if len(want) != len(items):
        raise Mismatch(f"reference {key}: {len(items)} results against the record's "
                       f"{len(want)}")
    for w, g in zip(want, items):
        diff = first_difference(w, g)
        if diff:
            field, a, b = diff
            raise Mismatch(f"reference {key} ({w['label']}): {field} differs: record "
                           f"{a!r}, got {b!r}")
    return True


class Tally:
    """The comparisons of one phase: ``compare`` each path's items, then
    ``line()``; ``missing()`` is the phase's paths never compared."""

    def __init__(self, record: dict, phase: int):
        self.record, self.phase = record, phase
        self.compared, self.listed, self.seen = 0, 0, set()

    def compare(self, key: str, items: list):
        if BY_KEY[key].phase != self.phase:
            raise Mismatch(f"reference {key}: not a path of phase {self.phase}")
        if check(self.record, key, items):
            self.compared += 1
        else:
            self.listed += 1
        self.seen.add(key)

    def missing(self) -> list:
        return [p.key for p in PATHS if p.phase == self.phase and p.key not in self.seen]

    def line(self) -> str:
        return (f"reference: {self.compared} compared, 0 differ, {self.listed} listed "
                "without an entry")


# ---------------------------------------------------------------------------
# running a path in either package
# ---------------------------------------------------------------------------

def run_path(pkg: str, path: FullPath) -> list:
    """``path`` run by ``pkg`` (``repro`` on its default backend, or
    ``repro_torch`` on the CPU): its ``item`` dicts."""
    import importlib

    G = graphs_namespace(pkg)
    api = importlib.import_module(pkg)
    dev = {"device": "cpu"} if pkg == "repro_torch" else {}
    opts = dict(path.options)
    if path.kind == "color":
        g = GRAPHS[path.graph][1](G)
        r = api.color(g, path.algorithm, **opts, **dev)
        return [item(g, r, "graph")]
    if path.kind == "d2_sgr_step":
        g = GRAPHS[path.graph][1](G)
        return [item(g, d2_sgr_loop(pkg, g), "graph")]
    if path.kind == "batch":
        graphs = GRAPHS[path.graph][1](G)
        rs = api.color_batch(graphs, path.algorithm, **opts, **dev)
        return [item(g, r, f"graph {i}") for i, (g, r) in enumerate(zip(graphs, rs))]
    if path.kind == "session":
        churn = importlib.import_module(f"{pkg}.dynamic").churn_delta
        s = api.open_session(GRAPHS[path.graph][1](G), **dev)
        return session_items(s, churn)
    raise ValueError(path.kind)


def session_items(s, churn_delta) -> list:
    """A session's open and ``STREAM_ROUNDS`` rounds of ``CHURN`` churn
    (``default_rng(CHURN_SEED)``), each recolored: the open's colouring and
    each round's ``recolor()`` on its snapshot."""
    out = [item(s.graph, s.result, "open")]
    rng = np.random.default_rng(CHURN_SEED)
    for r in range(STREAM_ROUNDS):
        rem, add = churn_delta(s.graph, CHURN, rng)
        s.apply_delta(remove_edges=rem, add_edges=add)
        res = s.recolor()
        out.append(item(s.graph, res, f"round {r}"))
    return out


def d2_sgr_loop(pkg: str, g, max_iters: int = 1000):
    """``d2_sgr_step`` from the all-zero start over every vertex, driven by
    ``run_workefficient_loop`` (``chip_smoke.py``'s ``d2_classic``)."""
    import importlib

    core = importlib.import_module(f"{pkg}.core.coloring")
    d2 = importlib.import_module(f"{pkg}.d2")
    adj = g.padded_adjacency()
    deg = np.concatenate([g.degrees, [0]]).astype(np.int32)
    if pkg == "repro":
        import jax.numpy as xp

        adj, deg = xp.asarray(adj), xp.asarray(deg)
        colors0, wl0 = xp.zeros(g.n + 1, xp.int32), xp.arange(g.n, dtype=xp.int32)
    else:
        import torch

        adj, deg = torch.from_numpy(adj), torch.from_numpy(deg)
        colors0 = torch.zeros(g.n + 1, dtype=torch.int32)
        wl0 = torch.arange(g.n, dtype=torch.int32)

    def step(colors, wl):
        return d2.d2_sgr_step(adj, adj, deg, colors, wl, include_first_hop=True)

    colors, iters, work, padded, converged = core.run_workefficient_loop(
        step, colors0, wl0, g.n, max_iters)
    return core.ColoringResult(np.asarray(colors)[:g.n], iters, work, padded, converged,
                               algorithm="d2_sgr_step")


def _one(pkg: str, key: str):
    t = time.perf_counter()
    items = run_path(pkg, BY_KEY[key])
    print(json.dumps({"key": key, "results": items, "seconds": time.perf_counter() - t}))


def _spawn(pkg: str, key: str, timeout: float) -> dict:
    """``key`` run by ``pkg`` in a process of its own, at most ``timeout``
    seconds: ``{"key", "results", "seconds"}`` or ``{"key", "reason"}``."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    t = time.perf_counter()
    p = subprocess.Popen([sys.executable, __file__, "--one", key, "--package", pkg],
                         env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        out, err = p.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        p.kill()
        p.communicate()
        return {"key": key, "reason": f"did not finish within {timeout:.0f} s on a CPU "
                f"({os.cpu_count()} CPUs)", "seconds": time.perf_counter() - t}
    if p.returncode != 0:
        oom = re.search(r"Out of memory allocating (\d+) bytes", err)
        ram = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
        reason = (f"asks the CPU for one buffer of {int(oom.group(1)):,} bytes, past its "
                  f"{ram / 2**30:.0f} GiB (RESOURCE_EXHAUSTED)" if oom else
                  f"exit {p.returncode}: {(err.strip().splitlines() or [''])[-1][-300:]}")
        return {"key": key, "reason": reason, "seconds": time.perf_counter() - t}
    return json.loads(out.strip().splitlines()[-1])


def _describe(path: FullPath) -> dict:
    return {"key": path.key, "phase": path.phase, "kind": path.kind,
            "graph": path.graph, "recipe": GRAPHS[path.graph][0],
            "algorithm": path.algorithm or "data_driven", "options": dict(path.options)}


def write_record(keys: list, jobs: int, timeout: float):
    """Run ``keys`` through ``repro`` and merge them into ``RECORD``."""
    import jax

    entries = load() if RECORD.exists() else {}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(jobs) as pool:
        for out in pool.map(lambda k: _spawn("repro", k, timeout), keys):
            entry = _describe(BY_KEY[out["key"]])
            if "results" in out:
                entry["results"] = out["results"]
            else:
                entry["reason"] = out["reason"]
            entry["seconds"] = round(out["seconds"], 1)
            entries[out["key"]] = entry
            print(f"{out['key']:34s} {out['seconds']:8.1f} s  "
                  f"{out.get('reason') or [r['num_colors'] for r in out['results']]}",
                  flush=True)
    doc = {"generator": "tests/repro_fullsize_record.py",
           "jax": jax.__version__, "cpus": os.cpu_count(),
           "entries": [entries[p.key] for p in PATHS if p.key in entries]}
    RECORD.parent.mkdir(exist_ok=True)
    RECORD.write_text(json.dumps(doc, indent=1) + "\n")
    print(f"{len(keys)} paths in {time.perf_counter() - t0:.1f} s -> {RECORD}")


def check_port(keys: list, jobs: int, timeout: float) -> int:
    """Run ``keys`` through the CPU port and hold them to ``RECORD``."""
    record = load()
    bad = 0
    t0 = time.perf_counter()
    with ThreadPoolExecutor(jobs) as pool:
        for out in pool.map(lambda k: _spawn("repro_torch", k, timeout), keys):
            key = out["key"]
            if "results" not in out:
                verdict = f"not run: {out['reason']}"
            elif "results" not in record.get(key, {}):
                verdict = "ran; the record lists it without an entry"
            else:
                try:
                    check(record, key, out["results"])
                    verdict = "equal"
                except Mismatch as e:
                    verdict, bad = str(e), bad + 1
            print(f"{key:34s} {out['seconds']:8.1f} s  {verdict}", flush=True)
    print(f"{len(keys)} paths in {time.perf_counter() - t0:.1f} s, {bad} differ")
    return 1 if bad else 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--check-port", action="store_true")
    ap.add_argument("--only", default="", help="comma-separated keys (default: all)")
    ap.add_argument("--jobs", type=int, default=2)
    ap.add_argument("--timeout", type=float, default=TIMEOUT)
    ap.add_argument("--one", help=argparse.SUPPRESS)
    ap.add_argument("--package", default="repro", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    if args.one:
        return _one(args.package, args.one)
    keys = [k for k in args.only.split(",") if k] or [p.key for p in PATHS]
    unknown = [k for k in keys if k not in BY_KEY]
    if unknown:
        ap.error(f"unknown keys {unknown}")
    if args.check_port:
        return check_port(keys, args.jobs, args.timeout)
    write_record(keys, args.jobs, args.timeout)


if __name__ == "__main__":
    sys.exit(main())
