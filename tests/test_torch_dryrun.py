"""The port's dry run (``repro_torch.launch.dryrun``, ``op_analysis``) on the
CPU, mirroring ``tests/test_dryrun.py`` and held against ``repro``'s.

* ``analyze_step`` counts matmul FLOPs exactly as ``analyze_hlo`` counts
  dots, through unrolled loops;
* ``plan_cells``, ``_coll_bytes`` and ``collective_stats`` equal ``repro``'s;
* the CLI traces qwen3-4b's ``decode_32k`` at full size on a 2x4 mesh, as
  ``tests/test_distributed.py::test_dryrun_cell_on_tiny_mesh`` asks of
  ``repro`` (which fails there on JAX 0.9: its mesh has Explicit axes);
* the slice against ``repro``: reduced qwen3-4b, rwkv6-1.6b,
  mixtral-8x22b, deepseek-v2-236b and recurrentgemma-2b at ``train_4k``'s
  mode cut to batch 8 and sequence 64 on a 2x2 mesh (the reduced configs'
  chunk sizes would unroll 128 attention chunks a layer at 4,096).
  ``repro`` compiles for 4 host devices on a mesh of Auto axes the test
  builds; the port traces on a fake group of 4.  Per-device FLOPs agree
  within 2% (rwkv6-1.6b: 4% below, the dead products of XLA's scan;
  ``tests/dryrun_compare.py --by-op`` prints them op by op), and the MoE
  families', recurrentgemma's and rwkv6's collective bytes
  stay within 1.15x; rwkv6 with remat off, rwkv6 on 1x4 and 2x4 (a WKV
  chunk across devices' shares of the sequence), recurrentgemma with five
  heads on 2x4, a deepseek-v2 whose router the resolver leaves whole
  over "model", as at full size, and qwen3-4b and recurrentgemma at
  d_model 640 on 1x4 (F18) are held to both bounds;
* rwkv6's gap is exactly XLA's dead scan products (``rwkv6_gap``) on
  every rwkv6 cell, recurrentgemma's five-head gap and F18's 1x4 cases'
  exactly the attention product XLA adds (``XLA_RESPLIT``), and reduced
  rwkv6's decode step with its heads split and the cache's state split
  over its rows runs on local shards with ``repro``'s FLOPs;
* a batch-1 decode step at full width, one period of layers, on 16x16
  (rwkv6, recurrentgemma, mixtral: ``TOKEN_CASES``) has ``repro``'s
  per-device FLOPs exactly and its collective bytes within 1.15x;
* reduced mixtral-8x22b and deepseek-v2-236b train steps with no mesh
  (also with several chunks a layer, and the flat and scatter dispatch)
  run each MoE chunk once forward and once in the backward, and each
  attention q-chunk as often as ``repro``'s FLOP count says;
* a prefill cell at full size (qwen3-4b ``prefill_32k`` on 16x16) holds
  only each rank's share of the caches, not the global caches.

Every process group starts in a subprocess; all of them at once, in one
module-scoped fixture.
"""
import json
import math
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.launch.op_analysis import analyze_step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests"))
import dryrun_compare  # noqa: E402
import repro_dryrun_record as R  # noqa: E402

COMPARED = ("qwen3-4b", "rwkv6-1.6b", "mixtral-8x22b", "deepseek-v2-236b",
            "recurrentgemma-2b")
# port / repro per-device FLOPs at the cut cell.  rwkv6's one reduced head
# has its channels split over "model": its WKV chunk runs as XLA places
# repro's (r, k and the log-decay split, v whole), product for product,
# but for three a layer that XLA's scan runs with a zero or unused
# cotangent and autograd skips (the first chunk's state gradient, the last
# chunk's two state products; ``rwkv6_gap``): 2.38% of repro's count at two
# chunks a layer, 3.07% with remat off (PERF.md §6, tests/dryrun_compare.py
# --by-op)
BOUNDS = {arch: (1 - R.FLOPS_BOUND, 1 + R.FLOPS_BOUND) for arch in COMPARED} | {
    "rwkv6-1.6b": (0.96, 1 + R.FLOPS_BOUND)}
# port / repro per-device collective bytes at the cut cell, at most
COLLECTIVE_BOUNDS = {arch: R.COLLECTIVE_BOUND for arch in (
    "mixtral-8x22b", "deepseek-v2-236b", "recurrentgemma-2b", "rwkv6-1.6b")}
# chunked MoE loops over a sequence that "model" splits (three experts do
# not divide it, so the tokens keep that split): on 2x4 a group of 32 of
# the 64 positions spans two devices' shares, one of 16 is one share; the
# flat path's chunks of 128 tokens on 2x2 lie inside a data shard.  Each
# (mesh, config overrides, remat); per-device FLOPs within 2% of repro's
SPLIT_CASES = {
    "mixtral-2x4-group32": ((2, 4), "n_experts=3,moe_group_seq=32", True),
    "mixtral-2x4-group32-no-remat": ((2, 4), "n_experts=3,moe_group_seq=32", False),
    "mixtral-2x4-group16": ((2, 4), "n_experts=3,moe_group_seq=16", True),
    "mixtral-2x4-group16-no-remat": ((2, 4), "n_experts=3,moe_group_seq=16", False),
    "mixtral-2x2-flat": ((2, 2), "moe_group=flat,moe_chunk=128", True),
}


# cells of the faults repaired in the LM mesh half (ROADMAP Queue C), each
# (arch, mesh, config overrides, remat); per-device FLOPs within the arch's
# BOUNDS of repro's.  rwkv6 with remat off (F10); deepseek-v2 with d_model 512 (its
# router takes the data axis on d, so stays whole over "model", as at full
# size), 256 experts and a vocabulary "model" splits (F11: the router on a
# device's share of each chunk, the shared experts on the split tokens)
FAULT_CASES = {
    "rwkv6-2x2-no-remat": ("rwkv6-1.6b", (2, 2), "", False),
    "deepseek-2x2-router-whole": ("deepseek-v2-236b", (2, 2),
                                  "d_model=512,vocab=1024,n_experts=256", True),
    # F15: a WKV chunk of 32 of the 64 positions spans two devices' shares;
    # "model" factors into 2 over its positions and 2 over the head's
    # channels, as XLA places repro's chunk (rwkv6._AcrossShares)
    "rwkv6-1x4-span": ("rwkv6-1.6b", (1, 4), "", True),
    "rwkv6-2x4-span": ("rwkv6-1.6b", (2, 4), "", True),
    # F13: five heads do not divide "model" (4), so both packages split the
    # head dim; XLA re-splits one backward product of the local attention
    "recurrentgemma-2x4-5-heads": ("recurrentgemma-2b", (2, 4), "n_heads=5", True),
}
# F18: a 1x4 mesh at d_model 640 leaves the head's vocabulary (288) whole
# over "model"; the loss's logits stay on each device's share of the
# sequence (model._next_token), 8 x 16 positions, not all 8 x 63.  The
# cases are tests/repro_dryrun_record.py's (its record keeps repro's counts
# for chip_smoke.py)
F18_CASES = {key: c for key, c in R.REDUCED.items() if key.startswith("F18")}
FAULT_CASES |= {key: (c["arch"], c["mesh"], c["overrides"], True)
                for key, c in F18_CASES.items()}
# repro's per-device FLOPs less the port's where XLA's partitioner re-splits
# the local attention's backward product over the q-chunk's positions with
# the whole head dim (its "involuntary full rematerialization"), where the
# port keeps the head dim's split (ROADMAP "Not faults", F13): per q-chunk
# (2 of 32 positions, one attention layer) f32[4,5,16,64] = f32[4,5,16,16] x
# f32[4,5,16,64] (655,360) against the port's (20,32,4) x (20,4,64)
# (327,680): 2 x 327,680.  At full size on 16x16: 32 x (8.59e10 - 2.15e10).
# F18's cases split the head dim too (ten heads on 4): there XLA's backward
# runs one attention product more than the port a q-chunk of an attention
# layer, 2 x B x H x 32 x 64 x 16 = 5,242,880 (qwen3-4b's 2 layers and
# recurrentgemma-2b's 1 layer, two q-chunks each)
XLA_RESPLIT = {"recurrentgemma-2x4-5-heads": 655_360} | {key: R.GAPS[key] for key in F18_CASES}
# the rwkv6 cells held exactly: (mesh, whose record); ``compared`` is the
# 2x2 cell of COMPARED
RWKV6_CELLS = {"2x2": ((2, 2), "compared"), "2x2-no-remat": ((2, 2), "rwkv6-2x2-no-remat"),
               "1x4-span": ((1, 4), "rwkv6-1x4-span"), "2x4-span": ((2, 4), "rwkv6-2x4-span")}


def rwkv6_gap(mesh) -> int:
    """``repro``'s per-device FLOPs less the port's on reduced rwkv6-1.6b
    (2 layers, one head of K = V = 64, chunks of L = 32) at batch 8,
    sequence 64 (2 chunks): XLA's scan runs its body's backward for every
    chunk alike, so it computes three state products a layer that take a
    zero or unused cotangent and autograd skips (the first chunk's state
    gradient, the last chunk's two), 2·B·L·K·V over the devices each;
    autograd runs the bonus term's backward as two batched products of one
    lane (2·B·L·K over the devices each, a chunk) where XLA multiplies
    elementwise.  At 1x4 and 2x4: 3,145,728 - 65,536 and 1,572,864 -
    32,768."""
    data, model = mesh
    layers, chunks, B, L, K = 2, 2, 8 // data, 32, 64
    dead = 3 * layers * 2 * B * L * K * K // model
    bonus = 2 * layers * chunks * 2 * B * L * K // model
    return dead - bonus


# F16: reduced rwkv6's decode step with heads of 16 channels on 2x4 (its
# (mesh, config overrides)): "model" splits the step's heads and the
# decode cell's caches split the state's rows; the step runs on local
# shards (layers.placed_like, rwkv6._local_heads), its per-device FLOPs repro's
# (chip_smoke.py keeps the count: its host has no JAX)
DECODE_CASE = ((2, 4), "rwkv_head_dim=16")
DECODE_FLOPS = 208_896
# F17: one token (long_500k's batch 1) at full width, cut to one period of
# layers, on 16x16: every product meets its weight where the weight lies
# (layers.local_product), the decode states meet the token at one
# placement (layers.meeting); repro's per-device FLOPs exactly, and its
# collective bytes within 1.15x.  The cases are
# tests/repro_dryrun_record.py's; its record pins repro's counts
TOKEN_CASES = {key: c for key, c in R.REDUCED.items() if key.startswith("F17")}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The CLI cells and every comparison cell, started together: the
    comparison cells in three processes a package (``start_cells``), so
    JAX, torch and their setup load once a process."""
    out = tmp_path_factory.mktemp("dryrun") / "res.json"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1")
    cli = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "qwen3-4b",
         "--shape", "decode_32k", "--mesh", "single", "--mesh-shape", "2x4",
         "--out", str(out)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    pf_out = out.with_name("prefill.json")
    prefill = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "qwen3-4b",
         "--shape", "prefill_32k", "--mesh", "single", "--out", str(pf_out)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    cells = {f"compared {arch}": dict(arch=arch, shape="train_4k", mesh=(2, 2))
             for arch in COMPARED}
    cells |= {f"split {case}": dict(arch="mixtral-8x22b", shape="train_4k", mesh=mesh,
                                    remat=remat, overrides=overrides)
              for case, (mesh, overrides, remat) in SPLIT_CASES.items()}
    cells |= {f"fault {case}": dict(arch=arch, shape="train_4k", mesh=mesh, remat=remat,
                                    overrides=overrides)
              for case, (arch, mesh, overrides, remat) in FAULT_CASES.items()}
    cells |= {f"fault {key}": cell for key, cell in F18_CASES.items()}    # as recorded
    cells["decode"] = dict(arch="rwkv6-1.6b", shape="decode_32k", mesh=DECODE_CASE[0],
                           overrides=DECODE_CASE[1])
    cells |= {f"token {key}": cell for key, cell in TOKEN_CASES.items()}
    got = dryrun_compare.finish_cells(dryrun_compare.start_cells(cells))
    stdout, stderr = cli.communicate(timeout=900)
    pf_stdout, pf_stderr = prefill.communicate(timeout=900)
    return {"cli": (cli.returncode, stdout, stderr, out),
            "compared": {arch: got[f"compared {arch}"] for arch in COMPARED},
            "split": {case: got[f"split {case}"] for case in SPLIT_CASES},
            "faults": {case: got[f"fault {case}"] for case in FAULT_CASES},
            "decode": got["decode"],
            "token": {key: got[f"token {key}"] for key in TOKEN_CASES},
            "prefill": (prefill.returncode, pf_stdout, pf_stderr, pf_out)}


# ---------------------------------------------------------------------------
# the analyzer
# ---------------------------------------------------------------------------

def _meta(*shape):
    return torch.empty(shape, device="meta")


def test_analyzer_unrolled_loop():
    def f(x, w):
        for _ in range(10):
            x = x @ w
        return x

    cost = analyze_step(f, _meta(128, 128), _meta(128, 128))
    assert cost.flops == 2 * 128 ** 3 * 10


def test_analyzer_nested_loops():
    def g(x, w):
        for _ in range(4):
            for _ in range(5):
                x = x @ w
        return x

    assert analyze_step(g, _meta(64, 64), _meta(64, 64)).flops == 2 * 64 ** 3 * 20


def test_analyzer_plain_dot_and_traffic():
    cost = analyze_step(lambda a, b: a @ b, _meta(256, 512), _meta(512, 128))
    assert cost.flops == 2 * 256 * 512 * 128
    assert cost.traffic >= (256 * 512 + 512 * 128 + 256 * 128) * 4
    assert cost.peak_bytes == 256 * 128 * 4 and not cost.events


def test_analyzer_tracks_live_bytes():
    """The peak counts what is alive at once, not what was allocated."""
    def f(x):
        for _ in range(8):
            x = x * 2          # each step frees the last
        return x

    cost = analyze_step(f, _meta(1024, 1024))
    assert cost.peak_bytes == 2 * 1024 * 1024 * 4
    assert cost.flops == 0 and cost.ops == 8


# ---------------------------------------------------------------------------
# the cells and the collective arithmetic, against repro's
# ---------------------------------------------------------------------------

def test_plan_cells_counts():
    from repro.launch.dryrun import plan_cells as repro_plan_cells
    from repro_torch.launch.dryrun import SHAPES, SUBQUADRATIC, plan_cells

    import repro.launch.dryrun as rd

    cells = plan_cells()
    assert cells == repro_plan_cells()
    assert SHAPES == rd.SHAPES and SUBQUADRATIC == rd.SUBQUADRATIC
    assert len(cells) == 10 * len(SHAPES)          # 40 nominal cells
    skips = [(a, s) for a, s, sk in cells if sk]
    runs = [(a, s) for a, s, sk in cells if not sk]
    assert ("hubert-xlarge", "decode_32k") in skips
    assert ("mixtral-8x22b", "long_500k") in runs   # SWA is sub-quadratic
    assert ("qwen3-32b", "long_500k") in skips
    assert len(runs) == 32


@pytest.mark.parametrize("op", ["all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                                "collective-permute"])
def test_coll_bytes_match_repro(op):
    from repro.launch.dryrun import _coll_bytes as repro_coll_bytes
    from repro_torch.launch.dryrun import _coll_bytes

    for n in range(1, 513):
        for out_bytes in (1, 4096, 2048 * 5120 * 2):
            assert _coll_bytes(op, out_bytes, n) == repro_coll_bytes(op, out_bytes, n)


def test_collective_stats_parsing():
    """The events of ``tests/test_dryrun.py``'s three HLO lines give
    ``repro``'s numbers."""
    from repro.launch.dryrun import collective_stats as repro_stats
    from repro_torch.launch.dryrun import collective_stats

    text = """
  %ag = bf16[2048,5120]{1,0} all-gather(%x), channel_id=1, replica_groups=[16,16]<=[256], dimensions={0}
  %ar = f32[1024]{0} all-reduce(%y), channel_id=2, replica_groups=[1,256]<=[256], to_apply=%add
  %cp = f32[8,8]{1,0} collective-permute(%z), channel_id=3, source_target_pairs={{0,1}}
"""
    events = [("all-gather", 2048 * 5120 * 2, 16), ("all-reduce", 1024 * 4, 256),
              ("collective-permute", 8 * 8 * 4, 2)]
    s = collective_stats(events)
    assert s == repro_stats(text)
    assert abs(s["all-gather"]["moved_bytes"] - 2048 * 5120 * 2 * 15 / 16) < 1
    assert s["collective-permute"]["moved_bytes"] == 256


def test_roofline_reads_the_ports_records():
    """``benchmarks/roofline.py`` reads a port record's keys."""
    from benchmarks.roofline import roofline_terms

    rec = {"analysis": {"flops": 197e12, "traffic_bytes": 819e9, "collective_bytes": 50e9,
                        "collectives": {}},
           "model_flops": 197e12 * 256 * 0.5, "mesh": "single"}
    t = roofline_terms(rec)
    assert abs(t["compute_s"] - 1.0) < 1e-6 and abs(t["useful_flops_ratio"] - 0.5) < 1e-6


# ---------------------------------------------------------------------------
# the CLI and the slice against repro
# ---------------------------------------------------------------------------

def test_dryrun_cell_on_tiny_mesh(runs):
    """The port's dry-run driver traces a full-size arch on a 2x4 mesh."""
    rc, _stdout, stderr, out = runs["cli"]
    assert rc == 0, stderr[-3000:]
    rec = json.loads(out.read_text())[0]
    assert rec["ok"], rec.get("error")
    assert rec["analysis"]["flops"] > 0
    assert rec["memory"]["temp_size_in_bytes"] > 0
    assert rec["mode"] == "decode" and rec["trace_s"] > 0


def test_prefill_cell_holds_only_its_share_of_the_caches(runs):
    """qwen3-4b ``prefill_32k`` at full size on 16x16: a rank allocates its
    shard of each cache, never the global caches (155 GB, which every rank
    would otherwise hold at once).  The outputs are the local caches (plus
    the logits), and the peak of temporaries stays under a sixteenth of
    the global caches (1.98 GB against 9.7 GB, my CPU run)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import SHAPES
    from repro_torch.models.transformer import cache_layout

    rc, _stdout, stderr, out = runs["prefill"]
    assert rc == 0, stderr[-3000:]
    rec = json.loads(out.read_text())[0]
    assert rec["ok"], rec.get("error")
    info = SHAPES["prefill_32k"]
    caches = sum(math.prod(shape) * dt.itemsize for layer in cache_layout(
        get_config("qwen3-4b"), info["batch"], info["seq"]) for shape, dt in layer.values())
    mem = rec["memory"]
    devices = 16 * 16
    assert caches // devices <= mem["output_size_in_bytes"] < 2 * caches // devices
    assert 0 < mem["temp_size_in_bytes"] < caches // 16
    assert rec["analysis"]["flops"] > 0


def test_list_prints_repros_cells():
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--list"],
                       env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    lines = r.stdout.strip().splitlines()
    assert len(lines) == 40 and sum(line.endswith("run") for line in lines) == 32


@pytest.mark.parametrize("arch", COMPARED)
def test_dryrun_flops_against_repro(runs, arch):
    got = runs["compared"][arch]
    port, repro = got["port"]["flops"], got["repro"]["flops"]
    assert port > 0 and repro > 0
    lo, hi = BOUNDS[arch]
    assert lo <= port / repro <= hi, (port, repro)


@pytest.mark.parametrize("arch", sorted(COLLECTIVE_BOUNDS))
def test_dryrun_collective_bytes_against_repro(runs, arch):
    got = runs["compared"][arch]
    port, repro = got["port"]["collective_bytes"], got["repro"]["collective_bytes"]
    assert port > 0 and repro > 0
    assert port / repro <= COLLECTIVE_BOUNDS[arch], (port, repro)


@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_split_chunk_flops_against_repro(runs, case):
    """A chunk of the MoE loop is placed as ``repro``'s reshape places it
    (``moe._SeqSplit``, ``moe._flat_tokens``): each device routes,
    dispatches and combines its share of every chunk, not the whole chunk
    (ROADMAP Queue C, F5 and F6)."""
    got = runs["split"][case]
    port, repro = got["port"]["flops"], got["repro"]["flops"]
    assert port > 0 and repro > 0
    assert 0.98 <= port / repro <= 1.02, (port, repro)


@pytest.mark.parametrize("case", sorted(FAULT_CASES))
def test_fault_case_flops_against_repro(runs, case):
    """rwkv6's WKV chunk runs over its head's channels as XLA places
    ``repro``'s (F10), deepseek-v2's router whole over "model" takes a
    device's share of each chunk (F11), and the loss's logits on a 1x4
    mesh stay on a device's share of the sequence (F18: +13.97% and
    +18.88% before); collective bytes within 1.15x."""
    got = runs["faults"][case]
    port, repro = got["port"]["flops"], got["repro"]["flops"]
    assert port > 0 and repro > 0
    lo, hi = BOUNDS.get(FAULT_CASES[case][0], (0.98, 1.02))
    assert lo <= port / repro <= hi, (port, repro)
    port, repro = got["port"]["collective_bytes"], got["repro"]["collective_bytes"]
    assert 0 < port <= R.COLLECTIVE_BOUND * repro, (port, repro)


@pytest.mark.parametrize("cell", sorted(RWKV6_CELLS))
def test_rwkv6_gap_is_xlas_dead_scan_products(runs, cell):
    """rwkv6's WKV chunk has ``repro``'s products, shape for shape: inside
    a share of the sequence (2x2, F10) and across shares (1x4, 2x4, F15);
    the port's per-device FLOPs are ``repro``'s less exactly
    ``rwkv6_gap``."""
    mesh, key = RWKV6_CELLS[cell]
    got = runs["compared"]["rwkv6-1.6b"] if key == "compared" else runs["faults"][key]
    assert got["repro"]["flops"] - got["port"]["flops"] == rwkv6_gap(mesh), got


@pytest.mark.parametrize("case", sorted(XLA_RESPLIT))
def test_recurrentgemma_gap_is_xlas_resplit_product(runs, case):
    """F13 reduced, and F18's cases: where the heads do not divide
    "model", the whole gap is the attention product XLA's backward adds."""
    got = runs["faults"][case]
    assert got["repro"]["flops"] - got["port"]["flops"] == XLA_RESPLIT[case], got


def test_rwkv6_decode_step_on_local_shards(runs):
    """F16: where "model" splits the decode step's heads and the cache
    splits the state's rows, the state is moved onto the heads' split and
    back, so each layer's step runs on the local shards (which torch 2.11
    needs: its ``DTensor`` refuses the products' fold of a split batch and
    a split head dim); per-device FLOPs equal ``repro``'s."""
    got = runs["decode"]
    assert got["port"]["local_heads"] == {"_wkv_step": 2}, got["port"]
    assert got["port"]["flops"] == got["repro"]["flops"] == DECODE_FLOPS, got


@pytest.mark.parametrize("key", sorted(TOKEN_CASES))
def test_token_decode_meets_the_weights_where_they_lie(runs, key):
    """F17: a batch-1 decode step at full width on 16x16 does repro's
    per-device work, product for product, and moves no weight: its
    collective bytes stay within 1.15x of repro's (before: up to 10^3x)."""
    got = runs["token"][key]
    assert got["port"]["flops"] == got["repro"]["flops"], got
    port, repro = got["port"]["collective_bytes"], got["repro"]["collective_bytes"]
    assert 0 < port <= R.COLLECTIVE_BOUND * repro, (port, repro)


@pytest.mark.parametrize("key", sorted(R.REDUCED))
def test_record_holds_repros_reduced_counts(runs, key):
    """The record's reduced entries, which chip_smoke.py holds the port to
    on a host without JAX, are repro's per-device FLOPs of this run."""
    got = runs["token"][key] if key in TOKEN_CASES else runs["faults"][key]
    assert R.load()[key]["flops"] == got["repro"]["flops"], key


def count_chunk_calls(arch: str, seq: int = 64, batch: int = 2, **overrides) -> dict:
    """Calls of the MoE chunk functions and of ``_attend_block`` in one
    reduced train step (loss and backward) of ``arch`` on the CPU, with no
    mesh: ``{"forward": {...}, "step": {...}}``.  The functions are wrapped
    from here; the package has no switch for it."""
    import collections
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import layers, moe
    from repro_torch.models.model import build_model

    counts: collections.Counter = collections.Counter()
    saved = {}

    def wrap(mod, name):
        fn = saved[mod, name] = getattr(mod, name)

        def counted(*args, **kwargs):
            counts[name] += 1
            return fn(*args, **kwargs)

        setattr(mod, name, counted)

    cfg = dataclasses.replace(get_config(arch).reduced(), **overrides)
    model = build_model(cfg, device="cpu")
    model.reset_parameters(torch.Generator().manual_seed(0))
    rng = torch.Generator().manual_seed(1)
    batch_ = {k: torch.randint(0, cfg.vocab, v.shape, generator=rng, dtype=v.dtype)
              for k, v in model.input_specs(batch, seq).items()}
    for mod, name in ((moe, "_chunk_moe"), (moe, "_grouped_chunk_moe"),
                      (layers, "_attend_block")):
        wrap(mod, name)
    try:
        loss, _ = model.loss(batch_)
        forward = dict(counts)
        loss.backward()
    finally:
        for (mod, name), fn in saved.items():
            setattr(mod, name, fn)
    return {"forward": forward, "step": dict(counts)}


@pytest.mark.parametrize("arch,overrides", [
    ("mixtral-8x22b", {}),
    ("deepseek-v2-236b", {}),
    ("mixtral-8x22b", {"moe_group_seq": 16, "attn_q_chunk": 16}),
    ("deepseek-v2-236b", {"moe_group": "flat", "moe_chunk": 32}),
    ("mixtral-8x22b", {"moe_group": "flat", "moe_chunk": 32, "moe_dispatch": "scatter"}),
])
def test_moe_chunks_run_once_in_the_backward(arch, overrides):
    """With ``remat``, ``moe_remat`` and ``attn_chunk_remat`` on, each MoE
    chunk runs once forward and once more in the backward, as in
    ``repro``'s compiled step (the period's recompute stops before the
    chunk loop).  The q-chunked attention runs three times a chunk in a
    remat period (forward, the period's recompute, its own), as
    ``repro``'s FLOP count shows XLA keeps both recomputes, and twice in a
    plain layer (deepseek-v2's dense layer 0)."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import plan_segments

    cfg = get_config(arch).reduced()
    assert cfg.remat and cfg.moe_remat and cfg.attn_chunk_remat
    got = count_chunk_calls(arch, **overrides)
    name = "_grouped_chunk_moe" if overrides.get("moe_group", cfg.moe_group) == "seq" \
        else "_chunk_moe"
    fwd = got["forward"][name]
    assert fwd >= 1 and got["step"][name] == 2 * fwd, got
    n_attn = 64 // overrides.get("attn_q_chunk", cfg.attn_q_chunk)
    scanned = sum(len(s.specs) * s.count for s in plan_segments(cfg) if s.kind == "scan")
    plain = cfg.n_layers - scanned
    assert got["forward"]["_attend_block"] == cfg.n_layers * n_attn
    assert got["step"]["_attend_block"] == (3 * scanned + 2 * plain) * n_attn, got


def test_production_mesh():
    """``launch/mesh.py``: importing it starts nothing; over a fake group of
    256 and of 512 ranks it gives ``repro``'s shapes and axis names."""
    code = """
import torch.distributed as dist
import repro_torch.launch.mesh as M
assert not dist.is_initialized()
from torch.testing._internal.distributed.fake_pg import FakeStore
for multi in (False, True):
    shape = M.MULTI_POD_SHAPE if multi else M.POD_SHAPE
    n = 1
    for s in shape:
        n *= s
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    mesh = M.make_production_mesh(multi_pod=multi, device_type="cpu")
    print(tuple(mesh.shape), mesh.mesh_dim_names)
    dist.destroy_process_group()
"""
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=300, env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")))
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.split("\n")[:2] == ["(16, 16) ('data', 'model')",
                                        "(2, 16, 16) ('pod', 'data', 'model')"]


def test_transposition_takes_only_even_splits():
    """``layers._transposition`` moves a split between two mesh dims of one
    size as a broadcast of equal blocks only where the dim divides the mesh
    dim; an uneven split (blocks of two sizes) is left to ``DTensor``."""
    code = """
import torch, torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.models.layers import _transposition
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
for rows in (4, 3):
    t = DTensor.from_local(torch.zeros(2, 8), mesh, [Shard(0), Replicate()], run_check=False,
                           shape=torch.Size((rows, 8)), stride=(8, 1))
    print(_transposition(t, [Replicate(), Shard(0)]))
dist.destroy_process_group()
"""
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=300, env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")))
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.split("\n")[:2] == ["(1, 0)", "None"]
