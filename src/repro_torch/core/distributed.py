"""The sharded ragged coloring engine (port of ``repro.core.distributed``).

Several shards colour one graph.  A ``PartitionedCSR`` plan
(``core/csr.py``) gives shard ``d`` a degree-balanced contiguous vertex
range and splits it into *interior* vertices, whose colours no other shard
reads, and *boundary* vertices, the shard's halo send list.

``repro`` runs each super-step as one ``shard_map`` program over a mesh of
devices, from one controller.  The port keeps that single controller: one
call in one process, one entry of ``devices=`` per shard, each shard's
arrays on its own entry.  The same device may appear more than once
(``["cpu"] * 3`` on the CPU, ``["cuda:0"] * 4`` on one card); results
depend only on the number of shards.  A super-step is:

* **halo exchange** — every shard sends the ``(id, colour)`` pairs of its
  boundary vertices that were live in the previous step (after the
  materialized bootstrap a colour changes only on the worklist, so that set
  covers every remote read that could have gone stale).  With
  ``packed_halo_ok(n)`` a pair travels as one ``id << 16 | colour`` word.
  The sends are concatenated in shard order onto every shard's device,
  ``repro``'s ``all_gather``, and scattered into each shard's own ``(n +
  1,)`` colour view.
* **the rotated super-step per shard** — ``ragged_superstep`` once per
  degree class, every class reading the exchanged snapshot.  On the card
  that is one K3 launch a shard a class, reading the shard's CSR rows in
  place (``ShardRows.lane_source``) or its composed two-hop rows
  (``TwoHopRows`` with ``start``).  Every shard speculates against the same
  snapshot and writes disjoint slots, so a sharded step equals the
  single-device tiled step and sharded colours equal ragged colours.
* **the coordinated tail** — the live counts are read on the host once a
  step; when the total reaches the tail threshold, or the worklist stalls,
  the view is assembled from each shard's own range on ``devices[0]`` and
  the same ordered serial FirstFit as the single-device engine finishes it
  (K2 on the card).

Work accounting is ``repro``'s fused one (post-step live totals plus the
materialized bootstrap; ``padded_work`` the dispatched lanes times the tile
width at uniform per-shard capacities), so one shard reproduces
``color_data_driven(mode="fused")`` field for field, and k shards give
``repro``'s result at k devices.  ``ColoringResult.halo_bytes_per_step`` is
the halo bytes a shard receives per super-step, averaged over the run.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch.core.coloring import (
    ColoringResult,
    _device_csr,
    _dispatch_tail,
    _graph_device_cache,
    _resolve_classes,
    _stalled,
    _tiled_superstep,
    compact,
    order_tail,
    resolve_tail_threshold,
    traced_run,
)
from repro_torch.core.csr import CSRGraph, PartitionedCSR, next_pow2
from repro_torch.core.heuristics import HEURISTICS
from repro_torch.ingest import packed_gather_ok, packed_halo_ok
from repro_torch.kernels.cuda import CsrRows
from repro_torch.kernels.dispatch import resolve_backend
from repro_torch.obs.spans import jit_span, span
from repro_torch.obs.trace import (
    HostRing,
    assemble_trace,
    empty_trace,
    resolve_trace_cap,
)

__all__ = ["ShardRows", "color_distributed", "resolve_devices",
           "run_sharded_engine"]


def resolve_devices(devices, device=None, backend: str | None = None) -> list:
    """The shards' devices, one ``torch.device`` each.

    ``devices=None`` means every visible CUDA device, or ``[cpu]`` under
    ``device="cpu"``.  A list may repeat a device; it may not mix the CPU
    and a card.  ``backend=`` is validated as ``resolve_backend`` does.
    """
    if devices is None:
        dev = resolve_backend(backend, device)
        if dev.type == "cpu":
            return [dev]
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devs = [torch.device(d) for d in devices]
    if not devs:
        raise ValueError("devices= is empty; give one device per shard")
    kinds = {d.type for d in devs}
    if len(kinds) > 1:
        raise ValueError(
            f"devices= mixes the CPU and CUDA devices ({[str(d) for d in devs]}); "
            "every shard must lie on a card, or every shard on the CPU")
    if device is not None and torch.device(device).type not in kinds:
        raise ValueError(
            f"device={device!r} disagrees with devices={[str(d) for d in devs]}")
    resolve_backend(backend, devs[0])
    if devs[0].type == "cuda":
        here = torch.cuda.current_device()
        devs = [torch.device("cuda", here if d.index is None else d.index)
                for d in devs]
    return devs


class ShardRows:
    """One shard's CSR rows over GLOBAL vertex ids.

    The shard holds its own rows' ``R``/``C`` slices (``stack_shards``):
    column ids stay global, so rows index the global colour view, and a
    worklist id ``v`` reads local row ``v - start``.  Ids outside the shard
    (only the sentinel ``n`` in practice) read all-sentinel rows.

    On the card K3 reads the rows in place through ``lane_source``: a
    ``CsrRows`` over ``(n + 1,)`` row starts rebased to the shard's ``C``
    (0 before ``start``, ``R[v] - R[start]`` inside the shard, the shard's
    edge count after it), so each of the shard's ids gets exactly its row
    and every other id a row of length 0.  ``rows`` gathers ``repro``'s
    ``(w, width)`` tile (the CPU path).
    """

    def __init__(self, row_starts, col_padded, deg_loc, start: int, n: int,
                 n_loc: int, max_width: int):
        self.row_starts = row_starts    # (L+1,) int32 local offsets
        self.col_padded = col_padded    # (Mcap,) int32 GLOBAL column ids
        self.deg_loc = deg_loc          # (L+1,) int32 local degrees
        self.start = int(start)         # first owned global id
        self.n = int(n)
        self.n_loc = int(n_loc)
        self.max_width = int(max_width)

    @property
    def device(self) -> torch.device:
        return self.row_starts.device

    @functools.cached_property
    def global_row_starts(self) -> torch.Tensor:
        """``(n + 1,)`` row starts into ``col_padded`` by global id."""
        out = torch.zeros(self.n + 1, dtype=torch.int32, device=self.device)
        hi = min(self.start + self.n_loc + 1, self.n + 1)
        out[self.start:hi] = self.row_starts[:hi - self.start]
        # slots past the range hold the shard's edge count, as the padding
        # of ``row_starts`` does
        out[hi:] = self.row_starts[self.n_loc]
        return out

    def lane_source(self, width: int | None = None):
        """``(source, W)``: the shard's rows by global id (``CsrRows``) and
        the row width."""
        return (CsrRows(self.global_row_starts, self.col_padded),
                self.max_width if width is None else int(width))

    def rows(self, ids: torch.Tensor, width: int | None = None) -> torch.Tensor:
        width = self.max_width if width is None else int(width)
        lidx = ids - self.start
        safe = lidx.clamp(0, self.n_loc - 1).long()
        starts = self.row_starts[safe]
        deg = self.deg_loc[safe]
        lane = torch.arange(width, dtype=torch.int32, device=ids.device)[None, :]
        # reads clamped into ``col_padded``, as JAX clamps gathers
        idx = (starts[:, None] + lane).clamp(max=self.col_padded.shape[0] - 1)
        rows = self.col_padded[idx.long()]
        valid = (lane < deg[:, None]) & (ids < self.n)[:, None]
        return torch.where(valid, rows, self.n)


@dataclasses.dataclass
class _Shard:
    """One shard's state on its device: the provider, the ``(n + 1,)``
    colour view, the halo send list ``swl``, the class worklists, the
    boundary mask and the first owned id."""

    provider: object
    view: torch.Tensor
    swl: torch.Tensor
    wls: list
    bmask: torch.Tensor
    start: int

    @property
    def device(self) -> torch.device:
        return self.view.device


def _exchange(shards, cap_s: int, n: int, pack_halo: bool) -> None:
    """The halo exchange: every shard's first ``cap_s`` send-list entries
    and their colours, concatenated in shard order onto each shard's
    device and scattered into its view.

    Only sentinel lanes repeat an index, and every one of them writes
    colour 0 at slot ``n``, so the scatter is deterministic.
    """
    sends = []
    for sh in shards:
        ids = sh.swl[:cap_s]
        colors = sh.view[ids.long()]  # the sentinel reads slot n: colour 0
        sends.append((ids << 16) | colors if pack_halo else torch.stack([ids, colors]))
    gathered = {}
    for sh in shards:
        if sh.device not in gathered:
            gathered[sh.device] = torch.cat([s.to(sh.device) for s in sends], dim=-1)
    for sh in shards:
        got = gathered[sh.device]
        if pack_halo:
            all_ids, all_colors = got >> 16, got & 0xFFFF
        else:
            all_ids, all_colors = got[0], got[1]
        sh.view[all_ids.long()] = all_colors


def _step(shards, deg_ext, n: int, n_loc: int, tile_widths, heuristic: str,
          kind: str, pack_degrees: bool):
    """Every shard's rotated super-step over the exchanged snapshot, then
    its next send list: its still-live boundary ids.  Returns each shard's
    per-class live counts and send count, not yet read."""
    K = len(tile_widths)
    out = []
    for sh in shards:
        sh.view, sh.wls, counts = _tiled_superstep(
            sh.provider, deg_ext[sh.device], sh.view, sh.wls, widths=tile_widths,
            heuristic=heuristic, kind=kind, chunks=[1] * K,
            pack_degrees=pack_degrees)
        live = torch.cat(sh.wls) if K > 1 else sh.wls[0]
        lidx = (live - sh.start).clamp(0, n_loc - 1)
        isb = (live < n) & sh.bmask[lidx.long()]
        sh.swl, scount = compact(live, isb, sentinel=n)
        out.append(torch.stack(list(counts) + [scount]))
    return out


def _assemble(views, plan: PartitionedCSR, device) -> torch.Tensor:
    """The global ``(n + 1,)`` colours on ``device`` from the shards' views
    (each shard's own range only)."""
    out = torch.zeros(plan.n + 1, dtype=torch.int32, device=device)
    for d, view in enumerate(views):
        s, e = int(plan.starts[d]), int(plan.starts[d + 1])
        out[s:e] = view[s:e].to(device)
    return out


def _shard_providers(plan: PartitionedCSR, devices, provider_kind: str,
                     prov_np: tuple, tail_width: int, include_first_hop: bool):
    """Each shard's row provider on its device."""
    n, L = plan.n, plan.n_loc
    if provider_kind == "csr":
        row_starts, col, deg = prov_np
        return [ShardRows(torch.from_numpy(row_starts[d]).to(dev),
                          torch.from_numpy(col[d]).to(dev),
                          torch.from_numpy(deg[d]).to(dev),
                          int(plan.starts[d]), n, L, tail_width)
                for d, dev in enumerate(devices)]
    from repro_torch.d2.coloring import TwoHopRows

    adj_a_np, adj_b_np = prov_np
    adj_b = {dev: torch.from_numpy(adj_b_np).to(dev) for dev in dict.fromkeys(devices)}
    return [TwoHopRows(torch.from_numpy(adj_a_np[d]).to(dev), adj_b[dev],
                       include_first_hop, start=int(plan.starts[d]), n_colored=n)
            for d, dev in enumerate(devices)]


def run_sharded_engine(
    *,
    plan: PartitionedCSR,
    devices,
    provider_kind: str,
    prov_np: tuple,
    deg_ext_np: np.ndarray,
    classes: list,
    tile_widths: list,
    acc_widths: list,
    tail_width: int,
    tail_provider,
    heuristic: str = "degree",
    kind: str = "bitset",
    tail_enabled: bool = True,
    tail_threshold: int = 0,
    max_iters: int,
    algorithm: str,
    pack_degrees: bool = False,
    include_first_hop: bool = True,
    providers=None,
    trace=False,
) -> ColoringResult:
    """Drive the sharded super-step to convergence.

    ``classes`` are the GLOBAL degree-class id arrays (wide-first, as in
    ``run_ragged_engine``); they are split per shard along the plan's
    ranges, so the union worklist, and with it every colour, live count
    and tail decision, is the single-device engine's.  ``prov_np`` holds
    the stacked per-shard provider arrays (``plan.stack_shards`` for
    ``"csr"``, ``(stacked first hop, whole second hop)`` for ``"twohop"``);
    ``providers`` may give the shards' providers already on their devices.
    ``tail_provider`` lies on ``devices[0]``.

    With ``trace`` each super-step records ``repro``'s telemetry row with
    the two sharded columns: ``halo_bytes`` (the entries a shard received
    this step × entry bytes × shards) and ``imbalance`` (max − min
    per-shard live count).  ``max_color`` is read off every shard's view
    and may include a stale remote entry mid-run; the final row is exact.
    """
    if heuristic not in HEURISTICS:
        raise ValueError(
            f"unknown heuristic {heuristic!r}; options: {HEURISTICS}")
    n, ndev, L = plan.n, plan.ndev, plan.n_loc
    K = len(classes)
    if len(devices) != ndev:
        raise ValueError(f"the plan has {ndev} shards for {len(devices)} devices")
    dev0 = devices[0]

    # ---- split classes per shard (uniform caps, sentinel padding) ---------
    owner_of = plan.owners()
    wls_np, caps = [], []
    counts = np.zeros((ndev, K), np.int64)
    for k, cls in enumerate(classes):
        own = owner_of[cls]
        groups = [cls[own == d] for d in range(ndev)]
        cap = max(max((g.size for g in groups), default=0), 1)
        arr = np.full((ndev, cap), n, np.int32)
        for d, g_ids in enumerate(groups):
            arr[d, : g_ids.size] = g_ids
            counts[d, k] = g_ids.size
        wls_np.append(arr)
        caps.append(cap)

    # ---- placement --------------------------------------------------------
    if providers is None:
        providers = _shard_providers(plan, devices, provider_kind, prov_np,
                                     tail_width, include_first_hop)
    deg_ext = {dev: torch.from_numpy(deg_ext_np).to(dev)
               for dev in dict.fromkeys(devices)}
    bmask = plan.boundary_masks()
    # bootstrap identity: every real vertex takes colour 1, a constant every
    # shard already agrees on, so the first step needs no exchange
    boot = torch.ones(n + 1, dtype=torch.int32)
    boot[n] = 0
    shards = [
        _Shard(providers[d], boot.to(dev, copy=True),
               torch.full((1,), n, dtype=torch.int32, device=dev),
               [torch.from_numpy(a[d]).to(dev) for a in wls_np],
               torch.from_numpy(bmask[d]).to(dev), int(plan.starts[d]))
        for d, dev in enumerate(devices)
    ]
    scounts = np.zeros(ndev, np.int64)

    cells_per_step = sum(ndev * caps[k] * acc_widths[k] for k in range(K))
    total = int(counts.sum())
    prev = total
    iters = 1  # the materialized bootstrap
    work = 0   # post-step live totals (fused accounting)
    padded = 0
    halo_bytes = 0
    stalled = False
    pack_halo = packed_halo_ok(n)  # id and colour both provably fit 15/16 bits
    halo_entry_bytes = 4 if pack_halo else 8
    trace_cap = resolve_trace_cap(trace, max_iters)
    rows = HostRing(trace_cap) if trace_cap else None
    if rows is not None:
        # the materialized bootstrap: everyone takes colour 1, nothing retires
        rows.append(total, 0, total, 1, 0)
    with span("superstep_loop", mode="sharded", ndev=ndev):
        while total > 0 and iters < max_iters:
            if tail_enabled and total <= tail_threshold:
                break
            if tail_enabled and _stalled(iters, total, prev):
                stalled = True
                break
            prev = total
            cap_s = min(next_pow2(max(int(scounts.max(initial=0)), 1)),
                        int(shards[0].swl.shape[0]))
            with jit_span("superstep", ("sharded_step", provider_kind, n, L,
                                        ndev, tuple(tile_widths), heuristic,
                                        kind, pack_degrees, pack_halo,
                                        cap_s)):
                _exchange(shards, cap_s, n, pack_halo)
                pending = _step(shards, deg_ext, n, L, tile_widths, heuristic,
                                kind, pack_degrees)
            read = torch.stack([p.to(dev0) for p in pending]).cpu().numpy()
            counts = read[:, :K].astype(np.int64)
            scounts = read[:, K].astype(np.int64)
            # received per shard: ndev × cap_s halo entries (padded lanes too)
            step_halo = halo_entry_bytes * ndev * cap_s
            halo_bytes += step_halo
            iters += 1
            new_total = int(counts.sum())
            if rows is not None:
                per_shard = counts.sum(axis=1)
                max_color = torch.stack(
                    [sh.view.max().to(dev0) for sh in shards]).max()
                rows.append(total, total - new_total, new_total, max_color,
                            cells_per_step, 0, step_halo,
                            int(per_shard.max() - per_shard.min()))
            total = new_total
            work += total
            padded += cells_per_step

    converged = total == 0
    views = [sh.view for sh in shards]
    if total > 0 and iters < max_iters and tail_enabled:
        # coordinated tail: the survivors gathered to one device, one
        # ordered serial FirstFit pass over the assembled colours
        with span("serial_tail", live=total, stalled=stalled):
            colors_ext = _assemble(views, plan, dev0)
            deg0 = deg_ext[dev0]
            if stalled:
                tail = torch.arange(n, dtype=torch.int32, device=dev0)
            else:
                tail = torch.cat([sh.wls[k].to(dev0) for k in range(K)
                                  for sh in shards])
            tail_wl = order_tail(tail, deg0)
            colors_ext = _dispatch_tail(tail_provider, colors_ext, tail_wl,
                                        width=tail_width)
        work += n if stalled else total
        tail_cells = int(tail_wl.shape[0]) * tail_width
        padded += tail_cells
        iters += 1
        converged = True
        colors = colors_ext[:n].cpu().numpy()
        if rows is not None:
            rows.append(total, total, 0, int(colors.max(initial=0)),
                        tail_cells, 1)
    else:
        colors = _assemble(views, plan, dev0)[:n].cpu().numpy()
    result = ColoringResult(
        colors, iters, work + n, padded, converged, algorithm=algorithm,
        halo_bytes_per_step=halo_bytes / max(iters, 1),
    )
    if rows is not None:
        result.trace = assemble_trace(rows.rows(), iters, trace_cap,
                                      f"{algorithm}:sharded")
    return result


def color_distributed(
    g: CSRGraph,
    *,
    devices=None,
    heuristic: str = "degree",
    firstfit: str = "bitset",
    buckets: tuple = (),
    tiling="auto",
    tail_serial="auto",
    max_iters: int | None = None,
    trace=False,
    device=None,
) -> ColoringResult:
    """Colour ``g`` with the sharded engine, one shard per entry of
    ``devices``.

    Equal to single-device ``color_data_driven`` in colours and iterations
    (any engine or mode) by the snapshot argument above, and to ``repro``'s
    ``color_distributed`` at the same shard count in every field.
    ``devices=None`` means every visible CUDA device (``[cpu]`` under
    ``device="cpu"``).  Runs the whole sharded machinery even on one
    device; ``color(g, engine="sharded")`` is what takes the ragged fused
    engine there.
    """
    if heuristic not in HEURISTICS:
        raise ValueError(
            f"unknown heuristic {heuristic!r}; options: {HEURISTICS}")
    devices = resolve_devices(devices, device)
    ndev = len(devices)
    n = g.n
    if n == 0:
        result = ColoringResult(np.zeros(0, np.int32), 0, 0, 0, True,
                                algorithm=f"sharded_sgr_{ndev}dev")
        if trace:
            result.trace = empty_trace(f"sharded_sgr_{ndev}dev")
        return result
    max_iters = max_iters or n + 1

    def run():
        with span("partition_plan", ndev=ndev):
            plan = _graph_device_cache(
                g, f"plan{ndev}", None, lambda: PartitionedCSR.from_graph(g, ndev))
            classes, widths = _resolve_classes(g.degrees, buckets, tiling)
        dmax = max(g.max_degree, 1)
        with span("csr_build", engine="sharded"):
            prov_np = _graph_device_cache(
                g, f"shards{ndev}", None, lambda: plan.stack_shards(g))
            providers = _graph_device_cache(
                g, f"shardrows{ndev}", tuple(devices),
                lambda: _shard_providers(plan, devices, "csr", prov_np, dmax,
                                         True))
            tail_provider = _device_csr(g, devices[0])
        deg_ext_np = np.concatenate(
            [g.degrees, np.zeros(1, np.int32)]).astype(np.int32)
        tail_enabled, thr = resolve_tail_threshold(tail_serial, n)
        return run_sharded_engine(
            plan=plan, devices=devices, provider_kind="csr", prov_np=prov_np,
            deg_ext_np=deg_ext_np, classes=classes, tile_widths=widths,
            acc_widths=widths, tail_width=dmax, tail_provider=tail_provider,
            heuristic=heuristic, kind=firstfit, tail_enabled=tail_enabled,
            tail_threshold=thr, max_iters=max_iters,
            algorithm=f"sharded_sgr_{ndev}dev",
            pack_degrees=packed_gather_ok(dmax), providers=providers,
            trace=trace,
        )

    return traced_run(run, trace)
