"""Serving benchmark of the port: Poisson traffic against
``repro_torch.ColoringService`` (the counterpart of ``benchmarks/serve.py``).

    PYTHONPATH=src python benchmarks/port_serve.py                 # the card
    PYTHONPATH=src python benchmarks/port_serve.py --device cpu --scale 0.05 \\
        --requests 12

Drives the service with ``serve.py``'s phases over a heterogeneous mix —
one-shot ``color()`` calls on ``serving_mix(16, scale)`` plus streaming
churn (``apply_delta`` + ``recolor``) on four pooled sessions over
``serving_mix(4, scale)`` — and writes one JSON record:

* ``warmup``: churn rounds and async color bursts until the miss counts
  (``bucket_jit_misses`` + the sessions' engine-key misses) settle, then a
  min-of-3 capacity probe (the warm seconds a request).
* ``steady``: three open-loop Poisson phases at 12% of the probed capacity
  (60% one-shot colours, 40% churn pairs, each pair one request measured
  delta-submit → recolor-done); the median phase by p99/p50 is reported,
  every phase under ``steady_phases``.
* ``overload``: a full-speed burst past ``queue_limit``: structured
  ``Overloaded`` rejections, the queue bounded.
* ``after_warmup``: what replaces ``serve.py``'s jit-miss gate on the card:
  the bucket keys first presented after warm-up (host bookkeeping), the
  caching allocator's new segments and its retries, and the kernel
  libraries loaded (``kernels/build.py`` builds and loads at first use).
* ``traced``: one more steady phase through a second service with
  ``trace=True`` under ``torch.profiler`` (its own latencies, so tracing
  stays out of ``steady``): the card's busy share, the spans' time by
  name, and the padded-slot share of the micro-batches (real vertices over
  ``padded B × (n_max + 1)`` flat ids).
* ``direct``: one warm ``repro_torch.color(g, "fused")`` a mix graph, the
  latency a caller pays without the service.

It only times; the service's parity is held in ``tests/test_torch_service.py``
and ``chip_smoke.py``.  Every record names its device and, on the card, the
``nvidia-smi`` name and power limit; no number of a CPU run is a card
number.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import random
import statistics
import subprocess
import sys
import time

_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(_ROOT, "src"))


def _percentile(sorted_vals: list[float], q: float) -> float:
    """Nearest-rank percentile of an ascending list (q in [0, 100])."""
    if not sorted_vals:
        return 0.0
    k = max(0, min(len(sorted_vals) - 1,
                   int(round(q / 100.0 * (len(sorted_vals) - 1)))))
    return sorted_vals[k]


def _latency_summary(lat_s: list[float]) -> dict:
    lat = sorted(lat_s)
    n = len(lat)
    return {
        "requests": n,
        "p50_ms": _percentile(lat, 50) * 1e3,
        "p90_ms": _percentile(lat, 90) * 1e3,
        "p99_ms": _percentile(lat, 99) * 1e3,
        "max_ms": (lat[-1] if lat else 0.0) * 1e3,
        "mean_ms": sum(lat) / n * 1e3 if n else 0.0,
    }


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of the first card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _device_state(device) -> dict:
    """Allocator and kernel-library counters of the card (empty on the CPU)."""
    import torch

    from repro_torch.kernels import build

    if device.type != "cuda":
        return {}
    torch.cuda.synchronize(device)
    stats = torch.cuda.memory_stats(device)
    return {"segments": stats.get("segment.all.allocated", 0),
            "alloc_retries": stats.get("num_alloc_retries", 0),
            "libraries": len(build._LIBS)}


def _busy_ms(prof) -> float:
    """Device-kernel time (ms) in a profiler window."""
    from torch.autograd import DeviceType

    total = 0.0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            total += getattr(e, "self_device_time_total",
                             getattr(e, "self_cuda_time_total", 0)) / 1e3
    return total


class _Traffic:
    """The request mix of one service: one-shot colours over ``graphs`` and
    balanced churn on the pooled sessions over ``churn_graphs``."""

    def __init__(self, svc, graphs, churn_graphs, pool_size, seed):
        import numpy as np

        self.svc = svc
        self.graphs = graphs
        self.churn_graphs = churn_graphs
        self.nprng = np.random.default_rng(seed)
        self.sids = []
        for i, g in enumerate(churn_graphs[:pool_size]):
            sid = f"churn-{i}"
            svc.open_session(sid, g)
            self.sids.append(sid)
        # balanced churn: every transaction adds a fresh edge batch and
        # retires the one added two transactions earlier, so a session's m
        # and max degree stay near their opening values
        self.added = {sid: [] for sid in self.sids}

    def churn_delta(self, sid: str, edges: int) -> dict:
        n = self.churn_graphs[int(sid.split("-")[1])].n
        batch = (self.nprng.integers(0, n, edges), self.nprng.integers(0, n, edges))
        kw = {"add_edges": batch}
        pending = self.added[sid]
        pending.append(batch)
        if len(pending) > 2:
            kw["remove_edges"] = pending.pop(0)
        return kw

    def churn_round(self, edges: int):
        for g in self.graphs:
            self.svc.color(g)
        for sid in self.sids:
            self.svc.apply_delta(sid, **self.churn_delta(sid, edges))
            self.svc.recolor(sid)

    def color_burst(self, copies: int):
        for g in self.graphs:  # per graph: stays within the queue limit
            ts = [self.svc.color(g, wait=False) for _ in range(copies)]
            for t in ts:
                t.wait(600)

    def steady_phase(self, rate: float, requests: int, rng) -> dict:
        """One open-loop Poisson phase (see the module doc)."""
        from repro_torch.errors import Overloaded

        svc = self.svc
        start = svc.metrics()
        pairs, orphans = [], []
        rejected = queue_peak = submitted = 0
        late = []
        next_at = time.perf_counter()
        while submitted < requests:
            next_at += rng.expovariate(rate)
            delay = next_at - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            else:
                late.append(-delay)
            try:
                if rng.random() < 0.6:
                    t = svc.color(self.graphs[submitted % len(self.graphs)],
                                  wait=False)
                    pairs.append((t, t))
                else:
                    sid = self.sids[submitted % len(self.sids)]
                    td = svc.apply_delta(sid, wait=False,
                                         **self.churn_delta(sid, 4))
                    try:
                        pairs.append((td, svc.recolor(sid, wait=False)))
                    except Overloaded:
                        orphans.append(td)  # mutation landed, repair shed
                        raise
            except Overloaded:
                rejected += 1
            submitted += 1
            if submitted % 8 == 0:
                queue_peak = max(queue_peak, svc.metrics()["queue_depth"])
        for _, last in pairs:
            last.wait(600)
        for t in orphans:
            t.wait(600)
        end = svc.metrics()
        out = _latency_summary(
            [last.done_at - first.enqueued_at for first, last in pairs])
        out.update({
            "submitted": submitted,
            "completed": len(pairs),
            "rejected": rejected,
            "rejection_rate": rejected / max(submitted, 1),
            "rate_hz": rate,
            "queue_peak": queue_peak,
            "generator_late_ms_max": max(late, default=0.0) * 1e3,
            "failed": end["failed"] - start["failed"],
            "jit_misses_after_warmup": (end["bucket_jit_misses"]
                                        - start["bucket_jit_misses"]),
        })
        return out


def bench_serving(scale: float, *, device="cuda", pool_size: int = 4,
                  queue_limit: int = 32, max_batch: int = 8, n_graphs: int = 16,
                  sessions: int = 4, steady_requests: int = 240,
                  overload_requests: int = 96, rate_hz: float | None = None,
                  seed: int = 0) -> dict:
    """One full serving run (warm-up → steady Poisson → overload burst →
    traced window → direct calls)."""
    import repro_torch
    from repro_torch.errors import Overloaded
    from repro_torch.graphs import serving_mix
    from repro_torch.kernels.dispatch import resolve_backend

    dev = resolve_backend(None, device)
    rng = random.Random(seed)
    graphs = serving_mix(n_graphs, scale)
    churn_graphs = serving_mix(sessions, scale)
    svc = repro_torch.ColoringService(pool_size=pool_size, queue_limit=queue_limit,
                                      max_batch=max_batch, device=dev)
    doc: dict = {
        "config": {
            "pool_size": pool_size, "queue_limit": queue_limit,
            "max_batch": max_batch, "n_graphs": n_graphs,
            "sessions": min(sessions, pool_size),
            "steady_requests": steady_requests,
            "overload_requests": overload_requests, "seed": seed,
            "graph_n": [g.n for g in graphs],
            "churn_n": [g.n for g in churn_graphs],
        },
    }
    try:
        t0 = time.perf_counter()
        traffic = _Traffic(svc, graphs, churn_graphs, pool_size, seed)

        def miss_count():
            m = svc.metrics()
            return m["bucket_jit_misses"] + m["session_engine_cache_misses"]

        for edges in (1, 2, 4, 8):  # the pow2 frontier pads steady uses
            traffic.churn_round(edges)
        for copies in (1, 2, 4, 8):  # the pow2 micro-batch sizes
            traffic.color_burst(copies)
        prev, stable = miss_count(), 0
        for _ in range(12):  # until full rounds stop presenting fresh keys
            traffic.churn_round(4)
            traffic.color_burst(4)
            cur = miss_count()
            stable = stable + 1 if cur == prev else 0
            if stable >= 2:
                break
            prev = cur
        warm = svc.metrics()
        doc["warmup"] = {
            "seconds": time.perf_counter() - t0,
            "requests": warm["admitted"],
            "jit_misses": warm["bucket_jit_misses"],
            "session_engine_misses": warm["session_engine_cache_misses"],
        }

        # capacity probe: best of three warm synchronous rounds; GC stays
        # off through the steady phases so collector pauses do not pose as
        # serving tail latency
        svc.maintain()
        gc.collect()
        gc.disable()
        probe_reqs = len(graphs) + 2 * len(traffic.sids)
        cap_s = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            traffic.churn_round(4)
            cap_s = min(cap_s, (time.perf_counter() - t0) / probe_reqs)
        cap_s = max(cap_s, 1e-4)
        doc["warmup"]["probe_request_seconds"] = cap_s
        before = _device_state(dev)

        # 12% of the probed op capacity; an arrival is 1.4 ops on average
        ops_per_arrival = 0.6 * 1 + 0.4 * 2
        rate = rate_hz if rate_hz is not None else 0.12 / (ops_per_arrival * cap_s)
        phases = []
        for _ in range(3):
            phases.append(traffic.steady_phase(rate, steady_requests, rng))
            svc.maintain()  # lull-time compaction between phases
        gc.enable()
        ranked = sorted(phases, key=lambda s: s["p99_ms"] / max(s["p50_ms"], 1e-9))
        doc["steady"] = dict(ranked[1])  # the median phase by tail ratio
        doc["steady_phases"] = phases
        doc["steady"]["jit_misses_after_warmup"] = sum(
            s["jit_misses_after_warmup"] for s in phases)
        after = _device_state(dev)
        doc["after_warmup"] = {
            "bucket_jit_misses": doc["steady"]["jit_misses_after_warmup"],
            "allocator_segments": (after["segments"] - before["segments"]
                                   if after else "not measured (cpu)"),
            "alloc_retries": (after["alloc_retries"] - before["alloc_retries"]
                              if after else "not measured (cpu)"),
            "kernel_libraries_loaded": (after["libraries"] - before["libraries"]
                                        if after else "not measured (cpu)"),
        }

        # overload burst: full-speed flood past the queue limit
        burst, burst_rejected, burst_peak = [], 0, 0
        for i in range(overload_requests):
            try:
                burst.append(svc.color(graphs[i % len(graphs)], wait=False))
            except Overloaded as e:
                burst_rejected += 1
                burst_peak = max(burst_peak, e.queue_depth)
        for t in burst:
            t.wait(600)
        doc["overload"] = {
            "submitted": overload_requests,
            "completed": len(burst),
            "rejected": burst_rejected,
            "rejection_rate": burst_rejected / max(overload_requests, 1),
            "queue_peak": max(burst_peak, svc.metrics()["queue_depth"]),
            "queue_limit": queue_limit,
        }
        final = svc.metrics()
    finally:
        svc.shutdown()
    doc["metrics"] = {
        k: final[k] for k in
        ("admitted", "rejected", "completed", "failed", "evictions",
         "spills", "restores", "maintenance", "microbatches",
         "batched_requests", "slow_requests", "bucket_jit_hits",
         "bucket_jit_misses", "session_engine_cache_hits",
         "session_engine_cache_misses", "pool_occupancy")}
    doc["traced"] = _traced_window(graphs, churn_graphs, dev, rate, pool_size,
                                   queue_limit, max_batch, steady_requests, seed)
    doc["direct"] = _direct_calls(graphs, dev)
    return doc


def _traced_window(graphs, churn_graphs, dev, rate, pool_size, queue_limit,
                   max_batch, requests, seed) -> dict:
    """One steady phase through a traced service under ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import repro_torch

    svc = repro_torch.ColoringService(pool_size=pool_size, queue_limit=queue_limit,
                                      max_batch=max_batch, trace=True, device=dev)
    try:
        traffic = _Traffic(svc, graphs, churn_graphs, pool_size, seed + 1)
        traffic.churn_round(4)
        svc.take_spans()
        acts = [ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts, acc_events=True) as prof:
            t0 = time.perf_counter()
            phase = traffic.steady_phase(rate, requests, random.Random(seed + 1))
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            wall_ms = (time.perf_counter() - t0) * 1e3
        spans = svc.take_spans()
    finally:
        svc.shutdown()
    by_name: dict = {}
    for e in spans:
        agg = by_name.setdefault(e.name, {"count": 0, "ms": 0.0})
        agg["count"] += 1
        agg["ms"] += e.duration * 1e3
    mb = [e.meta for e in spans if e.name == "serve_microbatch"]
    vertices = sum(m["vertices"] for m in mb)
    slots = sum(m["slots"] for m in mb)
    busy = _busy_ms(prof) if dev.type == "cuda" else None
    return {
        "latency": phase,
        "wall_ms": wall_ms,
        "busy_ms": busy if busy is not None else "not measured (cpu)",
        "busy_share": busy / wall_ms if busy is not None else "not measured (cpu)",
        "spans": by_name,
        "microbatches": len(mb),
        "mean_batch": statistics.fmean(m["B"] for m in mb) if mb else 0.0,
        "padded_slot_share": {"real_vertices": vertices, "slots": slots,
                              "share": vertices / slots if slots else 0.0},
    }


def _direct_calls(graphs, dev) -> dict:
    """One warm direct fused call a graph (host clock, synchronized)."""
    import torch

    import repro_torch

    walls = []
    for g in graphs:
        repro_torch.color(g, "fused", device=dev)  # warm-up
        t0 = time.perf_counter()
        repro_torch.color(g, "fused", device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        walls.append((time.perf_counter() - t0) * 1e3)
    return {"calls": len(walls), "median_ms": statistics.median(walls),
            "max_ms": max(walls), "sum_ms": sum(walls)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="where the service runs (cuda: the card; cpu: the "
                         "kernels' plain versions, for a rehearsal)")
    ap.add_argument("--scale", type=float, default=40.0,
                    help="serving_mix scale (40: n 48,000-100,583)")
    ap.add_argument("--requests", type=int, default=240,
                    help="requests a steady phase")
    ap.add_argument("--rate", type=float, default=None,
                    help="steady arrival rate in Hz (default: 12%% of the "
                         "probed capacity)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("-o", "--output", default="BENCH_port_serving.json")
    args = ap.parse_args(argv)

    import torch

    device = torch.device(args.device)
    serve = bench_serving(args.scale, device=device,
                          steady_requests=args.requests, rate_hz=args.rate,
                          seed=args.seed)
    on_card = device.type == "cuda"
    doc = {"schema": 9, "scale": args.scale, "backend": "torch",
           "device": (torch.cuda.get_device_name(device) if on_card else "cpu"),
           "card": card_line() if on_card else "not measured (cpu)",
           "serve": serve}
    with open(args.output, "w") as f:
        json.dump(doc, f, indent=2, sort_keys=True)
        f.write("\n")
    s, o, a, tr = serve["steady"], serve["overload"], serve["after_warmup"], serve["traced"]
    print(f"device: {doc['device']} [{doc['card']}]")
    print(f"steady: {s['requests']} reqs @ {s['rate_hz']:.3f} Hz  p50 "
          f"{s['p50_ms']:.3f} ms  p99 {s['p99_ms']:.3f} ms  rejected "
          f"{s['rejected']}/{s['submitted']}  failed {s['failed']}")
    print(f"after warm-up: bucket misses {a['bucket_jit_misses']}, allocator "
          f"segments {a['allocator_segments']}, retries {a['alloc_retries']}, "
          f"kernel libraries loaded {a['kernel_libraries_loaded']}")
    print(f"overload: {o['rejected']}/{o['submitted']} rejected (queue peak "
          f"{o['queue_peak']}/{o['queue_limit']})")
    print(f"traced window: busy {tr['busy_share']}, padded-slot share "
          f"{tr['padded_slot_share']['share']:.4f}, p50 "
          f"{tr['latency']['p50_ms']:.3f} ms p99 {tr['latency']['p99_ms']:.3f} ms")
    print(f"direct fused calls: median {serve['direct']['median_ms']:.3f} ms")
    print(f"wrote {args.output}")
    return doc


if __name__ == "__main__":
    main()
