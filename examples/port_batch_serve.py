"""Serving-path demo on the port: a ColoringService micro-batching a request
stream (the counterpart of ``examples/batch_serve.py``).

    PYTHONPATH=src python examples/port_batch_serve.py [--requests 24] [--batch 16]
    PYTHONPATH=src python examples/port_batch_serve.py --device cpu --requests 6

Many users submit graphs to a shared ``repro_torch.ColoringService``; its
worker drains the bounded request queue in micro-batches, buckets requests
by ``(pow2 shape class, ColorOptions)``, and colours every bucket with one
batched call (``repro_torch.core.batch``: one K3 launch a global step, one
K2 launch a bucket's tails on the card).  Every response is validated and
equal to the per-request fused call, steady waves present no new bucket key
after the first, and a closing flood shows the backpressure contract: a
full queue rejects with a structured ``Overloaded`` instead of growing.

Telemetry comes from the service itself: ``service.metrics()`` (micro-batch
and bucket-key accounting) and ``take_spans()`` (per-request and
per-micro-batch spans from the worker loop), plus one untimed traced re-run
of the first requests for the per-super-step table.
"""
import argparse
import sys
import time

sys.path.insert(0, "src")

import repro_torch  # noqa: E402
from repro_torch.core import is_valid_coloring  # noqa: E402
from repro_torch.core.batch import color_batch_fused  # noqa: E402
from repro_torch.errors import Overloaded  # noqa: E402
from repro_torch.graphs import serving_mix  # noqa: E402
from repro_torch.launch.coloring_service import ColoringService  # noqa: E402
from repro_torch.obs.report import format_result, format_trace  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--waves", type=int, default=3)
    ap.add_argument("--scale", type=float, default=0.25)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card) or cpu (the kernels' plain versions)")
    args = ap.parse_args(argv)
    dev = args.device

    graphs = serving_mix(args.requests, scale=args.scale)
    print(f"{args.requests} coloring requests/wave x {args.waves} waves, "
          f"micro-batch window B={args.batch}, device {dev}\n")

    # ---- reference: warm per-request loop, one fused call each --------------
    for g in graphs:
        repro_torch.color(g, "fused", device=dev)
    t0 = time.perf_counter()
    loop_results = [repro_torch.color(g, "fused", device=dev) for g in graphs]
    t_loop = time.perf_counter() - t0

    with ColoringService(queue_limit=max(64, 2 * args.requests),
                         max_batch=args.batch, trace=True, device=dev) as svc:
        # ---- first wave: presents every (bucket, pow2 B) key once ------------
        for t in [svc.color(g, wait=False) for g in graphs]:
            t.wait(600)
        warm_misses = svc.metrics()["bucket_jit_misses"]

        # ---- steady waves: async bursts drain as bucketed micro-batches ------
        t0 = time.perf_counter()
        svc_results = []
        for _ in range(args.waves):
            tickets = [svc.color(g, wait=False) for g in graphs]
            svc_results.append([t.wait(600) for t in tickets])
        t_svc = (time.perf_counter() - t0) / args.waves
        m = svc.metrics()
        spans = svc.take_spans()

        # ---- overload: flood far past queue_limit, catch the rejections ------
        accepted, shed, retry_after = [], 0, 0.0
        for _ in range(4 * svc.metrics()["queue_limit"]):
            try:
                accepted.append(svc.color(graphs[0], wait=False))
            except Overloaded as e:
                shed += 1
                retry_after = e.retry_after
        for t in accepted:
            t.wait(600)

    ok = all(is_valid_coloring(g, r.colors)
             for wave in svc_results for g, r in zip(graphs, wave))
    identical = all((a.colors == b.colors).all()
                    for wave in svc_results
                    for a, b in zip(loop_results, wave))
    print(f"per-request loop : {t_loop * 1e3:8.1f} ms/wave   "
          f"{len(graphs) / t_loop:7.1f} graphs/sec")
    print(f"service          : {t_svc * 1e3:8.1f} ms/wave   "
          f"{len(graphs) / t_svc:7.1f} graphs/sec "
          f"(admission + batching + validation included)")
    print(f"all proper={ok}  identical to loop={identical}")
    colors = sorted(r.num_colors for r in svc_results[0])
    print(f"colors used per graph: min={colors[0]} max={colors[-1]}")

    # ---- service telemetry --------------------------------------------------
    mb = [e for e in spans if e.name == "serve_microbatch"]
    steady_misses = m["bucket_jit_misses"] - warm_misses
    print(f"\nservice: {m['microbatches']} micro-batches for "
          f"{m['batched_requests']} batched requests across "
          f"{len(m['buckets'])} buckets; new bucket keys after the first "
          f"wave: {steady_misses}")
    if mb:
        sizes = sorted(e.meta["B"] for e in mb)
        share = (sum(e.meta["vertices"] for e in mb)
                 / sum(e.meta["slots"] for e in mb))
        print(f"micro-batch sizes: min={sizes[0]} max={sizes[-1]} "
              f"({len(mb)} dispatches); real vertices {share:.1%} of the "
              "padded flat ids")
    print(f"overload flood: {len(accepted)} accepted, {shed} shed with "
          f"structured Overloaded (retry_after~{retry_after:.3f}s); the "
          "queue never grew past its limit")

    # ---- per-super-step table: untimed traced re-run ------------------------
    traced = color_batch_fused(graphs[: min(4, len(graphs))], trace=True,
                               device=dev)
    print("\nfirst requests, per request:")
    for i, r in enumerate(traced):
        print("  " + format_result(f"request[{i}]", r))
    print("\nrequest[0], per super-step:")
    print(format_trace(traced[0].trace))
    return ok and identical


if __name__ == "__main__":
    sys.exit(0 if main() else 1)
