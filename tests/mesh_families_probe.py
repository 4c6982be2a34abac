"""Every architecture's reduced config on a 2x2 ``DeviceMesh`` of four CPU
processes (gloo), weights and batch placed by the resolver, the model built
with the mesh (its constraints on): one loss and backward, one prefill and
one decode step, each against the same path without a mesh.  Prints one
line per (architecture, path): the largest error relative to a tensor's max
(loss, every gradient, the logits), or the error raised and the port's
innermost frame, so a torch version that refuses a ``DTensor`` view shows
every site at once.  ``tests/test_torch_mesh_families.py`` holds every
path to 1e-4; the script imports no JAX, so it also runs where the card is.

    PYTHONPATH=src python tests/mesh_families_probe.py [--archs a,b]
"""
from __future__ import annotations

import argparse
import os
import socket
import sys
import tempfile
import traceback

import torch
import torch.multiprocessing as mp

BATCH, SEQ = 4, 16


def _where(exc: BaseException) -> str:
    frames = [f for f in traceback.extract_tb(exc.__traceback__) if "repro_torch" in f.filename]
    site = f"{frames[-1].filename.split('src/')[-1]}:{frames[-1].lineno}" if frames else "?"
    return f"{type(exc).__name__} at {site}: {str(exc).splitlines()[0][:300]}"


def _model(cfg, mesh=None):
    from repro_torch.distributed.sharding import set_parameter, state_shardings
    from repro_torch.models import build_model

    model = build_model(cfg, "cpu", generator=torch.Generator().manual_seed(0), mesh=mesh)
    if mesh is not None:
        with torch.no_grad():
            for name, sh in state_shardings(model, mesh).items():
                set_parameter(model, name, sh.place(model.get_parameter(name).detach()))
    return model


def _whole(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _rel(got, want) -> float:
    """max |got - want| over max |want|."""
    got, want = _whole(got).detach().float(), want.detach().float()
    return float((got - want).abs().max() / want.abs().max().clamp(min=1e-30))


def _paths(arch: str, mesh):
    """Each path on the mesh against the same path without one; returns
    the worst relative error it saw."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import batch_shardings, distribute
    from repro_torch.training import SyntheticData

    cfg = get_config(arch).reduced()
    model, plain = _model(cfg, mesh), _model(cfg)
    raw = SyntheticData.for_model(cfg, BATCH, SEQ, seed=0).batch(0)
    whole = {k: torch.as_tensor(v) for k, v in raw.items()}
    batch = distribute(whole, batch_shardings(whole, mesh))

    def loss():
        value, _ = model.loss(batch)
        with model.sharding_context():
            value.backward()
        want, _ = plain.loss(whole)
        want.backward()
        grads = dict(plain.named_parameters())
        return max([_rel(value, want.detach())] + [
            _rel(p.grad, grads[n].grad) for n, p in model.named_parameters()])

    def serve():
        if cfg.family == "encoder":
            return None
        prompt = {k: v for k, v in batch.items() if k != "labels"}
        caches, logits = model.prefill(prompt, SEQ + 4)
        want_caches, want_logits = plain.prefill(
            {k: v for k, v in whole.items() if k != "labels"}, SEQ + 4)
        token = torch.zeros((BATCH, 1), dtype=torch.int32)
        placed = distribute({"token": token}, batch_shardings({"token": token}, mesh))["token"]
        _, step = model.decode_step(caches, placed, SEQ)
        _, want_step = plain.decode_step(want_caches, token, SEQ)
        V = cfg.vocab                          # past it: the -1e30 of padding
        return max(_rel(_whole(logits)[..., :V], want_logits[..., :V]),
                   _rel(_whole(step)[..., :V], want_step[..., :V]))

    return {"loss+backward": loss, "prefill+decode": serve}


def _worker(rank: int, port: int, archs: list, out: str):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=4)
    res = {}
    try:
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
        for arch in archs:
            try:
                paths = _paths(arch, mesh)
            except Exception as exc:   # noqa: BLE001 - the probe reports every failure
                res[(arch, "build")] = _where(exc)
                continue
            for name, fn in paths.items():
                try:
                    res[(arch, name)] = fn()
                except Exception as exc:   # noqa: BLE001
                    res[(arch, name)] = _where(exc)
                    # a failed collective leaves the ranks out of step
                    dist.barrier()
    finally:
        if rank == 0:
            torch.save(res, out)
        dist.destroy_process_group()


def run(archs) -> dict:
    """``{(arch, path): worst relative error, None (no such path) or the
    error raised}`` from four ranks (spawned, so no process group outlives
    them)."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "probe.pt")
        mp.start_processes(_worker, args=(port, list(archs), out), nprocs=4,
                           start_method="spawn")
        return torch.load(out)


def main(argv=None):
    from repro_torch.configs import list_archs

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--archs", default=",".join(list_archs()))
    args = ap.parse_args(argv)
    print(f"torch {torch.__version__}", flush=True)
    for (arch, name), got in run(args.archs.split(",")).items():
        what = ("no such path (an encoder)" if got is None else got if isinstance(got, str)
                else f"ran; max rel. err {got:.3g}")
        print(f"{arch} {name}: {what}")


if __name__ == "__main__":
    sys.exit(main())
