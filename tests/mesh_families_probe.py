"""Every architecture's reduced config on a 2x2 ``DeviceMesh`` of four CPU
processes (gloo), weights and batch placed by the resolver, the model built
with the mesh (its constraints on): one loss and backward, one prefill and
one decode step, each against the same path without a mesh.  Prints one
line per (architecture, path): the largest error relative to a tensor's max
(loss, every gradient, the logits), or the error raised and the port's
innermost frame, so a torch version that refuses a ``DTensor`` view shows
every site at once.  ``CASES`` adds configs and meshes beyond the ten
families' (named ``arch:case``; ``--archs`` takes them too).
``tests/test_torch_mesh_families.py`` holds every path to 1e-4; the
script imports no JAX, so it also runs where the card is.

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


def _paths(arch: str, mesh, overrides=None, seq: int = SEQ, rows: int = BATCH,
           placed_caches: bool = False):
    """Each path on the mesh against the same path without one (``rows``
    rows of ``seq`` positions); returns the worst relative error it saw.  With
    ``placed_caches`` the decode step reads the prefill's caches placed as
    ``cache_shardings`` places a decode cell's, not as the prefill left
    them."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import batch_shardings, distribute
    from repro_torch.training import SyntheticData

    cfg = dataclasses.replace(get_config(arch).reduced(), **(overrides or {}))
    model, plain = _model(cfg, mesh), _model(cfg)
    raw = SyntheticData.for_model(cfg, rows, seq, seed=0).batch(0)
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
        caches, logits = model.prefill(prompt, seq + 4)
        if placed_caches:
            from repro_torch.distributed.sharding import cache_shardings

            caches = [{k: t.redistribute(mesh, sh[k].placements) for k, t in layer.items()}
                      for layer, sh in zip(caches, cache_shardings(caches, mesh, cfg))]
        want_caches, want_logits = plain.prefill(
            {k: v for k, v in whole.items() if k != "labels"}, seq + 4)
        token = torch.zeros((rows, 1), dtype=torch.int32)
        placed = distribute({"token": token}, batch_shardings({"token": token}, mesh))["token"]
        _, step = model.decode_step(caches, placed, seq)
        _, want_step = plain.decode_step(want_caches, token, seq)
        V = cfg.vocab                          # past it: the -1e30 of padding
        return max(_rel(_whole(logits)[..., :V], want_logits[..., :V]),
                   _rel(_whole(step)[..., :V], want_step[..., :V]))

    return {"loss+backward": loss, "prefill+decode": serve}


# cases beyond each family's reduced config on 2x2: {name: (arch, config
# overrides, mesh shape[, sequence[, rows]])}.  Three experts do not divide "model", so the
# grouped MoE's chunks keep the sequence's split (``moe._SeqSplit``): on
# 1x4 a chunk of 8 of the 16 positions spans two devices' shares, one of 4
# lies in one share; the flat path on 2x2 relays its tokens over the data
# axis (``moe._flat_tokens``).  deepseek-v2 with d_model 512 takes its
# router whole over "model" (the resolver gives the data axis to d), so the
# router runs on each device's share of a chunk (``moe._router``) and the
# shared experts, their d_ff whole there, on the split tokens: on 1x4 a
# chunk of 8 spans two shares, on 2x2 the chunk is the sequence.  rwkv6 at
# 64 positions on 2x2: each WKV chunk of 32 lies in a share of the
# sequence, so v comes whole over the head's split channels; with heads of
# 16 channels "model" splits the heads, as at full size, and each chunk
# runs on the local shards (``rwkv6._local_heads``).  rwkv6 at 64 positions
# on 1x4: a chunk spans two devices' shares, so "model" factors into two
# over its positions and two over the head's channels
# (``rwkv6._AcrossShares``).  ``PLACED_CACHES``: the decode step reads its
# caches placed as a decode cell's, the state's rows split where the step
# splits the heads (``layers.placed_like``).  recurrentgemma with three heads
# on 2x2: "model" splits the head dim, which the attention's output
# gathers before its heads merge (``transformer._merged_heads``), as at full
# size (ten heads on 16).  ``:token`` cases decode one row (a batch-1 step:
# each token meets the weights where they lie, ``layers.local_product``) at
# d_model 512, where the weights split their rows over "data", from caches
# placed as a decode cell's; ``rwkv6-1.6b:batch-decode`` decodes four rows
# there (the decay LoRA whole over "model" splits its columns); F18's
# qwen3-4b at d_model 640 on 1x4 keeps its loss's logits on each device's
# share of the sequence (``model._next_token``).
CASES = {
    "mixtral-8x22b:split-span": ("mixtral-8x22b", {"n_experts": 3, "moe_group_seq": 8}, (1, 4)),
    "mixtral-8x22b:split-share": ("mixtral-8x22b", {"n_experts": 3, "moe_group_seq": 4},
                                  (1, 4)),
    "mixtral-8x22b:flat": ("mixtral-8x22b", {"moe_group": "flat", "moe_chunk": 16}, (2, 2)),
    "deepseek-v2-236b:router-span": ("deepseek-v2-236b",
                                     {"d_model": 512, "moe_group_seq": 8}, (1, 4)),
    "deepseek-v2-236b:router-2x2": ("deepseek-v2-236b", {"d_model": 512}, (2, 2)),
    "rwkv6-1.6b:chunk-in-share": ("rwkv6-1.6b", None, (2, 2), 64),
    "rwkv6-1.6b:heads": ("rwkv6-1.6b", {"rwkv_head_dim": 16}, (2, 2), 64),
    "rwkv6-1.6b:chunk-span": ("rwkv6-1.6b", None, (1, 4), 64),
    "rwkv6-1.6b:decode-cache": ("rwkv6-1.6b", {"rwkv_head_dim": 16}, (1, 4), 64),
    "recurrentgemma-2b:split-head-dim": ("recurrentgemma-2b", {"n_heads": 3}, (2, 2)),
    "rwkv6-1.6b:token": ("rwkv6-1.6b", {"d_model": 512}, (2, 2), SEQ, 1),
    "recurrentgemma-2b:token": ("recurrentgemma-2b", {"d_model": 512}, (2, 2), SEQ, 1),
    "mixtral-8x22b:token": ("mixtral-8x22b", {"d_model": 512}, (2, 2), SEQ, 1),
    "rwkv6-1.6b:batch-decode": ("rwkv6-1.6b", {"d_model": 512}, (2, 2)),
    "qwen3-4b:1x4-d640": ("qwen3-4b", {"d_model": 640, "n_heads": 10, "head_dim": 64},
                          (1, 4)),
}
PLACED_CACHES = {"rwkv6-1.6b:decode-cache", "rwkv6-1.6b:token", "recurrentgemma-2b:token",
                 "mixtral-8x22b:token", "rwkv6-1.6b:batch-decode"}


def _worker(rank: int, port: int, archs: list, out: str):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=4)
    res = {}
    meshes = {}
    try:
        for arch in archs:
            base, overrides, shape, *seq = CASES.get(arch, (arch, None, (2, 2)))
            if shape not in meshes:
                meshes[shape] = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
            try:
                paths = _paths(base, meshes[shape], overrides, *seq,
                               placed_caches=arch in PLACED_CACHES)
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
    ap.add_argument("--archs", default=",".join(list_archs() + list(CASES)))
    args = ap.parse_args(argv)
    print(f"torch {torch.__version__}", flush=True)
    for (arch, name), got in run(args.archs.split(",")).items():
        what = ("no such path (an encoder)" if got is None else got if isinstance(got, str)
                else f"ran; max rel. err {got:.3g}")
        print(f"{arch} {name}: {what}")


if __name__ == "__main__":
    sys.exit(main())
