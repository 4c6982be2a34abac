"""``train_loop(mesh=)``, ``reshard_state`` and ``restore_checkpoint(shardings=)``
on a 2x2 ``DeviceMesh`` of four CPU processes (gloo), held against the same
calls without a mesh.

The four ranks run in subprocesses (``torch.multiprocessing`` spawn), so no
process group outlives them or reaches another test.  Each trains reduced
qwen3-4b and reduced mixtral-8x22b (MoE) for three steps on the mesh, with a
checkpoint at the end, takes one more step-0 loss and backward on the mesh
for the gradients, prefills qwen3-4b on the mesh, then restores its
checkpoint onto a 4x1 and a 1x4 mesh.  Tolerances, those the card is held
to against the CPU (chip_smoke.py phase 16):

* step-0 loss and ``grad_norm``: relative ``1e-4``; every step finite;
* step-0 gradients, per leaf: ``max |g_mesh - g| <= 1e-4 * max |g|``;
* parameters after k = 3 steps: ``max |Δ| <= 2 * lr * k`` and ``mean |Δ| <=
  1e-3 * lr * k`` (AdamW turns a sign flip of a tiny gradient into 2 lr);
* a restored leaf equals the saved one exactly, placed as the resolver says.
"""
import os
import socket

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.training import SyntheticData, init_train_state
from repro_torch.training.checkpoint import restore_checkpoint, save_checkpoint

ARCHS = ("qwen3-4b", "mixtral-8x22b")
STEPS, BATCH, SEQ, LR = 3, 4, 16, 1e-3
TOL = 1e-4
PREFILL_T = SEQ + 4        # a cache deeper than the prompt
RESHARD = ((4, 1), (1, 4))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run(cfg, **kw):
    from repro_torch.launch.train import train_loop

    return train_loop(cfg, steps=STEPS, batch_size=BATCH, seq_len=SEQ, lr=LR, log_every=1,
                      ckpt_every=100, device="cpu", **kw)


def _step0_grads(cfg, mesh=None):
    """Step 0's loss and every gradient (whole), on ``mesh`` or without."""
    from repro_torch.distributed.sharding import (batch_shardings, distribute,
                                                  place_state, state_shardings)

    model = build_model(cfg, "cpu", generator=torch.Generator().manual_seed(0))
    batch = SyntheticData.for_model(cfg, BATCH, SEQ, seed=0).batch(0)
    if mesh is not None:
        state = init_train_state(model)
        place_state(state, state_shardings(state, mesh))
        batch = distribute({k: torch.as_tensor(v) for k, v in batch.items()},
                           batch_shardings(batch, mesh))
    with model.sharding_context():
        loss, _ = model.loss(batch)
        loss.backward()
    whole = (lambda t: t.full_tensor()) if mesh is not None else (lambda t: t)
    return (float(whole(loss).detach()),
            {n: whole(p.grad).detach() for n, p in model.named_parameters()})


def _prefill(cfg, mesh=None):
    """Prefill of a cache ``PREFILL_T`` deep on ``mesh`` (weights and batch
    placed by the resolver) or without one: the caches and the logits."""
    from repro_torch.distributed.sharding import (batch_shardings, distribute, set_parameter,
                                                  state_shardings)

    model = build_model(cfg, "cpu", generator=torch.Generator().manual_seed(0), mesh=mesh)
    batch = {"tokens": torch.as_tensor(
        SyntheticData.for_model(cfg, BATCH, SEQ, seed=0).batch(0)["tokens"])}
    if mesh is not None:
        with torch.no_grad():
            for name, sh in state_shardings(model, mesh).items():
                set_parameter(model, name, sh.place(model.get_parameter(name).detach()))
        batch = distribute(batch, batch_shardings(batch, mesh))
    return model.prefill(batch, PREFILL_T)


def _mesh_prefill(cfg, mesh) -> dict:
    """Each cache leaf of a mesh prefill: made placed as ``cache_shardings``
    says, its local shard the one ``distribute_tensor`` gives; the caches
    and logits whole."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    from repro_torch.distributed.sharding import cache_shardings

    caches, logits = _prefill(cfg, mesh)
    want = cache_shardings(caches, mesh, cfg)
    placed = all(
        isinstance(t, DTensor) and tuple(t.placements) == want[i][k].placements
        and t.to_local().shape == distribute_tensor(
            torch.zeros(t.shape, dtype=t.dtype), mesh, want[i][k].placements).to_local().shape
        for i, layer in enumerate(caches) for k, t in layer.items())
    return {"placed": placed, "logits": logits.full_tensor(),
            "caches": [{k: t.full_tensor() for k, t in layer.items()} for layer in caches]}


def _mesh_worker(rank: int, out: str, port: int):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed.fault_tolerance import reshard_state
    from repro_torch.distributed.sharding import state_shardings

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=4)
    try:
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
        res = {}
        for arch in ARCHS:
            cfg = get_config(arch).reduced()
            summary = _run(cfg, ckpt_dir=os.path.join(out, "mesh", arch), mesh=mesh)
            res[arch] = {"summary": summary, "step0": _step0_grads(cfg, mesh)}
        cfg = get_config(ARCHS[0]).reduced()
        res["prefill"] = _mesh_prefill(cfg, mesh)
        for shape in RESHARD:
            new = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
            like = init_train_state(build_model(cfg, "cpu"))
            state = reshard_state(os.path.join(out, "mesh", ARCHS[0]), STEPS, like, new)
            want = state_shardings(state, new)
            leaves = [(p, want["params"][n]) for n, p in state.params.items()] + [
                (t, want["opt"][k][n]) for k in ("m", "v") for n, t in state.opt[k].items()]
            res[shape] = {
                "placed": all(isinstance(t, DTensor) and t.device_mesh == new
                              and tuple(t.placements) == sh.placements for t, sh in leaves),
                "params": {n: p.full_tensor().detach() for n, p in state.params.items()},
                "opt": {k: {n: t.full_tensor() for n, t in state.opt[k].items()}
                        for k in ("m", "v")},
                "step": state.step,
            }
        if rank == 0:
            torch.save(res, os.path.join(out, "result.pt"))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("mesh"))
    mp.start_processes(_mesh_worker, args=(out, _free_port()), nprocs=4,
                       start_method="spawn")
    mesh = torch.load(os.path.join(out, "result.pt"), weights_only=False)
    plain = {}
    for arch in ARCHS:
        cfg = get_config(arch).reduced()
        plain[arch] = {"summary": _run(cfg, ckpt_dir=os.path.join(out, "plain", arch)),
                       "step0": _step0_grads(cfg)}
    return out, mesh, plain


def _saved(out: str, which: str, arch: str) -> dict:
    with np.load(os.path.join(out, which, arch, f"step_{STEPS}", "arrays.npz")) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_training_matches_the_run_without_a_mesh(runs, arch):
    out, mesh, plain = runs
    got, want = mesh[arch], plain[arch]
    gs, ws = got["summary"], want["summary"]
    assert gs["steps"] == ws["steps"] == STEPS
    assert np.isfinite(gs["losses"]).all() and np.isfinite(gs["grad_norms"]).all()
    assert gs["losses"][0] == pytest.approx(ws["losses"][0], rel=TOL)
    assert gs["grad_norms"][0] == pytest.approx(ws["grad_norms"][0], rel=TOL)
    (l_mesh, g_mesh), (l_plain, g_plain) = got["step0"], want["step0"]
    assert l_mesh == pytest.approx(l_plain, rel=TOL)
    assert g_mesh.keys() == g_plain.keys()
    for n, g in g_plain.items():
        assert float((g_mesh[n] - g).abs().max()) <= TOL * float(g.abs().max()), n
    a, b = _saved(out, "mesh", arch), _saved(out, "plain", arch)
    diffs = np.concatenate([np.abs(a[k].astype(np.float64) - b[k]).ravel()
                            for k in b if k.startswith("params/")])
    assert diffs.max() <= 2 * LR * STEPS and diffs.mean() <= 1e-3 * LR * STEPS


def test_mesh_prefill_places_its_caches_and_matches_the_run_without_a_mesh(runs):
    """A prefill on the 2x2 mesh makes each cache leaf already placed (its
    local shard, never the global cache) as ``cache_shardings`` says, and
    its caches and last-position logits equal the mesh-less prefill's
    within ``1e-4`` of each tensor's max."""
    _out, mesh, _ = runs
    got = mesh["prefill"]
    assert got["placed"]
    caches, logits = _prefill(get_config(ARCHS[0]).reduced())
    assert float((got["logits"] - logits).abs().max()) <= TOL * float(logits.abs().max())
    assert len(got["caches"]) == len(caches)
    for g, w in zip(got["caches"], caches):
        assert g.keys() == w.keys()
        for k, t in w.items():
            assert g[k].shape == t.shape and g[k].dtype == t.dtype
            assert float((g[k].float() - t.float()).abs().max()) <= TOL * float(
                t.float().abs().max()), k


@pytest.mark.parametrize("shape", RESHARD, ids=lambda s: f"{s[0]}x{s[1]}")
def test_reshard_state_places_the_saved_state_on_a_new_mesh(runs, shape):
    """The state saved on 2x2 restores onto 4x1 and 1x4: every leaf a
    ``DTensor`` on the new mesh with the resolver's placements, its values
    the saved ones exactly."""
    out, mesh, _ = runs
    got = mesh[shape]
    assert got["placed"]
    saved = _saved(out, "mesh", ARCHS[0])
    assert got["step"] == int(saved["step"]) == STEPS
    for n, p in got["params"].items():
        np.testing.assert_array_equal(p.numpy(), saved[f"params/{n}"])
    for k in ("m", "v"):
        for n, t in got["opt"][k].items():
            np.testing.assert_array_equal(t.numpy(), saved[f"opt/{k}/{n}"])


def test_restore_without_shardings_is_unchanged(tmp_path):
    """``restore_checkpoint`` without ``shardings`` fills plain tensors in
    place, each keeping its device and dtype."""
    cfg = get_config("qwen3-4b").reduced()
    src = init_train_state(build_model(cfg, "cpu", generator=torch.Generator().manual_seed(1)))
    src.step = 5
    save_checkpoint(str(tmp_path), 5, src)
    like = init_train_state(build_model(cfg, "cpu", generator=torch.Generator().manual_seed(2)))
    before = {n: p for n, p in like.params.items()}
    out = restore_checkpoint(str(tmp_path), 5, like)
    assert out is like and out.step == 5
    for n, p in out.params.items():
        assert p is before[n] and type(p) is torch.nn.Parameter
        assert torch.equal(p, src.params[n])
