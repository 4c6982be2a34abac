"""The port's checkpoints, restarts and training launcher
(``repro_torch.training.checkpoint``, ``distributed/fault_tolerance.py``,
``launch/train.py``) on the CPU, mirroring ``tests/test_checkpoint.py`` and
``test_system.py``'s ``test_train_driver_cli`` and ``test_run_with_restarts``;
and a checkpoint written by ``repro`` restored into the port."""
import dataclasses
import json
import os
import signal
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.training as rtraining
from repro.configs import get_config as repro_config
from repro.models import build_model as repro_build
from repro.training.checkpoint import save_checkpoint as repro_save
from repro_torch.configs import get_config
from repro_torch.distributed.fault_tolerance import (
    install_preemption_handler,
    run_with_restarts,
)
from repro_torch.launch.train import train_loop
from repro_torch.models import build_model
from repro_torch.models.convert import load_repro_train_state, unstack_params
from repro_torch.training import AdamWConfig, SyntheticData, init_train_state, make_train_step
from repro_torch.training.checkpoint import (
    latest_step,
    list_steps,
    restore_checkpoint,
    save_checkpoint,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _state(dtype="float32", seed=0, steps=1):
    """A reduced qwen3 state after ``steps`` train steps (moments non-zero)."""
    cfg = dataclasses.replace(get_config("qwen3-4b").reduced(),
                              param_dtype=dtype, act_dtype=dtype)
    model = build_model(cfg, "cpu", generator=torch.Generator().manual_seed(seed))
    state = init_train_state(model)
    step = make_train_step(model, AdamWConfig(warmup_steps=0, total_steps=4))
    data = SyntheticData.for_model(cfg, 2, 16)
    for i in range(steps):
        state, _ = step(state, data.batch(i))
    return state


def _leaves(state):
    out = {f"params/{n}": p.detach() for n, p in state.params.items()}
    for k in ("m", "v"):
        out.update({f"opt/{k}/{n}": t for n, t in state.opt[k].items()})
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_roundtrip(tmp_path, dtype):
    """A state saved and restored into a fresh one of another seed: every
    leaf bit for bit, bfloat16 leaves carried as their uint16 bits."""
    state = _state(dtype)
    save_checkpoint(str(tmp_path), 3, state)
    got = restore_checkpoint(str(tmp_path), 3, _state(dtype, seed=1, steps=0))
    assert got.step == state.step == 1
    want = _leaves(state)
    for key, t in _leaves(got).items():
        assert t.dtype == want[key].dtype
        assert torch.equal(t, want[key]), key
    meta = json.load(open(tmp_path / "step_3" / "meta.json"))
    assert meta["step"] == 3 and "step" in meta["keys"]
    assert meta["dtypes"]["params/embed"] == dtype
    assert meta["dtypes"]["opt/m/embed"] == "float32"
    with np.load(tmp_path / "step_3" / "arrays.npz") as data:
        assert data["params/embed"].dtype == (np.uint16 if dtype == "bfloat16" else np.float32)


def test_restore_keeps_dtype_and_refuses_missing_leaves(tmp_path):
    """A bfloat16 state restored into a float32 one: each leaf keeps the
    float32 of ``like`` and holds the bfloat16 values exactly; a state with
    a leaf the checkpoint lacks raises."""
    state = _state("bfloat16")
    save_checkpoint(str(tmp_path), 1, state)
    got = restore_checkpoint(str(tmp_path), 1, _state("float32", seed=1, steps=0))
    want = _leaves(state)
    for key, t in _leaves(got).items():
        assert t.dtype == torch.float32
        assert torch.equal(t, want[key].float()), key
    cfg = get_config("qwen3-4b").reduced()
    deeper = dataclasses.replace(cfg, n_layers=cfg.n_layers + 1)
    other = init_train_state(build_model(deeper, "cpu"))
    with pytest.raises(KeyError, match=f"layers.{cfg.n_layers}"):
        restore_checkpoint(str(tmp_path), 1, other)


def test_retention_and_latest(tmp_path):
    state = {"x": torch.zeros(2)}
    for s in (1, 2, 3, 4, 5):
        save_checkpoint(str(tmp_path), s, state, keep_last=2)
    assert list_steps(str(tmp_path)) == [4, 5]
    assert latest_step(str(tmp_path)) == 5
    assert latest_step(str(tmp_path / "none")) is None


def test_atomic_no_partial_visible(tmp_path):
    save_checkpoint(str(tmp_path), 1, {"x": torch.zeros(4)})
    names = os.listdir(tmp_path)
    assert all(not n.startswith("tmp.") for n in names)
    # a stale temporary directory (a crash mid-write) is replaced, not read
    os.makedirs(tmp_path / "tmp.step_2")
    save_checkpoint(str(tmp_path), 2, {"x": torch.ones(4)})
    assert sorted(os.listdir(tmp_path)) == ["step_1", "step_2"]


def test_crash_restart_resumes_identically(tmp_path):
    """Fault tolerance: crash mid-run, resume from checkpoint, same trajectory."""
    cfg = get_config("qwen3-4b").reduced()
    ck = str(tmp_path / "ck")
    kw = dict(steps=12, batch_size=4, seq_len=16, lr=1e-3, log_every=1, seed=3,
              device="cpu")
    ref = train_loop(cfg, ckpt_dir=str(tmp_path / "ref"), ckpt_every=100, **kw)
    with pytest.raises(RuntimeError):
        train_loop(cfg, ckpt_dir=ck, ckpt_every=4, fail_at_step=8, **kw)
    assert latest_step(ck) == 8
    out = train_loop(cfg, ckpt_dir=ck, ckpt_every=4, resume=True, **kw)
    assert out["steps"] == 4
    assert abs(out["final_loss"] - ref["final_loss"]) < 1e-3


def test_run_with_restarts(tmp_path):
    cfg = get_config("qwen3-4b").reduced()
    ck = str(tmp_path / "ck")
    calls = {"n": 0}

    def run(start):
        calls["n"] += 1
        fail = 6 if calls["n"] == 1 else None   # first attempt dies at step 6
        return train_loop(cfg, steps=10, batch_size=2, seq_len=16, lr=1e-3,
                          ckpt_dir=ck, ckpt_every=3, log_every=5, seed=1,
                          resume=start > 0, fail_at_step=fail, device="cpu")

    out = run_with_restarts(run, ckpt_dir=ck, max_restarts=2)
    assert calls["n"] == 2 and out["steps"] == 4   # resumed from step 6

    def always(start):
        raise RuntimeError("down")

    with pytest.raises(RuntimeError, match="down"):
        run_with_restarts(always, ckpt_dir=ck, max_restarts=1)


def test_preemption_handler_checkpoints(tmp_path):
    saved = []
    old = signal.getsignal(signal.SIGTERM)
    try:
        install_preemption_handler(lambda: saved.append(
            save_checkpoint(str(tmp_path), 7, {"x": torch.zeros(1)})))
        with pytest.raises(SystemExit) as e:
            signal.raise_signal(signal.SIGTERM)
    finally:
        signal.signal(signal.SIGTERM, old)
    assert e.value.code == 143 and latest_step(str(tmp_path)) == 7 and saved


def _nest(flat: dict) -> dict:
    """``repro``'s ``/``-joined keys back into its tree (lists where every
    key of a level is an index)."""
    tree: dict = {}
    for key, a in flat.items():
        node = tree
        *path, last = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[last] = a

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[str(i)]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}

    return lists(tree)


def test_repro_checkpoint_restores_into_port(tmp_path):
    """A reduced float32 state trained two steps by ``repro``, saved by
    ``repro``'s ``save_checkpoint``, carried into the port: parameters and
    moments bit for bit, the step, and the next step's loss and gradient
    norm within 1e-4 relative of ``repro``'s."""
    rcfg = repro_config("qwen3-4b").reduced()
    rmodel = repro_build(rcfg)
    opt = dict(peak_lr=1e-3, warmup_steps=0, total_steps=4)
    rstep = jax.jit(rtraining.make_train_step(rmodel, rtraining.AdamWConfig(**opt)))
    cfg = get_config("qwen3-4b").reduced()
    data = SyntheticData.for_model(cfg, 2, 16, seed=5)
    state = rtraining.init_train_state(rmodel, jax.random.PRNGKey(2))
    metrics = []
    for i in range(3):
        state, m = rstep(state, {k: jnp.asarray(v) for k, v in data.batch(i).items()})
        metrics.append(m)
        if i == 1:
            repro_save(str(tmp_path), 2, jax.device_get(state))

    with np.load(tmp_path / "step_2" / "arrays.npz") as z:
        tree = _nest({k: z[k] for k in z.files})
    port = load_repro_train_state(init_train_state(build_model(cfg, "cpu")), tree)
    assert port.step == 2
    for k in ("m", "v"):
        flat = unstack_params(cfg, tree["opt"][k])
        for n, t in port.opt[k].items():
            assert torch.equal(t, torch.from_numpy(flat[n])), (k, n)
    flat = unstack_params(cfg, tree["params"])
    for n, p in port.params.items():
        assert torch.equal(p.detach(), torch.from_numpy(flat[n])), n
    _, m = make_train_step(port.model, AdamWConfig(**opt))(port, data.batch(2))
    for key in ("loss", "grad_norm"):
        want = float(metrics[2][key])
        assert abs(m[key].item() - want) <= 1e-4 * abs(want), key


def _cli(*args, tmp_path, **env):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), **env)
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *args],
        capture_output=True, text=True, env=env, timeout=600, cwd=str(tmp_path))


def test_train_driver_cli(tmp_path):
    """The launcher trains a reduced model for 20 steps from the CLI."""
    out = _cli("--arch", "qwen3-4b", "--reduced", "--steps", "20", "--batch", "4",
               "--seq", "32", "--lr", "3e-3", "--ckpt-dir", str(tmp_path / "ck"),
               "--device", "cpu", tmp_path=tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "loss=" in out.stdout
    assert (tmp_path / "ck" / "step_20").exists()
    summary = json.loads(out.stdout.strip().splitlines()[-1])
    assert summary["steps"] == 20 and summary["final_loss"] < summary["first_loss"]


def test_train_driver_cli_needs_a_card_by_default(tmp_path):
    out = _cli("--arch", "qwen3-4b", "--reduced", "--steps", "1", tmp_path=tmp_path,
               CUDA_VISIBLE_DEVICES="")
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
    assert "[train]" not in out.stdout
