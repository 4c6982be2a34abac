"""The port's training path (``repro_torch.training``: AdamW, the train
state and step; remat in ``models/``) against ``repro``'s on the CPU.

``repro``'s initial train state is carried into the port
(``models/convert.py:load_repro_train_state``); each family's reduced config
runs through ``repro`` once, in a module-scoped fixture (one jit: the init,
``jax.value_and_grad`` of ``Model.loss`` on the first batch, and three steps
of ``make_train_step`` in a ``lax.scan``).  Batches: ``SyntheticData``,
batch 2, sequence 64 (q-chunked attention, two RWKV-6 chunks, two MoE
chunks).  Tolerances, set before the first run:

* ``adamw_update`` against ``repro``'s: ``<= 1e-6`` absolute on parameters
  and moments, float32 and bfloat16 trees (the same float32 arithmetic in the
  same order);
* step-0 loss and every step's loss and ``grad_norm``: relative ``1e-4``;
* step-0 gradients, per leaf: ``max |g_port - g_repro| <= 1e-4 * max
  |g_repro|``, every family;
* parameters after k = 3 steps: ``max |Δ| <= 2 * lr * k`` and ``mean |Δ| <=
  1e-3 * lr * k``.  AdamW's first steps amplify sign noise: at step 1
  ``m̂ / (sqrt(v̂) + eps)`` is ``±1`` for every non-zero gradient, so a
  gradient of 1e-9 whose sign differs between the packages moves a parameter
  by ``2 * lr``; such elements are rare, so the mean stays far below it.
"""
import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.training as rtraining
from repro.configs import get_config as repro_config
from repro.models import build_model as repro_build
from repro.training.optimizer import adamw_update as repro_adamw_update
from repro.training.optimizer import cosine_lr as repro_cosine_lr
import repro_torch.models.transformer as transformer
import repro_torch.training as training
from repro_torch.configs import get_config
from repro_torch.launch.train import train_loop
from repro_torch.models import build_model
from repro_torch.models.convert import load_repro_train_state, unstack_params
from repro_torch.training import (
    AdamWConfig,
    SyntheticData,
    adamw_init,
    adamw_update,
    init_train_state,
    make_train_step,
)
from repro_torch.training.optimizer import cosine_lr

FAMILIES = ["qwen3-4b", "mixtral-8x22b", "deepseek-v2-236b", "rwkv6-1.6b",
            "recurrentgemma-2b", "internvl2-26b", "hubert-xlarge"]
# held against repro here; the other four in test_torch_train_families.py
# (repro's compiles take ~80 s for the seven; each file stays near 40 s)
PARITY_HERE = ["qwen3-4b", "deepseek-v2-236b", "rwkv6-1.6b"]
LR = 1e-3
STEPS = 3
OPT = dict(peak_lr=LR, warmup_steps=0, total_steps=STEPS)
REL_TOL = 1e-4
ADAMW_TOL = 1e-6
MEAN_PARAM_TOL = 1e-3 * LR * STEPS


def rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


# ---------------------------------------------------------------------------
# optimizer math against a numpy oracle and against repro
# ---------------------------------------------------------------------------

def test_adamw_matches_numpy_reference():
    cfg = AdamWConfig(peak_lr=1e-2, warmup_steps=0, total_steps=100,
                      weight_decay=0.1, clip_norm=1e9)
    p = {"w": torch.tensor(np.linspace(-1, 1, 6).reshape(2, 3), dtype=torch.float32)}
    g = {"w": torch.full((2, 3), 0.5)}
    opt = adamw_init(p)
    new_p, new_opt, stats = adamw_update(p, g, opt, 0, cfg)

    lr = float(cosine_lr(0, cfg))
    m = 0.1 * 0.5
    v = 0.05 * 0.25
    mh = m / (1 - 0.9)
    vh = v / (1 - 0.95)
    w = np.linspace(-1, 1, 6).reshape(2, 3)
    want = w - lr * (mh / (np.sqrt(vh) + cfg.eps) + 0.1 * w)
    np.testing.assert_allclose(new_p["w"].numpy(), want, rtol=1e-5)
    np.testing.assert_allclose(float(stats["grad_norm"]), np.sqrt((0.5 ** 2) * 6),
                               rtol=1e-5)
    assert new_p is p and new_opt is opt     # updated in place


def test_grad_clipping():
    cfg = AdamWConfig(clip_norm=0.1, warmup_steps=0, total_steps=10)
    p = {"w": torch.ones(4)}
    g = {"w": torch.full((4,), 100.0)}
    _, new_opt, stats = adamw_update(p, g, adamw_init(p), 0, cfg)
    scale = 0.1 / float(stats["grad_norm"])
    np.testing.assert_allclose(new_opt["m"]["w"].numpy(), 0.1 * 100.0 * scale, rtol=1e-4)


def test_cosine_schedule_shape():
    cfg = AdamWConfig(peak_lr=1.0, warmup_steps=10, total_steps=100,
                      min_lr_ratio=0.1)
    lrs = [float(cosine_lr(s, cfg)) for s in (0, 5, 10, 55, 100)]
    assert lrs[0] == 0.0
    assert abs(lrs[1] - 0.5) < 1e-6
    assert abs(lrs[2] - 1.0) < 1e-6
    assert 0.1 < lrs[3] < 1.0
    assert abs(lrs[4] - 0.1) < 1e-6


def test_cosine_lr_matches_repro():
    for cfg in (AdamWConfig(), AdamWConfig(peak_lr=3e-3, warmup_steps=3, total_steps=30)):
        rcfg = rtraining.AdamWConfig(**dataclasses.asdict(cfg))
        for s in (0, 1, 2, 3, 7, 29, 30, 99, 100, 5000, 10_000, 20_000):
            mine = cosine_lr(torch.tensor(s, dtype=torch.int32), cfg)
            assert mine.dtype == torch.float32
            assert abs(float(mine) - float(repro_cosine_lr(jnp.int32(s), rcfg))) <= \
                1e-7 * cfg.peak_lr


def _tree(rng, dtype):
    shapes = {"a": (3, 4), "b.c": (5,), "b.d": (2, 3, 4), "e": (7, 1)}
    return {n: rng.standard_normal(s).astype(np.float32) for n, s in shapes.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_repro(dtype):
    """Three updates of a random tree (gradients large enough to clip),
    parameters and moments equal to ``repro``'s within 1e-6."""
    rng = np.random.default_rng(11)
    cfg = AdamWConfig(peak_lr=1e-2, warmup_steps=1, total_steps=5)
    rcfg = rtraining.AdamWConfig(**dataclasses.asdict(cfg))
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    init = _tree(rng, dtype)
    p = {n: torch.from_numpy(a).to(tdt) for n, a in init.items()}
    rp = {n: jnp.asarray(a).astype(jdt) for n, a in init.items()}
    opt, ropt = adamw_init(p), rtraining.adamw_init(rp)
    upd = jax.jit(repro_adamw_update, static_argnums=(4,))
    for step in range(3):
        g = {n: (3.0 * rng.standard_normal(a.shape)).astype(np.float32) for n, a in init.items()}
        _, _, stats = adamw_update(p, {n: torch.from_numpy(a).to(tdt) for n, a in g.items()},
                                   opt, step, cfg)
        rp, ropt, rstats = upd(rp, {n: jnp.asarray(a).astype(jdt) for n, a in g.items()},
                               ropt, jnp.int32(step), rcfg)
        assert float(rstats["grad_norm"]) > cfg.clip_norm
        assert abs(float(stats["grad_norm"]) - float(rstats["grad_norm"])) <= \
            1e-6 * float(rstats["grad_norm"])
        assert rel(float(stats["lr"]), float(rstats["lr"])) <= 1e-6   # cos: 1 ulp
        for n in init:
            assert p[n].dtype == tdt and opt["m"][n].dtype == torch.float32
            np.testing.assert_allclose(p[n].float().numpy(),
                                       np.asarray(rp[n], np.float32), rtol=0, atol=ADAMW_TOL)
            for k in ("m", "v"):
                np.testing.assert_allclose(opt[k][n].numpy(), np.asarray(ropt[k][n]),
                                           rtol=0, atol=ADAMW_TOL)


def test_adamw_missing_gradient_is_zero():
    cfg = AdamWConfig(warmup_steps=0, total_steps=10)
    p = {"w": torch.ones(3), "b": torch.ones(2)}
    q = {n: t.clone() for n, t in p.items()}
    adamw_update(p, {"w": torch.ones(3), "b": None}, adamw_init(p), 0, cfg)
    adamw_update(q, {"w": torch.ones(3), "b": torch.zeros(2)}, adamw_init(q), 0, cfg)
    assert all(torch.equal(p[n], q[n]) for n in p)


def test_training_exports_repro_names_in_order():
    assert training.__all__[:len(rtraining.__all__)] == rtraining.__all__
    assert {"SyntheticConfig", "SyntheticData"} <= set(training.__all__)
    for name in training.__all__:
        assert getattr(training, name) is not None


# ---------------------------------------------------------------------------
# each family against repro: step-0 gradients and three train steps
# ---------------------------------------------------------------------------

class Run:
    """``repro``'s reduced ``arch``: the initial state, the step-0 loss,
    metrics and gradients, and three train steps, in one jit."""

    def __init__(self, arch: str):
        self.cfg = get_config(arch).reduced()
        rmodel = repro_build(repro_config(arch).reduced())
        data = SyntheticData.for_model(self.cfg, 2, 64, seed=1)
        self.batches = [data.batch(i) for i in range(STEPS)]
        step = rtraining.make_train_step(rmodel, rtraining.AdamWConfig(**OPT))

        def ref(key, batches):
            state = rtraining.init_train_state(rmodel, key)
            (loss, metrics), grads = jax.value_and_grad(
                lambda p: rmodel.loss(p, batches[0]), has_aux=True)(state["params"])
            stacked = jax.tree.map(lambda *x: jnp.stack(x), *batches)
            final, ms = jax.lax.scan(step, state, stacked)
            return state, loss, metrics, grads, ms, final

        out = jax.jit(ref)(jax.random.PRNGKey(7),
                           [{k: jnp.asarray(v) for k, v in b.items()} for b in self.batches])
        (self.state0, self.loss0, self.metrics0, grads, self.metrics,
         final) = jax.tree.map(np.asarray, out)
        self.grads0 = unstack_params(self.cfg, grads)
        self.final = unstack_params(self.cfg, final["params"])

    def port_state(self):
        model = build_model(self.cfg, "cpu")
        return load_repro_train_state(init_train_state(model), self.state0)


@pytest.fixture(scope="module")
def runs():
    cache = {}

    def get(arch):
        if arch not in cache:
            cache[arch] = Run(arch)
        return cache[arch]

    return get


@pytest.mark.parametrize("arch", PARITY_HERE)
def test_step0_gradients_match_repro(runs, arch):
    check_step0_gradients(runs(arch))


@pytest.mark.parametrize("arch", PARITY_HERE)
def test_train_steps_match_repro(runs, arch):
    check_train_steps(runs(arch))


def check_step0_gradients(run):
    """``Model.loss`` and its backward against ``jax.value_and_grad`` of
    ``repro``'s, leaf by leaf: every leaf of ``repro``'s tree has a port
    gradient, and the model holds no plain tensor that would be learned."""
    state = run.port_state()
    model = state.model
    assert list(model.buffers()) == []
    loss, metrics = model.loss(run.batches[0])
    loss.backward()
    assert rel(loss.item(), float(run.loss0)) <= REL_TOL
    for k in ("ce", "lb_loss", "z_loss"):
        assert abs(metrics[k].item() - float(run.metrics0[k])) <= REL_TOL * (1 + abs(float(run.metrics0[k])))
    assert metrics["tokens"].item() == int(run.metrics0["tokens"])
    params = state.params
    assert sorted(params) == sorted(run.grads0)
    for name, p in params.items():
        assert p.grad is not None, name
        want = run.grads0[name]
        err = float(np.abs(p.grad.numpy() - want).max())
        assert err <= REL_TOL * float(np.abs(want).max()), (name, err)


def check_train_steps(run):
    """Three steps of ``make_train_step`` against ``repro``'s jitted ones:
    every metric, then the parameters within the AdamW allowance."""
    state = run.port_state()
    step = make_train_step(state.model, AdamWConfig(**OPT))
    for i, batch in enumerate(run.batches):
        state, metrics = step(state, batch)
        assert set(metrics) == set(run.metrics)
        assert rel(metrics["loss"].item(), float(run.metrics["loss"][i])) <= REL_TOL
        assert rel(metrics["grad_norm"].item(), float(run.metrics["grad_norm"][i])) <= REL_TOL
        assert rel(float(metrics["lr"]), float(run.metrics["lr"][i])) <= 1e-6
        assert all(p.grad is None for p in state.model.parameters())   # freed
    assert state.step == STEPS
    diffs = np.concatenate([np.abs(p.detach().numpy() - run.final[n]).ravel()
                            for n, p in state.params.items()])
    assert diffs.max() <= 2 * LR * STEPS, diffs.max()
    assert diffs.mean() <= MEAN_PARAM_TOL, diffs.mean()


def test_load_repro_train_state_rejects_bad_trees(runs):
    run = runs("qwen3-4b")
    state = run.port_state()
    assert state.step == 0
    bad = jax.tree.map(lambda a: a, run.state0)
    bad["opt"]["m"]["final_norm"]["extra"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="opt/m"):
        load_repro_train_state(state, bad)
    bad = jax.tree.map(lambda a: a, run.state0)
    bad["opt"]["v"]["lm_head"] = np.zeros((3, 3), np.float32)
    with pytest.raises(ValueError, match="shape"):
        load_repro_train_state(state, bad)
    bad = jax.tree.map(lambda a: a, run.state0)
    del bad["params"]["embed"]
    with pytest.raises(ValueError, match="missing"):
        load_repro_train_state(state, bad)


def test_train_step_rejects_another_model():
    cfg = get_config("qwen3-4b").reduced()
    a, b = build_model(cfg, "cpu"), build_model(cfg, "cpu")
    step = make_train_step(a, AdamWConfig())
    with pytest.raises(ValueError, match="another model"):
        step(init_train_state(b), SyntheticData.for_model(cfg, 2, 8).batch(0))


# ---------------------------------------------------------------------------
# remat
# ---------------------------------------------------------------------------

def _grads(cfg, batch):
    model = build_model(cfg, "cpu", generator=torch.Generator().manual_seed(4))
    loss, _ = model.loss(batch)
    loss.backward()
    return loss.item(), {n: p.grad for n, p in model.named_parameters()}


@pytest.mark.parametrize("arch", FAMILIES)
def test_remat_gradients_equal(arch):
    """``remat``, ``moe_remat`` and ``attn_chunk_remat`` on (each period
    of a scanned segment, each MoE chunk and each attention q-chunk
    recomputed in the backward; a plain segment's layer is not, as in
    ``repro``) against all three off: the same loss and gradients, bit for
    bit."""
    on = get_config(arch).reduced()
    assert on.remat and on.moe_remat and on.attn_chunk_remat
    off = dataclasses.replace(on, remat=False, moe_remat=False, attn_chunk_remat=False)
    batch = SyntheticData.for_model(on, 2, 64, seed=2).batch(0)
    real = transformer.checkpoint
    with mock.patch.object(transformer, "checkpoint", side_effect=real) as spy:
        loss_on, g_on = _grads(on, batch)
    periods = sum(s.count for s in transformer.plan_segments(on) if s.kind == "scan")
    assert spy.call_count == periods
    loss_off, g_off = _grads(off, batch)
    assert loss_on == loss_off
    for n in g_off:
        assert torch.equal(g_on[n], g_off[n]), n


def test_serving_modes_do_not_recompute():
    """Only mode ``train`` with gradients on checkpoints; the forward, the
    serving paths and a loss under ``no_grad`` run as before, and mode
    ``train`` refuses caches."""
    cfg = get_config("qwen3-4b").reduced()
    model = build_model(cfg, "cpu")
    batch = SyntheticData.for_model(cfg, 2, 16).batch(0)
    with mock.patch.object(transformer, "checkpoint") as spy:
        model.forward(batch)
        caches, _ = model.prefill({"tokens": batch["tokens"][:, :8]}, 16)
        model.decode_step(caches, batch["tokens"][:, 8:9], 8)
        with torch.no_grad():
            model.loss(batch)
    assert spy.call_count == 0
    x = torch.zeros(2, 4, cfg.d_model)
    with pytest.raises(ValueError, match="no cache"):
        transformer.apply_stack(model.layers, x, cfg, torch.arange(4), "train",
                                caches=model.init_cache(2, 4))


# ---------------------------------------------------------------------------
# the loop
# ---------------------------------------------------------------------------

def test_loss_decreases_quick():
    """30 steps on the synthetic affine-recurrence language -> loss drops."""
    cfg = get_config("qwen3-4b").reduced()
    out = train_loop(cfg, steps=30, batch_size=8, seq_len=32, lr=3e-3,
                     log_every=5, device="cpu")
    assert out["final_loss"] < out["first_loss"] - 0.3, out["losses"]
    assert out["steps"] == 30 and len(out["losses"]) == 6


def test_train_loop_device_none_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_loop(get_config("qwen3-4b").reduced(), steps=1, batch_size=1, seq_len=8)
