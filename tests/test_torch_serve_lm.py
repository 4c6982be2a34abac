"""The port's LM serving path (prefill, decode, ``SyntheticData``,
``launch/serve_lm.py``) against ``repro``'s on the CPU.

Weights are ``repro``'s, carried into the port.  Tolerances:

* float32 logits, port against ``repro`` and the port's prefill plus
  decode against its own full forward: ``<= 1e-4`` over the real vocabulary
  (observed <= 6e-6);
* greedy tokens: equal to ``repro``'s, except where ``repro``'s top-2
  margin at that step is below twice the logits tolerance, where either
  token is accepted (the rows may then part; the later steps of that row
  are not compared);
* ``SyntheticData``: bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as repro_config
from repro.launch.serve_lm import serve_batch as repro_serve_batch
from repro.models import build_model as repro_build
from repro.training.data import SyntheticData as ReproData
from repro_torch.configs import get_config, list_archs
from repro_torch.launch.serve_lm import generate, main, serve_batch
from repro_torch.models import build_model
from repro_torch.models.convert import load_repro_params
from repro_torch.training.data import SyntheticData
from test_torch_lm_models import LOGITS_TOL, Pair, logits_err, make_batch

DECODE_ARCHS = [a for a in list_archs() if get_config(a).family != "encoder"]


@pytest.fixture(scope="module")
def pairs():
    cache = {}

    def get(arch):
        if arch not in cache:
            cache[arch] = Pair(arch)
        return cache[arch]

    return get


def teacher_forced(pair, tokens, k: int, T: int, patches=None):
    """Prefill ``tokens[:, :k]`` then decode the rest teacher-forced, in
    ``repro`` and in the port: ``(repro logits, port logits)`` per step."""
    cfg = pair.cfg
    off = cfg.n_patches if cfg.family == "vlm" else 0
    pre = {"tokens": tokens[:, :k]}
    if patches is not None:
        pre["patches"] = patches
    rpre = {n: jnp.asarray(v) for n, v in pre.items()}
    rcaches, rlg = jax.jit(pair.rmodel.prefill, static_argnums=2)(pair.params, rpre, T)
    caches, lg = pair.model.prefill(pre, T)
    out = [(np.asarray(rlg), lg.numpy())]
    dec = jax.jit(pair.rmodel.decode_step)
    for t in range(k, tokens.shape[1]):
        rcaches, rlg = dec(pair.params, rcaches, jnp.asarray(tokens[:, t:t + 1]),
                           jnp.int32(t + off))
        caches, lg = pair.model.decode_step(caches, tokens[:, t:t + 1], t + off)
        out.append((np.asarray(rlg), lg.numpy()))
    return out


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_prefill_decode_matches_repro(pairs, arch):
    """``tests/test_models.py``'s shapes (B 2, S 12, T 20): prefill 8
    tokens, decode 4, every step's logits against ``repro``'s."""
    pair = pairs(arch)
    batch = make_batch(pair.cfg, B=2, S=12, seed=1)
    steps = teacher_forced(pair, batch["tokens"], batch["tokens"].shape[1] - 4,
                           20, batch.get("patches"))
    for ref, mine in steps:
        assert np.isfinite(mine).all()
        assert logits_err(mine, ref, pair.cfg.vocab) <= LOGITS_TOL


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_prefill_decode_consistency(pairs, arch):
    """The port's own prefill plus decode logits equal its full forward's."""
    pair = pairs(arch)
    batch = make_batch(pair.cfg, B=2, S=12, seed=2)
    tokens = batch["tokens"]
    full = pair.model.forward(batch).numpy()
    k = tokens.shape[1] - 4
    off = pair.cfg.n_patches if pair.cfg.family == "vlm" else 0
    pre = {n: v for n, v in batch.items() if n != "labels"}
    pre["tokens"] = tokens[:, :k]
    caches, lg = pair.model.prefill(pre, 20)
    errs = [logits_err(lg.numpy(), full[:, k - 1], pair.cfg.vocab)]
    for t in range(k, tokens.shape[1]):
        caches, lg = pair.model.decode_step(caches, tokens[:, t:t + 1], t + off)
        errs.append(logits_err(lg.numpy(), full[:, t], pair.cfg.vocab))
    assert max(errs) <= LOGITS_TOL


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "recurrentgemma-2b"])
def test_windowed_decode_beyond_window(pairs, arch):
    """Ring-buffer caches (window 8) past the window: prefill 4 tokens,
    decode 10, against ``repro`` and against the port's full forward."""
    pair = pairs(arch)
    assert pair.cfg.window == 8
    tokens = make_batch(pair.cfg, B=1, S=14, seed=4)["tokens"]
    full = pair.model.forward({"tokens": tokens}).numpy()
    steps = teacher_forced(pair, tokens, 4, 4 + 14)
    for t, (ref, mine) in enumerate(steps[1:], start=4):
        assert logits_err(mine, ref, pair.cfg.vocab) <= LOGITS_TOL
        assert logits_err(mine, full[:, t], pair.cfg.vocab) <= LOGITS_TOL


FAMILY_ARCHS = {"dense": "qwen3-4b", "moe": "mixtral-8x22b",
                "hybrid": "recurrentgemma-2b", "rwkv": "rwkv6-1.6b",
                "encoder": "hubert-xlarge", "vlm": "internvl2-26b"}


@pytest.mark.parametrize("seed", [0, 11])
@pytest.mark.parametrize("family", sorted(FAMILY_ARCHS))
def test_synthetic_data_matches_repro(family, seed):
    """Every family's stream (tokens, VLM patches, encoder frames and
    labels), full and reduced config, bit for bit."""
    arch = FAMILY_ARCHS[family]
    for mine_cfg, ref_cfg in ((get_config(arch), repro_config(arch)),
                              (get_config(arch).reduced(), repro_config(arch).reduced())):
        assert mine_cfg.family == family
        S = 24 + mine_cfg.n_patches
        mine = SyntheticData.for_model(mine_cfg, 3, S, seed=seed)
        ref = ReproData.for_model(ref_cfg, 3, S, seed=seed)
        assert dataclasses.asdict(mine.cfg) == dataclasses.asdict(ref.cfg)
        for step in (0, 5):
            a, b = mine.batch(step), ref.batch(step)
            assert a.keys() == b.keys()
            for name in a:
                assert a[name].dtype == b[name].dtype, name
                assert np.array_equal(a[name], b[name]), name


def test_serve_batch_greedy_matches_repro():
    """``repro``'s ``serve_batch`` on qwen3-4b reduced against the port's
    ``generate`` (the loop ``serve_batch`` runs) on the same weights and
    prompts."""
    cfg, rcfg = get_config("qwen3-4b").reduced(), repro_config("qwen3-4b").reduced()
    B, P, G = 2, 8, 6
    ref = repro_serve_batch(rcfg, batch=B, prompt_len=P, gen=G, seed=0)["generated"]
    rmodel = repro_build(rcfg)
    params = rmodel.init(jax.random.PRNGKey(0))    # what repro's serve_batch uses
    model = load_repro_params(build_model(cfg, "cpu"), jax.tree.map(np.asarray, params))
    prompts = SyntheticData.for_model(cfg, B, P, seed=0).batch(0)["tokens"]
    out = generate(model, {"tokens": prompts}, prompt_len=P, gen=G)["generated"]
    assert out.shape == ref.shape == (B, G)

    # repro's logits at each generated step, for the top-2 margins
    seq = jnp.asarray(np.concatenate([prompts, ref], axis=1))
    logits = np.asarray(rmodel.forward(params, {"tokens": seq}))[:, P - 1:P - 1 + G]
    top2 = np.sort(logits, axis=-1)[..., -2:]
    margin = top2[..., 1] - top2[..., 0]
    for b in range(B):
        for t in range(G):
            if out[b, t] != ref[b, t]:
                assert margin[b, t] < 2 * LOGITS_TOL, (b, t, margin[b, t])
                break


def test_serve_driver():
    """``tests/test_system.py::test_serve_driver`` on the CPU."""
    cfg = get_config("qwen3-4b").reduced()
    out = serve_batch(cfg, batch=2, prompt_len=8, gen=6, device="cpu")
    assert out["generated"].shape == (2, 6)
    assert ((out["generated"] >= 0) & (out["generated"] < cfg.vocab)).all()
    assert out["prefill_s"] > 0 and out["decode_tok_s"] > 0
    again = serve_batch(cfg, batch=2, prompt_len=8, gen=6, device="cpu")
    assert np.array_equal(again["generated"], out["generated"])   # seeded


def test_serve_main_cpu(capsys):
    out = main(["--arch", "qwen3-4b", "--reduced", "--batch", "2",
                "--prompt-len", "8", "--gen", "5", "--device", "cpu"])
    assert out["generated"].shape == (2, 5)
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("[serve] batch=2 prefill=")
    assert lines[1].startswith("[serve] sample generation: [")


def test_device_none_needs_a_card():
    """With no ``device=`` the entry points mean the card, and raise
    without one (no CPU fallback)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    cfg = get_config("qwen3-4b").reduced()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_batch(cfg, batch=1, prompt_len=4, gen=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--arch", "qwen3-4b", "--reduced"])
    model = build_model(cfg, device="meta")     # meta allocates nothing
    assert model.device.type == "meta"
