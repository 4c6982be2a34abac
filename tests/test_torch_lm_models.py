"""The port's LM configs and models (``repro_torch.configs``, ``models``)
against ``repro``'s on the CPU.

Floats are compared at a tolerance, with ``repro``'s own weights carried into
the port (``models/convert.py``): JAX's and torch's random streams differ.
Each architecture's reduced config is initialised in ``repro`` once, in a
module-scoped fixture, and shared by the cases.  Tolerances:

* float32 logits: ``|port - repro| <= 1e-4`` over the real vocabulary
  (logits are O(1); observed <= 2.1e-5, RWKV-6 at S = 64);
* float32 losses (``loss``, ``ce``, ``lb_loss``, ``z_loss``): relative and
  absolute 1e-5;
* bfloat16 logits: ``<= 0.15``, about ten bfloat16 steps at the logits'
  magnitude (|logit| < 4, where a step is 2^-6; observed <= 0.071); the
  bfloat16 loss: relative 2e-3 (observed <= 3.4e-4).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as repro_config
from repro.configs import list_archs as repro_archs
from repro.models import build_model as repro_build
from repro_torch.configs import get_config, list_archs
from repro_torch.models import build_model
from repro_torch.models.convert import load_repro_params, unstack_params

ARCHS = repro_archs()
KEY = jax.random.PRNGKey(7)
LOGITS_TOL = 1e-4
LOSS_TOL = 1e-5
BF16_LOGITS_TOL = 0.15
BF16_LOSS_RTOL = 2e-3
PARAMS = {  # jax.eval_shape of repro's init, full configs
    "qwen3-4b": 4_412_079_616, "rwkv6-1.6b": 1_583_941_632,
    "recurrentgemma-2b": 3_038_753_280, "hubert-xlarge": 945_277_440,
    "granite-3-8b": 8_374_259_712, "starcoder2-15b": 15_956_127_744,
    "internvl2-26b": 19_869_014_016, "qwen3-32b": 32_763_433_984,
    "mixtral-8x22b": 140_630_071_296, "deepseek-v2-236b": 235_741_434_880,
}


class Pair:
    """One reduced architecture in both packages with the same weights.
    ``refs``: sequence lengths whose ``repro`` forward and loss on
    ``make_batch(cfg, S=S, seed=S)`` are computed with the init, in one
    compile (``reference``)."""

    def __init__(self, arch: str, refs=()):
        self.rcfg = repro_config(arch).reduced()
        self.cfg = get_config(arch).reduced()
        self.rmodel = model = repro_build(self.rcfg)
        batches = [make_batch(self.cfg, S=S, seed=S) for S in refs]

        def run(key, bs):
            p = model.init(key)
            return p, [(model.forward(p, b), model.loss(p, b)) for b in bs]

        self.params, outs = jax.jit(run)(
            KEY, [{k: jnp.asarray(v) for k, v in b.items()} for b in batches])
        self._refs = {S: (b, *host_outputs(out))
                      for S, b, out in zip(refs, batches, outs)}
        self.model = build_model(self.cfg, "cpu")
        load_repro_params(self.model, jax.tree.map(np.asarray, self.params))

    def reference(self, S: int):
        """``(batch, logits, loss, metrics)`` of ``repro`` at length S."""
        return self._refs[S]

    def variant(self, **replace) -> "Pair":
        """The same weights under another routing or dtype setting."""
        other = object.__new__(Pair)
        other.rcfg = dataclasses.replace(self.rcfg, **replace)
        other.cfg = dataclasses.replace(self.cfg, **replace)
        other.rmodel = repro_build(other.rcfg)
        shapes = jax.eval_shape(other.rmodel.init, KEY)
        other.params = jax.tree.map(lambda a, s: a.astype(s.dtype),
                                    self.params, shapes)
        other.model = build_model(other.cfg, "meta").to_empty(device="cpu")
        load_repro_params(other.model, jax.tree.map(np.asarray, other.params))
        return other


@pytest.fixture(scope="module")
def pairs():
    cache = {}

    def get(arch):
        if arch not in cache:
            cache[arch] = Pair(arch, refs=(16, 64))
        return cache[arch]

    return get


def make_batch(cfg, B=2, S=16, seed=0):
    """numpy inputs from a seed: tokens (and labels), VLM patches, or
    encoder frames with frame labels."""
    rng = np.random.default_rng(seed)
    if cfg.family == "encoder":
        return {"frames": rng.standard_normal((B, S, cfg.d_frontend), np.float32),
                "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    s_text = S - (cfg.n_patches if cfg.family == "vlm" else 0)
    tokens = rng.integers(0, cfg.vocab, (B, s_text)).astype(np.int32)
    b = {"tokens": tokens, "labels": tokens.copy()}
    if cfg.family == "vlm":
        b["patches"] = rng.standard_normal((B, cfg.n_patches, cfg.d_frontend),
                                           np.float32)
    return b


def host_outputs(out):
    logits, (loss, metrics) = out
    return (np.asarray(logits, np.float32), float(loss),
            {k: float(metrics[k]) for k in ("ce", "lb_loss", "z_loss", "tokens")})


def repro_forward_loss(pair, batch):
    """``repro``'s ``(logits, loss, metrics)`` on one batch."""
    model = pair.rmodel
    fn = jax.jit(lambda p, b: (model.forward(p, b), model.loss(p, b)))
    return host_outputs(fn(pair.params, {k: jnp.asarray(v) for k, v in batch.items()}))


def port_forward_loss(pair, batch):
    logits = pair.model.forward(batch).float().numpy()
    with torch.no_grad():
        loss, metrics = pair.model.loss(batch)
    return (logits, loss.item(),
            {k: metrics[k].item() for k in ("ce", "lb_loss", "z_loss", "tokens")})


def logits_err(a, b, vocab: int) -> float:
    return float(np.abs(a[..., :vocab] - b[..., :vocab]).max())


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

def test_list_archs_matches_repro():
    assert list_archs() == repro_archs()
    assert len(list_archs()) == 10


@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_repro(arch):
    for mine, ref in ((get_config(arch), repro_config(arch)),
                      (get_config(arch).reduced(), repro_config(arch).reduced())):
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
        assert mine.padded_vocab == ref.padded_vocab
        assert mine.attn_kind == ref.attn_kind
        assert mine.layer_kinds() == ref.layer_kinds()
        assert mine.ffn_kinds() == ref.ffn_kinds()
        assert mine.params_estimate() == ref.params_estimate()


# ---------------------------------------------------------------------------
# full configs on the meta device
# ---------------------------------------------------------------------------

class Leaf:
    """A shape stand-in for an abstract leaf: indexing drops the leading
    axis, as ``unstack_params`` does to a scanned segment's leaves."""

    def __init__(self, shape, dtype):
        self.shape, self.dtype = tuple(shape), str(dtype)

    def __getitem__(self, j):
        return Leaf(self.shape[1:], self.dtype)


@pytest.mark.parametrize("arch", ARCHS)
def test_meta_parameters_match_repro_shapes(arch):
    """Full config: the port's meta-device weights, name for name, have
    the shapes and dtypes of ``repro``'s abstract init, unstacked; nothing
    is allocated on either side."""
    cfg = get_config(arch)
    model = build_model(cfg, device="meta")
    mine = dict(model.named_parameters())
    assert all(p.is_meta for p in mine.values())
    abstract = jax.eval_shape(repro_build(repro_config(arch)).init, KEY)
    ref = unstack_params(cfg, jax.tree.map(lambda s: Leaf(s.shape, s.dtype), abstract))
    assert sorted(mine) == sorted(ref)
    for name, p in mine.items():
        assert tuple(p.shape) == ref[name].shape, name
        assert str(p.dtype).removeprefix("torch.") == ref[name].dtype, name
    assert sum(p.numel() for p in mine.values()) == PARAMS[arch]


def test_load_repro_params_rejects_bad_trees(pairs):
    pair = pairs("qwen3-4b")
    tree = jax.tree.map(np.asarray, pair.params)
    tree["final_norm"]["extra"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="extra"):
        load_repro_params(pair.model, tree)
    tree = jax.tree.map(np.asarray, pair.params)
    del tree["segments"][0]["sub0"]["attn"]["wq"]
    with pytest.raises(ValueError, match="wq"):
        load_repro_params(pair.model, tree)
    tree = jax.tree.map(np.asarray, pair.params)
    tree["lm_head"] = tree["lm_head"][:, :-1]
    with pytest.raises(ValueError, match="lm_head"):
        load_repro_params(pair.model, tree)


# ---------------------------------------------------------------------------
# forward and losses with carried weights
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S", [16, 64])  # 64 > attn_q_chunk = 32: q-chunked
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_losses_match_repro(pairs, arch, S):
    pair = pairs(arch)
    batch, ref_logits, ref_loss, ref_m = pair.reference(S)
    logits, loss, m = port_forward_loss(pair, batch)
    assert logits.shape == ref_logits.shape
    assert np.isfinite(logits).all()
    assert logits_err(logits, ref_logits, pair.cfg.vocab) <= LOGITS_TOL
    if pair.cfg.padded_vocab != pair.cfg.vocab:
        assert (logits[..., pair.cfg.vocab:] == -1e30).all()
    assert loss == pytest.approx(ref_loss, rel=LOSS_TOL, abs=LOSS_TOL)
    for k in ("ce", "lb_loss", "z_loss"):
        assert m[k] == pytest.approx(ref_m[k], rel=LOSS_TOL, abs=LOSS_TOL), k
    assert m["tokens"] == ref_m["tokens"]
    if pair.cfg.n_experts:
        assert m["lb_loss"] > 0.0


def test_label_masking_matches_repro(pairs):
    pair = pairs("qwen3-4b")
    batch = make_batch(pair.cfg, S=16, seed=3)
    batch["labels"][:, ::2] = -1
    _, ref_loss, ref_m = repro_forward_loss(pair, batch)
    _, loss, m = port_forward_loss(pair, batch)
    assert m["tokens"] == ref_m["tokens"] == 2 * 8
    assert loss == pytest.approx(ref_loss, rel=LOSS_TOL, abs=LOSS_TOL)


@pytest.mark.parametrize("arch,group,dispatch", [
    ("mixtral-8x22b", "flat", "einsum"),
    ("mixtral-8x22b", "flat", "scatter"),
    ("deepseek-v2-236b", "seq", "einsum"),
])
def test_moe_dispatch_with_drops_matches_repro(pairs, arch, group, dispatch):
    """``capacity_factor=1.0`` drops tokens.  Flat: 2 x 40 tokens in chunks
    of 64 route the last chunk's zero pad tokens too; seq: each batch row
    is one group of 40 (DeepSeek: with its shared expert and MLA)."""
    pair = pairs(arch).variant(capacity_factor=1.0, moe_group=group,
                               moe_dispatch=dispatch)
    batch = make_batch(pair.cfg, S=40, seed=5)
    ref_logits, ref_loss, ref_m = repro_forward_loss(pair, batch)
    logits, loss, m = port_forward_loss(pair, batch)
    assert logits_err(logits, ref_logits, pair.cfg.vocab) <= LOGITS_TOL
    for k in ("ce", "lb_loss", "z_loss"):
        assert m[k] == pytest.approx(ref_m[k], rel=LOSS_TOL, abs=LOSS_TOL), k
    drop_free = pairs(arch).variant(moe_group=group, moe_dispatch=dispatch)
    assert logits_err(drop_free.model.forward(batch).numpy(), logits,
                      pair.cfg.vocab) > 1e-2   # tokens were dropped


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "qwen3-4b", "mixtral-8x22b",
                                  "recurrentgemma-2b", "deepseek-v2-236b"])
def test_bf16_matches_repro(pairs, arch):
    """The counterpart of ``test_bf16_numerics_smoke``: the reduced config
    in bfloat16 (``repro``'s float32 weights cast as its bfloat16 init
    casts them): finite, within the bfloat16 tolerance of ``repro``."""
    pair = pairs(arch).variant(param_dtype="bfloat16", act_dtype="bfloat16")
    batch = make_batch(pair.cfg, S=16, seed=9)
    ref_logits, ref_loss, _ = repro_forward_loss(pair, batch)
    logits, loss, _ = port_forward_loss(pair, batch)
    assert np.isfinite(logits).all() and np.isfinite(loss)
    assert logits_err(logits, ref_logits, pair.cfg.vocab) <= BF16_LOGITS_TOL
    assert loss == pytest.approx(ref_loss, rel=BF16_LOSS_RTOL)
    caches, lg = pair.model.prefill({"tokens": batch["tokens"]}, 20)
    caches, lg = pair.model.decode_step(caches, np.zeros((2, 1), np.int32), 16)
    assert lg.dtype == torch.float32 and torch.isfinite(lg).all()
