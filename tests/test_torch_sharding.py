"""The port's placement resolver (``repro_torch.distributed.sharding``), its
activation constraints (``shard_heads``, the residual constrainer) and its
stacked resolution, held against ``repro``'s on the CPU.

The resolver reads only axis names and sizes, so ``repro``'s runs on a
``jax.sharding.Mesh`` of the one CPU device repeated (as
``tests/test_distributed.py`` builds one) and the port's on the same
``{name: size}``.  No process group is started here.  Specs are compared
entry for entry (JAX writes a one-name tuple as the name).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding as JaxNamedSharding

import repro.distributed.sharding as RS
import repro.models.layers as rlayers
import repro.models.transformer as rtransformer
from repro.configs import get_config as repro_config
from repro.configs import list_archs
from repro.models import build_model as repro_build
from repro.training import init_train_state as repro_init_train_state
import repro_torch.distributed as port_distributed
import repro_torch.distributed.sharding as PS
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.models.convert import unstack_params
from repro_torch.models.layers import heads_spec, shard_heads, split_heads, use_sharding_mesh
from repro_torch.models.transformer import init_cache, make_constrainer, residual_spec
from repro_torch.training import init_train_state

MESHES = {"16x16": (16, 16), "2x16x16": (2, 16, 16), "2x4": (2, 4), "4x1": (4, 1),
          "1x1": (1, 1)}
FULL_MESHES = ("16x16", "2x16x16", "2x4")


def _names(shape):
    return ("data", "model") if len(shape) == 2 else ("pod", "data", "model")


def jax_mesh(key: str) -> Mesh:
    shape = MESHES[key]
    n = math.prod(shape)
    return Mesh(np.array(jax.devices() * n)[:n].reshape(shape), _names(shape))


def port_mesh(key: str) -> dict:
    shape = MESHES[key]
    return dict(zip(_names(shape), shape))


def norm(spec) -> tuple:
    """A spec as a tuple, one-name tuples written as the name."""
    if spec is None:
        return None
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in spec)


def shape_grid(seed: int, n: int = 400) -> list:
    """Shapes of 1-5 dims from 1 to 2**19: powers of two and their
    multiples of 3, 5 and 7 (divisible by 2, 4, 16, 32 or not), and odd
    sizes."""
    rng = np.random.default_rng(seed)
    sizes = sorted({s for p in range(20) for m in (1, 3, 5, 7) if (s := m * 2 ** p) <= 2 ** 19}
                   | {1, 3, 7, 11, 48, 257, 49155, 151936})
    return [tuple(int(rng.choice(sizes)) for _ in range(rng.integers(1, 6))) for _ in range(n)]


# ---------------------------------------------------------------------------
# the rules, entry for entry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ep", ["1", "0"], ids=["ep_on", "ep_off"])
@pytest.mark.parametrize("batch_dim", [0, 1])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_resolver_rules_match_repro(mesh, batch_dim, ep, monkeypatch):
    """``param_spec``, ``act_spec`` (at ``batch_dim``) and
    ``expert_param_spec`` equal ``repro``'s over a seeded grid of shapes;
    ``REPRO_EP`` read by both at call time, as ``repro`` reads it."""
    monkeypatch.setenv("REPRO_EP", ep)
    jm, pm = jax_mesh(mesh), port_mesh(mesh)
    for shape in shape_grid(seed=len(mesh) * 7 + batch_dim):
        assert norm(PS.param_spec(shape, pm)) == norm(RS.param_spec(shape, jm)), shape
        assert (norm(PS.act_spec(shape, pm, batch_dim))
                == norm(RS.act_spec(shape, jm, batch_dim))), shape
        assert (norm(PS.expert_param_spec(shape, pm))
                == norm(RS.expert_param_spec(shape, jm))), shape
        assert PS._expert_parallel_enabled() == RS._expert_parallel_enabled()


def test_sharding_resolver_rules():
    """``tests/test_distributed.py::test_sharding_resolver_rules`` on the
    port's resolver."""
    mesh = port_mesh("16x16")
    P = PS.PartitionSpec
    # big 2D param: TP on last dim, FSDP on first
    assert PS.param_spec((8192, 4096), mesh) == P("data", "model")
    # scan-stacked 3D: layer dim never sharded
    s = PS.param_spec((36, 2560, 9728), mesh)
    assert s[0] is None and s[2] == "model"
    # tiny params replicate
    assert PS.param_spec((64,), mesh) == P(None)
    # batch=1 long-context: sequence takes the data axes
    s = PS.act_spec((1, 524288, 2560), mesh)
    assert s[1] in ("data", ("data",))
    # kv_heads=8 cannot split 16 ways -> time dim takes model
    s = PS.act_spec((128, 32768, 8, 128), mesh)
    assert s[0] in ("data", ("data",)) and "model" in s
    # indivisible dims never sharded
    assert PS.act_spec((3, 7, 11), mesh) == P(None, None, None)


def test_placements_follow_mesh_order():
    """A spec entry becomes ``Shard(dim)`` on each mesh dim it names, a
    tuple entry on each of its axes in mesh order; the rest replicate."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = port_mesh("2x16x16")
    P = PS.PartitionSpec
    assert PS.NamedSharding(mesh, P(("pod", "data"), None, "model")).placements == (
        Shard(0), Shard(0), Shard(2))
    assert PS.NamedSharding(mesh, P(None, "data")).placements == (
        Replicate(), Shard(1), Replicate())
    assert PS.replicated(mesh).placements == (Replicate(),) * 3
    assert PS.mesh_axes(mesh) == {"pod": 2, "data": 16, "model": 16}
    # an axis of size 1 holds the whole tensor: replicated there
    assert PS.NamedSharding(port_mesh("4x1"), P("data", "model")).placements == (
        Shard(0), Replicate())
    assert PS.NamedSharding(port_mesh("1x1"), P("data", "model")).placements == (
        Replicate(), Replicate())


def test_distributed_exports_repros_five_names():
    import repro.distributed as rd

    assert port_distributed.__all__ == rd.__all__
    for name in rd.__all__:
        assert getattr(port_distributed, name) is getattr(PS, name)


# ---------------------------------------------------------------------------
# activation constraints
# ---------------------------------------------------------------------------

def _repro_constraint_spec(fn, x, mesh):
    """The spec ``repro``'s ``fn`` hands ``with_sharding_constraint``."""
    seen = []

    def capture(x, sharding):
        seen.append(sharding.spec)
        return x

    orig = jax.lax.with_sharding_constraint
    jax.lax.with_sharding_constraint = capture
    try:
        with rlayers.use_sharding_mesh(mesh):
            fn(x)
    finally:
        jax.lax.with_sharding_constraint = orig
    return seen[0]


@pytest.mark.parametrize("mesh", list(MESHES))
def test_shard_heads_and_constrainer_match_repro(mesh):
    """``heads_spec`` (``shard_heads``'s rule) on (B, S, H, D) and
    ``residual_spec`` (``make_constrainer``'s) on (B, S, d) equal the specs
    ``repro`` constrains to, over a seeded grid of shapes."""
    jm, pm = jax_mesh(mesh), port_mesh(mesh)
    rng = np.random.default_rng(len(mesh))
    sizes = (1, 2, 3, 4, 8, 10, 16, 28, 32, 40, 64, 128, 256, 4096, 32768)
    constrain = rtransformer.make_constrainer(jm)
    for _ in range(200):
        shape4 = tuple(int(rng.choice(sizes)) for _ in range(4))
        x4 = jax.ShapeDtypeStruct(shape4, jnp.float32)
        want = _repro_constraint_spec(rlayers.shard_heads, x4, jm)
        assert norm(heads_spec(shape4, pm)) == norm(want), shape4
        shape3 = shape4[:3]
        want = _repro_constraint_spec(constrain, jax.ShapeDtypeStruct(shape3, jnp.float32), jm)
        assert norm(residual_spec(shape3, pm)) == norm(want), shape3


def test_constraints_are_the_identity_without_a_dtensor():
    """Without a mesh, or on a plain tensor under one, ``shard_heads``,
    ``split_heads`` and the constrainer change nothing, bit for bit."""
    x = torch.randn(2, 8, 4 * 16, generator=torch.Generator().manual_seed(0))
    assert torch.equal(split_heads(x, 4, 16), x.reshape(2, 8, 4, 16))
    q = x.reshape(2, 8, 4, 16)
    assert shard_heads(q) is q
    assert make_constrainer(None) is None
    with use_sharding_mesh(port_mesh("2x4")):
        assert shard_heads(q) is q
        assert torch.equal(split_heads(x, 4, 16), q)
        assert make_constrainer(port_mesh("2x4"))(x) is x


# ---------------------------------------------------------------------------
# every leaf of the ten full-size train states and decode caches
# ---------------------------------------------------------------------------

FFN3 = frozenset({"ffn.w_gate", "ffn.w_up", "ffn.w_down"})
FFN2 = frozenset({"ffn.w_up", "ffn.w_down"})
KV = frozenset({"k", "v"})
# (arch, mesh) -> (layer leaves of the train state, layer leaves of the
# decode_32k caches) whose stacked spec in ``repro`` puts a mesh axis on the
# layer axis: the name-based expert rule on a dense FFN's (or the RG-LRU
# gate's) stacked (L, d, ff) when L divides "model", and a stacked cache's
# layer count taken for its batch when it divides the data axes.
EXCEPTIONS = {
    ("hubert-xlarge", "16x16"): (FFN2, frozenset()),
    ("internvl2-26b", "16x16"): (FFN3, KV),
    ("qwen3-32b", "16x16"): (FFN3, KV),
    ("hubert-xlarge", "2x16x16"): (FFN2, frozenset()),
    ("internvl2-26b", "2x16x16"): (FFN3, frozenset()),
    ("qwen3-32b", "2x16x16"): (FFN3, KV),
    ("granite-3-8b", "2x4"): (FFN3, KV),
    ("hubert-xlarge", "2x4"): (FFN2, frozenset()),
    ("internvl2-26b", "2x4"): (FFN3, KV),
    ("mixtral-8x22b", "2x4"): (frozenset(), KV),
    ("qwen3-32b", "2x4"): (FFN3, KV),
    ("qwen3-4b", "2x4"): (FFN3, KV),
    ("recurrentgemma-2b", "2x4"): (frozenset({"ffn.w_up", "ffn.w_down", "rec.w_gate"}),
                                   frozenset({"conv", "h", "k", "v"})),
    ("rwkv6-1.6b", "2x4"): (frozenset(), frozenset({"sa", "sc", "state"})),
    ("starcoder2-15b", "2x4"): (FFN2, KV),
}
DECODE_B, DECODE_T = 128, 32768   # decode_32k


class _Stacked:
    """A ``repro`` spec that ``unstack_params`` indexes: taking layer j of a
    scanned segment marks it stacked."""

    def __init__(self, spec, shape, stacked=False):
        self.spec, self.shape, self.stacked = spec, shape, stacked

    def __getitem__(self, j):
        return _Stacked(self.spec, self.shape, True)


def _marked(shardings, shapes):
    return jax.tree.map(lambda s, x: _Stacked(s.spec, x.shape), shardings, shapes,
                        is_leaf=lambda x: isinstance(x, JaxNamedSharding))


def _device_bytes(shape, spec, sizes: dict, itemsize: int) -> float:
    """Bytes a device holds of a leaf of ``shape`` placed by ``spec``."""
    n = math.prod(shape)
    for e in spec:
        for a in ((e,) if isinstance(e, str) else (e or ())):
            n /= sizes[a]
    return n * itemsize


@pytest.fixture(scope="module")
def repro_trees():
    """Each architecture's full-size train state and decode_32k caches, as
    ``jax.eval_shape`` trees (no allocation)."""
    out = {}
    for arch in list_archs():
        cfg = repro_config(arch)
        model = repro_build(cfg)
        state = jax.eval_shape(lambda: repro_init_train_state(model, jax.random.PRNGKey(0)))
        caches = (model.input_specs(DECODE_B, DECODE_T, "decode")["caches"]
                  if cfg.family != "encoder" else None)
        out[arch] = (state, caches)
    return out


def _check_leaves(got: dict, want: dict, mesh: str, where: str, exceptions: frozenset,
                  itemsizes: dict) -> set:
    """Each port leaf's spec is ``repro``'s stacked spec less its leading
    ``None`` (or ``repro``'s own where the leaf is not stacked); a leaf
    whose stacked spec leads with a mesh axis must be in ``exceptions``,
    and there the device's bytes are held against ``repro``'s per layer.
    Returns the exception leaves seen."""
    sizes = port_mesh(mesh)
    seen = set()
    assert got.keys() == want.keys()
    for name, mark in want.items():
        spec = norm(got[name].spec)
        leaf = name.split(".", 2)[2] if name.startswith("layers.") else name
        if mark.stacked and len(mark.spec) and mark.spec[0] is not None:
            seen.add(leaf)
            assert leaf in exceptions, (where, name, mark.spec)
            shape = mark.shape[1:]
            assert spec == norm(
                PS._stacked(lambda s, m, n=leaf.split(".")[-1]: PS._leaf_param_spec(n, s, m)
                            if where != "cache" else PS._cache_spec(s, m),
                            shape, None, sizes)), (where, name)
            # the same bytes a device as repro's stacked leaf, per layer
            port_b = _device_bytes(shape, got[name].spec, sizes, itemsizes[name])
            repro_b = _device_bytes(mark.shape, mark.spec, sizes, itemsizes[name]) / mark.shape[0]
            assert port_b == repro_b, (where, name, port_b, repro_b)
            continue
        expect = norm(mark.spec[1:]) if mark.stacked else norm(mark.spec)
        expect = expect + (None,) * (len(spec) - len(expect))
        assert spec == expect, (where, name, spec, mark.spec)
    return seen


@pytest.mark.parametrize("mesh", FULL_MESHES)
@pytest.mark.parametrize("arch", list_archs())
def test_full_size_state_and_caches_match_repro(arch, mesh, repro_trees):
    """Every leaf of the port's ``meta`` train state (parameters and both
    moments) and decode_32k caches is placed as ``repro`` places the
    stacked leaf, less its leading ``None``; the leaves where ``repro``
    puts a mesh axis on the layer axis are exactly ``EXCEPTIONS``."""
    cfg = get_config(arch)
    jm, pm = jax_mesh(mesh), port_mesh(mesh)
    state_s, caches_s = repro_trees[arch]
    rsh = RS.state_shardings(state_s, jm)
    state = init_train_state(build_model(cfg, "meta"))
    psh = PS.state_shardings(state, pm)
    assert psh["step"].spec == PS.PartitionSpec()
    want_state, want_cache = EXCEPTIONS.get((arch, mesh), (frozenset(), frozenset()))
    itemsizes = {n: p.element_size() for n, p in state.params.items()}
    seen = _check_leaves(psh["params"], unstack_params(cfg, _marked(rsh["params"], state_s["params"])),
                         mesh, "params", want_state, itemsizes)
    assert seen == want_state
    for k in ("m", "v"):
        seen = _check_leaves(psh["opt"][k],
                             unstack_params(cfg, _marked(rsh["opt"][k], state_s["opt"][k])),
                             mesh, f"opt/{k}", want_state, dict.fromkeys(itemsizes, 4))
        assert seen == want_state
    if caches_s is None:
        assert not want_cache
        return
    caches = init_cache(cfg, DECODE_B, DECODE_T, "meta")
    pcs = PS.cache_shardings(caches, pm, cfg)
    got = {f"layers.{i}.{k}": s for i, layer in enumerate(pcs) for k, s in layer.items()}
    want = unstack_params(cfg, {"segments": _marked(RS.cache_shardings(caches_s, jm), caches_s)})
    itemsizes = {f"layers.{i}.{k}": t.element_size()
                 for i, layer in enumerate(caches) for k, t in layer.items()}
    seen = _check_leaves(got, want, mesh, "cache", want_cache, itemsizes)
    assert seen == want_cache


def test_layer_stacks_follow_plan_segments():
    """``layer_stacks`` gives each layer its scanned segment's length (the
    stack axis in ``repro``) or ``None`` for a plain layer."""
    assert PS.layer_stacks(get_config("qwen3-4b")) == [36] * 36
    ds = PS.layer_stacks(get_config("deepseek-v2-236b"))
    assert ds[0] is None and set(ds[1:]) == {59}
    rg = get_config("recurrentgemma-2b")
    stacks = PS.layer_stacks(rg)
    assert len(stacks) == rg.n_layers and stacks[-1] is None


def test_state_shardings_of_a_parameter_dict_needs_its_config():
    model = build_model(get_config("qwen3-4b").reduced(), "meta")
    params = dict(model.named_parameters())
    mesh = port_mesh("2x4")
    assert PS.state_shardings(params, mesh, cfg=model.cfg) == PS.state_shardings(model, mesh)
    with pytest.raises(ValueError):
        PS.state_shardings(params, mesh)
