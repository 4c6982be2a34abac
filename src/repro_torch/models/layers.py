"""Common transformer building blocks: weight-holding modules and the plain
functions on tensors that apply them (the port of ``repro.models.layers``).

Conventions, as in ``repro``:

* weights keep ``repro``'s ``(in, out)`` layout and leaf names, so
  ``linear(x, w)`` is ``x @ w`` and a carried weight needs no transpose;
* activations run in ``cfg.act_dtype``; norms, RoPE and softmax compute in
  float32 and cast back exactly where ``repro`` does;
* attention is q-chunked above ``cfg.attn_q_chunk`` (when the sequence is a
  multiple of it), so a long prompt never holds an ``(S, S)`` score block;
  with ``chunk_remat`` the backward recomputes each chunk's scores.
"""
from __future__ import annotations

import contextlib
import contextvars
import math
import sys

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

__all__ = [
    "DTYPES",
    "Norm",
    "MLP",
    "new_param",
    "dense_init_",
    "linear",
    "norm_apply",
    "rope_apply",
    "attention",
    "mlp_apply",
    "use_sharding_mesh",
    "sharding_mesh",
    "is_dtensor",
    "heads_spec",
    "shard_heads",
    "split_heads",
    "cache_write",
    "local_product",
    "reduce_partial",
    "pad_seq",
    "contiguous_stride",
]

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# The mesh of the activation-sharding constraints (``shard_heads``, the
# residual constrainer).  Set by the ``Model`` entry points; None on runs
# without a mesh, where every constraint is the identity.
_MESH_CTX: contextvars.ContextVar = contextvars.ContextVar("repro_torch_mesh",
                                                           default=None)


@contextlib.contextmanager
def use_sharding_mesh(mesh):
    tok = _MESH_CTX.set(mesh)
    try:
        yield
    finally:
        _MESH_CTX.reset(tok)


def sharding_mesh():
    """The mesh ``use_sharding_mesh`` set, or None."""
    return _MESH_CTX.get()


def is_dtensor(t) -> bool:
    """Whether ``t`` is a ``DTensor`` (none exists before
    ``torch.distributed.tensor`` is imported)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(t, mod.DTensor)


def constrain(x, spec, mesh):
    """``x`` redistributed to ``spec`` (a ``PartitionSpec``) on ``mesh``:
    the counterpart of ``with_sharding_constraint``."""
    from repro_torch.distributed.sharding import NamedSharding

    return x.redistribute(mesh, NamedSharding(mesh, spec).placements)


def heads_spec(shape, mesh):
    """``repro``'s spec for (B, S, H, D): batch over (pod, data), else the
    sequence; heads over "model", else D."""
    from repro_torch.distributed.sharding import PartitionSpec, mesh_axes

    sizes = mesh_axes(mesh)
    daxes = tuple(a for a in ("pod", "data") if a in sizes)
    dsize = math.prod(sizes[a] for a in daxes)
    msize = sizes.get("model", 1)
    B, S, H, D = shape
    spec: list = [None, None, None, None]
    if B % dsize == 0 and B > 1:
        spec[0] = daxes
    elif S % dsize == 0 and S >= dsize:
        spec[1] = daxes
    if H % msize == 0 and H >= msize:
        spec[2] = "model"
    elif D % msize == 0 and D >= msize:
        spec[3] = "model"
    return PartitionSpec(*spec)


def shard_heads(x):
    """Constrain (B, S, H, D) to ``heads_spec``; the identity without a
    mesh or on a plain tensor."""
    mesh = _MESH_CTX.get()
    if mesh is None or x.ndim != 4 or not is_dtensor(x):
        return x
    return constrain(x, heads_spec(x.shape, mesh), mesh)


def split_heads(x, H: int, D: int):
    """(B, S, H*D) -> (B, S, H, D), then ``shard_heads``.  On a mesh the
    flat dim keeps "model" into the view only where the heads take it, so
    no view splits a dim sharded unevenly (DTensor refuses that; XLA pads
    it silently)."""
    B, S = x.shape[:2]
    mesh = _MESH_CTX.get()
    if mesh is None or not is_dtensor(x):
        return x.reshape(B, S, H, D)
    spec = heads_spec((B, S, H, D), mesh)
    x = constrain(x, spec[:3], mesh)
    return constrain(x.reshape(B, S, H, D), spec, mesh)


def cache_write(cache, start: int, value):
    """``cache[:, start:start + n] = value`` in place (n = ``value.shape[1]``,
    cast to the cache's dtype).  On a ``DTensor`` cache whose time dim is
    split, a write that covers the whole dim is a ``redistribute`` of the
    value to the cache's placement; any other write goes into the local
    shard of the rank that holds those positions, from the value gathered
    along time (a view of one position of a split dim cannot be written
    through: ``DTensor`` would write into a gathered copy)."""
    value = value.to(cache.dtype)
    n = value.shape[1]
    if not is_dtensor(cache):
        cache[:, start:start + n] = value
        return
    from torch.distributed.tensor import Replicate, Shard

    mesh, placements = cache.device_mesh, cache.placements
    T = cache.shape[1]
    if start == 0 and n == T:
        cache.copy_(value.redistribute(mesh, placements))
        return
    local_c = cache.to_local()
    local_v = value.redistribute(
        mesh, [Replicate() if p == Shard(1) else p for p in placements]).to_local()
    coord, lo, span = mesh.get_coordinate(), 0, T
    for i, p in enumerate(placements):     # mesh order: the outer split first
        if p == Shard(1):
            span //= mesh.size(i)
            lo += coord[i] * span
    a, b = max(start, lo), min(start + n, lo + local_c.shape[1])
    if a < b:
        local_c[:, a - lo:b - lo] = local_v[:, a - start:b - start]


# ---------------------------------------------------------------------------
# init / linear
# ---------------------------------------------------------------------------

def new_param(shape, dtype, device) -> nn.Parameter:
    """An uninitialised weight; ``Model.reset_parameters`` fills it."""
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device))


@torch.no_grad()
def dense_init_(w: torch.Tensor, generator: torch.Generator,
                scale: float | None = None) -> torch.Tensor:
    """Truncated-normal fan-in init in place: a standard normal cut at +-2,
    times ``scale`` or ``1/sqrt(fan_in)`` (``fan_in`` the product of all but
    the last axis), drawn in float32 from ``generator`` and cast."""
    shape = w.shape
    fan_in = shape[0] if len(shape) == 1 else math.prod(shape[:-1])
    std = scale if scale is not None else 1.0 / max(fan_in, 1) ** 0.5
    draw = torch.empty(shape, dtype=torch.float32, device=w.device)
    nn.init.trunc_normal_(draw, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return w.copy_(draw.mul_(std))


def linear(x, w):
    """``x @ w`` (w cast to x's dtype).  On ``DTensor``s, ``local_product``."""
    w = w.to(x.dtype)
    if is_dtensor(x) and is_dtensor(w):
        return local_product(x, w)
    return x @ w


def local_product(x, w, e: int | None = None):
    """x (..., a) @ w (a, b) on ``DTensor``s, on the local shards; with
    ``e``, w is (E, a, b) and x's dim ``e`` its E (a product per expert).
    Mesh dim by mesh dim:

    * x split on E: w split on E alike;
    * x split on another leading dim: w gathered there (the FSDP
      all-gather), the output split as x, w's local gradient a partial sum;
    * x split on ``a``: w split on ``a`` too, the output a partial sum,
      reduced at once (``reduce_partial`` over ``b``);
    * x whole: w keeps a split of ``b`` (the output split on ``b``, x's
      local gradient a partial sum) and is gathered otherwise; x is made
      whole first where it is partial, strided, or split on a leading dim
      after the first where w splits ``b``.

    ``DTensor``'s own ``matmul`` or ``einsum`` folds the leading dims of x
    into one before its ``mm``/``bmm``, a view torch 2.11 refuses when a
    leading dim after the first is split: the sequence-parallel residual
    (batch over the data axes, sequence over "model") reaches every
    projection so, and the dispatched tokens (batch, experts) every expert
    product."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh, a = x.device_mesh, x.ndim - 1
    wa, wb = w.ndim - 2, w.ndim - 1

    def kept(p, pw):
        # x is gathered on a mesh dim where it holds a partial sum or a
        # strided split (``DTensor``'s ``_StridedShard``, left by folding a
        # split head dim into its neighbour: no block of w's rows), and
        # where a split sequence (any leading dim after the first but E)
        # meets a w split on b: the column-parallel projection after
        # sequence parallelism (Megatron's, and XLA's for repro), so what
        # follows stays split over its features (heads), not the sequence
        if p.is_replicate():
            return True
        return type(p) is Shard and not (0 < p.dim < a and p.dim != e and pw == Shard(wb))

    xp = [p if kept(p, pw) else Replicate() for p, pw in zip(x.placements, w.placements)]
    rules = []    # per mesh dim: (w's placement, output's, x's gradient's, w's gradient's)
    for px, pw in zip(xp, w.placements):
        if px.is_shard() and px.dim == e:
            rules.append((Shard(0), px, px, Shard(0)))
        elif px.is_shard() and px.dim != a:
            rules.append((Replicate(), px, px, Partial()))
        elif px.is_shard():
            rules.append((Shard(wa), Partial(), px, Shard(wa)))
        elif pw == Shard(wb):
            rules.append((pw, Shard(a), Partial(), pw))
        else:
            rules.append((Replicate(), px, px, Replicate()))
    wp, out, x_grad, w_grad = (list(r) for r in zip(*rules))
    x, w = x.redistribute(mesh, xp), w.redistribute(mesh, wp)
    y = torch.matmul(x.to_local(grad_placements=x_grad), w.to_local(grad_placements=w_grad))
    shape = (*x.shape[:-1], w.shape[-1])
    y = DTensor.from_local(y, mesh, out, run_check=False, shape=torch.Size(shape),
                           stride=contiguous_stride(shape))
    return reduce_partial(y, a)


def pad_seq(t, n: int, value=0):
    """``t`` (B, S, ...) with ``n`` steps of ``value`` after its last along
    dim 1: ``F.pad`` on a plain tensor; on a ``DTensor`` a ``cat`` with a
    filled tensor of its kind (torch 2.11's ``DTensor`` fails to plan the
    redistribution ``F.pad`` asks for: an ``IndexError``)."""
    if not n:
        return t
    if not is_dtensor(t):
        return F.pad(t, (0, 0) * (t.ndim - 2) + (0, n), value=value)
    return torch.cat([t, t.new_full((t.shape[0], n, *t.shape[2:]), value)], dim=1)


def reduce_partial(t, dim: int):
    """A ``DTensor``'s partial sums reduced at once: scattered over ``dim``
    where it divides that mesh axis (a reduce-scatter), else all-reduced.
    Torch 2.11 cannot bring the other operand of a later op to a partial
    placement (``Shard`` to ``Partial``), so no partial sum leaves the
    product that made it.  The identity on anything else."""
    if not (is_dtensor(t) and any(p.is_partial() for p in t.placements)):
        return t
    from torch.distributed.tensor import Replicate, Shard

    mesh = t.device_mesh
    taken = {p.dim for p in t.placements if p.is_shard()}
    out = []
    for i, p in enumerate(t.placements):
        if p.is_partial() and dim not in taken and t.shape[dim] % mesh.size(i) == 0:
            p = Shard(dim)
            taken.add(dim)
        elif p.is_partial():
            p = Replicate()
        out.append(p)
    return t.redistribute(mesh, out)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

class Norm(nn.Module):
    """RMSNorm (``scale``) or LayerNorm (``scale``, ``bias``) weights."""

    def __init__(self, d: int, kind: str, dtype, device):
        super().__init__()
        self.kind = kind
        self.scale = new_param((d,), dtype, device)
        if kind != "rmsnorm":
            self.bias = new_param((d,), dtype, device)

    def reset_parameters(self, generator):
        with torch.no_grad():
            self.scale.fill_(1.0)
            if self.kind != "rmsnorm":
                self.bias.zero_()


def norm_apply(p, x, kind: str, eps: float = 1e-6):
    xf = x.float()
    if kind == "rmsnorm":
        xf = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
        return (xf * p.scale.float()).to(x.dtype)
    mean = xf.mean(-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(-1, keepdim=True)
    xf = (xf - mean) * torch.rsqrt(var + eps)
    return (xf * p.scale.float() + p.bias.float()).to(x.dtype)


def _head_rmsnorm(x, scale, eps: float = 1e-6):
    """qk_norm (Qwen3): RMSNorm over head_dim, scale shared across heads."""
    xf = x.float()
    xf = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    return (xf * scale.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_apply(x, positions, theta: float):
    """Rotate (..., S, H, D) by absolute ``positions`` (shape (S,)): the two
    concatenated halves, not interleaved pairs, in float32."""
    d = x.shape[-1]
    half = d // 2
    exps = torch.arange(half, dtype=torch.float32, device=x.device) / half
    freqs = torch.pow(1.0 / theta, exps)              # float32, as jnp's
    ang = positions.float()[:, None] * freqs[None, :]            # (S, half)
    cos = torch.cos(ang)[None, :, None, :]
    sin = torch.sin(ang)[None, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention (GQA/MQA, causal / bidirectional / sliding-window, q-chunked)
# ---------------------------------------------------------------------------

def _attend_block(q, k, v, q_pos, k_pos, causal, window, scale):
    """q (B,Sq,H,D), k (B,Sk,H,D), v (B,Sk,H,Dv) -> (B,Sq,H,Dv).

    The einsum form of ``repro``: masked scores are -1e30 in float32, a key
    at ``k_pos == -1`` is an unfilled slot, and a row with no valid key
    (an empty cache at position 0) gives zeros, where
    ``scaled_dot_product_attention`` would give NaN.  On ``DTensor``s whose
    D is split (``shard_heads`` when the heads do not divide "model") the
    partial scores are all-reduced before the mask, as XLA reduces them
    for the softmax: left to ``DTensor``, they are reduce-scattered over
    the queries, and the next product then fails on a local view
    (recurrentgemma-2b's prefill_32k on 16x16)."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if is_dtensor(scores):
        from torch.distributed.tensor import Replicate

        scores = scores.redistribute(scores.device_mesh, [
            Replicate() if p.is_partial() else p for p in scores.placements])
    valid = (k_pos >= 0)[None, :]                        # (1, Sk)
    if causal:
        valid = valid & (k_pos[None, :] <= q_pos[:, None])
    if window is not None:
        valid = valid & (q_pos[:, None] - k_pos[None, :] < window)
    scores = torch.where(valid[None, None], scores, -1e30)
    probs = torch.softmax(scores, dim=-1)
    any_valid = valid.any(dim=-1)                        # (Sq,) or (1,)
    probs = probs * any_valid[None, None, :, None]
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)


def attention(
    q,                    # (B, Sq, Hq, D)
    k,                    # (B, Sk, Hkv, D)
    v,                    # (B, Sk, Hkv, Dv)
    *,
    q_pos,                # (Sq,) absolute positions
    k_pos,                # (Sk,) absolute positions; -1 marks unfilled slots
    causal: bool = True,
    window: int | None = None,
    q_chunk: int = 1024,
    scale: float | None = None,
    chunk_remat: bool = False,
):
    """``chunk_remat`` (with gradients on): recompute each q-chunk's float32
    score block in the backward instead of saving it, as ``repro``'s
    ``jax.checkpoint`` of its chunk loop."""
    B, Sq, Hq, D = q.shape
    G = Hq // k.shape[2]
    scale = scale if scale is not None else D ** -0.5
    if G > 1:  # each KV head repeats G times in a row, as jnp.repeat
        k = k.repeat_interleave(G, dim=2)
        v = v.repeat_interleave(G, dim=2)
    q, k, v = shard_heads(q), shard_heads(k), shard_heads(v)
    args = (q_pos, k_pos, causal, window, scale, q_chunk, chunk_remat)
    if _split_on_batch_and_heads(q, k, v):
        from torch.distributed.tensor import DTensor

        out = _attend(q.to_local(), k.to_local(), v.to_local(), *args).contiguous()
        shape = (*q.shape[:3], v.shape[3])
        return DTensor.from_local(out, q.device_mesh, q.placements, run_check=False,
                                  shape=torch.Size(shape), stride=contiguous_stride(shape))
    return _attend(q, k, v, *args)


def contiguous_stride(shape) -> tuple:
    """The strides of a contiguous tensor of ``shape`` (a ``DTensor``'s
    global stride, for ``DTensor.from_local``)."""
    stride = [1] * len(shape)
    for d in range(len(shape) - 2, -1, -1):
        stride[d] = stride[d + 1] * shape[d + 1]
    return tuple(stride)


def _split_on_batch_and_heads(q, k, v) -> bool:
    """Whether q, k and v are ``DTensor``s placed alike and split over batch
    (dim 0) or heads (dim 2) only.  Attention is then independent shard by
    shard and runs on the local tensors, with no collective: ``DTensor``'s
    own ``einsum`` flattens (batch, heads) into one dim before its ``bmm``,
    and torch 2.11 refuses that view when both are split."""
    if not all(is_dtensor(t) for t in (q, k, v)):
        return False
    pl = q.placements
    return (k.placements == pl and v.placements == pl
            and all(p.is_replicate() or (p.is_shard() and p.dim in (0, 2)) for p in pl))


def _attend(q, k, v, q_pos, k_pos, causal, window, scale, q_chunk, chunk_remat):
    Sq = q.shape[1]
    if Sq <= q_chunk or Sq % q_chunk != 0:
        return _attend_block(q, k, v, q_pos, k_pos, causal, window, scale)
    block = (_attend_block if not (chunk_remat and torch.is_grad_enabled())
             else lambda *a: checkpoint(_attend_block, *a, use_reentrant=False))
    return torch.cat([
        block(q[:, s:s + q_chunk], k, v, q_pos[s:s + q_chunk], k_pos,
              causal, window, scale)
        for s in range(0, Sq, q_chunk)], dim=1)


# ---------------------------------------------------------------------------
# MLPs (SwiGLU for silu, plain 2-layer for gelu)
# ---------------------------------------------------------------------------

class MLP(nn.Module):
    """SwiGLU (``w_gate``, ``w_up``, ``w_down``) or plain 2-layer weights."""

    def __init__(self, d: int, d_ff: int, act: str, dtype, device):
        super().__init__()
        if act == "silu":
            self.w_gate = new_param((d, d_ff), dtype, device)
        self.w_up = new_param((d, d_ff), dtype, device)
        self.w_down = new_param((d_ff, d), dtype, device)

    def reset_parameters(self, generator):
        for w in self.parameters(recurse=False):
            dense_init_(w, generator)


def mlp_apply(p, x, act: str):
    if act == "silu":
        return linear(F.silu(linear(x, p.w_gate)) * linear(x, p.w_up), p.w_down)
    # jax.nn.gelu's default is the tanh form
    return linear(F.gelu(linear(x, p.w_up), approximate="tanh"), p.w_down)
