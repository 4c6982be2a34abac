"""Composable decoder/encoder stack covering all assigned families (the port
of ``repro.models.transformer``).

``repro`` plans the layers as *segments* (plain layers, then scanned runs of
whole periods) and stacks a scanned segment's weights on a leading axis.
The port keeps the plan, which says how a ``repro`` parameter tree unstacks
(``models/convert.py``), and holds one ``Block`` per layer in model order,
run in a Python loop.

Modes: ``forward``/``train`` (full sequence, no cache), ``prefill`` (full
sequence, fills per-layer caches), ``decode`` (one token, reads and writes
the caches in place).  With ``cfg.remat``, mode ``train`` recomputes each
``Block`` in the backward pass (``torch.utils.checkpoint``), as ``repro``
wraps each scanned period in ``jax.checkpoint``.
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import rwkv6
from repro_torch.models.layers import (
    DTYPES,
    MLP,
    Norm,
    _head_rmsnorm,
    _redistributed,
    attention,
    cache_write,
    channels_split,
    constrain,
    dense_init_,
    gather_operand,
    heads_spec,
    is_dtensor,
    linear,
    mlp_apply,
    new_param,
    norm_apply,
    rope_apply,
    sharding_mesh,
    split_heads,
    whole_channels,
)
from repro_torch.models.mla import MLA, mla_attention, mla_decode_absorbed
from repro_torch.models.moe import MoE, moe_apply
from repro_torch.models.rglru import RGLRU, rglru_apply, rglru_decode_step

__all__ = ["Segment", "layer_specs", "plan_segments", "Attention", "Block",
           "cache_layout", "init_cache", "residual_spec", "make_constrainer", "apply_stack"]


@dataclasses.dataclass(frozen=True)
class Segment:
    kind: str                 # "scan" | "plain"
    specs: tuple[tuple[str, str], ...]   # per-layer (block, ffn) within a period
    count: int                # scan length (periods) or 1 for plain


def layer_specs(cfg: ModelConfig) -> list[tuple[str, str]]:
    specs = []
    for kind, ffn in zip(cfg.layer_kinds(), cfg.ffn_kinds()):
        if cfg.family == "rwkv":
            specs.append(("rwkv", "none"))
        elif kind == "rec":
            specs.append(("rec", "dense"))
        else:
            specs.append(("mla" if cfg.mla else "attn", ffn))
    return specs


def plan_segments(cfg: ModelConfig) -> list[Segment]:
    """``repro``'s segments: the leading dense layers, then the full periods
    (one scanned segment), then the trailing partial period, in layer order."""
    specs = layer_specs(cfg)
    segments: list[Segment] = []
    start = cfg.first_dense_layers
    for i in range(start):
        segments.append(Segment("plain", (specs[i],), 1))
    period = max(len(cfg.pattern), 1)
    rest = specs[start:]
    n_full = len(rest) // period
    if n_full:
        segments.append(Segment("scan", tuple(rest[:period]), n_full))
    for s in rest[n_full * period:]:
        segments.append(Segment("plain", (s,), 1))
    return segments


# ---------------------------------------------------------------------------
# per-block weights
# ---------------------------------------------------------------------------

class Attention(nn.Module):
    def __init__(self, cfg, dtype, device):
        super().__init__()
        d, Hq, Hkv, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        self.wq = new_param((d, Hq * Dh), dtype, device)
        self.wk = new_param((d, Hkv * Dh), dtype, device)
        self.wv = new_param((d, Hkv * Dh), dtype, device)
        self.wo = new_param((Hq * Dh, d), dtype, device)
        if cfg.qk_norm:
            self.q_norm = new_param((Dh,), dtype, device)
            self.k_norm = new_param((Dh,), dtype, device)

    @torch.no_grad()
    def reset_parameters(self, generator):
        for w in (self.wq, self.wk, self.wv, self.wo):
            dense_init_(w, generator)
        if hasattr(self, "q_norm"):
            self.q_norm.fill_(1.0)
            self.k_norm.fill_(1.0)


class Block(nn.Module):
    """One residual layer; its attributes are ``repro``'s leaf names
    (``ln1``, ``attn`` | ``rec`` | ``rwkv``, ``ln2``, ``ffn``)."""

    def __init__(self, cfg, spec, device):
        super().__init__()
        self.spec = spec
        block, ffn = spec
        dtype = DTYPES[cfg.param_dtype]
        d = cfg.d_model
        self.ln1 = Norm(d, cfg.norm, dtype, device)
        if block == "attn":
            self.attn = Attention(cfg, dtype, device)
        elif block == "mla":
            self.attn = MLA(cfg, dtype, device)
        elif block == "rec":
            self.rec = RGLRU(cfg, dtype, device)
        elif block == "rwkv":
            self.rwkv = rwkv6.RWKV(cfg, dtype, device)
        else:
            raise ValueError(block)
        if block == "rwkv" or ffn != "none":
            self.ln2 = Norm(d, cfg.norm, dtype, device)
        if ffn == "moe":
            self.ffn = MoE(cfg, dtype, device)
        elif ffn == "dense":
            self.ffn = MLP(d, cfg.d_ff, cfg.act, dtype, device)


# ---------------------------------------------------------------------------
# per-block caches
# ---------------------------------------------------------------------------

def _block_cache(cfg, spec, B, T, dtype):
    block, _ = spec
    Hkv, Dh = cfg.n_kv_heads, cfg.head_dim

    def leaf(*shape, dt=dtype):
        return shape, dt

    if block == "attn":
        Tc = min(T, cfg.window) if cfg.window else T
        return {"k": leaf(B, Tc, Hkv, Dh), "v": leaf(B, Tc, Hkv, Dh)}
    if block == "mla":
        return {"ckv": leaf(B, T, cfg.kv_lora), "krope": leaf(B, T, cfg.qk_rope_dim)}
    if block == "rec":
        return {"h": leaf(B, cfg.d_rnn, dt=torch.float32),
                "conv": leaf(B, cfg.conv_width - 1, cfg.d_rnn)}
    if block == "rwkv":
        H = cfg.d_model // cfg.rwkv_head_dim
        K = cfg.rwkv_head_dim
        return {"state": leaf(B, H, K, K, dt=torch.float32),
                "sa": leaf(B, cfg.d_model), "sc": leaf(B, cfg.d_model)}
    raise ValueError(block)


def cache_layout(cfg: ModelConfig, B: int, T: int) -> list[dict]:
    """Each layer's cache leaves as ``{name: (shape, dtype)}``, in model
    order; nothing is allocated."""
    dtype = DTYPES[cfg.act_dtype]
    return [_block_cache(cfg, spec, B, T, dtype) for spec in layer_specs(cfg)]


def init_cache(cfg: ModelConfig, B: int, T: int, device) -> list[dict]:
    """Zero caches, one dict per layer in model order."""
    return [{k: torch.zeros(shape, dtype=dt, device=device) for k, (shape, dt) in layer.items()}
            for layer in cache_layout(cfg, B, T)]


# ---------------------------------------------------------------------------
# block apply
# ---------------------------------------------------------------------------

def _ring_kpos(pos: int, Wd: int, device):
    s = torch.arange(Wd, dtype=torch.int32, device=device)
    return pos - torch.remainder(pos - s, Wd)


def _attn_qkv(p, x, positions, cfg):
    Hq, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    x = gather_operand(x, p.wq, p.wk, p.wv)
    q = split_heads(linear(x, p.wq), Hq, Dh)
    k = split_heads(linear(x, _cols_as_heads(p.wk, x, Hkv, Dh)), Hkv, Dh)
    v = split_heads(linear(x, _cols_as_heads(p.wv, x, Hkv, Dh)), Hkv, Dh)
    if cfg.qk_norm:
        q = _head_rmsnorm(q, p.q_norm)
        k = _head_rmsnorm(k, p.k_norm)
    q = rope_apply(q, positions, cfg.rope_theta)
    k = rope_apply(k, positions, cfg.rope_theta)
    return q, k, v


def _cols_as_heads(w, x, H: int, D: int):
    """A projection ``w`` (d, H*D) for one token (a batch-1 decode step):
    on each mesh dim where ``w`` is whole and the projected heads (1, 1,
    H, D) split as a block of its columns (whole heads, or one head's D),
    its columns split there (a slice), so the token's product splits its
    output as the heads then split, as XLA splits ``repro``'s; ``w``
    elsewhere."""
    if not (is_dtensor(w) and is_dtensor(x)) or math.prod(x.shape[:-1]) != 1:
        return w
    from torch.distributed.tensor import Shard

    from repro_torch.distributed.sharding import NamedSharding

    mesh = w.device_mesh
    heads = NamedSharding(mesh, heads_spec((1, 1, H, D), mesh)).placements
    return _redistributed(w, [Shard(1) if pw.is_replicate() and (
        ph == Shard(2) or (ph == Shard(3) and H == 1)) else pw
        for pw, ph in zip(w.placements, heads)])


def _merged_heads(out):
    """The attention's output (B, S, H, Dh) as (B, S, H * Dh).  On a
    ``DTensor`` split over Dh (heads that do not divide "model") it is
    gathered over Dh first: the merge would leave a strided split (no block
    of ``wo``'s rows), which the product gathers anyway, and torch 2.11's
    ``DTensor`` refuses the merge of a split Dh."""
    B, S = out.shape[:2]
    if out.shape[2] > 1 and channels_split(out):
        out = whole_channels(out)
    return out.reshape(B, S, -1)


def _attn_block(p, x, cfg, positions, mode, cache, pos):
    B, S, _ = x.shape
    if mode != "decode":
        q, k, v = _attn_qkv(p, x, positions, cfg)
        out = attention(q, k, v, q_pos=positions, k_pos=positions,
                        causal=cfg.causal, window=cfg.window,
                        q_chunk=cfg.attn_q_chunk, chunk_remat=cfg.attn_chunk_remat)
        y = linear(_merged_heads(out), p.wo, reduce_dims=(1,))
        if mode == "prefill":
            if cfg.window and cfg.window < S:          # ring buffer: last Wd keys
                # key S - Wd + j goes to slot (S - Wd + j) % Wd: a roll by
                # r, as two slices (``DTensor`` has no rule for ``roll``)
                Wd = cfg.window
                r = (S - Wd) % Wd
                for name, t in (("k", k), ("v", v)):
                    last = t[:, S - Wd:]
                    cache_write(cache[name], 0, torch.cat([last[:, Wd - r:], last[:, :Wd - r]], 1))
            else:
                cache_write(cache["k"], 0, k)
                cache_write(cache["v"], 0, v)
        return y

    # ---- decode: one token at position ``pos`` ----------------------------
    q, k, v = _attn_qkv(p, x, positions, cfg)
    Tc = cache["k"].shape[1]
    if cfg.window and Tc == cfg.window:
        slot = pos % Tc
        k_pos = _ring_kpos(pos, Tc, x.device)
    else:
        slot = pos
        k_pos = torch.arange(Tc, dtype=torch.int32, device=x.device)
    cache_write(cache["k"], slot, k)
    cache_write(cache["v"], slot, v)
    out = attention(q, cache["k"], cache["v"], q_pos=positions, k_pos=k_pos,
                    causal=True, window=None, q_chunk=cfg.attn_q_chunk)
    return linear(_merged_heads(out), p.wo)


def _mla_block(p, x, cfg, positions, mode, cache, pos):
    if mode != "decode":
        y, (c_kv, k_rope) = mla_attention(p, x, positions, cfg)
        if mode == "prefill":
            cache_write(cache["ckv"], 0, c_kv)
            cache_write(cache["krope"], 0, k_rope)
        return y
    y, _, _ = mla_decode_absorbed(p, x, pos, cache["ckv"], cache["krope"], cfg)
    return y


def _block_apply(p, x, cfg, positions, mode, cache, pos):
    """One layer; ``cache`` (prefill and decode) is updated in place.
    Returns (x, (lb_loss, z_loss)) or (x, None) for a layer with no MoE."""
    block, ffn = p.spec
    h = norm_apply(p.ln1, x, cfg.norm)
    if block == "attn":
        y = _attn_block(p.attn, h, cfg, positions, mode, cache, pos)
    elif block == "mla":
        y = _mla_block(p.attn, h, cfg, positions, mode, cache, pos)
    elif block == "rec":
        if mode == "decode":
            y, cache["h"], cache["conv"] = rglru_decode_step(
                p.rec, h, cache["h"], cache["conv"])
        else:
            y, (hst, conv) = rglru_apply(p.rec, h)
            if mode == "prefill":
                cache["h"], cache["conv"] = hst, conv.to(cache["conv"].dtype)
    elif block == "rwkv":
        H = cfg.d_model // cfg.rwkv_head_dim
        if mode == "decode":
            y, cache["sa"], cache["state"] = rwkv6.rwkv_time_mix_step(
                p.rwkv, h, H, cache["sa"], cache["state"])
        else:
            y, (sa, state) = rwkv6.rwkv_time_mix(p.rwkv, h, H)
            if mode == "prefill":
                cache["sa"], cache["state"] = sa, state
        x = x + y
        h2 = norm_apply(p.ln2, x, cfg.norm)
        if mode == "decode":
            y2, cache["sc"] = rwkv6.rwkv_channel_mix_step(p.rwkv, h2, cache["sc"])
        else:
            y2, sc = rwkv6.rwkv_channel_mix(p.rwkv, h2)
            if mode == "prefill":
                cache["sc"] = sc
        return x + y2, None
    else:
        raise ValueError(block)
    x = x + y

    aux = None
    if ffn != "none":
        h = norm_apply(p.ln2, x, cfg.norm)
        if ffn == "moe":
            y, moe_aux = moe_apply(p.ffn, h, cfg)
            aux = (moe_aux["moe_lb_loss"], moe_aux["moe_z_loss"])
        else:
            y = mlp_apply(p.ffn, h, cfg.act)
        x = x + y
    return x, aux


# ---------------------------------------------------------------------------
# stack apply
# ---------------------------------------------------------------------------

def residual_spec(shape, mesh):
    """``repro``'s spec for the (B, S, d) residual stream between blocks:
    batch over (pod, data), else the sequence; the sequence over "model"
    when the data axes left it (Megatron-style sequence parallelism)."""
    from repro_torch.distributed.sharding import PartitionSpec, mesh_axes

    sizes = mesh_axes(mesh)
    daxes = tuple(a for a in ("pod", "data") if a in sizes)
    dsize = math.prod(sizes[a] for a in daxes)
    msize = sizes.get("model", 1)
    B, S, _ = shape
    spec: list = [None, None, None]
    if B % dsize == 0 and B > 1:
        spec[0] = daxes
    elif S % dsize == 0 and S >= dsize:
        spec[1] = daxes
    if spec[1] is None and S % msize == 0 and S >= msize:
        spec[1] = "model"
    return PartitionSpec(*spec)


def make_constrainer(mesh):
    """The residual stream's constraint to ``residual_spec`` on ``mesh``
    (``repro``'s); None without a mesh, the identity on a plain tensor."""
    if mesh is None:
        return None

    def constrain_residual(x):
        if x.ndim != 3 or not is_dtensor(x):
            return x
        return constrain(x, residual_spec(x.shape, mesh), mesh)

    return constrain_residual


def _periods(cfg) -> list[tuple[int, int, bool]]:
    """``(first layer, layers, scanned)`` for each period of each segment,
    in layer order; a plain segment is one period of one layer."""
    out, i = [], 0
    for seg in plan_segments(cfg):
        n = len(seg.specs)
        for _ in range(seg.count):
            out.append((i, n, seg.kind == "scan"))
            i += n
    return out


def _period_apply(layers, x, cfg, positions, mode, caches, pos, constrain_residual):
    """One period's blocks (``repro``'s ``_period_apply``): the residual is
    constrained before each block and after the last.  Returns (x, aux
    (lb, z) summed over its MoE blocks, or None)."""
    aux = None
    for i, layer in enumerate(layers):
        if constrain_residual is not None:
            x = constrain_residual(x)
        x, a = _block_apply(layer, x, cfg, positions, mode,
                            caches[i] if caches is not None else None, pos)
        if a is not None:
            aux = a if aux is None else (aux[0] + a[0], aux[1] + a[1])
    if constrain_residual is not None:
        x = constrain_residual(x)
    return x, aux


def apply_stack(layers, x, cfg, positions, mode, caches=None, pos=None):
    """Run every layer in order, a period at a time.  Returns (x, {"lb":
    ..., "z": ...}); in ``prefill`` and ``decode`` mode ``caches`` (one
    dict a layer) is updated in place.  With ``cfg.remat``, mode ``train``
    recomputes each period of a scanned segment in the backward as one
    checkpoint, as ``repro`` wraps its scan body, and no plain segment's
    layer, as ``repro`` runs those outside any ``jax.checkpoint``.  Mode
    ``train`` takes no cache, so a recomputed period never reads a tensor
    written since its forward.  Under ``use_sharding_mesh`` the residual is
    constrained where ``repro``'s ``_period_apply`` does."""
    if mode == "train" and caches is not None:
        raise ValueError("mode 'train' writes no cache; got caches")
    remat = cfg.remat and mode == "train" and torch.is_grad_enabled()
    constrain_residual = make_constrainer(sharding_mesh())
    lb = z = x.new_zeros((), dtype=torch.float32)   # a DTensor on a mesh
    for i, n, scanned in _periods(cfg):
        args = (layers[i:i + n], x, cfg, positions, mode,
                caches[i:i + n] if caches is not None else None, pos, constrain_residual)
        if remat and scanned:
            x, aux = checkpoint(_period_apply, *args, use_reentrant=False)
        else:
            x, aux = _period_apply(*args)
        if aux is not None:
            lb, z = lb + aux[0], z + aux[1]
    return x, {"lb": lb, "z": z}
