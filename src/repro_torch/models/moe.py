"""Top-k routed Mixture-of-Experts with token-chunked GShard dispatch (the
port of ``repro.models.moe``).

* capacity is per chunk: ``C = max(1, ceil(int(Nc * top_k * cf) / E))``;
  tokens past it are dropped (they pass through the residual stream);
* priority is choice-major: choice j's slots start after the counts of the
  choices before it;
* router: softmax over all experts, top-k (ties to the lower index, as
  ``lax.top_k``), renormalised gates; a Switch-style load-balance loss and
  the router z-loss, averaged over chunks;
* ``moe_group="flat"`` routes chunks of ``moe_chunk`` flattened tokens (the
  zero pad tokens of the last chunk are routed too and take slots);
  ``"seq"`` routes each batch row in groups of ``moe_group_seq`` positions;
* shared experts (DeepSeek-V2) run densely on every token;
* ``moe_remat`` (with gradients on): each chunk's dispatch is recomputed in
  the backward, as ``repro``'s ``jax.checkpoint`` of its chunk loop.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models.layers import (
    MLP,
    constrain,
    dense_init_,
    is_dtensor,
    linear,
    local_product,
    mlp_apply,
    new_param,
    pad_seq,
    reduce_partial,
    sharding_mesh,
)

__all__ = ["MoE", "moe_apply"]


class MoE(nn.Module):
    def __init__(self, cfg, dtype, device):
        super().__init__()
        d, E, ff = cfg.d_model, cfg.n_experts, cfg.expert_d_ff
        self.router = new_param((d, E), dtype, device)
        self.w_gate = new_param((E, d, ff), dtype, device)
        self.w_up = new_param((E, d, ff), dtype, device)
        self.w_down = new_param((E, ff, d), dtype, device)
        if cfg.n_shared_experts:
            self.shared = MLP(d, ff * cfg.n_shared_experts, "silu", dtype, device)

    def reset_parameters(self, generator):
        dense_init_(self.router, generator, scale=0.02)
        for w in (self.w_gate, self.w_up, self.w_down):
            dense_init_(w, generator)


def _top_k(probs, k: int):
    """``lax.top_k``: the k largest along the last axis, ties to the lower
    index (a stable descending sort keeps equal values in index order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k].to(torch.int32)


def _capacity(n: int, cfg) -> int:
    return max(1, -(-int(n * cfg.top_k * cfg.capacity_factor) // cfg.n_experts))


def _slots(expert_idx, E: int, axis: int):
    """Per choice ``(e_j, pos_tok, one-hot (.., E))``: a token's slot in its
    expert, counting along ``axis`` after every earlier choice's tokens."""
    iota_e = torch.arange(E, dtype=torch.int32, device=expert_idx.device)
    base = None
    routes = []
    for j in range(expert_idx.shape[-1]):                 # choice-major priority
        e_j = expert_idx[..., j]
        oh_e = e_j[..., None] == iota_e
        cnt = oh_e.to(torch.int32)
        pos = torch.cumsum(cnt, dim=axis, dtype=torch.int32) - 1
        if base is not None:
            pos = pos + base.unsqueeze(axis)
        pos_tok = torch.where(oh_e, pos, 0).sum(-1, dtype=torch.int32)
        total = cnt.sum(axis, dtype=torch.int32)
        base = total if base is None else base + total
        routes.append((e_j, pos_tok, oh_e))
    return routes


def _aux(probs, logits, expert_idx, E: int, dims):
    me = probs.mean(dim=dims)
    top1 = F.one_hot(expert_idx[..., 0].long(), E).float()
    lb_loss = E * torch.sum(me * top1.mean(dim=dims))
    z_loss = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    return lb_loss, z_loss


def _router(p, xc):
    logits = linear(xc, p.router).float()
    probs = torch.softmax(logits, dim=-1)
    return logits, probs


def _expert_split(xe, w):
    """On a mesh whose "model" axis splits the experts of ``w`` (``repro``'s
    expert parallelism), the dispatched tokens (..., E, C, d) are split
    over the experts the same way and their batch dim over the data axes:
    the dispatch's partial sums reduce-scatter onto each device's experts,
    as XLA partitions ``repro``'s dispatch.  The identity otherwise."""
    mesh = sharding_mesh()
    if mesh is None or not (is_dtensor(xe) and is_dtensor(w)):
        return xe
    from torch.distributed.tensor import Shard

    from repro_torch.distributed.sharding import PartitionSpec, act_spec, mesh_axes

    axes = list(mesh_axes(mesh))
    if "model" not in axes or w.placements[axes.index("model")] != Shard(0):
        return xe
    spec = [None] * xe.ndim
    if xe.ndim == 4:                       # grouped: (B, E, C, d)
        spec[0] = act_spec(xe.shape[:1], mesh)[0]
    spec[-3] = "model"
    return constrain(xe, PartitionSpec(*spec), mesh)


def _per_expert(x, w):
    """x (..., E, C, a) @ w (E, a, b), expert by expert; on ``DTensor``s
    ``local_product`` over x's E (``DTensor``'s ``einsum`` backward also
    fails on a non-contiguous local shard here)."""
    if is_dtensor(x):
        return local_product(x, w, e=x.ndim - 3)
    return torch.einsum("...ecd,edf->...ecf", x, w)


def _experts_ffn(p, xe, dtype):
    """xe (..., E, C, d) through each expert's SwiGLU.  On a mesh whose
    "model" axis splits the experts, the tokens go in split over the
    experts (``_expert_split``).  The combine einsum then flattens C with
    E, which ``DTensor`` refuses when C does not divide that axis
    (deepseek-v2's C = 39 on 16): there the outputs come out replicated
    over "model", one all-gather of (..., E, C, d) a chunk."""
    split = _expert_split(xe, p.w_gate)
    h = F.silu(_per_expert(split, p.w_gate.to(dtype)))
    h = h * _per_expert(split, p.w_up.to(dtype))
    y = _per_expert(h, p.w_down.to(dtype))
    names = y.device_mesh.mesh_dim_names if split is not xe else ()
    if "model" not in names or y.shape[-2] % y.device_mesh.size(names.index("model")) == 0:
        return y
    from torch.distributed.tensor import Replicate

    return y.redistribute(y.device_mesh, [Replicate() if n == "model" else pl
                                          for n, pl in zip(names, y.placements)])


def _split_like_experts(mask, ye):
    """The combine mask (..., E, C) and the expert outputs ``ye`` (..., E,
    C, d), split over their experts and batch alike (``ye`` also over d)
    and whole otherwise: the mask by a local slice where it is replicated.
    The combine then contracts each device's own experts into a partial
    sum, as XLA partitions ``repro``'s combine; left alone, ``DTensor``
    gathers ``ye``'s experts and every device combines all of them, and a
    split of C would sit inside the (E, C) fold the ``einsum`` makes, which
    torch 2.11 refuses.  (The combine's subscripts name C ``f``, after E:
    ``einsum`` folds its summed dims in letter order, and E, the split
    one, must come first.)  The identity off a mesh."""
    if not (is_dtensor(mask) and is_dtensor(ye)):
        return mask, ye
    from torch.distributed.tensor import Replicate, Shard

    e, d = ye.ndim - 3, ye.ndim - 1        # ye's expert dim: 1 if grouped
    mp, yp = [], []
    for py in ye.placements:
        batch = bool(e) and py == Shard(0)
        yp.append(py if py in (Shard(e), Shard(d)) or batch else Replicate())
        mp.append(Shard(mask.ndim - 2) if py == Shard(e) else py if batch else Replicate())
    return mask.redistribute(mask.device_mesh, mp), ye.redistribute(ye.device_mesh, yp)


def _chunk_moe(p, xc, cfg):
    """One token chunk: (Nc, d) -> (Nc, d), plus aux-loss stats.

    ``cfg.moe_dispatch``: ``"einsum"`` builds GShard's one-hot (Nc, E, C)
    dispatch and combine masks; ``"scatter"`` adds each kept token into an
    (E*C, d) buffer (a trash row takes the dropped) and gathers back."""
    Nc, d = xc.shape
    E, k = cfg.n_experts, cfg.top_k
    C = _capacity(Nc, cfg)
    logits, probs = _router(p, xc)
    gate_vals, expert_idx = _top_k(probs, k)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True)
    routes = _slots(expert_idx, E, axis=0)
    lb_loss, z_loss = _aux(probs, logits, expert_idx, E, 0)

    if cfg.moe_dispatch == "scatter":
        buf = torch.zeros((E * C + 1, d), dtype=xc.dtype, device=xc.device)
        for e_j, pos_tok, _ in routes:
            slot = torch.where(pos_tok < C, e_j * C + pos_tok, E * C)
            buf.index_add_(0, slot, xc)
        ye = _experts_ffn(p, buf[:E * C].reshape(E, C, d), xc.dtype).reshape(E * C, d)
        yc = torch.zeros((Nc, d), dtype=xc.dtype, device=xc.device)
        for j, (e_j, pos_tok, _) in enumerate(routes):
            slot = torch.clamp(e_j * C + pos_tok, 0, E * C - 1)
            g = (gate_vals[:, j] * (pos_tok < C)).to(xc.dtype)
            yc = yc + ye[slot] * g[:, None]
        return yc, lb_loss, z_loss

    dispatch, combine = _masks(routes, gate_vals, C)
    xe = torch.einsum("nec,nd->ecd", dispatch.to(xc.dtype), xc)
    ye = _experts_ffn(p, xe, xc.dtype)
    combine, ye = _split_like_experts(combine.to(xc.dtype), ye)
    yc = reduce_partial(torch.einsum("nef,efd->nd", combine, ye), 1)
    return yc, lb_loss, z_loss


def _masks(routes, gate_vals, C: int):
    """GShard's (..., E, C) dispatch (bool) and combine (float32) masks."""
    iota_c = torch.arange(C, dtype=torch.int32, device=gate_vals.device)
    dispatch = combine = None
    for j, (_, pos_tok, oh_e) in enumerate(routes):
        oh_c = (pos_tok[..., None] == iota_c) & (pos_tok < C)[..., None]
        dm = oh_e[..., None] & oh_c[..., None, :]
        term = dm * gate_vals[..., j, None, None]
        dispatch = dm if dispatch is None else dispatch | dm
        combine = term if combine is None else combine + term
    return dispatch, combine


def _grouped_chunk_moe(p, xc, cfg):
    """Grouped (GShard-style) chunk: (B, Sc, d) -> (B, Sc, d) + aux.

    Routing, slot positions and capacity ``C = ceil(Sc * k * cf / E)`` are
    per batch row: the position cumsum runs along the sequence axis."""
    B, Sc, d = xc.shape
    E, k = cfg.n_experts, cfg.top_k
    C = _capacity(Sc, cfg)
    logits, probs = _router(p, xc)
    gate_vals, expert_idx = _top_k(probs, k)               # (B, Sc, k)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True)
    dispatch, combine = _masks(_slots(expert_idx, E, axis=1), gate_vals, C)

    xe = torch.einsum("bsec,bsd->becd", dispatch.to(xc.dtype), xc)
    ye = _experts_ffn(p, xe, xc.dtype)
    combine, ye = _split_like_experts(combine.to(xc.dtype), ye)
    yc = reduce_partial(torch.einsum("bsef,befd->bsd", combine, ye), 1)
    lb_loss, z_loss = _aux(probs, logits, expert_idx, E, (0, 1))
    return yc, lb_loss, z_loss


def moe_apply(p, x, cfg):
    """x (B, S, d) -> (y (B, S, d), aux dict of scalar losses)."""
    B, S, d = x.shape
    lb = z = x.new_zeros((), dtype=torch.float32)   # a DTensor on a mesh
    ys = []
    remat = cfg.moe_remat and torch.is_grad_enabled()

    def run(chunk_fn, xc):
        if remat:
            return checkpoint(chunk_fn, p, xc, cfg, use_reentrant=False)
        return chunk_fn(p, xc, cfg)

    if cfg.moe_group == "seq":
        Sc = max(1, min(cfg.moe_group_seq, S))
        n_chunks = -(-S // Sc)
        pad = n_chunks * Sc - S
        xg = pad_seq(x, pad)
        for c in range(n_chunks):
            yc, lb_c, z_c = run(_grouped_chunk_moe, xg[:, c * Sc:(c + 1) * Sc])
            lb, z = lb + lb_c, z + z_c
            ys.append(yc)
        y = torch.cat(ys, dim=1)[:, :S]
    else:
        N = B * S
        chunk = min(cfg.moe_chunk, N)
        n_chunks = -(-N // chunk)
        pad = n_chunks * chunk - N
        xf = x.reshape(N, d)
        if pad:
            xf = torch.cat([xf, xf.new_zeros((pad, d))])
        for c in range(n_chunks):
            yc, lb_c, z_c = run(_chunk_moe, xf[c * chunk:(c + 1) * chunk])
            lb, z = lb + lb_c, z + z_c
            ys.append(yc)
        y = torch.cat(ys)[:N].reshape(B, S, d)

    if cfg.n_shared_experts:
        y = y + mlp_apply(p.shared, x, "silu")
    return y, {"moe_lb_loss": lb / n_chunks, "moe_z_loss": z / n_chunks}
