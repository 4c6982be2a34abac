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
* ``moe_remat`` (with gradients on): each chunk is recomputed once in the
  backward, as ``repro``'s ``jax.checkpoint`` of its chunk loop, also inside
  a remat period (``_LoopInputs``).
"""
from __future__ import annotations

from types import SimpleNamespace

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
    _redistributed,
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


def _ep_dim(w):
    """The mesh dim whose "model" axis splits the experts of ``w`` (E, a,
    b), ``repro``'s expert parallelism; None off such a mesh."""
    if not is_dtensor(w):
        return None
    names = w.device_mesh.mesh_dim_names or ()
    i = names.index("model") if "model" in names else None
    return i if i is not None and w.placements[i].is_shard(0) else None


def _placed(t, i, dim=None):
    """``t`` split over its ``dim`` on mesh dim ``i``, or whole there
    (``dim`` None); the identity where ``i`` is None or ``t`` is no
    ``DTensor``."""
    if i is None or not is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate, Shard

    pl = list(t.placements)
    pl[i] = Replicate() if dim is None else Shard(dim)
    return _redistributed(t, pl)


def _expert_split(xe, w):
    """The dispatched tokens (..., E, C, d) as the expert products take
    them: a partial sum (the dispatch contracted tokens split over a mesh
    dim: the sequence where the experts are whole over "model", the flat
    tokens over the data axes) made whole through a reduce-scatter and an
    all-gather, an all-reduce's bytes, so that its gradient comes back
    whole too (a direct all-reduce's stays partial, and the dispatch's
    backward then gathers its mask and contracts every token on every
    device); on a mesh whose "model" axis splits the experts of ``w``,
    split over the experts the same way and the batch dim (grouped) over
    the data axes.  The identity off a mesh."""
    mesh = sharding_mesh()
    if mesh is None or not is_dtensor(xe):
        return xe
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.distributed.sharding import PartitionSpec, act_spec

    part = [p.is_partial() for p in xe.placements]
    if any(part):
        d = xe.ndim - 1
        mid = list(xe.placements)
        i = part.index(True)
        if xe.shape[d] % mesh.size(i) == 0 and Shard(d) not in mid:
            mid[i] = Shard(d)
        xe = _redistributed(_redistributed(xe, mid),
                            [Replicate() if q else p for p, q in zip(mid, part)])
    if _ep_dim(w) is None:
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
    """xe (..., E, C, d) through each expert's SwiGLU, on a mesh whose
    "model" axis splits the experts each device over its own
    (``_expert_split``)."""
    xe = _expert_split(xe, p.w_gate)
    h = F.silu(_per_expert(xe, p.w_gate.to(dtype)))
    h = h * _per_expert(xe, p.w_up.to(dtype))
    return _per_expert(h, p.w_down.to(dtype))


def _dispatch_combine(p, routes, gate_vals, C: int, xc, spec: str):
    """GShard's dispatch and combine around the experts: ``spec`` is the
    dispatch's ``einsum`` (``"nec,nd->ecd"`` flat, ``"bsec,bsd->becd"``
    grouped).  On a mesh whose "model" axis splits the experts, as XLA
    partitions ``repro``'s: the tokens come whole over "model"
    (``moe_apply``) and each device slices its own experts' columns of
    the one-hot masks (no collective: the routing is whole there), so the
    dispatch writes its experts' slots with no partial sum; the combine
    contracts its own experts into a partial sum, reduced once
    (``reduce_partial``).  In the backward each product again covers its
    own experts, and the gates' gradients reduce as (.., k) sums, not as
    masks.  (The combine's subscripts name C ``f``, after E: ``einsum``
    folds its summed dims in letter order, and E, the split one, must
    come first.)"""
    dispatch, combine = _masks(routes, gate_vals, C, _ep_dim(p.w_gate))
    xe = torch.einsum(spec, dispatch.to(xc.dtype), xc)
    ye = _experts_ffn(p, xe, xc.dtype)
    out = "nef,efd->nd" if spec[0] == "n" else "bsef,befd->bsd"
    return reduce_partial(torch.einsum(out, combine.to(xc.dtype), ye), xc.ndim - 2)


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

    return _dispatch_combine(p, routes, gate_vals, C, xc, "nec,nd->ecd"), lb_loss, z_loss


def _masks(routes, gate_vals, C: int, ep_dim=None):
    """GShard's (..., E, C) dispatch (bool) and combine (float32) masks;
    with ``ep_dim``, each choice's one-hot split over E on that mesh dim
    before its gate multiplies it."""
    iota_c = torch.arange(C, dtype=torch.int32, device=gate_vals.device)
    dispatch = combine = None
    for j, (_, pos_tok, oh_e) in enumerate(routes):
        oh_c = (pos_tok[..., None] == iota_c) & (pos_tok < C)[..., None]
        dm = _placed(oh_e[..., None] & oh_c[..., None, :], ep_dim, oh_e.ndim - 1)
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
    routes = _slots(expert_idx, E, axis=1)
    lb_loss, z_loss = _aux(probs, logits, expert_idx, E, (0, 1))
    return _dispatch_combine(p, routes, gate_vals, C, xc, "bsec,bsd->becd"), lb_loss, z_loss


def _run_chunks(chunk_fn, src, cfg, dim: int, size: int, remat: bool):
    """Every chunk of ``size`` along ``dim`` of the loop's input in order:
    (the chunks' outputs joined along ``dim``, the summed load-balance and
    z losses).  With ``remat``, each chunk a ``checkpoint``."""
    x = src.get()[0]
    lb = z = x.new_zeros((), dtype=torch.float32)   # a DTensor on a mesh
    ys = []
    for c in range(x.shape[dim] // size):
        if remat:
            yc, lb_c, z_c = checkpoint(_chunk, chunk_fn, src, c, cfg, dim, size,
                                       use_reentrant=False)
        else:
            yc, lb_c, z_c = _chunk(chunk_fn, src, c, cfg, dim, size)
        lb, z = lb + lb_c, z + z_c
        ys.append(yc)
    return torch.cat(ys, dim), lb, z


def _chunk(chunk_fn, src, c, cfg, dim, size):
    x, *ws = src.get()
    return chunk_fn(SimpleNamespace(**dict(zip(_ROUTED, ws))), x.narrow(dim, c * size, size), cfg)


class _SaveInputs(torch.autograd.Function):
    """Its inputs, saved for a backward and passed on."""

    @staticmethod
    def forward(ctx, *ts):
        ctx.save_for_backward(*ts)
        return tuple(t.view_as(t) for t in ts)

    @staticmethod
    def backward(ctx, *grads):
        return grads


class _LoopInputs:
    """The routed loop's input and weights.  With gradients on they pass
    through ``_SaveInputs``, which saves them before the shared experts and
    the first chunk run, and a chunk's ``checkpoint`` (``moe_remat``) takes
    no tensor: it reads them here, from the tensors themselves while the
    forward runs and from the saved ones when it recomputes.  So every
    tensor that a remat period's recompute must rebuild is saved before the
    loop runs, and that recompute stops there (``checkpoint``'s early
    stop): each chunk runs once forward and once in the backward, as in
    ``repro``'s compiled step, where XLA drops the loop's recompute in the
    period, whose outputs its backward never reads.  (A ``checkpoint`` a
    chunk with its own inputs would run every chunk but the last three
    times.)  The loop's gradients gather at the one node with or without
    ``moe_remat``, so both sum them in the same order."""

    def __init__(self, x, ws):
        self.saver = None
        self.ts = (x, *ws)
        if torch.is_grad_enabled() and any(t.requires_grad for t in self.ts):
            self.ts = _SaveInputs.apply(*self.ts)
            self.saver = self.ts[0].grad_fn

    def forward_done(self):
        if self.saver is not None:
            self.ts = None

    def get(self):
        if self.ts is None:   # a recompute: unpack once (``checkpoint`` allows one)
            self.ts = tuple(self.saver.saved_tensors)
        return self.ts


_ROUTED = ("router", "w_gate", "w_up", "w_down")


def moe_apply(p, x, cfg):
    """x (B, S, d) -> (y (B, S, d), aux dict of scalar losses)."""
    B, S, d = x.shape
    # on a mesh that splits the experts, the tokens whole over "model" once,
    # for the router, the dispatch and the shared experts
    x = _placed(x, _ep_dim(p.w_gate))
    if cfg.moe_group == "seq":
        chunk_fn, dim, size = _grouped_chunk_moe, 1, max(1, min(cfg.moe_group_seq, S))
        n_chunks = -(-S // size)
        xs = pad_seq(x, n_chunks * size - S)
    else:
        N = B * S
        chunk_fn, dim, size = _chunk_moe, 0, min(cfg.moe_chunk, N)
        n_chunks = -(-N // size)
        pad = n_chunks * size - N
        xs = x.reshape(N, d)
        if pad:
            xs = torch.cat([xs, xs.new_zeros((pad, d))])
    src = _LoopInputs(xs, [getattr(p, name) for name in _ROUTED])
    shared = mlp_apply(p.shared, x, "silu") if cfg.n_shared_experts else None
    remat = cfg.moe_remat and src.saver is not None
    y, lb, z = _run_chunks(chunk_fn, src, cfg, dim, size, remat)
    src.forward_done()
    y = y[:, :S] if dim else y[:N].reshape(B, S, d)
    if shared is not None:
        y = y + shared
    return y, {"moe_lb_loss": lb / n_chunks, "moe_z_loss": z / n_chunks}
