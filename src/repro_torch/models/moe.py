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
  a remat period (``_LoopInputs``);
* on a mesh, a chunk is placed as XLA places ``repro``'s reshape of the
  tokens into chunks: split over the devices its positions span where
  "model" splits the sequence (``_SeqSplit``), its features split over the
  data axes where they split the flat tokens (``_flat_tokens``).
"""
from __future__ import annotations

import math
from types import SimpleNamespace

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models.layers import (
    MLP,
    constrain,
    contiguous_stride,
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
    """The router's logits and probabilities of the chunk ``xc``.  Where
    the chunk's tokens come whole over "model" for experts split over it
    and ``p`` carries the router's own chunk (``moe_apply``), the product
    takes the device's share of the positions, as XLA splits ``repro``'s
    (``_SeqSplit``'s layout), and the logits are gathered whole."""
    if getattr(p, "route_x", None) is None:
        logits = linear(_forward_features(xc), p.router).float()
    else:
        logits = _whole_logits(linear(_forward_features(p.route_x), p.route_w).float(),
                               xc.device_mesh)
    probs = torch.softmax(logits, dim=-1)
    return logits, probs


def _forward_features(xc):
    """A split chunk (``_SeqSplit``) outside autograd (a prefill) with its
    features split over "model", where it is whole: XLA splits the
    forward-only step's router and combine so, over the factor of "model"
    that the chunk's positions leave free (a train step keeps them whole,
    as its backward's products take them).  ``xc`` itself elsewhere."""
    if not _is_split(xc) or torch.is_grad_enabled() or not xc.placements[-2].is_replicate():
        return xc
    from torch.distributed.tensor import Shard

    return _redistributed(xc, (*xc.placements[:-2], Shard(xc.ndim - 1), xc.placements[-1]))


def _whole_logits(t, mesh):
    """A split chunk's (B, Sc, E) logits on the factored mesh gathered
    whole over "model_lo" and moved onto ``mesh``, the loop's, whole over
    "model" (the gather the only collective)."""
    from torch.distributed.tensor import Replicate

    whole = [*t.placements[:-2], Replicate(), Replicate()]
    return _moved(_redistributed(t, whole), mesh, whole[:-1], t.shape)


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
        if xe.shape[d] % xe.device_mesh.size(i) == 0 and Shard(d) not in mid:
            mid[i] = Shard(d)
        xe = _redistributed(_redistributed(xe, mid),
                            [Replicate() if q else p for p, q in zip(mid, part)])
    if _ep_dim(w) is None:
        return xe
    spec = [None] * xe.ndim
    if xe.ndim == 4:                       # grouped: (B, E, C, d)
        spec[0] = act_spec(xe.shape[:1], mesh)[0]
    elif _data_split_features(xe):         # flat, relaid (``_flat_tokens``)
        spec[-1] = _data_axes(mesh)
    spec[-3] = "model"
    return constrain(xe, PartitionSpec(*spec), mesh)


def _data_axes(mesh) -> tuple:
    return tuple(n for n in mesh.mesh_dim_names if n != "model")


def _data_split_features(t) -> bool:
    """Whether the data axes split ``t``'s last dim, the features (the
    flat loop's tokens after ``_flat_tokens``), and "model" does not."""
    if not is_dtensor(t):
        return False
    names = t.device_mesh.mesh_dim_names or ()
    feat = [p.is_shard() and p.dim == t.ndim - 1 for p in t.placements]
    return (len(feat) > 1 and not feat[names.index("model")]
            and all(f for f, n in zip(feat, names) if n != "model"))


def _flat_tokens(xs, size: int, w):
    """The flat loop's tokens (N, d) placed as XLA places ``repro``'s
    ``xf.reshape(n_chunks, chunk, d)`` where the data axes split N, each
    device holding whole chunks, and "model" splits the experts of ``w``
    (the tokens whole over it): the loop runs every chunk on every device,
    so the data axes' split moves from the tokens to the features (one
    all-to-all), and the dispatch, the expert products (their FSDP split
    of the features kept: no gather of the weights) and the dispatch's
    backward each take the device's features.  Unchanged elsewhere."""
    if not is_dtensor(xs) or _ep_dim(w) is None:
        return xs
    from torch.distributed.tensor import Shard

    mesh, pl = xs.device_mesh, xs.placements
    names = mesh.mesh_dim_names
    data = [i for i, n in enumerate(names) if n != "model"]
    n = math.prod(mesh.size(i) for i in data)
    N, d = xs.shape
    if (not pl[names.index("model")].is_replicate() or any(pl[i] != Shard(0) for i in data)
            or (N // n) % size or N % n or d % n
            or any(w.placements[i] != Shard(1) for i in data)):
        return xs
    return _redistributed(xs, [Shard(1) if i in data else p for i, p in enumerate(pl)])


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
    if _is_split(xc):
        tok = _token_placements(xc)
        xe = _SplitDispatch.apply(dispatch.to(xc.dtype), xc, tok)
        ye = _experts_ffn(p, xe, xc.dtype)
        if not torch.is_grad_enabled():
            return _forward_combine(combine.to(xc.dtype), ye, tok)
        cm, ye = _SaveInputs.apply(combine.to(xc.dtype), ye)
        return _SplitCombine.apply(cm, ye, tok, cm.grad_fn)
    xe = torch.einsum(spec, dispatch.to(xc.dtype), xc)
    ye = _experts_ffn(p, xe, xc.dtype)
    if _data_split_features(ye):   # the combine takes every feature, as XLA's
        from torch.distributed.tensor import Replicate

        names = ye.device_mesh.mesh_dim_names
        ye = _redistributed(ye, [p if n == "model" else Replicate()
                                 for p, n in zip(ye.placements, names)])
    out = "nef,efd->nd" if spec[0] == "n" else "bsef,befd->bsd"
    return reduce_partial(torch.einsum(out, combine.to(xc.dtype), ye), xc.ndim - 2)


def _is_split(xc) -> bool:
    """Whether ``xc`` is a chunk placed by ``_SeqSplit``."""
    return is_dtensor(xc) and (xc.device_mesh.mesh_dim_names or ())[-1:] == ("model_lo",)


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


_FACTORED: dict = {}


def _factored(mesh, m1: int, m2: int):
    """``mesh`` with its last dim ("model") factored row-major into
    ("model", "model_lo") of sizes (m1, m2): model rank ``hi * m2 + lo`` is
    (hi, lo), so a tensor split over "model" is the same shard split over
    both, nested (``Shard(k)`` on each).  One a (mesh, m1, m2)."""
    key = (id(mesh), m1, m2)
    if key not in _FACTORED:
        from torch.distributed.device_mesh import DeviceMesh

        ranks = mesh.mesh.reshape(*mesh.mesh.shape[:-1], m1, m2)
        names = (*mesh.mesh_dim_names[:-1], "model", "model_lo")
        _FACTORED[key] = (mesh, DeviceMesh(mesh.device_type, ranks, mesh_dim_names=names))
    return _FACTORED[key][1]


def _moved(t, mesh, placements, shape):
    """``t``'s local shard as a ``DTensor`` of ``shape`` on ``mesh`` (the
    same bytes on every rank; no collective), its gradient coming back
    placed as ``t``."""
    from torch.distributed.tensor import DTensor

    local = t.to_local(grad_placements=t.placements).reshape(
        [s // _split_of(placements, mesh, i) for i, s in enumerate(shape)])
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=torch.Size(shape), stride=contiguous_stride(shape))


def _split_of(placements, mesh, dim: int) -> int:
    return math.prod(mesh.size(i) for i, p in enumerate(placements)
                     if p.is_shard() and p.dim == dim)


class _SeqSplit:
    """The chunks of the grouped loop placed as XLA places ``repro``'s
    ``x.reshape(B, n_chunks, Sc, d)`` of a sequence split over "model"
    (M devices, a share of S/M positions each): the split carries over
    the reshape, so a chunk that spans m2 = Sc / share devices stays
    split over them (each keeps its share of every chunk), and the
    other factor, m1 = M / m2, splits the chunks (m1 = n_chunks), or,
    where a chunk lies inside one share (m2 = 1), the shares' chunks.
    The loop then runs every chunk on every device, so the chunks come
    whole over m1 (one gather before the loop); inside a chunk the
    routing, the slot ``cumsum``, the dispatch and the combine run on
    the device's share (``_SplitDispatch``, ``_SplitCombine``).  On the
    factored mesh (``_factored``: "model" of size m1, "model_lo" of m2)
    the tokens are split over "model_lo" and whole over "model"."""

    def __init__(self, mesh, m1: int, m2: int, shape):
        self.mesh, self.mesh3 = mesh, _factored(mesh, m1, m2)
        self.m2, self.shape = m2, shape

    @staticmethod
    def of(xs, size: int, cfg):
        """The split of ``xs`` (B, S, d), or None where no "model" axis
        splits its sequence alone, or the shares do not tile the chunks."""
        if not is_dtensor(xs) or cfg.moe_dispatch != "einsum":
            return None
        from torch.distributed.tensor import Shard

        mesh, pl = xs.device_mesh, xs.placements
        names = mesh.mesh_dim_names or ()
        M = mesh.size(mesh.ndim - 1)
        if (M == 1 or names[-1:] != ("model",) or pl[-1] != Shard(1)
                or any(not (p.is_replicate() or p == Shard(0)) for p in pl[:-1])):
            return None
        B, S, d = xs.shape
        share = S // M
        if S % M or (size % share if size >= share else share % size):
            return None
        m2 = max(1, size // share)
        m1 = M // m2
        if d % m1:
            return None
        return _SeqSplit(mesh, m1, m2, (B, S // size, size, d))

    def chunks(self, xs):
        """(B, S, d) -> (B, n_chunks, Sc, d), whole over "model" (a gather
        over m1), split over "model_lo"."""
        from torch.distributed.tensor import Replicate, Shard

        pl = (*xs.placements[:-1], Shard(1), Shard(2) if self.m2 > 1 else Replicate())
        x4 = _moved(xs, self.mesh3, pl, self.shape)
        return _redistributed(x4, (*pl[:-2], Replicate(), pl[-1]))

    def weights(self, ws):
        """Each routed weight as the same shards on the factored mesh."""
        return [_moved(w, self.mesh3, (*w.placements, w.placements[-1]), w.shape)
                for w in ws]

    def join(self, ys):
        """The chunks' outputs (B, n_chunks, Sc, d) -> (B, S, d) placed as
        the loop's input (each device keeps its own chunks: no
        collective; the backward gathers their gradients over m1)."""
        from torch.distributed.tensor import Shard

        pl = (*ys.placements[:-2], Shard(1), ys.placements[-1])
        B, n, Sc, d = ys.shape
        return _moved(_redistributed(ys, pl), self.mesh,
                      (*pl[:-2], Shard(1)), (B, n * Sc, d))

    def scalar(self, t):
        """A loss on the factored mesh, whole, on the loop's mesh."""
        from torch.distributed.tensor import Replicate

        whole = [Replicate()] * self.mesh3.ndim
        return _moved(_redistributed(t, whole), self.mesh,
                      [Replicate()] * self.mesh.ndim, t.shape)


def _token_placements(xc):
    """The placements of a split chunk's (B, Sc, ...) tensors: as its
    tokens, whole over "model", split over "model_lo"."""
    from torch.distributed.tensor import Replicate, Shard

    return (*xc.placements[:-2], Replicate(), Shard(1) if xc.placements[-1].is_shard()
            else Replicate())


def _hi_block(mesh, t, dim: int):
    """``t``'s slice along ``dim`` that this device's "model" coordinate
    (of the factored mesh) picks."""
    hi = mesh.ndim - 2
    n = mesh.size(hi)
    w = t.shape[dim] // n
    return t.narrow(dim, mesh.get_local_rank(hi) * w, w)


class _SplitDispatch(torch.autograd.Function):
    """GShard's dispatch of a split chunk, ``xe = einsum("bsec,bsd->becd",
    dispatch, xc)``, on the device's share of the tokens (a partial sum
    over "model_lo").  Its backward contracts the experts' slots with the
    features split over "model", as XLA splits ``repro``'s: the free
    factor of the model axis takes the features of the backward's
    products."""

    @staticmethod
    def forward(ctx, mask, xc, tok):
        from torch.distributed.tensor import DTensor, Partial, Replicate

        mesh = xc.device_mesh
        m = _redistributed(mask, tok).to_local()
        xe = torch.einsum("bsec,bsd->becd", m, _redistributed(xc, tok).to_local())
        ctx.save_for_backward(m)
        ctx.tok, ctx.xshape = tok, xc.shape
        B, _, E, C = mask.shape
        pl = (*tok[:-2], Replicate(), Partial() if tok[-1].is_shard() else Replicate())
        shape = (B, E, C, xc.shape[-1])
        return DTensor.from_local(xe, mesh, pl, run_check=False, shape=torch.Size(shape),
                                  stride=contiguous_stride(shape))

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import DTensor, Replicate, Shard

        (m,) = ctx.saved_tensors
        tok, shape = ctx.tok, ctx.xshape
        mesh = g.device_mesh
        g = _redistributed(g, (*tok[:-2], Shard(3), Replicate())).to_local()
        dx = torch.einsum("bsec,becd->bsd", m, g)
        return None, DTensor.from_local(dx, mesh, (*tok[:-2], Shard(2), tok[-1]),
                                        run_check=False, shape=shape,
                                        stride=contiguous_stride(shape)), None


def _forward_combine(cm, ye, tok):
    """A split chunk's combine outside autograd (a prefill):
    ``einsum("bsec,becd->bsd", combine, ye)`` on the device's share of the
    tokens with the features split over "model" (``_forward_features``),
    the output so too."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    feats = (*tok[:-2], Shard(3), Replicate())
    y = torch.einsum("bsec,becd->bsd", _redistributed(cm, tok).to_local(),
                     _redistributed(ye, feats).to_local())
    shape = (*cm.shape[:2], ye.shape[-1])
    return DTensor.from_local(y, cm.device_mesh, (*tok[:-2], Shard(2), tok[-1]),
                              run_check=False, shape=torch.Size(shape),
                              stride=contiguous_stride(shape))


class _SplitCombine(torch.autograd.Function):
    """GShard's combine of a split chunk, ``einsum("bsec,becd->bsd",
    combine, ye)``, on the device's share of the tokens and every feature;
    its backward's two products take the features split over "model"
    (``_SplitDispatch``): the combine mask's gradient a partial sum over
    "model", the experts' outputs' one over "model_lo".  It saves
    nothing itself: ``_SaveInputs`` saves its inputs before it runs, so a
    recompute (``checkpoint``'s early stop) ends before its product, as
    XLA drops the recompute's combine, whose output no gradient reads."""

    @staticmethod
    def forward(ctx, cm, ye, tok, saver):
        from torch.distributed.tensor import DTensor, Replicate

        mesh = cm.device_mesh
        whole = (*tok[:-2], Replicate(), Replicate())
        y = torch.einsum("bsec,becd->bsd", _redistributed(cm, tok).to_local(),
                         _redistributed(ye, whole).to_local())
        ctx.tok, ctx.saver = tok, saver
        shape = (*cm.shape[:2], ye.shape[-1])
        return DTensor.from_local(y, mesh, tok, run_check=False, shape=torch.Size(shape),
                                  stride=contiguous_stride(shape))

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

        cm, ye = ctx.saver.saved_tensors
        tok = ctx.tok
        mesh = g.device_mesh
        g = _hi_block(mesh, _redistributed(g, tok).to_local(), 2)
        ye_l = _redistributed(ye, (*tok[:-2], Shard(3), Replicate())).to_local()
        cm_l = _redistributed(cm, tok).to_local()
        dcm = torch.einsum("bsd,becd->bsec", g, ye_l)
        dye = torch.einsum("bsec,bsd->becd", cm_l, g)
        lo = Partial() if tok[-1].is_shard() else tok[-1]
        return (DTensor.from_local(dcm, mesh, (*tok[:-2], Partial(), tok[-1]),
                                   run_check=False, shape=cm.shape,
                                   stride=contiguous_stride(cm.shape)),
                DTensor.from_local(dye, mesh, (*tok[:-2], Shard(3), lo), run_check=False,
                                   shape=ye.shape, stride=contiguous_stride(ye.shape)),
                None, None)


def _run_chunks(chunk_fn, src, cfg, dim: int, size, remat: bool):
    """Every chunk of the loop's input in order: (the chunks' outputs, the
    summed load-balance and z losses).  A chunk is ``size`` along ``dim``,
    or, with ``size`` None (``_SeqSplit``'s layout, as ``repro``'s
    reshape lays them out), the input's entries along ``dim``.  With
    ``remat``, each chunk a ``checkpoint``."""
    x = src.get()[0]
    lb = z = x.new_zeros((), dtype=torch.float32)   # a DTensor on a mesh
    ys = []
    n = x.shape[dim] if size is None else x.shape[dim] // size
    for c in range(n):
        if remat:
            # torch 2.11's checkpoint saves a placeholder tensor through the
            # hooks around it, a remat period's: kept out of them, so the
            # period's recompute still stops before the loop (2.13 keeps
            # its inputs on the checkpoint's own frame)
            with torch.autograd.graph.saved_tensors_hooks(_same, _same):
                yc, lb_c, z_c = checkpoint(_chunk, chunk_fn, src, c, cfg, dim, size,
                                           use_reentrant=False)
        else:
            yc, lb_c, z_c = _chunk(chunk_fn, src, c, cfg, dim, size)
        lb, z = lb + lb_c, z + z_c
        ys.append(yc)
    return ys, lb, z


def _same(t):
    return t


def _chunk(chunk_fn, src, c, cfg, dim, size):
    x, *ws = src.get()
    xc = x.select(dim, c) if size is None else x.narrow(dim, c * size, size)
    p = SimpleNamespace(**dict(zip(_ROUTED, ws)))
    if len(ws) > len(_ROUTED):   # the router's own chunks and weight (``moe_apply``)
        p.route_x, p.route_w = ws[-2].select(1, c), ws[-1]
    return chunk_fn(p, xc, cfg)


def _unflatten(y, B: int, S: int):
    """The flat loop's output (B*S, d) as (B, S, d).  On a ``DTensor``
    split over its tokens by whole batch rows, the same view of the local
    shard, so that the backward takes the gradient placed as ``y`` (torch
    2.11's ``DTensor`` refuses the backward's flatten of a gradient whose
    sequence is split, as the residual's is)."""
    if not is_dtensor(y):
        return y.reshape(B, S, -1)
    from torch.distributed.tensor import Shard

    mesh, pl = y.device_mesh, y.placements
    if any(p.is_partial() for p in pl) or B % _split_of(pl, mesh, 0):
        return y.reshape(B, S, -1)
    out = [Shard(p.dim + 1) if p.is_shard() and p.dim == 1 else p for p in pl]
    return _moved(y, mesh, out, (B, S, y.shape[1]))


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
    ep = _ep_dim(p.w_gate)
    ws = [getattr(p, name) for name in _ROUTED]
    # on a mesh that splits the experts, the tokens whole over "model" once,
    # for the dispatch (and the shared experts: below)
    x_in, x = x, _placed(x, ep)
    split = None
    if cfg.moe_group == "seq":
        chunk_fn, dim, size = _grouped_chunk_moe, 1, max(1, min(cfg.moe_group_seq, S))
        n_chunks = -(-S // size)
        xs = pad_seq(x, n_chunks * size - S)
        split = _SeqSplit.of(xs, size, cfg)
        if split is not None:
            xs, ws = split.chunks(xs), split.weights(ws)
        elif ep is not None and p.router.placements[ep].is_replicate():
            # a router whole over "model" (the resolver gave the data axes
            # to d) takes its own chunks, placed as a split loop's (``_router``)
            xr = pad_seq(x_in, n_chunks * size - S)
            route = _SeqSplit.of(xr, size, cfg)
            if route is not None:
                ws += [route.chunks(xr), *route.weights(ws[:1])]
    else:
        N = B * S
        chunk_fn, dim, size = _chunk_moe, 0, min(cfg.moe_chunk, N)
        n_chunks = -(-N // size)
        pad = n_chunks * size - N
        xs = x.reshape(N, d)
        if pad:
            xs = torch.cat([xs, xs.new_zeros((pad, d))])
        xs = _flat_tokens(xs, size, p.w_gate)
    src = _LoopInputs(xs, ws)
    shared = None
    if cfg.n_shared_experts:
        # the gathered tokens where the shared experts split d_ff over
        # "model" (``gather_operand`` would gather them so), else the tokens
        # as they came, split as XLA splits repro's product
        ff_split = ep is not None and p.shared.w_gate.placements[ep].is_shard(1)
        shared = mlp_apply(p.shared, x if ff_split else x_in, "silu")
    remat = cfg.moe_remat and src.saver is not None
    ys, lb, z = _run_chunks(chunk_fn, src, cfg, dim, None if split else size, remat)
    src.forward_done()
    if split is not None:
        y, lb, z = split.join(torch.stack(ys, 1)), split.scalar(lb), split.scalar(z)
    else:
        y = torch.cat(ys, dim)
    y = y[:, :S] if dim else _unflatten(y[:N], B, S)
    if shared is not None:
        y = y + shared
    return y, {"moe_lb_loss": lb / n_chunks, "moe_z_loss": z / n_chunks}
