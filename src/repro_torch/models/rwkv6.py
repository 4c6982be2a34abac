"""RWKV-6 "Finch" block (arXiv:2404.05892): data-dependent decay linear RNN;
the port of ``repro.models.rwkv6``.

Time-mix recurrence per head (K = V = head dim):
  S_t   = diag(w_t) S_{t-1} + k_t^T v_t
  out_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
with the data-dependent per-channel decay w_t = exp(-exp(w0 + lora(m_w))),
token-shift lerps (static mixes, as ``repro`` simplifies them) and a gated
output.

The full sequence uses the chunked form (intra-chunk attention in log-decay
space, then the inter-chunk state) over chunks of ``_CHUNK`` steps, with
exponents in float32 clamped at ``_CLAMP``; padded steps get ``lw = 0`` and
``k = 0`` so they neither decay nor contribute.  Decode runs the exact
one-token recurrence.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.layers import (
    _redistributed,
    contiguous_stride,
    dense_init_,
    gather_operand,
    in_decode,
    is_dtensor,
    linear,
    channels_split,
    met,
    new_param,
    pad_seq,
    placed_like,
    whole_channels,
)

__all__ = ["RWKV", "rwkv_time_mix", "rwkv_time_mix_step", "rwkv_channel_mix",
           "rwkv_channel_mix_step"]

_CHUNK = 32
_CLAMP = 60.0


class RWKV(nn.Module):
    def __init__(self, cfg, dtype, device):
        super().__init__()
        d, dk = cfg.d_model, cfg.rwkv_head_dim
        H = d // dk
        r = cfg.rwkv_lora
        f32 = torch.float32
        # time-mix
        self.mu = new_param((5, d), dtype, device)            # lerp for w,k,v,r,g
        self.w0 = new_param((d,), f32, device)                # decay bias
        self.wA = new_param((d, r), dtype, device)
        self.wB = new_param((r, d), dtype, device)
        self.u = new_param((H, dk), f32, device)
        self.Wr = new_param((d, d), dtype, device)
        self.Wk = new_param((d, d), dtype, device)
        self.Wv = new_param((d, d), dtype, device)
        self.Wg = new_param((d, d), dtype, device)
        self.Wo = new_param((d, d), dtype, device)
        self.gn_scale = new_param((d,), f32, device)
        # channel-mix
        self.cmu = new_param((2, d), dtype, device)           # lerp for k,r
        self.Ck = new_param((d, cfg.d_ff), dtype, device)
        self.Cv = new_param((cfg.d_ff, d), dtype, device)
        self.Cr = new_param((d, d), dtype, device)

    @torch.no_grad()
    def reset_parameters(self, generator):
        self.mu.fill_(0.5)
        self.cmu.fill_(0.5)
        self.w0.fill_(-1.0)
        self.gn_scale.fill_(1.0)
        dense_init_(self.wA, generator, scale=0.01)
        dense_init_(self.wB, generator, scale=0.01)
        dense_init_(self.u, generator, scale=0.5)
        for w in (self.Wr, self.Wk, self.Wv, self.Wg, self.Wo,
                  self.Ck, self.Cv, self.Cr):
            dense_init_(w, generator)


def _shift(x, carry):
    """Token shift: previous token's activations (carry = last of prev call)."""
    return torch.cat([carry[:, None], x[:, :-1]], dim=1)


def _whole(w):
    """A small weight whole on every mesh dim (the lerp mixes, the decay
    LoRA's down-projection): gathered once, so what it multiplies stays
    placed as it is (a ``DTensor``'s ``mu`` split over the features
    would split the lerps over them, and each projection of a lerp would
    then contract split features into a partial sum); the identity off a
    mesh."""
    if not is_dtensor(w):
        return w
    from torch.distributed.tensor import Replicate

    return w.redistribute(w.device_mesh, [Replicate()] * w.device_mesh.ndim)


def _project(p, x, xx, seq=None):
    """Lerped projections -> (lw (float32 log-decay), k, v, r, g).  On a
    mesh ``x`` and ``xx`` come whole over the sequence (``rwkv_time_mix``
    gathers ``x`` once), the lerps run whole and every projection splits
    its output; the decay LoRA's down-projection takes the device's share
    of the positions where ``seq`` (the placements ``x`` came with) split
    them, as XLA runs ``repro``'s.  A decode step's tokens take ``wA`` as it
    lies."""
    mu = _whole(p.mu).to(x.dtype)
    m = [x + (xx - x) * mu[i] for i in range(5)]
    # a decode step's tokens meet wA where it lies (``layers.local_product``)
    wA = p.wA if in_decode() else _whole(p.wA)
    lora = linear(torch.tanh(linear(_share_of(m[0], seq), wA)), p.wB)
    lw = -torch.exp(p.w0.float() + lora.float())
    lw = torch.clamp(lw, -8.0, -1e-6)                     # log w_t in (-8, 0)
    k = linear(m[1], p.Wk)
    v = linear(m[2], p.Wv)
    r = linear(m[3], p.Wr)
    g = linear(m[4], p.Wg)
    return lw, k, v, r, g


def _share_of(t, seq):
    """``t`` (B, S, ...), whole along S on the mesh dims where the
    placements ``seq`` split it, as this device's share there: a slice of
    the local shard (no collective), its gradient a partial sum on those
    dims, reduced where ``t``'s other partial gradients are.  ``t`` itself
    off a mesh or where ``seq`` splits no position."""
    if not is_dtensor(t) or seq is None:
        return t
    from torch.distributed.tensor import DTensor, Partial, Shard

    mesh = t.device_mesh
    dims = [i for i, p in enumerate(seq) if p.is_shard(1) and t.placements[i].is_replicate()]
    if not dims:
        return t
    coord, lo, span = mesh.get_coordinate(), 0, t.shape[1]
    for i in dims:                         # mesh order: the outer split first
        span //= mesh.size(i)
        lo += coord[i] * span
    local = t.to_local(grad_placements=[Partial() if i in dims else p
                                        for i, p in enumerate(t.placements)])
    return DTensor.from_local(local.narrow(1, lo, span), mesh,
                              [Shard(1) if i in dims else p for i, p in enumerate(t.placements)],
                              run_check=False, shape=t.shape,
                              stride=contiguous_stride(t.shape))


def _summed(t):
    """A ``DTensor``'s partial sums made whole (an all-reduce), its splits
    kept; anything else as it is."""
    if not (is_dtensor(t) and any(p.is_partial() for p in t.placements)):
        return t
    from torch.distributed.tensor import Replicate

    return t.redistribute(t.device_mesh, [Replicate() if p.is_partial() else p
                                          for p in t.placements])


def _share(x) -> int:
    """The positions of ``x`` (B, S, ...) that one device holds (S off a
    mesh)."""
    n = 1
    if is_dtensor(x):
        for i, p in enumerate(x.placements):
            if p.is_shard(1):
                n *= x.device_mesh.size(i)
    return x.shape[1] // n


def _state_like(s, kc):
    """A new state (B,H,K,V) placed as the chunks ``kc`` (n,B,H,L,K) place
    its batch, heads and rows (the identity off a mesh): a local slice."""
    if not is_dtensor(kc):
        return s
    from torch.distributed.tensor import Replicate, Shard

    dims = {1: 0, 2: 1, 4: 2}
    return s.redistribute(s.device_mesh, [Shard(dims[p.dim]) if p.is_shard() and p.dim in dims
                                          else Replicate() for p in kc.placements])


def _head_mean(t):
    """``t.mean(-1, keepdim=True)``; on a ``DTensor`` split over the last
    dim the local sums made whole (an all-reduce of one number a head) and
    divided, so the statistics come back whole and ``t`` stays split
    (``DTensor``'s own mean leaves a ``Partial(avg)`` that it then meets
    by gathering ``t``)."""
    if not channels_split(t):
        return t.mean(-1, keepdim=True)
    return _summed(t.sum(-1, keepdim=True)) / t.shape[-1]


def _group_norm(x, scale, eps=1e-5):
    """Per-head LayerNorm on (B, S, H, K) -> flattened (B, S, d)."""
    xf = x.float()
    mean = _head_mean(xf)
    var = _head_mean((xf - mean) ** 2)
    xf = (xf - mean) * torch.rsqrt(var + eps)
    B, S, H, K = x.shape
    return (xf.reshape(B, S, H * K) * scale).to(x.dtype)


def _cumsum_time(t):
    """``torch.cumsum`` along dim 2 (time).  On a ``DTensor`` whole along
    time it runs on the local shard: torch 2.11's ``DTensor`` has no rule
    for the ``flip`` that the ``cumsum`` backward takes."""
    if is_dtensor(t) and not any(p.is_partial() or (p.is_shard() and p.dim == 2)
                                 for p in t.placements):
        from torch.distributed.tensor import DTensor

        return DTensor.from_local(torch.cumsum(t.to_local(), dim=2), t.device_mesh,
                                  t.placements, run_check=False, shape=t.shape,
                                  stride=contiguous_stride(t.shape))
    return torch.cumsum(t, dim=2)


def _chunk_wkv(r, k, v, lw, u, state):
    """One chunk: r/k/v (B,H,L,K), lw float32 (B,H,L,K), state (B,H,K,V).
    On a mesh that splits the head's channels, r, k, lw, ``u`` and the
    state's rows keep the split and ``v`` comes whole: the scores, the
    bonus and the inter-chunk term are partial sums over the channels,
    each made whole before it meets ``v``, so every device runs its data
    shard's chunk over the whole of V, as XLA places ``repro``'s chunk."""
    rf, kf, vf = r.float(), k.float(), v.float()
    Lcum = _cumsum_time(lw)                                # inclusive
    Lprev = Lcum - lw                                      # exclusive
    r_t = rf * torch.exp(Lprev)                            # decayed queries
    k_t = kf * torch.exp(torch.clamp(-Lcum, max=_CLAMP))   # amplified keys
    A = _summed(torch.einsum("bhtk,bhsk->bhts", r_t, k_t))  # intra-chunk scores
    L = r.shape[2]
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool, device=r.device), -1)
    A = torch.where(tri[None, None], A, 0.0)
    diag = _summed(torch.einsum("bhtk,bhtk->bht", rf * u[None, :, None, :], kf))
    out = torch.einsum("bhts,bhsv->bhtv", A, vf)
    out = out + diag[..., None] * vf
    out = out + _summed(torch.einsum("bhtk,bhkv->bhtv", r_t, state))  # inter-chunk
    Dlast = Lcum[:, :, -1:, :]                             # (B,H,1,K)
    kd = kf * torch.exp(Dlast - Lcum)                      # exponent <= 0
    new_state = state * torch.exp(Dlast[:, :, 0, :, None]) + torch.einsum(
        "bhsk,bhsv->bhkv", kd, vf)
    return out, new_state


def _local_heads(fn, r, k, v, w, u, state):
    """``fn(r, k, v, w, u, state) -> (out, new_state)`` (a chunk or a decode
    step) on the local shards where a mesh splits only the batch and the
    heads, alike in every operand (each device holds whole heads, so every
    product is its own), the outputs placed as ``r``, ``u`` split as its
    heads (its gradient summed over the batch's split): torch 2.11's
    ``DTensor`` refuses the ``einsum``s' fold of a batch dim and a head
    dim that are both split.  A decode step (r (B,H,K)) may also split the
    channels K, the state's rows, where v comes whole: ``out`` is then a
    partial sum there, as XLA leaves ``repro``'s step.  None elsewhere."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    step = r.ndim == 3
    if not (is_dtensor(r) and all(is_dtensor(t) and t.placements == r.placements
                                  for t in (k, w, state))
            and all(p.is_replicate() or p.is_shard(0) or p.is_shard(1)
                    or (step and p.is_shard(2)) for p in r.placements)
            and is_dtensor(v) and list(v.placements) == [
                Replicate() if p.is_shard(2) else p for p in r.placements]):
        return None
    mesh = r.device_mesh
    u = _redistributed(u, [Shard(0) if p.is_shard(1) else Shard(1) if p.is_shard(2)
                           else Replicate() for p in r.placements])
    u = u.to_local(grad_placements=[Partial() if p.is_shard(0) else q
                                    for p, q in zip(r.placements, u.placements)])
    out, new = fn(*(t.to_local() for t in (r, k, v, w)), u, state.to_local())
    out_pl = [Partial() if p.is_shard(2) else p for p in r.placements]
    return tuple(DTensor.from_local(t, mesh, pl, run_check=False, shape=shape,
                                    stride=contiguous_stride(shape))
                 for t, pl, shape in ((out, out_pl, v.shape), (new, r.placements, state.shape)))


def _wkv_step(r, k, v, w, u, state):
    """One token: r/k/v/w (B,H,K) float32, state (B,H,K,V)."""
    kv = torch.einsum("bhk,bhv->bhkv", k, v)
    out = torch.einsum("bhk,bhkv->bhv", r, state + u[None, :, :, None] * kv)
    return out, state * w[..., None] + kv


class _AcrossShares:
    """A WKV chunk placed as XLA places ``repro``'s where a chunk spans
    devices' shares of the sequence and "model" splits a head's channels
    (``rwkv_time_mix`` where ``in_share`` is false): "model" (M devices,
    shares of S/M positions) factors, as ``moe._SeqSplit`` factors it,
    into m2 = L / share over a chunk's positions ("model_lo") and m1 =
    M / m2 over its channels ("model").  Inside a chunk r, k and the
    log-decay keep both splits, v comes whole over its channels and
    split over the positions, the state (B,H,K,V) splits its rows over
    m1 and is whole over m2 (``_split_chunk_wkv``); every device runs
    every chunk, and its share of the positions (chunk ``hi``'s half
    ``lo``) is its share of the sequence again after the loop."""

    def __init__(self, mesh, m1: int, m2: int):
        from repro_torch.models.moe import _factored

        self.mesh, self.mesh3 = mesh, _factored(mesh, m1, m2)

    @staticmethod
    def of(seq, S: int, vc):
        """The factoring where ``seq`` (the placements ``x`` came with)
        splits the sequence over "model" alone into shares that a chunk
        spans and tiles, and ``vc`` (n,B,H,L,V) splits its channels over
        "model" alone, by a multiple of m1; None elsewhere."""
        if seq is None or not is_dtensor(vc):
            return None
        from torch.distributed.tensor import Shard

        mesh = vc.device_mesh
        M, L, K = mesh.size(mesh.ndim - 1), vc.shape[3], vc.shape[4]
        if ((mesh.mesh_dim_names or ())[-1:] != ("model",) or seq[-1] != Shard(1)
                or vc.placements[-1] != Shard(4) or S % L or S % M or K % M
                or any(p.is_shard(1) for p in seq[:-1])
                or any(p.is_shard(4) for p in vc.placements[:-1])):
            return None
        share = S // M
        if L % share or M % (L // share):
            return None
        return _AcrossShares(mesh, M // (L // share), L // share)

    def _to3(self, t, m1, m2):
        """``t`` (last placement ``Shard`` or ``Replicate`` on "model") on
        the factored mesh, then placed ``m1`` over "model" and ``m2`` over
        "model_lo", its other placements kept."""
        from repro_torch.models.moe import _moved

        pl = tuple(t.placements)
        t3 = _moved(t, self.mesh3, (*pl, pl[-1]), t.shape)
        return _redistributed(t3, (*pl[:-1], m1, m2))

    def run(self, lwc, kc, vc, rc, u, s):
        """The chunk loop: ``(out (B,S,H,K) split over the sequence as
        ``x`` came, the last state placed as ``s`` came)``."""
        from torch.distributed.tensor import Replicate, Shard

        from repro_torch.models.moe import _moved

        n, B, H, L, K = kc.shape
        ch, pos = Shard(4), Shard(3)
        lwc, kc, rc = (self._to3(t, ch, pos) for t in (lwc, kc, rc))
        vc = self._to3(vc, Replicate(), pos)
        u = self._to3(u, Shard(1), Replicate())
        state_pl = tuple(s.placements)
        s = self._to3(s, Shard(2), Replicate())
        outs = []
        for i in range(n):
            out, s = _split_chunk_wkv(rc[i], kc[i], vc[i], lwc[i], u, s)
            outs.append(out)
        # (n,B,H,L,V): chunk hi's positions lo on device (hi, lo) are its
        # share of the sequence
        out = torch.stack(outs)
        pl = (*out.placements[:-2], Shard(0), Shard(3))
        out = _redistributed(out, pl).permute(1, 0, 3, 2, 4)
        out = _moved(out, self.mesh, (*out.placements[:-2], Shard(1)), (B, n * L, H, K))
        s = _redistributed(s, (*s.placements[:-1], s.placements[-2]))
        s = _moved(s, self.mesh, (*s.placements[:-1],), s.shape)
        return out, _redistributed(s, state_pl)


class _MaskedAV(torch.autograd.Function):
    """``out = tril(A)[..., s] @ v[s]`` over the columns ``s`` of this
    device's part (``part`` of ``parts``) of a chunk's positions, on local
    tensors: ``A`` (B,H,t,L) a device's rows ``t`` (from ``t0``) of the
    scores, whole over its part; ``v`` (B,H,L,V) whole.  The product over
    the part is a partial sum over the parts.  Its backward takes the
    scores' gradient over every column at once, ``dout @ v^T`` (the same
    on every part, so whole there), and ``v``'s over the part's rows (a
    partial sum): XLA's products for ``repro``'s chunk."""

    @staticmethod
    def forward(ctx, A, v, t0: int, part: int, parts: int):
        t, L = A.shape[-2], A.shape[-1]
        w = L // parts
        rows = torch.arange(t0, t0 + t, device=A.device)[:, None]
        mask = rows > torch.arange(L, device=A.device)[None, :]
        ctx.save_for_backward(A, v, mask)
        ctx.cols = (part * w, w)
        Am = torch.where(mask, A, 0.0)
        return torch.matmul(Am.narrow(-1, part * w, w), v.narrow(-2, part * w, w))

    @staticmethod
    def backward(ctx, dout):
        A, v, mask = ctx.saved_tensors
        c0, w = ctx.cols
        dA = torch.where(mask, torch.matmul(dout, v.transpose(-1, -2)), 0.0)
        Am = torch.where(mask, A, 0.0).narrow(-1, c0, w)
        dv = torch.zeros_like(v)
        dv.narrow(-2, c0, w).copy_(torch.matmul(Am.transpose(-1, -2), dout))
        return dA, dv, None, None, None


def _on_shards(eq: str, a, b, out_pl, a_grad=None, b_grad=None):
    """``torch.einsum(eq, a, b)`` of two ``DTensor``s on their local shards
    (each device's product its own, no collective and no search for a
    sharding strategy), the result a ``DTensor`` placed ``out_pl`` (a
    partial sum where the contraction is split); each operand's gradient
    comes back placed ``a_grad`` / ``b_grad`` (its own placements by
    default; a partial sum where the operand is whole over a mesh dim that
    splits the other one)."""
    from torch.distributed.tensor import DTensor

    size = dict(zip(eq.split("->")[0].split(",")[0], a.shape)) | dict(
        zip(eq.split("->")[0].split(",")[1], b.shape))
    shape = torch.Size(size[c] for c in eq.split("->")[1])
    out = torch.einsum(eq, a.to_local(grad_placements=a_grad or a.placements),
                       b.to_local(grad_placements=b_grad or b.placements))
    return DTensor.from_local(out, a.device_mesh, out_pl, run_check=False, shape=shape,
                              stride=contiguous_stride(shape))


def _split_chunk_wkv(r, k, v, lw, u, state):
    """``_chunk_wkv`` on ``_AcrossShares``' factored mesh: r, k, lw
    (B,H,L,K) split over K on "model" and over L on "model_lo", v whole
    over V and split over L, ``u`` split over K, ``state`` (B,H,K,V) split
    over K and whole over "model_lo".  Returns ``(out (B,H,L,V) whole over
    "model", split over L; the new state)``: r·kᵀ over the device's positions and
    channels against every position (k gathered over the positions), the
    scores made whole over the channels, A·v over the device's part of
    the columns (``_MaskedAV``), the inter-chunk term over its positions
    and channels, the state's update over its positions, each partial sum
    reduced where it is whole."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    def whole_t(t):
        return _redistributed(t, (*t.placements[:-1], Replicate()))

    def own_t(t):
        return _redistributed(t, (*t.placements[:-1], Shard(2)))

    data = tuple(r.placements[:-2])
    rf, kf, vf = r.float(), k.float(), v.float()
    Lcum = _cumsum_time(whole_t(lw))                       # inclusive, every position
    r_t = rf * torch.exp(own_t(Lcum) - lw)                 # decayed queries
    k_t = whole_t(kf) * torch.exp(torch.clamp(-Lcum, max=_CLAMP))
    rows = (*data, Partial(), Shard(2))                    # a chunk's rows, summed over K
    A = _summed(_on_shards("bhtk,bhsk->bhts", r_t, k_t, rows,
                           b_grad=(*data, Shard(3), Partial())))
    diag = _summed(_on_shards("bhtk,bhtk->bht", rf * u[None, :, None, :], kf, rows))
    mesh = A.device_mesh
    hi, lo = mesh.get_coordinate()[-2:]
    av = _MaskedAV.apply(A.to_local(grad_placements=A.placements),
                         whole_t(vf).to_local(grad_placements=(*data, Partial(), Partial())),
                         lo * (A.shape[2] // mesh.size(mesh.ndim - 1)), hi,
                         mesh.size(mesh.ndim - 2))
    av = DTensor.from_local(av, mesh, rows, run_check=False, shape=vf.shape,
                            stride=contiguous_stride(vf.shape))
    inter = _on_shards("bhtk,bhkv->bhtv", r_t, state, rows,
                       b_grad=(*data, Shard(2), Partial()))
    out = _summed(av + inter) + diag[..., None] * vf
    Dlast = Lcum[:, :, -1:, :]                             # (B,H,1,K)
    kd = kf * torch.exp(own_t(Dlast - Lcum))               # exponent <= 0
    kv = _on_shards("bhsk,bhsv->bhkv", kd, vf, (*data, Shard(2), Partial()),
                    b_grad=(*data, Partial(), Shard(2)))
    new_state = state * torch.exp(Dlast[:, :, 0, :, None]) + _summed(kv)
    return out, new_state


def rwkv_time_mix(p, x, H, *, shift_carry=None, state=None):
    """Full-sequence time-mix. x (B,S,d). Returns (y, (last_x, state))."""
    B, S, d = x.shape
    K = d // H
    carry = shift_carry if shift_carry is not None else x.new_zeros((B, d))
    L = _CHUNK
    in_share = _share(x) % L == 0     # each chunk inside one device's share
    seq = x.placements if is_dtensor(x) else None
    x = gather_operand(x, p.Wk, p.Wv, p.Wr, p.Wg)
    lw, k, v, r, g = _project(p, x, _shift(x, carry), seq)

    n = -(-S // L)
    pad = n * L - S

    def chunks(t):  # (B,S,d) -> (n, B, H, L, K), padded steps zero
        t = pad_seq(t, pad)
        return t.reshape(B, n, L, H, K).permute(1, 0, 3, 2, 4)

    # zero padding is the mask: padded steps have lw = 0 and k = 0
    lwc, kc, vc, rc = chunks(lw.float()), chunks(k), chunks(v), chunks(r)
    s = state if state is not None else _state_like(
        x.new_zeros((B, H, K, K), dtype=torch.float32), kc)
    across = None if in_share else _AcrossShares.of(seq, S, vc)
    # v whole over its channels (one gather, every chunk) where "model"
    # splits them and a chunk lies inside a share of the sequence: XLA's
    # placement of repro's chunk there
    split = in_share and channels_split(vc)
    if across is not None:
        out, s = across.run(lwc, kc, vc, rc, p.u, s)
    else:
        if split:
            vc = whole_channels(vc)
        outs = []
        for i in range(n):
            args = (rc[i], kc[i], vc[i], lwc[i], p.u, s)
            out, s = _local_heads(_chunk_wkv, *args) or _chunk_wkv(*args)
            outs.append(out)
        out = torch.stack(outs).permute(1, 0, 3, 2, 4).reshape(B, n * L, H, K)[:, :S]
    if across is not None or split:
        # whole heads come out: normed whole, then split as g (the gradient
        # gathered)
        y = _redistributed(_group_norm(out, _whole(p.gn_scale)), g.placements)
    else:
        y = _group_norm(out, p.gn_scale)
    y = y.to(x.dtype) * F.silu(g)
    return linear(y, p.Wo), (x[:, -1], s)


def rwkv_time_mix_step(p, x, H, shift_carry, state):
    """Exact one-token recurrence. x (B,1,d); state (B,H,K,V) float32.  On
    a mesh the token and the cache's token-shift carry meet at one
    placement (``layers.meeting``), and so do r, k and the decay with the
    cache's state: the state moves onto the step's head split (an
    all-to-all), its rows keep a split that the token can take as a
    slice, and the step runs on local shards; the new carry and state go
    back to the cache's placements."""
    B, _, d = x.shape
    K = d // H
    x, carry = met(x, shift_carry[:, None])
    lw, k, v, r, g = _project(p, x, carry)
    w = torch.exp(lw[:, 0].reshape(B, H, K))
    kh = k[:, 0].reshape(B, H, K).float()
    vh = v[:, 0].reshape(B, H, K).float()
    rh, s = met(r[:, 0].reshape(B, H, K).float(), state)
    args = (rh, placed_like(kh, rh), _rows_whole(vh, rh), placed_like(w, rh), p.u, s)
    out, new_state = _local_heads(_wkv_step, *args) or _wkv_step(*args)
    y = _group_norm(_summed(out).reshape(B, 1, H, K), p.gn_scale).to(x.dtype) * F.silu(g)
    return (linear(y, p.Wo), placed_like(x[:, -1], shift_carry),
            placed_like(new_state, state))


def _rows_whole(v, r):
    """``v`` (B,H,V) placed as ``r`` (B,H,K) but whole where ``r`` splits
    its channels (the state's rows: v spans the state's columns)."""
    if not (is_dtensor(v) and is_dtensor(r)):
        return v
    from torch.distributed.tensor import Replicate

    return _redistributed(v, [Replicate() if q.is_shard(2) else q for q in r.placements])


def rwkv_channel_mix(p, x, *, shift_carry=None):
    B, S, d = x.shape
    carry = shift_carry if shift_carry is not None else x.new_zeros((B, d))
    x = gather_operand(x, p.Ck, p.Cr)
    xx = _shift(x, carry)
    cmu = _whole(p.cmu).to(x.dtype)
    mk = x + (xx - x) * cmu[0]
    mr = x + (xx - x) * cmu[1]
    kk = torch.square(torch.relu(linear(mk, p.Ck)))
    vv = linear(kk, p.Cv)
    rr = torch.sigmoid(linear(mr, p.Cr))
    return rr * vv, x[:, -1]


def rwkv_channel_mix_step(p, x, shift_carry):
    """One token; the token and the cache's carry meet at one placement
    (``layers.meeting``) and the new carry goes back to the cache's."""
    x, carry = met(x, shift_carry[:, None])
    y, last = rwkv_channel_mix(p, x, shift_carry=carry[:, 0])
    return y, placed_like(last, shift_carry)
