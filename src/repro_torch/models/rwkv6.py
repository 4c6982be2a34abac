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
    contiguous_stride,
    dense_init_,
    is_dtensor,
    linear,
    new_param,
    pad_seq,
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


def _project(p, x, xx):
    """Lerped projections -> (lw (float32 log-decay), k, v, r, g)."""
    mu = p.mu.to(x.dtype)
    m = [x + (xx - x) * mu[i] for i in range(5)]
    lora = linear(torch.tanh(linear(m[0], p.wA)), p.wB)
    lw = -torch.exp(p.w0.float() + lora.float())
    lw = torch.clamp(lw, -8.0, -1e-6)                     # log w_t in (-8, 0)
    k = linear(m[1], p.Wk)
    v = linear(m[2], p.Wv)
    r = linear(m[3], p.Wr)
    g = linear(m[4], p.Wg)
    return lw, k, v, r, g


def _group_norm(x, scale, eps=1e-5):
    """Per-head LayerNorm on (B, S, H, K) -> flattened (B, S, d)."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(-1, keepdim=True)
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
    """One chunk: r/k/v (B,H,L,K), lw float32 (B,H,L,K), state (B,H,K,V)."""
    rf, kf, vf = r.float(), k.float(), v.float()
    Lcum = _cumsum_time(lw)                                # inclusive
    Lprev = Lcum - lw                                      # exclusive
    r_t = rf * torch.exp(Lprev)                            # decayed queries
    k_t = kf * torch.exp(torch.clamp(-Lcum, max=_CLAMP))   # amplified keys
    A = torch.einsum("bhtk,bhsk->bhts", r_t, k_t)          # intra-chunk scores
    L = r.shape[2]
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool, device=r.device), -1)
    A = torch.where(tri[None, None], A, 0.0)
    diag = torch.einsum("bhtk,bhtk->bht", rf * u[None, :, None, :], kf)
    out = torch.einsum("bhts,bhsv->bhtv", A, vf)
    out = out + diag[..., None] * vf
    out = out + torch.einsum("bhtk,bhkv->bhtv", r_t, state)  # inter-chunk
    Dlast = Lcum[:, :, -1:, :]                             # (B,H,1,K)
    kd = kf * torch.exp(Dlast - Lcum)                      # exponent <= 0
    new_state = state * torch.exp(Dlast[:, :, 0, :, None]) + torch.einsum(
        "bhsk,bhsv->bhkv", kd, vf)
    return out, new_state


def rwkv_time_mix(p, x, H, *, shift_carry=None, state=None):
    """Full-sequence time-mix. x (B,S,d). Returns (y, (last_x, state))."""
    B, S, d = x.shape
    K = d // H
    carry = shift_carry if shift_carry is not None else x.new_zeros((B, d))
    lw, k, v, r, g = _project(p, x, _shift(x, carry))

    L = _CHUNK
    n = -(-S // L)
    pad = n * L - S

    def chunks(t):  # (B,S,d) -> (n, B, H, L, K), padded steps zero
        t = pad_seq(t, pad)
        return t.reshape(B, n, L, H, K).permute(1, 0, 3, 2, 4)

    # zero padding is the mask: padded steps have lw = 0 and k = 0
    lwc, kc, vc, rc = chunks(lw.float()), chunks(k), chunks(v), chunks(r)
    s = state if state is not None else x.new_zeros((B, H, K, K), dtype=torch.float32)
    outs = []
    for i in range(n):
        out, s = _chunk_wkv(rc[i], kc[i], vc[i], lwc[i], p.u, s)
        outs.append(out)
    out = torch.stack(outs).permute(1, 0, 3, 2, 4).reshape(B, n * L, H, K)[:, :S]
    y = _group_norm(out, p.gn_scale).to(x.dtype) * F.silu(g)
    return linear(y, p.Wo), (x[:, -1], s)


def rwkv_time_mix_step(p, x, H, shift_carry, state):
    """Exact one-token recurrence. x (B,1,d); state (B,H,K,V) float32."""
    B, _, d = x.shape
    K = d // H
    lw, k, v, r, g = _project(p, x, shift_carry[:, None])
    w = torch.exp(lw[:, 0].reshape(B, H, K))
    kh = k[:, 0].reshape(B, H, K).float()
    vh = v[:, 0].reshape(B, H, K).float()
    rh = r[:, 0].reshape(B, H, K).float()
    kv = torch.einsum("bhk,bhv->bhkv", kh, vh)
    out = torch.einsum("bhk,bhkv->bhv", rh, state + p.u[None, :, :, None] * kv)
    new_state = state * w[..., None] + kv
    y = _group_norm(out.reshape(B, 1, H, K), p.gn_scale).to(x.dtype) * F.silu(g)
    return linear(y, p.Wo), x[:, -1], new_state


def rwkv_channel_mix(p, x, *, shift_carry=None):
    B, S, d = x.shape
    carry = shift_carry if shift_carry is not None else x.new_zeros((B, d))
    xx = _shift(x, carry)
    cmu = p.cmu.to(x.dtype)
    mk = x + (xx - x) * cmu[0]
    mr = x + (xx - x) * cmu[1]
    kk = torch.square(torch.relu(linear(mk, p.Ck)))
    vv = linear(kk, p.Cv)
    rr = torch.sigmoid(linear(mr, p.Cr))
    return rr * vv, x[:, -1]


def rwkv_channel_mix_step(p, x, shift_carry):
    return rwkv_channel_mix(p, x, shift_carry=shift_carry)
