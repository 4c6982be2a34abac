"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427); the
port of ``repro.models.rglru``.

Block structure (one "rec" residual block):
  x -> [gate branch: linear -> gelu] * [main: linear -> causal conv1d(width 4)
       -> RG-LRU] -> linear out

RG-LRU recurrence (per channel):
  r_t = sigmoid(W_r x_t + b_r)          recurrence gate
  i_t = sigmoid(W_i x_t + b_i)          input gate
  a_t = exp(-c * softplus(lam) * r_t),  c = 8
  h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The full sequence combines ``(a, b)`` pairs with a log-depth
(Hillis-Steele) scan, where ``repro`` uses ``lax.associative_scan``: the
same products and sums, grouped in another order.  Decode carries
``(h, conv window)`` exactly.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.layers import (
    along,
    dense_init_,
    gather_operand,
    linear,
    met,
    new_param,
    placed_like,
)

__all__ = ["RGLRU", "rglru_apply", "rglru_decode_step"]

_C = 8.0


class RGLRU(nn.Module):
    def __init__(self, cfg, dtype, device):
        super().__init__()
        d, dr, cw = cfg.d_model, cfg.d_rnn, cfg.conv_width
        self.w_x = new_param((d, dr), dtype, device)
        self.w_gate = new_param((d, dr), dtype, device)
        self.conv_w = new_param((cw, dr), dtype, device)
        self.conv_b = new_param((dr,), dtype, device)
        self.w_r = new_param((dr, dr), dtype, device)
        self.b_r = new_param((dr,), dtype, device)
        self.w_i = new_param((dr, dr), dtype, device)
        self.b_i = new_param((dr,), dtype, device)
        self.lam = new_param((dr,), torch.float32, device)
        self.w_out = new_param((dr, d), dtype, device)

    @torch.no_grad()
    def reset_parameters(self, generator):
        dense_init_(self.w_x, generator)
        dense_init_(self.w_gate, generator)
        dense_init_(self.conv_w, generator, scale=0.5)
        dense_init_(self.w_r, generator)
        dense_init_(self.w_i, generator)
        dense_init_(self.w_out, generator)
        for b in (self.conv_b, self.b_r, self.b_i):
            b.zero_()
        # lam so that a ~ uniform in [0.9, 0.999] at r = 0.5
        a = torch.linspace(0.9, 0.999, self.lam.shape[0], dtype=torch.float32,
                           device=self.lam.device)
        self.lam.copy_(torch.log(torch.expm1(-torch.log(a) * 2.0 / _C)))


def _gates(p, u):
    u = gather_operand(u, p.w_r, p.w_i)
    r = linear(u, p.w_r).float()
    r = torch.sigmoid(r + along(p.b_r, r).float())
    i = linear(u, p.w_i).float()
    i = torch.sigmoid(i + along(p.b_i, i).float())
    a = torch.exp(-_C * F.softplus(along(p.lam, r)) * r)
    b = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * i * placed_like(u, i).float()
    return a, b


def _conv(p, u, state=None):
    """Causal depthwise conv along time. u (B,S,dr); state (B,cw-1,dr)|None."""
    cw = p.conv_w.shape[0]
    pad = (u.new_zeros((u.shape[0], cw - 1, u.shape[2])) if state is None
           else state.to(u.dtype))
    xp = torch.cat([pad, u], dim=1)
    S = u.shape[1]
    conv_w = along(p.conv_w, u).to(u.dtype)
    out = sum(xp[:, i:i + S] * conv_w[i] for i in range(cw))
    return out + along(p.conv_b, u).to(u.dtype), xp[:, -(cw - 1):]


def _linear_scan(a, b):
    """``h_t = a_t * h_{t-1} + b_t`` from ``h_{-1} = 0`` along axis 1, in
    ceil(log2 S) rounds of ``(a_l, b_l) . (a_r, b_r) = (a_l a_r, b_l a_r + b_r)``."""
    off = 1
    while off < a.shape[1]:
        a_l, b_l = a[:, :-off], b[:, :-off]
        a_r, b_r = a[:, off:], b[:, off:]
        b = torch.cat([b[:, :off], b_l * a_r + b_r], dim=1)
        a = torch.cat([a[:, :off], a_l * a_r], dim=1)
        off *= 2
    return b


def rglru_apply(p, x, *, conv_state=None, h_state=None):
    """Full-sequence block. x (B,S,d) -> (y (B,S,d), (h_last, conv_state))."""
    x = gather_operand(x, p.w_gate, p.w_x)
    gate = F.gelu(linear(x, p.w_gate), approximate="tanh")
    u = linear(x, p.w_x)
    u, conv_state = _conv(p, u, conv_state)
    a, b = _gates(p, u)                       # (B,S,dr) float32
    if h_state is not None:                    # inject carried state as step 0
        b = torch.cat([b[:, :1] + a[:, :1] * h_state.float()[:, None], b[:, 1:]], 1)
    h = _linear_scan(a, b)
    y = linear(h.to(x.dtype) * gate, p.w_out, reduce_dims=(1,))
    return y, (h[:, -1], conv_state)


def rglru_decode_step(p, x, h_state, conv_state):
    """One-token step. x (B,1,d); h (B,dr); conv (B,cw-1,dr).  On a mesh
    the step's activations meet the cache's states at one placement
    (``layers.meeting``: the branch ``u`` and the conv window, the decay
    ``a`` and the state ``h``), and what each elementwise op takes is
    placed as its other operand, so no op meets operands placed apart;
    the new states go back to the cache's placements."""
    gate = F.gelu(linear(x, p.w_gate), approximate="tanh")
    u, conv = met(linear(x, p.w_x), conv_state)
    u, new_conv = _conv(p, u, conv)
    a, b = _gates(p, u)                        # (B,1,dr)
    a, h = met(a[:, 0], h_state)
    h = a * h.float() + placed_like(b[:, 0], a)
    y = h[:, None].to(x.dtype)
    y = linear(y * placed_like(gate, y), p.w_out)
    return y, placed_like(h, h_state), placed_like(new_conv, conv_state)
