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

import math

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
]

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


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
    return x @ w.to(x.dtype)


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
    ``scaled_dot_product_attention`` would give NaN."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
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
