"""Multi-head Latent Attention (DeepSeek-V2, arXiv:2405.04434); the port of
``repro.models.mla``.

Queries go through a low-rank bottleneck (q_lora); keys/values are compressed
into a per-token latent ``c_kv`` (kv_lora wide) plus one shared decoupled RoPE
key (qk_rope_dim).  Scoring width = qk_nope + qk_rope per head.

* ``mla_attention`` (forward/prefill) decompresses K/V per head and runs the
  standard attention;
* ``mla_decode_absorbed`` (decode) absorbs the per-head up-projections into
  the query and output sides and scores against the compressed
  ``(B, T, kv_lora + rope)`` cache.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models.layers import (
    Norm,
    attention,
    cache_write,
    dense_init_,
    gather_operand,
    linear,
    new_param,
    norm_apply,
    placed_like,
    rope_apply,
    split_heads,
)

__all__ = ["MLA", "mla_project_qkv", "mla_attention", "mla_decode_absorbed"]


class MLA(nn.Module):
    def __init__(self, cfg, dtype, device):
        super().__init__()
        d, H = cfg.d_model, cfg.n_heads
        dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
        self.wq_a = new_param((d, cfg.q_lora), dtype, device)
        self.q_norm = Norm(cfg.q_lora, "rmsnorm", dtype, device)
        self.wq_b = new_param((cfg.q_lora, H * (dn + dr)), dtype, device)
        self.wkv_a = new_param((d, cfg.kv_lora + dr), dtype, device)
        self.kv_norm = Norm(cfg.kv_lora, "rmsnorm", dtype, device)
        self.wk_b = new_param((cfg.kv_lora, H * dn), dtype, device)
        self.wv_b = new_param((cfg.kv_lora, H * dv), dtype, device)
        self.wo = new_param((H * dv, d), dtype, device)

    def reset_parameters(self, generator):
        for w in self.parameters(recurse=False):
            dense_init_(w, generator)


def mla_project_qkv(p, x, positions, cfg):
    """Shared projections. Returns (q_nope, q_rope, c_kv, k_rope)."""
    H, dn, dr = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim
    x = gather_operand(x, p.wq_a, p.wkv_a)
    q = linear(x, p.wq_a)
    q = norm_apply(p.q_norm, q, "rmsnorm")
    q = split_heads(linear(q, p.wq_b), H, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = rope_apply(q_rope, positions, cfg.rope_theta)

    ckv = linear(x, p.wkv_a)
    c_kv, k_rope = ckv[..., :cfg.kv_lora], ckv[..., cfg.kv_lora:]
    c_kv = norm_apply(p.kv_norm, c_kv, "rmsnorm")
    k_rope = rope_apply(k_rope[:, :, None, :], positions, cfg.rope_theta)[:, :, 0]
    return q_nope, q_rope, c_kv, k_rope


def mla_attention(p, x, positions, cfg):
    """Forward/prefill path: decompress and run standard attention.
    Returns (out, (c_kv, k_rope))."""
    B, S, _ = x.shape
    H, dn, dr, dv = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    q_nope, q_rope, c_kv, k_rope = mla_project_qkv(p, x, positions, cfg)
    k_nope = split_heads(linear(c_kv, p.wk_b), H, dn)
    v = split_heads(linear(c_kv, p.wv_b), H, dv)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None].expand(B, S, H, dr)], dim=-1)
    out = attention(
        q, k, v,
        q_pos=positions, k_pos=positions,
        causal=cfg.causal, window=cfg.window, q_chunk=cfg.attn_q_chunk,
        scale=(dn + dr) ** -0.5, chunk_remat=cfg.attn_chunk_remat,
    )
    out = linear(out.reshape(B, S, H * dv), p.wo, reduce_dims=(1,))
    return out, (c_kv, k_rope)


def mla_decode_absorbed(p, x, pos: int, cache_ckv, cache_krope, cfg):
    """Decode against the compressed cache (absorption trick).

    x (B, 1, d); cache_ckv (B, T, kv_lora); cache_krope (B, T, dr), both
    written at ``pos`` in place.  Returns (out (B, 1, d), cache_ckv,
    cache_krope)."""
    B = x.shape[0]
    H, dn, dr, dv = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    R = cfg.kv_lora
    positions = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    q_nope, q_rope, c_kv_new, k_rope_new = mla_project_qkv(p, x, positions, cfg)
    cache_write(cache_ckv, pos, c_kv_new)
    cache_write(cache_krope, pos, k_rope_new)

    wk_b = p.wk_b.to(x.dtype).reshape(R, H, dn)
    q_lat = torch.einsum("bhd,rhd->bhr", q_nope[:, 0], wk_b)
    scores = torch.einsum("bhr,btr->bht", q_lat, cache_ckv)
    scores = scores + torch.einsum("bhd,btd->bht", q_rope[:, 0], cache_krope)
    scores = scores.float() * (dn + dr) ** -0.5
    k_pos = torch.arange(cache_ckv.shape[1], dtype=torch.int32, device=x.device)
    scores = torch.where((k_pos <= pos)[None, None, :], scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)

    ctx = torch.einsum("bht,btr->bhr", probs, cache_ckv)      # latent context
    wv_b = p.wv_b.to(x.dtype).reshape(R, H, dv)
    out = torch.einsum("bhr,rhd->bhd", ctx, wv_b).reshape(B, 1, H * dv)
    # back on the token's placement: a decode cell's cache may split its
    # batch over "model" and its positions over the data axes, and the
    # products against it leave the output so (the batch over "model"),
    # where XLA takes repro's output projection on the token's split
    return linear(placed_like(out, x), p.wo), cache_ckv, cache_krope
