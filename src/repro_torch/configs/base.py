"""Model configuration system + architecture registry (the port's copy of
``repro.configs``: same fields, defaults and ``reduced()``).

Every assigned architecture registers a full-size ``ModelConfig`` (exact
published dimensions) and gets a ``reduced()`` variant for CPU smoke tests.
A full config is built on the card, or on the meta device
(``build_model(cfg, device="meta")``), which allocates nothing.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

__all__ = ["ModelConfig", "ARCHS", "register", "get_config", "list_archs"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | hybrid | rwkv | encoder | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int

    act: str = "silu"              # silu -> SwiGLU MLP; gelu -> plain MLP
    norm: str = "rmsnorm"          # rmsnorm | layernorm
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    window: int | None = None      # sliding-window attention size
    causal: bool = True

    # --- MoE ---------------------------------------------------------------
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    expert_d_ff: int = 0
    first_dense_layers: int = 0    # leading dense-FFN layers (DeepSeek-V2)
    capacity_factor: float = 1.0
    moe_chunk: int = 4096          # token-chunked dispatch (bounds transients)
    moe_dispatch: str = "einsum"   # einsum (GShard one-hot) | scatter (indexed)
    moe_group: str = "flat"        # flat (global capacity) | seq (per-row groups)
    moe_group_seq: int = 512       # group length along S for moe_group="seq"
    moe_remat: bool = True         # recompute chunk dispatch in backward (§Perf)
    attn_chunk_remat: bool = True  # recompute q-chunk scores in backward (§Perf)

    # --- MLA (DeepSeek-V2) ---------------------------------------------------
    mla: bool = False
    kv_lora: int = 0
    q_lora: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    # --- hybrid (RecurrentGemma / Griffin) -----------------------------------
    pattern: tuple[str, ...] = ()  # e.g. ("rec", "rec", "attn"), cycled
    d_rnn: int = 0
    conv_width: int = 4

    # --- rwkv -----------------------------------------------------------------
    rwkv_head_dim: int = 64
    rwkv_lora: int = 64            # data-dependent decay LoRA rank

    # --- modality frontend (stubbed per task rules) ---------------------------
    frontend: str | None = None    # "patch" (vlm) | "frame" (audio)
    d_frontend: int = 0
    n_patches: int = 0

    # --- numerics / training ---------------------------------------------------
    param_dtype: str = "float32"
    act_dtype: str = "float32"
    vocab_pad_to: int = 256
    remat: bool = True
    logits_chunk: int = 1024       # CE loss computed in seq chunks (memory)
    attn_q_chunk: int = 1024       # chunked-softmax attention threshold/size
    sources: str = ""

    # ------------------------------------------------------------------------
    @property
    def padded_vocab(self) -> int:
        p = self.vocab_pad_to
        return ((self.vocab + p - 1) // p) * p

    @property
    def attn_kind(self) -> str:
        if self.family == "rwkv":
            return "rwkv"
        if self.mla:
            return "mla"
        return "gqa"

    def layer_kinds(self) -> list[str]:
        """Per-layer block kind: 'attn' | 'rec' (cycled hybrid pattern)."""
        if not self.pattern:
            return ["attn"] * self.n_layers
        return [self.pattern[i % len(self.pattern)] for i in range(self.n_layers)]

    def ffn_kinds(self) -> list[str]:
        if self.n_experts:
            return [
                "dense" if i < self.first_dense_layers else "moe"
                for i in range(self.n_layers)
            ]
        return ["dense"] * self.n_layers

    def params_estimate(self) -> tuple[int, int]:
        """(total, active-per-token) parameter counts — for 6ND model FLOPs."""
        d, L = self.d_model, self.n_layers
        emb = self.padded_vocab * d * (1 if self.family == "encoder" else 2)
        per_layer_total = per_layer_active = 0
        kinds = self.layer_kinds()
        ffns = self.ffn_kinds()
        for kind, ffn in zip(kinds, ffns):
            if kind == "rec":
                blk = 2 * d * self.d_rnn + self.conv_width * self.d_rnn \
                    + 2 * self.d_rnn * self.d_rnn // max(self.d_rnn // d, 1) \
                    + self.d_rnn * d
            elif self.family == "rwkv":
                blk = 5 * d * d + 6 * self.rwkv_lora * d
            elif self.mla:
                blk = (
                    d * self.q_lora
                    + self.q_lora * self.n_heads * (self.qk_nope_dim + self.qk_rope_dim)
                    + d * (self.kv_lora + self.qk_rope_dim)
                    + self.kv_lora * self.n_heads * (self.qk_nope_dim + self.v_head_dim)
                    + self.n_heads * self.v_head_dim * d
                )
            else:
                blk = d * self.n_heads * self.head_dim \
                    + 2 * d * self.n_kv_heads * self.head_dim \
                    + self.n_heads * self.head_dim * d
            mlp_mult = 3 if self.act == "silu" else 2
            if ffn == "moe":
                expert = mlp_mult * d * self.expert_d_ff
                total_ffn = self.n_experts * expert + self.n_shared_experts * expert \
                    + d * self.n_experts
                active_ffn = (self.top_k + self.n_shared_experts) * expert \
                    + d * self.n_experts
            else:
                ff = self.d_ff if not (self.n_experts and ffn == "dense") else self.d_ff
                total_ffn = active_ffn = mlp_mult * d * ff
            per_layer_total += blk + total_ffn
            per_layer_active += blk + active_ffn
        return emb + per_layer_total, emb + per_layer_active

    def reduced(self) -> "ModelConfig":
        """Tiny same-family variant for CPU smoke tests."""
        period = max(len(self.pattern), 1)
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=max(2, period + 1) if self.pattern else 2,
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) or 1,
            head_dim=16,
            d_ff=128,
            vocab=257,
            n_experts=min(self.n_experts, 4),
            n_shared_experts=min(self.n_shared_experts, 1),
            top_k=min(self.top_k, 2),
            expert_d_ff=48 if self.n_experts else 0,
            first_dense_layers=min(self.first_dense_layers, 1),
            moe_chunk=64,
            capacity_factor=8.0,   # drop-free at smoke scale (exactness tests)
            q_lora=24 if self.q_lora else 0,
            kv_lora=16 if self.kv_lora else 0,
            qk_nope_dim=16 if self.mla else 0,
            qk_rope_dim=8 if self.mla else 0,
            v_head_dim=16 if self.mla else 0,
            d_rnn=64 if self.d_rnn else 0,
            rwkv_lora=8,
            window=min(self.window, 8) if self.window else None,
            d_frontend=32 if self.frontend else 0,
            n_patches=4 if self.frontend == "patch" else 0,
            vocab_pad_to=32,
            logits_chunk=64,
            attn_q_chunk=32,
            param_dtype="float32",
            act_dtype="float32",
        )


ARCHS: dict[str, Callable[[], ModelConfig]] = {}


def register(arch_id: str):
    def deco(fn: Callable[[], ModelConfig]):
        ARCHS[arch_id] = fn
        return fn

    return deco


def get_config(arch_id: str) -> ModelConfig:
    import repro_torch.configs  # noqa: F401  (triggers registration)

    return ARCHS[arch_id]()


def list_archs() -> list[str]:
    import repro_torch.configs  # noqa: F401

    return sorted(ARCHS)
