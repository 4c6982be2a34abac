"""Qwen3-32B — dense GQA with per-head qk RMSNorm.

[hf:Qwen/Qwen3-8B family; hf]  64L d_model=5120 64H (kv=8) d_ff=25600 vocab=151936.
"""
from repro_torch.configs.base import ModelConfig, register


@register("qwen3-32b")
def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-32b",
        family="dense",
        n_layers=64,
        d_model=5120,
        n_heads=64,
        n_kv_heads=8,
        head_dim=128,
        d_ff=25600,
        vocab=151936,
        qk_norm=True,
        rope_theta=1_000_000.0,
        param_dtype="bfloat16",
        act_dtype="bfloat16",
        sources="hf:Qwen/Qwen3-32B",
    )
