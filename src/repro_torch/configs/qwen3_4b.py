"""Qwen3-4B — dense GQA with qk_norm.

[hf:Qwen/Qwen3-8B family; hf]  36L d_model=2560 32H (kv=8) d_ff=9728 vocab=151936.
"""
from repro_torch.configs.base import ModelConfig, register


@register("qwen3-4b")
def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-4b",
        family="dense",
        n_layers=36,
        d_model=2560,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=9728,
        vocab=151936,
        qk_norm=True,
        rope_theta=1_000_000.0,
        param_dtype="bfloat16",
        act_dtype="bfloat16",
        sources="hf:Qwen/Qwen3-4B",
    )
