"""Granite-3 8B — dense GQA.

[hf:ibm-granite/granite-3.0 family; hf] 40L d_model=4096 32H (kv=8) d_ff=12800
vocab=49155 (note: odd vocab -> physically padded to 49408, logits masked).
"""
from repro_torch.configs.base import ModelConfig, register


@register("granite-3-8b")
def config() -> ModelConfig:
    return ModelConfig(
        name="granite-3-8b",
        family="dense",
        n_layers=40,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=12800,
        vocab=49155,
        rope_theta=10_000.0,
        param_dtype="bfloat16",
        act_dtype="bfloat16",
        sources="hf:ibm-granite/granite-3.0-8b-base",
    )
