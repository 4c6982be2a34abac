"""StarCoder2-15B — dense GQA (kv=4), LayerNorm + GELU MLP, RoPE.

[arXiv:2402.19173; hf]  40L d_model=6144 48H (kv=4) d_ff=24576 vocab=49152.
"""
from repro_torch.configs.base import ModelConfig, register


@register("starcoder2-15b")
def config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-15b",
        family="dense",
        n_layers=40,
        d_model=6144,
        n_heads=48,
        n_kv_heads=4,
        head_dim=128,
        d_ff=24576,
        vocab=49152,
        act="gelu",
        norm="layernorm",
        rope_theta=100_000.0,
        param_dtype="bfloat16",
        act_dtype="bfloat16",
        sources="arXiv:2402.19173",
    )
