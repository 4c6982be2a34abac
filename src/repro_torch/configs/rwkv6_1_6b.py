"""RWKV-6 "Finch" 1.6B — attention-free, data-dependent decay linear RNN.

[arXiv:2404.05892; unverified]  24L d_model=2048 d_ff=7168 vocab=65536.
Head dim 64 (32 heads).  Trained/prefilled with chunked linear attention;
decoded with the exact (H, K, V) state recurrence -> O(1)/token, long_500k ok.
"""
from repro_torch.configs.base import ModelConfig, register


@register("rwkv6-1.6b")
def config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-1.6b",
        family="rwkv",
        n_layers=24,
        d_model=2048,
        n_heads=32,
        n_kv_heads=32,
        head_dim=64,
        d_ff=7168,
        vocab=65536,
        rwkv_head_dim=64,
        rwkv_lora=64,
        param_dtype="bfloat16",
        act_dtype="bfloat16",
        sources="arXiv:2404.05892",
    )
