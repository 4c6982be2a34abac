"""Mixtral 8x22B — 8-expert top-2 MoE with sliding-window attention.

[arXiv:2401.04088; hf]  56L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=32768.
"""
from repro_torch.configs.base import ModelConfig, register


@register("mixtral-8x22b")
def config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x22b",
        family="moe",
        n_layers=56,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        head_dim=128,
        d_ff=16384,
        vocab=32768,
        n_experts=8,
        top_k=2,
        expert_d_ff=16384,
        window=4096,             # SWA -> sub-quadratic; long_500k runs
        rope_theta=1_000_000.0,
        moe_group="seq",          # grouped routing (GShard groups; §Perf)
        moe_group_seq=1024,
        param_dtype="bfloat16",
        act_dtype="bfloat16",
        sources="arXiv:2401.04088",
    )
