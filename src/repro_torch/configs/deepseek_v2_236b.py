"""DeepSeek-V2 236B — MLA (kv_lora 512) + MoE 160 routed top-6 + 2 shared.

[arXiv:2405.04434; hf]  60L d_model=5120 128H d_ff(expert)=1536 vocab=102400.
MLA: q_lora 1536, kv_lora 512, qk_nope 128, qk_rope 64 (decoupled), v 128.
Layer 0 uses a dense FFN (d_ff 12288) per the paper; the rest are MoE.
"""
from repro_torch.configs.base import ModelConfig, register


@register("deepseek-v2-236b")
def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-236b",
        family="moe",
        n_layers=60,
        d_model=5120,
        n_heads=128,
        n_kv_heads=128,          # MLA: latent cache is shared; heads read it
        head_dim=192,            # qk_nope + qk_rope (scoring width)
        d_ff=12288,              # the dense layer-0 FFN
        vocab=102400,
        mla=True,
        q_lora=1536,
        kv_lora=512,
        qk_nope_dim=128,
        qk_rope_dim=64,
        v_head_dim=128,
        n_experts=160,
        n_shared_experts=2,
        top_k=6,
        expert_d_ff=1536,
        first_dense_layers=1,
        rope_theta=10_000.0,
        moe_group="seq",          # grouped routing (GShard groups; §Perf)
        moe_group_seq=1024,
        param_dtype="bfloat16",
        act_dtype="bfloat16",
        sources="arXiv:2405.04434",
    )
