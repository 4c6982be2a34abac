"""RecurrentGemma-2B — Griffin hybrid: RG-LRU + local attention, 2:1 pattern.

[arXiv:2402.19427; hf]  26L d_model=2560 10H (MQA kv=1, head 256) d_ff=7680
vocab=256000.  Pattern (rec, rec, attn) cycled; local attention window 2048;
RG-LRU width 2560, causal conv width 4.  The assignment sheet writes the
pattern ratio as "1:2" (attn:rec) — same 2 recurrent : 1 attention mix.
"""
from repro_torch.configs.base import ModelConfig, register


@register("recurrentgemma-2b")
def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-2b",
        family="hybrid",
        n_layers=26,
        d_model=2560,
        n_heads=10,
        n_kv_heads=1,
        head_dim=256,
        d_ff=7680,
        vocab=256000,
        act="gelu",
        pattern=("rec", "rec", "attn"),
        d_rnn=2560,
        conv_width=4,
        window=2048,
        rope_theta=10_000.0,
        param_dtype="bfloat16",
        act_dtype="bfloat16",
        sources="arXiv:2402.19427",
    )
