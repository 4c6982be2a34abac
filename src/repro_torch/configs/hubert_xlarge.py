"""HuBERT X-Large — encoder-only audio transformer (frame classification).

[arXiv:2106.07447; unverified]  48L d_model=1280 16H d_ff=5120 vocab=504
(masked-unit prediction classes).  Encoder-only: bidirectional attention, no
decode shapes.  The conv waveform frontend is stubbed: the batch
supplies precomputed 512-d frame features which a learned projector embeds.
"""
from repro_torch.configs.base import ModelConfig, register


@register("hubert-xlarge")
def config() -> ModelConfig:
    return ModelConfig(
        name="hubert-xlarge",
        family="encoder",
        n_layers=48,
        d_model=1280,
        n_heads=16,
        n_kv_heads=16,
        head_dim=80,
        d_ff=5120,
        vocab=504,
        act="gelu",
        norm="layernorm",
        causal=False,
        frontend="frame",
        d_frontend=512,
        param_dtype="bfloat16",
        act_dtype="bfloat16",
        sources="arXiv:2106.07447",
    )
