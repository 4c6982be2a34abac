"""InternVL2-26B — VLM: InternViT frontend (stubbed) + InternLM2-20B backbone.

[arXiv:2404.16821; hf]  backbone 48L d_model=6144 48H (kv=8) d_ff=16384
vocab=92553 (padded).  Per task rules the modality frontend is a stub:
the batch supplies precomputed ViT patch embeddings (B, 256, 1024)
which a learned projector maps into the text stream.
"""
from repro_torch.configs.base import ModelConfig, register


@register("internvl2-26b")
def config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-26b",
        family="vlm",
        n_layers=48,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        head_dim=128,
        d_ff=16384,
        vocab=92553,
        frontend="patch",
        d_frontend=1024,
        n_patches=256,
        rope_theta=1_000_000.0,
        param_dtype="bfloat16",
        act_dtype="bfloat16",
        sources="arXiv:2404.16821",
    )
