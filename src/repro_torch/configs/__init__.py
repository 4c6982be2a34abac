"""Architecture registry — importing this package registers all configs."""
from repro_torch.configs.base import ARCHS, ModelConfig, get_config, list_archs, register

# one module per assigned architecture; import order = registry order
from repro_torch.configs import (  # noqa: F401
    deepseek_v2_236b,
    granite_3_8b,
    hubert_xlarge,
    internvl2_26b,
    mixtral_8x22b,
    qwen3_32b,
    qwen3_4b,
    recurrentgemma_2b,
    rwkv6_1_6b,
    starcoder2_15b,
)

__all__ = ["ARCHS", "ModelConfig", "get_config", "list_archs", "register"]
