"""The port of ``repro.training``: for now the synthetic data stream that
``launch/serve_lm.py`` draws its prompts from."""
from repro_torch.training.data import SyntheticConfig, SyntheticData

__all__ = ["SyntheticConfig", "SyntheticData"]
