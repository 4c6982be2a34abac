"""The LM stack's models (the port of ``repro.models``): ``build_model``
returns a ``Model`` (an ``nn.Module`` holding the weights) on the card by
default.  ``models/convert.py`` carries a ``repro`` parameter tree across."""
from repro_torch.models.model import Model, build_model

__all__ = ["Model", "build_model"]
