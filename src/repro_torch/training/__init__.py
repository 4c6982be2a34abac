"""The port of ``repro.training``: AdamW, the train state and step, and the
synthetic data stream (checkpoints in ``repro_torch.training.checkpoint``)."""
from repro_torch.training.data import SyntheticConfig, SyntheticData
from repro_torch.training.optimizer import AdamWConfig, adamw_init, adamw_update
from repro_torch.training.train_step import TrainState, init_train_state, make_train_step

__all__ = [
    "AdamWConfig",
    "adamw_init",
    "adamw_update",
    "TrainState",
    "make_train_step",
    "init_train_state",
    "SyntheticConfig",
    "SyntheticData",
]
