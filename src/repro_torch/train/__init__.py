"""The training loop with checkpoint/restart (counterpart of
``repro.train``)."""
from repro_torch.train.trainer import TrainConfig, make_step, train

__all__ = ["TrainConfig", "make_step", "train"]
