"""Step-atomic checkpoints in the reference's on-disk layout
(counterpart of ``repro.checkpoint``)."""
from repro_torch.checkpoint.ckpt import (latest_step, restore,
                                         restore_for_device, save)

__all__ = ["save", "restore", "restore_for_device", "latest_step"]
