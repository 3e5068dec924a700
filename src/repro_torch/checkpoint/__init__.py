"""Step-atomic checkpoints in the reference's on-disk layout
(counterpart of ``repro.checkpoint``), restored whole onto one device or
as one device's blocks on a mesh."""
from repro_torch.checkpoint.ckpt import (latest_step, restore,
                                         restore_for_device,
                                         restore_for_mesh, save)

__all__ = ["save", "restore", "restore_for_device", "restore_for_mesh",
           "latest_step"]
