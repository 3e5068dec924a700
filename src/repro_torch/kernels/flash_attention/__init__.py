from repro_torch.kernels.flash_attention.flash import flash_cuda
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import flash_blocked, flash_ref

__all__ = ["flash_attention", "flash_blocked", "flash_ref", "flash_cuda"]
