from repro_torch.kernels.gain.gain import gain_cuda
from repro_torch.kernels.gain.ops import greedy_gain
from repro_torch.kernels.gain.ref import gain_ref

__all__ = ["greedy_gain", "gain_ref", "gain_cuda"]
