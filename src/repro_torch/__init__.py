"""PyTorch/CUDA port of the similarity-cache system in ``repro``.

Mirrors ``repro``'s modules path for path (``repro_torch.core.simcache``
is the counterpart of ``repro.core.simcache``). Imports torch and numpy
only — never ``jax`` and nothing of ``repro``.

fp32 products run in IEEE fp32: TF32 is switched off for matmuls and
cuDNN here, where the package initialises, since it would break every
tolerance the port is held to against the JAX reference.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
