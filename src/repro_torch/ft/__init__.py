"""Fault tolerance (counterpart of ``repro.ft``): hedged dispatch
(``straggler``), the hierarchical int8 cross-pod gradient mean
(``compress``, over a ``torch.distributed`` device mesh, with the
per-row int8 codec of kernels/quant.py re-exported as the reference
re-exports its own) and elastic re-meshing (``elastic``: the new mesh
and the spec tree a checkpoint restores by)."""
from repro_torch.ft.compress import (axis_size, compressed_crosspod_mean,
                                     dequantize_int8, quantize_int8)
from repro_torch.ft.elastic import plan_mesh, reshard_plan
from repro_torch.ft.straggler import HedgedDispatcher, simulated_replica

__all__ = ["quantize_int8", "dequantize_int8", "axis_size",
           "compressed_crosspod_mean", "plan_mesh", "reshard_plan",
           "HedgedDispatcher", "simulated_replica"]
