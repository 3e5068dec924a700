"""Fault tolerance (counterpart of ``repro.ft``): hedged dispatch
(``straggler``) and the int8 gradient codec of ``repro.ft.compress``,
which is ``kernels/quant.py``'s per-row quantizer, re-exported here as
the reference re-exports its own. The cross-pod mean and elastic
re-meshing need a mesh of several cards and are not ported yet."""
from repro_torch.ft.straggler import HedgedDispatcher, simulated_replica
from repro_torch.kernels.quant import dequantize_int8, quantize_int8

__all__ = ["quantize_int8", "dequantize_int8", "HedgedDispatcher",
           "simulated_replica"]
