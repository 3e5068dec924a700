"""Cross-pod gradient compression.

Counterpart of ``repro.ft.compress``. The "pod" mesh axis crosses the
data-centre network, with far less bandwidth than the links inside a
pod. Gradients are reduced hierarchically: a full-precision mean
*within* each pod over the data axis, then an int8-quantized exchange
*across* pods — 4× fewer bytes on the slow leg than an f32 all-reduce,
at a quantization error far under the optimizer's noise (per-row
scales keep the relative error under 1/127 a row).

The reference runs the two legs under ``shard_map``; here they are two
``torch.distributed`` collectives on the groups of a ``DeviceMesh``
(``torch.distributed.device_mesh``), on the device of the gradients: an
f32 ``all_reduce`` over the data group, then ``quantize_int8``
(kernels/quant.py, the reference's quantizer bit for bit) and an
``all_gather`` of payloads and scales over the pod group, dequantized
and averaged on every rank.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist

from repro_torch.kernels.quant import dequantize_int8, quantize_int8

__all__ = ["axis_size", "quantize_int8", "dequantize_int8",
           "compressed_crosspod_mean"]


def axis_size(mesh, axis_name: str) -> int:
    """Size of the named axis of a ``DeviceMesh``."""
    return mesh.size(mesh.mesh_dim_names.index(axis_name))


def _crosspod_leaf(g: torch.Tensor, group, n_pods: int) -> torch.Tensor:
    """Mean over the pod group with an int8 exchange."""
    q, s = quantize_int8(g)
    qs = [torch.empty_like(q) for _ in range(n_pods)]
    ss = [torch.empty_like(s) for _ in range(n_pods)]
    dist.all_gather(qs, q, group=group)
    dist.all_gather(ss, s, group=group)
    deq = dequantize_int8(torch.stack(qs), torch.stack(ss))
    out = torch.mean(deq, dim=0)
    return out.reshape(g.shape)


def compressed_crosspod_mean(grads: Any, mesh, pod_axis: str = "pod",
                             data_axis: str = "data") -> Any:
    """Hierarchical gradient mean over ``mesh`` (a ``DeviceMesh`` with
    ``pod_axis`` and ``data_axis``): an f32 mean over the data group,
    then the int8 exchange over the pod group. ``grads`` is a tensor or a
    nested dict of tensors, each this rank's gradient, whole (replicated
    over the other axes); returns the same structure, new tensors."""
    data_group = mesh.get_group(data_axis)
    pod_group = mesh.get_group(pod_axis)
    n_data = axis_size(mesh, data_axis)
    n_pods = axis_size(mesh, pod_axis)

    def apply(g):
        if isinstance(g, dict):
            return {k: apply(v) for k, v in g.items()}
        g = g.float().clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=data_group)
        return _crosspod_leaf(g / n_data, pod_group, n_pods)
    return apply(grads)
