"""AdamW with f32, bf16 or int8 moments.

Counterpart of ``repro.optim.adamw``, with the reference's arithmetic
step for step (which ``torch.optim.AdamW`` does not compute: it decays
before the moment step and puts eps under the bias correction):

* the gradients are clipped to a global norm of ``clip_norm``
  (scale = min(1, clip / (‖g‖ + 1e-12)));
* m ← b1·m + (1 − b1)·g and v ← b2·v + (1 − b2)·g², in f32;
* the bias corrections 1 − b ** step in f32, step counted from 1;
* p ← p − lr·lr_scale·(m̂ / (√v̂ + eps) + wd·p).

The moments are stored in ``moment_dtype``: f32, bf16 (rounded to
nearest even) or int8 with one f32 scale a row of the trailing axis
(``{"q": int8, "s": f32}``; the 8-bit-Adam recipe). The int8 codec is
the optimizer's own, as in the reference: per-row absmax / 127 floored
at 1e-20, not ``kernels/quant.py``'s zero-row guard.

The parameters and gradients are mappings of name → tensor (a model's
``dict(named_parameters())``); :func:`adamw_update` writes the new
parameters and moments in place under ``torch.no_grad`` and keeps the
step count on the parameters' device, so a step needs no host sync.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: str = "float32"     # float32 | bfloat16 | int8


# ----------------------------------------------------- int8 moment codec
def _q8_encode(x: torch.Tensor) -> dict:
    scale = x.abs().amax(dim=-1, keepdim=True) / 127.0
    scale = scale.clamp_min(1e-20)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return {"q": q, "s": scale.float()}


def _q8_decode(e: dict) -> torch.Tensor:
    return e["q"].float() * e["s"]


def _encode(x: torch.Tensor, dtype: str):
    if dtype == "int8":
        return _q8_encode(x)
    return x.to(getattr(torch, dtype))


def _decode(e, dtype: str) -> torch.Tensor:
    if dtype == "int8":
        return _q8_decode(e)
    return e.float()


# ------------------------------------------------------------- optimizer
def adamw_init(params: Mapping[str, torch.Tensor], cfg: AdamWConfig
               ) -> dict:
    """Zero moments for every parameter, and the step count 0 (an int32
    scalar on the parameters' device)."""
    def zero_like(p):
        return _encode(torch.zeros(p.shape, dtype=torch.float32,
                                   device=p.device), cfg.moment_dtype)
    dev = next(iter(params.values())).device
    return {"m": {n: zero_like(p) for n, p in params.items()},
            "v": {n: zero_like(p) for n, p in params.items()},
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tensors) -> torch.Tensor:
    """√(Σ ‖x‖²) over ``tensors`` (an iterable), in f32."""
    total = 0
    for x in tensors:
        xf = x.float()
        total = total + (xf * xf).sum()
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


@torch.no_grad()
def adamw_update(grads: Mapping[str, torch.Tensor], state: dict,
                 params: Mapping[str, torch.Tensor], cfg: AdamWConfig,
                 lr_scale: torch.Tensor | float = 1.0) -> dict:
    """One AdamW step: ``params`` and ``state``'s moments and step are
    updated in place. ``grads`` has ``params``' names. Returns
    ``state``."""
    step = state["step"] + 1
    gnorm = global_norm(grads[n] for n in params)
    scale = torch.clamp_max(cfg.clip_norm / (gnorm + 1e-12), 1.0)
    stepf = step.float()
    one = torch.ones((), dtype=torch.float32, device=stepf.device)
    c1 = 1 - (one * cfg.b1) ** stepf
    c2 = 1 - (one * cfg.b2) ** stepf
    lr = cfg.lr * lr_scale
    md = cfg.moment_dtype
    for n, p in params.items():
        g = grads[n].float() * scale
        m = cfg.b1 * _decode(state["m"][n], md) + (1 - cfg.b1) * g
        v = cfg.b2 * _decode(state["v"][n], md) + (1 - cfg.b2) * g * g
        mh = m / c1
        vh = v / c2
        pf = p.float()
        upd = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * pf
        p.copy_((pf - lr * upd).to(p.dtype))
        state["m"][n] = _encode(m, md)
        state["v"][n] = _encode(v, md)
    state["step"] = step
    return state
