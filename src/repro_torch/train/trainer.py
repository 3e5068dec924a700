"""Training loop with checkpoint/restart.

Counterpart of ``repro.train.trainer``, on one device (CUDA unless
named). A step is the train-mode forward of ``models.model.loss_fn``
(each super-block rematerialised where ``cfg.remat`` is set), its
backward by autograd, the warmup-cosine multiplier of the updates done
so far (0 at the first step, as the reference's), and one AdamW update
of the model's parameters in place (``optim/adamw.py``).

Restart: with ``resume`` the trainer starts from the newest checkpoint
in ``ckpt_dir`` and the deterministic pipeline replays exactly the
batches it owes, so a crash is invisible in the loss curve. Checkpoints
hold the reference's tree, ``{"params": …, "opt": {"m", "v", "step"}}``
with every per-layer leaf stacked on the super-block axis
(``models/convert.py``), so either package resumes the other's run.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Callable

import torch

from repro_torch._device import resolve_device
from repro_torch.checkpoint import latest_step, restore_for_device, save
from repro_torch.configs.base import ArchConfig
from repro_torch.data.pipeline import SyntheticLMData
from repro_torch.models import convert
from repro_torch.models import model as model_api
from repro_torch.models.sharding_api import NO_SHARD, ShardPolicy
from repro_torch.models.transformer import DecoderLM
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               cosine_schedule)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The reference's fields and defaults, but two: ``ckpt_dir`` None
    is ``repro_torch_ckpt`` in the temporary directory (``TMPDIR``), and
    ``ckpt_every`` 0 writes no checkpoint at all."""
    steps: int = 300
    ckpt_dir: str | None = None
    ckpt_every: int = 100
    log_every: int = 20
    seed: int = 0
    opt: AdamWConfig = AdamWConfig(lr=1e-3, weight_decay=0.01)
    warmup: int = 50


def make_step(cfg: ArchConfig, opt: AdamWConfig, warmup: int,
              total: int, shard: ShardPolicy = NO_SHARD) -> Callable:
    """(model, opt_state, batch) → (loss, metrics): one training step,
    the model's parameters and ``opt_state`` updated in place. The
    gradient is ``models.model.loss_and_grads``'s (a zero one where the
    forward does not reach a parameter, as in the reference), under the
    shard policy ``shard``."""
    def step_fn(model: DecoderLM, opt_state: dict, batch: dict):
        loss, metrics, grads = model_api.loss_and_grads(cfg, model, batch,
                                                        shard)
        lr = cosine_schedule(opt_state["step"], warmup=warmup, total=total)
        adamw_update(grads, opt_state, dict(model.named_parameters()), opt,
                     lr_scale=lr)
        return loss, metrics
    return step_fn


def opt_state_tree(cfg: ArchConfig, model: DecoderLM, state: dict) -> dict:
    """The optimizer state in the reference's layout: moments stacked as
    the parameters (``convert.to_jax_tree``), the step an int32 scalar."""
    return {"m": convert.to_jax_tree(cfg, model, state["m"]),
            "v": convert.to_jax_tree(cfg, model, state["v"]),
            "step": convert.host_array(state["step"])}


def opt_state_from_tree(cfg: ArchConfig, model: DecoderLM, tree: dict,
                        device: torch.device) -> dict:
    """The inverse of :func:`opt_state_tree`, on ``device``."""
    return {"m": convert.from_jax_tree(cfg, model, tree["m"]),
            "v": convert.from_jax_tree(cfg, model, tree["v"]),
            "step": convert.as_tensor(tree["step"]).to(
                device=device, dtype=torch.int32)}


def _device_batch(batch: dict, device: torch.device) -> dict:
    return {k: torch.as_tensor(v).long().to(device) for k, v in batch.items()}


def train(cfg: ArchConfig, tcfg: TrainConfig, data: SyntheticLMData,
          resume: bool = True, stop_after: int | None = None,
          log: Callable = print,
          device: str | torch.device | None = None) -> dict:
    """Run (or resume) training on ``device`` (CUDA unless named).
    Returns {"losses": the losses of the steps run, "step": the step
    reached, "params": the trained ``DecoderLM`` (its parameters back
    without a gradient, ready to serve), "step_ms": each step's time
    (CUDA events on a card, the host's clock elsewhere)}."""
    dev = resolve_device(device)
    ckpt_dir = tcfg.ckpt_dir or os.path.join(tempfile.gettempdir(),
                                             "repro_torch_ckpt")
    step0 = latest_step(ckpt_dir) if resume else None
    if step0 is not None:
        step0, state = restore_for_device(ckpt_dir, dev)
        model = convert.from_jax_params(cfg, state["params"], dev)
        opt_state = opt_state_from_tree(cfg, model, state["opt"], dev)
        del state
        log(f"[train] resumed from step {step0}")
    else:
        step0 = 0
        model = model_api.init_params(cfg, tcfg.seed, device=dev)
        opt_state = adamw_init(dict(model.named_parameters()), tcfg.opt)

    step_fn = make_step(cfg, tcfg.opt, tcfg.warmup, tcfg.steps)
    losses, marks = [], []
    timer = _Timer(dev)
    t0 = time.time()
    end = tcfg.steps if stop_after is None else min(tcfg.steps,
                                                    step0 + stop_after)
    for step in range(step0, end):
        batch = _device_batch(data.batch_at(step), dev)
        marks.append(timer.mark())
        loss, metrics = step_fn(model, opt_state, batch)
        marks.append(timer.mark())
        losses.append(float(loss))
        if step % tcfg.log_every == 0:
            dt = time.time() - t0
            log(f"[train] step {step:5d} loss {float(loss):.4f} "
                f"ce {float(metrics['ce']):.4f} ({dt:.1f}s)")
        if tcfg.ckpt_every > 0 and ((step + 1) % tcfg.ckpt_every == 0
                                    or step + 1 == end):
            save(ckpt_dir, step + 1,
                 {"params": convert.to_jax_params(cfg, model),
                  "opt": opt_state_tree(cfg, model, opt_state)})
    return {"losses": losses, "step": end, "params": model,
            "step_ms": timer.elapsed(marks)}


class _Timer:
    """Step marks: CUDA events on a card, the host clock elsewhere."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def mark(self):
        if not self.cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def elapsed(self, marks: list) -> list[float]:
        """Milliseconds between each pair of marks."""
        pairs = list(zip(marks[::2], marks[1::2]))
        if not self.cuda:
            return [(b - a) * 1e3 for a, b in pairs]
        torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in pairs]
