"""Training launcher: ``python -m repro_torch.launch.train``.

Counterpart of ``repro.launch.train``, with its flags and its last line.
It trains the architecture's smoke config (``--smoke`` is on and cannot
be turned off, as in the reference) on the synthetic pipeline, on the
CUDA card; without one it exits 1 with "no CUDA device is available".

  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \\
      --steps 100
"""
from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch._device import resolve_device
from repro_torch.configs.registry import (get_config, get_smoke_config,
                                          list_archs)
from repro_torch.data.pipeline import SyntheticLMData
from repro_torch.optim import AdamWConfig
from repro_torch.train import TrainConfig, train


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint directory (default: "
                         "repro_torch_launch_train in the temporary "
                         "directory)")
    ap.add_argument("--lr", type=float, default=1e-3)
    return ap


def run(args: argparse.Namespace, device) -> dict:
    """The launcher's training run on ``device``; prints its last line
    and returns ``train``'s result."""
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    ckpt = args.ckpt or os.path.join(tempfile.gettempdir(),
                                     "repro_torch_launch_train")
    tcfg = TrainConfig(steps=args.steps, ckpt_dir=ckpt,
                       ckpt_every=max(args.steps // 3, 1), log_every=10,
                       opt=AdamWConfig(lr=args.lr))
    data = SyntheticLMData(vocab=cfg.vocab, batch=args.batch, seq=args.seq)
    out = train(cfg, tcfg, data, device=device)
    print(f"[launch.train] done at step {out['step']}; "
          f"final loss {out['losses'][-1]:.4f}")
    return out


def main(argv: list[str] | None = None) -> None:
    args = parser().parse_args(argv)
    try:
        device = resolve_device()
    except RuntimeError as e:
        raise SystemExit(f"[launch.train] {e}") from e
    run(args, device)


if __name__ == "__main__":
    main()
