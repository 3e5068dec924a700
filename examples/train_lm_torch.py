"""Train a ~100M-parameter LM on the PyTorch port for a few hundred steps
on the synthetic pipeline, with checkpointing — then kill and resume to
demonstrate the fault-tolerance path (the loss curve continues exactly).
Twin of examples/train_lm.py; it writes its checkpoints to a directory
of its own.

  PYTHONPATH=src python examples/train_lm_torch.py [--steps 300] \\
      [--ckpt $TMPDIR/repro_torch_train_lm] [--device cpu]
"""
import argparse
import dataclasses
import os
import shutil
import tempfile

import numpy as np

from repro_torch._device import resolve_device
from repro_torch.configs.registry import get_smoke_config
from repro_torch.data.pipeline import SyntheticLMData
from repro_torch.models import schema
from repro_torch.optim import AdamWConfig
from repro_torch.train import TrainConfig, train

# under the temporary directory (TMPDIR), not the reference's
CKPT_DIR = os.path.join(tempfile.gettempdir(), "repro_torch_train_lm")


def run(steps: int = 300, ckpt: str = CKPT_DIR, device=None,
        cfg=None, batch: int = 8, seq: int = 128) -> dict:
    """The example's body at the reference's sizes (a test passes a
    narrower ``cfg`` and a smaller batch); returns both runs' outputs."""
    dev = resolve_device(device)
    # ~100M params: granite-family, 8 layers, d=512
    cfg = cfg or dataclasses.replace(
        get_smoke_config("granite-3-2b"), n_layers=8, d_model=512,
        n_heads=8, n_kv_heads=4, head_dim=64, d_ff=1536, vocab=8192,
        tie_embeddings=False)
    n = schema.param_count(cfg)
    print(f"model: {n/1e6:.1f}M params ({cfg.n_layers}L d={cfg.d_model})")

    shutil.rmtree(ckpt, ignore_errors=True)
    tcfg = TrainConfig(steps=steps, ckpt_dir=ckpt, ckpt_every=50,
                       log_every=10, warmup=30,
                       opt=AdamWConfig(lr=6e-4, weight_decay=0.01))
    data = SyntheticLMData(vocab=cfg.vocab, batch=batch, seq=seq)

    # run two thirds, "crash", resume — the curve must continue seamlessly
    crash_at = steps * 2 // 3
    print(f"\n-- run until simulated crash at step {crash_at} --")
    out1 = train(cfg, tcfg, data, stop_after=crash_at, device=dev)
    print("\n-- CRASH — restarting from latest checkpoint --")
    out2 = train(cfg, tcfg, data, device=dev)
    losses = out1["losses"] + out2["losses"]
    print(f"\nfirst-20 mean loss {np.mean(losses[:20]):.3f} → "
          f"last-20 mean {np.mean(losses[-20:]):.3f} "
          f"(down {np.mean(losses[:20]) - np.mean(losses[-20:]):.3f})")
    return {"crash_at": crash_at, "first": out1, "resumed": out2,
            "losses": losses}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--ckpt", default=CKPT_DIR)
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA)")
    args = ap.parse_args()
    run(args.steps, args.ckpt, args.device)


if __name__ == "__main__":
    main()
