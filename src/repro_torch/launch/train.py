"""End-to-end training command line.

The port of ``repro/launch/train.py``: the same flags, log lines and
checkpoints, on the card unless ``--device cpu`` is given::

    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch llama3.2-1b --steps 300 --seq 256 --batch 8 --reduced

``--mode rar`` uses the paper-faithful explicit ring-all-reduce step on a
ring of ``--devices`` workers (default 1), all on the one device;
``--mode pjit`` the single-program step.  Checkpoints land in --ckpt-dir.
Seconds are host wall time; the loss is read back every step, which
waits for the device.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np

from repro_torch import ckpt, resolve_device
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, make_batch
from repro_torch.dist.steps import (RingMesh, make_rar_train_step,
                                    make_train_step)
from repro_torch.models import build_model
from repro_torch.models.config import InputShape
from repro_torch.optim import adamw
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.tree import leaves


def main(argv=None) -> dict:
    """Run the CLI on ``argv``; returns ``losses``, the final ``params``
    and ``opt`` state, and the ``checkpoints`` written."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--reduced", action="store_true",
                    help="train the reduced smoke variant (CPU-friendly)")
    ap.add_argument("--mode", choices=("pjit", "rar"), default="pjit")
    ap.add_argument("--devices", type=int, default=0,
                    help="ring width: N workers of the RAR step, run one "
                         "after another on --device (default 1)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt-dir", default="checkpoints")
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    shape = InputShape("cli", args.seq, args.batch, "train")
    model = build_model(cfg, max_seq=args.seq, device=dev)
    params = model.init(0)
    n_dev = max(args.devices, 1)
    n_params = sum(p.numel() for p in leaves(params))
    print(f"[train] {cfg.name}{' (reduced)' if args.reduced else ''}: "
          f"{n_params/1e6:.1f}M params, {n_dev} device(s) on {dev}, "
          f"mode={args.mode}")

    ocfg = AdamWConfig(lr=args.lr, warmup_steps=min(50, args.steps // 10 + 1),
                       total_steps=args.steps)
    opt = adamw.init(ocfg, params)

    if args.mode == "rar":
        if args.batch % n_dev:
            raise SystemExit(f"batch {args.batch} must divide over "
                             f"{n_dev} devices")
        step_fn = make_rar_train_step(model, ocfg,
                                      RingMesh(range(n_dev), dev))
    else:
        step_fn = make_train_step(model, ocfg)

    losses, saved = [], []
    t0 = time.time()
    for step in range(args.steps):
        batch = make_batch(cfg, shape, step, DataConfig(), device=dev)
        params, opt, metrics = step_fn(params, opt, batch)
        losses.append(float(metrics["loss"]))
        if step % args.log_every == 0 or step == args.steps - 1:
            dt = time.time() - t0
            print(f"[train] step {step:5d} loss {losses[-1]:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"lr {float(metrics['lr']):.2e} ({dt:.1f}s)")
        if args.ckpt_every and step and step % args.ckpt_every == 0:
            path = os.path.join(args.ckpt_dir, f"{cfg.name}_{step}.npz")
            ckpt.save(path, params=params, opt_state=opt, step=step)
            saved.append(path)
            print(f"[train] checkpoint -> {path}")

    first = np.mean(losses[: max(3, len(losses) // 10)])
    last = np.mean(losses[-max(3, len(losses) // 10):])
    print(f"[train] loss {first:.4f} -> {last:.4f} "
          f"({'improved' if last < first else 'NO IMPROVEMENT'})")
    return {"losses": losses, "params": params, "opt": opt,
            "checkpoints": saved}


if __name__ == "__main__":
    main()
