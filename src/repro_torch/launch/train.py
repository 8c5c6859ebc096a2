"""End-to-end training launcher (fault-tolerant), on one device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite_3_2b \
        --reduced --steps 50 --batch 8 --seq 128 --ckpt-dir /tmp/run0 \
        [--device cpu]

Runs a real training loop: the synthetic stream (``data.pipeline``), the
train step (``train.step``: the loss through the model's kernels, AdamW),
checkpoints (``ckpt.checkpoint``). It runs on the card (``--device cuda``,
the default; without a card it refuses and exits non-zero) or on the CPU
with ``--device cpu`` (the kernels' plain versions). Flags, defaults and
printed lines are the reference launcher's.

Fault tolerance:
  * checkpoints are written asynchronously every ``--ckpt-every`` steps with
    atomic commit; ``--resume`` restarts from LATEST. A checkpoint's step is
    the number of batches its state has taken (the one written after batch
    ``s`` is step ``s + 1``), so a resumed run takes the batches an
    uninterrupted run would have, and ends with the same parameters (the
    reference labels it ``s`` and its resume takes batch ``s`` twice);
  * the data pipeline is stateless-deterministic (step -> batch), so a
    restart replays no data and skips none;
  * ``--simulate-failure-at`` kills the process mid-run (exit 42, after
    the in-flight checkpoint writes have landed).
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import torch

from ..ckpt import checkpoint as ckpt
from ..configs.base import get_arch
from ..core.engine import resolve_device
from ..data.pipeline import Prefetcher, SyntheticLM
from ..models import transformer as tf
from ..train.optimizer import AdamWConfig, adamw_init
from ..train.step import train_step

__all__ = ["main"]


def main(argv=None, cfg=None) -> int:
    """Run the launcher on ``argv``; ``cfg`` (an ``ArchConfig``), where
    given, is the model in place of ``--arch``'s."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--simulate-failure-at", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default: the kernels) or cpu (their "
                         "plain versions)")
    args = ap.parse_args(argv)

    try:
        device = resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        print(f"[train] {e}", file=sys.stderr, flush=True)
        return 2
    cfg = get_arch(args.arch) if cfg is None else cfg
    if args.reduced:
        cfg = cfg.reduced()
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=max(2, args.steps // 20),
                          total_steps=args.steps)

    params = tf.init_params(cfg, args.seed, device=device)
    opt_state = adamw_init(params)
    start_step = 0
    if (args.resume and args.ckpt_dir
            and ckpt.latest_step(args.ckpt_dir) is not None):
        start_step, state = ckpt.restore(args.ckpt_dir,
                                         {"params": params, "opt": opt_state})
        params, opt_state = state["params"], state["opt"]
        print(f"[train] resumed from step {start_step}", flush=True)

    source = SyntheticLM(cfg.vocab, args.seq, args.batch, seed=args.seed)
    prefetch = Prefetcher(source, start_step=start_step, transform=lambda b: {
        k: torch.from_numpy(v).to(device) for k, v in b.items()})

    t0 = time.time()
    losses = []
    try:
        for step, batch in prefetch:
            if step >= args.steps:
                break
            params, opt_state, metrics = train_step(
                params, opt_state, batch, cfg, opt_cfg, remat=args.remat)
            if (args.simulate_failure_at is not None
                    and step == args.simulate_failure_at):
                # Drain in-flight async saves so the crash point is
                # deterministic: resume then restores the last boundary.
                ckpt.wait_all()
                print(f"[train] simulating crash at step {step}", flush=True)
                os._exit(42)
            if args.ckpt_dir and step > 0 and step % args.ckpt_every == 0:
                ckpt.save_async(args.ckpt_dir, step + 1,
                                {"params": params, "opt": opt_state})
            if step % args.log_every == 0 or step == args.steps - 1:
                loss = float(metrics["loss"])
                losses.append(loss)
                dt = time.time() - t0
                print(f"[train] step={step} loss={loss:.4f} "
                      f"gnorm={float(metrics['grad_norm']):.3f} "
                      f"({dt:.1f}s)", flush=True)
    finally:
        prefetch.close()
    if args.ckpt_dir:
        ckpt.wait_all()   # drain in-flight async saves before the final one
        ckpt.save(args.ckpt_dir, args.steps, {"params": params,
                                              "opt": opt_state})
    if len(losses) >= 2:
        print(f"[train] loss {losses[0]:.4f} -> {losses[-1]:.4f} "
              f"({'improved' if losses[-1] < losses[0] else 'NOT improved'})",
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
