"""End-to-end LM training example: a ~100M-parameter granite-style model for a
few hundred steps on the synthetic pipeline, with checkpointing.

Defaults are CPU-sized (~20M params, 200 steps); pass ``--full`` for the
100M-parameter configuration. The demo configuration flows through the
launcher's own code path (``repro_torch.launch.train``).

    PYTHONPATH=src python -m repro_torch.examples.train_lm [--full] \
        [--steps 200] [--device cpu]
"""
import argparse
import os
import tempfile

from ..configs.base import ArchConfig
from ..launch import train as lt


def config_100m() -> ArchConfig:
    return ArchConfig(name="demo-100m", family="dense", n_layers=12,
                      d_model=768, n_heads=12, n_kv_heads=4, head_dim=64,
                      d_ff=2048, vocab=8192, dtype="float32")


def config_20m() -> ArchConfig:
    return ArchConfig(name="demo-20m", family="dense", n_layers=6,
                      d_model=384, n_heads=6, n_kv_heads=2, head_dim=64,
                      d_ff=1024, vocab=4096, dtype="float32")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true", help="~100M params")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_train_lm"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = config_100m() if args.full else config_20m()
    print(f"[example] {cfg.name}: {cfg.param_count()/1e6:.1f}M params")

    return lt.main(["--arch", cfg.name, "--steps", str(args.steps),
                    "--batch", str(args.batch), "--seq", str(args.seq),
                    "--ckpt-dir", args.ckpt_dir, "--ckpt-every", "50",
                    "--lr", "1e-3", "--log-every", "20",
                    "--device", args.device], cfg=cfg)


if __name__ == "__main__":
    raise SystemExit(main())
