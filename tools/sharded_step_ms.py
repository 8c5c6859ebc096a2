#!/usr/bin/env python3
"""Time the port's sharded train step and sharded decode step on one CUDA
card, to compare two checkouts of the port on the same card.

  python3 tools/sharded_step_ms.py [--src DIR] [--train-steps N]
      [--decode-steps N]

``--src`` is the ``src`` directory whose ``repro_torch`` is timed (default:
this checkout's); its kernels build under that checkout's ``build/``. Both
cells are ``chip_smoke.py``'s, on a (4, 2) ``("data", "model")`` mesh whose
eight positions share the card:

* train (14a): ``granite_3_2b`` at full width and depth in bf16, weights
  from seed 0, ``SyntheticLM(vocab, 4096, 4, seed 0)``, microbatches 1,
  remat on; the first step warms up, the others are timed;
* decode (15d): the same model, 4 rows of a 4,096-token prompt into a
  32,768-slot ring, then teacher-forced decode steps, the first a warm-up.

Each step is timed on the host's clock from its call to the card's
synchronisation (the steps are host-bound). One more step of each cell
then counts the placement layer's calls (``placement._wrap``, one or more
an ``smap``; ``placement._collective``, one a collective), and each
call's host cost is timed alone: an ``smap`` of a no-op and a ``psum`` of
a 4-byte block over the mesh's 8 positions, ``--reps`` times. Prints the
card's name and power limit, then one JSON line with every step's ms,
the medians, the counts and the per-call microseconds. It needs one card
and exits non-zero without one.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCH, SEQ, BATCH = "granite_3_2b", 4096, 4
PROMPT, SLOTS = 4096, 32768


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def timed(fn) -> tuple:
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, out


class Calls:
    """Counts the placement layer's calls while it is entered."""

    def __init__(self):
        from repro_torch.sharding import placement

        self.p, self.n = placement, {"wrap": 0, "collective": 0}

    def _counted(self, key, fn):
        def call(*a, **k):
            self.n[key] += 1
            return fn(*a, **k)
        return call

    def __enter__(self):
        self.saved = self.p._wrap, self.p._collective
        self.p._wrap = self._counted("wrap", self.saved[0])
        self.p._collective = self._counted("collective", self.saved[1])
        return self.n

    def __exit__(self, *exc):
        self.p._wrap, self.p._collective = self.saved


def call_us(reps: int) -> dict:
    """Host microseconds of one ``smap`` of a no-op and of one ``psum`` of
    a 4-byte block over the (4, 2) mesh of the card: the median of 5
    batches of ``reps`` calls."""
    import torch

    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.sharding import place, psum, smap

    mesh = make_test_mesh((4, 2), ("data", "model"), devices=["cuda"] * 8)
    x = place(torch.zeros(8, 2, device="cuda"), mesh, ("data", "model"))
    one = smap(lambda t: t[0, 0], x)

    def per_call(fn):
        out = []
        for _ in range(5):
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            out.append((time.perf_counter() - t0) * 1e6 / reps)
        torch.cuda.synchronize()
        return statistics.median(out)
    return {"smap_us": per_call(lambda: smap(lambda t: t, x)),
            "psum_us": per_call(lambda: psum(one, ("data", "model")))}


def train_ms(steps: int) -> list:
    import torch

    from repro_torch.configs import ShapeConfig, get_arch
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import transformer as tf
    from repro_torch.sharding import MeshRules, place_tree
    from repro_torch.train import step as tstep
    from repro_torch.train.optimizer import AdamWConfig

    cfg = get_arch(ARCH)
    rules = MeshRules(make_test_mesh((4, 2), ("data", "model"),
                                     devices=["cuda"] * 8))
    ocfg = AdamWConfig(lr=3e-4, warmup_steps=2, total_steps=steps)
    step, in_sh, _, _ = tstep.build_train_step(
        cfg, ShapeConfig("train_4k", SEQ, BATCH, "train"), rules, ocfg,
        microbatches=1, remat=True)
    pd = place_tree(tf.init_params(cfg, 0, device="cuda"), in_sh[0])
    opt = tstep.sharded_adamw_init(pd)
    stream = SyntheticLM(cfg.vocab, SEQ, BATCH, seed=0)
    out = []
    for i in range(steps + 1):
        batch = place_tree({k: torch.from_numpy(v).to("cuda") for k, v in
                            stream.batch_at(i).items()}, in_sh[2])
        if i < steps:
            ms, (pd, opt, _) = timed(lambda: step(pd, opt, batch))
            out.append(ms)
        else:
            with Calls() as calls:
                step(pd, opt, batch)
    del pd, opt
    torch.cuda.empty_cache()
    return out, calls


def decode_ms(steps: int) -> tuple:
    import torch

    from repro_torch.configs import ShapeConfig, get_arch
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import transformer as tf
    from repro_torch.sharding import MeshRules, place_tree
    from repro_torch.train import step as tstep

    cfg = get_arch(ARCH)
    rules = MeshRules(make_test_mesh((4, 2), ("data", "model"),
                                     devices=["cuda"] * 8))
    pf, pin, _, _ = tstep.build_prefill_step(
        cfg, ShapeConfig("prefill", SLOTS, BATCH, "prefill"), rules)
    df, din, _, _ = tstep.build_decode_step(
        cfg, ShapeConfig("decode", SLOTS, BATCH, "decode"), rules)
    g = torch.Generator(device="cpu").manual_seed(0)
    toks = torch.randint(0, cfg.vocab, (BATCH, PROMPT + steps + 1),
                         generator=g).to("cuda")
    pd = place_tree(tf.init_params(cfg, 0, device="cuda"), pin[0])
    pre, (_, cache) = timed(lambda: pf(pd, place_tree(
        {"tokens": toks[:, :PROMPT]}, pin[1])))
    out = []
    for t in range(steps):
        tb = place_tree({"tokens": toks[:, PROMPT + t]}, din[2])
        ms, (_, cache) = timed(lambda: df(pd, cache, tb))
        out.append(ms)
    with Calls() as calls:
        df(pd, cache, place_tree({"tokens": toks[:, PROMPT + steps]},
                                 din[2]))
    del pd, cache
    torch.cuda.empty_cache()
    return pre, out, calls


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--train-steps", type=int, default=4)
    ap.add_argument("--decode-steps", type=int, default=17)
    ap.add_argument("--reps", type=int, default=2000)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: this script runs on the card only",
              file=sys.stderr)
        return 2
    print(card_line(), flush=True)
    sys.path.insert(0, str(pathlib.Path(args.src).resolve()))
    import repro_torch

    train, train_calls = train_ms(args.train_steps)
    prefill, decode, decode_calls = decode_ms(args.decode_steps)
    print(json.dumps({
        **call_us(args.reps), "train_step_calls": train_calls,
        "decode_step_calls": decode_calls,
        "src": str(pathlib.Path(repro_torch.__file__).parent),
        "card": torch.cuda.get_device_name(0),
        "train_step_ms": train,
        "train_step_ms_median": statistics.median(train[1:]),
        "prefill_ms": prefill, "decode_step_ms": decode,
        "decode_step_ms_median": statistics.median(decode[1:])}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
