"""Run one cell of ``BENCHMARK.json`` once on this machine's card.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Prints the set-up, the window and the check on standard error, with each
number compared beside its limit last, and one JSON object as the last
line of standard output. Exits non-zero, printing no result, without a
CUDA card (or fewer than the cell asks for), where the program cannot be
loaded, or where JAX or the JAX package was loaded.

``--control <batches>`` prints instead the readings of the control: the
plain reference in bfloat16 put in the program's place for the sampled
rows of that many batches (host only; no measured run passes it).
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, default=0)
    a = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    from bench.harness import cell, spec

    bspec = spec.load()
    w = spec.workload(bspec, a.workload)
    if a.control:
        out = cell.control(a.workload, a.seed, a.control, bspec)
        print(json.dumps(out), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        cell.log("no CUDA card: this benchmark measures the card only")
        return 3
    if torch.cuda.device_count() < int(w["chips"]):
        cell.log(f"{w['name']} needs {w['chips']} cards, this machine has "
                 f"{torch.cuda.device_count()}")
        return 3
    src = ROOT / "src"
    if not (src / "repro_torch").is_dir():
        cell.log(f"the program is not here: no {src / 'repro_torch'}")
        return 4
    sys.path.insert(0, str(src))
    out = cell.run(a.workload, a.seed, a.seconds, bool(a.trace),
                   t_start=T_START, bench_spec=bspec)
    found = cell.forbidden_modules()
    if found:
        cell.log("refused: JAX or the JAX package was loaded:", found)
        return 5
    for name, v in out["check"].items():
        cell.log(f"check {name} = {v['value']!r} (limit {v['limit']!r})")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
