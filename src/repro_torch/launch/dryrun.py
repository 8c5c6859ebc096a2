"""The dry run: every (arch x shape x mesh) cell of the production meshes,
and the GLIN cell, reckoned without a card (the reference's
``launch/dryrun.py``, which lowers and compiles each cell).

For each cell it:

1. lays out the production mesh (``launch.mesh.make_production_mesh``:
   16 x 16 single-pod, 2 x 16 x 16 multi-pod), each position a chip of
   its own;
2. builds the step the reference builds: ``train_4k`` the sharded train
   step (``train.step.build_train_step``) with the reference's microbatch
   rule, ``prefill_32k`` the sharded prefill, ``decode_32k`` and
   ``long_500k`` the sharded decode step;
3. counts one step on ``meta`` tensors at depths 1, 2 and 3 and carries
   every figure to the config's depth (``utils.cost``: per position flops,
   bytes, collective bytes by kind, each device's peak of live bytes);
4. writes a record: ``memory`` per device (arguments and outputs exactly
   from the layouts, parameters and moments aliased where the step updates
   them in place; temporaries the counted peak's rise over them),
   ``cost`` per chip (the busiest position's), ``roofline`` at the H100's
   constants (``utils.roofline``), ``model_flops`` and
   ``useful_flops_ratio``, and ``reckon_s``. A cell ``cell_supported``
   refuses is a ``skip`` with its reason.

The GLIN cell (``--arch glin``, shape ``query``: 4,096 windows at a budget
of 512 over 2^28 records on ``single``, 2^29 on ``multi``) is reckoned by
the reference's analytic model, ``kernels.refine.sharded_refine_cost``:
the port's sharded query step runs position by position with probes that
depend on the data (design P4), which no meta run can follow. Its memory
is the placed inputs' bytes a position (``core.distributed.
glin_input_specs``), the gathered survivor blocks and the hits.

The dry run computes nothing on a device and allocates nothing: it is the
one entry point of the port that needs no card.

Usage::

  PYTHONPATH=src python -m repro_torch.launch.dryrun               # every cell
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite_3_2b \\
      --shape train_4k --mesh single                                 # one cell
  ... --resume     # skip cells whose record exists

Records go to ``build/dryrun/<arch>__<shape>__<mesh>.json`` (``--out``
another directory); the exit code is 1 where any cell failed.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import pathlib
import time
import traceback
from typing import Optional, Sequence

import numpy as np
import torch

from ..configs.base import (ARCH_IDS, SHAPES, ShapeConfig, cell_supported,
                            get_arch, get_shape)
from ..core.distributed import glin_input_specs, shard_count
from ..kernels.refine import sharded_refine_cost
from ..models import moe
from ..models import transformer as tf
from ..sharding import MeshRules
from ..sharding.placement import Sharded, block_slices, normalize_spec
from ..train import step as tstep
from ..utils import cost, roofline
from ..utils.tree import leaves
from .mesh import make_production_mesh

__all__ = ["ART_DIR", "GLIN_QUERIES", "GLIN_BUDGET", "train_microbatches",
           "reckon", "reckon_glin", "run_cell", "main"]

ART_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "dryrun"
GLIN_QUERIES = 4096
GLIN_BUDGET = 512
GLIN_MAX_VERTS = 12           # glin_input_specs' default ring width
MEMORY_KEYS = ("argument_size_in_bytes", "output_size_in_bytes",
               "temp_size_in_bytes", "alias_size_in_bytes")


# ------------------------------------------------------- meta placement
def meta_mesh(mesh):
    """``mesh``'s axes and sizes, every position on the ``meta`` device."""
    return dataclasses.replace(
        mesh, flat=(torch.device("meta"),) * len(mesh.flat))


def meta_place(shape_dtype, sharding, devices: Sequence[int],
               counter: Optional[cost.Counter] = None) -> Sharded:
    """A placed value of ``shape_dtype`` ((shape, dtype)) laid out by
    ``sharding`` (a NamedSharding on a :func:`meta_mesh`), its blocks empty
    meta tensors: one per distinct block shape where each position is its
    own device (``devices`` all distinct: the blocks are interchangeable,
    ``cost.Counter.interchangeable``), else one per distinct (device,
    block), as ``placement.place``. Held where it lies when ``counter`` is
    given."""
    shape, dtype = shape_dtype
    mesh = sharding.mesh
    spec = normalize_spec(sharding.spec, len(shape))
    own = len(set(devices)) == len(devices)
    made, where, blocks = {}, {}, []
    for p in range(len(mesh.flat)):
        sl = block_slices(mesh, spec, shape, p)
        size = tuple(s.stop - s.start for s in sl)
        key = size if own else (devices[p], tuple((s.start, s.stop)
                                                  for s in sl))
        if key not in made:
            made[key] = torch.empty(size, dtype=dtype, device="meta")
        where[key] = where.get(key, 0) | (1 << p)
        blocks.append(made[key])
    if counter is not None:
        for key, t in made.items():
            counter.hold(t, where[key])
    return Sharded(shape, spec, mesh, blocks)


def meta_tree(shapes, shardings, devices, counter=None):
    """:func:`meta_place` over parallel trees of (shape, dtype) pairs and
    NamedShardings."""
    if isinstance(shapes, dict):
        return {k: meta_tree(v, shardings[k], devices, counter)
                for k, v in shapes.items()}
    return meta_place(shapes, shardings, devices, counter)


def layout_bytes(shapes, shardings, devices: Sequence[int]) -> np.ndarray:
    """Each device's bytes of a tree of (shape, dtype) pairs laid out by
    the parallel tree of NamedShardings: one tensor per distinct (device,
    block), as ``placement.place`` shares them."""
    out = np.zeros(max(devices) + 1)
    for (shape, dtype), sh in zip(leaves(shapes), leaves(shardings)):
        spec = normalize_spec(sh.spec, len(shape))
        item = torch.empty((), dtype=dtype).element_size()
        seen = set()
        for p in range(len(devices)):
            sl = block_slices(sh.mesh, spec, shape, p)
            key = (devices[p], tuple((s.start, s.stop) for s in sl))
            if key not in seen:
                seen.add(key)
                out[devices[p]] += item * int(np.prod(
                    [s.stop - s.start for s in sl]))
    return out


def train_microbatches(shape: ShapeConfig, rules: MeshRules,
                       microbatches: int) -> int:
    """The reference's rule: at most ``microbatches``, and each microbatch
    still covers every data position (else activations would replicate)."""
    dp = len(rules.mesh.flat) // rules.mesh.shape["model"]
    return min(microbatches, max(1, shape.global_batch // dp))


def _build(cfg, shape: ShapeConfig, rules: MeshRules, mbs: int):
    """(step, [(shapes, shardings) of its inputs], [(shapes, shardings) of
    its outputs], [(shapes, shardings) of the outputs that alias inputs])."""
    if shape.kind == "train":
        step, in_sh, out_sh, (p, o, b) = tstep.build_train_step(
            cfg, shape, rules, microbatches=mbs)
        scalars = {k: ((), torch.float32) for k in out_sh[2]}
        ins = [(p, in_sh[0]), (o, in_sh[1]), (b, in_sh[2])]
        return (step, ins, ins[:2] + [(scalars, out_sh[2])], ins[:2])
    logits = ((shape.global_batch, cfg.vocab), torch.float32)
    if shape.kind == "prefill":
        step, in_sh, out_sh, (p, b) = tstep.build_prefill_step(cfg, shape,
                                                                rules)
        cache = tf.cache_shapes(cfg, shape.global_batch, shape.seq_len)
        return (step, [(p, in_sh[0]), (b, in_sh[1])],
                [(logits, out_sh[0]), (cache, out_sh[1])], [])
    step, in_sh, out_sh, (p, c, b) = tstep.build_decode_step(cfg, shape,
                                                             rules)
    ins = [(p, in_sh[0]), (c, in_sh[1]), (b, in_sh[2])]
    return step, ins, [(logits, out_sh[0]), ins[1]], [ins[1]]


def _count(cfg, shape, mesh, devices, mbs: int, seq_shard: bool):
    """The :class:`~..utils.cost.Cost` of one step of ``cfg`` on a meta
    copy of ``mesh``."""
    rules = MeshRules(meta_mesh(mesh), seq_sharding=seq_shard)
    step, ins, _, _ = _build(cfg, shape, rules, mbs)

    def run():
        step(*[meta_tree(s, sh, devices, cost.active())
               for s, sh in ins])
    return cost.count(run, positions=len(mesh.flat), devices=devices,
                      pause=moe.stats.paused)[1]


def _bytes(pairs, devices) -> np.ndarray:
    total = np.zeros(max(devices) + 1)
    for shapes, shardings in pairs:
        total += layout_bytes(shapes, shardings, devices)
    return total


def _memory(args, outs, alias, peak) -> dict:
    """The reference's memory keys at the device whose total is largest,
    from per-device arrays: temporaries are the peak's rise over the
    arguments and the outputs that alias none."""
    temp = np.maximum(0.0, peak - args - (outs - alias))
    total = args + temp + outs - alias
    d = int(np.argmax(total))
    vals = (args[d], outs[d], temp[d], alias[d])
    out = {k: int(round(v)) for k, v in zip(MEMORY_KEYS, vals)}
    out["total_bytes_per_device"] = int(round(total[d]))
    out["device"] = d
    return out


def reckon(cfg, shape: ShapeConfig, mesh, microbatches: int = 16,
           seq_shard: bool = False,
           devices: Optional[Sequence[int]] = None) -> dict:
    """One step of ``cfg`` at ``shape`` on ``mesh`` (its layout; nothing
    runs on its devices), counted at depths 1 to 3 and carried to
    ``cfg.n_layers``: {``memory``, ``cost``, ``roofline``,
    ``model_flops``, ``useful_flops_ratio``, ``microbatches``,
    ``layers_counted``}. ``devices[p]`` is position ``p``'s device
    (default: each its own, as on the production meshes; all 0 for a mesh
    of one card). A train step takes :func:`train_microbatches`."""
    n = len(mesh.flat)
    devices = list(range(n)) if devices is None else list(devices)
    rules = MeshRules(meta_mesh(mesh), seq_sharding=seq_shard)
    mbs = (train_microbatches(shape, rules, microbatches)
           if shape.kind == "train" else 1)
    depths = tuple(range(1, min(cfg.n_layers, 3) + 1))
    counts = [_count(dataclasses.replace(cfg, n_layers=d), shape, mesh,
                     devices, mbs, seq_shard) for d in depths]
    full = cost.extrapolate(counts, depths, cfg.n_layers)
    _, ins, outs, alias = _build(cfg, shape, rules, mbs)
    mem = _memory(_bytes(ins, devices), _bytes(outs, devices),
                  _bytes(alias, devices), full.peak)
    fig = full.per_chip()
    mf = roofline.model_flops(cfg, shape)
    return {"memory": mem,
            "cost": {"flops_per_chip": fig["flops"],
                     "bytes_per_chip": fig["bytes"],
                     "collectives_per_chip": fig["collectives"],
                     "collective_total_per_chip": fig["collective_total"]},
            "roofline": roofline.roofline_terms(
                fig["flops"], fig["bytes"], fig["collective_total"], chips=1),
            "model_flops": mf,
            "useful_flops_ratio": (mf / (fig["flops"] * n) if fig["flops"]
                                   else None),
            "microbatches": mbs, "layers_counted": list(depths)}


def reckon_glin(mesh, num_records: int, num_queries: int = GLIN_QUERIES,
                budget: int = GLIN_BUDGET) -> dict:
    """The GLIN cell: ``sharded_refine_cost`` per chip (its record shards
    the data (and pod) extent, its gather width the widest pow2 bucket of
    :data:`GLIN_MAX_VERTS`-vertex rings), and the memory a position holds:
    the replicated model tables, its model column's windows and its
    shard's records (arguments), the gathered ``(Q, shards, budget + 1)``
    survivor blocks (temporaries) and its ``(Q / model, budget)`` hits and
    counts (outputs)."""
    shards = shard_count(mesh)
    m = mesh.shape["model"]
    verts = 1 << math.ceil(math.log2(GLIN_MAX_VERTS))
    snap, windows, table = glin_input_specs(num_records, num_queries, mesh,
                                            max_verts=GLIN_MAX_VERTS)

    def nbytes(shape, dtype, parts=1):
        return math.prod(shape) // parts * torch.empty(
            (), dtype=dtype).element_size()
    args = (sum(nbytes(*getattr(snap, f.name))
                for f in dataclasses.fields(snap)
                if isinstance(getattr(snap, f.name), tuple))
            + nbytes(*windows, m)
            + sum(nbytes(*v, shards) for v in table.values()))
    c = sharded_refine_cost(q=num_queries, n=num_records, budget=budget,
                            shards=shards, verts=verts)
    q_local = num_queries // m
    outs = q_local * (budget + 1) * 4
    temp = int(c["collective_bytes"])
    return {"memory": {"argument_size_in_bytes": args,
                       "output_size_in_bytes": outs,
                       "temp_size_in_bytes": temp,
                       "alias_size_in_bytes": 0,
                       "total_bytes_per_device": args + temp + outs},
            "cost": {"flops_per_chip": c["flops"],
                     "bytes_per_chip": c["bytes_accessed"],
                     "collectives_per_chip": {
                         "all-gather": c["collective_bytes"]},
                     "collective_total_per_chip": c["collective_bytes"]},
            "roofline": roofline.roofline_terms(
                c["flops"], c["bytes_accessed"], c["collective_bytes"],
                chips=1),
            "method": "kernels.refine.sharded_refine_cost"}


def run_cell(arch_id: str, shape_name: str, mesh_kind: str,
             microbatches: int = 16, seq_shard: bool = False,
             ssd_chunk: int = 0) -> dict:
    """One cell of the grid on the production mesh ``mesh_kind``
    (``"single"`` or ``"multi"``): its record (see the module
    docstring)."""
    multi = mesh_kind == "multi"
    n = 512 if multi else 256
    mesh = make_production_mesh(multi_pod=multi, devices=["cpu"] * n)
    rec = {"arch": arch_id, "shape": shape_name, "mesh": mesh_kind,
           "chips": n, "status": "ok"}
    t0 = time.perf_counter()
    if arch_id == "glin":
        rec["tokens"] = GLIN_QUERIES
        rec.update(reckon_glin(mesh, (1 << 29) if multi else (1 << 28)))
    else:
        cfg = get_arch(arch_id)
        if ssd_chunk:
            cfg = dataclasses.replace(cfg, ssd_chunk=ssd_chunk)
        shape = get_shape(shape_name)
        ok, why = cell_supported(cfg, shape)
        if not ok:
            rec.update(status="skip", reason=why)
            return rec
        rec.update(reckon(cfg, shape, mesh, microbatches, seq_shard))
    rec["reckon_s"] = round(time.perf_counter() - t0, 3)
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default=None, choices=[None, "single", "multi"])
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--microbatches", type=int, default=16)
    ap.add_argument("--seq-shard", action="store_true")
    ap.add_argument("--ssd-chunk", type=int, default=0)
    ap.add_argument("--out", default=str(ART_DIR),
                    help="directory of the records (default build/dryrun)")
    args = ap.parse_args(argv)

    out = pathlib.Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    archs = [args.arch] if args.arch else ARCH_IDS + ["glin"]
    meshes = [args.mesh] if args.mesh else ["single", "multi"]
    failures = 0
    for arch_id in archs:
        shapes = ([args.shape] if args.shape
                  else (["query"] if arch_id == "glin" else list(SHAPES)))
        for shape_name in shapes:
            for mesh_kind in meshes:
                name = f"{arch_id}__{shape_name}__{mesh_kind}"
                path = out / f"{name}.json"
                if args.resume and path.exists():
                    print(f"[skip existing] {name}")
                    continue
                print(f"[dryrun] {name} ...", flush=True)
                try:
                    rec = run_cell(arch_id, shape_name, mesh_kind,
                                   microbatches=args.microbatches,
                                   seq_shard=args.seq_shard,
                                   ssd_chunk=args.ssd_chunk)
                except Exception as e:
                    rec = {"arch": arch_id, "shape": shape_name,
                           "mesh": mesh_kind, "status": "fail",
                           "error": f"{type(e).__name__}: {e}",
                           "traceback": traceback.format_exc()[-4000:]}
                    failures += 1
                path.write_text(json.dumps(rec, indent=1))
                status = rec["status"]
                extra = ""
                if status == "ok":
                    r = rec["roofline"]
                    gib = rec["memory"]["total_bytes_per_device"] / 2**30
                    extra = (f" reckon={rec['reckon_s']}s"
                             f" dominant={r['dominant']}"
                             f" mem/dev={gib:.2f}GiB")
                print(f"[{status}] {name}{extra}", flush=True)
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
