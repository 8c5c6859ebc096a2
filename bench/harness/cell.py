"""One run of one cell: set-up, warm-up, the measured window, the per-layer
readings of a traced run, and the check against the plain reference.

The program under test is ``repro_torch``'s ``SpatialIndex``: the store and
the queries are made here from the seed, wrapped in the port's
``GeometrySet``, and every batch goes through ``SpatialIndex.query`` in a
closed loop of one client, called by the mix's driver
(``bench/drivers/<kind>.py``). A batch counts when its ids are on the host.
"""
from __future__ import annotations

import dataclasses
import gc
import sys
import time
from types import SimpleNamespace
from typing import Optional

import numpy as np

from ..reference import search
from ..reference.precision import store_bf16, to_bf16
from . import roofline, spec, stores, trace
from .traffic import Batches, Traffic

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def log(*a) -> None:
    print("bench:", *a, file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is the JAX package's or JAX's."""
    return sorted({m for m in list(sys.modules)
                   if m.partition(".")[0] in FORBIDDEN})


@dataclasses.dataclass
class Inputs:
    store: stores.Store
    traffic: Traffic
    pool: dict                   # the driver's queries, arrays by name


def make_inputs(cell: dict, seed: int, records: Optional[int] = None,
                traffic_over: Optional[dict] = None,
                marks: Optional[dict] = None) -> Inputs:
    marks = {} if marks is None else marks
    cfg = spec.config(cell["config"])
    tr = spec.traffic(cell["traffic"])
    tr.update(traffic_over or {})
    t = Traffic.from_json(tr)
    t0 = time.perf_counter()
    st = stores.make_store(cfg["store"], records or int(cfg["records"]),
                           seed)
    t1 = time.perf_counter()
    pool = t.driver.pool(st, t, seed)
    marks["store_s"] = t1 - t0
    marks["pool_s"] = time.perf_counter() - t1
    return Inputs(st, t, pool)


def _index(inp: Inputs, device: str):
    """The program's index over a copy of the benchmark's store."""
    from repro_torch.core.datasets import GeometrySet
    from repro_torch.core.engine import EngineConfig, SpatialIndex
    from repro_torch.core.zorder import UNIT

    st = inp.store
    gs = GeometrySet(nverts=st.nv.copy(), kinds=st.kind.copy(),
                     mbrs=st.mbr.copy(), grid=UNIT, pool=st.pool.copy(),
                     offsets=st.off.copy())
    # on a card the engine's defaults (the CUDA kernels); a CPU rehearsal
    # takes the same kernel wrappers, which run their plain versions there
    cfg = (EngineConfig() if device == "cuda" else
           EngineConfig(fusion="kernel", compaction="kernel",
                        knn_topk="kernel"))
    return SpatialIndex.build(gs, config=cfg, device=device)


def _sync(device: str) -> None:
    if device == "cuda":
        import torch

        torch.cuda.synchronize()


def _held_bytes(objs) -> int:
    """Bytes of the distinct device storages reachable from ``objs``
    through dataclass instances (their fields and cached tables), tuples,
    lists and dicts."""
    import torch

    seen = {}

    def walk(o, depth):
        if isinstance(o, torch.Tensor):
            if o.device.type == "cuda":
                s = o.untyped_storage()
                seen[s.data_ptr()] = s.nbytes()
        elif depth < 6:
            if dataclasses.is_dataclass(o) and not isinstance(o, type):
                for v in vars(o).values():
                    walk(v, depth + 1)
            elif isinstance(o, (tuple, list)):
                for v in o:
                    walk(v, depth + 1)
            elif isinstance(o, dict):
                for v in o.values():
                    walk(v, depth + 1)

    for o in objs:
        walk(o, 0)
    return sum(seen.values())


def _published(idx):
    """The published snapshot and the vertex pods the index holds, found by
    type among its attributes."""
    from repro_torch.core.device import VertexPods

    pods = [v for v in vars(idx).values() if isinstance(v, VertexPods)]
    return idx.snapshot(), pods


def run(workload: str, seed: int, seconds: float, traced: bool, *,
        device: str = "cuda", t_start: Optional[float] = None,
        records: Optional[int] = None, traffic_over: Optional[dict] = None,
        bench_spec: Optional[dict] = None) -> dict:
    """One run of cell ``workload``; returns the result line's object.

    ``device="cpu"`` is the CPU rehearsal of the tests: the same path with
    the kernels' plain versions, reporting no device metric."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    bspec = bench_spec or spec.load()
    cell = spec.workload(bspec, workload)
    on_card = device == "cuda"
    if on_card:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.cuda.reset_peak_memory_stats()

    # ------------------------------------------------------------ set-up
    marks = {}
    marks["imports_s"] = time.perf_counter() - t_start
    inp = make_inputs(cell, seed, records, traffic_over, marks)
    tr = inp.traffic
    t = time.perf_counter()
    idx = _index(inp, device)
    marks["build_s"] = time.perf_counter() - t
    t = time.perf_counter()
    idx.snapshot()
    _sync(device)
    marks["publish_s"] = time.perf_counter() - t
    drv = tr.driver
    t = time.perf_counter()
    warm = Batches(tr, seed + 1)           # its own draws: the timed batches
    for _ in range(drv.warm_batches(tr)):
        rows, rel = warm.next()
        drv.call(idx, inp.pool, tr, rows, rel)
    _sync(device)
    marks["warmup_s"] = time.perf_counter() - t
    setup_s = time.perf_counter() - t_start
    log("setup", {k: round(v, 3) for k, v in marks.items()},
        f"setup_s={setup_s:.3f}")

    # ------------------------------------------------------------ window
    batches = Batches(tr, seed)
    pick_rng = np.random.default_rng([seed, 3])
    per_batch, samples = [], []
    first_error = None
    res = None

    def step() -> None:
        """One batch through the program, its wall and the rows kept for
        the check."""
        nonlocal res, first_error
        rows, rel = batches.next()
        pick = pick_rng.choice(rows.shape[0], min(tr.check_rows,
                                                  rows.shape[0]),
                               replace=False)
        tb = time.perf_counter()
        try:
            res = drv.call(idx, inp.pool, tr, rows, rel)
        except Exception as e:          # the batch failed: counted, go on
            res = None
            first_error = first_error or repr(e)
        rec = {"wall_ms": (time.perf_counter() - tb) * 1e3, "relation": rel,
               "rows": rows, "stages": [], "hits": None,
               "ok": res is not None}
        if res is None:
            samples.extend((int(rows[j]), rel, None) for j in pick)
        else:
            rec["stages"] = [dataclasses.asdict(s) for s in res.stages or ()]
            rec["hits"] = res.total_hits
            samples.extend((int(rows[j]), rel, drv.keep(res, j))
                           for j in pick)
        per_batch.append(rec)

    t0 = time.perf_counter()
    deadline = t0 + seconds
    while time.perf_counter() < deadline:
        step()
    window_s = time.perf_counter() - t0
    timed = list(per_batch)

    # A traced run instruments a stretch of ``profile_batches`` more
    # batches once the window has closed: the kernel wrappers' events, the
    # spans and the profiler. The window itself runs as in an untraced run,
    # so the metrics of the program's own stage walls read it unchanged.
    # The profiler's first start sets up its tracing (seconds), and a
    # process that has traced once launches more slowly afterwards: both
    # stay out of the window.
    timer = summary = None
    stretch, stretch_s = [], 0.0
    if traced:
        timer = trace.KernelTimer(on_card).install()
        spans = trace.Spans().install()
        prof = None
        if on_card:
            trace.warm_profiler()
            prof = trace.start_profiler()
        t = time.perf_counter()
        for _ in range(tr.profile_batches):
            timer.batch = len(per_batch)
            stretch.append(len(per_batch))
            step()
        _sync(device)
        stretch_s = time.perf_counter() - t
        if prof is not None:
            prof.__exit__(None, None, None)
            summary = trace.profile_summary(prof)
            summary["window_s"] = stretch_s
            del prof
        spans.uninstall()
        timer.uninstall()
    if first_error:
        log("first failure:", first_error)
    lat = [b["wall_ms"] for b in timed]
    done = sum(b["rows"].shape[0] for b in per_batch if b["ok"])
    attempted = sum(b["rows"].shape[0] for b in per_batch)

    # ------------------------------------------------------ after the window
    memory_peak = torch.cuda.max_memory_allocated() if on_card else 0
    snap, pods = _published(idx)
    held = {"index": _held_bytes([snap]) if on_card else 0,
            "device": _held_bytes([snap, *pods]) if on_card else 0}
    del snap, pods, res
    kernel_ms, calls, launches = {}, {}, {}
    if timer is not None:
        for name in trace.KERNELS:
            kernel_ms[name] = timer.per_batch_ms(name)
            calls[name] = len(timer.events.get(name, ()))
            launches[name] = timer.wrappers[name].launches
    del idx
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    grid = search.Grid(inp.store)
    n = len(inp.store)
    metrics = {}
    result_device = {"platform": "gpu" if on_card else "cpu",
                     "kind": (torch.cuda.get_device_name() if on_card
                              else "cpu"),
                     "count": 1, "memory_peak_bytes": int(memory_peak)}
    breakdown = None
    if traced:
        if summary is not None:
            missing = {k: max(timer.calls(k, set(stretch))
                              - summary["kernels_seen"][k], 0)
                       for k in trace.KERNELS}
            summary["missing"] = missing
            result_device["busy_s"] = summary["busy_s"]
            result_device["window_s"] = summary["window_s"]
            breakdown = {"device_ops": [[k, v] for k, v in
                                        summary["device_ops"]],
                         "idle_gaps": [[k, v] for k, v in
                                       summary["idle_gaps"]]}
            log("profile", {k: summary[k] for k in
                            ("busy_s", "window_s", "device_events",
                             "kernels_seen", "missing")})
        recording = SimpleNamespace(
            kind=tr.kind, batches=per_batch, window=timed,
            kernel_ms=kernel_ms, kernel_calls=calls, launches=launches,
            profile=summary, stretch=stretch, held=held, records=n,
            kernel_calls_in=timer.calls, on_card=on_card, grid=grid,
            pool=inp.pool,
            peaks=(roofline.peaks(result_device["kind"]) if on_card
                   else None))
        for m in spec.per_layer(bspec, workload):
            v = spec.reader(m["name"])(recording)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        log("calls", calls, "launches", launches)
        log("batch wall ms, median: window "
            f"{_median(lat):.3f} over "
            f"{len(lat)}, instrumented stretch "
            f"{_median([per_batch[b]['wall_ms'] for b in stretch]):.3f} "
            f"over {len(stretch)}")
    elif on_card:
        answered = sum(b["rows"].shape[0] for b in timed if b["ok"])
        e2e = {"query_rate": answered / window_s if window_s > 0 else 0.0,
               "batch_p95_ms": float(np.percentile(lat, 95)) if lat else 0.0,
               "device_bytes_per_record": held["device"] / n,
               "setup_s": setup_s}
        for m in spec.end_to_end(bspec, workload):
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    log(f"window: {len(lat)} batches, {done} queries answered, "
        f"{attempted - done} failed (with the stretch's), {window_s:.3f} s; "
        "latency ms median "
        f"{_median(lat):.3f} p95 "
        f"{float(np.percentile(lat, 95)) if lat else 0:.3f}")

    # ------------------------------------------------------------- the check
    t = time.perf_counter()
    readings = judge(grid, inp, samples)
    log(f"check took {time.perf_counter() - t:.3f} s over "
        f"{len(samples)} sampled rows", readings)
    limits = tr.limits
    compared = {k: {"value": readings[k], "limit": limits[k]}
                for k in limits}
    correct = all(v["value"] <= v["limit"] for v in compared.values())
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(attempted - done), "metrics": metrics,
           "device": result_device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["check"] = compared
    return out


def _median(v) -> float:
    return float(np.median(v)) if len(v) else 0.0


def judge(grid, inp: Inputs, samples) -> dict:
    """Readings of the sampled rows ``(pool row, relation, answer)``
    against the reference."""
    tr = inp.traffic
    rows = np.asarray([r for r, _, _ in samples], np.int64)
    return tr.driver.judge(grid, inp.pool, tr, rows,
                           [rel for _, rel, _ in samples],
                           [a for _, _, a in samples])


def control(workload: str, seed: int, batches: int,
            bench_spec: Optional[dict] = None, records: Optional[int] = None,
            traffic_over: Optional[dict] = None) -> dict:
    """The control's readings: the reference in bfloat16 (store and queries
    rounded to it) put in the program's place for the sampled rows of
    ``batches`` batches, judged as a run's answers are."""
    bspec = bench_spec or spec.load()
    cell = spec.workload(bspec, workload)
    inp = make_inputs(cell, seed, records, traffic_over)
    tr = inp.traffic
    gen = Batches(tr, seed)
    pick_rng = np.random.default_rng([seed, 3])
    rows, rels = [], []
    for _ in range(batches):
        r, rel = gen.next()
        pick = pick_rng.choice(r.shape[0], min(tr.check_rows, r.shape[0]),
                               replace=False)
        rows.extend(int(r[j]) for j in pick)
        rels.extend([rel] * len(pick))
    rows = np.asarray(rows, np.int64)
    low = {k: to_bf16(v) for k, v in inp.pool.items()}
    answers = tr.driver.reference(search.Grid(store_bf16(inp.store)), low,
                                  tr, rows, rels)
    readings = judge(search.Grid(inp.store), inp,
                     list(zip(rows.tolist(), rels, answers)))
    return {"readings": readings,
            "correct": all(readings[k] <= v for k, v in tr.limits.items()),
            "limits": tr.limits}
