"""What a traced run (``--trace 1``) adds around the program, for a stretch
of batches after the measured window.

* :class:`KernelTimer` replaces the kernel wrappers at their module
  attributes (``kernels.refine.refine_fused``, ``refine_compact``,
  ``kernels.knn.knn_topk``) with timed ones: a pair of CUDA events around
  each call, filed under the batch that made it. The program counts its
  launches in ``<wrapper>.launches`` through the module attribute, so it
  counts them on the timed wrapper, beside the events.
* :class:`Spans` puts ``torch.profiler.record_function`` ranges named
  ``bench.*`` around the calls into each layer (the facade's query, the
  refine and kNN stages, the device functions and the kernels), patched at
  their module or class attributes, so the profiler's trace says what the
  host was doing in each idle gap of the device.
* :func:`profile_summary` reads a ``torch.profiler`` trace: the union of
  the device's operations (busy), the top operations by device time and
  the longest idle gaps by the innermost ``bench.*`` span around them.

Everything is put back by ``uninstall``.
"""
from __future__ import annotations

import collections
import functools
import importlib

KERNELS = {"refine_fused": ("repro_torch.kernels.refine", ("fused_kernel",)),
           "refine_compact": ("repro_torch.kernels.refine",
                              ("compact_kernel",)),
           "knn_topk": ("repro_torch.kernels.knn",
                        ("knn_warp_kernel", "knn_topk_kernel"))}


NAME_CHARS = 120     # a device operation's name, cut for the breakdown


class KernelTimer:
    """Timed kernel wrappers; on the CPU (``on_card=False``) they only file
    each call under its batch."""

    def __init__(self, on_card: bool = True):
        self.on_card = on_card
        self.batch = -1
        self.events = collections.defaultdict(list)   # name -> [(b, e0, e1)]
        self._saved = []
        self.wrappers = {}

    def install(self):
        import torch

        for name, (mod_name, _) in KERNELS.items():
            mod = importlib.import_module(mod_name)
            real = getattr(mod, name)

            def timed(*a, _real=real, _name=name, **kw):
                if not self.on_card:
                    self.events[_name].append((self.batch, None, None))
                    return _real(*a, **kw)
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                with torch.profiler.record_function("bench.kernel." + _name):
                    out = _real(*a, **kw)
                e1.record()
                self.events[_name].append((self.batch, e0, e1))
                return out

            timed = functools.wraps(real)(timed)
            timed.launches = 0
            self._saved.append((mod, name, real))
            self.wrappers[name] = timed
            setattr(mod, name, timed)
        return self

    def uninstall(self):
        for mod, name, real in reversed(self._saved):
            setattr(mod, name, real)
        self._saved.clear()

    def per_batch_ms(self, name: str) -> dict:
        """{batch: summed event ms} of ``name``'s calls (synchronizes)."""
        import torch

        if not self.on_card:
            return {}
        torch.cuda.synchronize()
        out = collections.defaultdict(float)
        for b, e0, e1 in self.events.get(name, ()):
            if b >= 0:
                out[b] += e0.elapsed_time(e1)
        return dict(out)

    def calls(self, name: str, batches=None) -> int:
        return sum(1 for b, _, _ in self.events.get(name, ())
                   if (b >= 0 if batches is None else b in batches))


class Spans:
    """``bench.*`` ranges around the layers' entry points."""

    TARGETS = (("repro_torch.core.engine", "SpatialIndex", "query"),
               ("repro_torch.core.exec", "FusedDeviceStage", "run"),
               ("repro_torch.core.exec", "DeviceRefineStage", "run"),
               ("repro_torch.core.exec", "KnnDeviceStage", "run"),
               ("repro_torch.core.engine", None, "batch_query_fused"),
               ("repro_torch.core.engine", None, "batch_query"),
               ("repro_torch.core.exec", None, "batch_knn_rank"))

    def __init__(self):
        self._saved = []

    def install(self):
        import torch

        for mod_name, cls_name, attr in self.TARGETS:
            mod = importlib.import_module(mod_name)
            owner = getattr(mod, cls_name) if cls_name else mod
            real = getattr(owner, attr)
            label = "bench." + (f"{cls_name}.{attr}" if cls_name else attr)

            def spanned(*a, _real=real, _label=label, **kw):
                with torch.profiler.record_function(_label):
                    return _real(*a, **kw)

            self._saved.append((owner, attr, real))
            setattr(owner, attr, functools.wraps(real)(spanned))
        return self

    def uninstall(self):
        for owner, attr, real in reversed(self._saved):
            setattr(owner, attr, real)
        self._saved.clear()


def start_profiler():
    import torch

    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])
    prof.__enter__()
    return prof


def warm_profiler() -> None:
    """One short trace, so that a later start is quick."""
    import torch

    prof = start_profiler()
    torch.ones(8, device="cuda").add_(1)
    torch.cuda.synchronize()
    prof.__exit__(None, None, None)


def _merge(iv):
    out = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def profile_summary(prof) -> dict:
    """Busy seconds, device operations and idle gaps of a profiler trace,
    and the launches it recorded of each timed kernel."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    dev, spans = [], []
    for e in prof.events():
        tr = e.time_range
        if e.name.startswith("bench."):
            # the profiler mirrors each range onto the device's timeline
            # too; those copies are no device work
            if e.device_type != cuda:
                spans.append((tr.start, tr.end, e.name))
        elif e.device_type == cuda and tr.end > tr.start:
            dev.append((tr.start, tr.end, e.name))
    merged = _merge([(a, b) for a, b, _ in dev])
    busy_us = sum(b - a for a, b in merged)
    ops = collections.Counter()
    for a, b, name in dev:
        ops[name[:NAME_CHARS]] += (b - a) * 1e-6
    spans.sort()
    gaps = collections.Counter()
    for (_, g0), (g1, _) in zip(merged, merged[1:]):
        inner = "between queries"
        for a, b, name in spans:
            if a > g0:
                break
            if b >= g0:
                inner = name            # the latest-starting span around g0
        gaps[inner] += (g1 - g0) * 1e-6
    seen = {k: sum(1 for _, _, n in dev if any(s in n for s in subs))
            for k, (_, subs) in KERNELS.items()}
    return {"busy_s": busy_us * 1e-6, "device_ops": ops.most_common(10),
            "idle_gaps": gaps.most_common(10), "kernels_seen": seen,
            "device_events": len(dev)}
