"""GPipe-style pipeline parallelism over a mesh axis (``pod`` by default):
the port's counterpart of the reference's ``sharding/pipeline.py``.

* stage parameters are stacked on a leading axis placed over the stage
  axis (each position holds its stage's slice);
* microbatches stream through the classic GPipe schedule (M + S − 1 ticks
  for M microbatches over S stages): stage 0 takes microbatch ``t`` while
  ``t < M``, every other stage what its predecessor sent;
* activations hop from stage i's device to stage i+1's by ``ppermute``;
* the last stage emits from tick S − 1 on (zeros elsewhere) and the
  outputs are summed over the stage axis, as the reference's ``psum``.

Pipelining adds only zeros and copies, so the outputs equal the stages run
in sequence. Bubble fraction = (S−1)/(M+S−1) (:func:`bubble_fraction`).
"""
from __future__ import annotations

from typing import Callable

import torch

from ..utils.tree import leaves, unflatten
from .placement import Sharded, place, ppermute, psum, smap
from .rules import PartitionSpec

__all__ = ["gpipe", "bubble_fraction"]


def bubble_fraction(num_stages: int, num_microbatches: int) -> float:
    return (num_stages - 1) / (num_microbatches + num_stages - 1)


def gpipe(stage_fn: Callable, mesh, stage_axis: str = "pod"):
    """Build a pipelined apply: ``f(stage_params, xs) -> ys``.

    ``stage_params``: a tensor or a nested dict of tensors (the port's
    parameter trees, :mod:`~..utils.tree`) with a leading stage axis, or
    of :class:`Sharded` values already placed over ``stage_axis`` on it; ``stage_fn(params_slice, x) -> y`` maps one
    microbatch through ONE stage; ``xs``: (M, ...) microbatches (a tensor,
    or a value replicated on the mesh). Returns the (M, ...) outputs
    replicated on the mesh (``placement.gather`` reads them)."""
    s = mesh.shape[stage_axis]

    def run(stage_params, xs):
        flat = [t if isinstance(t, Sharded)
                else place(t, mesh, (stage_axis,))
                for t in leaves(stage_params)]
        for t in flat:
            if tuple(t.spec.axes(0)) != (stage_axis,) or t.shape[0] != s:
                raise ValueError(f"a stage leaf {t} is not {s} stages "
                                 f"placed over {stage_axis!r}")
        local = [smap(lambda b: b[0], t) for t in flat]
        xs = xs if isinstance(xs, Sharded) else place(xs, mesh, ())
        m = xs.shape[0]
        state = smap(lambda x: torch.zeros_like(x[0]), xs)
        outs = []
        for t in range(m + s - 1):
            mb = min(t, m - 1)

            def tick(i, x_all, st, *ps):
                x_in = x_all[mb] if i == 0 and t < m else st
                return stage_fn(unflatten(stage_params, ps), x_in)
            y = smap(tick, xs, state, *local, coord=stage_axis)
            emit = t >= s - 1
            outs.append(smap(lambda i, b: b if i == s - 1 and emit
                             else torch.zeros_like(b), y, coord=stage_axis))
            if s > 1:
                state = ppermute(y, stage_axis,
                                 [(i, i + 1) for i in range(s - 1)])
        ys = smap(lambda *o: torch.stack(o), *outs[s - 1:])
        ys = psum(ys, stage_axis)                  # nonzero only at the last
        return Sharded((m,) + tuple(ys.blocks[0].shape[1:]), PartitionSpec(),
                       mesh, ys.blocks)

    return run
