"""The check fails the control (the reference in bfloat16 in the program's
place) and a run whose timed path is broken underneath: a batch that
returns the state it had (the previous batch's answers), half of each
batch left out, an answer altered where it is produced. The cells run on
one card, so there is no exchange between cards to leave out."""
import dataclasses

import numpy as np
import pytest

from bench.harness import cell
from bench.tests.helpers import CELLS, RECORDS, SMALL


@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(workload):
    out = cell.control(workload, 2**31 + 9, 12, records=20000,
                       traffic_over=SMALL)
    assert out["correct"] is False


def _run(workload):
    return cell.run(workload, 2**31 + 3, 0.3, False, device="cpu",
                    records=RECORDS, traffic_over=SMALL)


def _patch_query(monkeypatch, fn):
    from repro_torch.core import engine

    real = engine.SpatialIndex.query

    def broken(self, batch, *a, **kw):
        return fn(real(self, batch, *a, **kw))

    monkeypatch.setattr(engine.SpatialIndex, "query", broken)


@pytest.mark.parametrize("workload", CELLS)
def test_stale_state_is_caught(workload, monkeypatch):
    first = []

    def stale(res):
        first.append(res)
        return first[0]

    _patch_query(monkeypatch, stale)
    assert _run(workload)["correct"] is False


@pytest.mark.parametrize("workload", CELLS)
def test_half_the_batch_left_out_is_caught(workload, monkeypatch):
    def half(res):
        h = len(res.ids) // 2
        ids = res.ids[:h] + [np.empty(0, np.int64)] * (len(res.ids) - h)
        dist = (None if res.distances is None else res.distances[:h]
                + [np.empty(0)] * (len(res.ids) - h))
        return dataclasses.replace(res, ids=ids, distances=dist)

    _patch_query(monkeypatch, half)
    assert _run(workload)["correct"] is False


@pytest.mark.parametrize("workload", CELLS)
def test_altered_answer_is_caught(workload, monkeypatch):
    """One id of every row moved to the next record, in the kernel's output
    (the fused refine's hits; the kNN rank's top-k)."""
    from repro_torch.core import engine
    from repro_torch.core import exec as qexec

    real_fused = engine.batch_query_fused
    real_rank = qexec.batch_knn_rank

    def fused(*a, **kw):
        hits, counts = real_fused(*a, **kw)
        first = hits[:, :1]
        return _cat([first.where(first < 0, first + 1), hits[:, 1:]]), counts

    def rank(*a, **kw):
        idk, dk, within = real_rank(*a, **kw)
        first = idk[:, :1]
        return _cat([first.where(first < 0, first + 1), idk[:, 1:]]), dk, \
            within

    monkeypatch.setattr(engine, "batch_query_fused", fused)
    monkeypatch.setattr(qexec, "batch_knn_rank", rank)
    assert _run(workload)["correct"] is False


def _cat(parts):
    import torch

    return torch.cat(parts, dim=1)
