"""A tiny CPU rehearsal of each cell through the harness, with the kernels'
plain versions: correct, and no device metric reported."""
import pytest

from bench.harness import cell
from bench.tests.helpers import CELLS, RECORDS, SMALL

COUNTS = {"escalations_per_batch", "knn_rungs"}   # counts, not device readings


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("workload", CELLS)
def test_cpu_rehearsal(workload, traced):
    out = cell.run(workload, 2**31 + 5, 0.3, traced, device="cpu",
                   records=RECORDS, traffic_over=SMALL)
    assert out["correct"] is True
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) <= COUNTS
    assert out["device"]["platform"] == "cpu"
    assert "busy_s" not in out["device"]
    assert list(out)[-1] == "check"
    assert all(v["value"] <= v["limit"] for v in out["check"].values())


@pytest.mark.parametrize("workload", CELLS)
def test_traced_run_puts_the_program_back(workload):
    """The instrumented stretch's wrappers and spans are gone afterwards."""
    from repro_torch.core import engine
    from repro_torch.core import exec as qexec
    from repro_torch.kernels import knn, refine

    def attrs():
        return (engine.SpatialIndex.query, engine.batch_query_fused,
                qexec.FusedDeviceStage.run, qexec.KnnDeviceStage.run,
                refine.refine_fused, refine.refine_compact, knn.knn_topk)

    before = attrs()
    out = cell.run(workload, 2**31 + 11, 0.3, True, device="cpu",
                   records=RECORDS, traffic_over=SMALL)
    assert out["correct"] is True
    assert all(a is b for a, b in zip(before, attrs()))


@pytest.mark.parametrize("metric, stage, field", [
    ("escalations_per_batch", "refine", "escalations"),
    ("knn_rungs", "knn-rank", "rungs")])
def test_stage_counts_skip_the_instrumented_stretch(metric, stage, field):
    from types import SimpleNamespace

    from bench.harness import spec

    def batch(v):
        return {"stages": [{"stage": stage, field: v, "wall_ms": 1.0}],
                "wall_ms": 2.0}

    window = [batch(1), batch(3)]
    rec = SimpleNamespace(window=window, batches=window + [batch(50)],
                          stretch=[2], on_card=False)
    assert spec.reader(metric)(rec) == 2
