"""The plain reference against brute force, and the frozen store recipes
against the port's generator."""
import numpy as np
import pytest

from bench.harness import spec
from bench.harness.stores import make_store
from bench.harness.traffic import query_windows
from bench.reference import geometry as geo
from bench.reference import search

CONFIGS = {"glin-unif-2m": "uniform"}


def _store(config, n=2000, seed=11):
    return make_store(spec.config(config)["store"], n, seed)


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_store_is_the_ports_recipe(config):
    from repro_torch.core.datasets import generate

    st = _store(config, 2000, 7)
    gs = generate(CONFIGS[config], 2000, seed=7)
    assert np.array_equal(st.nv, gs.nverts)
    assert np.array_equal(st.kind, gs.kinds)
    assert np.array_equal(st.off, gs.offsets)
    assert np.array_equal(st.pool, gs.pool.astype(np.float32)
                          .astype(np.float64))


@pytest.mark.parametrize("relation", ["intersects", "contains",
                                      "dwithin:0.003"])
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_window_answers_match_brute_force(config, relation):
    """Every record tested, by the port's own float64 host predicates (an
    implementation independent of the reference's)."""
    from repro_torch.core.relations import get_relation

    st = _store(config)
    wins = query_windows(st, 3e-3, 12, 5)
    got = search.window_answers(search.Grid(st), wins, [relation] * 12)
    rel = get_relation(relation)
    width = int(st.nv.max())
    verts = st.padded(np.arange(len(st)), width)
    for w, ids in zip(wins, got):
        want = np.nonzero(rel.predicate(w, verts, st.nv, st.kind))[0]
        assert np.array_equal(ids, want)


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_knn_answers_match_brute_force(config):
    from repro_torch.core.geometry import rect_geom_sqdist

    st = _store(config)
    pts = query_windows(st, 3e-3, 8, 3)[:, :2]
    k = 10
    ids, d = search.knn_answers(search.Grid(st), pts, k)
    verts = st.padded(np.arange(len(st)), int(st.nv.max()))
    for p, i, dd in zip(pts, ids, d):
        rect = np.concatenate([p, p])
        all_d = np.sqrt(rect_geom_sqdist(rect, verts, st.nv, st.kind))
        order = np.lexsort((np.arange(len(st)), all_d))[:k]
        assert np.array_equal(i, order)
        np.testing.assert_allclose(dd, all_d[order], rtol=0, atol=1e-15)


def test_pair_predicates_agree_with_the_ports_per_window():
    """Windows per row against the port's one-window predicates."""
    from repro_torch.core.geometry import rect_geom_sqdist

    st = _store("glin-unif-2m")
    wins = query_windows(st, 5e-3, 3, 9)
    recs = np.arange(len(st))
    verts = st.padded(recs, int(st.nv.max()))
    for w in wins:
        rect = np.repeat(w[None], len(st), 0)
        got = geo.over_pairs(geo.sqdist, st, rect, recs)
        want = rect_geom_sqdist(w, verts, st.nv, st.kind)
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
