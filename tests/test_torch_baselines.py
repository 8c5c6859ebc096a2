"""The paper's baselines in the port (``repro_torch.core.baselines``) against
the reference's (``repro.core.baselines``): ``RTree``, ``QuadTree`` and
``SortedArray`` on the stores of ``tests/test_system.py`` (``roads`` 8,000,
``uniform`` 30,000).

Both packages build from the same generated store, so every answer must be
the reference's exactly: the ids of each relation, the ``QueryStats`` each
query fills, ``stats()`` (the storage model the paper's comparison reads)
and, after the same deletes and inserts, the same ids and stats again.
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")   # the reference needs jax

import repro.core.baselines as rbase  # noqa: E402
import repro.core.datasets as rdata  # noqa: E402
import repro.core.index as rindex  # noqa: E402
import repro_torch.core.baselines as tbase  # noqa: E402
import repro_torch.core.datasets as tdata  # noqa: E402
import repro_torch.core.index as tindex  # noqa: E402

CLASSES = ("RTree", "QuadTree", "SortedArray")
RELATIONS = ("contains", "intersects", "within", "covers", "touches",
             "crosses", "dwithin:0.005")
COMPLEMENTS = ("disjoint",)


def _stores(family, n, seed):
    rgs = rdata.generate(family, n, seed=seed)
    tgs = tdata.generate(family, n, seed=seed)
    for k in ("pool", "offsets", "nverts", "kinds", "mbrs"):
        np.testing.assert_array_equal(getattr(tgs, k), getattr(rgs, k))
    return rgs, tgs


def _build(mod, name, gs):
    cls = getattr(mod, name)
    return cls.build(gs, 400) if name == "SortedArray" else cls.build(gs)


@pytest.fixture(scope="module")
def roads():
    rgs, tgs = _stores("roads", 8000, seed=4)
    wins = rdata.make_query_windows(rgs, 0.005, 4, seed=5)
    # windows flush against record MBR edges, so touches has hits
    m = rgs.mbrs[[11, 222, 3333]]
    edge = np.stack([m[:, 0] - 1e-3, m[:, 1], m[:, 0], m[:, 3]], 1)
    return rgs, tgs, np.concatenate([wins, edge])


def _query(index, w, rel, stats_cls):
    st = stats_cls()
    ids = index.query(w, rel, stats=st)
    return ids, dataclasses.asdict(st)


@pytest.mark.parametrize("name", CLASSES)
def test_baseline_matches_reference(roads, name):
    """Ids and ``QueryStats`` for every non-complement relation, and the
    ``stats()`` dict, equal the reference's."""
    rgs, tgs, wins = roads
    r, t = _build(rbase, name, rgs), _build(tbase, name, tgs)
    assert t.stats() == r.stats()
    hits = 0
    for w in wins:
        for rel in RELATIONS:
            rid, rst = _query(r, w, rel, rindex.QueryStats)
            tid, tst = _query(t, w, rel, tindex.QueryStats)
            np.testing.assert_array_equal(tid, rid, err_msg=f"{name} {rel}")
            assert tid.dtype == np.int64
            assert tst == rst, (name, rel)
            hits += len(tid)
    assert hits > 0


@pytest.mark.parametrize("name", CLASSES)
def test_baseline_answers_equal_bruteforce(roads, name):
    """The test_system.py oracle: the host GLIN's brute force."""
    _, tgs, wins = roads
    g = tindex.GLIN.build(tgs, tindex.GLINConfig(piece_limitation=400))
    t = _build(tbase, name, tgs)
    for w in wins[:4]:
        for rel in ("contains", "intersects"):
            np.testing.assert_array_equal(np.sort(t.query(w, rel)),
                                          np.sort(g.query_bruteforce(w, rel)))


@pytest.mark.parametrize("name", ("RTree", "QuadTree"))
def test_baseline_maintenance_matches_reference(roads, name):
    """The same deletes and inserts (a node split on the way: 200 records
    deleted and inserted again, then 64 more entries of one record's
    neighbourhood) leave the same ids and stats in both packages."""
    rgs, tgs, wins = roads
    r, t = _build(rbase, name, rgs), _build(tbase, name, tgs)
    rng = np.random.default_rng(6)
    gone = rng.choice(len(rgs), 200, replace=False)
    again = np.repeat(gone[:8], 8)
    for rec in gone:
        assert t.delete(int(rec)) == r.delete(int(rec)) is True
    assert t.delete(int(gone[0])) == r.delete(int(gone[0])) is False
    assert t.stats() == r.stats()
    for rec in np.concatenate([gone, again]):
        r.insert(int(rec))
        t.insert(int(rec))
    assert t.stats() == r.stats()
    if name == "RTree":
        assert t.stats()["leaf_nodes"] > 500        # inserts split leaves
    for w in wins:
        for rel in ("intersects", "contains"):
            rid, rst = _query(r, w, rel, rindex.QueryStats)
            tid, tst = _query(t, w, rel, tindex.QueryStats)
            np.testing.assert_array_equal(tid, rid)
            assert tst == rst


@pytest.mark.parametrize("name", CLASSES)
@pytest.mark.parametrize("relation", COMPLEMENTS)
def test_baseline_complement_raises(roads, name, relation):
    rgs, tgs, wins = roads
    for mod, gs in ((rbase, rgs), (tbase, tgs)):
        with pytest.raises(NotImplementedError, match="complement"):
            _build(mod, name, gs).query(wins[0], relation)


def test_storage_claim_vs_tree_indexes():
    """Fig 8's direction on test_system.py's store: the R-tree and the
    Quad-tree each take more than 5x GLIN's index bytes, and the three
    stats dicts equal the reference's."""
    rgs, tgs = _stores("uniform", 30000, seed=3)
    glin_b = tindex.GLIN.build(
        tgs, tindex.GLINConfig(piece_limitation=10000)).stats()[
            "total_index_bytes"]
    for name in CLASSES:
        st = _build(tbase, name, tgs).stats()
        assert st == _build(rbase, name, rgs).stats()
        if name != "SortedArray":
            assert st["index_bytes"] > 5 * glin_b, name
