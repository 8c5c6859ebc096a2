"""The port's device snapshot and batched query path against the reference.

First the port's own host build and snapshot must give tables identical to
the reference's for the same ``generate()`` seed. Then both packages are fed
the SAME learned snapshot (the reference's tables, carried over as numpy by
``snapshot_from_numpy``) and must agree bit for bit on probe bounds, staged
``(hits, counts)`` and the fused reference composition — including odd Q and
N, zero-survivor and all-survivor rows, the ``-(n) - 1`` overflow encodings,
keys past the last leaf with a saturating model prediction, and the padded
(``pad_quantum``) snapshot. Where the reference reaches a Pallas kernel it is
held through its XLA reference (``compaction="scan"``, ``mode="reference"``).
"""
import dataclasses

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")   # the reference needs jax
# small tensors: one torch thread per xdist worker beats oversubscribing
# the cores the workers share
torch.set_num_threads(1)

from _oracle import mixed_store  # noqa: E402
from repro.core import device as rdev  # noqa: E402
from repro.core.engine import EngineConfig as REngineConfig  # noqa: E402
from repro.core.engine import SpatialIndex as RIndex  # noqa: E402
from repro.core.index import GLIN as RGLIN  # noqa: E402
from repro.core.index import GLINConfig as RGLINConfig  # noqa: E402
from repro.core.datasets import make_query_windows  # noqa: E402
from repro_torch.core import datasets as tdata  # noqa: E402
from repro_torch.core import device as tdev  # noqa: E402
from repro_torch.core import geometry as tgeom  # noqa: E402
from repro_torch.core.engine import EngineConfig as TEngineConfig  # noqa: E402
from repro_torch.core.engine import SpatialIndex as TIndex  # noqa: E402
from repro_torch.core.index import GLIN as TGLIN  # noqa: E402
from repro_torch.core.index import GLINConfig as TGLINConfig  # noqa: E402

RELATIONS = ("intersects", "contains", "covers", "within", "touches",
             "crosses", "dwithin:0.004")


def port_mixed_store(n, seed):
    """The port's copy of ``_oracle.mixed_store`` (fp32-exact pool)."""
    gs = tdata.generate("mixed", n, seed=seed)
    gs.verts = gs.verts.astype(np.float32).astype(np.float64)
    gs.mbrs = tgeom.mbrs_of_verts(gs.verts, gs.nverts)
    return gs


def snap_numpy(s):
    fields = {k: np.asarray(getattr(s, k)) for k in tdev.SNAPSHOT_FIELDS}
    meta = {k: getattr(s, k) for k in tdev.SNAPSHOT_META}
    return fields, meta


def pods_numpy(p):
    return {"pool": np.asarray(p.pool), "off": np.asarray(p.off),
            "nv": np.asarray(p.nv), "kd": np.asarray(p.kd),
            "bucket": np.asarray(p.bucket), "max_width": p.max_width}


@pytest.fixture(scope="module")
def world():
    """Odd N=347 mixed store in both packages; the reference's unpadded and
    padded snapshots; the port fed the reference's learned tables."""
    gs = mixed_store(347, seed=3)
    tgs = port_mixed_store(347, seed=3)
    g = RGLIN.build(gs, RGLINConfig(piece_limitation=200))
    tg = TGLIN.build(tgs, TGLINConfig(piece_limitation=200))
    r_un = RIndex(g, REngineConfig(pad_quantum=0)).snapshot()
    r_pad = RIndex(g, REngineConfig()).snapshot()
    rpods = rdev.pods_from_store(gs)
    fed = tdev.snapshot_from_numpy(*snap_numpy(r_un), device="cpu")
    fed_pad = tdev.snapshot_from_numpy(*snap_numpy(r_pad), device="cpu")
    tpods = tdev.pods_from_numpy(pods_numpy(rpods), device="cpu")
    lo = gs.mbrs[:, :2].min(axis=0) - 0.01
    hi = gs.mbrs[:, 2:].max(axis=0) + 0.01
    wins = np.concatenate([
        make_query_windows(gs, 0.004, 12, seed=4),
        [[hi[0] + 1, hi[1] + 1, hi[0] + 2, hi[1] + 2],    # zero survivors
         [lo[0], lo[1], hi[0], hi[1]],                    # all survivors
         [1.5, 1.5, 1.6, 1.6]],                           # past the domain
    ]).astype(np.float32)
    return dict(gs=gs, tgs=tgs, g=g, tg=tg, r_un=r_un, r_pad=r_pad,
                rpods=rpods, fed=fed, fed_pad=fed_pad, tpods=tpods,
                wins=wins)


def _eq(t, a):
    np.testing.assert_array_equal(t.cpu().numpy(), np.asarray(a))


# ---------------------------------------------------------------- tables --
@pytest.mark.parametrize("pad", [0, 4096])
def test_snapshot_tables_match_reference(world, pad):
    """The port's own host GLIN + snapshot (+ facade bucket padding) give
    the reference's tables for the same seed: slot, leaf, node, code and
    piece tables, trip counts and grid."""
    np.testing.assert_array_equal(world["tgs"].pool, world["gs"].pool)
    ref = world["r_un"] if pad == 0 else world["r_pad"]
    mine = TIndex(world["tg"], TEngineConfig(pad_quantum=pad),
                  device="cpu").snapshot()
    for k, dt in tdev.SNAPSHOT_FIELDS.items():
        t = getattr(mine, k)
        assert t.dtype == dt, k
        np.testing.assert_array_equal(t.numpy(), np.asarray(getattr(ref, k)),
                                      err_msg=k)
    for k in tdev.SNAPSHOT_META:
        assert getattr(mine, k) == getattr(ref, k), k


def test_pods_match_reference(world):
    mine = tdev.pods_from_store(world["tgs"], "cpu", pad_records_to=400,
                                pool_pad_to=5000, max_width=128)
    ref = rdev.pods_from_store(world["gs"], pad_records_to=400,
                               pool_pad_to=5000, max_width=128)
    for k in ("pool", "off", "nv", "kd", "bucket"):
        _eq(getattr(mine, k), getattr(ref, k))
    assert (mine.max_width, mine.num_buckets) == (ref.max_width,
                                                  ref.num_buckets)


# ---------------------------------------------------------------- probing --
@pytest.mark.parametrize("relation", RELATIONS)
def test_bounds_match_reference(world, relation):
    wins = world["wins"]
    for rs, ts in ((world["r_un"], world["fed"]),
                   (world["r_pad"], world["fed_pad"])):
        rs_, re_ = rdev.batch_query_bounds(rs, jnp.asarray(wins), relation)
        ts_, te_ = tdev.batch_query_bounds(ts, torch.from_numpy(wins),
                                           relation)
        _eq(ts_, rs_)
        _eq(te_, re_)
        assert ts_.dtype == torch.int32


@pytest.mark.parametrize("slope", [1e30, -1e30, float("nan")])
def test_saturating_prediction_past_last_leaf(world, slope):
    """A model prediction far outside int32 (or NaN) must saturate like the
    reference's cast before the clip to the leaf: a key past the last leaf
    then still lands in a window that brackets its lower bound."""
    fields, meta = snap_numpy(world["r_un"])
    fields = dict(fields)
    fields["leaf_slope"] = np.full_like(fields["leaf_slope"], slope)
    rs = dataclasses.replace(world["r_un"],
                             leaf_slope=jnp.asarray(fields["leaf_slope"]))
    ts = tdev.snapshot_from_numpy(fields, meta, device="cpu")
    wins = world["wins"]
    for rel in ("contains", "intersects"):
        a = rdev.batch_query_bounds(rs, jnp.asarray(wins), rel)
        b = tdev.batch_query_bounds(ts, torch.from_numpy(wins), rel)
        _eq(b[0], a[0])
        _eq(b[1], a[1])
    if slope > 0:
        # saturated high, the prediction clips to the last slot of the
        # leaf: the past-the-domain window probes past every stored key
        n = world["r_un"].keys_hi.shape[0]
        assert int(b[0][-1]) == int(b[1][-1]) == n


# ----------------------------------------------------------------- queries --
@pytest.mark.parametrize("relation,budget,cap", [
    ("intersects", 64, 1024), ("intersects", 0, 256)])
def test_batch_query_matches_reference(world, relation, budget, cap):
    """Staged scan compaction (budget > 0) and the dense single-stage path
    (budget 0): identical (hits, counts) layouts."""
    wins = world["wins"]
    mb = jnp.asarray(world["gs"].mbrs.astype(np.float32))
    rh, rc = rdev.batch_query(world["r_un"], jnp.asarray(wins),
                              world["rpods"], mb, relation=relation, cap=cap,
                              exact_budget=budget, compaction="scan")
    th, tc = tdev.batch_query(world["fed"], torch.from_numpy(wins),
                              world["tpods"], relation=relation, cap=cap,
                              exact_budget=budget, compaction="scan")
    _eq(th, rh)
    _eq(tc, rc)
    if relation == "intersects":   # the all-survivor row overflows
        assert np.asarray(rc)[-2] < 0


@pytest.mark.parametrize("budget", [8, 512])
def test_fused_reference_matches_reference(world, budget):
    """``batch_query_fused(mode="reference")``: budget 8 overflows (the
    capless ``-(survivors) - 1`` code), budget 512 holds the all-survivor
    row; the zero-survivor row is all -1 either way."""
    wins = world["wins"]
    rh, rc = rdev.batch_query_fused(world["r_un"], jnp.asarray(wins),
                                    world["rpods"], relation="intersects",
                                    exact_budget=budget, mode="reference")
    th, tc = tdev.batch_query_fused(world["fed"], torch.from_numpy(wins),
                                    world["tpods"], relation="intersects",
                                    exact_budget=budget, mode="reference")
    _eq(th, rh)
    _eq(tc, rc)
    rc = np.asarray(rc)
    assert rc[-3] == 0 and (th[-3] == -1).all()
    if budget == 8:
        assert rc[-2] < 0 and -rc[-2] - 1 > budget
    else:
        assert rc[-2] == len(world["gs"])


def test_fused_reference_padded_snapshot(world):
    """The bucket-padded snapshot (sentinel keys, +inf leaf/piece bounds,
    far-away MBRs; its bounds match the reference's above) gives the
    unpadded answer, through the reference composition and through the
    wrapper's plain version alike."""
    w = torch.from_numpy(world["wins"])
    uh, uc = tdev.batch_query_fused(world["fed"], w, world["tpods"],
                                    relation="contains", exact_budget=64,
                                    mode="reference")
    for mode in ("reference", "kernel"):
        th, tc = tdev.batch_query_fused(world["fed_pad"], w, world["tpods"],
                                        relation="contains", exact_budget=64,
                                        mode=mode)
        _eq(th, uh.numpy())
        _eq(tc, uc.numpy())


def test_snapshot_device_and_validation(world):
    s = world["fed"]
    assert s.device.type == "cpu"
    w = torch.from_numpy(world["wins"])
    with pytest.raises(ValueError, match="compaction"):
        tdev.batch_query(s, w, world["tpods"], compaction="sort")
    with pytest.raises(ValueError, match="mode"):
        tdev.batch_query_fused(s, w, world["tpods"], mode="pallas")
    with pytest.raises(ValueError, match="exact_budget"):
        tdev.batch_query_fused(s, w, world["tpods"], exact_budget=0)
    with pytest.raises(ValueError, match="device-native"):
        tdev.batch_query_bounds(s, w, "disjoint")
