"""Port foundations against the reference package: Z-order limbs and window
intervals, every fp32 geometry predicate, and the relation registry.

Inputs are made with numpy from a seed and handed to both packages as numpy
arrays; the reference predicates run with ``xp=jax.numpy`` in fp32. Decisions
(booleans, limbs, keys) must be equal element for element. The one float
output compared, the squared distance, carries a stated tolerance: the
reference's compiled CPU program contracts ``a * b + c`` into fused
multiply-adds, the port rounds each product on its own (as its kernels do).
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")   # the reference needs jax
# small tensors: one torch thread per xdist worker beats oversubscribing
# the cores the workers share
torch.set_num_threads(1)
import jax.numpy as jnp  # noqa: E402

from _oracle import mixed_store  # noqa: E402
from repro.core import geometry as rgeom  # noqa: E402
from repro.core import relations as rrel  # noqa: E402
from repro.core import zorder as rz  # noqa: E402
from repro.core.datasets import make_query_windows  # noqa: E402
from repro_torch.core import geometry as tgeom  # noqa: E402
from repro_torch.core import relations as trel  # noqa: E402
from repro_torch.core import zorder as tz  # noqa: E402

PREDICATES = {
    # name: (reference predicate, port predicate)
    "intersects": (rgeom.rect_intersects_geoms,
                   tgeom.rect_intersects_geoms_torch),
    "contains_proper": (rgeom.rect_contains_geoms_proper,
                        tgeom.rect_contains_geoms_proper_torch),
    "covers": (lambda r, v, n, k, xp: rgeom.rect_covers_geoms(r, v, n, xp=xp),
               tgeom.rect_covers_geoms_torch),
    "within": (rgeom.geoms_cover_rect, tgeom.geoms_cover_rect_torch),
    "touches": (rgeom.rect_touches_geoms, tgeom.rect_touches_geoms_torch),
    "crosses": (rgeom.rect_crosses_geoms, tgeom.rect_crosses_geoms_torch),
    "disjoint": (rgeom.rect_disjoint_geoms, tgeom.rect_disjoint_geoms_torch),
    "interior": (rgeom.rect_interior_intersects_geoms,
                 tgeom.rect_interior_intersects_geoms_torch),
    "dwithin": (lambda r, v, n, k, xp: rgeom.rect_dwithin_geoms(
                    r, v, n, k, 0.003, xp=xp),
                lambda r, v, n, k: tgeom.rect_dwithin_geoms_torch(
                    r, v, n, k, 0.003)),
}


@pytest.fixture(scope="module")
def store():
    """fp32 views of a mixed store (points .. 64-vertex rings) plus windows:
    random ones, ones flush against record MBR edges (touches / boundary
    cases) and degenerate zero-width ones."""
    gs = mixed_store(300, seed=4)
    verts = gs.verts.astype(np.float32)
    rng = np.random.default_rng(0)
    wins = [make_query_windows(gs, 0.01, 8, seed=1)]
    m = gs.mbrs[rng.choice(len(gs), 6, replace=False)]
    wins.append(np.stack([m[:, 0] - 0.01, m[:, 1], m[:, 0], m[:, 3]], 1))
    wins.append(np.stack([m[:, 0], m[:, 1], m[:, 2], m[:, 3]], 1))
    wins.append(np.stack([m[:, 0], m[:, 1], m[:, 0], m[:, 1]], 1))
    # small boxes around interior vertices of polylines (crosses)
    lines = np.nonzero((gs.kinds == int(rgeom.GeomKind.POLYLINE))
                       & (gs.nverts >= 3))[0][:6]
    v1 = gs.pool[gs.offsets[lines] + 1]
    wins.append(np.concatenate([v1 - 1e-4, v1 + 1e-4], 1))
    wins = np.concatenate(wins).astype(np.float32)
    return gs, verts, wins


def _reference(name, wins, verts, nverts, kinds):
    fn = PREDICATES[name][0]
    v = jnp.asarray(verts)
    n = jnp.asarray(nverts)
    k = jnp.asarray(kinds.astype(np.int32))
    batched = jax.jit(jax.vmap(lambda w: fn(w, v, n, k, xp=jnp)))
    return np.asarray(batched(jnp.asarray(wins)))


@pytest.mark.parametrize("name", sorted(PREDICATES))
def test_predicates_match_reference(store, name):
    """Batched port predicate == reference fp32 predicate, per window and
    record, including the rank-1 (one window) form."""
    gs, verts, wins = store
    want = _reference(name, wins, verts, gs.nverts, gs.kinds)
    fn = PREDICATES[name][1]
    q = wins.shape[0]
    tv = torch.from_numpy(verts)
    tn = torch.from_numpy(gs.nverts.astype(np.int32))
    tk = torch.from_numpy(gs.kinds.astype(np.int32))
    got = fn(torch.from_numpy(wins), tv.expand(q, *tv.shape),
             tn.expand(q, -1), tk.expand(q, -1)).numpy()
    np.testing.assert_array_equal(got, want)
    one = fn(torch.from_numpy(wins[3]), tv, tn, tk).numpy()
    np.testing.assert_array_equal(one, want[3])
    assert want.any(), "the inputs never trigger the predicate"


def test_sqdist_close_to_reference(store):
    """Squared distances agree to fp32 rounding: rtol 1e-6 covers the
    reference's fused multiply-adds (one rounding less per product-sum)."""
    gs, verts, wins = store
    k = jnp.asarray(gs.kinds.astype(np.int32))
    want = np.asarray(jax.jit(jax.vmap(lambda w: rgeom.rect_geom_sqdist(
        w, jnp.asarray(verts), jnp.asarray(gs.nverts), k, xp=jnp)))(
            jnp.asarray(wins)))
    q = wins.shape[0]
    got = tgeom.rect_geom_sqdist_torch(
        torch.from_numpy(wins),
        torch.from_numpy(verts).expand(q, *verts.shape),
        torch.from_numpy(gs.nverts.astype(np.int32)).expand(q, -1),
        torch.from_numpy(gs.kinds.astype(np.int32)).expand(q, -1)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)
    assert (want == 0).any() and (want > 0).any()


def test_width_independent_and_ragged_padded(store):
    """The pad-with-last gather matches the reference, and a predicate's
    answer does not depend on the padded width (what lets a kernel loop
    over exactly nverts vertices)."""
    gs, _, wins = store
    pool = gs.pool.astype(np.float32)
    idx = np.arange(len(gs))
    want = rgeom.ragged_padded(pool, gs.offsets[idx], gs.nverts[idx], 64)
    got = tgeom.ragged_padded_torch(
        torch.from_numpy(pool), torch.from_numpy(gs.offsets[idx]),
        torch.from_numpy(gs.nverts[idx].astype(np.int32)), 64).numpy()
    np.testing.assert_array_equal(got, want)
    tn = torch.from_numpy(gs.nverts.astype(np.int32))
    tk = torch.from_numpy(gs.kinds.astype(np.int32))
    w = torch.from_numpy(wins[0])
    base = None
    for width in (64, 128):
        v = tgeom.ragged_padded_torch(torch.from_numpy(pool),
                                      torch.from_numpy(gs.offsets), tn, width)
        out = [tgeom.device_predicate(c, 0.002)(w, v, tn, tk)
               for c in range(tgeom.PRED_DWITHIN + 1)]
        out = torch.stack(out).numpy()
        if base is None:
            base = out
        np.testing.assert_array_equal(out, base)


def test_zorder_limbs_and_intervals():
    rng = np.random.default_rng(2)
    qx = rng.integers(0, 1 << 30, 5000).astype(np.int32)
    qy = rng.integers(0, 1 << 30, 5000).astype(np.int32)
    hi, lo = rz.morton_encode_hilo(jnp.asarray(qx), jnp.asarray(qy))
    thi, tlo = tz.morton_encode_hilo(torch.from_numpy(qx),
                                     torch.from_numpy(qy))
    np.testing.assert_array_equal(thi.numpy(), np.asarray(hi))
    np.testing.assert_array_equal(tlo.numpy(), np.asarray(lo))
    assert thi.dtype == torch.int32
    a, b = (rng.integers(0, 4, (2, 3000)).astype(np.int32) for _ in range(2))
    np.testing.assert_array_equal(
        tz.z_less_hilo(*map(torch.from_numpy, (a[0], a[1], b[0], b[1])))
        .numpy(), np.asarray(rz.z_less_hilo(a[0], a[1], b[0], b[1])))
    np.testing.assert_array_equal(
        tz.hilo_to_float32(torch.from_numpy(thi.numpy()),
                           torch.from_numpy(tlo.numpy()), 3, 7).numpy(),
        np.asarray(rz.hilo_to_float32(hi, lo, 3, 7)))


@pytest.mark.parametrize("grid", ["UNIT", "WGS84"])
def test_window_intervals_match_reference(grid):
    """fp32 window -> guarded Z-interval limbs, bit for bit, on the unit
    grid and on WGS84, including out-of-domain corners that must clamp.
    The reference is compiled as its device query compiles it: on WGS84 its
    compiled arithmetic (reciprocal multiply, fused multiply-add) differs
    from its op-by-op evaluation, and the port follows the compiled one; on
    the unit grid every step is exact and the two agree."""
    g_ref, g_port = getattr(rz, grid), getattr(tz, grid)
    rng = np.random.default_rng(3)
    if grid == "UNIT":
        lo, hi = -0.1, 1.1
    else:
        lo, hi = -200.0, 200.0
    c = rng.uniform(lo, hi, (4000, 2))
    wins = np.concatenate([c, c + rng.uniform(0, 0.05, (4000, 2))], 1)
    wins = wins.astype(np.float32)
    (a, b), (c_, d) = jax.jit(lambda w: rz.mbr_to_zinterval_hilo(
        w, g_ref, guard=64))(jnp.asarray(wins))
    (ta, tb), (tc, td) = tz.mbr_to_zinterval_hilo(torch.from_numpy(wins),
                                                  g_port, guard=64)
    for x, y in ((ta, a), (tb, b), (tc, c_), (td, d)):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))


def test_registry_parity():
    """Same relations with the same probe rules; every device-native
    relation has a device predicate code."""
    assert trel.check_registry() == rrel.check_registry()
    for name in rrel.relation_names():
        a, b = rrel.RELATIONS[name], trel.RELATIONS[name]
        for f in ("augment", "device_native", "complement_of", "probe_pad",
                  "prefilter_kind", "parametric"):
            assert getattr(a, f) == getattr(b, f), (name, f)
    for name in ("dwithin:0.25", "dwithin:0"):
        a, b = rrel.get_relation(name), trel.get_relation(name)
        assert (a.probe_pad, a.augment) == (b.probe_pad, b.augment)
        assert b.code == tgeom.PRED_DWITHIN and b.dist == a.probe_pad
    codes = {trel.get_relation(n).code
             for n in trel.relation_names(device_native=True)
             if not trel.RELATIONS[n].parametric}
    assert codes == set(range(tgeom.PRED_DWITHIN))
    w = np.array([[0.1, 0.2, 0.3, 0.4]], np.float32)
    np.testing.assert_array_equal(
        trel.get_relation("dwithin:0.05").probe_window(torch.from_numpy(w))
        .numpy(),
        np.asarray(rrel.get_relation("dwithin:0.05").probe_window(
            jnp.asarray(w), xp=jnp)))
    with pytest.raises(ValueError, match="parameter"):
        trel.get_relation("dwithin")
