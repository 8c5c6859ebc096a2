"""The dry run's arithmetic: the refine cost helpers and the roofline held
value for value against the reference, and the port's cost counter
(``utils.cost``, its counterpart of ``utils/hlo.py``) held exact on
programs whose counts are worked out by hand here, as
``tests/test_analysis.py`` holds the reference's HLO analyzer:

* a loop of 10 x (1 + 7) 256 x 256 products through its backward;
* ``x @ w`` on a (4, 2) mesh of CPU positions, ``x`` over ``data`` and
  ``w`` over ``model``, and the final sum's all-reduce;
* the depth extrapolation against a count at full depth;
* the collective bytes of a reduced granite_3_2b train step on a (4, 2)
  mesh, with and without sequence sharding, and the MoE dispatch's
  all-to-all bytes of a reduced mixtral_8x22b step.

Everything counted runs on meta tensors except the mesh program (CPU).
"""
import dataclasses

import numpy as np
import pytest
import torch

from _sharded import cpu_mesh
from repro_torch.configs import ARCH_IDS, SHAPES, ShapeConfig, get_arch
from repro_torch.kernels import attention as katt
from repro_torch.kernels import refine as kr
from repro_torch.kernels import ssd as kssd
from repro_torch.launch import dryrun
from repro_torch.models import moe
from repro_torch.sharding import place, psum, smap
from repro_torch.sharding.placement import (all_to_all, ppermute,
                                          reduce_scatter, split)
from repro_torch.utils import cost, roofline

pytest.importorskip("jax")    # the reference needs jax

F32 = 4                       # bytes: the reduced configs are fp32


# ------------------------------------------------------------ cost helpers
GRID = [(1, 1000, 8, 4, 2, 3), (64, 501_008, 256, 10, 4, 16),
        (1024, 2_002_944, 512, 100, 16, 64), (4096, 1 << 28, 512, 10, 32,
                                              16)]


@pytest.mark.parametrize("kind", ["mask", "count", "compact", "exact",
                                  "fused", "knn"])
@pytest.mark.parametrize("q,n,budget,k,shards,verts", GRID)
def test_refine_cost_equals_the_reference(kind, q, n, budget, k, shards,
                                          verts):
    from repro.kernels import refine as ref

    got = kr.refine_cost(kind, q, n, budget, verts)
    want = ref.refine_cost(kind, q, n, budget, verts)
    assert got.keys() == want.keys()
    for key in want:
        assert got[key] == pytest.approx(want[key], rel=1e-12, abs=0)


@pytest.mark.parametrize("q,n,budget,k,shards,verts", GRID)
def test_sharded_costs_equal_the_reference(q, n, budget, k, shards, verts):
    from repro.kernels import refine as ref

    assert (kr.DEFAULT_BQ, kr.DEFAULT_BN, kr.COMPACT_BN) == (
        ref.DEFAULT_BQ, ref.DEFAULT_BN, ref.COMPACT_BN)
    for got, want in (
            (kr.sharded_refine_cost(q, n, budget, shards, verts),
             ref.sharded_refine_cost(q, n, budget, shards, verts)),
            (kr.sharded_knn_cost(q, n, budget, k, shards, verts),
             ref.sharded_knn_cost(q, n, budget, k, shards, verts))):
        assert got.keys() == want.keys()
        for key in want:
            assert got[key] == pytest.approx(want[key], rel=1e-12, abs=0)


def test_refine_cost_refuses_an_unknown_kind():
    with pytest.raises(ValueError, match="unknown kernel kind"):
        kr.refine_cost("scan", 8, 512)


# --------------------------------------------------------------- roofline
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_equals_the_reference(arch, shape):
    from repro.configs.base import get_arch as ref_arch
    from repro.configs.base import get_shape as ref_shape
    from repro.utils import roofline as ref

    assert roofline.model_flops(get_arch(arch), SHAPES[shape]) == \
        ref.model_flops(ref_arch(arch), ref_shape(shape))


def test_roofline_terms_at_the_cards_constants():
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.LINK_BW) == (
        989e12, 3.35e12, 450e9)
    t = roofline.roofline_terms(flops=989e12, bytes_accessed=3.35e12 * 2,
                                coll_bytes=450e9 * 0.5, chips=1)
    assert abs(t["compute_s"] - 1.0) < 1e-9
    assert abs(t["memory_s"] - 2.0) < 1e-9
    assert abs(t["collective_s"] - 0.5) < 1e-9
    assert t["dominant"] == "memory" and t["bound_s"] == t["memory_s"]
    assert abs(t["compute_fraction"] - 0.5) < 1e-9
    t = roofline.roofline_terms(989e12 * 4, 3.35e12, 450e9 * 8, chips=2)
    assert t["dominant"] == "collective" and abs(t["bound_s"] - 4.0) < 1e-9


# --------------------------------------------------- the counter, by hand
def test_loop_trip_counts_through_the_backward():
    """10 x (1 + 7) products of 256 x 256, then the gradient with respect
    to x only: 80 forward products and 80 backward ones (dC = dY w^T)."""
    x = torch.empty(256, 256, device="meta", requires_grad=True)
    w = torch.empty(256, 256, device="meta")

    def f():
        c = x
        for _ in range(10):
            c = torch.relu(c @ w)
            for _ in range(7):
                c = c @ w
        return torch.autograd.grad(c.sum(), x)[0]
    _, c = cost.count(f)
    assert c.per_chip()["flops"] == 160 * 2 * 256 ** 3
    assert c.per_chip()["collective_total"] == 0


def test_sharded_product_per_position():
    """x (64, 128) over ``data``, w (128, 256) over ``model`` on (4, 2):
    each position multiplies a (16, 128) block by a (128, 128) one, and
    the sum of the product all-reduces a 4-byte scalar over all 8."""
    mesh = cpu_mesh()
    g = torch.Generator().manual_seed(0)
    xg, wg = torch.randn(64, 128, generator=g), torch.randn(128, 256,
                                                           generator=g)
    x, w = place(xg, mesh, ("data", None)), place(wg, mesh, (None, "model"))

    def f():
        h = smap(torch.matmul, x, w, out=("data", "model"))
        return psum(smap(torch.sum, h, out=()), ("data", "model"))
    total, c = cost.count(f, positions=8)
    np.testing.assert_array_equal(c.flops, 2 * 64 * 128 * 256 / 8)
    assert (c.bytes > 0).all()
    np.testing.assert_array_equal(c.collectives["all-reduce"], F32)
    assert c.per_chip()["collective_total"] > 0
    for b in total.blocks:                    # the values are the program's
        torch.testing.assert_close(b, (xg @ wg).sum(), rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("op", ["reduce_scatter", "all_to_all", "ppermute",
                                "split"])
def test_a_count_keeps_the_programs_values(op):
    """On CPU tensors a count of 8 positions (each taken as its own
    device) returns the program's own values: every position gets its
    own rank's block, as without the counter, and a collective is still
    charged its received bytes."""
    mesh = cpu_mesh()
    g = torch.Generator().manual_seed(1)
    x = torch.randn(16, 8, 4, generator=g)
    whole = place(x, mesh, ("data", None, None))        # (4, 8, 4) a row
    part = smap(lambda t: t * 1.0, place(x, mesh, ("data", "model", None)))
    kinds = {"reduce_scatter": "reduce-scatter", "all_to_all": "all-to-all",
             "ppermute": "collective-permute"}
    run = {"reduce_scatter": lambda: reduce_scatter(part, "model", 1),
           "all_to_all": lambda: all_to_all(part, "data", 0, 2),
           "ppermute": lambda: ppermute(part, "data", [(i, (i + 1) % 4)
                                                       for i in range(4)]),
           "split": lambda: split(whole, "model", 1)}[op]
    want = run()
    got, c = cost.count(run, positions=8)
    assert len({tuple(b.shape) for b in got.blocks}) == 1
    for a, b in zip(got.blocks, want.blocks):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    if op in kinds:
        nb = got.blocks[0].numel() * F32
        np.testing.assert_array_equal(c.collectives[kinds[op]], nb)
    if op != "reduce_scatter":                          # blocks that differ
        assert not torch.equal(got.blocks[0], got.blocks[2])


def test_repeatable_adds_the_first_calls_counts():
    """A :func:`cost.repeatable` function called twice on inputs of one
    shape counts twice its first call, and runs once."""
    runs = []

    @cost.repeatable
    def f(a):
        runs.append(1)
        return a @ a

    a = torch.empty(32, 32, device="meta")
    _, once = cost.count(lambda: f(a))
    runs.clear()
    _, twice = cost.count(lambda: (f(a), f(a)))
    assert len(runs) == 1
    assert twice.flops[0] == 2 * once.flops[0] == 2 * 2 * 32 ** 3


def test_kernels_meta_routes_charge_their_work():
    """B7, B8 and B9 on meta tensors launch nothing and count nothing in
    ``launches``; the counter is charged their own operations and bytes
    (B8 counting every slot live); ``_route`` still refuses meta."""
    m = dict(device="meta")
    q, k = torch.empty(2, 8, 64, 16, **m), torch.empty(2, 2, 64, 16, **m)
    qd, kd = torch.empty(2, 8, 16, **m), torch.empty(2, 2, 40, 16, **m)
    ap = torch.empty(2, 40, dtype=torch.int32, **m)
    pos = torch.empty(2, dtype=torch.int32, **m)
    x = torch.empty(1, 96, 4, 16, **m)
    dt = torch.empty(1, 96, 4, **m)
    b = torch.empty(1, 96, 8, **m)
    a = torch.empty(4, **m)
    before = (katt.flash_attention.launches, katt.decode_attention.launches,
              kssd.ssd_scan.launches)
    for run, work in (
            (lambda: katt.flash_attention(q, k, k, 16),
             katt.flash_work(q, k, 16)),
            (lambda: katt.decode_attention(qd, kd, kd, ap, pos,
                                           return_lse=True),
             katt.decode_work(qd, kd, 2 * 40, lse=True)),
            (lambda: kssd.ssd_scan(x, dt, a, b, b, return_state=True),
             (sum(kssd.ssd_work(x, dt, b)[1:]), kssd.ssd_work(x, dt, b)[0]))):
        _, c = cost.count(run)
        assert (c.flops[0], c.bytes[0]) == work
    assert katt.flash_work(q, k)[0] == 4 * 2 * 8 * 16 * (64 * 65 // 2)
    assert (katt.flash_attention.launches, katt.decode_attention.launches,
            kssd.ssd_scan.launches) == before
    with pytest.raises(ValueError, match="unsupported device meta"):
        kr._route(q, k)


def test_depth_extrapolation_equals_a_full_count():
    """A reduced granite_3_2b train step on (4, 2) counted at depths 1-3
    and carried to 5 equals the count at depth 5: flops and collective
    bytes (linear), bytes (with the depth-squared term) and the peak."""
    cfg = get_arch("granite_3_2b").reduced()
    shape = ShapeConfig("t", 16, 16, "train")
    mesh, devices = cpu_mesh(), list(range(8))
    counts = [dryrun._count(dataclasses.replace(cfg, n_layers=d), shape,
                            mesh, devices, 2, False) for d in (1, 2, 3, 5)]
    got, want = cost.extrapolate(counts[:3], (1, 2, 3), 5), counts[3]
    for a, b in ((got.flops, want.flops), (got.bytes, want.bytes),
                 (got.peak, want.peak)):
        np.testing.assert_allclose(a, b, rtol=1e-12)
    for kind in cost.KINDS:
        np.testing.assert_allclose(got.collectives[kind],
                                   want.collectives[kind], rtol=1e-12)


# ---------------------------------------------- collective bytes, by hand
B, S = 8, 16            # 2 rows a data position, the (4, 2) mesh


def _step_counts(arch, seq=False):
    cfg = get_arch(arch).reduced()
    c = dryrun._count(cfg, ShapeConfig("t", S, B, "train"), cpu_mesh(),
                      list(range(8)), 1, seq)
    out = {k: set(v.tolist()) for k, v in c.collectives.items()}
    for k, v in out.items():
        assert len(v) == 1, (k, v)          # every position alike
    return {k: v.pop() for k, v in out.items()}


def _granite_terms():
    """The reduced granite_3_2b's blocks, fp32 (d 64, 4 heads of 16 over
    2 ``model`` positions, ff 128, vocab 256, 2 layers): each weight is
    FSDP over ``data`` (4) and TP over ``model`` (2)."""
    rows = B // 4 * S * 64 * F32                   # (2, 16, 64) activations
    # FSDP gathers a layer (each to the whole ``w_embed`` dim): wq, wk, wv
    # (64, 32), wo (32, 64) and wu, wg, wd (64 | 128 / 2 wide)
    gathers = 4 * 64 * 32 * F32 + 3 * 64 * 64 * F32
    shards = gathers // 4                          # their input blocks
    embed = 128 * 64 * F32                         # (V / 2, d) gathered
    norms = (2 * 64 + 2 * 64 + 64) * F32           # ln1, ln2, final_norm
    nll = 3 * (B // 4 * S * F32)                   # pmax, exp-sum, target
    return rows, gathers, shards, embed, norms, nll


def test_collective_bytes_of_a_train_step():
    """Forward: the embedding gathered over ``data`` and the vocab-split
    lookup summed over ``model``; a layer's seven weight gathers, and its
    attention and MLP outputs summed over ``model`` (all-reduce); the
    loss's three (2, 16) all-reduces and two scalars. Remat recomputes
    each block up to its last saved input (its MLP sum is not needed: 7
    gathers, 1 all-reduce). Backward: the reverse of every forward
    collective that carries a gradient (a gather's reduce-scatter of its
    input block; a sum's all-reduce; not the max, not the mask count),
    and the all-reduce of the replicated norms' gradients."""
    rows, gathers, shards, embed, norms, nll = _granite_terms()
    layers = 2
    got = _step_counts("granite_3_2b")
    assert got["all-gather"] == embed + 2 * layers * gathers
    assert got["reduce-scatter"] == embed // 4 + layers * shards
    fwd = rows + layers * 2 * rows + nll + 2 * F32
    remat = layers * rows
    bwd = rows + layers * 2 * rows + 2 * nll // 3 + F32
    assert got["all-reduce"] == fwd + remat + bwd + norms
    assert got["all-to-all"] == got["collective-permute"] == 0


def test_collective_bytes_of_a_seq_sharded_train_step():
    """The same step with the residual's rows split over ``model`` (8 of
    16 a position): each sublayer's normed rows are gathered (2, 8, 64) ->
    (2, 16, 64) and its output reduce-scattered back, in place of the
    all-reduce; the head gathers the final rows. Remat recomputes a
    block's two row gathers and its attention's reduce-scatter. The
    backward reverses them: a reduce-scatter of each gather's input, an
    all-gather of each reduce-scatter's."""
    rows, gathers, shards, embed, norms, nll = _granite_terms()
    layers = 2
    got = _step_counts("granite_3_2b", seq=True)
    row_gathers = layers * 2 + 1 + layers * 2        # forward, head, remat
    scatters = layers * 2 + layers                   # forward, remat
    fwd_scatters = layers * 2
    assert got["all-gather"] == (embed + 2 * layers * gathers
                                 + row_gathers * rows
                                 + fwd_scatters * rows)
    assert got["reduce-scatter"] == (scatters * rows // 2 + embed // 4
                                     + layers * shards
                                     + (layers * 2 + 1) * rows // 2)
    assert got["all-reduce"] == (rows + nll + 2 * F32
                                 + rows + 2 * nll // 3 + F32 + norms)


def test_moe_dispatch_bytes_of_a_train_step():
    """A reduced mixtral_8x22b step (4 experts over ``data``, top 2): a
    chunk's 128 tokens give a capacity of 128 slots an expert (128 x 2 x
    1.25 / 4 rounded up to 128); each position cuts its (4 experts, 128,
    64) buffer into 4 expert blocks and receives one from each position,
    (4, 1, 128, 64). Two all-to-alls a layer (dispatch, return), again in
    the remat recompute, and the reverse of the two forward ones in the
    backward: 6 a layer."""
    assert moe.capacity(B * S, 2, 4) == 128
    block = 4 * 1 * 128 * 64 * F32
    got = _step_counts("mixtral_8x22b")
    assert got["all-to-all"] == 2 * 6 * block
