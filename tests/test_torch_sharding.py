"""The port's sharding layer against the reference's: the rule table (every
model's parameter, cache and batch layouts on the test and production
meshes, with and without sequence sharding, leaf for leaf as tuples), the
shape table, and the placed values and collectives under one controller
against numpy (every position on the CPU).

The reference's rules read only a mesh's axis names and sizes, so it runs
on ``jax.sharding.AbstractMesh`` (no devices); the port's on its own
``Mesh`` of CPU positions.
"""
import functools
import math

import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import base as rbase
from repro.sharding import MeshRules as RRules
from repro.train import step as rstep
from repro_torch.configs import base as tbase
from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.core.distributed import make_mesh
from repro_torch.models import transformer as tf
from repro_torch.sharding import (MeshRules, constrain,
                                  gather, place, use_rules)
from repro_torch.sharding import placement as pl
from repro_torch.sharding.rules import logical_to_spec, spec_tree
from repro_torch.train import step as tstep
from repro_torch.utils.tree import paths

MESHES = {"4x2": ((4, 2), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


@functools.lru_cache(maxsize=None)
def _meshes(name):
    sizes, axes = MESHES[name]
    return (AbstractMesh(sizes, axes),
            make_mesh(sizes, axes, ["cpu"] * math.prod(sizes)))


def _ref_specs(tree):
    """A reference tree of NamedShardings as {path: spec tuple}."""
    out = {}

    def walk(t, prefix):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, f"{prefix}{k}/")
        else:
            out[prefix[:-1]] = tuple(t.spec)
    walk(tree, "")
    return out


def _port_specs(tree):
    return {k: tuple(getattr(v, "spec", v)) for k, v in paths(tree)}


@pytest.mark.parametrize("seq", [False, True], ids=["noseq", "seq"])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_layouts_match_reference(arch, mesh, seq):
    """Parameters (``param_shardings`` over ``logical_axes``), the decode
    cache (over ``cache_logical``) and every shape's batch (``input_specs``
    and ``_batch_spec``): the same spec for every leaf."""
    amesh, tmesh = _meshes(mesh)
    rr, tr = RRules(mesh=amesh, seq_sharding=seq), MeshRules(
        tmesh, seq_sharding=seq)
    rcfg, tcfg = rbase.get_arch(arch), get_arch(arch)
    rshapes, rsh = rstep.param_shardings(rcfg, rr)
    tshapes, tsh = tstep.param_shardings(tcfg, tr)
    assert _port_specs(tsh) == _ref_specs(rsh)
    got_shapes = {k: (v[0], str(v[1]).split(".")[-1])
                  for k, v in paths(tshapes)}
    want_shapes = {}

    def walk(t, prefix):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, f"{prefix}{k}/")
        else:
            want_shapes[prefix[:-1]] = (tuple(t.shape), str(t.dtype))
    walk(rshapes, "")
    assert got_shapes == want_shapes
    for sname, shp in rbase.SHAPES.items():
        tshp = tbase.get_shape(sname)
        want = _ref_specs(rstep._cache_shardings(rcfg, shp, rr))
        got = spec_tree(tr, tf.cache_logical(tcfg), tf.cache_shapes(
            tcfg, tshp.global_batch, tshp.seq_len))
        assert _port_specs(got) == want, sname
        rb = rstep.input_specs(rcfg, shp)
        tb = tstep.input_specs(tcfg, tshp)
        assert {k: (s, str(d).split(".")[-1]) for k, (s, d) in tb.items()} \
            == {k: (tuple(v.shape), str(v.dtype)) for k, v in rb.items()}
        assert _port_specs(tstep._batch_spec(tr, tb)) == _ref_specs(
            rstep._batch_spec(rr, rb)), sname


def test_opt_layouts_follow_params():
    _, tmesh = _meshes("4x2")
    rules = MeshRules(tmesh)
    p_shapes, p_sh = tstep.param_shardings(get_arch("granite_34b"), rules)
    o_shapes, o_sh = tstep._opt_shardings(rules, p_shapes, p_sh)
    assert o_sh["mu"] is p_sh and o_sh["nu"] is p_sh
    assert tuple(o_sh["step"].spec) == ()
    assert all(d == torch.float32 for _, (_, d) in paths(o_shapes["mu"]))
    assert o_shapes["step"] == ((), torch.int32)


def test_quiet_rules():
    """An undivided dimension stays whole; an axis already used is not
    used again (granite_3_2b's odd vocab, granite_34b's one kv head)."""
    _, tmesh = _meshes("4x2")
    rules = MeshRules(tmesh)
    _, sh = tstep.param_shardings(get_arch("granite_3_2b"), rules)
    assert tuple(sh["embed"].spec) == (None, "data")         # 49,155
    _, sh = tstep.param_shardings(get_arch("granite_34b"), rules)
    assert tuple(sh["blocks"]["attn"]["wq"].spec) == (None, "data", "model")
    assert tuple(sh["blocks"]["attn"]["wk"].spec) == (None, "data", "model")
    assert logical_to_spec(rules, ("heads", "kv"), (4, 4)) == ("model",)
    assert logical_to_spec(rules, ("batch", None), (6, 3)) == ()


def test_shape_table_matches_reference():
    assert {k: tuple(vars(v).values()) for k, v in tbase.SHAPES.items()} \
        == {k: tuple(vars(v).values()) for k, v in rbase.SHAPES.items()}
    ref_cells = [c for c in rbase.all_cells() if c[0] in ARCH_IDS]
    assert sorted(tbase.all_cells()) == sorted(ref_cells)
    assert len(tbase.all_cells()) == 40


# -------------------------------------------------------------- placement
def _mesh8(shape=(4, 2), axes=("data", "model")):
    return make_mesh(shape, axes, ["cpu"] * 8)


SPECS = [(), ("data",), (None, "model"), ("data", "model"),
         (("data", "model"),), ("model", "data"), (None, ("model", "data"))]


@pytest.mark.parametrize("spec", SPECS, ids=str)
def test_place_gather_round_trip(spec):
    mesh = _mesh8()
    x = torch.arange(8 * 16, dtype=torch.float32).reshape(8, 16)
    s = place(x, mesh, spec)
    assert torch.equal(gather(s), x)
    n_blocks = len({pl._key(pl.block_slices(mesh, s.spec, x.shape, p))
                    for p in range(8)})
    # one tensor per distinct block on the one device
    assert len({id(b) for b in s.blocks}) == n_blocks
    assert torch.equal(gather(pl.relayout(s, ("model", "data"))), x)


def test_place_three_axes_and_tuple_entries():
    mesh = _mesh8((2, 2, 2), ("pod", "data", "model"))
    x = torch.arange(4 * 6).reshape(4, 6)
    s = place(x, mesh, (("pod", "data"), "model"))
    # position (pod 1, data 0, model 1): row block 2 of 4, column block 1
    assert torch.equal(s.blocks[5], x[2:3, 3:6])
    assert torch.equal(gather(s), x)
    with pytest.raises(ValueError):
        place(x, mesh, ("data", "data"))
    with pytest.raises(ValueError):
        place(torch.zeros(3, 2), mesh, ("pod",))


def test_constrain_identity_outside_rules():
    x = torch.ones(4, 4)
    assert constrain(x, ("batch", None)) is x
    s = place(x, _mesh8(), ())
    assert constrain(s, ("batch", None)) is s


def test_constrain_inside_rules():
    mesh = _mesh8()
    x = torch.arange(8 * 6, dtype=torch.float32).reshape(8, 6)
    s = place(x, mesh, ("data",))
    with use_rules(MeshRules(mesh)):
        assert constrain(s, ("batch", None)) is s           # already laid out
        r = constrain(s, (None, "ff"))                      # gather + slice
        assert tuple(r.spec) == (None, "model")
        assert torch.equal(gather(r), x)
        assert torch.equal(r.blocks[1], x[:, 3:])
        assert tuple(constrain(s, ("batch", "heads")).spec) == ("data",
                                                                "model")
    assert constrain(s, (None, "ff")) is s


# ------------------------------------------------------------ collectives
def _blocks_np(mesh, make):
    """A per-position value: position p's block ``make(p)``."""
    return pl.Sharded(None, None, mesh,
                      [torch.from_numpy(make(p)) for p in range(8)])


def _coords(mesh, p):
    return dict(zip(mesh.axis_names, np.unravel_index(p, mesh.sizes)))


@pytest.mark.parametrize("axis", ["data", "model", ("data", "model")],
                         ids=str)
def test_collectives_match_numpy(axis):
    mesh = _mesh8()
    rng = np.random.default_rng(0)
    vals = [rng.normal(size=(3, 4)).astype(np.float32) for _ in range(8)]
    s = _blocks_np(mesh, lambda p: vals[p])
    axes = (axis,) if isinstance(axis, str) else axis

    def group(p):
        """The positions sharing p's other coordinates, in axis order."""
        c = _coords(mesh, p)
        out = [q for q in range(8) if all(
            _coords(mesh, q)[a] == c[a] for a in mesh.axis_names
            if a not in axes)]
        return sorted(out, key=lambda q: [_coords(mesh, q)[a]
                                          for a in axes])
    for p in range(8):
        g = group(p)
        rank = g.index(p)
        np.testing.assert_array_equal(pl.psum(s, axis).blocks[p].numpy(),
                                      functools.reduce(np.add,
                                                       [vals[q] for q in g]))
        np.testing.assert_array_equal(pl.pmax(s, axis).blocks[p].numpy(),
                                      np.max([vals[q] for q in g], 0))
        np.testing.assert_array_equal(
            pl.all_gather(s, axis, 1).blocks[p].numpy(),
            np.concatenate([vals[q] for q in g], 1))
        total = functools.reduce(np.add, [vals[q] for q in g])
        n = 4 // len(g) if len(g) <= 4 else None
        if n:
            np.testing.assert_array_equal(
                pl.reduce_scatter(s, axis, 1).blocks[p].numpy(),
                total[:, rank * n:(rank + 1) * n])
    if isinstance(axis, str):
        k = mesh.shape[axis]
        shifted = pl.ppermute(s, axis, [(i, (i + 1) % k) for i in range(k)])
        for p in range(8):
            g = group(p)
            src = g[(g.index(p) - 1) % k]
            np.testing.assert_array_equal(shifted.blocks[p].numpy(),
                                          vals[src])
        half = pl.ppermute(s, axis, [(0, k - 1)])
        for p in range(8):
            g = group(p)
            want = vals[g[0]] if g.index(p) == k - 1 else 0 * vals[p]
            np.testing.assert_array_equal(half.blocks[p].numpy(), want)


def test_placed_collectives_keep_layouts():
    mesh = _mesh8()
    x = torch.arange(8 * 8, dtype=torch.float32).reshape(8, 8)
    s = place(x, mesh, ("data", "model"))
    g = pl.all_gather(s, "model", 1)
    assert tuple(g.spec) == ("data",) and torch.equal(gather(g), x)
    r = pl.reduce_scatter(place(x, mesh, ("data",)), "model", 1)
    assert tuple(r.spec) == ("data", "model")
    assert torch.equal(gather(r), 2 * x)
    with pytest.raises(ValueError):
        pl.all_gather(s, "data", 1)


def test_autograd_through_all_gather_and_psum():
    """The gradient of an all-gather arrives summed over the positions that
    read it; a value copied into a psum gets each reader's gradient."""
    mesh = _mesh8()
    w = torch.arange(8 * 4, dtype=torch.float64).reshape(8, 4)
    s = place(w, mesh, ("data", "model"))
    for b in s.blocks:
        b.requires_grad_(True)
    full = pl.all_gather(pl.all_gather(s, "model", 1), "data", 0)
    # every position reads the whole value, scaled by (its index + 1)
    scaled = pl.smap(lambda i, f: f * (i + 1), full, coord=("data", "model"))
    tot = pl.psum(pl.smap(lambda f: f.sum(), scaled), ("data", "model"))
    grads = torch.autograd.grad(tot.blocks[0], list(s.blocks))
    for g in grads:   # sum over the eight readers of 1 .. 8
        torch.testing.assert_close(g, torch.full_like(g, 36.0))
    x = torch.ones(3, dtype=torch.float64, requires_grad=True)
    copies = pl.Sharded(None, None, mesh, [x * 1.0] * 4 + [x * 2.0] * 4)
    summed = pl.psum(copies, "data")
    loss = sum(b.sum() for b in summed.blocks[:2])
    (gx,) = torch.autograd.grad(loss, [x])
    # position 0 and 1 each read 4 copies: (1+1+2+2) twice
    torch.testing.assert_close(gx, torch.full_like(gx, 12.0))


def test_sum_replicas_and_canonical_blocks():
    mesh = _mesh8()
    s = place(torch.ones(4, 2), mesh, ("data",))
    assert pl.sum_replicas(s) is s                     # one tensor a block
    assert len(pl.canonical_blocks(s)) == 4
    apart = pl.Sharded(s.shape, s.spec, mesh,
                       [b * (p % 2 + 1) for p, b in enumerate(s.blocks)])
    r = pl.sum_replicas(apart)
    for b in r.blocks:       # the two model replicas of each block: 1 + 2
        assert torch.equal(b, torch.full((1, 2), 3.0))
    assert len(pl.unique_blocks(apart)) == 8
