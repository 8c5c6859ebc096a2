"""Sequence sharding (``MeshRules(seq_sharding=True)``) in the sharded train
step and the sharded prefill over a (4, 2) ``("data", "model")`` mesh of
CPU positions, held against the reference's seq-sharded run; a decode
step on those rules against one without; the residual's layout.

The reference runs once, in a subprocess with eight host devices, started
by a module fixture while the port-only tests run: its
``build_train_step`` (two microbatches of 4 x 64 tokens) and
``build_prefill_step`` (a 40-row prompt into a 48-slot cache) with
``seq_sharding=True`` on the ``reduced()`` granite_3_2b, qwen2_vl_2b (stub
frontend, M-RoPE positions), mamba2_2p7b, hymba_1p5b (8 meta rows ahead of
each sequence) and mixtral_8x22b.

Tolerances (``tests/test_torch_sharded_train.py``'s): loss, grad_norm and
lr within 1e-5 relative; ``mu`` within 1e-5 of each leaf's largest
magnitude (3e-5 with an SSM: ``tests/test_torch_sharded_families.py``
says why); the updated parameters within 2 lr everywhere and 1e-6 on all
but 0.1% of the elements; the prefill's logits and every cache leaf within
1e-5 of the largest (integer leaves exactly).
"""
import dataclasses

import numpy as np
import pytest
import torch

from _sharded import (close_rel, cpu_mesh, leaf_close, params_close,
                      start_reference, stop_reference, tree,
                      wait_reference)
from repro_torch.configs import ShapeConfig, get_arch
from repro_torch.models import convert
from repro_torch.models import parallel as par
from repro_torch.models import transformer as tf
from repro_torch.sharding import MeshRules, gather, gather_tree, place_tree
from repro_torch.sharding import placement as pl
from repro_torch.train import step as tstep
from repro_torch.utils.tree import leaves, paths

ARCHS = ("granite_3_2b", "qwen2_vl_2b", "mamba2_2p7b", "hymba_1p5b",
         "mixtral_8x22b")
SEQ, BATCH, MICRO = 64, 8, 2
PROMPT, SLOTS = 40, 48

_REF = r'''
import sys
import numpy as np, jax
from repro.utils.compat import make_auto_mesh
from repro.configs.base import get_arch, ShapeConfig
from repro.sharding import MeshRules
from repro.train.step import build_train_step, build_prefill_step
from repro.train.optimizer import adamw_init
from repro.models import transformer as tf

out = {{}}

def pack(prefix, tree):
    for pp, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                       for p in pp)
        out[prefix + "/" + key] = np.asarray(leaf)

def draw(cfg, rng, b, s, labels):
    if cfg.frontend == "embed_stub":
        batch = {{"embeds": rng.normal(0, 1, (b, s, cfg.d_model)
                                      ).astype(np.float32)}}
        if cfg.mrope:
            batch["positions"] = rng.integers(0, s, (b, 3, s)
                                              ).astype(np.int32)
    else:
        batch = {{"tokens": rng.integers(0, cfg.vocab, (b, s)
                                        ).astype(np.int32)}}
    if labels:
        batch["labels"] = rng.integers(0, cfg.vocab, (b, s)
                                       ).astype(np.int32)
    return batch

mesh = make_auto_mesh((4, 2), ("data", "model"))
rules = MeshRules(mesh=mesh, seq_sharding=True)
for arch in {ARCHS!r}:
    cfg = get_arch(arch).reduced()
    params = tf.init_params(cfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    batch = draw(cfg, rng, {BATCH}, {SEQ}, True)
    prompt = draw(cfg, rng, {BATCH}, {PROMPT}, False)
    step, in_sh, out_sh, _ = build_train_step(
        cfg, ShapeConfig("t", {SEQ}, {BATCH}, "train"), rules,
        microbatches={MICRO})
    pf, pin, pout, _ = build_prefill_step(
        cfg, ShapeConfig("p", {SLOTS}, {BATCH}, "prefill"), rules)
    with mesh:
        p_d = jax.tree_util.tree_map(jax.device_put, params, in_sh[0])
        o_d = jax.tree_util.tree_map(jax.device_put, adamw_init(params),
                                     in_sh[1])
        b_d = {{k: jax.device_put(v, in_sh[2][k]) for k, v in batch.items()}}
        lg, cache = jax.jit(pf, in_shardings=pin, out_shardings=pout)(
            p_d, {{k: jax.device_put(v, pin[1][k])
                  for k, v in prompt.items()}})
        pack(arch + "/cache", cache)
        out[arch + "/logits"] = np.asarray(lg)
        fn = jax.jit(step, in_shardings=in_sh, out_shardings=out_sh)
        p2, o2, m = fn(p_d, o_d, b_d)
    pack(arch + "/params", params)
    pack(arch + "/batch", batch)
    pack(arch + "/prompt", prompt)
    pack(arch + "/new", p2)
    pack(arch + "/mu", o2["mu"])
    pack(arch + "/metrics", m)
np.savez(sys.argv[1], **out)
print("REF-OK")
'''


@pytest.fixture(scope="module", autouse=True)
def ref_run(tmp_path_factory):
    """Starts the reference subprocess with the module's first test; the
    tests that read it wait in ``ref``, the port-only tests (first in the
    file) run meanwhile."""
    d = tmp_path_factory.mktemp("seq_sharding_ref")
    proc, logs = start_reference(_REF, d, ARCHS=ARCHS, SEQ=SEQ,
                                 BATCH=BATCH, MICRO=MICRO, PROMPT=PROMPT,
                                 SLOTS=SLOTS)
    yield proc, d
    stop_reference(proc, logs)


@pytest.fixture(scope="module")
def ref(ref_run):
    return wait_reference(*ref_run)


def _rel(cfg) -> float:
    return 3e-5 if cfg.has_ssm else 1e-5


def _close(got, want, rel=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    if np.issubdtype(want.dtype, np.integer):
        np.testing.assert_array_equal(got, want)
    else:
        leaf_close(got, want, rel)


def _rules(seq=True):
    return MeshRules(cpu_mesh(), seq_sharding=seq)


def _tokens(cfg, b, s, seed=0):
    g = torch.Generator().manual_seed(seed)
    return {k: torch.randint(0, cfg.vocab, (b, s), generator=g,
                             dtype=torch.int32) for k in ("tokens", "labels")}


def _spy_blocks(monkeypatch):
    """The spec of every block's input, in call order."""
    seen = []
    real = par._block

    def spy(x, *a, **k):
        seen.append(tuple(x.spec))
        return real(x, *a, **k)
    monkeypatch.setattr(par, "_block", spy)
    return seen


# -------------------------------------------------- the residual's layout
@pytest.mark.parametrize("arch,seq,split", [
    ("granite_3_2b", SEQ, True),
    ("hymba_1p5b", SEQ, True),          # 8 meta + 64 rows: 36 | 36
    ("hymba_1p5b", SEQ - 1, False)])    # 8 meta + 63 rows do not split
def test_residual_split_where_the_rows_divide(monkeypatch, arch, seq, split):
    """Between blocks the residual's rows split over ``model`` where they
    divide its extent, and stay whole where they do not (as
    ``logical_to_spec`` leaves them); the loss and every gradient leaf
    equal the step's without sequence sharding (bit for bit where the
    residual stays whole)."""
    seen = _spy_blocks(monkeypatch)
    cfg = get_arch(arch).reduced()
    params = tf.init_params(cfg, 1, device="cpu")
    batch = _tokens(cfg, BATCH, seq, seed=1)
    got = []
    for rules in (_rules(False), _rules(True)):
        pd = place_tree(params, tstep.param_shardings(cfg, rules)[1])
        bd = place_tree(batch, tstep._batch_spec(
            rules, tstep.input_specs(cfg, ShapeConfig("t", seq, BATCH,
                                                      "train"))))
        seen.clear()
        loss, grads = tstep.sharded_value_and_grad(pd, cfg, bd, rules)
        got.append((float(gather(loss)),
                    [gather(g).numpy() for g in leaves(grads)]))
    want = ("data", "model") if split else ("data",)
    assert seen == [want] * 2 * cfg.n_layers    # forward, remat recompute
    (l0, g0), (l1, g1) = got
    if split:
        close_rel(l1, l0)
        for a, b in zip(g1, g0):
            leaf_close(a, b, _rel(cfg))
    else:
        assert l1 == l0
        assert all(np.array_equal(a, b) for a, b in zip(g1, g0))


@pytest.mark.parametrize("arch", ["granite_3_2b", "hymba_1p5b",
                                  "mixtral_8x22b"])
def test_decode_with_seq_rules_equals_without(arch):
    """A decode step's residual has one row: on ``seq_sharding=True``
    rules it gives the same logits and the same cache as without, bit for
    bit, from the same prefilled cache."""
    cfg = get_arch(arch).reduced()
    params = tf.init_params(cfg, 2, device="cpu")
    toks = _tokens(cfg, BATCH, PROMPT + 1, seed=2)["tokens"]
    pf, pin, _, _ = tstep.build_prefill_step(
        cfg, ShapeConfig("p", SLOTS, BATCH, "prefill"), _rules(False))
    _, cache = pf(place_tree(params, pin[0]),
                  place_tree({"tokens": toks[:, :PROMPT]}, pin[1]))
    prefilled = gather_tree(cache)
    out = []
    for seq in (False, True):
        df, din, _, _ = tstep.build_decode_step(
            cfg, ShapeConfig("d", SLOTS, BATCH, "decode"), _rules(seq))
        lg, cache = df(place_tree(params, din[0]),
                       place_tree(prefilled, din[1]),
                       place_tree({"tokens": toks[:, PROMPT]}, din[2]))
        out.append((gather(lg), leaves(gather_tree(cache))))
    (l0, c0), (l1, c1) = out
    assert torch.equal(l1, l0)
    assert all(torch.equal(a, b) for a, b in zip(c1, c0))


# ------------------------------------------------ against the reference
def _ref_inputs(ref, arch):
    cfg = get_arch(arch).reduced()
    params = convert.params_from_reference(cfg, tree(ref, arch + "/params"),
                                           device="cpu")
    return cfg, params


@pytest.mark.parametrize("arch", ARCHS)
def test_seq_sharded_step_matches_reference(ref, arch):
    cfg, params = _ref_inputs(ref, arch)
    batch = {k: torch.from_numpy(v)
             for k, v in tree(ref, arch + "/batch").items()}
    rules = _rules()
    step, in_sh, _, _ = tstep.build_train_step(
        cfg, ShapeConfig("t", SEQ, BATCH, "train"), rules,
        microbatches=MICRO)
    pd = place_tree(params, in_sh[0])
    new, opt, m = step(pd, tstep.sharded_adamw_init(pd),
                       place_tree(batch, in_sh[2]))
    rm = tree(ref, arch + "/metrics")
    for k in ("loss", "grad_norm", "lr"):
        close_rel(float(gather(m[k])), float(rm[k]))
    rmu = dict(paths(tree(ref, arch + "/mu")))
    for k, v in paths(opt["mu"]):
        leaf_close(gather(v).numpy(), rmu[k], _rel(cfg))
    rnew = dict(paths(tree(ref, arch + "/new")))
    got = [(gather(v).numpy(), rnew[k]) for k, v in paths(new)]
    params_close([a for a, _ in got], [b for _, b in got], float(rm["lr"]))


@pytest.mark.parametrize("arch", ARCHS)
def test_seq_sharded_prefill_matches_reference(ref, arch):
    cfg, params = _ref_inputs(ref, arch)
    prompt = {k: torch.from_numpy(v)
              for k, v in tree(ref, arch + "/prompt").items()}
    pf, pin, pout, _ = tstep.build_prefill_step(
        cfg, ShapeConfig("p", SLOTS, BATCH, "prefill"), _rules())
    lg, cache = pf(place_tree(params, pin[0]), place_tree(prompt, pin[1]))
    _close(gather(lg).numpy(), ref[arch + "/logits"])
    want = dict(paths(tree(ref, arch + "/cache")))
    got = dict(paths(cache))
    assert got.keys() == want.keys()
    for k in got:
        assert tuple(got[k].spec) == tuple(dict(paths(pout[1]))[k].spec), k
        _close(gather(got[k]).numpy(), want[k])


def test_seq_sharded_prefill_layouts_as_without():
    """The prefill's and decode's layouts do not depend on
    ``seq_sharding``: the reference's cache logical axes have no ``seq``."""
    cfg = get_arch("hymba_1p5b").reduced()
    for kind, build in (("prefill", tstep.build_prefill_step),
                        ("decode", tstep.build_decode_step)):
        a = build(cfg, ShapeConfig("x", SLOTS, BATCH, kind), _rules(False))
        b = build(cfg, ShapeConfig("x", SLOTS, BATCH, kind), _rules(True))
        assert _specs(a[1:3]) == _specs(b[1:3])


def _specs(t):
    """Every NamedSharding's spec in a nest of tuples and dicts, in
    order."""
    if isinstance(t, (tuple, list)):
        return [x for v in t for x in _specs(v)]
    if isinstance(t, dict):
        return [x for k in sorted(t) for x in _specs(t[k])]
    return [tuple(t.spec)]


def test_remat_keeps_each_positions_rows(monkeypatch):
    """What remat keeps of a layer, its input, is each position's rows:
    (B/4, S/2, d) a position under sequence sharding."""
    cfg = dataclasses.replace(get_arch("granite_3_2b").reduced(),
                              n_layers=1)
    params = tf.init_params(cfg, 0, device="cpu")
    batch = _tokens(cfg, BATCH, SEQ)
    shapes = []
    real = par._block

    def spy(x, *a, **k):
        shapes.append({tuple(b.shape) for b in x.blocks})
        return real(x, *a, **k)
    monkeypatch.setattr(par, "_block", spy)
    rules = _rules()
    pd = place_tree(params, tstep.param_shardings(cfg, rules)[1])
    bd = place_tree(batch, tstep._batch_spec(rules, tstep.input_specs(
        cfg, ShapeConfig("t", SEQ, BATCH, "train"))))
    tstep.sharded_value_and_grad(pd, cfg, bd, rules, remat=True)
    # the forward and the backward's recompute
    assert shapes == [{(BATCH // 4, SEQ // 2, cfg.d_model)}] * 2


@pytest.mark.parametrize("shape", [(4, 2), (8, 1)])
def test_reduce_scatter_shares_no_memory_with_its_inputs(shape):
    """Positions on one device share a block's tensor; the reduce-scatter
    that ends each sublayer under sequence sharding sums a group once and
    hands each position a view of that new sum (a group of one a copy), so
    no result aliases an input that another position still reads."""
    mesh = cpu_mesh(shape)
    g = torch.Generator().manual_seed(5)
    x = torch.randn(8, 6, 4, generator=g)
    s = pl.place(x, mesh, ("data",))            # whole over model: shared
    parts = pl.smap(lambda j, b: b * (j + 1), s, coord="model", out=s.spec)
    out = pl.reduce_scatter(parts, "model", 1)
    m = shape[1]
    ins = {b.untyped_storage().data_ptr() for b in parts.blocks}
    for p, b in enumerate(out.blocks):
        assert b.untyped_storage().data_ptr() not in ins
        i, j = divmod(p, m)
        rows = x[i * 8 // shape[0]:(i + 1) * 8 // shape[0]]
        want = rows * sum(range(1, m + 1))
        torch.testing.assert_close(
            b, want[:, j * 6 // m:(j + 1) * 6 // m], rtol=0, atol=1e-6)
    assert tuple(out.spec) == ("data", "model")
