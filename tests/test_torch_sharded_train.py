"""The sharded train step (FSDP + TP over a (4, 2) ``("data", "model")``
mesh), ``gpipe``, the int8 gradient compression and the elastic restore,
held against the reference and against the port's single-device step.

The reference runs once, in a subprocess with eight host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=8``), started by a
module fixture while the port-only tests run: its ``build_train_step`` on
the ``reduced()`` granite_3_2b (vocab 256, which splits over ``model``;
two microbatches), granite_34b (one kv head, an untied head) and
qwen2_vl_2b (embeddings and M-RoPE positions), as
``tests/test_distributed.py`` runs it; ``gpipe`` as
``tests/test_pipeline.py``; ``compressed_psum_mean`` and
``apply_error_feedback`` as ``tests/test_distributed.py``; and a
``ckpt.save`` of a (4, 2)-sharded tree. The port runs on a mesh of eight
CPU positions.

Tolerances: loss, grad_norm and lr within 1e-5 relative; ``mu`` and each
gradient leaf within 1e-5 of the leaf's largest magnitude; the updated
parameters within 2 lr absolute everywhere and within 1e-6 on all but
0.1% of the elements (an Adam step's sign can flip where a gradient is
near 0: the first step moves each element by about lr); ``gpipe`` within
1e-5; the compression and the restored checkpoint bit for bit.
"""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.configs import ShapeConfig, get_arch
from repro_torch.core.distributed import make_mesh
from repro_torch.models import convert
from repro_torch.models import transformer as tf
from repro_torch.sharding import (MeshRules, NamedSharding, gather,
                                  gather_tree, place, place_tree)
from repro_torch.sharding import placement as pl
from repro_torch.sharding.pipeline import bubble_fraction, gpipe
from repro_torch.train import compress
from repro_torch.train import optimizer as topt
from repro_torch.train import step as tstep
from repro_torch.utils.tree import leaves, paths, unflatten

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCHS = ("granite_3_2b", "granite_34b", "qwen2_vl_2b")
SEQ, BATCH, MICRO = 64, 8, 2
WAIT_S = 600

_REF = r'''
import json, sys, tempfile
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.utils.compat import make_auto_mesh, shard_map
from repro.configs.base import get_arch, ShapeConfig
from repro.sharding import MeshRules
from repro.sharding.pipeline import gpipe
from repro.train.step import build_train_step
from repro.train.optimizer import adamw_init
from repro.train.compress import apply_error_feedback, compressed_psum_mean
from repro.models import transformer as tf
from repro.ckpt import checkpoint as ckpt

out = {{}}

def pack(prefix, tree):
    for pp, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                       for p in pp)
        out[prefix + "/" + key] = np.asarray(leaf)

mesh = make_auto_mesh((4, 2), ("data", "model"))
for arch in {ARCHS!r}:
    cfg = get_arch(arch).reduced()
    shape = ShapeConfig("t", {SEQ}, {BATCH}, "train")
    step, in_sh, out_sh, specs = build_train_step(
        cfg, shape, MeshRules(mesh=mesh), microbatches={MICRO})
    params = tf.init_params(cfg, jax.random.PRNGKey(0))
    opt = adamw_init(params)
    rng = np.random.default_rng(0)
    if cfg.frontend == "embed_stub":
        batch = {{"embeds": rng.normal(0, 1, ({BATCH}, {SEQ}, cfg.d_model)
                                      ).astype(np.float32)}}
        if cfg.mrope:
            batch["positions"] = rng.integers(
                0, {SEQ}, ({BATCH}, 3, {SEQ})).astype(np.int32)
    else:
        batch = {{"tokens": rng.integers(0, cfg.vocab, ({BATCH}, {SEQ})
                                        ).astype(np.int32)}}
    batch["labels"] = rng.integers(0, cfg.vocab, ({BATCH}, {SEQ})
                                   ).astype(np.int32)
    with mesh:
        p_d = jax.tree_util.tree_map(jax.device_put, params, in_sh[0])
        o_d = jax.tree_util.tree_map(jax.device_put, opt, in_sh[1])
        b_d = {{k: jax.device_put(v, in_sh[2][k]) for k, v in batch.items()}}
        fn = jax.jit(step, in_shardings=in_sh, out_shardings=out_sh)
        p2, o2, m = fn(p_d, o_d, b_d)
    pack(arch + "/params", params)
    pack(arch + "/batch", batch)
    pack(arch + "/new", p2)
    pack(arch + "/mu", o2["mu"])
    pack(arch + "/metrics", m)

pmesh = make_auto_mesh((4,), ("pod",))
S, M, D = 4, 8, 32
rng = np.random.default_rng(0)
ws = jnp.asarray(rng.normal(0, 0.3, (S, D, D)), jnp.float32)
bs = jnp.asarray(rng.normal(0, 0.1, (S, D)), jnp.float32)
xs = jnp.asarray(rng.normal(0, 1, (M, 16, D)), jnp.float32)

def stage(params, x):
    w, b = params
    return jnp.tanh(x @ w + b)

with pmesh:
    ys = jax.jit(gpipe(stage, pmesh, "pod"))((ws, bs), xs)
out["gpipe/ws"], out["gpipe/bs"] = np.asarray(ws), np.asarray(bs)
out["gpipe/xs"], out["gpipe/ys"] = np.asarray(xs), np.asarray(ys)

dmesh = make_auto_mesh((8,), ("data",))
gs = np.random.default_rng(0).normal(0, 1, (8, 256)).astype(np.float32)
out["compress/gs"] = gs
out["compress/mean"] = np.asarray(jax.jit(shard_map(
    lambda g: compressed_psum_mean(g, "data"), dmesh, P("data"),
    P("data")))(gs))
g = np.tile(np.linspace(-1, 1, 64, dtype=np.float32), (8, 1))
g[3] *= -0.5                                   # ranks that differ
e = np.zeros_like(g)
ef = jax.jit(shard_map(lambda g, e: apply_error_feedback(g, e, "data"),
                       dmesh, (P("data"), P("data")), (P("data"), P("data"))))
avgs, errs = [], []
for _ in range(20):
    avg, e = ef(g, e)
    avgs.append(np.asarray(avg))
    errs.append(np.asarray(e))
out["compress/ef_g"] = g
out["compress/ef_avg"] = np.stack(avgs)
out["compress/ef_err"] = np.stack(errs)

tree = {{"w": np.arange(64, dtype=np.float32).reshape(8, 8),
        "b": np.ones(16, np.float32)}}
sh = {{"w": NamedSharding(mesh, P("data", "model")),
      "b": NamedSharding(mesh, P("data"))}}
ckpt.save(sys.argv[2], 7, {{k: jax.device_put(v, sh[k])
                           for k, v in tree.items()}})
np.savez(sys.argv[1], **out)
print("REF-OK")
'''


@pytest.fixture(scope="module", autouse=True)
def ref_run(tmp_path_factory):
    """Starts the reference subprocess with the module's first test; the
    tests that read it wait in ``ref``, the port-only tests (first in the
    file) run meanwhile."""
    d = tmp_path_factory.mktemp("sharded_train_ref")
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = str(ROOT / "src")
    code = textwrap.dedent(_REF).format(ARCHS=ARCHS, SEQ=SEQ, BATCH=BATCH,
                                        MICRO=MICRO)
    logs = [open(d / "stdout.txt", "w"), open(d / "stderr.txt", "w")]
    proc = subprocess.Popen([sys.executable, "-c", code, str(d / "ref.npz"),
                             str(d / "ckpt")], env=env, stdout=logs[0],
                            stderr=logs[1], cwd=str(ROOT))
    yield proc, d
    if proc.poll() is None:
        proc.kill()
        proc.wait()
    for f in logs:
        f.close()


@pytest.fixture(scope="module")
def ref(ref_run):
    proc, d = ref_run
    rc = proc.wait(timeout=WAIT_S)
    err = (d / "stderr.txt").read_text()[-4000:]
    assert rc == 0, f"reference subprocess failed:\n{err}"
    with np.load(d / "ref.npz") as z:
        data = {k: z[k] for k in z.files}
    data["ckpt_dir"] = str(d / "ckpt")
    return data


def _tree(data, prefix):
    """The arrays under ``prefix/`` as a nested dict."""
    out = {}
    for k, v in data.items():
        if k.startswith(prefix + "/"):
            node = out
            parts = k[len(prefix) + 1:].split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = v
    return out


def _mesh(shape=(4, 2), axes=("data", "model")):
    return make_mesh(shape, axes, ["cpu"] * 8)


def _batch(cfg, seed=0):
    """The reference subprocess's batch for ``cfg``, drawn the same way."""
    rng = np.random.default_rng(seed)
    if cfg.frontend == "embed_stub":
        batch = {"embeds": rng.normal(0, 1, (BATCH, SEQ, cfg.d_model)
                                      ).astype(np.float32)}
        if cfg.mrope:
            batch["positions"] = rng.integers(0, SEQ, (BATCH, 3, SEQ)
                                              ).astype(np.int32)
    else:
        batch = {"tokens": rng.integers(0, cfg.vocab, (BATCH, SEQ)
                                        ).astype(np.int32)}
    batch["labels"] = rng.integers(0, cfg.vocab, (BATCH, SEQ)
                                   ).astype(np.int32)
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _setup(cfg, params, batch, mesh=None, microbatches=MICRO):
    """The sharded step of ``cfg`` and its placed (params, opt, batch)."""
    rules = MeshRules(mesh or _mesh())
    shape = ShapeConfig("t", SEQ, BATCH, "train")
    step, in_sh, out_sh, _ = tstep.build_train_step(
        cfg, shape, rules, microbatches=microbatches)
    pd = place_tree(params, in_sh[0])
    return step, rules, pd, tstep.sharded_adamw_init(pd), place_tree(
        batch, in_sh[2])


def _close_rel(got, want, rel=1e-5):
    assert abs(got - want) <= rel * max(abs(want), 1e-30), (got, want)


def _leaf_close(got, want, rel=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= rel * scale, (
        np.abs(got - want).max() / scale)


def _params_close(got, want, lr):
    """Within 2 lr everywhere and 1e-6 on all but 0.1% of elements.
    Returns the count past 1e-6."""
    loose = n = 0
    for a, b in zip(got, want):
        d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
        assert d.max() <= 2 * lr, d.max()
        loose += int((d > 1e-6).sum())
        n += d.size
    assert loose <= 1e-3 * n, (loose, n)
    return loose


# ------------------------------------------ the step, against one device
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_step_matches_single_device(arch):
    cfg = get_arch(arch).reduced()
    params = tf.init_params(cfg, 0, device="cpu")
    batch = _batch(cfg)
    step, rules, pd, opt, bd = _setup(cfg, params, batch)
    # each microbatch's gradient, leaf for leaf
    for i in range(MICRO):
        rows = slice(i * BATCH // MICRO, (i + 1) * BATCH // MICRO)
        part = {k: v[rows] for k, v in batch.items()}
        loss1, g1 = tstep.sharded_value_and_grad(
            pd, cfg, place_tree(part, {k: NamedSharding(
                rules.mesh, ("data",)) for k in part}), rules)
        loss0, g0 = tstep.value_and_grad(params, cfg, part)
        _close_rel(float(gather(loss1)), float(loss0))
        for a, b in zip(leaves(g1), g0):
            _leaf_close(gather(a).numpy(), b.numpy())
    new, opt, m = step(pd, opt, bd)
    p0, _, m0 = tstep.train_step(params, topt.adamw_init(params), batch,
                                 cfg, microbatches=MICRO)
    for k in ("loss", "grad_norm", "lr"):
        _close_rel(float(gather(m[k])), float(m0[k]))
    _params_close([gather(v).numpy() for v in leaves(new)],
                  [v.numpy() for v in leaves(p0)], float(m0["lr"]))


def test_masked_labels_global_mean():
    """Labels of -1 masked unevenly over the rows (whole rows, half rows,
    none): the loss is the batch's masked mean, not a mean of the data
    rows' means."""
    cfg = get_arch("granite_3_2b").reduced()
    params = tf.init_params(cfg, 1, device="cpu")
    batch = _batch(cfg, seed=4)
    lab = batch["labels"].clone()
    lab[0] = -1
    lab[1, : SEQ // 2] = -1
    lab[2, ::3] = -1
    lab[5, 1:] = -1
    batch["labels"] = lab
    rules = MeshRules(_mesh())
    bd = place_tree(batch, {k: NamedSharding(rules.mesh, ("data",))
                            for k in batch})
    pd = place_tree(params, tstep.param_shardings(cfg, rules)[1])
    loss1, g1 = tstep.sharded_value_and_grad(pd, cfg, bd, rules)
    loss0, g0 = tstep.value_and_grad(params, cfg, batch)
    _close_rel(float(gather(loss1)), float(loss0))
    for a, b in zip(leaves(g1), g0):
        _leaf_close(gather(a).numpy(), b.numpy())
    # a mean of the four data rows' means is another number
    rows = [tstep.value_and_grad(params, cfg, {k: v[2 * r:2 * r + 2]
                                               for k, v in batch.items()})[0]
            for r in range(4)]
    assert abs(float(sum(rows)) / 4 - float(loss0)) > 1e-3


def test_replicas_on_separate_tensors():
    """Every position holding its own copy of its blocks (as on a mesh of
    several devices): the replicas' gradients are summed and each copy
    takes the same update, so the step equals the shared one."""
    cfg = get_arch("granite_34b").reduced()
    params = tf.init_params(cfg, 2, device="cpu")
    batch = _batch(cfg, seed=2)
    step, rules, pd, opt, bd = _setup(cfg, params, batch, microbatches=1)
    apart = unflatten(pd, [pl.Sharded(s.shape, s.spec, s.mesh,
                                      [b.clone() for b in s.blocks])
                           for s in leaves(pd)])
    opt2 = tstep.sharded_adamw_init(apart)
    _, g_shared = tstep.sharded_value_and_grad(pd, cfg, bd, rules)
    _, g_apart = tstep.sharded_value_and_grad(apart, cfg, bd, rules)
    for a, b in zip(leaves(g_apart), leaves(g_shared)):
        _same_replicas(a)
        torch.testing.assert_close(gather(a), gather(b), rtol=1e-6,
                                   atol=1e-7)
    p1, _, m1 = step(pd, opt, bd)
    p2, _, m2 = step(apart, opt2, bd)
    _close_rel(float(gather(m2["grad_norm"])), float(gather(m1["grad_norm"])))
    for a, b in zip(leaves(p2), leaves(p1)):
        _same_replicas(a)
        torch.testing.assert_close(gather(a), gather(b), rtol=0, atol=1e-6)


def _same_replicas(s):
    """Every position holding a block holds the same values."""
    blocks = {}
    for p, x in enumerate(s.blocks):
        key = pl._key(pl.block_slices(s.mesh, s.spec, s.shape, p))
        if key in blocks:
            assert torch.equal(blocks[key], x)
        blocks[key] = x


def test_step_refuses_what_it_cannot_split():
    cfg = get_arch("granite_3_2b").reduced()
    shape = ShapeConfig("t", SEQ, BATCH, "train")
    with pytest.raises(ValueError, match="data positions"):
        tstep.build_train_step(cfg, shape, MeshRules(_mesh()),
                               microbatches=4)


def test_step_splits_the_sequence():
    """``MeshRules(seq_sharding=True)``: the step runs, its residual split
    over ``model`` by rows, and equals the step without it."""
    cfg = get_arch("granite_3_2b").reduced()
    params = tf.init_params(cfg, 0, device="cpu")
    batch = _batch(cfg)
    out = []
    for seq in (False, True):
        rules = MeshRules(_mesh(), seq_sharding=seq)
        step, in_sh, _, _ = tstep.build_train_step(
            cfg, ShapeConfig("t", SEQ, BATCH, "train"), rules,
            microbatches=MICRO)
        pd = place_tree(params, in_sh[0])
        out.append(step(pd, tstep.sharded_adamw_init(pd),
                        place_tree(batch, in_sh[2])))
    (p0, _, m0), (p1, _, m1) = out
    for k in ("loss", "grad_norm", "lr"):
        _close_rel(float(gather(m1[k])), float(gather(m0[k])))
    _params_close([gather(v).numpy() for v in leaves(p1)],
                  [gather(v).numpy() for v in leaves(p0)],
                  float(gather(m0["lr"])))


# ---------------------------------------------- the step, against the ref
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_step_matches_reference(ref, arch):
    cfg = get_arch(arch).reduced()
    params = convert.params_from_reference(cfg, _tree(ref, arch + "/params"),
                                           device="cpu")
    batch = {k: torch.from_numpy(v)
             for k, v in _tree(ref, arch + "/batch").items()}
    step, _, pd, opt, bd = _setup(cfg, params, batch)
    new, opt, m = step(pd, opt, bd)
    rm = _tree(ref, arch + "/metrics")
    for k in ("loss", "grad_norm", "lr"):
        _close_rel(float(gather(m[k])), float(rm[k]))
    rmu = dict(paths(_tree(ref, arch + "/mu")))
    for k, v in paths(opt["mu"]):
        _leaf_close(gather(v).numpy(), rmu[k])
    rnew = dict(paths(_tree(ref, arch + "/new")))
    got = [(gather(v).numpy(), rnew[k]) for k, v in paths(new)]
    _params_close([a for a, _ in got], [b for _, b in got],
                  float(rm["lr"]))


# ------------------------------------------------------------------ gpipe
def _stage(params, x):
    return torch.tanh(x @ params["w"] + params["b"])


def test_gpipe_matches_reference(ref):
    mesh = make_mesh((4,), ("pod",), ["cpu"] * 4)
    ws, bs, xs = (torch.from_numpy(ref[f"gpipe/{k}"]) for k in ("ws", "bs",
                                                                "xs"))
    ys = gather(gpipe(_stage, mesh, "pod")({"w": ws, "b": bs}, xs))
    np.testing.assert_allclose(ys.numpy(), ref["gpipe/ys"], rtol=0,
                               atol=1e-5)
    assert abs(bubble_fraction(4, 8) - 3 / 11) < 1e-9


def test_gpipe_equals_sequential_stages():
    """Zeros and copies only: the pipelined outputs equal the stages run in
    sequence, bit for bit, with the stage parameters placed beforehand
    and on a mesh with a second axis."""
    mesh = make_mesh((4, 2), ("pod", "data"), ["cpu"] * 8)
    g = torch.Generator().manual_seed(3)
    ws = torch.randn(4, 16, 16, generator=g) * 0.3
    bs = torch.randn(4, 16, generator=g) * 0.1
    xs = torch.randn(6, 5, 16, generator=g)
    placed = {"w": place(ws, mesh, ("pod",)), "b": place(bs, mesh, ("pod",))}
    ys = gpipe(lambda p, x: torch.tanh(x @ p["w"] + p["b"]), mesh)(placed,
                                                                  xs)
    ref = xs
    for i in range(4):
        ref = torch.tanh(ref @ ws[i] + bs[i])
    assert torch.equal(gather(ys), ref)
    assert all(torch.equal(b, ref) for b in ys.blocks)


# ------------------------------------------------------------ compression
def test_compression_matches_reference_bit_for_bit(ref):
    mesh = make_mesh((8,), ("data",), ["cpu"] * 8)
    gs = ref["compress/gs"]
    got = gather(compress.compressed_psum_mean(place(gs, mesh, ("data",)),
                                               "data")).numpy()
    np.testing.assert_array_equal(got.view(np.int32),
                                  ref["compress/mean"].view(np.int32))
    assert np.abs(got[0] - gs.mean(0)).max() < np.abs(gs).max() / 127 * 2
    q, scale = compress.quantize(torch.from_numpy(gs[0]))
    assert q.dtype == torch.int8 and int(q.abs().max()) == 127
    back = compress.dequantize(q, scale).numpy()
    assert np.abs(back - gs[0]).max() <= float(scale) / 2 + 1e-7


def test_error_feedback_matches_reference_bit_for_bit(ref):
    mesh = make_mesh((8,), ("data",), ["cpu"] * 8)
    g = place(ref["compress/ef_g"], mesh, ("data",))
    e = place(np.zeros_like(ref["compress/ef_g"]), mesh, ("data",))
    for t in range(20):
        avg, e = compress.apply_error_feedback(g, e, "data")
        np.testing.assert_array_equal(
            gather(avg).numpy().view(np.int32),
            ref["compress/ef_avg"][t].view(np.int32))
        np.testing.assert_array_equal(
            gather(e).numpy().view(np.int32),
            ref["compress/ef_err"][t].view(np.int32))


# --------------------------------------------------------------- restore
def test_restore_reads_the_reference_sharded_checkpoint(ref):
    d = ref["ckpt_dir"]
    want = {"w": torch.arange(64, dtype=torch.float32).reshape(8, 8),
            "b": torch.ones(16)}
    like = {k: (tuple(v.shape), v.dtype) for k, v in want.items()}
    step, one = ckpt.restore(d, like)
    assert step == 7
    for k in want:
        assert torch.equal(one[k], want[k]) and one[k].device.type == "cpu"
    mesh = _mesh()
    sh = {"w": NamedSharding(mesh, ("data", "model")),
          "b": NamedSharding(mesh, ("data",))}
    step, back = ckpt.restore(d, like, shardings=sh)
    assert step == 7
    for k in want:
        assert tuple(back[k].spec) == tuple(sh[k].spec)
        assert torch.equal(gather(back[k]), want[k])
    assert torch.equal(back["w"].blocks[3], want["w"][2:4, 4:])


def test_elastic_save_on_the_mesh_restore_anywhere(tmp_path):
    """A placed state saved from the (4, 2) mesh restores onto one device
    and onto a (2, 4) mesh with every bit."""
    cfg = dataclasses.replace(get_arch("granite_3_2b").reduced(),
                              dtype="bfloat16")
    rules = MeshRules(_mesh())
    params = tf.init_params(cfg, 0, device="cpu")
    shapes, sh = tstep.param_shardings(cfg, rules)
    pd = place_tree(params, sh)
    opt = tstep.sharded_adamw_init(pd)
    tree = {"params": pd, "opt": opt}
    ckpt.save(str(tmp_path), 3, tree)
    like = {"params": shapes, "opt": tstep._opt_shardings(rules, shapes,
                                                         sh)[0]}
    step, one = ckpt.restore(str(tmp_path), like)
    assert step == 3
    for (_, a), b in zip(paths(one["params"]), leaves(params)):
        assert a.dtype == b.dtype and torch.equal(a.view(torch.int16),
                                                  b.view(torch.int16))
    other = MeshRules(make_mesh((2, 4), ("data", "model"), ["cpu"] * 8))
    _, sh2 = tstep.param_shardings(cfg, other)
    _, back = ckpt.restore(str(tmp_path), {"params": shapes},
                           shardings={"params": sh2})
    for a, b in zip(leaves(gather_tree(back["params"])), leaves(params)):
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))
    assert json.loads((tmp_path / "step_000000003" / "manifest.json")
                      .read_text())["leaves"]["params/embed"]["dtype"] \
        == "bfloat16"
