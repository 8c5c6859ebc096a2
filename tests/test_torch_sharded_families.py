"""The sharded train step of the ``moe``, ``ssm`` and ``hybrid`` families
(expert parallelism, the split SSM) over a (4, 2) ``("data", "model")``
mesh of CPU positions, held against the reference and against the port's
single-device step; the MoE FFN's global capacity and its branch without
expert parallelism; ``all_to_all`` and its gradient.

The reference runs once, in a subprocess with eight host devices, started
by a module fixture while the port-only tests run: its
``build_train_step`` on the ``reduced()`` mamba2_2p7b, hymba_1p5b,
mixtral_8x22b and qwen3_moe_235b (two microbatches of 4 x 64 tokens), and
its ``moe_ffn`` under the rule table on 1,024 tokens whose router favours
expert 0 (so a global capacity drops replicas), on the (4, 2) mesh (4
experts over 4 data rows: expert parallelism) and on an (8, 1) mesh (4
experts do not split over 8 rows: the capacity slots do).

Tolerances (``tests/test_torch_sharded_train.py``'s): loss, grad_norm and
lr within 1e-5 relative; ``mu``, each gradient leaf and the FFN's output
within 1e-5 of the largest magnitude; the updated parameters within 2 lr
everywhere and 1e-6 on all but 0.1% of the elements; drop counts and kept
replicas exactly. The leaves of a model with an SSM (every gradient
passes through the SSD scan) are held to 3e-5 of their largest
(:data:`SSM_REL`): the single-device path differs from itself by up to
1.69e-5 when only the scan's chunk changes (``a_log`` of
``hymba_1p5b@15|3``, chunk 128 against 24: the same sums in another
order; 7.7e-6 on mamba2_2p7b's ``wz`` and 5.5e-6 on its ``ln1``), and the
sharded scan sums over half the heads, the reference's over one head at a
time.
"""
import dataclasses

import numpy as np
import pytest
import torch

from _sharded import (close_rel, cpu_mesh, leaf_close, params_close,
                      start_reference, stop_reference, tree,
                      wait_reference)
from repro_torch.configs import ShapeConfig, get_arch
from repro_torch.core.distributed import make_mesh
from repro_torch.models import convert, moe
from repro_torch.models import parallel as par
from repro_torch.models import parallel_moe as pmoe
from repro_torch.models import transformer as tf
from repro_torch.sharding import (MeshRules, NamedSharding, gather, place,
                                  place_tree)
from repro_torch.sharding import placement as pl
from repro_torch.sharding.rules import logical_to_spec
from repro_torch.train import optimizer as topt
from repro_torch.train import step as tstep
from repro_torch.utils.tree import leaves, paths

ARCHS = ("mamba2_2p7b", "hymba_1p5b", "mixtral_8x22b", "qwen3_moe_235b")
SEQ, BATCH, MICRO = 64, 8, 2
CAP_B, CAP_S = 8, 128          # 1,024 tokens in one dispatch chunk
SSM_REL = 3e-5                 # a model with an SSM (module docstring)


def _rel(cfg) -> float:
    return SSM_REL if cfg.has_ssm else 1e-5

_REF = r'''
import dataclasses, math, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import NamedSharding
from repro.utils.compat import make_auto_mesh
from repro.configs.base import get_arch, ShapeConfig
from repro.sharding import MeshRules, constrain, logical_to_spec, use_rules
from repro.train.step import build_train_step
from repro.train.optimizer import adamw_init
from repro.models import transformer as tf
from repro.models import moe as rmoe

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
    batch = {{"tokens": rng.integers(0, cfg.vocab, ({BATCH}, {SEQ})
                                    ).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, ({BATCH}, {SEQ})
                                    ).astype(np.int32)}}
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

# one MoE FFN over {CAP_B} x {CAP_S} tokens, the router favouring expert 0
cfg = dataclasses.replace(get_arch("mixtral_8x22b").reduced(), n_layers=1)
params = tf.init_params(cfg, jax.random.PRNGKey(1))
p = {{k: v[0] for k, v in params["blocks"]["moe"].items()}}
p["router"] = p["router"].at[0, 0].add(5.0)
rng = np.random.default_rng(1)
x = rng.normal(0, 1, ({CAP_B}, {CAP_S}, cfg.d_model)).astype(np.float32)
x[..., 0] += 3.0
out["cap/x"] = x
pack("cap/p", p)
# the routing rule of the reference's _moe_chunk: each replica's rank among
# its expert's replicas in token-major order, kept below the capacity
k, e = cfg.top_k, cfg.n_experts
xf = jnp.asarray(x.reshape(-1, cfg.d_model))
_, eidx = jax.lax.top_k(jax.nn.softmax(xf @ p["router"], axis=-1), k)
flat_e = eidx.reshape(-1).astype(jnp.int32)
order = jnp.argsort(flat_e, stable=True)
counts = jnp.bincount(flat_e, length=e)
starts = jnp.cumsum(counts) - counts
sorted_rank = jnp.arange(flat_e.shape[0]) - starts[flat_e[order]]
rank = jnp.zeros_like(sorted_rank).at[order].set(sorted_rank)
t = xf.shape[0]
cap = max(128, min(int(math.ceil(t * k * 1.25 / e / 128.0)) * 128, t))
out["cap/keep"] = np.asarray(rank < cap)
out["cap/counts"] = np.asarray(counts)
out["cap/cap"] = np.asarray(cap)
for tag, mshape in (("ep", (4, 2)), ("noep", (8, 1))):
    m = make_auto_mesh(mshape, ("data", "model"))
    rules = MeshRules(mesh=m)
    lg = {{n: v[1:] for n, v in rmoe.moe_logical(cfg).items()}}
    psh = {{n: NamedSharding(m, logical_to_spec(rules, lg[n], p[n].shape))
           for n in p}}
    xsh = NamedSharding(m, logical_to_spec(rules, ("batch", None, None),
                                           x.shape))

    def ffn(x, p):
        with use_rules(rules):
            return rmoe.moe_ffn(x, p, cfg, constrain)
    with m:
        y = jax.jit(ffn, in_shardings=(xsh, psh))(
            jax.device_put(x, xsh),
            {{n: jax.device_put(v, psh[n]) for n, v in p.items()}})
    out["cap/y_" + tag] = np.asarray(y)
np.savez(sys.argv[1], **out)
print("REF-OK")
'''


@pytest.fixture(scope="module", autouse=True)
def ref_run(tmp_path_factory):
    """Starts the reference subprocess with the module's first test; the
    tests that read it wait in ``ref``, the port-only tests (first in the
    file) run meanwhile."""
    d = tmp_path_factory.mktemp("sharded_families_ref")
    proc, logs = start_reference(_REF, d, ARCHS=ARCHS, SEQ=SEQ,
                                 BATCH=BATCH, MICRO=MICRO, CAP_B=CAP_B,
                                 CAP_S=CAP_S)
    yield proc, d
    stop_reference(proc, logs)


@pytest.fixture(scope="module")
def ref(ref_run):
    return wait_reference(*ref_run)


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    return {k: torch.from_numpy(rng.integers(0, cfg.vocab, (BATCH, SEQ))
                                .astype(np.int32))
            for k in ("tokens", "labels")}


def _setup(cfg, params, batch, mesh=None, microbatches=MICRO):
    """The sharded step of ``cfg`` and its placed (params, opt, batch)."""
    rules = MeshRules(mesh or cpu_mesh())
    shape = ShapeConfig("t", SEQ, BATCH, "train")
    step, in_sh, _, _ = tstep.build_train_step(cfg, shape, rules,
                                               microbatches=microbatches)
    pd = place_tree(params, in_sh[0])
    return step, rules, pd, tstep.sharded_adamw_init(pd), place_tree(
        batch, in_sh[2])


def _config(name):
    """A family config by test id: the reduced configs, and hymba_1p5b
    with 5 query heads over 1 kv head (a 2 | 3 split over ``model``) and
    with 15 over 3 (7 | 8: the positions' kv groups uneven)."""
    arch, _, heads = name.partition("@")
    cfg = get_arch(arch).reduced()
    if heads:
        hq, hkv = (int(h) for h in heads.split("|"))
        cfg = dataclasses.replace(cfg, n_heads=hq, n_kv_heads=hkv)
    return cfg


# ------------------------------------------------------------ all_to_all
def test_all_to_all_matches_numpy():
    """Chunk i of the position at coordinate j goes to coordinate i,
    concatenated in mesh order: against numpy on a (4, 2) mesh, over
    ``data`` and over ``model``."""
    mesh = cpu_mesh()
    x = np.arange(4 * 2 * 8 * 6, dtype=np.float32).reshape(4, 2, 8, 6)
    s = place(x, mesh, ("data", "model"))        # block (1, 1, 8, 6)
    got = pl.all_to_all(s, "data", 2, 0)         # (4, 1, 2, 6)
    for p, (i, j) in enumerate(np.ndindex(4, 2)):
        want = x[:, j, 2 * i:2 * i + 2][:, None]
        np.testing.assert_array_equal(got.blocks[p].numpy(), want)
    got = pl.all_to_all(s, "model", 3, 1)        # (1, 2, 8, 3)
    for p, (i, j) in enumerate(np.ndindex(4, 2)):
        want = x[i, :, :, 3 * j:3 * j + 3][None]
        np.testing.assert_array_equal(got.blocks[p].numpy(), want)
    with pytest.raises(ValueError, match="does not split"):
        pl.all_to_all(place(x[:, :, :7], mesh, ("data", "model")), "data",
                      2, 0)


def test_all_to_all_gradient_is_the_reverse_all_to_all():
    """The gradient of a sum weighted by ``w`` through ``all_to_all``
    equals the reverse ``all_to_all`` of ``w``, and the numpy
    derivative."""
    mesh = cpu_mesh()
    g = torch.Generator().manual_seed(0)
    x = torch.randn(4, 8, 6, generator=g)
    w = torch.randn(4, 4, 2, 6, generator=g)
    xs = place(x, mesh, ("data",))               # block (1, 8, 6)
    leaves_ = [b for _, b in pl.unique_blocks(xs)]
    for b in leaves_:
        b.requires_grad_(True)
    out = pl.all_to_all(xs, "data", 1, 0)        # block (4, 2, 6)
    loss = sum((out.blocks[2 * i] * w[i]).sum() for i in range(4))
    grads = torch.autograd.grad(loss, leaves_)
    ws = pl.Sharded(None, None, mesh, [w[i] for i, _ in np.ndindex(4, 2)])
    back = pl.all_to_all(ws, "data", 0, 1)       # block (1, 8, 6)
    for j in range(4):
        want = np.concatenate([w[i, j].numpy() for i in range(4)], 0)
        np.testing.assert_allclose(grads[j][0].numpy(), want, rtol=0,
                                   atol=0)
        np.testing.assert_array_equal(back.blocks[2 * j][0].numpy(), want)


# ------------------------------------------ the steps, against one device
@pytest.mark.parametrize("name", ARCHS + ("hymba_1p5b@5|1",
                                          "hymba_1p5b@15|3"))
def test_family_step_matches_single_device(name):
    cfg = _config(name)
    params = tf.init_params(cfg, 0, device="cpu")
    batch = _batch(cfg)
    step, rules, pd, opt, bd = _setup(cfg, params, batch)
    for i in range(MICRO):
        rows = slice(i * BATCH // MICRO, (i + 1) * BATCH // MICRO)
        part = {k: v[rows] for k, v in batch.items()}
        loss1, g1 = tstep.sharded_value_and_grad(
            pd, cfg, place_tree(part, {k: NamedSharding(
                rules.mesh, ("data",)) for k in part}), rules)
        loss0, g0 = tstep.value_and_grad(params, cfg, part)
        close_rel(float(gather(loss1)), float(loss0))
        for a, b in zip(leaves(g1), g0):
            leaf_close(gather(a).numpy(), b.numpy(), _rel(cfg))
    new, opt, m = step(pd, opt, bd)
    p0, _, m0 = tstep.train_step(params, topt.adamw_init(params), batch,
                                 cfg, microbatches=MICRO)
    for k in ("loss", "grad_norm", "lr"):
        close_rel(float(gather(m[k])), float(m0[k]))
    params_close([gather(v).numpy() for v in leaves(new)],
                 [v.numpy() for v in leaves(p0)], float(m0["lr"]))


def test_ssd_scan_runs_on_each_positions_heads(monkeypatch):
    """B9 runs once a layer per position, on the position's 4 of 8 heads
    with the whole B and C; a per-position gated norm is a different
    model (the one-device loss differs from it)."""
    cfg = get_arch("mamba2_2p7b").reduced()
    seen = []
    real = par.pssm.kssd.ssd_scan

    def spy(x, dt, a, b, c, *rest, **kw):
        seen.append((tuple(x.shape), tuple(b.shape), tuple(a.shape)))
        return real(x, dt, a, b, c, *rest, **kw)
    monkeypatch.setattr(par.pssm.kssd, "ssd_scan", spy)
    params = tf.init_params(cfg, 0, device="cpu")
    batch = _batch(cfg)
    rules = MeshRules(cpu_mesh())
    pd = place_tree(params, tstep.param_shardings(cfg, rules)[1])
    bd = place_tree(batch, {k: NamedSharding(rules.mesh, ("data",))
                            for k in batch})
    loss = float(gather(par.loss_fn(pd, cfg, bd, rules, remat=False)))
    assert seen == [((2, SEQ, 4, 16), (2, SEQ, 16), (4,))] * (
        8 * cfg.n_layers)
    close_rel(loss, float(tf.loss_fn(params, cfg, batch, remat=False)))

    # the same mixer with each position normalising its own half alone
    def _own_norm(g, ss, w, cfg_, plan, like):
        def local(g, ss, nw, ow):
            y = g.float() * torch.rsqrt(ss / (cfg_.d_inner / plan.m) + 1e-6)
            return (y * nw.float()).to(g.dtype) @ ow
        return par._reduced(pl.smap(local, g, ss, w["norm"], w["out"]),
                            like, plan)
    monkeypatch.setattr(par.pssm, "_gated_out", _own_norm)
    other = float(gather(par.loss_fn(pd, cfg, bd, rules, remat=False)))
    assert abs(other - loss) > 1e-4


# ---------------------------------------------- the steps, against the ref
@pytest.mark.parametrize("arch", ARCHS)
def test_family_step_matches_reference(ref, arch):
    cfg = get_arch(arch).reduced()
    params = convert.params_from_reference(cfg, tree(ref, arch + "/params"),
                                           device="cpu")
    batch = {k: torch.from_numpy(v)
             for k, v in tree(ref, arch + "/batch").items()}
    step, _, pd, opt, bd = _setup(cfg, params, batch)
    new, opt, m = step(pd, opt, bd)
    rm = tree(ref, arch + "/metrics")
    for k in ("loss", "grad_norm", "lr"):
        close_rel(float(gather(m[k])), float(rm[k]))
    rmu = dict(paths(tree(ref, arch + "/mu")))
    for k, v in paths(opt["mu"]):
        leaf_close(gather(v).numpy(), rmu[k], _rel(cfg))
    rnew = dict(paths(tree(ref, arch + "/new")))
    got = [(gather(v).numpy(), rnew[k]) for k, v in paths(new)]
    params_close([a for a, _ in got], [b for _, b in got], float(rm["lr"]))


# ------------------------------------------------ the MoE FFN's capacity
def _moe_inputs(ref, mesh):
    """The capacity case on ``mesh``: cfg, plan, the placed tokens and
    layer weights, and the same unplaced."""
    cfg = dataclasses.replace(get_arch("mixtral_8x22b").reduced(),
                              n_layers=1)
    rules = MeshRules(mesh)
    x = torch.from_numpy(ref["cap/x"])
    p = {k: torch.from_numpy(v) for k, v in tree(ref, "cap/p").items()}
    lg = {k: v[1:] for k, v in moe.moe_logical(cfg).items()}
    pd = {k: place(v, mesh, logical_to_spec(rules, lg[k], tuple(v.shape)))
          for k, v in p.items()}
    xd = place(x, mesh, logical_to_spec(rules, ("batch", None, None),
                                        tuple(x.shape)))
    return cfg, rules, par.Plan.of(rules), xd, pd, x, p


def test_moe_capacity_is_global(ref):
    """1,024 tokens, expert 0 favoured: the port drops the reference's
    replicas (the last data rows' tokens in global order), its output
    equals the reference's and one device's; a capacity counted per data
    row would keep every replica."""
    cfg, rules, plan, xd, pd, x, p = _moe_inputs(ref, cpu_mesh())
    assert pmoe.expert_parallel(cfg, rules)
    moe.stats.reset()
    y = pmoe.moe_ffn(xd, pd, cfg, plan)
    st = moe.stats.read()
    cap, counts = int(ref["cap/cap"]), ref["cap/counts"]
    dropped = int(np.maximum(counts - cap, 0).sum())
    assert dropped > 0 and st["dropped"] == dropped and st["calls"] == 1
    assert st["max_load"] == int(counts.max())
    leaf_close(gather(y).numpy(), ref["cap/y_ep"])
    leaf_close(gather(y).numpy(), moe.moe_ffn(x, p, cfg).numpy())
    (eidx, _, _, keep, *_), _, got_cap = pmoe.routing(
        xd, par._fsdp(pd["router"], 0), cfg, plan)
    assert got_cap == cap
    keep = np.concatenate([keep.blocks[2 * i].numpy() for i in range(4)])
    np.testing.assert_array_equal(keep, ref["cap/keep"])
    # the dropped replicas: expert 0's from token `cap` on, in global order
    flat_e = np.concatenate([eidx.blocks[2 * i].numpy().reshape(-1)
                             for i in range(4)])
    tok = np.arange(flat_e.size) // cfg.top_k
    assert np.array_equal(np.flatnonzero(~keep),
                          np.flatnonzero((flat_e == 0) & (tok >= cap)))
    # a capacity counted on each data row's tokens alone keeps them all
    per_row = [moe.route(x[2 * i:2 * i + 2].reshape(-1, cfg.d_model),
                         p["router"], cfg.top_k) for i in range(4)]
    assert all(bool(r.keep.all()) for r in per_row)
    assert not np.array_equal(np.concatenate(
        [r.keep.numpy() for r in per_row]), keep)


def test_moe_without_expert_parallelism(ref):
    """4 experts over 8 data rows: the experts stay whole, their weights
    FSDP-sharded on ``w_embed``, each row holds 1/8 of the capacity slots
    of every expert; the output equals the reference's on the same (8, 1)
    mesh, and the step equals one device's."""
    mesh = cpu_mesh((8, 1))
    cfg, rules, plan, xd, pd, x, p = _moe_inputs(ref, mesh)
    assert not pmoe.expert_parallel(cfg, rules)
    assert tuple(pd["wu"].spec) == (None, "data")
    moe.stats.reset()
    y = pmoe.moe_ffn(xd, pd, cfg, plan)
    assert moe.stats.read()["dropped"] == int(np.maximum(
        ref["cap/counts"] - int(ref["cap/cap"]), 0).sum())
    leaf_close(gather(y).numpy(), ref["cap/y_noep"])
    cfg = get_arch("mixtral_8x22b").reduced()
    params = tf.init_params(cfg, 3, device="cpu")
    batch = _batch(cfg, seed=3)
    step, rules, pd, opt, bd = _setup(cfg, params, batch, mesh=mesh,
                                      microbatches=1)
    new, _, m = step(pd, opt, bd)
    p0, _, m0 = tstep.train_step(params, topt.adamw_init(params), batch,
                                 cfg)
    close_rel(float(gather(m["loss"])), float(m0["loss"]))
    params_close([gather(v).numpy() for v in leaves(new)],
                 [v.numpy() for v in leaves(p0)], float(m0["lr"]))


# ------------------------------------------------- sequence sharding
@pytest.mark.parametrize("arch", ARCHS)
def test_families_refuse_sequence_sharding(arch):
    """No family refuses ``MeshRules(seq_sharding=True)``: the train step
    and the prefill run and equal the same steps without it (the step's
    loss, grad_norm and parameters; the prefill's logits and cache)."""
    cfg = get_arch(arch).reduced()
    params = tf.init_params(cfg, 0, device="cpu")
    batch = _batch(cfg)
    runs = []
    for seq in (False, True):
        rules = MeshRules(cpu_mesh(), seq_sharding=seq)
        step, in_sh, _, _ = tstep.build_train_step(
            cfg, ShapeConfig("t", SEQ, BATCH, "train"), rules,
            microbatches=MICRO)
        pd = place_tree(params, in_sh[0])
        pf, pin, _, _ = tstep.build_prefill_step(
            cfg, ShapeConfig("p", SEQ, BATCH, "prefill"), rules)
        lg, cache = pf(pd, place_tree({"tokens": batch["tokens"]}, pin[1]))
        new, _, m = step(pd, tstep.sharded_adamw_init(pd),
                         place_tree(batch, in_sh[2]))
        runs.append((new, m, gather(lg).numpy(),
                     {k: gather(v).numpy() for k, v in paths(cache)}))
    (p0, m0, l0, c0), (p1, m1, l1, c1) = runs
    for k in ("loss", "grad_norm", "lr"):
        close_rel(float(gather(m1[k])), float(gather(m0[k])))
    params_close([gather(v).numpy() for v in leaves(p1)],
                 [gather(v).numpy() for v in leaves(p0)],
                 float(gather(m0["lr"])))
    leaf_close(l1, l0)
    assert c1.keys() == c0.keys()
    for k in c0:
        leaf_close(c1[k], c0[k])


def test_moe_refuses_what_it_cannot_split():
    """Experts over an axis other than the batch's, and a capacity that
    does not split over the data rows when the experts do not."""
    cfg = get_arch("mixtral_8x22b").reduced()
    with pytest.raises(NotImplementedError, match="batch axes only"):
        tstep.build_train_step(cfg, ShapeConfig("t", SEQ, BATCH, "train"),
                               MeshRules(cpu_mesh(), expert_axis="model"),
                               microbatches=MICRO)
    # 3 experts over 6 data rows of 20 tokens: no expert parallelism, and
    # the capacity of 128 does not split over 6 rows either
    cfg = dataclasses.replace(cfg, n_layers=1, n_experts=3)
    mesh = make_mesh((6, 1), ("data", "model"), ["cpu"] * 6)
    rules = MeshRules(mesh)
    plan = par.Plan.of(rules)
    x = place(torch.zeros(6, 20, cfg.d_model), mesh, ("data",))
    p = {k: place(v[0], mesh, logical_to_spec(
        rules, moe.moe_logical(cfg)[k][1:], tuple(v.shape[1:])))
        for k, v in tf.init_params(cfg, 0, device="cpu")["blocks"][
            "moe"].items()}
    assert not pmoe.expert_parallel(cfg, rules)
    with pytest.raises(NotImplementedError, match="capacity 128"):
        pmoe.moe_ffn(x, p, cfg, plan)
