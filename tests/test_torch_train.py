"""The port's training path against the reference on the CPU.

* The loss and every gradient leaf of ``jax.value_and_grad(loss_fn)`` for
  six families at ``reduced()`` size in fp32 (the reference's weights
  carried by ``params_from_reference``; some labels -1): ``granite_3_2b``,
  ``mamba2_2p7b``, ``hymba_1p5b`` (meta tokens), ``mixtral_8x22b`` (seq 64:
  its window of 32 binds), ``qwen2_vl_2b`` (embeddings and (B, 3, S)
  M-RoPE positions) and ``musicgen_medium``, the port with remat on and
  off. Gate: the loss within 1e-5 relative, each leaf's gradient within
  1e-4 of that leaf's largest reference gradient.
* Remat against no remat (equal losses, gradients and MoE counters).
* AdamW and its schedule against the reference's (1e-6 relative); the
  train step with two microbatches against one and against the
  reference's accumulation written out in JAX.
* The loss goes down over 60 steps (the reference's
  ``test_training_reduces_loss``); ``SyntheticLM`` batches equal the
  reference's; the ``Prefetcher``'s order and close.
* The autograd wiring of the two kernels' wrappers with ``_route`` patched
  to True and ``_launch`` to a stand-in that writes the plain version's
  result (the CUDA path as far as the launch): their gradients equal
  autograd of the plain versions, a query-chunked attention backward
  equals the unchunked one, one launch a forward, and a ``grad_fn`` on
  the outputs of inputs that require a gradient.

The reference's value-and-grad is jitted once per family, in a
module-scoped fixture.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")         # the reference needs jax
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
from repro.configs import get_arch as rget  # noqa: E402
from repro.data import pipeline as rpipe  # noqa: E402
from repro.models import transformer as rtf  # noqa: E402
from repro.sharding import constrain  # noqa: E402
from repro.train import optimizer as ropt  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_arch  # noqa: E402
from repro_torch.data import pipeline as tpipe  # noqa: E402
from repro_torch.kernels import attention as katt  # noqa: E402
from repro_torch.kernels import ssd as kssd  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train.step import (input_specs, train_step,  # noqa: E402
                                    value_and_grad)
from repro_torch.utils.tree import paths  # noqa: E402

ARCHS = ("granite_3_2b", "mamba2_2p7b", "hymba_1p5b", "mixtral_8x22b",
         "qwen2_vl_2b", "musicgen_medium")
B = 2
LOSS_REL, GRAD_REL = 1e-5, 1e-4


def make_batch(cfg, s, seed):
    """A numpy train batch: tokens or embeddings (M-RoPE positions on a
    4 x 4 patch grid first under ``cfg.mrope``), labels with -1 in places."""
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.frontend == "embed_stub":
        out["embeds"] = rng.standard_normal((B, s, cfg.d_model)).astype(
            np.float32)
        if cfg.mrope:
            pos = np.broadcast_to(np.arange(s, dtype=np.int32),
                                  (B, 3, s)).copy()
            pos[:, 0, :16] = 0
            pos[:, 1, :16] = np.arange(16) // 4
            pos[:, 2, :16] = np.arange(16) % 4
            out["positions"] = pos
    else:
        out["tokens"] = rng.integers(0, cfg.vocab, (B, s)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, (B, s)).astype(np.int32)
    labels[:, :3] = -1
    labels[1, -5:] = -1
    out["labels"] = labels
    return out


def to_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def to_torch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


def carried(arch, seed=1):
    """(reference cfg, port cfg, reference params, the port's copy)."""
    rcfg, cfg = rget(arch).reduced(), get_arch(arch).reduced()
    rparams = jax.jit(rtf.init_params, static_argnums=0)(
        rcfg, jax.random.PRNGKey(seed))
    params = params_from_reference(
        cfg, jax.tree_util.tree_map(np.asarray, rparams), "cpu")
    return rcfg, cfg, rparams, params


@pytest.fixture(scope="module", params=ARCHS)
def family(request):
    """The reference's loss and gradients on one batch, jitted once."""
    arch = request.param
    rcfg, cfg, rparams, params = carried(arch)
    batch = make_batch(cfg, 64 if arch == "mixtral_8x22b" else 32, 0)
    vg = jax.jit(jax.value_and_grad(
        lambda p, b: rtf.loss_fn(p, rcfg, b, constrain, remat=False)))
    loss, grads = vg(rparams, to_jax(batch))
    return {"cfg": cfg, "params": params, "batch": to_torch(batch),
            "loss": float(loss),
            "grads": dict(paths(jax.tree_util.tree_map(np.asarray, grads)))}


@pytest.mark.parametrize("remat", [True, False])
def test_loss_and_grads_match_reference(family, remat):
    loss, grads = value_and_grad(family["params"], family["cfg"],
                                 family["batch"], remat)
    assert abs(float(loss) - family["loss"]) <= LOSS_REL * family["loss"]
    names = [k for k, _ in paths(family["params"])]
    assert sorted(names) == sorted(family["grads"])
    for name, g in zip(names, grads):
        want = family["grads"][name]
        assert g.shape == want.shape and g.dtype == torch.float32
        scale = float(np.abs(want).max())
        err = float(np.abs(g.numpy() - want).max())
        assert err <= GRAD_REL * scale, (name, err, scale)
    assert not any(p.requires_grad for _, p in paths(family["params"]))


@pytest.mark.parametrize("arch", ["granite_3_2b", "mixtral_8x22b",
                                  "mamba2_2p7b"])
def test_remat_matches_no_remat(arch):
    cfg = get_arch(arch).reduced()
    params = tf.init_params(cfg, 2, device="cpu")
    batch = to_torch(make_batch(cfg, 64, 2))
    out = {}
    for remat in (False, True):
        moe.stats.reset()
        out[remat] = (*value_and_grad(params, cfg, batch, remat),
                      moe.stats.read())
    (l0, g0, s0), (l1, g1, s1) = out[False], out[True]
    assert float(l0) == float(l1)
    for a, b in zip(g0, g1):
        torch.testing.assert_close(a, b, atol=0, rtol=1e-6)
    assert s0 == s1
    if cfg.is_moe:      # one dispatch a layer, counted once under remat
        assert s1["calls"] == cfg.n_layers
        assert s1["replicas"] == cfg.n_layers * B * 64 * cfg.top_k


# ------------------------------------------------------------------ AdamW
def _tree(rng, dtype):
    return {"a": rng.standard_normal((3, 5, 4)).astype(dtype),
            "b": {"c": rng.standard_normal((7,)).astype(dtype),
                  "d": rng.standard_normal((2, 6)).astype(dtype)}}


def _close_rel(got, want, rel):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.abs(got - want).max() <= rel * max(np.abs(want).max(), 1e-30)


@pytest.mark.parametrize("clip", [1.0, 100.0])
def test_adamw_matches_reference(clip):
    """Three updates of an fp32 tree (clipped by its norm, and not)."""
    rng = np.random.default_rng(7)
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=10, grad_clip=clip)
    rcfg, tcfg = ropt.AdamWConfig(**cfg), topt.AdamWConfig(**cfg)
    p0 = _tree(rng, np.float32)
    rp = jax.tree_util.tree_map(jnp.asarray, p0)
    tp = jax.tree_util.tree_map(torch.from_numpy, p0)
    rs, ts = ropt.adamw_init(rp), topt.adamw_init(tp)
    for _ in range(3):
        g = jax.tree_util.tree_map(lambda x: x * 3,
                                   _tree(rng, np.float32))
        rp, rs, rm = ropt.adamw_update(jax.tree_util.tree_map(
            jnp.asarray, g), rs, rp, rcfg)
        tp, ts, tm = topt.adamw_update(jax.tree_util.tree_map(
            torch.from_numpy, g), ts, tp, tcfg)
        for key in ("grad_norm", "lr"):
            _close_rel(tm[key].numpy(), rm[key], 1e-6)
        for tree_t, tree_r in ((tp, rp), (ts["mu"], rs["mu"]),
                               (ts["nu"], rs["nu"])):
            for (_, a), (_, b) in zip(paths(tree_t), paths(
                    jax.tree_util.tree_map(np.asarray, tree_r))):
                _close_rel(a.numpy(), b, 1e-6)
        assert int(ts["step"]) == int(rs["step"])
        assert ts["step"].dtype == torch.int32


@pytest.mark.parametrize("warmup,total", [(100, 10000), (5, 60), (0, 1)])
def test_cosine_schedule_matches_reference(warmup, total):
    rcfg = ropt.AdamWConfig(lr=3e-4, warmup_steps=warmup, total_steps=total)
    tcfg = topt.AdamWConfig(lr=3e-4, warmup_steps=warmup, total_steps=total)
    for step in (0, 1, 3, warmup, warmup + 1, total // 2, total - 1, total,
                 total + 7):
        want = float(ropt.cosine_schedule(rcfg, jnp.asarray(step,
                                                            jnp.int32)))
        got = float(topt.cosine_schedule(
            tcfg, torch.tensor(step, dtype=torch.int32)))
        assert abs(got - want) <= 1e-6 * abs(want) + 1e-12, (step, got, want)


def test_adamw_keeps_bf16_parameters_bf16():
    """No fp32 master copy: bf16 leaves stay bf16, the moments fp32, and
    each new parameter is the fp32 update of the old one rounded once."""
    g = torch.Generator().manual_seed(0)
    p = {"w": torch.randn(4, 3, 5, generator=g).to(torch.bfloat16)}
    grads = {"w": torch.randn(4, 3, 5, generator=g).to(torch.bfloat16)}
    old = p["w"].clone()
    state = topt.adamw_init(p)
    cfg = topt.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=10)
    p2, state, m = topt.adamw_update(grads, state, p, cfg)
    assert p2["w"] is p["w"] and p["w"].dtype == torch.bfloat16
    assert state["mu"]["w"].dtype == torch.float32
    g32 = grads["w"].float() * torch.clamp(1.0 / m["grad_norm"], max=1.0)
    delta = (g32 / (g32.abs() + 1e-8) + 0.1 * old.float())
    want = (old.float() - m["lr"] * delta).to(torch.bfloat16)
    assert torch.equal(p["w"], want)


# -------------------------------------------------------------- train step
def test_train_step_matches_reference_accumulation():
    """Two microbatches: the port's step against the reference's scan body
    written out (value_and_grad per microbatch, g / 2 summed, loss / 2
    summed, one AdamW update), and against one microbatch (each row with
    as many masked labels, so the mean of the two means is the mean)."""
    rcfg, cfg, rparams, params = carried("granite_3_2b", 3)
    batch = make_batch(cfg, 32, 3)
    batch["labels"][0, -5:] = -1
    ocfg = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    rocfg = ropt.AdamWConfig(**ocfg)

    @jax.jit
    def ref_step(p, opt, b):
        vg = jax.value_and_grad(lambda p_, b_: rtf.loss_fn(
            p_, rcfg, b_, constrain, remat=True))
        acc = jax.tree_util.tree_map(jnp.zeros_like, p)
        acc_loss = jnp.zeros((), jnp.float32)
        for i in range(2):
            part = jax.tree_util.tree_map(lambda v: v[i:i + 1], b)
            loss, g = vg(p, part)
            acc = jax.tree_util.tree_map(lambda a, g_: a + g_ / 2, acc, g)
            acc_loss = acc_loss + loss / 2
        p, opt, m = ropt.adamw_update(acc, opt, p, rocfg)
        m["loss"] = acc_loss
        return p, opt, m

    rp, ropt_state, rm = ref_step(rparams, ropt.adamw_init(rparams),
                                  to_jax(batch))
    tb = to_torch(batch)
    one = jax.tree_util.tree_map(lambda t: t.clone(), params)
    tp, ts, tm = train_step(params, topt.adamw_init(params), tb, cfg,
                            topt.AdamWConfig(**ocfg), microbatches=2)
    assert set(tm) == {"loss", "grad_norm", "lr"}
    _close_rel(tm["loss"], rm["loss"], 1e-5)
    _close_rel(tm["grad_norm"], rm["grad_norm"], 1e-5)
    _close_rel(tm["lr"], rm["lr"], 1e-6)
    rmu = dict(paths(jax.tree_util.tree_map(np.asarray, ropt_state["mu"])))
    for name, mu in paths(ts["mu"]):     # mu = 0.1 * clipped grads
        want = rmu[name]
        assert np.abs(mu.numpy() - want).max() <= (
            GRAD_REL * np.abs(want).max())
    _, _, m1 = train_step(one, topt.adamw_init(one), tb, cfg,
                          topt.AdamWConfig(**ocfg), microbatches=1)
    _close_rel(m1["loss"], tm["loss"], 1e-5)
    _close_rel(m1["grad_norm"], tm["grad_norm"], 1e-4)
    with pytest.raises(ValueError, match="microbatches"):
        train_step(one, topt.adamw_init(one), tb, cfg, microbatches=3)


def test_training_reduces_loss():
    """~60 steps on the structured synthetic stream must reduce the loss
    (the reference's own test, through the port)."""
    cfg = get_arch("granite_3_2b").reduced()
    params = tf.init_params(cfg, 4, device="cpu")
    opt = topt.adamw_init(params)
    ocfg = topt.AdamWConfig(lr=2e-3, warmup_steps=5, total_steps=60)
    src = tpipe.SyntheticLM(cfg.vocab, 64, 8, seed=5)
    losses = []
    for i in range(60):
        params, opt, m = train_step(params, opt, to_torch(src.batch_at(i)),
                                    cfg, ocfg, remat=False)
        losses.append(float(m["loss"]))
    assert np.mean(losses[-10:]) < np.mean(losses[:10]) - 0.2, losses[::10]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_match_reference(arch):
    from repro.configs.base import ShapeConfig
    from repro.train.step import input_specs as rspecs

    cfg = get_arch(arch)
    want = rspecs(rget(arch), ShapeConfig("x_train", 8, 4, "train"))
    got = input_specs(cfg, ShapeConfig("x_train", 8, 4, "train"))
    assert sorted(got) == sorted(want)
    for k, (shape, dtype) in got.items():
        assert shape == want[k].shape
        assert str(dtype).split(".")[1] == str(want[k].dtype)


# ---------------------------------------------------------------- pipeline
@pytest.mark.parametrize("seed,hosts", [(0, 1), (3, 2), (11, 4)])
def test_synthetic_lm_matches_reference(seed, hosts):
    for host in range(hosts):
        a = rpipe.SyntheticLM(97, 16, 8, seed=seed, host_id=host,
                              num_hosts=hosts)
        b = tpipe.SyntheticLM(97, 16, 8, seed=seed, host_id=host,
                              num_hosts=hosts)
        for step in (0, 1, 5, 1000):
            ba, bb = a.batch_at(step), b.batch_at(step)
            assert sorted(ba) == sorted(bb) == ["labels", "tokens"]
            for k in ba:
                assert ba[k].dtype == bb[k].dtype
                np.testing.assert_array_equal(ba[k], bb[k])


def test_prefetcher_orders_transforms_and_closes():
    src = tpipe.SyntheticLM(vocab=31, seq_len=8, batch=2, seed=0)
    pf = tpipe.Prefetcher(src, start_step=5, depth=2, transform=lambda b: {
        k: torch.from_numpy(v) for k, v in b.items()})
    got = [next(pf) for _ in range(4)]
    pf.close()
    assert [s for s, _ in got] == [5, 6, 7, 8]
    for s, b in got:
        assert torch.equal(b["tokens"], torch.from_numpy(
            src.batch_at(s)["tokens"]))
    assert not pf._thread.is_alive()


# ------------------------------------------- the kernels' autograd wiring
@pytest.fixture
def fake_kernels(monkeypatch):
    """``_route`` True, and each launch writes its plain version's result
    into the wrapper's outputs (a record of each launch kept)."""
    calls = []

    def flash(name, device, q, k, v, out, b, hq, hkv, s, d, window, *rest):
        calls.append(name)
        out.copy_(katt.flash_attention_plain(q, k, v, window))

    def ssd(name, device, x, dt, a, b, c, y, state, *rest):
        calls.append(name)
        yy, st = kssd.ssd_scan_plain(x, dt, a, b, c, 64, return_state=True)
        y.copy_(yy)
        state.copy_(st)

    for mod, fn in ((katt, flash), (kssd, ssd)):
        monkeypatch.setattr(mod, "_route", lambda *t: True)
        monkeypatch.setattr(mod, "_launch", fn)
    return calls


def _flash_inputs(dtype, b=2, hkv=2, group=3, s=70, d=16, seed=0):
    g = torch.Generator().manual_seed(seed)
    mk = (lambda h: torch.randn(b, s, h, d, generator=g).to(dtype)
          .transpose(1, 2))       # the model's transposed views
    return mk(hkv * group), mk(hkv), mk(hkv)


def _grads(fn, ins, dout):
    ins = [t.detach().requires_grad_() for t in ins]
    out = fn(*ins)
    out = out[0] if isinstance(out, tuple) else out
    return out, torch.autograd.grad(out, ins, dout)


@pytest.mark.parametrize("window", [0, 5, 40])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_gradient_is_the_plain_versions(fake_kernels, window, dtype):
    q, k, v = _flash_inputs(dtype, seed=window)
    dout = torch.randn(q.shape, generator=torch.Generator().manual_seed(1)
                       ).to(dtype)
    n0 = katt.flash_attention.launches
    out, got = _grads(lambda *t: katt.flash_attention(*t, window), (q, k, v),
                      dout)
    assert katt.flash_attention.launches == n0 + 1
    assert fake_kernels == ["glin_flash_attention_bf16" if dtype ==
                            torch.bfloat16 else "glin_flash_attention_fp32"]
    assert out.grad_fn is not None
    want_out, want = _grads(lambda *t: katt.flash_attention_plain(
        *t, window), (q, k, v), dout)
    assert torch.equal(out, want_out)
    tol = 2e-6 if dtype == torch.float32 else 2 ** -7
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        scale = float(b.float().abs().max())
        assert float((a.float() - b.float()).abs().max()) <= tol * scale


@pytest.mark.parametrize("window", [0, 7])
def test_flash_backward_chunks_equal_one_chunk(window):
    q, k, v = _flash_inputs(torch.float32, s=50, seed=3)
    dout = torch.randn(q.shape, generator=torch.Generator().manual_seed(4))
    whole = katt.flash_attention_grad(q, k, v, dout, window, rows=50)
    for rows in (1, 16, 33):
        for a, b in zip(katt.flash_attention_grad(q, k, v, dout, window,
                                                  rows=rows), whole):
            torch.testing.assert_close(a, b, atol=2e-6, rtol=1e-5)


def test_flash_without_grad_launches_as_before(fake_kernels):
    q, k, v = _flash_inputs(torch.float32)
    n0 = katt.flash_attention.launches
    out = katt.flash_attention(q, k, v)
    with torch.no_grad():
        out2 = katt.flash_attention(*(t.requires_grad_() for t in (q, k, v)))
    assert katt.flash_attention.launches == n0 + 2
    assert out.grad_fn is None and out2.grad_fn is None
    assert torch.equal(out, out2)


@pytest.mark.parametrize("return_state", [False, True])
@pytest.mark.parametrize("s", [64, 90])
def test_ssd_gradient_is_the_plain_versions(fake_kernels, return_state, s):
    g = torch.Generator().manual_seed(s)
    bsz, h, p, n = 2, 3, 8, 5
    x = torch.randn(bsz, s, h, p, generator=g)
    dt = torch.rand(bsz, s, h, generator=g) * 0.1 + 0.001
    a = -(torch.rand(h, generator=g) + 0.1)
    b = torch.randn(bsz, s, n, generator=g)
    c = torch.randn(bsz, s, n, generator=g)
    dy = torch.randn(bsz, s, h, p, generator=g)
    n0 = kssd.ssd_scan.launches
    ins = [t.requires_grad_() for t in (x, dt, a, b, c)]
    out = kssd.ssd_scan(*ins, 32, return_state=return_state)
    assert kssd.ssd_scan.launches == n0 + 1
    y = out[0] if return_state else out
    assert y.grad_fn is not None
    if return_state:
        assert out[1].grad_fn is None and not out[1].requires_grad
    got = torch.autograd.grad(y, ins, dy)
    want = torch.autograd.grad(kssd.ssd_scan_plain(*ins, 32), ins, dy)
    for u, w in zip(got, want):
        assert torch.equal(u, w)       # the same derivative, recomputed
    with torch.no_grad():
        assert kssd.ssd_scan(*ins, 32).grad_fn is None
    assert kssd.ssd_scan.launches == n0 + 2


def test_model_gradients_through_the_wrappers(fake_kernels):
    """A hybrid model (both kernels) under remat: one flash and one SSD
    launch a layer in the forward and one more in its recompute, and the
    gradients of the plain path."""
    cfg = get_arch("hymba_1p5b").reduced()
    params = tf.init_params(cfg, 5, device="cpu")
    batch = to_torch(make_batch(cfg, 64, 5))
    n0 = (katt.flash_attention.launches, kssd.ssd_scan.launches)
    loss, grads = value_and_grad(params, cfg, batch, remat=True)
    assert (katt.flash_attention.launches - n0[0],
            kssd.ssd_scan.launches - n0[1]) == (2 * cfg.n_layers,
                                                2 * cfg.n_layers)
    for mod in (katt, kssd):
        mod._route = lambda *t: False        # undone by monkeypatch
    want_loss, want = value_and_grad(params, cfg, batch, remat=True)
    assert abs(float(loss) - float(want_loss)) <= LOSS_REL * float(want_loss)
    for a, b in zip(grads, want):
        assert float((a - b).abs().max()) <= GRAD_REL * max(
            float(b.abs().max()), 1e-30)


def test_example_trains_on_the_cpu(tmp_path, capsys):
    from repro_torch.examples import train_lm
    from repro_torch.launch import train as lt

    before = lt.get_arch
    assert train_lm.main(["--steps", "3", "--batch", "2", "--seq", "32",
                          "--ckpt-dir", str(tmp_path), "--device",
                          "cpu"]) == 0
    out = capsys.readouterr().out
    assert "[example] demo-20m" in out and "[train] step=2 " in out
    assert lt.get_arch is before
    assert (tmp_path / "LATEST").read_text() == "step_000000003"
    assert math.isclose(train_lm.config_100m().param_count() / 1e6, 100,
                        rel_tol=0.25)
    assert dataclasses.asdict(train_lm.config_20m())["dtype"] == "float32"
