"""The port's hybrid family (``hymba_1p5b``: attention and Mamba-2 heads
side by side in every layer, meta tokens ahead of the prompt, a sliding
window) against the reference's, at ``cfg.reduced()`` in fp32 with the
reference's weights carried by ``params_from_reference``.

Two prompts: 40 tokens (48 with the 8 meta tokens: past the reduced window
of 32, so prefill rolls the ring and decode wraps it) and 16 (24 with the
meta tokens, under the window: the padded ring). Each: prefill's last
logits and every cache leaf (k, v, abs_pos, pos; conv, state), then 6
decode steps, at the fp32 tolerances of ``tests/test_torch_lm.py``; the
decode steps also against the port's own full forward. Then the port's
``SlotServer`` against the reference's (equal greedy tokens), the CLI on
the CPU, and the full-width parameter count.

Last, the bf16 witness: both packages in bf16 from the same weights, in 2
and 8 layers at reduced width. Each evaluation of the model rounds its
activations to bf16 at every layer, so two bf16 evaluations of one function
differ, and each differs from the fp32 one (the same weights upcast).
``measure`` reads, for each package, the largest |decode - forward| of the
decode steps' logits in bf16 (``gap``), the largest |forward bf16 -
forward fp32| (``drift``), and between the packages the largest
|port - reference| of the bf16 forward and decode logits (``cross``). The
tests hold them to the rule ``chip_smoke.py`` holds the port's bf16 paths
to on the card (``SSM_BF16_DRIFT_RATIO``: within twice the drift), as
``tests/test_torch_ssm_drift.py`` does for the SSM family.

Run as a script, it measures both packages at full width, cut in depth:

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_hybrid.py \
        --layers 2 4
"""
import argparse
import dataclasses
import json
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")         # the reference needs jax
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
from repro.configs import get_arch as rget  # noqa: E402
from repro.launch import serve as rserve  # noqa: E402
from repro.models import transformer as rtf  # noqa: E402
from repro.sharding import constrain  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_arch  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCH = "hymba_1p5b"
B, EXTRA, CTX = 2, 6, 64
PROMPTS = (40, 16)
FP32 = {"prefill": (2e-4, 1e-3), "decode": (5e-4, 1e-2), "cache": (2e-4, 1e-3)}


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


@pytest.fixture(scope="module")
def carried():
    """The reference's reduced weights (one jitted draw) and their carry."""
    rcfg, cfg = rget(ARCH).reduced(), get_arch(ARCH).reduced()
    rparams = jax.jit(rtf.init_params, static_argnums=0)(
        rcfg, jax.random.PRNGKey(1))
    return rcfg, cfg, rparams, params_from_reference(
        cfg, jax.tree_util.tree_map(np.asarray, rparams), "cpu")


@pytest.fixture(scope="module", params=PROMPTS)
def run(request, carried):
    """Prefill + 6 decode steps of both packages on the same tokens and the
    same (carried) weights, and the port's forward at each step (the
    reference's prefill and decode step jitted, as its SlotServer runs
    them)."""
    s = request.param
    rcfg, cfg, rparams, params = carried
    rprefill = jax.jit(lambda p, b: rtf.prefill(p, rcfg, b, constrain,
                                                seq_len_cache=CTX))
    rdecode = jax.jit(lambda p, b, c: rtf.decode_step(p, rcfg, b, c,
                                                      constrain))
    toks = np.random.default_rng(s).integers(0, cfg.vocab, (B, s + EXTRA))
    toks = toks.astype(np.int32)
    rl, rc = rprefill(rparams, {"tokens": jnp.asarray(toks[:, :s])})
    tl, tc = tf.prefill(params, cfg, {"tokens": torch.from_numpy(toks[:, :s])},
                        seq_len_cache=CTX)
    out = {"cfg": cfg, "s": s, "prefill": (_np(rl), tl.numpy()), "dec": [],
           "fwd": [],
           "cache": ({f"{g}/{k}": _np(v) for g in ("attn", "ssm")
                      for k, v in rc[g].items()},
                     {f"{g}/{k}": v.float().numpy().copy()   # in place below
                      for g in ("attn", "ssm") for k, v in tc[g].items()})}
    for t in range(EXTRA):
        rd, rc = rdecode(rparams, {"tokens": jnp.asarray(toks[:, s + t])},
                         rc)
        td, tc = tf.decode_step(params, cfg,
                                {"tokens": torch.from_numpy(toks[:, s + t])},
                                tc)
        full, _ = tf.forward(params, cfg,
                             {"tokens": torch.from_numpy(toks[:, :s + t + 1])},
                             logits_last_only=True)
        out["dec"].append((_np(rd), td.numpy()))
        out["fwd"].append(full[:, -1].numpy())
    out["final"] = ({"abs_pos": _np(rc["attn"]["abs_pos"]),
                     "state": _np(rc["ssm"]["state"])},
                    {"abs_pos": tc["attn"]["abs_pos"].numpy(),
                     "state": tc["ssm"]["state"].numpy()})
    return out


def test_prefill_logits_match_reference(run):
    atol, rtol = FP32["prefill"]
    np.testing.assert_allclose(run["prefill"][1], run["prefill"][0],
                               atol=atol, rtol=rtol)


def test_prefill_cache_matches_reference(run):
    """Both caches: the windowed ring over the meta tokens and the prompt
    (positions counted from the first meta token), the conv window and the
    fp32 SSM state."""
    want, got = run["cache"]
    assert set(got) == set(want) == {"attn/k", "attn/v", "attn/abs_pos",
                                     "attn/pos", "ssm/conv", "ssm/state"}
    cfg, s = run["cfg"], run["s"]
    np.testing.assert_array_equal(got["attn/abs_pos"], want["attn/abs_pos"])
    np.testing.assert_array_equal(got["attn/pos"], want["attn/pos"])
    assert (got["attn/pos"] == s + cfg.meta_tokens).all()
    assert got["attn/k"].shape[2] == cfg.window
    atol, rtol = FP32["cache"]
    for name in ("attn/k", "attn/v", "ssm/conv", "ssm/state"):
        assert got[name].shape == want[name].shape, name
        np.testing.assert_allclose(got[name], want[name], atol=atol,
                                   rtol=rtol, err_msg=name)


def test_decode_steps_match_reference_and_forward(run):
    atol, rtol = FP32["decode"]
    for (want, got), fwd in zip(run["dec"], run["fwd"]):
        np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)
        np.testing.assert_allclose(got, fwd, atol=atol, rtol=rtol)
    want, got = run["final"]
    np.testing.assert_array_equal(got["abs_pos"], want["abs_pos"])
    np.testing.assert_allclose(got["state"], want["state"], atol=atol,
                               rtol=rtol)


def test_ring_rolls_or_pads(run):
    """Past the window the ring holds the last 32 positions (the meta
    tokens fall out of it); under it, the empty slots are -1."""
    cfg, s = run["cfg"], run["s"]
    ap = run["final"][1]["abs_pos"]
    end = s + cfg.meta_tokens + EXTRA
    if s + cfg.meta_tokens > cfg.window:
        assert ap.min() == end - cfg.window and ap.max() == end - 1
    else:
        assert ap.max() == end - 1 and (ap == -1).sum() == (
            ap.shape[0] * ap.shape[1] * (cfg.window - end))


def _serve(server, prompts, gens):
    """Drive a SlotServer as ``main_lm`` does: admit into free slots, step,
    retire; returns each request's generated tokens."""
    queue = list(range(len(prompts)))
    owner = [None] * server.slots
    cur = np.zeros(server.slots, np.int32)
    out = {}
    while queue or any(server.active):
        for s in range(server.slots):
            if not server.active[s] and queue:
                r = queue.pop(0)
                server.admit(s, prompts[r], gens[r])
                owner[s], cur[s] = r, prompts[r][-1]
        nxt = server.step(cur)
        for s in range(server.slots):
            if server.active[s]:
                server.generated[s].append(int(nxt[s]))
                cur[s] = nxt[s]
                server.remaining[s] -= 1
                if server.remaining[s] <= 0:
                    server.active[s] = False
                    out[owner[s]] = list(server.generated[s])
    return [out[r] for r in range(len(prompts))]


def test_slot_server_matches_reference(carried):
    """2 slots, 3 requests (the third admitted when the first finishes):
    both caches splice into a slot; the greedy tokens are the reference's,
    past the window (12 + 8 meta + up to 17 generated over 32 slots)."""
    rcfg, cfg, rparams, params = carried
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab, 12).astype(np.int32)
               for _ in range(3)]
    gens = [5, 17, 6]
    want = _serve(rserve.SlotServer(rcfg, rparams, 2, 32), prompts, gens)
    got = _serve(tserve.SlotServer(cfg, params, 2, 32, device="cpu"),
                 prompts, gens)
    assert [len(g) for g in got] == gens
    assert got == want


def test_serve_cli_runs_hybrid_on_cpu():
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "lm", "--arch",
         ARCH, "--device", "cpu", "--requests", "3", "--slots", "2",
         "--max-ctx", "48"],
        cwd=ROOT, env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin"},
        capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "3 requests" in r.stdout


def test_hymba_is_served_at_full_width():
    """In ARCH_IDS; the port's parameter tree at full width counts the
    reference's ``param_count`` (no tensor allocated)."""
    assert ARCH in ARCH_IDS
    cfg = get_arch(ARCH)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(rget(ARCH))

    def count(tree):
        return sum(count(v) if isinstance(v, dict) else math.prod(v.shape)
                   for v in tree.values())

    assert count(tf.param_shapes(cfg)) == cfg.param_count() == (
        rget(ARCH).param_count())
    assert cfg.n_heads // cfg.n_kv_heads == 5 and cfg.meta_tokens == 128


# --------------------------------------------------------- bf16 witness --
DRIFT_RATIO = 2.0        # chip_smoke.SSM_BF16_DRIFT_RATIO


def _upcast(tree):
    return {k: _upcast(v) if isinstance(v, dict) else v.float()
            for k, v in tree.items()}


def _ref_paths(params, cfg, toks, prompt, ctx):
    """The reference's (decode logits, forward logits) of positions
    prompt - 1 .. S - 1, each (B, steps, V) fp32."""
    fwd = jax.jit(lambda p, t: rtf.forward_train(
        p, cfg, {"tokens": t}, constrain, remat=False)[0])
    pre = jax.jit(lambda p, t: rtf.prefill(p, cfg, {"tokens": t}, constrain,
                                           seq_len_cache=ctx))
    dec = jax.jit(lambda p, t, c: rtf.decode_step(
        p, cfg, {"tokens": t}, c, constrain))
    full = _np(fwd(params, jnp.asarray(toks)))
    last, cache = pre(params, jnp.asarray(toks[:, :prompt]))
    out = [_np(last)]
    for t in range(prompt, toks.shape[1]):
        last, cache = dec(params, jnp.asarray(toks[:, t]), cache)
        out.append(_np(last))
    return np.stack(out, 1), full[:, prompt - 1:]


def _port_paths(params, cfg, toks, prompt, ctx):
    """The port's, as :func:`_ref_paths`."""
    tt = torch.from_numpy(toks)
    full, _ = tf.forward(params, cfg, {"tokens": tt})
    last, cache = tf.prefill(params, cfg, {"tokens": tt[:, :prompt]},
                             seq_len_cache=ctx)
    out = [last]
    for t in range(prompt, toks.shape[1]):
        last, cache = tf.decode_step(params, cfg, {"tokens": tt[:, t]}, cache)
        out.append(last)
    return (torch.stack(out, 1).float().numpy(),
            full[:, prompt - 1:].float().numpy())


def measure(layers, seed, prompt, total, ctx, batch=1, reduced=True):
    """{"ref": readings, "port": readings, "cross": readings} of
    ``hymba_1p5b`` in bf16 with ``layers`` layers (reduced width, or the
    full width), weights from the reference's ``init_params`` at ``seed``,
    carried into the port."""
    def cut(c):
        c = c.reduced() if reduced else c
        return dataclasses.replace(c, n_layers=layers, dtype="bfloat16")

    rcfg, cfg = cut(rget(ARCH)), cut(get_arch(ARCH))
    rp16 = rtf.init_params(rcfg, jax.random.PRNGKey(seed))
    tp16 = params_from_reference(
        cfg, jax.tree_util.tree_map(np.asarray, rp16), "cpu")
    runs = {
        "ref": (_ref_paths, rcfg, rp16, jax.tree_util.tree_map(
            lambda a: a.astype(jnp.float32), rp16)),
        "port": (_port_paths, cfg, tp16, _upcast(tp16))}
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab, (batch, total)).astype(np.int32)
    out, bf16 = {}, {}
    for name, (paths, c16, p16, p32) in runs.items():
        c32 = dataclasses.replace(c16, dtype="float32")
        fwd32 = paths(p32, c32, toks, prompt, ctx)[1]
        dec16, fwd16 = bf16[name] = paths(p16, c16, toks, prompt, ctx)
        out[name] = {
            "range": float(np.abs(fwd32).max()),
            "gap": float(np.abs(dec16 - fwd16).max()),
            "drift": float(np.abs(fwd16 - fwd32).max()),
            "decode_drift": float(np.abs(dec16 - fwd32).max())}
    (rd, rf), (td, tf_) = bf16["ref"], bf16["port"]
    out["cross"] = {"forward": float(np.abs(tf_ - rf).max()),
                    "decode": float(np.abs(td - rd).max())}
    return out


@pytest.fixture(scope="module", params=(2, 8))
def bf16_readings(request):
    """40-token prompts (48 positions with the meta tokens, past the
    window of 32) and 8 decode steps, 2 requests."""
    return measure(request.param, seed=0, prompt=40, total=48, ctx=CTX,
                   batch=2)


@pytest.mark.parametrize("pkg", ("ref", "port"))
def test_bf16_gap_within_twice_the_drift(bf16_readings, pkg):
    """The bound chip_smoke.py puts on the port's bf16 paths holds for
    each package's own decode path against its forward."""
    r = bf16_readings[pkg]
    assert r["gap"] <= DRIFT_RATIO * r["drift"], bf16_readings


def test_bf16_port_within_twice_the_reference(bf16_readings):
    """The port's bf16 logits against the reference's, from the same
    weights and tokens: as far apart as two bf16 evaluations of one
    function may be (twice the reference's distance from its fp32 run),
    and the port's own drift and gap within twice the reference's."""
    ref, port, cross = (bf16_readings[k] for k in ("ref", "port", "cross"))
    assert cross["forward"] <= DRIFT_RATIO * ref["drift"], bf16_readings
    assert cross["decode"] <= DRIFT_RATIO * ref["decode_drift"], (
        bf16_readings)
    assert port["drift"] <= 2 * ref["drift"], bf16_readings
    assert port["gap"] <= 2 * ref["gap"], bf16_readings


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description="hymba_1p5b's bf16 drift, "
                                 "reference and port, at full width")
    ap.add_argument("--layers", type=int, nargs="+", default=[2, 4])
    ap.add_argument("--prompt", type=int, default=384)
    ap.add_argument("--total", type=int, default=512)
    ap.add_argument("--ctx", type=int, default=1024)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    for n in args.layers:
        res = measure(n, args.seed, args.prompt, args.total, args.ctx,
                      reduced=False)
        print(json.dumps({"layers": n, "width": "full",
                          "prompt": args.prompt, "total": args.total, **{
                              k: v if k == "cross" else {
                                  **v, "gap_share": v["gap"] / v["range"],
                                  "drift_share": v["drift"] / v["range"]}
                              for k, v in res.items()}}), flush=True)
