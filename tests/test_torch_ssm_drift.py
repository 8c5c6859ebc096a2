"""How far the SSM model's bf16 evaluations stray, in the reference and in
the port, from the same weights and tokens.

Two bf16 evaluations of one function — the decode path (a prefill of the
prompt, then one token a step) and the full forward over the same tokens —
differ, and each differs from the fp32 evaluation (the same bf16 weights
upcast): every layer rounds its activations to bf16, and the differences
grow with depth. ``measure`` reads, for each package, the largest
|decode - forward| over the logits of the steps in bf16 (``gap``) and in
fp32 (``gap_fp32``), the largest |forward bf16 - forward fp32| (``drift``)
and the fp32 logits' largest magnitude (``range``).

``chip_smoke.py`` holds the port's bf16 paths on the card to
``SSM_BF16_DRIFT_RATIO`` (2) times the drift of their counterpart: two bf16
evaluations, each no further from the fp32 one than the forward is, lie
within twice that of each other. The tests hold the reference to that
bound as well as the port (at full width the reference's own gap stays
within 1.21x its drift, 2 to 16 layers), the port's drift to within twice
the reference's, and the fp32 gaps to the decode tolerance of
``tests/test_models.py``, at reduced width in 2 and 8 layers.

Run as a script, it measures both packages at full width, cut in depth (the
numbers ``PERF.md`` cites; about 15 min for the default depths on 8 CPU
cores, nearly all of it the reference):

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_ssm_drift.py \
        --layers 2 4 8 16
"""
import argparse
import dataclasses
import json

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")         # the reference needs jax

import jax.numpy as jnp  # noqa: E402
from repro.configs import get_arch as rget  # noqa: E402
from repro.models import transformer as rtf  # noqa: E402
from repro.sharding import constrain  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402

DRIFT_RATIO = 2.0        # chip_smoke.SSM_BF16_DRIFT_RATIO
FP32_GAP = (5e-4, 1e-2)  # atol, rtol of the range: tests/test_models.py


def _upcast(tree):
    return {k: _upcast(v) if isinstance(v, dict) else v.float()
            for k, v in tree.items()}


def _ref_paths(params, cfg, toks, prompt):
    """The reference's (decode logits, forward logits) of positions
    prompt - 1 .. S - 1, each (B, steps, V) fp32."""
    fwd = jax.jit(lambda p, t: rtf.forward_train(
        p, cfg, {"tokens": t}, constrain, remat=False)[0])
    pre = jax.jit(lambda p, t: rtf.prefill(p, cfg, {"tokens": t}, constrain))
    dec = jax.jit(lambda p, t, c: rtf.decode_step(
        p, cfg, {"tokens": t}, c, constrain))
    full = np.asarray(fwd(params, jnp.asarray(toks)), np.float32)
    last, cache = pre(params, jnp.asarray(toks[:, :prompt]))
    out = [np.asarray(last, np.float32)]
    for t in range(prompt, toks.shape[1]):
        last, cache = dec(params, jnp.asarray(toks[:, t]), cache)
        out.append(np.asarray(last, np.float32))
    return np.stack(out, 1), full[:, prompt - 1:]


def _port_paths(params, cfg, toks, prompt):
    """The port's, as :func:`_ref_paths`."""
    tt = torch.from_numpy(toks)
    full, _ = tf.forward(params, cfg, {"tokens": tt})
    last, cache = tf.prefill(params, cfg, {"tokens": tt[:, :prompt]})
    out = [last]
    for t in range(prompt, toks.shape[1]):
        last, cache = tf.decode_step(params, cfg, {"tokens": tt[:, t]}, cache)
        out.append(last)
    return (torch.stack(out, 1).float().numpy(),
            full[:, prompt - 1:].float().numpy())


def measure(layers, seed, prompt, total, batch=1, reduced=True):
    """{"ref": readings, "port": readings} of ``mamba2_2p7b`` in bf16 with
    ``layers`` layers (reduced width, or the full width), weights from the
    reference's ``init_params`` at ``seed``, carried into the port."""
    def cut(c):
        c = c.reduced() if reduced else c
        return dataclasses.replace(c, n_layers=layers, dtype="bfloat16")

    rcfg, cfg = cut(rget("mamba2_2p7b")), cut(get_arch("mamba2_2p7b"))
    rp16 = rtf.init_params(rcfg, jax.random.PRNGKey(seed))
    tp16 = params_from_reference(
        cfg, jax.tree_util.tree_map(np.asarray, rp16), "cpu")
    runs = {
        "ref": (_ref_paths, rcfg, rp16, jax.tree_util.tree_map(
            lambda a: a.astype(jnp.float32), rp16)),
        "port": (_port_paths, cfg, tp16, _upcast(tp16))}
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab, (batch, total)).astype(np.int32)
    out = {}
    for name, (paths, c16, p16, p32) in runs.items():
        c32 = dataclasses.replace(c16, dtype="float32")
        dec32, fwd32 = paths(p32, c32, toks, prompt)
        dec16, fwd16 = paths(p16, c16, toks, prompt)
        out[name] = {
            "range": float(np.abs(fwd32).max()),
            "gap": float(np.abs(dec16 - fwd16).max()),
            "gap_first": float(np.abs(dec16[:, 0] - fwd16[:, 0]).max()),
            "drift": float(np.abs(fwd16 - fwd32).max()),
            "decode_drift": float(np.abs(dec16 - fwd32).max()),
            "gap_fp32": float(np.abs(dec32 - fwd32).max())}
    return out


@pytest.fixture(scope="module", params=(2, 8))
def readings(request):
    return measure(request.param, seed=0, prompt=24, total=40, batch=2)


@pytest.mark.parametrize("pkg", ("ref", "port"))
def test_bf16_gap_within_twice_the_drift(readings, pkg):
    """The bound chip_smoke.py puts on the port's bf16 paths holds for the
    reference's own."""
    r = readings[pkg]
    assert r["gap"] <= DRIFT_RATIO * r["drift"], r


def test_port_drift_within_twice_the_reference(readings):
    assert readings["port"]["drift"] <= 2 * readings["ref"]["drift"], readings
    assert readings["port"]["gap"] <= 2 * readings["ref"]["gap"], readings


@pytest.mark.parametrize("pkg", ("ref", "port"))
def test_fp32_paths_agree(readings, pkg):
    r = readings[pkg]
    atol, rtol = FP32_GAP
    assert r["gap_fp32"] <= atol + rtol * r["range"], r


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, nargs="+", default=[2, 4, 8, 16])
    ap.add_argument("--prompt", type=int, default=384)
    ap.add_argument("--total", type=int, default=512)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    for n in args.layers:
        res = measure(n, args.seed, args.prompt, args.total, reduced=False)
        for pkg, r in res.items():
            print(json.dumps({"layers": n, "package": pkg, "width": "full",
                              "prompt": args.prompt, "total": args.total,
                              **r, "gap_share": r["gap"] / r["range"],
                              "drift_share": r["drift"] / r["range"],
                              "gap_over_drift": r["gap"] / r["drift"]}),
                  flush=True)
