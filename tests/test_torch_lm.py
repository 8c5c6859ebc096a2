"""The port's dense and SSM LMs against the reference's, and its serving
launcher.

The reference's parameters (``repro.models.transformer.init_params``)
carried by ``params_from_reference`` must make the port compute what the
reference computes, at reduced size: ``prefill``'s last logits and every
cache leaf, then 6 ``decode_step``s, for ``granite_3_2b``,
``phi4_mini_3p8b``, ``codeqwen1p5_7b`` (untied head, MHA) and
``granite_34b`` (untied, MQA, GELU); a windowed variant (window 16, prompt
40, max_ctx 64: the roll branch, and a ring that wraps while decoding); and
one bf16 case. Tolerances in fp32 as ``tests/test_models.py`` holds the
reference's decode to its forward: 2e-4 / 1e-3 (atol / rtol) for prefill,
5e-4 / 1e-2 for decode. In bf16 the two frameworks round activations at
different points (and the reference's prefill rounds the probabilities to
bf16 before P.V, the port's flash kernel keeps them fp32), so logits of
magnitude ~5 differ by up to ~0.1 and k/v by one or two bf16 steps: the
bf16 case allows 0.25 on logits and 0.125 on k/v.

``mamba2_2p7b`` (the ssm family) the same way at S = 40, as
``tests/test_models.py`` runs it: prefill's last logits, both SSM cache
leaves (conv, state) and 6 decode steps, in fp32 at the tolerances above
(the cache leaves at prefill's) and in bf16 (logits 0.25 and conv 0.125
as the dense bf16 case; the fp32 state, which sums 40 steps of bf16 inputs
that the two frameworks round apart, within 2% of its largest magnitude,
where one bf16 step is 0.4-0.8%); the carry of the SSM tree with its fp32
leaves; and its ``SlotServer`` and CLI.

Then the port's ``SlotServer`` against the reference's (2 slots, 3 requests
admitted as slots free up, equal greedy tokens), the CLI on the CPU, and the
configs themselves (every architecture of the reference's pool; the MoE,
vision-language and audio families are held against the reference in
``tests/test_torch_families.py``).
"""
import dataclasses
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
B, S, EXTRA, CTX = 2, 40, 6, 64
CASES = ("granite_3_2b", "phi4_mini_3p8b", "codeqwen1p5_7b", "granite_34b",
         "granite_3_2b+window16", "granite_3_2b+bf16")
FP32 = {"prefill": (2e-4, 1e-3), "decode": (5e-4, 1e-2), "kv": (2e-4, 1e-3)}
BF16 = {"prefill": (0.25, 0.0), "decode": (0.25, 0.0), "kv": (0.125, 0.0)}


def _configs(case):
    arch, _, variant = case.partition("+")
    extra = {"window16": {"window": 16}, "bf16": {"dtype": "bfloat16"},
             "": {}}[variant]
    return (dataclasses.replace(rget(arch).reduced(), **extra),
            dataclasses.replace(get_arch(arch).reduced(), **extra))


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


@pytest.fixture(scope="module", params=CASES)
def run(request):
    """Prefill + 6 decode steps of both packages on the same tokens and the
    same (carried) weights."""
    rcfg, cfg = _configs(request.param)
    rparams = rtf.init_params(rcfg, jax.random.PRNGKey(1))
    params = params_from_reference(
        cfg, jax.tree_util.tree_map(np.asarray, rparams), "cpu")
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (B, S + EXTRA))
    toks = toks.astype(np.int32)
    out = {"tol": BF16 if cfg.dtype == "bfloat16" else FP32, "dec": []}
    rl, rc = rtf.prefill(rparams, rcfg, {"tokens": jnp.asarray(toks[:, :S])},
                         constrain, seq_len_cache=CTX)
    tl, tc = tf.prefill(params, cfg, {"tokens": torch.from_numpy(toks[:, :S])},
                        seq_len_cache=CTX)
    out["prefill"] = (_np(rl), tl.numpy())
    out["cache"] = ({k: _np(v) for k, v in rc["attn"].items()},
                    {k: v.float().numpy().copy()   # decode updates in place
                     for k, v in tc["attn"].items()})
    for t in range(EXTRA):
        rd, rc = rtf.decode_step(rparams, rcfg,
                                 {"tokens": jnp.asarray(toks[:, S + t])}, rc,
                                 constrain)
        td, tc = tf.decode_step(params, cfg,
                                {"tokens": torch.from_numpy(toks[:, S + t])},
                                tc)
        out["dec"].append((_np(rd), td.numpy()))
    out["w"] = tc["attn"]["k"].shape[2]
    out["final_abs_pos"] = (_np(rc["attn"]["abs_pos"]),
                            tc["attn"]["abs_pos"].numpy())
    return out


def test_prefill_logits_match_reference(run):
    atol, rtol = run["tol"]["prefill"]
    np.testing.assert_allclose(run["prefill"][1], run["prefill"][0],
                               atol=atol, rtol=rtol)


def test_prefill_cache_matches_reference(run):
    want, got = run["cache"]
    assert set(got) == set(want) == {"k", "v", "abs_pos", "pos"}
    np.testing.assert_array_equal(got["abs_pos"], want["abs_pos"])
    np.testing.assert_array_equal(got["pos"], want["pos"])
    atol, rtol = run["tol"]["kv"]
    for name in ("k", "v"):
        assert got[name].shape == want[name].shape
        np.testing.assert_allclose(got[name], want[name], atol=atol,
                                   rtol=rtol)


def test_decode_steps_match_reference(run):
    atol, rtol = run["tol"]["decode"]
    for want, got in run["dec"]:
        np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)
    np.testing.assert_array_equal(*run["final_abs_pos"])


def test_windowed_case_wraps_its_ring(run):
    """The window-16 case keeps 16 slots and its ring wraps past them."""
    abs_pos = run["final_abs_pos"][1]
    if run["w"] == CTX:
        assert abs_pos.max() == S + EXTRA - 1
    else:
        assert run["w"] == 16 and abs_pos.min() == S + EXTRA - 16


SSM_CASES = ("mamba2_2p7b", "mamba2_2p7b+bf16")
SSM_BF16_STATE_REL = 0.02


@pytest.fixture(scope="module", params=SSM_CASES)
def ssm_run(request):
    """mamba2_2p7b: prefill + 6 decode steps of both packages on the same
    tokens and the same (carried) weights."""
    rcfg, cfg = _configs(request.param)
    rparams = rtf.init_params(rcfg, jax.random.PRNGKey(2))
    params = params_from_reference(
        cfg, jax.tree_util.tree_map(np.asarray, rparams), "cpu")
    toks = np.random.default_rng(2).integers(0, cfg.vocab, (B, S + EXTRA))
    toks = toks.astype(np.int32)
    out = {"bf16": cfg.dtype == "bfloat16", "dec": []}
    rl, rc = rtf.prefill(rparams, rcfg, {"tokens": jnp.asarray(toks[:, :S])},
                         constrain, seq_len_cache=CTX)
    tl, tc = tf.prefill(params, cfg, {"tokens": torch.from_numpy(toks[:, :S])},
                        seq_len_cache=CTX)
    out["prefill"] = (_np(rl), tl.numpy())
    out["cache"] = ({k: _np(v) for k, v in rc["ssm"].items()},
                    {k: v.float().numpy().copy()   # decode updates in place
                     for k, v in tc["ssm"].items()},
                    {k: v.dtype for k, v in tc["ssm"].items()})
    for t in range(EXTRA):
        rd, rc = rtf.decode_step(rparams, rcfg,
                                 {"tokens": jnp.asarray(toks[:, S + t])}, rc,
                                 constrain)
        td, tc = tf.decode_step(params, cfg,
                                {"tokens": torch.from_numpy(toks[:, S + t])},
                                tc)
        out["dec"].append((_np(rd), td.numpy()))
    return out


def test_ssm_prefill_logits_match_reference(ssm_run):
    atol, rtol = (BF16 if ssm_run["bf16"] else FP32)["prefill"]
    np.testing.assert_allclose(ssm_run["prefill"][1], ssm_run["prefill"][0],
                               atol=atol, rtol=rtol)


def test_ssm_prefill_cache_matches_reference(ssm_run):
    """conv (L,B,K-1,C) in the model's dtype, state (L,B,H,N,P) fp32."""
    want, got, dtypes = ssm_run["cache"]
    assert set(got) == set(want) == {"conv", "state"}
    assert dtypes["state"] == torch.float32
    assert dtypes["conv"] == (torch.bfloat16 if ssm_run["bf16"]
                              else torch.float32)
    for name in ("conv", "state"):
        assert got[name].shape == want[name].shape
    if ssm_run["bf16"]:
        np.testing.assert_allclose(got["conv"], want["conv"],
                                   atol=BF16["kv"][0], rtol=0)
        bound = SSM_BF16_STATE_REL * np.abs(want["state"]).max()
        np.testing.assert_allclose(got["state"], want["state"], atol=bound,
                                   rtol=0)
    else:
        for name in ("conv", "state"):
            np.testing.assert_allclose(got[name], want[name],
                                       atol=FP32["prefill"][0],
                                       rtol=FP32["prefill"][1])


def test_ssm_decode_steps_match_reference(ssm_run):
    atol, rtol = (BF16 if ssm_run["bf16"] else FP32)["decode"]
    for want, got in ssm_run["dec"]:
        np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)


def test_ssm_params_from_reference_keep_fp32_leaves():
    """In a bf16 model the SSM's dt_bias, a_log and skip_d stay fp32 (0.5,
    0 and 1 from init) and carry as fp32; the port's own init fills them
    alike; a leaf of another dtype is refused."""
    rcfg, cfg = _configs("mamba2_2p7b+bf16")
    tree = jax.tree_util.tree_map(
        np.asarray, rtf.init_params(rcfg, jax.random.PRNGKey(5)))
    carried = params_from_reference(cfg, tree, "cpu")["blocks"]["ssm"]
    own = tf.init_params(cfg, 5, device="cpu")["blocks"]["ssm"]
    for name, fill in (("dt_bias", 0.5), ("a_log", 0.0), ("skip_d", 1.0)):
        for p in (carried, own):
            assert p[name].dtype == torch.float32
            assert p[name].shape == (cfg.n_layers, cfg.ssm_heads)
            assert torch.equal(p[name], torch.full_like(p[name], fill))
    for name in ("wz", "wx", "wb", "wc", "wdt", "conv_w", "norm", "out"):
        assert carried[name].dtype == own[name].dtype == torch.bfloat16
        assert carried[name].shape == own[name].shape
    np.testing.assert_array_equal(
        carried["wx"].float().numpy(),
        np.asarray(tree["blocks"]["ssm"]["wx"], np.float32))
    tree["blocks"]["ssm"]["a_log"] = tree["blocks"]["ssm"]["a_log"].astype(
        tree["blocks"]["ssm"]["wx"].dtype)
    with pytest.raises(ValueError, match="a_log"):
        params_from_reference(cfg, tree, "cpu")


def test_ssm_decode_matches_full_forward():
    """The port alone: mamba2_2p7b's prefill and 6 decode steps equal the
    full forward's last logits over the same tokens."""
    cfg = get_arch("mamba2_2p7b").reduced()
    params = tf.init_params(cfg, 3, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (B, S + EXTRA)))
    last, cache = tf.prefill(params, cfg, {"tokens": toks[:, :S]})
    full, _ = tf.forward(params, cfg, {"tokens": toks[:, :S]})
    torch.testing.assert_close(last, full[:, -1], atol=2e-4, rtol=1e-3)
    for t in range(EXTRA):
        dec, cache = tf.decode_step(params, cfg, {"tokens": toks[:, S + t]},
                                    cache)
        full, _ = tf.forward(params, cfg, {"tokens": toks[:, :S + t + 1]})
        torch.testing.assert_close(dec, full[:, -1], atol=5e-4, rtol=1e-2)


def test_ssm_forward_needs_a_chunk_multiple():
    """As the reference's ``ssd_chunked`` asserts: a sequence longer than
    the SSD chunk (128) must be a multiple of it."""
    cfg = get_arch("mamba2_2p7b").reduced()
    params = tf.init_params(cfg, 3, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (1, 256)))
    logits, _ = tf.forward(params, cfg, {"tokens": toks},
                           logits_last_only=True)
    assert logits.shape == (1, 1, cfg.vocab)
    assert torch.isfinite(logits).all()
    with pytest.raises(ValueError, match="multiple of the SSD chunk 128"):
        tf.forward(params, cfg, {"tokens": toks[:, :130]})


@pytest.mark.parametrize("window", [0, 16])
def test_decode_matches_full_forward(window):
    """The port alone: after prefill and t decode steps the logits equal the
    full forward's last logits over the same s + t + 1 tokens."""
    cfg = dataclasses.replace(get_arch("granite_3_2b").reduced(),
                              window=window)
    params = tf.init_params(cfg, 3, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (B, S + EXTRA)))
    last, cache = tf.prefill(params, cfg, {"tokens": toks[:, :S]},
                             seq_len_cache=S + EXTRA)
    full, _ = tf.forward(params, cfg, {"tokens": toks[:, :S]})
    torch.testing.assert_close(last, full[:, -1], atol=2e-4, rtol=1e-3)
    for t in range(EXTRA):
        dec, cache = tf.decode_step(params, cfg, {"tokens": toks[:, S + t]},
                                    cache)
        full, _ = tf.forward(params, cfg, {"tokens": toks[:, :S + t + 1]})
        torch.testing.assert_close(dec, full[:, -1], atol=5e-4, rtol=1e-2)


def _serve(server, prompts, gens):
    """Drive a SlotServer as ``main_lm`` does: admit into free slots,
    step, retire; returns each request's generated tokens."""
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


def _servers_agree(arch):
    """2 slots, 3 requests: the third is admitted when the first finishes;
    both servers generate the same greedy tokens."""
    rcfg, cfg = _configs(arch)
    rparams = rtf.init_params(rcfg, jax.random.PRNGKey(4))
    params = params_from_reference(
        cfg, jax.tree_util.tree_map(np.asarray, rparams), "cpu")
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab, 12).astype(np.int32)
               for _ in range(3)]
    gens = [5, 9, 6]
    want = _serve(rserve.SlotServer(rcfg, rparams, 2, 32), prompts, gens)
    got = _serve(tserve.SlotServer(cfg, params, 2, 32, device="cpu"),
                 prompts, gens)
    assert [len(g) for g in got] == gens
    assert got == want


def test_slot_server_matches_reference():
    _servers_agree("granite_3_2b")


def test_ssm_slot_server_matches_reference():
    """The SSM cache {conv, state} splices into a slot along axis 1."""
    _servers_agree("mamba2_2p7b")


def _cli(arch):
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "lm", "--arch",
         arch, "--device", "cpu", "--requests", "3", "--slots", "2",
         "--max-ctx", "48"],
        cwd=ROOT, env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin"},
        capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "3 requests" in r.stdout


def test_serve_cli_runs_on_cpu():
    _cli("granite_3_2b")


def test_serve_cli_runs_ssm_on_cpu():
    _cli("mamba2_2p7b")


def test_serve_spatial_mode_is_not_ported(monkeypatch):
    """The spatial mode is ported now, and runs on the card by default:
    where there is none it refuses (nothing carries on on the CPU) before
    it builds anything. ``test_torch_serving.py`` runs it with --device
    cpu."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserve.main(["spatial"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserve.main(["--n", "100"])   # spatial is the default mode


def test_unknown_arch_and_foreign_tree_raise():
    with pytest.raises(KeyError):
        get_arch("glin")
    cfg = get_arch("granite_3_2b").reduced()
    tree = jax.tree_util.tree_map(
        np.asarray, rtf.init_params(rget("granite_3_2b").reduced(),
                                    jax.random.PRNGKey(0)))
    del tree["blocks"]["mlp"]["wg"]
    with pytest.raises(ValueError, match="parameter tree"):
        params_from_reference(cfg, tree, "cpu")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_configs_equal_the_reference(arch):
    assert dataclasses.asdict(get_arch(arch)) == dataclasses.asdict(
        rget(arch))
    assert dataclasses.asdict(get_arch(arch).reduced()) == (
        dataclasses.asdict(rget(arch).reduced()))
    assert get_arch(arch).param_count() == rget(arch).param_count()
