"""The port's last four families of the reference's pool against the
reference, at ``cfg.reduced()`` in fp32 with the reference's weights carried
by ``params_from_reference``:

* ``mixtral_8x22b`` (moe: 4 of its experts, top-2, its window cut to 32 so
  a 40-token prompt binds it: the ring rolls in prefill and wraps in
  decode);
* ``qwen3_moe_235b`` (moe with QK-norm);
* ``qwen2_vl_2b`` (vlm: M-RoPE over (t, h, w) streams, the ``embed_stub``
  frontend); its prompt's first 16 embeddings sit on a 4 x 4 patch grid
  (t = 0, h = row, w = col), the rest at their index in all three streams,
  and the decode steps continue at the cache's ``pos``;
* ``musicgen_medium`` (audio: ``embed_stub``, GELU MLP, MHA, untied head).

Each: prefill's last logits and every cache leaf, then 6 decode steps (the
port's also against its own full forward), at the fp32 tolerances of
``tests/test_torch_lm.py`` (the reference's own decode-vs-forward ones in
``tests/test_models.py``). Then the port's ``SlotServer`` against the
reference's for both MoE configs (equal greedy tokens), the CLI on the CPU
for one, the token-only server refusing an ``embed_stub`` model, M-RoPE
against the reference's ``mrope``, the family checks, and the full-width
parameter trees against ``param_count()``.
"""
import dataclasses
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
from repro.models import layers as rlayers  # noqa: E402
from repro.models import transformer as rtf  # noqa: E402
from repro.sharding import constrain  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("mixtral_8x22b", "qwen3_moe_235b", "qwen2_vl_2b", "musicgen_medium")
MOE = ("mixtral_8x22b", "qwen3_moe_235b")
B, S, EXTRA, CTX, GRID = 2, 40, 6, 64, 4
FP32 = {"prefill": (2e-4, 1e-3), "decode": (5e-4, 1e-2), "kv": (2e-4, 1e-3)}


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def grid_positions(b, s, grid):
    """(B, 3, S): a grid x grid patch grid first (t 0, h the row, w the
    column), then each position's index in all three streams."""
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, 3, s)).copy()
    n = grid * grid
    pos[:, 0, :n] = 0
    pos[:, 1, :n] = np.arange(n) // grid
    pos[:, 2, :n] = np.arange(n) % grid
    return pos


def inputs(cfg, seed):
    """Per step the batch both packages take, as numpy: a prompt of S and
    EXTRA decode inputs (tokens, or embeddings under ``embed_stub``)."""
    rng = np.random.default_rng(seed)
    if cfg.frontend != "embed_stub":
        toks = rng.integers(0, cfg.vocab, (B, S + EXTRA)).astype(np.int32)
        return ({"tokens": toks[:, :S]},
                [{"tokens": toks[:, S + t]} for t in range(EXTRA)],
                lambda n: {"tokens": toks[:, :n]})
    emb = rng.standard_normal((B, S + EXTRA, cfg.d_model)).astype(np.float32)

    def upto(n):
        out = {"embeds": emb[:, :n]}
        if cfg.mrope:
            out["positions"] = grid_positions(B, n, GRID)
        return out
    return upto(S), [{"embeds": emb[:, S + t]} for t in range(EXTRA)], upto


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


@pytest.fixture(scope="module", params=ARCHS)
def run(request):
    """Prefill + 6 decode steps of both packages on the same inputs and the
    same (carried) weights, and the port's forward at each step (the
    reference jitted, as its SlotServer runs it)."""
    arch = request.param
    rcfg, cfg = rget(arch).reduced(), get_arch(arch).reduced()
    rparams = jax.jit(rtf.init_params, static_argnums=0)(
        rcfg, jax.random.PRNGKey(1))
    params = params_from_reference(
        cfg, jax.tree_util.tree_map(np.asarray, rparams), "cpu")
    rprefill = jax.jit(lambda p, b: rtf.prefill(p, rcfg, b, constrain,
                                                seq_len_cache=CTX))
    rdecode = jax.jit(lambda p, b, c: rtf.decode_step(p, rcfg, b, c,
                                                      constrain))
    prompt, steps, upto = inputs(cfg, 1)
    rl, rc = rprefill(rparams, _jax(prompt))
    tl, tc = tf.prefill(params, cfg, _torch(prompt), seq_len_cache=CTX)
    out = {"arch": arch, "cfg": cfg, "prefill": (_np(rl), tl.numpy()),
           "dec": [], "fwd": [],
           "cache": ({k: _np(v) for k, v in rc["attn"].items()},
                     {k: v.float().numpy().copy()    # updated in place
                      for k, v in tc["attn"].items()})}
    for t, step in enumerate(steps):
        rd, rc = rdecode(rparams, _jax(step), rc)
        td, tc = tf.decode_step(params, cfg, _torch(step), tc)
        full, _ = tf.forward(params, cfg, _torch(upto(S + t + 1)),
                             logits_last_only=True)
        out["dec"].append((_np(rd), td.numpy()))
        out["fwd"].append(full[:, -1].numpy())
    out["final_abs_pos"] = (_np(rc["attn"]["abs_pos"]),
                            tc["attn"]["abs_pos"].numpy())
    return out


def test_prefill_logits_match_reference(run):
    atol, rtol = FP32["prefill"]
    np.testing.assert_allclose(run["prefill"][1], run["prefill"][0],
                               atol=atol, rtol=rtol)


def test_prefill_cache_matches_reference(run):
    want, got = run["cache"]
    assert set(got) == set(want) == {"k", "v", "abs_pos", "pos"}
    np.testing.assert_array_equal(got["abs_pos"], want["abs_pos"])
    np.testing.assert_array_equal(got["pos"], want["pos"])
    atol, rtol = FP32["kv"]
    for name in ("k", "v"):
        assert got[name].shape == want[name].shape
        np.testing.assert_allclose(got[name], want[name], atol=atol,
                                   rtol=rtol, err_msg=name)


def test_decode_steps_match_reference_and_forward(run):
    atol, rtol = FP32["decode"]
    for (want, got), fwd in zip(run["dec"], run["fwd"]):
        np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)
        np.testing.assert_allclose(got, fwd, atol=atol, rtol=rtol)
    np.testing.assert_array_equal(*run["final_abs_pos"])


def test_ring_rolls_where_the_window_binds(run):
    """Mixtral's reduced window of 32 binds past the 40-token prompt: the
    ring holds the last 32 positions; the others keep the whole context."""
    cfg, ap = run["cfg"], run["final_abs_pos"][1]
    end = S + EXTRA
    if run["arch"] == "mixtral_8x22b":
        assert cfg.window == 32 and ap.shape[-1] == 32
        assert ap.min() == end - 32 and ap.max() == end - 1
    else:
        assert cfg.window == 0 and ap.shape[-1] == CTX
        assert ap.max() == end - 1 and (ap == -1).sum() == ap.shape[0] * (
            ap.shape[1] * (CTX - end))


def _serve(server, prompts, gens):
    """Drive a SlotServer as ``main_lm`` does; each request's tokens."""
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


@pytest.mark.parametrize("arch", MOE)
def test_moe_slot_server_matches_reference(arch):
    """2 slots, 3 requests (the third admitted when the first finishes):
    the greedy tokens are the reference's; mixtral's 12-token prompts and
    up to 21 generated tokens pass its reduced window of 32."""
    rcfg, cfg = rget(arch).reduced(), get_arch(arch).reduced()
    rparams = jax.jit(rtf.init_params, static_argnums=0)(
        rcfg, jax.random.PRNGKey(4))
    params = params_from_reference(
        cfg, jax.tree_util.tree_map(np.asarray, rparams), "cpu")
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab, 12).astype(np.int32)
               for _ in range(3)]
    gens = [5, 21, 6]
    want = _serve(rserve.SlotServer(rcfg, rparams, 2, 40), prompts, gens)
    got = _serve(tserve.SlotServer(cfg, params, 2, 40, device="cpu"),
                 prompts, gens)
    assert [len(g) for g in got] == gens
    assert got == want


def _cli(arch):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "lm", "--arch",
         arch, "--device", "cpu", "--requests", "3", "--slots", "2",
         "--max-ctx", "48"],
        cwd=ROOT, env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin"},
        capture_output=True, text=True, timeout=120)


def test_serve_cli_runs_moe_on_cpu():
    r = _cli("qwen3_moe_235b")
    assert r.returncode == 0, r.stderr
    assert "3 requests" in r.stdout


@pytest.mark.parametrize("arch", ("qwen2_vl_2b", "musicgen_medium"))
def test_token_server_refuses_embed_stub(arch):
    """The slot server takes tokens only, as the reference's: an
    embed_stub model is refused, before any weight is drawn."""
    cfg = get_arch(arch).reduced()
    with pytest.raises(ValueError, match="tokens only"):
        tserve.SlotServer(cfg, {}, 2, 32, device="cpu")
    with pytest.raises(ValueError, match="tokens only"):
        tserve.main(["lm", "--arch", arch, "--device", "cpu"])


def test_mrope_matches_reference():
    """Distinct (t, h, w) streams over the full width's sections (16, 24,
    24) of head dim 128; a (B, S) stream taken as t = h = w is RoPE."""
    cfg = get_arch("qwen2_vl_2b")
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 24, 3, cfg.head_dim)).astype(np.float32)
    pos = grid_positions(2, 24, 4)
    pos[1] += 7
    want = _np(rlayers.mrope(jnp.asarray(x), jnp.asarray(pos),
                             cfg.mrope_sections, cfg.rope_theta))
    got = tlayers.apply_rot(torch.from_numpy(x), *tattn.rot_tables(
        cfg, torch.from_numpy(pos))).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    flat = torch.from_numpy(pos[:, 2].copy())
    text = dataclasses.replace(cfg, mrope=False)
    for a, b in zip(tattn.rot_tables(cfg, flat), tattn.rot_tables(text, flat)):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0)


@pytest.mark.parametrize("arch,change,why", [
    ("mixtral_8x22b", {"n_experts": 0}, "moe config needs"),
    ("mixtral_8x22b", {"top_k": 9}, "moe config needs"),
    ("granite_3_2b", {"n_experts": 4, "top_k": 2}, "moe family"),
    ("qwen2_vl_2b", {"mrope": False}, "M-RoPE"),
    ("musicgen_medium", {"frontend": "text"}, "embed_stub"),
    ("musicgen_medium", {"frontend": "vision"}, "unknown frontend"),
])
def test_contradicting_flags_raise(arch, change, why):
    cfg = dataclasses.replace(get_arch(arch).reduced(), **change)
    with pytest.raises(NotImplementedError, match=why):
        tf.param_shapes(cfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_tree_counts_param_count(arch):
    """The port's parameter tree at full width (no tensor allocated) counts
    the reference's ``param_count``; the MoE router is an fp32 leaf, the
    QK-norm scales (head_dim,) a layer."""
    cfg = get_arch(arch)
    shapes = tf.param_shapes(cfg)

    def count(tree):
        return sum(count(v) if isinstance(v, dict) else math.prod(v.shape)
                   for v in tree.values())

    assert count(shapes) == cfg.param_count() == rget(arch).param_count()
    blocks = shapes["blocks"]
    if cfg.is_moe:
        assert blocks["moe"]["router"].dtype == torch.float32
        assert blocks["moe"]["wg"].shape == (cfg.n_layers, cfg.n_experts,
                                             cfg.d_model, cfg.d_ff)
        assert "mlp" not in blocks
    assert ("qn" in blocks["attn"]) == cfg.qk_norm == (
        arch == "qwen3_moe_235b")
