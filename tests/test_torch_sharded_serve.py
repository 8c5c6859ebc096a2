"""The sharded prefill and decode builders (``train.step.
build_prefill_step`` / ``build_decode_step``) over a (4, 2) ``("data",
"model")`` mesh of CPU positions, held against the reference's and against
the port's single-device ``prefill`` / ``decode_step``; B8's log-sum-exp
and the cross-position softmax merge.

The reference runs once, in a subprocess with eight host devices, started
by a module fixture while the port-only tests run: its builders jitted
with their shardings on the ``reduced()`` granite_3_2b (a 40-token prompt
into a 48-slot cache, whose slots split 24 | 24 over ``model``, and an
8-token prompt, whose valid slots all lie on the first position),
mixtral_8x22b (window 32: the 40-token prompt wraps the ring),
mamba2_2p7b and hymba_1p5b (8 meta tokens, window 32: both caches), and
granite_3_2b with a 44-token prompt into a 47-slot ring, whose slots do
not split over 2 ``model`` positions and whose 4 kv heads do (the rules
lay it out by kv heads; the fourth decode step wraps it), also with 2
kv heads (a GQA group of 2: each position's 2 query heads read its one kv
head), each
prefill followed by 4 teacher-forced decode steps. fp32 throughout: the
logits and every cache leaf within 1e-5 of the largest magnitude (integer
leaves exactly), the layouts leaf for leaf.
"""
import dataclasses
import json
import math

import numpy as np
import pytest
import torch

from _sharded import (cpu_mesh, leaf_close, spec_tuple, start_reference,
                      stop_reference, tree, wait_reference)
from repro_torch.configs import ShapeConfig, get_arch
from repro_torch.kernels import attention as katt
from repro_torch.models import convert
from repro_torch.models import parallel_serve as pserve
from repro_torch.models import transformer as tf
from repro_torch.sharding import MeshRules, gather, place_tree
from repro_torch.train import step as tstep
from repro_torch.utils.tree import paths

B, STEPS = 8, 4
# tag: (arch, prompt, cache slots, fields of the reduced config replaced)
CASES = {"granite": ("granite_3_2b", 40, 48, {}),
         "granite_one_side": ("granite_3_2b", 8, 48, {}),
         "mixtral_wraps": ("mixtral_8x22b", 40, 48, {}),
         "mamba2": ("mamba2_2p7b", 40, 48, {}),
         "hymba": ("hymba_1p5b", 40, 48, {}),
         "granite_by_heads": ("granite_3_2b", 44, 47, {}),
         "granite_gqa_by_heads": ("granite_3_2b", 44, 47, {"n_kv_heads": 2})}

_REF = r'''
import dataclasses, json, sys
import numpy as np, jax
from repro.utils.compat import make_auto_mesh
from repro.configs.base import get_arch, ShapeConfig
from repro.sharding import MeshRules
from repro.train.step import build_prefill_step, build_decode_step
from repro.models import transformer as tf

out, specs = {{}}, {{}}

def pack(prefix, tree):
    for pp, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                       for p in pp)
        out[prefix + "/" + key] = np.asarray(leaf)

def spec_of(tree):
    return jax.tree_util.tree_map(
        lambda sh: [list(e) if isinstance(e, tuple) else e
                    for e in sh.spec], tree)

mesh = make_auto_mesh((4, 2), ("data", "model"))
rules = MeshRules(mesh=mesh)
for tag, (arch, prompt, seq, over) in {CASES!r}.items():
    cfg = dataclasses.replace(get_arch(arch).reduced(), **over)
    params = tf.init_params(cfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab, ({B}, prompt + {STEPS})
                          ).astype(np.int32)
    pf, pin, pout, _ = build_prefill_step(
        cfg, ShapeConfig("p", seq, {B}, "prefill"), rules)
    df, din, dout, _ = build_decode_step(
        cfg, ShapeConfig("d", seq, {B}, "decode"), rules)
    specs[tag] = {{"prefill_in": spec_of(pin), "prefill_out": spec_of(pout),
                  "decode_in": spec_of(din), "decode_out": spec_of(dout)}}
    with mesh:
        pd = jax.tree_util.tree_map(jax.device_put, params, pin[0])
        lg, cache = jax.jit(pf, in_shardings=pin, out_shardings=pout)(
            pd, {{"tokens": jax.device_put(tokens[:, :prompt],
                                          pin[1]["tokens"])}})
        pack(tag + "/prefill_cache", cache)
        out[tag + "/logits/0"] = np.asarray(lg)
        step = jax.jit(df, in_shardings=din, out_shardings=dout)
        for t in range({STEPS}):
            lg, cache = step(pd, cache, {{"tokens": jax.device_put(
                tokens[:, prompt + t], din[2]["tokens"])}})
            out[tag + "/logits/" + str(t + 1)] = np.asarray(lg)
        pack(tag + "/cache", cache)
    pack(tag + "/params", params)
    out[tag + "/tokens"] = tokens
np.savez(sys.argv[1], **out)
with open(sys.argv[1] + ".json", "w") as f:
    json.dump(specs, f)
print("REF-OK")
'''


@pytest.fixture(scope="module", autouse=True)
def ref_run(tmp_path_factory):
    d = tmp_path_factory.mktemp("sharded_serve_ref")
    proc, logs = start_reference(_REF, d, CASES=CASES, B=B, STEPS=STEPS)
    yield proc, d
    stop_reference(proc, logs)


@pytest.fixture(scope="module")
def ref(ref_run):
    data = wait_reference(*ref_run)
    with open(ref_run[1] / "ref.npz.json") as f:
        data["specs"] = json.load(f)
    return data


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    if np.issubdtype(want.dtype, np.integer):
        np.testing.assert_array_equal(got, want)
    else:
        leaf_close(got, want)


# ---------------------------------------------------- B8's log-sum-exp
def _decode_inputs(seed, b=4, hq=8, hkv=2, w=40, d=16):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(b, hq, d, generator=g)
    k = torch.randn(b, hkv, w, d, generator=g)
    v = torch.randn(b, hkv, w, d, generator=g)
    ap = torch.randint(-1, 50, (b, w), generator=g, dtype=torch.int32)
    ap[0] = -1                                   # a row with no live slot
    pos = torch.tensor([10, 30, 45, 49], dtype=torch.int32)[:b]
    return q, k, v, ap, pos


@pytest.mark.parametrize("window", [0, 8])
def test_decode_plain_lse_is_the_masked_logsumexp(window):
    q, k, v, ap, pos = _decode_inputs(0)
    out, lse = katt.decode_attention_plain(q, k, v, ap, pos, window,
                                           return_lse=True)
    assert torch.equal(out, katt.decode_attention_plain(q, k, v, ap, pos,
                                                        window))
    kk = k.repeat_interleave(4, dim=1)
    sc = torch.einsum("bhd,bhkd->bhk", q, kk) / math.sqrt(q.shape[-1])
    live = (ap >= 0) & (ap <= pos[:, None])
    if window:
        live &= pos[:, None] - ap < window
    for r in range(q.shape[0]):
        if not live[r].any():
            assert torch.isneginf(lse[r]).all()
            continue
        want = torch.logsumexp(sc[r][:, live[r]], dim=-1)
        torch.testing.assert_close(lse[r], want, rtol=0, atol=1e-6)


def test_decode_wrapper_hands_the_lse_buffer_to_the_kernel(monkeypatch):
    calls = []
    monkeypatch.setattr(katt, "_route", lambda *t: True)
    monkeypatch.setattr(katt, "_launch",
                        lambda name, device, *args: calls.append(args))
    q, k, v, ap, pos = _decode_inputs(1)
    out, lse = katt.decode_attention(q, k, v, ap, pos, 0, return_lse=True)
    assert calls[0][-1] is lse and lse.dtype == torch.float32
    assert lse.shape == (4, 8) and lse.is_contiguous()
    katt.decode_attention(q, k, v, ap, pos, 0)
    assert calls[1][-1] is None


@pytest.mark.parametrize("parts", [2, 3])
def test_merge_over_slot_ranges_equals_the_whole(parts):
    """The plain version over each of ``parts`` slot ranges, merged by
    their log-sum-exps, equals the plain version over every slot: rows
    with live slots on every part, on one part only, and on none."""
    q, k, v, ap, pos = _decode_inputs(2, w=42)
    ap[1, 14:] = -1                       # row 1: live slots at the start
    want = katt.decode_attention_plain(q, k, v, ap, pos, 0)
    cut = [i * 42 // parts for i in range(parts + 1)]
    outs, lses = zip(*[katt.decode_attention_plain(
        q, k[:, :, a:b], v[:, :, a:b], ap[:, a:b], pos, 0, return_lse=True)
        for a, b in zip(cut, cut[1:])])
    lses = torch.stack(lses)
    assert torch.isneginf(lses[1:, 1]).all()       # the empty sides
    got = pserve.merge_softmax(torch.stack(outs), lses)
    torch.testing.assert_close(got, want, rtol=0, atol=2e-6)


# ------------------------------------------------------------- layouts
def _cfg(tag):
    arch, _, _, over = CASES[tag]
    return dataclasses.replace(get_arch(arch).reduced(), **over)


def _builders(cfg, seq):
    rules = MeshRules(cpu_mesh())
    pre = tstep.build_prefill_step(cfg, ShapeConfig("p", seq, B, "prefill"),
                                   rules)
    dec = tstep.build_decode_step(cfg, ShapeConfig("d", seq, B, "decode"),
                                  rules)
    return cfg, rules, pre, dec


def _flat(t, prefix=""):
    """{path: spec tuple} of a builder's layouts: a tuple of NamedShardings
    and trees of them (the port's), or the reference's as JSON (a list of
    spec lists and trees of them)."""
    if prefix == "":
        out = {}
        for i, v in enumerate(t):
            out.update(_flat(v, f"{i}/"))
        return out
    if isinstance(t, dict):
        out = {}
        for k, v in t.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    spec = t.spec if hasattr(t, "spec") else [
        tuple(e) if isinstance(e, list) else e for e in t]
    return {prefix[:-1]: spec_tuple(spec)}


@pytest.mark.parametrize("tag", ["granite", "mixtral_wraps", "mamba2",
                                 "hymba", "granite_by_heads",
                                 "granite_gqa_by_heads"])
def test_layouts_match_the_reference(ref, tag):
    _, _, pre, dec = _builders(_cfg(tag), CASES[tag][2])
    want = ref["specs"][tag]
    got = {"prefill_in": pre[1], "prefill_out": pre[2],
           "decode_in": dec[1], "decode_out": dec[2]}
    for name in got:
        assert _flat(got[name]) == _flat(want[name]), name


# ------------------------------------------------------- the steps' values
def _run(ref, tag):
    """The port's sharded prefill + STEPS decode steps on the reference's
    weights and tokens: (logits per step, the cache after prefill and at
    the end, gathered), and the same on one device."""
    _, prompt, seq, _ = CASES[tag]
    cfg, rules, (pf, pin, pout, _), (df, din, _, _) = _builders(_cfg(tag),
                                                                 seq)
    params = convert.params_from_reference(cfg, tree(ref, tag + "/params"),
                                           device="cpu")
    tokens = torch.from_numpy(ref[tag + "/tokens"])
    pd = place_tree(params, pin[0])
    lg, cache = pf(pd, place_tree({"tokens": tokens[:, :prompt]}, pin[1]))
    for (k, s), (_, sh) in zip(paths(cache), paths(pout[1])):
        assert tuple(s.spec) == tuple(sh.spec), k
    logits = [gather(lg).numpy()]
    first = {k: gather(s).numpy() for k, s in paths(cache)}
    for t in range(STEPS):
        lg, cache = df(pd, cache, place_tree(
            {"tokens": tokens[:, prompt + t]}, din[2]))
        logits.append(gather(lg).numpy())
    last = {k: gather(s).numpy() for k, s in paths(cache)}
    l0, c0 = tf.prefill(params, cfg, {"tokens": tokens[:, :prompt]},
                        seq_len_cache=seq)
    one = [l0.numpy()]
    one_first = {k: v.clone().numpy() for k, v in paths(c0)}
    for t in range(STEPS):
        l0, c0 = tf.decode_step(params, cfg, {"tokens": tokens[:, prompt + t]},
                                c0)
        one.append(l0.numpy())
    one_last = {k: v.numpy() for k, v in paths(c0)}
    return (logits, first, last), (one, one_first, one_last)


@pytest.mark.parametrize("tag", list(CASES))
def test_prefill_and_decode_match_the_reference(ref, tag):
    (logits, first, last), _ = _run(ref, tag)
    for t, lg in enumerate(logits):
        _close(lg, ref[f"{tag}/logits/{t}"])
    for name, got in (("prefill_cache", first), ("cache", last)):
        want = dict(paths(tree(ref, f"{tag}/{name}")))
        assert got.keys() == want.keys()
        for k in got:
            _close(got[k], want[k])


@pytest.mark.parametrize("tag", list(CASES))
def test_prefill_and_decode_match_one_device(ref, tag):
    (logits, first, last), (one, one_first, one_last) = _run(ref, tag)
    for a, b in zip(logits, one):
        _close(a, b)
    for got, want in ((first, one_first), (last, one_last)):
        for k in got:
            _close(got[k], want[k])


def test_one_sided_merge(ref, monkeypatch):
    """An 8-token prompt in a 48-slot ring split 24 | 24: every decode
    step's valid slots lie on the first ``model`` position, so the second
    returns a log-sum-exp of -inf for every (row, head) and weighs 0; the
    logits still equal one device's."""
    seen = []
    real = katt.decode_attention

    def spy(q, k, v, ap, pos, window=0, return_lse=False):
        out = real(q, k, v, ap, pos, window, return_lse)
        if return_lse:
            seen.append(out[1].clone())
        return out
    monkeypatch.setattr(katt, "decode_attention", spy)
    (logits, _, _), (one, _, _) = _run(ref, "granite_one_side")
    cfg = get_arch("granite_3_2b").reduced()
    # per step and layer, the 8 positions in mesh order: (data, model)
    assert len(seen) == STEPS * cfg.n_layers * 8
    for i, lse in enumerate(seen):
        assert torch.isneginf(lse).all() == (i % 2 == 1), i
    for a, b in zip(logits, one):
        _close(a, b)


@pytest.mark.parametrize("arch", ["qwen2_vl_2b", "musicgen_medium",
                                  "granite_34b", "qwen3_moe_235b"])
def test_other_families_serve_as_one_device(arch):
    """The builders for the stub-frontend families (embeddings, M-RoPE
    positions), one kv head and QK-norm with the MoE: a 40-step prefill
    into a 48-slot ring and 4 decode steps equal one device's."""
    cfg = get_arch(arch).reduced()
    _, rules, (pf, pin, _, _), (df, din, _, _) = _builders(cfg, 48)
    params = tf.init_params(cfg, 0, device="cpu")
    g = torch.Generator().manual_seed(0)
    if cfg.frontend == "embed_stub":
        emb = torch.randn(B, 44, cfg.d_model, generator=g)
        prompt = {"embeds": emb[:, :40]}
        if cfg.mrope:
            prompt["positions"] = torch.randint(0, 40, (B, 3, 40),
                                                generator=g,
                                                dtype=torch.int32)
        steps = [{"embeds": emb[:, 40 + t]} for t in range(STEPS)]
    else:
        toks = torch.randint(0, cfg.vocab, (B, 44), generator=g,
                             dtype=torch.int32)
        prompt = {"tokens": toks[:, :40]}
        steps = [{"tokens": toks[:, 40 + t]} for t in range(STEPS)]
    pd = place_tree(params, pin[0])
    lg, cache = pf(pd, place_tree(prompt, pin[1]))
    l0, c0 = tf.prefill(params, cfg, prompt, seq_len_cache=48)
    _close(gather(lg).numpy(), l0.numpy())
    for st in steps:
        lg, cache = df(pd, cache, place_tree(st, din[2]))
        l0, c0 = tf.decode_step(params, cfg, st, c0)
        _close(gather(lg).numpy(), l0.numpy())
    for (k, a), (_, b) in zip(paths(cache), paths(c0)):
        _close(gather(a).numpy(), b.numpy())


@pytest.mark.parametrize("tag", ["granite_by_heads", "granite_gqa_by_heads"])
def test_by_heads_decode_runs_each_position_over_its_heads(ref, tag,
                                                           monkeypatch):
    """On the ring laid out by kv heads, B8 runs once a position and layer
    a step, on the position's 2 query heads over its own kv heads (2 of 4,
    or 1 of 2: a GQA group of 2) and every one of the 47 slots, without a
    log-sum-exp and without the merge; the logits still equal one
    device's."""
    seen, merged = [], []
    real = katt.decode_attention

    def spy(q, k, v, ap, pos, window=0, return_lse=False):
        seen.append((tuple(q.shape), tuple(k.shape), tuple(ap.shape),
                     return_lse))
        return real(q, k, v, ap, pos, window, return_lse)
    monkeypatch.setattr(katt, "decode_attention", spy)
    monkeypatch.setattr(pserve, "merge_softmax",
                        lambda *a: merged.append(1))
    (logits, _, _), (one, _, _) = _run(ref, tag)
    cfg = _cfg(tag)
    hkv = cfg.n_kv_heads // 2
    # the one-device run's calls take every row and head
    sharded = [c for c in seen if c[0][0] == B // 4]
    assert len(seen) - len(sharded) == STEPS * cfg.n_layers
    assert len(sharded) == STEPS * cfg.n_layers * 8
    assert set(sharded) == {((B // 4, 2, 16), (B // 4, hkv, 47, 16),
                             (B // 4, 47), False)}
    assert not merged
    for a, b in zip(logits, one):
        _close(a, b)
