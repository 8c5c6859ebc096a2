"""The port's MoE FFN (``repro_torch.models.moe``) against the reference's
``repro.models.moe.moe_ffn``, in fp32 on reduced ``mixtral_8x22b`` and
``qwen3_moe_235b`` (4 experts, top-2), with the same numpy inputs and the
reference's layer-0 weights carried by ``params_from_reference``.

Cases: no drops (32 tokens: the capacity floor of 128 holds them all);
drops (1,024 tokens, the capacity 640, with a bias column: input feature 0
set to 1 and 8 added to the router's row 0 for experts 0 and 1, applied
alike in both packages, so nearly every token picks those two and each
overflows; the last tokens lose both replicas and their rows are zeros);
the sequence-chunked path (``chunk_tokens`` 512 over 2 x 512 tokens: two
chunks of 2 x 256, each with its own capacity of 384, the bias again); and
an ungated (GELU) MLP. Outputs within 2e-5 absolute and 1e-5 relative: the
same fp32 function, products summed in another order (two BLAS
libraries), on outputs of magnitude ~1.

A numpy oracle of the routing rule (fp64 softmax, the top-k with the lower
expert first on a tie, the replicas' stable order by expert, ranks against
the capacity) holds the port's experts, ranks, kept replicas and drop count
exactly; each case checks first that no token's k-th and next probability
lie within 1e-6 of each other, where fp32 and fp64 could rank apart.
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")         # the reference needs jax
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
from repro.configs import get_arch as rget  # noqa: E402
from repro.models import moe as rmoe  # noqa: E402
from repro.models import transformer as rtf  # noqa: E402
from repro.sharding import constrain  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402

TOL = dict(atol=2e-5, rtol=1e-5)
BIAS = 8.0
# (arch, batch, seq, chunk_tokens, bias, mlp_gated)
CASES = {
    "mixtral": ("mixtral_8x22b", 2, 16, moe.CHUNK_TOKENS, False, True),
    "qwen3": ("qwen3_moe_235b", 2, 16, moe.CHUNK_TOKENS, False, True),
    "mixtral_drops": ("mixtral_8x22b", 2, 512, moe.CHUNK_TOKENS, True, True),
    "qwen3_drops": ("qwen3_moe_235b", 2, 512, moe.CHUNK_TOKENS, True, True),
    "mixtral_chunked": ("mixtral_8x22b", 2, 512, 512, True, True),
    "mixtral_gelu": ("mixtral_8x22b", 2, 16, moe.CHUNK_TOKENS, False, False),
}


def oracle(x, router, k, cap):
    """The routing rule in numpy: (experts (T, k), ranks (T*k,), keep)."""
    logits = x.astype(np.float64) @ router.astype(np.float64)
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    ranked = np.argsort(-probs, axis=-1, kind="stable")
    top = np.sort(probs, -1)[:, ::-1]
    assert (top[:, k - 1] - top[:, k]).min() > 1e-6, "a near-tie"
    eidx = ranked[:, :k]
    flat = eidx.reshape(-1)
    seen, rank = {}, np.empty(flat.size, np.int64)
    for r, e in enumerate(flat):          # (token, slot) order
        rank[r] = seen.get(e, 0)
        seen[e] = rank[r] + 1
    return eidx, rank, rank < cap


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    arch, b, s, chunk, bias, gated = CASES[request.param]
    rcfg = dataclasses.replace(rget(arch).reduced(), mlp_gated=gated)
    cfg = dataclasses.replace(get_arch(arch).reduced(), mlp_gated=gated)
    tree = jax.tree_util.tree_map(
        np.asarray, rtf.init_params(rcfg, jax.random.PRNGKey(7)))
    layer = {k: v[0].copy() for k, v in tree["blocks"]["moe"].items()}
    rng = np.random.default_rng(len(request.param))
    x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    if bias:
        x[..., 0] = 1.0
        layer["router"][0, :2] += BIAS
    p = {k: v[0] for k, v in
         params_from_reference(cfg, tree, "cpu")["blocks"]["moe"].items()}
    p["router"] = torch.from_numpy(layer["router"])
    ref = jax.jit(lambda xx, pp: rmoe.moe_ffn(xx, pp, rcfg, constrain,
                                              chunk_tokens=chunk))
    want = np.asarray(ref(jnp.asarray(x),
                          {k: jnp.asarray(v) for k, v in layer.items()}))
    moe.stats.reset()
    got = moe.moe_ffn(torch.from_numpy(x), p, cfg, chunk_tokens=chunk)
    return dict(name=request.param, cfg=cfg, x=x, p=p, chunk=chunk,
                want=want, got=got.numpy(), stats=moe.stats.read(),
                bias=bias)


def test_moe_ffn_matches_reference(case):
    assert case["got"].dtype == np.float32
    np.testing.assert_allclose(case["got"], case["want"], **TOL)


def test_zeroed_rows_match_reference(case):
    """Tokens that lose every replica get zero rows in both packages (the
    bias cases have some, the others none)."""
    want = (case["want"] == 0).all(-1)
    got = (case["got"] == 0).all(-1)
    np.testing.assert_array_equal(got, want)
    assert want.any() == case["bias"]


def _chunks(case):
    """Each dispatch chunk's flat tokens, in the port's chunking."""
    x, b = case["x"], case["x"].shape[0]
    t = x.shape[0] * x.shape[1]
    if t <= case["chunk"]:
        return [x.reshape(t, -1)]
    cs = case["chunk"] // b
    return [x[:, i:i + cs].reshape(b * cs, -1)
            for i in range(0, x.shape[1], cs)]


def test_routing_matches_numpy_oracle(case):
    """Per chunk: the port's experts, ranks and kept replicas are the
    oracle's; the drop count and largest load in ``moe.stats`` are its
    sums over the chunks."""
    cfg, router = case["cfg"], case["p"]["router"]
    dropped, max_load = 0, 0
    for xf in _chunks(case):
        r = moe.route(torch.from_numpy(xf), router, cfg.top_k)
        assert r.cap == moe.capacity(xf.shape[0], cfg.top_k, cfg.n_experts)
        eidx, rank, keep = oracle(xf, router.numpy(), cfg.top_k, r.cap)
        np.testing.assert_array_equal(r.eidx.numpy(), eidx)
        np.testing.assert_array_equal(r.rank.numpy(), rank)
        np.testing.assert_array_equal(r.keep.numpy(), keep)
        loads = np.bincount(eidx.reshape(-1), minlength=cfg.n_experts)
        np.testing.assert_array_equal(r.counts.numpy(), loads)
        dropped += int((~keep).sum())
        max_load = max(max_load, int(loads.max()))
    assert case["stats"] == {"calls": len(_chunks(case)),
                             "replicas": case["x"].shape[0]
                             * case["x"].shape[1] * cfg.top_k,
                             "dropped": dropped, "max_load": max_load}
    assert (dropped > 0) == case["bias"]


def test_capacity_rule():
    """``max(128, min(ceil(T k cf / E / 128) 128, T))``, cf 1.25: the
    floor, the token count and the rounding each bind."""
    assert moe.capacity(8, 2, 8) == 128            # a decode step
    assert moe.capacity(512, 2, 8) == 256          # mixtral, 512 tokens
    assert moe.capacity(384, 2, 8) == 128
    assert moe.capacity(512, 8, 128) == 128        # qwen3
    assert moe.capacity(4608, 2, 8) == 1536
    assert moe.capacity(1024, 2, 4) == 640
    assert moe.capacity(512, 2, 4) == 384          # a chunk of 2 x 256
    assert moe.capacity(256, 2, 4) == 256


def test_router_tie_takes_the_lower_expert():
    """Equal probabilities rank by expert id, as ``lax.top_k``."""
    router = torch.zeros(4, 6)
    router[0, 3] = router[0, 5] = 1.0
    r = moe.route(torch.ones(2, 4), router, 3)
    assert r.eidx.tolist() == [[3, 5, 0], [3, 5, 0]]
    assert r.rank.tolist() == [0, 0, 0, 1, 1, 1]
