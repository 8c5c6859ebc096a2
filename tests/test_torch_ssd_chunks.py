"""The CUDA ``ssd_scan``'s design against the reference, on the CPU.

``tests/_ssd_chunks.py`` mirrors the kernel's phases in plain torch: its
64-step chunks, the warp scan of g, C B^T once per chunk, each chunk's state
contribution, the pass over the chunks and the carry-in, with every fp32
operand of a product split into bf16 hi + lo as the tensor cores take it
(emulated exactly: bf16-rounded operands multiplied in fp32). The mirror
must compute what the reference computes on the same inputs (numpy seed):
the exact recurrence ``ref.ssd_ref``, the Pallas kernel in interpret mode
through ``repro.kernels.ops.ssd_scan``, and ``ssd_chunked``'s final state,
at the sweep of ``tests/test_torch_ssd.py``, at S that the tile does not
divide (1, 65, 100) and at the largest N (256). Tolerance: 2e-4 / 1e-3
(atol / rtol), the reference's own kernel tests; a bf16 y is rounded once
more, so one bf16 step (2^-7 relative) on top. ``test_torch_cuda.py`` holds
the kernel itself against the plain version on the card.
"""
import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")   # the reference needs jax
torch.set_num_threads(1)

from _ssd_chunks import split, split_product, ssd_chunks, warp_cumsum  # noqa: E402
from repro.kernels import ops as rops  # noqa: E402
from repro.kernels import ref as rref  # noqa: E402
from repro.models.ssm import ssd_chunked  # noqa: E402

TOL = dict(atol=2e-4, rtol=1e-3)
BF16_STEP = 2.0 ** -7
SWEEP = [(128, 2, 16, 8), (256, 3, 32, 16), (256, 1, 64, 32)]


def _inputs(b, s, h, p, n, seed, dt_hi=0.1):
    """(x, dt, a, b, c) as numpy fp32, the ranges of tests/test_kernels.py."""
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, (b, s, h, p)).astype(np.float32),
            rng.uniform(0.001, dt_hi, (b, s, h)).astype(np.float32),
            -rng.uniform(0.1, 1.0, h).astype(np.float32),
            rng.normal(0, 1, (b, s, n)).astype(np.float32),
            rng.normal(0, 1, (b, s, n)).astype(np.float32))


def _torch(args, dtype):
    """x, b and c in ``dtype``; dt and a stay fp32."""
    x, dt, a, b, c = (torch.from_numpy(v) for v in args)
    return x.to(dtype), dt, a, b.to(dtype), c.to(dtype)


def _as_given(targs):
    """The values the kernel sees (bf16-rounded where the inputs are bf16),
    as numpy fp32 for the reference."""
    return tuple(jnp.asarray(t.float().numpy()) for t in targs)


def _close(got, want, dtype):
    tol = dict(TOL)
    if dtype == torch.bfloat16:
        tol["rtol"] += BF16_STEP
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want), **tol)


def test_split_leaves_a_residual_below_two_to_the_minus_16():
    """hi + lo carries v to 2^-16 of |v| (each bf16 rounding keeps 8
    bits), over fp32's normal range."""
    rng = np.random.default_rng(0)
    v = torch.from_numpy((rng.normal(0, 1, 4096) * 10.0 ** rng.uniform(
        -30, 30, 4096)).astype(np.float32))
    hi, lo = split(v)
    assert torch.equal(hi.to(torch.bfloat16).float(), hi)
    assert torch.equal(lo.to(torch.bfloat16).float(), lo)
    assert ((v - hi - lo).abs() <= 2.0 ** -16 * v.abs()).all()


def test_split_product_against_float64():
    """The split products of fp32 operands land within 2^-15 of the
    operands' magnitude of the exact product; bf16 operands need no
    split (their products are exact in fp32)."""
    rng = np.random.default_rng(1)
    a = torch.from_numpy(rng.normal(0, 1, (32, 48)).astype(np.float32))
    b = torch.from_numpy(rng.normal(0, 1, (48, 24)).astype(np.float32))
    exact = a.double() @ b.double()
    mag = a.double().abs() @ b.double().abs()
    for a_exact, b_exact in ((False, False), (True, False), (False, True)):
        aa = a.bfloat16().float() if a_exact else a
        bb = b.bfloat16().float() if b_exact else b
        got = split_product("ik,kj->ij", aa, bb, a_exact, b_exact).double()
        want = aa.double() @ bb.double()
        assert ((got - want).abs() <= 2.0 ** -15 * mag).all()
    assert not torch.equal(exact, exact.float().double())   # fp32 rounds


def test_warp_cumsum_is_a_cumsum():
    rng = np.random.default_rng(2)
    v = torch.from_numpy(-rng.uniform(0, 0.1, (3, 64, 5)).astype(np.float32))
    torch.testing.assert_close(warp_cumsum(v), torch.cumsum(v, 1),
                               atol=1e-6, rtol=1e-6)
    one = torch.ones(1, 64, 1)
    assert torch.equal(warp_cumsum(one)[0, :, 0], torch.arange(1., 65.))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("s,h,p,n", SWEEP)
def test_mirror_matches_reference(s, h, p, n, dtype):
    """y against the exact recurrence, the final state against
    ``ssd_chunked``'s, on the values the kernel sees."""
    targs = _torch(_inputs(2, s, h, p, n, s + p + n), dtype)
    y, state = ssd_chunks(*targs, return_state=True)
    assert y.dtype == dtype and state.dtype == torch.float32
    assert state.shape == (2, h, n, p)
    jargs = _as_given(targs)
    _close(y, rref.ssd_ref(*jargs), dtype)
    _, want_state = ssd_chunked(*jargs, chunk=64)
    _close(state, want_state, torch.float32)


@pytest.mark.parametrize("s,n", [(1, 8), (65, 16), (100, 256)])
def test_mirror_partial_tiles(s, n):
    """S that the 64-step tile does not divide (the last chunk reads dt = 0
    and zero x, B, C) and the largest N; bf16 inputs, as the model's."""
    targs = _torch(_inputs(1, s, 2, 40 if s == 65 else 16, n, s + n),
                   torch.bfloat16)
    y, state = ssd_chunks(*targs, return_state=True)
    jargs = _as_given(targs)
    _close(y, rref.ssd_ref(*jargs), torch.bfloat16)
    _, want_state = ssd_chunked(*jargs, chunk=s)
    _close(state, want_state, torch.float32)


@pytest.mark.parametrize("tile", [64, 128])
def test_mirror_matches_interpreted_pallas_kernel(tile):
    """The Pallas kernel (interpret mode, chunk 32) and the mirror at the
    kernel's tile and at twice it: the tile changes no output."""
    args = _inputs(2, 128, 3, 16, 8, 7)
    want = np.asarray(rops.ssd_scan(*(jnp.asarray(v) for v in args),
                                    chunk=32))
    _close(ssd_chunks(*_torch(args, torch.float32), tile=tile), want,
           torch.float32)


def test_mirror_masked_exponent_overflow_stays_finite():
    """dt * a near -40 a step: above the diagonal g_i - g_j overflows e^x;
    the mask comes before the exponential, so y stays finite."""
    args = list(_inputs(1, 128, 2, 8, 4, 19))
    args[1] = np.full_like(args[1], 20.0)
    args[2] = np.asarray([-2.0, -1.5], np.float32)
    targs = _torch(args, torch.float32)
    y, state = ssd_chunks(*targs, return_state=True)
    assert torch.isfinite(y).all() and torch.isfinite(state).all()
    _close(y, rref.ssd_ref(*_as_given(targs)), torch.float32)


@pytest.mark.parametrize("s,p,n", [(512, 64, 128), (65, 40, 256), (1, 16, 8)])
def test_the_launch_allocates_the_phases_scratch(monkeypatch, s, p, n):
    """What a card's call hands the C entry point (reached on the CPU by
    patching the router and the launcher): the operands, the fp32 scratch
    of the phases at the kernel's 64-step tile (C B^T per chunk, the
    per-chunk (P, N16) states, g_tot), the sizes and the strides of the
    views, one argument per C parameter; one call counts one launch."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import ssd as kssd

    calls = []
    monkeypatch.setattr(kssd, "_route", lambda *t: True)
    monkeypatch.setattr(kssd, "_launch",
                        lambda name, device, *a: calls.append((name, a)))
    h = 3
    conv = torch.zeros(2, s, h * p + 2 * n, dtype=torch.bfloat16)
    x = conv[..., :h * p].reshape(2, s, h, p)
    bm, cm = conv[..., h * p:h * p + n], conv[..., h * p + n:]
    dt, a = torch.zeros(2, s, h), torch.zeros(h)
    n0 = kssd.ssd_scan.launches
    y, state = kssd.ssd_scan(x, dt, a, bm, cm, 128, return_state=True)
    assert kssd.ssd_scan.launches == n0 + 1
    (name, args), = calls
    assert name == "glin_ssd_scan"
    assert len(args) + 1 == len(_build._SIGNATURES[name])
    assert args[5] is y and args[6] is state
    assert y.dtype == torch.bfloat16 and state.shape == (2, h, n, p)
    nc, n16 = -(-s // 64), -(-n // 16) * 16
    cb, ut, gtot = args[7:10]
    assert kssd.TILE == 64
    assert cb.shape == (2, nc, 64, 64) and ut.shape == (2, h, nc, p, n16)
    assert gtot.shape == (2, h, nc)
    assert all(t.dtype == torch.float32 for t in (cb, ut, gtot))
    assert args[10:16] == (2, s, h, p, n, 1)
    assert args[16:] == (*x.stride()[:3], *dt.stride()[:2],
                         *bm.stride()[:2], *cm.stride()[:2])
