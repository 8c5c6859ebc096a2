"""The SSD scan's plain version and wrapper against the reference.

On the CPU ``ssd_scan`` takes its plain version, ``ssd_scan_plain``
(``ssd_chunked``'s algorithm in torch), which must compute what the
reference computes on the same inputs (numpy seed): the Pallas kernel in
interpret mode through ``repro.kernels.ops.ssd_scan``, the exact recurrence
``ref.ssd_ref``, and ``repro.models.ssm.ssd_chunked``'s final state — at the
shapes of ``tests/test_kernels.py``'s sweep, over its chunk-invariance case
(chunks 32, 64, 96 and 192 over S = 192), and for an S that the chunk does
not divide (``ops``'s fallback to one chunk of S; the plain version's
zero-padded last chunk). Tolerance in fp32: 2e-4 / 1e-3 (atol / rtol), the
reference's own kernel tests. bf16 inputs: y is rounded to bf16 once, so
the bound is one bf16 step at the output's magnitude (2^-7 relative) on
top of the fp32 tolerance. ``test_torch_cuda.py`` holds the CUDA kernel
against this plain version on the card.
"""
import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")   # the reference needs jax
torch.set_num_threads(1)

from repro.kernels import ops as rops  # noqa: E402
from repro.kernels import ref as rref  # noqa: E402
from repro.models.ssm import ssd_chunked  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ssd  # noqa: E402

TOL = dict(atol=2e-4, rtol=1e-3)
SWEEP = [(128, 2, 16, 8, 32), (256, 3, 32, 16, 64), (256, 1, 64, 32, 128)]


def _inputs(b, s, h, p, n, seed, dt_hi=0.1):
    """(x, dt, a, b, c) as numpy fp32, the ranges of tests/test_kernels.py."""
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, (b, s, h, p)).astype(np.float32),
            rng.uniform(0.001, dt_hi, (b, s, h)).astype(np.float32),
            -rng.uniform(0.1, 1.0, h).astype(np.float32),
            rng.normal(0, 1, (b, s, n)).astype(np.float32),
            rng.normal(0, 1, (b, s, n)).astype(np.float32))


def _torch(args, dtype=torch.float32):
    """x, b and c in ``dtype``; dt and a stay fp32."""
    x, dt, a, b, c = (torch.from_numpy(v) for v in args)
    return x.to(dtype), dt, a, b.to(dtype), c.to(dtype)


def _jax(args):
    return tuple(jnp.asarray(v) for v in args)


@pytest.mark.parametrize("s,h,p,n,chunk", SWEEP)
def test_plain_matches_exact_recurrence(s, h, p, n, chunk):
    args = _inputs(2, s, h, p, n, s + p)
    want = np.asarray(rref.ssd_ref(*_jax(args)))
    got = ssd.ssd_scan_plain(*_torch(args), chunk)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    got = tops.ssd_scan(*_torch(args), chunk=chunk, use_kernel=False)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("s,h,p,n,chunk", SWEEP)
def test_final_state_matches_ssd_chunked(s, h, p, n, chunk):
    """y and the final state (B, H, N, P) fp32, ``ssd_chunked``'s outputs."""
    args = _inputs(2, s, h, p, n, s + n)
    want_y, want_state = ssd_chunked(*_jax(args), chunk=chunk)
    y, state = ssd.ssd_scan_plain(*_torch(args), chunk, return_state=True)
    assert state.dtype == torch.float32 and state.shape == (2, h, n, p)
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **TOL)
    np.testing.assert_allclose(state.numpy(), np.asarray(want_state), **TOL)


def test_wrapper_matches_interpreted_pallas_kernel():
    """The wrapper on CPU tensors (its plain version) and both sides of the
    ``ops`` entry point against ``ssd_scan_pallas`` in interpret mode; a CPU
    call launches nothing."""
    args = _inputs(2, 128, 3, 16, 8, 7)
    want = np.asarray(rops.ssd_scan(*_jax(args), chunk=32))
    before = ssd.ssd_scan.launches
    for got in (ssd.ssd_scan(*_torch(args), chunk=32),
                tops.ssd_scan(*_torch(args), chunk=32),
                tops.ssd_scan(*_torch(args), chunk=32, use_kernel=False)):
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert ssd.ssd_scan.launches == before


@pytest.mark.parametrize("chunk", [32, 64, 96, 192])
def test_chunk_invariance(chunk):
    """Any chunk gives the exact recurrence (the kernel picks its own tile
    on the strength of this)."""
    args = _inputs(1, 192, 2, 8, 4, 11, dt_hi=0.2)
    want = np.asarray(rref.ssd_ref(*_jax(args)))
    got, state = ssd.ssd_scan_plain(*_torch(args), chunk, return_state=True)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    _, want_state = ssd_chunked(*_jax(args), chunk=192)
    np.testing.assert_allclose(state.numpy(), np.asarray(want_state), **TOL)


def test_ops_chunk_fallback_and_padded_chunk():
    """S = 100 with chunk 64: ``ops`` runs one chunk of S, as the reference's
    ``ops.ssd_scan`` does (its Pallas kernel in interpret mode); the plain
    version given chunk 64 zero-pads a partial last chunk. Both are the
    exact recurrence."""
    args = _inputs(1, 100, 2, 8, 4, 13)
    want = np.asarray(rops.ssd_scan(*_jax(args), chunk=64))
    np.testing.assert_allclose(
        want, np.asarray(rref.ssd_ref(*_jax(args))), **TOL)
    for use_kernel in (True, False):
        got = tops.ssd_scan(*_torch(args), chunk=64, use_kernel=use_kernel)
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    y, state = ssd.ssd_scan_plain(*_torch(args), 64, return_state=True)
    np.testing.assert_allclose(y.numpy(), want, **TOL)
    y100, state100 = ssd.ssd_scan_plain(*_torch(args), 100, return_state=True)
    np.testing.assert_allclose(state.numpy(), state100.numpy(), **TOL)


def test_bf16_inputs():
    """bf16 x, b and c (dt, a fp32): y comes back in bf16 within one bf16
    step (2^-7 relative) of the exact recurrence on the same bf16 values."""
    args = _inputs(2, 128, 2, 16, 8, 17)
    x, dt, a, b, c = _torch(args, torch.bfloat16)
    y, state = ssd.ssd_scan_plain(x, dt, a, b, c, 32, return_state=True)
    assert y.dtype == torch.bfloat16 and state.dtype == torch.float32
    rounded = (x.float().numpy(), args[1], args[2], b.float().numpy(),
               c.float().numpy())
    want = np.asarray(rref.ssd_ref(*_jax(rounded)))
    np.testing.assert_allclose(y.float().numpy(), want, atol=TOL["atol"],
                               rtol=TOL["rtol"] + 2.0 ** -7)
    _, want_state = ssd_chunked(*_jax(rounded), chunk=32)
    np.testing.assert_allclose(state.numpy(), np.asarray(want_state), **TOL)


def test_masked_exponent_overflow_stays_finite():
    """dt * a near -40 a step: g_i - g_j reaches +5000 above the diagonal,
    where e^x overflows fp32. The mask is selected before the exponential,
    so y and the state stay finite and equal the exact recurrence."""
    args = list(_inputs(1, 128, 2, 8, 4, 19))
    args[1] = np.full_like(args[1], 20.0)
    args[2] = np.asarray([-2.0, -1.5], np.float32)
    y, state = ssd.ssd_scan_plain(*_torch(args), 128, return_state=True)
    assert torch.isfinite(y).all() and torch.isfinite(state).all()
    want = np.asarray(rref.ssd_ref(*_jax(args)))
    np.testing.assert_allclose(y.numpy(), want, **TOL)
