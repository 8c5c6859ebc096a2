"""The attention kernels' plain versions and wrappers against the reference.

On the CPU a wrapper takes its plain version, which must equal the
reference's oracles: ``kernels.ref.attention_ref`` for ``flash_attention``
and ``kernels.ref.decode_attention_ref`` for ``decode_attention`` — group
sizes 1, 4 and 8, windows 0 and 64, S and W that are not multiples of 64,
empty ring slots and a row with no live slot, fp32 and bf16 — and, on one
small case each, the Pallas kernels in interpret mode through
``repro.kernels.ops``. Tolerances (absolute, as the reference's own kernel
tests): 2e-5 in fp32 (summation order), 3e-2 in bf16 (one bf16 rounding of
the output). ``test_torch_cuda.py`` holds the CUDA kernels against these
plain versions on the card.
"""
import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")   # the reference needs jax
torch.set_num_threads(1)

from repro.kernels import ops as rops  # noqa: E402
from repro.kernels import ref as rref  # noqa: E402
from repro_torch.kernels import attention as katt  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

TOL = {"float32": 2e-5, "bfloat16": 3e-2}
B, HKV, D = 2, 2, 32


def _pair(a, dtype):
    """One numpy array -> (jax array, torch tensor) of ``dtype``."""
    return (jnp.asarray(a, dtype), torch.from_numpy(a).to(getattr(torch,
                                                                  dtype)))


def _err(j, t):
    return float(np.abs(np.asarray(j, np.float32)
                        - t.float().numpy()).max())


def _ring(rng, w, pos):
    """Ring slots as a decode cache holds them: slot s holds the latest
    absolute position p <= pos with p % w == s, -1 where none was written;
    row 0 has no live slot at all (-1 everywhere)."""
    slots = np.arange(w)[None, :]
    p = pos[:, None]
    ap = slots + w * ((p - slots) // w)
    ap = np.where(ap <= p, ap, -1)
    ap[0] = -1
    ap[1, rng.integers(0, w, 3)] = -1          # scattered empty slots
    return ap.astype(np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [0, 64])
@pytest.mark.parametrize("group", [1, 4, 8])
def test_flash_plain_matches_reference(group, window, dtype):
    rng = np.random.default_rng(group * 10 + window)
    s = 100                                   # not a multiple of 64
    q = rng.normal(0, 1, (B, HKV * group, s, D)).astype(np.float32)
    k = rng.normal(0, 1, (B, HKV, s, D)).astype(np.float32)
    v = rng.normal(0, 1, (B, HKV, s, D)).astype(np.float32)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (q, k, v))
    want = rref.attention_ref(jq, jk, jv, window=window)
    got = katt.flash_attention(tq, tk, tv, window)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    assert _err(want, got) < TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [0, 64])
@pytest.mark.parametrize("group", [1, 4, 8])
def test_decode_plain_matches_reference(group, window, dtype):
    rng = np.random.default_rng(100 + group * 10 + window)
    b, w = 3, 70                              # not a multiple of 64
    q = rng.normal(0, 1, (b, HKV * group, D)).astype(np.float32)
    k = rng.normal(0, 1, (b, HKV, w, D)).astype(np.float32)
    v = rng.normal(0, 1, (b, HKV, w, D)).astype(np.float32)
    pos = np.array([5, 150, 40], np.int32)    # row 1's ring has wrapped
    ap = _ring(rng, w, pos)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (q, k, v))
    want = rref.decode_attention_ref(jq, jk, jv, jnp.asarray(ap),
                                     jnp.asarray(pos), window=window)
    got = katt.decode_attention(tq, tk, tv, torch.from_numpy(ap),
                                torch.from_numpy(pos), window)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    assert _err(want, got) < TOL[dtype]
    # the row with no live slot averages every slot's value, as the
    # reference's all -1e30 softmax does
    np.testing.assert_allclose(got[0].float().numpy(),
                               np.repeat(tv[0].float().mean(1).numpy(),
                                         group, 0), atol=TOL[dtype])


@pytest.mark.parametrize("window", [0, 16])
def test_ops_flash_matches_pallas_interpret(window):
    """``ops.flash_attention`` (both sides) against the Pallas kernel in
    interpret mode (S divides its tiles) and the reference's plain side."""
    rng = np.random.default_rng(7)
    q = rng.normal(0, 1, (1, 4, 64, 16)).astype(np.float32)
    k = rng.normal(0, 1, (1, 2, 64, 16)).astype(np.float32)
    v = rng.normal(0, 1, (1, 2, 64, 16)).astype(np.float32)
    want = rops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), window=window)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    for use_kernel in (True, False):
        got = tops.flash_attention(tq, tk, tv, window=window,
                                   use_kernel=use_kernel)
        assert _err(want, got) < TOL["float32"]


@pytest.mark.parametrize("window", [0, 16])
def test_ops_decode_matches_pallas_interpret(window):
    rng = np.random.default_rng(8)
    b, w = 2, 64
    q = rng.normal(0, 1, (b, 4, 16)).astype(np.float32)
    k = rng.normal(0, 1, (b, 2, w, 16)).astype(np.float32)
    v = rng.normal(0, 1, (b, 2, w, 16)).astype(np.float32)
    pos = np.array([20, 90], np.int32)
    ap = _ring(rng, w, pos)
    ap[0, :21] = np.arange(21)               # row 0 live, its tail empty
    want = rops.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), jnp.asarray(ap),
                                 jnp.asarray(pos), window=window)
    args = [torch.from_numpy(a) for a in (q, k, v, ap, pos)]
    for use_kernel in (True, False):
        got = tops.decode_attention(*args, window=window,
                                    use_kernel=use_kernel)
        assert _err(want, got) < TOL["float32"]


def test_cpu_tensors_never_launch():
    """A CPU tensor takes the plain version: no launch is counted."""
    n0 = (katt.flash_attention.launches, katt.decode_attention.launches)
    q = torch.zeros(1, 2, 3, 16)
    katt.flash_attention(q, q[:, :1], q[:, :1])
    katt.decode_attention(q[:, :, 0], q[:, :1], q[:, :1],
                          torch.zeros(1, 3, dtype=torch.int32),
                          torch.zeros(1, dtype=torch.int32))
    assert (katt.flash_attention.launches,
            katt.decode_attention.launches) == n0


def test_wrappers_reject_devices_they_cannot_run_on():
    q = torch.zeros(1, 2, 3, 16, device="meta")
    with pytest.raises(ValueError, match="device"):
        katt.flash_attention(q, q[:, :1], q[:, :1])
    with pytest.raises(ValueError, match="different devices"):
        katt.flash_attention(torch.zeros(1, 2, 3, 16), q[:, :1], q[:, :1])
