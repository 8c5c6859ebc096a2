"""The mask kernel's tiling, and the count's kernel-level entry point, on the
CPU.

``csrc/refine.cu``'s ``mask_kernel`` cannot run here, so its design is held
against the per-slot definition as a plain loop (``mask_emulation``): a
block of ``MASK_THREADS`` threads covers a tile of ``MASK_TILE`` slots and
``MASK_ROWS`` query rows; each thread holds ``MASK_SLOTS`` consecutive slots
and writes their bytes of a row in one 16-byte store where the row offset is
16-byte aligned; where it is ``d`` bytes past that, each thread but the
row's first stores the previous thread's last ``d`` bytes (a shuffle, or for
lane 0 a ballot of the warp's tests of those slots) with its own first
``16 - d`` at the aligned address below; the row's first thread writes its
first ``16 - d`` bytes and the last lane before a warp that is not full its
last ``d``, byte by byte; a warp holding slots past ``n`` writes byte by
byte; a row whose clipped run misses a thread's slots writes zeros
untested. The emulation also checks that every byte of the mask is written
exactly once. Shapes: ``n`` not a multiple of the tile or of 16, ``q`` not
a multiple of the row chunk, runs that start below 0 or end past ``n``,
inverted and empty runs.
"""
import collections
import inspect

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")   # the reference needs jax
torch.set_num_threads(1)

from repro.kernels import ops as rops  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import refine as kr  # noqa: E402

# csrc/refine.cu: kMaskThreads, kMaskSlots, kMaskRows
MASK_THREADS, MASK_SLOTS, MASK_ROWS = 128, 16, 64
MASK_TILE = MASK_THREADS * MASK_SLOTS


def _meets(m, w):
    return ((m[:, 0] <= w[2]) & (w[0] <= m[:, 2]) & (m[:, 1] <= w[3])
            & (w[1] <= m[:, 3]))


def straddle(prev, cur, d):
    """The kernel's ``straddle``: the previous lane's last ``d`` bytes and
    this lane's first ``16 - d``, by its word arithmetic (the 256-bit
    little-endian (cur:prev) shifted right by ``128 - 8 d`` bits in 32-bit
    funnel shifts)."""
    w = np.concatenate([prev, cur]).view("<u4").astype(np.uint64)
    bits = 128 - 8 * d
    k, r = bits >> 5, bits & 31
    o = [((int(w[j + k + 1]) << 32 | int(w[j + k])) >> r) & 0xFFFFFFFF
         for j in range(4)]
    return np.asarray(o, "<u4").view(np.int8)


def mask_emulation(windows, bounds, mbrs):
    """-> ((Q, N) int8 mask, Counter of block-row stores by kind: "int4",
    "straddle", of warp rows "byte", and of thread rows "untested"), by the
    kernel's grid (row chunks along x, tiles along y), threads and
    stores."""
    w, b, m = (t.numpy() for t in (windows, bounds, mbrs))
    q, n = w.shape[0], m.shape[0]
    out = np.zeros(q * n, np.int8)
    writes = np.zeros(q * n, np.int32)
    kinds = collections.Counter()

    def store(at, data):
        out[at:at + len(data)] = data
        writes[at:at + len(data)] += 1

    def bytes_of(s0, cnt, lo, hi, row):
        """A thread's 16 bytes: zeros untested where the run misses."""
        if not (lo < s0 + cnt and s0 < hi):
            return np.zeros(MASK_SLOTS, np.int8), False
        slot = s0 + np.arange(MASK_SLOTS)
        mm = m[np.clip(slot, 0, n - 1)]
        return ((slot >= lo) & (slot < hi) & _meets(mm, w[row])).astype(
            np.int8), True

    for bx in range(-(-q // MASK_ROWS)):
        r0 = bx * MASK_ROWS
        rows = min(MASK_ROWS, q - r0)
        for by in range(-(-n // MASK_TILE)):
            s0 = by * MASK_TILE + MASK_SLOTS * np.arange(MASK_THREADS)
            cnt = np.clip(n - s0, 0, MASK_SLOTS)
            warp_end = by * MASK_TILE + MASK_SLOTS * (
                (np.arange(MASK_THREADS) | 31) + 1)
            full = warp_end <= n                # the thread's warp
            next_full = warp_end + 32 * MASK_SLOTS <= n
            for r in range(rows):
                row = r0 + r
                lo, hi = max(int(b[row, 0]), 0), min(int(b[row, 1]), n)
                v = np.zeros((MASK_THREADS, MASK_SLOTS), np.int8)
                for t in range(MASK_THREADS):
                    v[t], tested = bytes_of(s0[t], cnt[t], lo, hi, row)
                    kinds["untested"] += not tested
                at = row * n + s0                   # byte offsets
                d = int(at[0] % 16)                 # one per row
                kinds["int4" if d == 0 else "straddle"] += 1
                kinds["byte"] += int((~full[::32]).sum())
                for t in range(MASK_THREADS):
                    if not full[t]:
                        store(at[t], v[t, :cnt[t]])
                    elif d == 0:
                        store(at[t], v[t])
                    else:
                        if s0[t] > 0:
                            prev = (v[t - 1] if t % 32 else bytes_of(
                                s0[t] - MASK_SLOTS, MASK_SLOTS, lo, hi,
                                row)[0])
                            assert (at[t] - d) % 16 == 0
                            store(at[t] - d, straddle(prev, v[t], d))
                        else:
                            store(at[t], v[t, :MASK_SLOTS - d])
                        if t % 32 == 31 and not next_full[t]:
                            store(at[t] + MASK_SLOTS - d,
                                  v[t, MASK_SLOTS - d:])
    assert (writes == 1).all()      # every byte, once
    return torch.from_numpy(out.reshape(q, n)), kinds


def _inputs(q, n, seed):
    """Clustered record MBRs (a NaN row and an inverted one among them),
    windows around some of them, and runs: random, clipped below 0 and past
    n, inverted, empty, the whole table."""
    g = np.random.default_rng(seed)
    lo = g.uniform(0, 1, (n, 2))
    m = np.concatenate([lo, lo + g.uniform(0, 0.02, (n, 2))], 1)
    m[3] = np.nan
    m[5] = [0.6, 0.6, 0.4, 0.4]
    c = g.uniform(0, 1, (q, 2))
    r = g.uniform(0.01, 0.2, (q, 1))
    w = np.concatenate([c - r, c + r], 1)
    a = g.integers(-50, n, q)
    e = a + g.integers(-20, n // 2, q)
    bnd = np.stack([a, e], 1)
    bnd[0] = [-7, n + 9]                  # clipped at both ends
    bnd[1] = [n // 3, n // 3]             # empty
    bnd[2] = [n - 3, n + 100]             # the tail only
    bnd[3] = [0, n]                       # the whole table
    return (torch.from_numpy(w.astype(np.float32)),
            torch.from_numpy(bnd.astype(np.int32)),
            torch.from_numpy(m.astype(np.float32)))


@pytest.mark.parametrize("q,n", [(17, MASK_TILE * 2 + 5),   # odd n
                                 (67, MASK_TILE + 4),       # d of 0, 4, 8, 12
                                 (5, MASK_TILE - 3),        # one tile, tail
                                 (16, MASK_TILE * 2)])      # all 16-byte
def test_mask_tiling_matches_plain(q, n):
    w, b, m = _inputs(q, n, q * 1000 + n)
    got, kinds = mask_emulation(w, b, m)
    want = kr.refine_mask_plain(w, b, m)
    assert torch.equal(got, want)
    assert want.any() and kinds["untested"] > 0
    assert torch.equal(kr.refine_mask(w, b, m), want)   # CPU: plain version
    if n % 16 == 0:
        assert kinds["straddle"] == kinds["byte"] == 0 and kinds["int4"]
    elif n > MASK_TILE:
        assert kinds["int4"] and kinds["straddle"] and kinds["byte"]
    assert torch.equal(want.sum(1, dtype=torch.int32),
                       tops.refine_count(w, b, m))


@pytest.mark.parametrize("d", range(1, 16))
def test_straddle_words(d):
    """The funnel-shift composition of an unaligned row's 16-byte store is
    the previous lane's last d bytes followed by this lane's first 16 - d."""
    g = np.random.default_rng(d)
    prev, cur = (g.integers(-128, 128, 16).astype(np.int8) for _ in "pc")
    np.testing.assert_array_equal(straddle(prev, cur, d),
                                  np.concatenate([prev[16 - d:],
                                                  cur[:16 - d]]))


def test_ops_refine_count_keeps_reference_signature():
    """``ops.refine_count`` takes the reference's arguments (its kernel
    walks each slot as its own leaf) and gives the reference's counts."""
    ref = inspect.signature(rops.refine_count).parameters
    got = inspect.signature(tops.refine_count).parameters
    assert [p for p in ref if p != "use_pallas"] == [
        p for p in got if p != "use_kernel"]
    w, b, m = _inputs(9, 300, 4)
    want = rops.refine_count(jnp.asarray(w.numpy()), jnp.asarray(b.numpy()),
                             jnp.asarray(m.numpy()), use_pallas=False)
    for use_kernel in (True, False):
        np.testing.assert_array_equal(
            tops.refine_count(w, b, m, use_kernel=use_kernel).numpy(),
            np.asarray(want))
