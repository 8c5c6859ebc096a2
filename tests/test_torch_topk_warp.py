"""The warp route of the CUDA ``knn_topk`` (``csrc/knn.cu``:
``knn_warp_kernel``), mirrored in Python and held against the two-key sort.

A row of up to 1024 columns takes one warp: lane l holds columns
``l E .. l E + E - 1`` (E, a power of two, the least with 32 E >= B) as
(pair key, distance bits), sorted stably by key; each of k rounds takes the
least head by the minimum of the keys' high words, then of the low words
among the lanes holding that high word, and the lowest such lane pops its
head. A lane whose real columns are spent takes no part; when no lane has
any left, the rest of the row is (+inf, ``ID_PAD``). A wider row takes the
block route. The mirror runs those rounds on numpy rows and must equal, bit for bit, the port's plain version ``knn_topk_plain``
and the reference's contract, ``jax.lax.sort((d, ids), num_keys=2)``
truncated to k and padded past B (not ``knn_topk_pallas``: its
``pl.store`` is gone from this JAX). Rows carry distance ties, duplicate
pairs, -0 and +0, NaN, +inf tails, k > B and B that is not a multiple of
32. ``test_torch_cuda.py`` holds the kernels themselves against the plain
version on the card.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
torch.set_num_threads(1)

from repro_torch.kernels import knn as kk  # noqa: E402

NO_WORD = 0xFFFFFFFF


def pair_key(d: np.float32, i: np.int32) -> int:
    """The kernel's 64-bit key: the distance's order-preserving word (-0 as
    +0, every NaN the largest) over the id with its sign bit flipped."""
    if np.isnan(d):
        dk = NO_WORD
    else:
        bits = int(np.float32(0.0 if d == 0 else d).view(np.uint32))
        dk = (~bits & NO_WORD) if bits & 0x80000000 else bits | 0x80000000
    return (dk << 32) | ((int(i) & NO_WORD) ^ 0x80000000)


def rounds(heads, k: int):
    """Up to k rounds over per-lane lists of (key, bits), each sorted: the
    least head by high word, then low word, the lowest lane on ties ->
    the popped (key, bits) in order, real pairs only."""
    out = []
    for _ in range(k):
        live = [lane[0][0] if lane else None for lane in heads]
        hi = [h >> 32 if h is not None else NO_WORD for h in live]
        m_hi = min(hi)
        lo = [h & NO_WORD if h is not None and hi[j] == m_hi else NO_WORD
              for j, h in enumerate(live)]
        m_lo = min(lo)
        who = [j for j, h in enumerate(live)
               if h is not None and hi[j] == m_hi and lo[j] == m_lo]
        if not who:                      # every real pair is out
            break
        out.append(heads[who[0]].pop(0))
    return out


def warp_select(d, ids, k: int, per_lane: int):
    """One warp over a row's columns, per_lane a lane, sorted stably."""
    lanes = [sorted(((pair_key(d[c], ids[c]), d[c].view(np.uint32))
                     for c in range(lane * per_lane,
                                    min(lane * per_lane + per_lane,
                                        d.shape[0]))),
                    key=lambda e: e[0]) for lane in range(32)]
    return rounds(lanes, k)


def warp_row(d, ids, k: int):
    """One row through the warp route -> (k distance bits, k ids), padded
    with (+inf, ID_PAD)."""
    b = d.shape[0]
    per_lane = 1
    while 32 * per_lane < b:
        per_lane *= 2
    assert per_lane <= kk.WARP_MAX_PER_LANE
    got = warp_select(d, ids, k, per_lane)
    got += [(None, np.float32(np.inf).view(np.uint32))] * (k - len(got))
    return (np.asarray([bits for _, bits in got], np.uint32),
            np.asarray([kk.ID_PAD if key is None
                        else np.int32((key & NO_WORD) ^ 0x80000000).item()
                        for key, _ in got], np.int32))


def warp_topk(d, ids, k: int):
    rows = [warp_row(d[r], ids[r], k) for r in range(d.shape[0])]
    return (np.stack([r[0] for r in rows]).reshape(d.shape[0], k),
            np.stack([r[1] for r in rows]).reshape(d.shape[0], k))


def lax_sort_topk(d, ids, k: int):
    """The reference's contract: the two-key sort, k columns, padded."""
    sd, si = (np.asarray(t) for t in jax.lax.sort((d, ids), num_keys=2))
    q, b = d.shape
    if k > b:
        sd = np.concatenate([sd, np.full((q, k - b), np.inf, np.float32)], 1)
        si = np.concatenate([si, np.full((q, k - b), kk.ID_PAD, np.int32)], 1)
    return sd[:, :k].view(np.uint32), si[:, :k]


def _rows(q, b, seed):
    """Ties, duplicate pairs, zeros of both signs, NaN, +inf tails, an
    all-+inf row."""
    g = np.random.default_rng(seed)
    d = g.choice(np.float32([0.0, -0.0, 0.25, 0.5, 1.0, 2.0, 3.5, np.nan]),
                 (q, b)).astype(np.float32)
    d[g.random((q, b)) < 0.3] = np.inf
    ids = g.integers(0, 12, (q, b)).astype(np.int32)
    ids[np.isinf(d)] = kk.ID_PAD
    d[0], ids[0] = np.inf, kk.ID_PAD
    if q > 1 and b >= 4:
        d[1, :4], ids[1, :4] = 0.5, 7              # four equal pairs
    if q > 2:
        d[2, ::3], ids[2, ::3] = np.nan, kk.ID_PAD   # (NaN, ID_PAD) pairs
    return d, ids


@pytest.mark.parametrize("q,b,k", [(4, 37, 5), (6, 256, 10), (4, 130, 150),
                                   (3, 1, 4), (5, 33, 40), (3, 64, 64),
                                   (3, 1000, 100), (2, 1024, 256),
                                   (3, 1024, 1030)])
def test_warp_mirror_matches_plain_and_lax_sort(q, b, k):
    d, ids = _rows(q, b, q * 7 + b)
    got = warp_topk(d, ids, k)
    pd, pi = kk.knn_topk_plain(torch.from_numpy(d), torch.from_numpy(ids), k)
    assert np.array_equal(got[0], pd.numpy().view(np.uint32))
    assert np.array_equal(got[1], pi.numpy())
    want = lax_sort_topk(d, ids, k)
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])


def test_the_wrapper_on_cpu_takes_the_plain_version():
    d, ids = _rows(4, 70, 5)
    n0 = kk.knn_topk.launches
    got = kk.knn_topk(torch.from_numpy(d), torch.from_numpy(ids), 9)
    want = kk.knn_topk_plain(torch.from_numpy(d), torch.from_numpy(ids), 9)
    assert kk.knn_topk.launches == n0
    assert torch.equal(got[1], want[1])
    assert np.array_equal(got[0].numpy().view(np.uint32),
                          want[0].numpy().view(np.uint32))


def test_plan_routes_by_width():
    """Powers of two per lane up to the warp route's widest row, then the
    block route."""
    widest = 32 * kk.WARP_MAX_PER_LANE
    assert kk.knn_plan(1) == {"route": "warp", "per_lane": 1}
    assert kk.knn_plan(33) == {"route": "warp", "per_lane": 2}
    assert kk.knn_plan(256)["per_lane"] == 8
    assert kk.knn_plan(widest) == {"route": "warp",
                                   "per_lane": kk.WARP_MAX_PER_LANE}
    block = {"route": "block", "per_lane": 0}
    assert kk.knn_plan(widest + 1) == block
    assert kk.knn_plan(1 << 20) == block
    for b in range(1, widest + 1, 37):
        per_lane = kk.knn_plan(b)["per_lane"]
        assert 32 * per_lane >= b and per_lane < 2 * max(1, -(-b // 32))


@pytest.mark.parametrize("b", [1, 256, 32 * kk.WARP_MAX_PER_LANE,
                               32 * kk.WARP_MAX_PER_LANE + 1, 40000])
def test_the_launch_carries_the_plan(monkeypatch, b):
    """What a card's call hands the C entry point (reached on the CPU by
    patching the router and the launcher): the operands, (Q, B, k) and the
    plan's columns per lane, one argument per C parameter."""
    from repro_torch.kernels import _build

    calls = []
    monkeypatch.setattr(kk, "_route", lambda *t: True)
    monkeypatch.setattr(kk, "_launch",
                        lambda name, device, *a: calls.append((name, a)))
    d, ids = _rows(3, b, 1)
    n0 = kk.knn_topk.launches
    out_d, out_i = kk.knn_topk(torch.from_numpy(d), torch.from_numpy(ids), 7)
    assert kk.knn_topk.launches == n0 + 1
    (name, a), = calls
    assert name == "glin_knn_topk"
    assert len(a) + 1 == len(_build._SIGNATURES[name])
    assert a[2] is out_d and a[3] is out_i and out_d.shape == (3, 7)
    plan = kk.knn_plan(b)
    assert a[4:] == (3, b, 7, plan["per_lane"])
    assert plan["route"] == ("warp" if b <= 32 * kk.WARP_MAX_PER_LANE
                             else "block")
