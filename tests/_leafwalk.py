"""Leaf-walk test helpers shared by the CPU and card tests (port only).

``spliced_walk`` gives a snapshot's walk tables empty leaves between real
ones, whose MBR rows (NaN, inverted, a box around everything) no walk may
count; ``walk_emulation`` is the group -> leaf -> slot walk of
``csrc/refine.cu`` (``walk_run``, as the compact and count kernels run it)
as a plain loop, so its design can be held against the per-slot definition
where no card is.
"""
import numpy as np
import torch

from repro_torch.core import device as tdev
from repro_torch.kernels import refine as kr

_EMPTY_ROWS = (np.full(4, np.nan, np.float32),
               np.float32([np.inf, np.inf, -np.inf, -np.inf]),
               np.float32([-1e30, -1e30, 1e30, 1e30]))


def spliced_walk(s, every: int = 3) -> kr.LeafWalk:
    """``s.leaf_walk`` with an empty leaf before every ``every``-th leaf;
    the empty rows cycle through NaN, inverted and everything-covering."""
    starts = s.leaf_start.cpu().numpy()
    mbr = s.leaf_mbr.cpu().numpy()
    nl = mbr.shape[0]
    new_start, new_mbr = [], []
    remap = np.empty(nl, np.int64)
    for leaf in range(nl):
        if leaf % every == 0:
            new_start.append(starts[leaf])
            new_mbr.append(_EMPTY_ROWS[(leaf // every) % len(_EMPTY_ROWS)])
        remap[leaf] = len(new_mbr)
        new_start.append(starts[leaf])
        new_mbr.append(mbr[leaf])
    new_start.append(starts[nl])
    dev = s.device
    rec_leaf = torch.from_numpy(
        remap[s.rec_leaf.cpu().numpy()].astype(np.int32)).to(dev)
    leaf_start = torch.from_numpy(np.asarray(new_start, np.int32)).to(dev)
    leaf_mbr = torch.from_numpy(np.stack(new_mbr).astype(np.float32)).to(dev)
    return kr.LeafWalk(rec_leaf, leaf_start, leaf_mbr,
                       tdev.leaf_group_mbrs(leaf_mbr, leaf_start))


def slot_walk(leaf_mbrs) -> kr.LeafWalk:
    """Slot-as-leaf tables: leaf l = slot l."""
    n = leaf_mbrs.shape[0]
    dev = leaf_mbrs.device
    return kr.LeafWalk(torch.arange(n, dtype=torch.int32, device=dev),
                       torch.arange(n + 1, dtype=torch.int32, device=dev),
                       leaf_mbrs, tdev.leaf_group_mbrs(leaf_mbrs))


def _meets(m, w) -> bool:
    return bool(m[0] <= w[2] and w[0] <= m[2] and m[1] <= w[3]
                and w[1] <= m[3])


def _covers(m, w) -> bool:
    return bool(m[0] <= w[0] and m[1] <= w[1] and w[2] <= m[2]
                and w[3] <= m[3])


def walk_emulation(windows, bounds, rec_mbrs, walk: kr.LeafWalk,
                   budget: int, prefilter: str):
    """-> (slots (Q, budget) int32, counts (Q,) int32) by the walk's three
    levels, in the kernel's order; also the number of group rows and leaves
    it tested. Budget 0 is the count kernel's count-only walk: no survivor
    list, the totals alone."""
    w_np, b_np = windows.cpu().numpy(), bounds.cpu().numpy()
    rm = rec_mbrs.cpu().numpy()
    rl, ls, lm, gm = (t.cpu().numpy() for t in walk)
    n, nl = rl.shape[0], lm.shape[0]
    q = w_np.shape[0]
    slots = np.full((q, budget), -1, np.int32)
    counts = np.zeros(q, np.int32)
    tested = [0, 0]
    rec_ok = _covers if prefilter == "contains" else _meets
    for i in range(q):
        w = w_np[i]
        lo, hi = max(int(b_np[i, 0]), 0), min(int(b_np[i, 1]), n)
        if lo >= hi or nl < 1:
            continue
        l0, l1 = max(int(rl[lo]), 0), min(int(rl[hi - 1]), nl - 1)
        surv = []
        for g in range(l0 // 32, l1 // 32 + 1):
            tested[0] += 1
            if not _meets(gm[g], w):
                continue
            for leaf in range(max(32 * g, l0), min(32 * g + 32, l1 + 1)):
                tested[1] += 1
                a, b = max(int(ls[leaf]), lo), min(int(ls[leaf + 1]), hi)
                if a < b and _meets(lm[leaf], w):
                    surv += [s for s in range(a, b) if rec_ok(rm[s], w)]
        counts[i] = len(surv)
        take = surv[:budget]
        slots[i, :len(take)] = take
    return torch.from_numpy(slots), torch.from_numpy(counts), tested
