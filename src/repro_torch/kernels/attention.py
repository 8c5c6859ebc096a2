"""Attention kernels for Hopper: the prefill's ``flash_attention`` and the
decode step's ``decode_attention``, over ``csrc/flash_attention.cu`` and
``csrc/decode_attention.cu`` (sm_90a), each with its plain torch version
beside it.

Both take the reference's layouts — q (B, Hq, S, D) with k/v (B, Hkv, S, D)
for flash; q (B, Hq, D) with k/v (B, Hkv, W, D), ``abs_pos`` (B, W) and
``pos`` (B,) for decode — in fp32 or bf16, and read them through their
strides (last dimension contiguous): the model hands in transposed views of
its (B, S, H, D) activations and (B, W, Hkv, D) cache, never a copy. A CUDA
tensor takes a kernel, a CPU tensor the plain version; each wrapper counts
its kernel launches in ``<wrapper>.launches``. Meta tensors under the dry
run's cost counter (``utils.cost``) take the kernel's route, where the
counter is charged :func:`flash_work` / :func:`decode_work` and nothing
launches. :func:`flash_plan` and
:func:`decode_plan` give each launch's shape (entry point, kernel, grid).

``flash_attention`` has a gradient: where an input requires one, the kernel
runs inside a ``torch.autograd.Function`` whose backward is the derivative
of the plain version (:func:`flash_attention_grad`), recomputed
:data:`BACKWARD_ROWS` query rows at a time. No kernel of the reference has
a backward either: its gradient is XLA's derivative of its jnp path.
"""
from __future__ import annotations

import math

import torch

from ..utils import cost
from .refine import _count, _launch, _route

__all__ = ["NEG_INF", "HEAD_DIMS", "BACKWARD_ROWS", "flash_attention",
           "flash_attention_plain", "flash_attention_grad", "decode_attention",
           "decode_attention_plain", "flash_plan", "decode_plan",
           "band_pairs", "flash_work", "decode_work"]

NEG_INF = -1e30          # the reference's mask fill (not -inf)
HEAD_DIMS = (16, 32, 64, 128, 256)   # head dims the kernels are built for
MAX_GROUP = 64           # query heads per kv head the flash kernel takes
FLASH_ROWS = 64          # query rows of a flash block: heads x tokens
DECODE_MAX_SPLIT = 8     # decode blocks that share a row's slots, at most
H100_SMS = 132           # decode splits a row's slots until a block an SM
# query rows of one backward recompute: the fp32 scores of a chunk are
# (B, Hq, rows, keys), as the reference's query-chunked attention_train
BACKWARD_ROWS = 1024
_DTYPES = (torch.float32, torch.bfloat16)
# the flash entry point of each dtype: the tensor cores for bf16, the CUDA
# cores for fp32 (TF32 would miss the fp32 tolerance)
_FLASH_ENTRY = {torch.bfloat16: "glin_flash_attention_bf16",
                torch.float32: "glin_flash_attention_fp32"}


def flash_attention_plain(q, k, v, window: int = 0, q_offset: int = 0):
    """``repro.kernels.ref.attention_ref`` in torch: fp32 scores, the -1e30
    fill, fp32 softmax and P.V, the output cast to q's dtype. Query row i
    sits at key position ``q_offset + i`` in the causal and window masks
    (0: q and k are the same positions)."""
    b, hq, s, d = q.shape
    group = hq // k.shape[1]
    k = k.repeat_interleave(group, dim=1).float()
    v = v.repeat_interleave(group, dim=1).float()
    sc = torch.einsum("bhqd,bhkd->bhqk", q.float(), k) * (1.0 / math.sqrt(d))
    qi = q_offset + torch.arange(s, device=q.device)[:, None]
    kj = torch.arange(k.shape[2], device=q.device)[None, :]
    mask = qi >= kj
    if window > 0:
        mask &= (qi - kj) < window
    sc = torch.where(mask, sc, torch.full_like(sc, NEG_INF))
    p = torch.softmax(sc, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v).to(q.dtype)


def decode_attention_plain(q, k, v, abs_pos, pos, window: int = 0,
                           return_lse: bool = False):
    """``repro.kernels.ref.decode_attention_ref`` in torch: a slot counts
    where ``0 <= abs_pos <= pos`` (and ``pos - abs_pos < window`` with a
    window); the others take the -1e30 fill. With ``return_lse`` also the
    fp32 log-sum-exp (B, Hq) of each (row, head)'s scaled scores over its
    live slots alone: -inf where none is live (not the fill's)."""
    b, hq, d = q.shape
    group = hq // k.shape[1]
    k = k.repeat_interleave(group, dim=1).float()
    v = v.repeat_interleave(group, dim=1).float()
    sc = torch.einsum("bhd,bhkd->bhk", q.float(), k) * (1.0 / math.sqrt(d))
    valid = (abs_pos >= 0) & (abs_pos <= pos[:, None])
    if window > 0:
        valid &= (pos[:, None] - abs_pos) < window
    live = valid[:, None, :]
    p = torch.softmax(torch.where(live, sc, torch.full_like(sc, NEG_INF)),
                      dim=-1)
    out = torch.einsum("bhk,bhkd->bhd", p, v).to(q.dtype)
    if not return_lse:
        return out
    return out, torch.logsumexp(
        torch.where(live, sc, torch.full_like(sc, -math.inf)), dim=-1)


def band_pairs(s: int, window: int = 0) -> int:
    """(query, key) pairs of a causal, optionally windowed, prompt of s."""
    if window <= 0 or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window


def flash_work(q, k, window: int = 0) -> tuple:
    """(operations, bytes) of one flash launch on these shapes: 4 D
    operations a (query head, key) pair of the causal or windowed band; q,
    k and v read once and the output written once."""
    b, hq, s, d = q.shape
    return (4.0 * b * hq * d * band_pairs(s, window),
            float(q.element_size() * (2 * q.numel() + 2 * k.numel())))


def decode_work(q, k, live: int, lse: bool = False) -> tuple:
    """(operations, bytes) of one decode launch with ``live`` live (row,
    slot) pairs: 4 D operations a query head and live slot; the live
    slots' K and V, q, abs_pos and pos read once, the output (and the
    log-sum-exp) written once."""
    b, hq, d = q.shape
    hkv, w = k.shape[1], k.shape[2]
    nbytes = (2 * live * hkv * d * k.element_size() + 2 * q.numel()
              * q.element_size() + b * w * 4 + b * 4
              + (b * hq * 4 if lse else 0))
    return 4.0 * live * hq * d, float(nbytes)


def _check_strided(name, t, dtype, shape):
    """dtype and shape, and the last dimension contiguous (the other
    strides are free: the kernels take them as arguments)."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if t.stride(-1) != 1:
        raise ValueError(f"{name}: needs a contiguous last dimension, got "
                         f"strides {t.stride()}")


def _check_rows(name, t, dtype, shape):
    """:func:`_check_strided`, and every stride and the base 16-byte
    aligned (the kernels load 16 bytes a lane)."""
    _check_strided(name, t, dtype, shape)
    vec = 16 // t.element_size()
    if any(st % vec for st, n in zip(t.stride()[:-1], t.shape[:-1]) if n > 1):
        raise ValueError(f"{name}: needs 16-byte aligned rows, got strides "
                         f"{t.stride()}")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: data must be 16-byte aligned")


def _check_heads(q, k, d):
    if q.dtype not in _DTYPES:
        raise TypeError(f"q: dtype {q.dtype}, expected fp32 or bf16")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d}: the kernels take {HEAD_DIMS}")
    hq, hkv = q.shape[1], k.shape[1]
    if hkv < 1 or hq % hkv or hq // hkv > MAX_GROUP:
        raise ValueError(f"{hq} query heads over {hkv} kv heads: needs a "
                         f"group of 1..{MAX_GROUP}")


def flash_plan(b: int, hkv: int, group: int, s: int, d: int, dtype) -> dict:
    """The flash launch for these shapes: its entry point and kernel (bf16:
    wgmma at head dim 64, mma.sync at the others; fp32: the CUDA cores),
    the tokens of a block (its 64 rows are the group's heads times that
    many tokens), the blocks of its grid and their threads."""
    bq = FLASH_ROWS // group
    bf16 = dtype == torch.bfloat16
    kernel = ("flash_fp32_kernel" if not bf16 else "flash_wgmma_kernel"
              if d == 64 else "flash_mma_kernel")
    return {"entry": _FLASH_ENTRY[dtype], "kernel": kernel,
            "tokens_per_block": bq, "blocks": -(-s // bq) * hkv * b,
            "threads": 128 if bf16 else 256}


def decode_plan(b: int, hkv: int) -> dict:
    """The decode launch for these shapes: ``split`` blocks share each
    (row, kv head)'s slots, doubled from 1 until the grid has a block for
    every SM of an H100 or the split reaches 8; grid (split, Hkv, B) of 128
    threads."""
    split = 1
    while split < DECODE_MAX_SPLIT and b * hkv * split < H100_SMS:
        split *= 2
    return {"split": split, "blocks": split * hkv * b, "threads": 128}


# (device, stream) -> the decode kernel's int32 counters, one per (row, kv
# head): zero before a launch, and its last block of each row sets its
# counter back to zero, so they are filled once and never reset
_DECODE_DONE = {}


def _decode_done(device, n: int):
    stream = (torch.cuda.current_stream(device).cuda_stream
              if device.type == "cuda" else 0)
    done = _DECODE_DONE.get((device, stream))
    if done is None or done.numel() < n:
        done = torch.zeros(max(n, 256), dtype=torch.int32, device=device)
        _DECODE_DONE[(device, stream)] = done
    return done


def flash_attention_grad(q, k, v, dout, window: int = 0, rows=None):
    """(dq, dk, dv) of :func:`flash_attention_plain`'s output against
    ``dout``, in q's, k's and v's shapes and dtypes: autograd of the plain
    version, recomputed ``rows`` (default :data:`BACKWARD_ROWS`) query rows
    at a time over the keys the chunk's causal (and window) mask lets
    through, on fp32 copies of the inputs (dk and dv summed over the chunks
    in fp32, then cast). A masked key's probability is exactly 0 in the
    plain version, so leaving it out changes nothing."""
    s, rows = q.shape[2], rows or BACKWARD_ROWS
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    for q0 in range(0, s, rows):
        q1 = min(q0 + rows, s)
        lo = max(0, q0 - window + 1) if window > 0 else 0
        with torch.enable_grad():
            qc, kc, vc = (t.detach().float().requires_grad_() for t in (
                q[:, :, q0:q1], k[:, :, lo:q1], v[:, :, lo:q1]))
            out = flash_attention_plain(qc, kc, vc, window, q_offset=q0 - lo)
            gq, gk, gv = torch.autograd.grad(out, (qc, kc, vc),
                                             dout[:, :, q0:q1].float())
        dq[:, :, q0:q1] = gq
        dk[:, :, lo:q1] += gk
        dv[:, :, lo:q1] += gv
    return dq, dk.to(k.dtype), dv.to(v.dtype)


class _Flash(torch.autograd.Function):
    """The kernel forward, the plain version's derivative backward."""

    @staticmethod
    def forward(ctx, q, k, v, window):
        ctx.window = window
        ctx.charged = cost.charged()     # the dry run's count
        ctx.save_for_backward(q, k, v)
        return _flash_launch(q, k, v, window)

    @staticmethod
    def backward(ctx, dout):
        q, k, v = ctx.saved_tensors
        with cost.at(ctx.charged):
            return (*flash_attention_grad(q, k, v, dout, ctx.window), None)


def flash_attention(q, k, v, window: int = 0):
    """q (B, Hq, S, D), k/v (B, Hkv, S, D) -> (B, Hq, S, D) in q's dtype:
    causal (``window`` = 0) or sliding-window GQA attention.

    Replaces ``flash_attention_pallas`` (repro/kernels/flash_attention.py).
    Bound on this card at the prefill's shapes: bytes (q, k, v read once,
    the output written once). One entry point per dtype
    (:func:`flash_plan`): bf16 on the tensor cores, FlashAttention-2 style
    (wgmma warpgroup products at head dim 64, mma.sync at the others), fp32
    on the CUDA cores (TF32 would miss the fp32 tolerance). All: one block
    per (64-row query tile of the group's heads, kv head, batch row); K/V
    tiles staged in shared memory; fully masked tiles skipped. The output
    takes q's layout (``empty_like``), so a transposed view in gives one
    out. The launch runs inside :class:`_Flash`, whose backward is
    :func:`flash_attention_grad` (no graph is recorded where no input
    requires a gradient).
    """
    if not (cost.meta_route(q, k, v) or _route(q, k, v)):
        return flash_attention_plain(q, k, v, window)
    return _Flash.apply(q, k, v, int(window))


def _flash_launch(q, k, v, window: int):
    """Check the operands and launch the flash kernel (one count)."""
    b, hq, s, d = q.shape
    _check_heads(q, k, d)
    kv_shape = (b, k.shape[1], s, d)
    _check_rows("q", q, q.dtype, (b, hq, s, d))
    _check_rows("k", k, q.dtype, kv_shape)
    _check_rows("v", v, q.dtype, kv_shape)
    if k.stride() != v.stride():
        raise ValueError(f"k and v need one layout: strides {k.stride()} "
                         f"and {v.stride()}")
    out = torch.empty_like(q)         # q's layout where q is a dense view
    if q.device.type == "meta":
        cost.charge_kernel(*flash_work(q, k, window), q, k, v)
    elif b and s:
        plan = flash_plan(b, k.shape[1], hq // k.shape[1], s, d, q.dtype)
        _launch(plan["entry"], q.device, q, k, v, out, b, hq, k.shape[1], s,
                d, int(window), 1.0 / math.sqrt(d), plan["tokens_per_block"],
                *q.stride()[:3], *k.stride()[:3], *out.stride()[:3])
        _count(flash_attention)
    return out


def decode_attention(q, k, v, abs_pos, pos, window: int = 0,
                     return_lse: bool = False):
    """q (B, Hq, D), k/v (B, Hkv, W, D), abs_pos (B, W) int32 (-1 = empty
    slot), pos (B,) int32 -> (B, Hq, D) in q's dtype: one query token per
    row against its ring of W slots. With ``return_lse`` also the fp32
    log-sum-exp (B, Hq) of each (row, head)'s scaled scores over its live
    slots (-inf where none is live), from which partial softmaxes over
    disjoint slot ranges merge (the sharded decode's slots over ``model``).

    Replaces ``decode_attention_pallas`` (repro/kernels/decode_attention.py).
    Bound on this card: bytes (the live slots' K and V). Each (row, kv
    head)'s slots are split over ``split`` blocks (:func:`decode_plan`),
    each streaming its run of live slots through shared memory with the
    group's query heads in registers and leaving its partial softmax state
    in a scratch tensor; in the same launch, the last block of the row to
    finish (counted on per-stream counters that the kernel leaves at zero)
    merges them, and writes the log-sum-exp where it is asked for.
    """
    if not (cost.meta_route(q, k, v, abs_pos, pos)
            or _route(q, k, v, abs_pos, pos)):
        return decode_attention_plain(q, k, v, abs_pos, pos, window,
                                      return_lse)
    b, hq, d = q.shape
    _check_heads(q, k, d)
    w = k.shape[2]
    kv_shape = (b, k.shape[1], w, d)
    _check_rows("q", q, q.dtype, (b, hq, d))
    _check_rows("k", k, q.dtype, kv_shape)
    _check_rows("v", v, q.dtype, kv_shape)
    if k.stride() != v.stride():
        raise ValueError(f"k and v need one layout: strides {k.stride()} "
                         f"and {v.stride()}")
    for name, t, shape in (("abs_pos", abs_pos, (b, w)), ("pos", pos, (b,))):
        if t.dtype != torch.int32 or tuple(t.shape) != shape:
            raise ValueError(f"{name}: {t.dtype} {tuple(t.shape)}, expected "
                             f"int32 {shape}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: needs a contiguous last dimension")
    out = torch.empty((b, hq, d), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, hq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if q.device.type == "meta":       # every slot counted live: no data
        cost.charge_kernel(*decode_work(q, k, b * w, return_lse), q, k, v)
    elif b and w:
        hkv = k.shape[1]
        split = decode_plan(b, hkv)["split"]
        # each block's partial softmax state: per head (acc[D], m, l), and
        # its live flag
        part = torch.empty(b * hkv * split * (hq // hkv * (d + 2) + 1),
                           dtype=torch.float32, device=q.device)
        _launch("glin_decode_attention", q.device, q, k, v, abs_pos, pos,
                out, part, _decode_done(q.device, b * hkv), b, hq, hkv, w, d,
                int(window), 1.0 / math.sqrt(d),
                int(q.dtype == torch.bfloat16), split, *q.stride()[:2],
                *k.stride()[:3], abs_pos.stride(0), lse)
        _count(decode_attention)
    elif lse is not None:
        lse.fill_(-math.inf)
    return (out, lse) if return_lse else out


flash_attention.launches = 0
decode_attention.launches = 0
