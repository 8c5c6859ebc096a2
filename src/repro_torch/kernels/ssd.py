"""The Mamba-2 SSD chunked scan for Hopper: ``ssd_scan`` over
``csrc/ssd_scan.cu`` (sm_90a), with its plain torch version beside it.

Layouts are the reference's: x (B, S, H, P) in fp32 or bf16, dt (B, S, H)
fp32 (after softplus), a (H,) fp32 (negative), b/c (B, S, N) in x's dtype;
y (B, S, H, P) in x's dtype and, with ``return_state``, the final state
(B, H, N, P) fp32. The kernel reads x, dt, b and c through their strides
(last dimension contiguous): the model hands in views of its convolution's
output, never a copy. A CUDA tensor takes the kernel, a CPU tensor the plain
version (meta tensors under the dry run's cost counter the kernel's route,
charged :func:`ssd_work`, launching nothing); ``ssd_scan.launches`` counts
the kernel's launches. Where an input
requires a gradient, the kernel runs inside a ``torch.autograd.Function``
whose backward is the derivative of the plain version, recomputed at the
caller's chunk (no kernel of the reference has a backward either).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..utils import cost
from .attention import _check_strided as _check
from .refine import _count, _launch, _route

__all__ = ["MAX_STATE", "TILE", "ssd_scan", "ssd_scan_plain", "ssd_scan_grad",
           "ssd_scratch", "ssd_work"]

MAX_STATE = 256          # the largest N the kernel takes (shared memory)
TILE = 64                # the kernel's chunk (steps)
_DTYPES = (torch.float32, torch.bfloat16)


def ssd_scan_plain(x, dt, a, b, c, chunk: int = 128,
                   return_state: bool = False):
    """``repro.models.ssm.ssd_chunked`` in torch, over every head at once:
    fp32 throughout, the causal mask selected before ``exp``, y cast to x's
    dtype. An S that ``chunk`` does not divide gets a zero-padded last chunk
    (dt = 0 and zero x, b, c: the state and the real outputs stay as they
    are). Returns y, or (y, final state (B, H, N, P) fp32)."""
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    ch = max(1, min(int(chunk), s))
    pad = (-s) % ch
    xf, dtf, bf, cf = x.float(), dt.float(), b.float(), c.float()
    if pad:
        xf = F.pad(xf, (0, 0, 0, 0, 0, pad))
        dtf = F.pad(dtf, (0, 0, 0, pad))
        bf = F.pad(bf, (0, 0, 0, pad))
        cf = F.pad(cf, (0, 0, 0, pad))
    nc = (s + pad) // ch
    xc = xf.reshape(bsz, nc, ch, h, p)
    dtc = dtf.reshape(bsz, nc, ch, h)
    bc = bf.reshape(bsz, nc, ch, n)
    cc = cf.reshape(bsz, nc, ch, n)

    scores = torch.einsum("bcln,bcmn->bclm", cc, bc)        # shared by heads
    g = torch.cumsum(dtc * a.float(), dim=2)                # (B,NC,L,H)
    gtot = g[:, :, -1]                                      # (B,NC,H)
    li = torch.arange(ch, device=x.device)
    causal = (li[:, None] >= li[None, :])[None, None, :, :, None]
    delta = torch.where(causal, g[:, :, :, None, :] - g[:, :, None, :, :],
                        float("-inf"))                      # (B,NC,L,M,H)
    w = scores[..., None] * torch.exp(delta) * dtc[:, :, None, :, :]
    y = torch.einsum("bclmh,bcmhp->bclhp", w, xc)

    # chunk summaries U_c = B^T (e^{gtot-g} dt x), carried across chunks
    xw = xc * (torch.exp(gtot[:, :, None, :] - g) * dtc)[..., None]
    u = torch.einsum("bcln,bclhp->bchnp", bc, xw)           # (B,NC,H,N,P)
    decay = torch.exp(gtot)                                 # (B,NC,H)
    state = torch.zeros((bsz, h, n, p), dtype=torch.float32, device=x.device)
    prev = []
    for i in range(nc):
        prev.append(state)
        state = state * decay[:, i, :, None, None] + u[:, i]
    prev = torch.stack(prev, 1)                             # pre-chunk states
    y = y + torch.einsum("bcln,bchnp->bclhp", cc, prev) * torch.exp(g)[..., None]
    y = y.reshape(bsz, nc * ch, h, p)[:, :s].to(x.dtype)
    return (y, state) if return_state else y


def ssd_scan_grad(x, dt, a, b, c, dy, chunk: int = 128) -> tuple:
    """(dx, ddt, da, db, dc) of :func:`ssd_scan_plain`'s y at ``chunk``
    against ``dy``: autograd of the plain version, recomputed."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_() for t in (x, dt, a, b, c)]
        return torch.autograd.grad(ssd_scan_plain(*ins, chunk), ins, dy)


class _SSD(torch.autograd.Function):
    """The kernel forward, the plain version's derivative backward. The
    final state carries no gradient (training discards the cache)."""

    @staticmethod
    def forward(ctx, x, dt, a, b, c, chunk):
        ctx.chunk = chunk
        ctx.charged = cost.charged()     # the dry run's count
        ctx.save_for_backward(x, dt, a, b, c)
        y, state = _ssd_launch(x, dt, a, b, c, chunk)
        ctx.mark_non_differentiable(state)
        return y, state

    @staticmethod
    def backward(ctx, dy, _dstate):
        with cost.at(ctx.charged):
            return (*ssd_scan_grad(*ctx.saved_tensors, dy, ctx.chunk), None)


def ssd_scan(x, dt, a, b, c, chunk: int = 128, return_state: bool = False):
    """x (B, S, H, P), dt (B, S, H) fp32, a (H,) fp32, b/c (B, S, N) ->
    y (B, S, H, P) in x's dtype, or (y, final state (B, H, N, P) fp32).

    Replaces ``ssd_scan_pallas`` (repro/kernels/ssd_scan.py) and adds the
    final state, which ``ssd_chunked`` returns and the decode cache needs.
    Chunk-parallel on the tensor cores (``csrc/ssd_scan.cu``): C B^T once
    per chunk with each chunk's state contribution, the pass over the
    chunks, then y per chunk: three launches on the current stream (one
    call, one count in ``launches``). Bound on this card at the serving
    shape: bytes (the products take less on the tensor cores). The kernel's
    chunk is 64 steps (:data:`TILE`) whatever ``chunk``, which sets only the
    plain version's (the chunked algorithm computes the same function for
    any chunk). Any S. The launch runs inside :class:`_SSD` (no graph is
    recorded where no input requires a gradient).
    """
    if not (cost.meta_route(x, dt, a, b, c) or _route(x, dt, a, b, c)):
        return ssd_scan_plain(x, dt, a, b, c, chunk, return_state)
    y, state = _SSD.apply(x, dt, a, b, c, chunk)
    return (y, state) if return_state else y


def _ssd_launch(x, dt, a, b, c, chunk: int):
    """Check the operands and launch the scan (one count) -> (y, state)."""
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    if x.dtype not in _DTYPES:
        raise TypeError(f"x: dtype {x.dtype}, expected fp32 or bf16")
    if not 1 <= n <= MAX_STATE:
        raise ValueError(f"state size {n}: the kernel takes 1..{MAX_STATE}")
    if chunk < 1:
        raise ValueError(f"chunk {chunk} must be positive")
    _check("x", x, x.dtype, (bsz, s, h, p))
    _check("dt", dt, torch.float32, (bsz, s, h))
    _check("a", a, torch.float32, (h,))
    _check("b", b, x.dtype, (bsz, s, n))
    _check("c", c, x.dtype, (bsz, s, n))
    y = torch.empty((bsz, s, h, p), dtype=x.dtype, device=x.device)
    state = torch.empty((bsz, h, n, p), dtype=torch.float32, device=x.device)
    if x.device.type == "meta":
        for shape in ssd_scratch(bsz, s, h, p, n).values():
            torch.empty(shape, dtype=torch.float32, device=x.device)
        nbytes, ops_cb, ops_rest = ssd_work(x, dt, b)
        cost.charge_kernel(ops_cb + ops_rest, nbytes, x, dt, a, b, c)
    elif not s:
        state.zero_()                 # the state of an empty sequence
    elif bsz and h and p:             # the kernels write every element
        scratch = ssd_scratch(bsz, s, h, p, n)
        _launch("glin_ssd_scan", x.device, x, dt, a, b, c, y, state,
                *(torch.empty(shape, dtype=torch.float32, device=x.device)
                  for shape in scratch.values()),
                bsz, s, h, p, n, int(x.dtype == torch.bfloat16),
                *x.stride()[:3], *dt.stride()[:2], *b.stride()[:2],
                *c.stride()[:2])
        _count(ssd_scan)
    return y, state


def ssd_work(x, dt, b, chunk: int = TILE) -> tuple:
    """(bytes, C B^T operations, the other operations) of one scan at
    ``chunk`` (the kernel's own by default): C B^T once a chunk (shared by
    the heads), and per head and chunk W X, C state and the state update;
    x, dt, a, B and C read once, y and the fp32 final state written once.
    The causal mask leaves C B^T and W X their lower triangle, ch (ch + 1)
    / 2 of the ch^2 pairs."""
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    ch = min(chunk, s)
    nc = -(-s // ch)
    tri = ch * (ch + 1) // 2
    nbytes = (2 * x.numel() * x.element_size() + bsz * h * n * p * 4
              + dt.numel() * 4 + h * 4 + 2 * b.numel() * b.element_size())
    return (nbytes, bsz * nc * 2 * tri * n,
            bsz * h * nc * (2 * tri * p + 4 * ch * n * p))


def ssd_scratch(bsz: int, s: int, h: int, p: int, n: int) -> dict:
    """The kernels' 4-byte scratch shapes: C B^T per chunk (``cb``), each
    chunk's state contribution, then the state before it as bf16 hi + lo
    words, in (P, N16) rows (``ut``), and each chunk's g_tot (``gtot``);
    NC = ceil(S / TILE), N16 = N rounded up to 16."""
    nc, n16 = -(-s // TILE), -(-n // 16) * 16
    return {"cb": (bsz, nc, TILE, TILE), "ut": (bsz, h, nc, p, n16),
            "gtot": (bsz, h, nc)}


ssd_scan.launches = 0
