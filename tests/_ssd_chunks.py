"""A plain torch mirror of the CUDA ``ssd_scan``'s phases
(``src/repro_torch/kernels/csrc/ssd_scan.cu``), for CPU tests.

The kernel cuts the sequence into chunks of ``tile`` steps (64 on the card)
and runs, per chunk: g = cumsum(dt a) as a warp scan (two steps a lane, then
a Kogge-Stone scan over the lanes); C B^T once for every head; the chunk's
state contribution U_c = B^T (e^{g_tot - g} dt o X); the pass over the
chunks, prev_{c+1} = e^{g_tot} prev_c + U_c; then y = W X + (C prev_c) o e^g
with W = (C B^T) o Gamma o dt, masked to the causal triangle before the
exponential. Every product runs on the tensor cores with bf16 operands and
fp32 sums: an fp32 operand is split into bf16 hi + lo and each part is a
product of its own (both operands fp32: hi.hi + lo.hi + hi.lo). Here the
split is emulated exactly: bf16-rounded fp32 values multiplied in fp32.
"""
import torch
import torch.nn.functional as F


def split(v):
    """fp32 -> (hi, lo), both bf16 values held in fp32: hi = bf16(v),
    lo = bf16(v - hi)."""
    hi = v.to(torch.bfloat16).float()
    return hi, (v - hi).to(torch.bfloat16).float()


def split_product(eq, a, b, a_exact, b_exact):
    """``einsum(eq, a, b)`` as the kernel multiplies: an operand that is not
    exact in bf16 goes in as its hi and lo parts, one product each, and the
    lo.lo product is left out."""
    ah, al = (a, None) if a_exact else split(a)
    bh, bl = (b, None) if b_exact else split(b)
    out = torch.einsum(eq, ah, bh)
    if al is not None:
        out = out + torch.einsum(eq, al, bh)
    if bl is not None:
        out = out + torch.einsum(eq, ah, bl)
    return out


def warp_cumsum(v):
    """Inclusive cumsum over dim -2 (the chunk's steps, an even count) in
    the kernel's order: pairs summed in each lane, then a Kogge-Stone scan
    of the pair sums over the lanes, each pair completed from the sum of
    the lanes before it."""
    v0 = v[..., 0::2, :]
    v1 = v0 + v[..., 1::2, :]
    run, lanes, o = v1, v1.shape[-2], 1
    while o < lanes:
        run = run + F.pad(run[..., :-o, :], (0, 0, o, 0))
        o *= 2
    before = F.pad(run[..., :-1, :], (0, 0, 1, 0))
    return torch.stack([before + v0, before + v1], -2).flatten(-3, -2)


def ssd_chunks(x, dt, a, b, c, tile: int = 64, return_state: bool = False):
    """The kernel's phases on CPU tensors. x (B, S, H, P) fp32 or bf16, dt
    (B, S, H) fp32, a (H,) fp32, b/c (B, S, N) in x's dtype -> y in x's
    dtype, or (y, final state (B, H, N, P) fp32). Any S: the last chunk is
    zero-padded (dt = 0, zero x, b, c)."""
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    exact = x.dtype == torch.bfloat16        # bf16 inputs go in as they are
    nc = -(-s // tile)
    pad = nc * tile - s
    xf = F.pad(x.float(), (0, 0, 0, 0, 0, pad)).reshape(bsz, nc, tile, h, p)
    dtc = F.pad(dt.float(), (0, 0, 0, pad)).reshape(bsz, nc, tile, h)
    bc = F.pad(b.float(), (0, 0, 0, pad)).reshape(bsz, nc, tile, n)
    cc = F.pad(c.float(), (0, 0, 0, pad)).reshape(bsz, nc, tile, n)

    # 1. C B^T once per chunk, shared by the heads
    cb = split_product("bcln,bcmn->bclm", cc, bc, exact, exact)
    g = warp_cumsum(dtc * a.float())                        # (B,NC,L,H)
    gtot = g[:, :, -1]                                      # (B,NC,H)

    # 2. each chunk's state contribution
    coef = torch.exp(gtot[:, :, None] - g) * dtc
    u = split_product("bcln,bclhp->bchnp", bc, xf * coef[..., None], exact,
                      False)                                # (B,NC,H,N,P)

    # 3. the pass: the state before each chunk, and the final state
    decay = torch.exp(gtot)
    state = torch.zeros((bsz, h, n, p), dtype=torch.float32)
    prev = []
    for i in range(nc):
        prev.append(state)
        state = state * decay[:, i, :, None, None] + u[:, i]
    prev = torch.stack(prev, 1)

    # 4. y per chunk: W X + (C prev) o e^g, the mask before the exponential
    li = torch.arange(tile)
    causal = (li[:, None] >= li[None, :])[None, None, :, :, None]
    delta = torch.where(causal, g[:, :, :, None, :] - g[:, :, None, :, :],
                        float("-inf"))                      # (B,NC,L,M,H)
    w = cb[..., None] * torch.exp(delta) * dtc[:, :, None, :, :]
    y = split_product("bclmh,bcmhp->bclhp", w, xf, False, exact)
    carry = split_product("bcln,bchnp->bclhp", cc, prev, exact, False)
    y = y + carry * torch.exp(g)[..., None]
    y = y.reshape(bsz, nc * tile, h, p)[:, :s].to(x.dtype)
    return (y, state) if return_state else y
