"""The Mamba-2 (SSD) mixer in PyTorch: the reference's ``models/ssm.py``.

* :func:`ssm_mixer_full` — the whole sequence (prefill and the full
  forward): in-projection, the causal depthwise convolution, the SSD scan by
  the ``ssd_scan`` kernel (which also returns the final state), the skip
  term, the gate, RMSNorm and the out-projection. Returns the output and the
  layer's decode cache.
* :func:`ssm_mixer_decode` — one token against the layer's cache: the
  convolution over the cached window and the exact recurrence, in fp32. It
  updates the cache IN PLACE (the reference returns a new one).
* :func:`ssm_param_shapes` / :func:`init_ssm_cache` — the parameters and the
  cache.

The rounding points are the reference's: the in-projections are products in
the activation dtype, ``dt`` is fp32; the prefill convolution runs in the
activation dtype (shifted products added in order), the decode convolution
in fp32; the scan's y comes back in x's dtype, the skip term is added in
fp32, then the cast, the gate in the activation dtype and the norm. The
model reaches the kernel as ``kssd.ssd_scan`` at call time, so swapping the
module attribute swaps the path.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..kernels import ssd as kssd
from .layers import Leaf, dense, rms_norm

__all__ = ["ssm_param_shapes", "ssm_mixer_full", "ssm_mixer_decode",
           "init_ssm_cache", "ssm_cache_shapes", "ssm_logical",
           "ssm_cache_logical"]


def ssm_param_shapes(cfg) -> Dict[str, Leaf]:
    """The reference's ``init_ssm_params`` tree, leaf for leaf: dt_bias,
    a_log and skip_d are fp32 in any model and start at 0.5, 0 and 1."""
    nl, d = cfg.n_layers, cfg.d_model
    di, n, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    f32 = torch.float32
    return {
        "wz": Leaf((nl, d, di), d), "wx": Leaf((nl, d, di), d),
        "wb": Leaf((nl, d, n), d), "wc": Leaf((nl, d, n), d),
        "wdt": Leaf((nl, d, h), d),
        "dt_bias": Leaf((nl, h), fill=0.5, dtype=f32),
        "a_log": Leaf((nl, h), fill=0.0, dtype=f32),      # A = -exp(a_log)
        "skip_d": Leaf((nl, h), fill=1.0, dtype=f32),
        "conv_w": Leaf((nl, cfg.conv_width, di + 2 * n), cfg.conv_width),
        "norm": Leaf((nl, di)),
        "out": Leaf((nl, di, d), di),
    }


def ssm_logical(cfg) -> Dict[str, tuple]:
    """The logical axes of the mixer's leaves (the reference's): the inner
    width (``ff``) splits the in / out projections, the conv and the gated
    norm."""
    return {
        "wz": (None, "w_embed", "ff"),
        "wx": (None, "w_embed", "ff"),
        "wb": (None, "w_embed", None),
        "wc": (None, "w_embed", None),
        "wdt": (None, "w_embed", None),
        "dt_bias": (None, None),
        "a_log": (None, None),
        "skip_d": (None, None),
        "conv_w": (None, None, "ff"),
        "norm": (None, "ff"),
        "out": (None, "ff", "w_embed"),
    }


def ssm_cache_logical() -> Dict[str, tuple]:
    """The logical axes of the stacked SSM cache (the reference's)."""
    return {
        "conv": (None, "batch", None, "ff"),
        "state": (None, "batch", None, None, None),
    }


def _causal_conv(x, w):
    """Depthwise causal convolution by K-1 shifted adds, in x's dtype.
    x (B,S,C); w (K,C)."""
    k, s = w.shape[0], x.shape[1]
    out = x * w[k - 1]
    for i in range(1, k):
        shifted = F.pad(x, (0, 0, i, 0))[:, :s]
        out = out + shifted * w[k - 1 - i]
    return out


def _in_proj(x, p):
    """z, x, B, C in the activation dtype; dt = softplus(x.f32 @ wdt +
    dt_bias) and a = -exp(a_log) in fp32."""
    z = dense(x, p["wz"])
    xi = dense(x, p["wx"])
    bm = dense(x, p["wb"])
    cm = dense(x, p["wc"])
    dt_raw = x.float() @ p["wdt"].float()
    v = dt_raw + p["dt_bias"]
    dt = torch.logaddexp(v, torch.zeros_like(v))     # jax.nn.softplus
    return z, xi, bm, cm, dt, -torch.exp(p["a_log"])


def _out(y, z, p):
    """The gate y * silu(z) in the activation dtype, RMSNorm, out-proj."""
    y = rms_norm(y * F.silu(z.float()).to(y.dtype), p["norm"])
    return dense(y, p["out"])


def ssm_mixer_full(x, p, cfg) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x (B,S,d) -> (output (B,S,d), {conv (B,K-1,C) the convolution's last
    K-1 inputs, state (B,H,N,P) fp32 the scan's final state})."""
    b, s, _ = x.shape
    di, n, h, ph = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    ch = min(cfg.ssd_chunk, s)
    if s % ch:                  # ssd_chunked's assert, kept under python -O
        raise ValueError(f"sequence length {s} is not a multiple of the "
                         f"SSD chunk {ch}")
    z, xi, bm, cm, dt, a = _in_proj(x, p)
    conv_in = torch.cat([xi, bm, cm], dim=-1)
    conv_out = F.silu(_causal_conv(conv_in, p["conv_w"]).float()).to(x.dtype)
    xi, bm, cm = conv_out.split([di, n, n], dim=-1)
    xh = xi.reshape(b, s, h, ph)                      # views, no copy
    y, state = kssd.ssd_scan(xh, dt, a, bm, cm, ch, return_state=True)
    y = y.float() + xh.float() * p["skip_d"][None, None, :, None]
    y = y.reshape(b, s, di).to(x.dtype)
    cache = {"conv": conv_in[:, -(cfg.conv_width - 1):], "state": state}
    return _out(y, z, p), cache


def ssm_mixer_decode(x, p, cfg, cache) -> torch.Tensor:
    """x (B,1,d); cache: the layer's {conv (B,K-1,C), state (B,H,N,P) fp32},
    updated in place. Returns the output (B,1,d)."""
    b = x.shape[0]
    di, n, h, ph = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    z, xi, bm, cm, dt, a = _in_proj(x, p)
    conv_in = torch.cat([xi, bm, cm], dim=-1)                 # (B,1,C)
    window = torch.cat([cache["conv"], conv_in], dim=1)       # (B,K,C)
    conv_out = F.silu(torch.einsum("bkc,kc->bc", window.float(),
                                   p["conv_w"].float()))
    xi, bm, cm = conv_out.to(x.dtype).split([di, n, n], dim=-1)
    xh = xi.reshape(b, h, ph).float()
    dt1 = dt[:, 0]                                            # (B,H)
    decay = torch.exp(dt1 * a[None, :])
    upd = (bm.float()[:, None, :, None]
           * (xh * dt1[:, :, None])[:, :, None, :])           # (B,H,N,P)
    state = cache["state"]
    state.mul_(decay[:, :, None, None]).add_(upd)
    y = torch.einsum("bn,bhnp->bhp", cm.float(), state)
    y = y + xh * p["skip_d"][None, :, None]
    y = y.reshape(b, 1, di).to(x.dtype)
    cache["conv"].copy_(window[:, 1:])
    return _out(y, z, p)


def ssm_cache_shapes(cfg, batch: int, dtype
                     ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """{name: (shape, dtype)} of :func:`init_ssm_cache`'s tensors."""
    nl = cfg.n_layers
    conv = (nl, batch, cfg.conv_width - 1, cfg.d_inner + 2 * cfg.ssm_state)
    state = (nl, batch, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim)
    return {"conv": (conv, dtype), "state": (state, torch.float32)}


def init_ssm_cache(cfg, batch: int, dtype, device) -> Dict[str, torch.Tensor]:
    """Per-layer SSM cache, stacked: conv (L, B, K-1, C) in the model's
    dtype and state (L, B, H, N, P) fp32, zeros."""
    return {k: torch.zeros(shape, dtype=dt, device=device)
            for k, (shape, dt) in ssm_cache_shapes(cfg, batch, dtype).items()}
