"""The Mamba-2 mixer split over ``model`` (the ``ssm`` and ``hybrid``
families' sharded steps): what GSPMD makes of the reference's
``ssm_mixer_train`` / ``ssm_mixer_decode`` under ``ssm_logical``, written
out per position.

Position ``j`` of ``model`` owns SSM heads ``[j*H/m, (j+1)*H/m)``:

* ``wz`` and ``wx`` give its heads' inner columns (taken on head
  boundaries; gathered where the rule's ``ff`` split is elsewhere);
  ``wb``, ``wc`` and ``wdt`` are whole, and ``dt_bias``, ``a_log`` and
  ``skip_d`` are sliced to its heads.
* The depthwise conv's channels are ``[x | B | C]`` (``C = d_inner +
  2N``); the rules split them at ``C/m``, which is not the heads' split,
  so each position takes its own heads' ``x`` channels and all of ``B``
  and ``C`` from ``conv_w``. The conv is per channel, so this is exact.
* B9 (``kernels.ssd.ssd_scan``) runs on the position's heads with the
  whole ``B`` and ``C``.
* The gated RMSNorm averages over the whole ``d_inner``: each position's
  fp32 sum of squares is summed over ``model`` before the scale.
* ``out`` holds the position's rows; the partial products are summed over
  ``model`` (reduce-scattered over the sequence under sequence sharding,
  where the mixer's input is the gathered rows).

A decode step keeps the cache in its layout: ``conv`` split over
``model`` at the conv's ``C/m`` channels, ``state`` whole on every
position. Each position runs the conv window on its channels; the step's
conv output (B, C) is gathered over ``model``; every position advances
the whole state (no collective: it is replicated); the gated norm and
``out`` run on the position's heads as above.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from ..kernels import ssd as kssd
from ..sharding.placement import Sharded, all_gather, psum, smap
from . import parallel as par
from . import ssm as mssm
from .layers import dense

__all__ = ["mixer", "mixer_decode", "head_ranges"]


def head_ranges(cfg, plan):
    """Each ``model`` position's SSM head range."""
    return par._ranges(cfg.ssm_heads, plan.m)


def _weights(p: Dict[str, Sharded], cfg, plan):
    """(head ranges, their inner column ranges, the per-position z / x /
    norm / out slices and the whole B / C / dt projections)."""
    ph = cfg.ssm_head_dim
    heads = head_ranges(cfg, plan)
    cols = [(a * ph, b * ph) for a, b in heads]
    w = {"wz": par._take(par._fsdp(p["wz"], 0), 1, cols, plan),
         "wx": par._take(par._fsdp(p["wx"], 0), 1, cols, plan),
         "wb": par._fsdp(p["wb"], 0), "wc": par._fsdp(p["wc"], 0),
         "wdt": par._fsdp(p["wdt"], 0),
         "norm": par._take(p["norm"], 0, cols, plan),
         "out": par._take(par._fsdp(p["out"], 1), 0, cols, plan)}
    return heads, cols, w


def _gate(y, z):
    """The gate ``y * silu(z)`` in the activation dtype, and its fp32 sum
    of squares over the position's inner columns."""
    g = y * F.silu(z.float()).to(y.dtype)
    g32 = g.float()
    return g, (g32 * g32).sum(-1, keepdim=True)


def _gated_out(g: Sharded, ss: Sharded, w, cfg, plan, like: Sharded
               ) -> Sharded:
    """RMSNorm of the gated rows over the whole ``d_inner`` (the sums of
    squares summed over ``model``), then the out-projection, summed over
    ``model``."""
    ss = psum(ss, plan.tp)
    di = cfg.d_inner

    def local(g, ss, nw, ow):
        y = g.float() * torch.rsqrt(ss / di + 1e-6)
        return dense((y * nw.float()).to(g.dtype), ow)
    return par._reduced(smap(local, g, ss, w["norm"], w["out"]), like, plan)


def _dt(x, wdt, dt_bias, h0, h1):
    """softplus(x.f32 @ wdt[:, h0:h1] + dt_bias[h0:h1]), fp32."""
    v = x.float() @ wdt[:, h0:h1].float() + dt_bias[h0:h1]
    return torch.logaddexp(v, torch.zeros_like(v))


def mixer(h: Sharded, p: Dict[str, Sharded], cfg, plan,
          collect: bool = False, *, like: Sharded):
    """The split mixer over a whole sequence: h (B, S, d) with whole rows
    -> (output (B, S, d) laid out as ``like`` (``h``, or each position's
    rows where ``like``'s split), and where ``collect`` the
    per-position
    cache pieces {"tail": the conv input's last K-1 rows (B, K-1, the
    position's x channels + 2N), "state": its heads' final state (B, H_j,
    N, P) fp32}, else None)."""
    di, n, ph = cfg.d_inner, cfg.ssm_state, cfg.ssm_head_dim
    s = h.shape[1]
    ch = min(cfg.ssd_chunk, s)
    if s % ch:                  # ssd_chunked's assert, kept under python -O
        raise ValueError(f"sequence length {s} is not a multiple of the "
                         f"SSD chunk {ch}")
    heads, cols, w = _weights(p, cfg, plan)
    conv_w = par._take(p["conv_w"], 1, [
        list(range(a, b)) + list(range(di, di + 2 * n)) for a, b in cols],
        plan)
    k_tail = cfg.conv_width - 1

    def local(j, x, wz, wx, wb, wc, wdt, dt_bias, a_log, skip_d, cw):
        h0, h1 = heads[j]
        nl = (h1 - h0) * ph
        z, xi = dense(x, wz), dense(x, wx)
        dt = _dt(x, wdt, dt_bias, h0, h1)
        conv_in = torch.cat([xi, dense(x, wb), dense(x, wc)], dim=-1)
        conv_out = F.silu(mssm._causal_conv(conv_in, cw).float()).to(
            x.dtype)
        xi, bm, cm = conv_out.split([nl, n, n], dim=-1)
        xh = xi.reshape(x.shape[0], s, h1 - h0, ph)        # views, no copy
        y, state = kssd.ssd_scan(xh, dt, -torch.exp(a_log[h0:h1]), bm, cm,
                                 ch, return_state=True)
        y = y.float() + xh.float() * skip_d[h0:h1][None, None, :, None]
        g, ss = _gate(y.reshape(x.shape[0], s, nl).to(x.dtype), z)
        return g, ss, conv_in[:, -k_tail:], state
    g, ss, tail, state = smap(local, h, w["wz"], w["wx"], w["wb"], w["wc"],
                             w["wdt"], p["dt_bias"], p["a_log"],
                             p["skip_d"], conv_w, coord=plan.tp)
    out = _gated_out(g, ss, w, cfg, plan, like)
    return out, ({"tail": tail, "state": state} if collect else None)


def conv_ranges(conv: Sharded, cfg, plan):
    """Each ``model`` position's channel range of the conv cache (the
    whole ``C`` where the layout keeps it whole)."""
    c = cfg.d_inner + 2 * cfg.ssm_state
    if plan.tp and conv.spec.axes(conv.blocks[0].dim() - 1) == plan.tp:
        return par._ranges(c, plan.m)
    return [(0, c)] * plan.m


def _clip(rs, lo, hi):
    return [(min(max(a, lo), hi) - lo, min(max(b, lo), hi) - lo)
            for a, b in rs]


@torch.no_grad()
def mixer_decode(h: Sharded, p: Dict[str, Sharded], cfg, plan,
                 cache: Dict[str, Sharded]):
    """One token: h (B, 1, d) and the layer's cache {conv (B, K-1, C) over
    ``model``'s channel ranges, state (B, H, N, P) fp32 whole} ->
    (output (B, 1, d), {conv, state}: the new values, to be written into
    the cache by the caller). The rounding points are the one-device
    ``ssm_mixer_decode``'s."""
    di, n, ph, nh = (cfg.d_inner, cfg.ssm_state, cfg.ssm_head_dim,
                     cfg.ssm_heads)
    heads, cols, w = _weights(p, cfg, plan)
    cr = conv_ranges(cache["conv"], cfg, plan)
    wx_c = par._take(par._fsdp(p["wx"], 0), 1, _clip(cr, 0, di), plan)
    wb_c = par._take(w["wb"], 1, _clip(cr, di, di + n), plan)
    wc_c = par._take(w["wc"], 1, _clip(cr, di + n, di + 2 * n), plan)
    cw = par._take(p["conv_w"], 1, cr, plan)

    def window(x, wx, wb, wc, cw, conv):
        xin = torch.cat([dense(x, wx), dense(x, wb), dense(x, wc)], dim=-1)
        win = torch.cat([conv, xin], dim=1)                  # (B, K, C_j)
        out = F.silu(torch.einsum("bkc,kc->bc", win.float(), cw.float()))
        return win[:, 1:], out
    new_conv, co = smap(window, h, wx_c, wb_c, wc_c, cw, cache["conv"])
    if cr[0] != (0, di + 2 * n):
        co = all_gather(co, plan.tp, 1)                     # (B, C) fp32

    def advance(x, wdt, dt_bias, a_log, co, state):
        xi, bm, _ = co.to(x.dtype).split([di, n, n], dim=-1)
        xh = xi.reshape(x.shape[0], nh, ph).float()
        dt1 = _dt(x, wdt, dt_bias, 0, nh)[:, 0]              # (B, H)
        decay = torch.exp(dt1 * -torch.exp(a_log)[None, :])
        upd = (bm.float()[:, None, :, None]
               * (xh * dt1[:, :, None])[:, :, None, :])     # (B, H, N, P)
        return state * decay[:, :, None, None] + upd
    new_state = smap(advance, h, w["wdt"], p["dt_bias"], p["a_log"], co,
                     cache["state"], out=cache["state"].spec)

    def local(j, x, wz, co, state, skip_d):
        h0, h1 = heads[j]
        xi, _, cm = co.to(x.dtype).split([di, n, n], dim=-1)
        xh = xi.reshape(x.shape[0], nh, ph)[:, h0:h1].float()
        y = torch.einsum("bn,bhnp->bhp", cm.float(), state[:, h0:h1])
        y = y + xh * skip_d[h0:h1][None, :, None]
        y = y.reshape(x.shape[0], 1, (h1 - h0) * ph).to(x.dtype)
        return _gate(y, dense(x, wz))
    g, ss = smap(local, h, w["wz"], co, new_state, p["skip_d"],
                 coord=plan.tp)
    out = _gated_out(g, ss, w, cfg, plan, h)
    return out, {"conv": new_conv, "state": new_state}
