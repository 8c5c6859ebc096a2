"""Attention: GQA / MQA / MHA with RoPE or M-RoPE (Qwen2-VL's three
position streams), optional QK-norm (Qwen3), causal or sliding-window.

* :func:`rot_tables`       — the rotary tables of a forward's or a decode
  step's positions, built once and shared by q, k and every layer.
* :func:`attention_full`   — the whole sequence (prefill and the full
  forward), computed by the ``flash_attention`` kernel.
* :func:`attention_decode` — one token against the layer's ring KV cache,
  computed by the ``decode_attention`` kernel. It writes the new token's
  K/V, its absolute position and the advanced ``pos`` into the cache IN
  PLACE (the reference returns a new cache; ``index_put_`` here in place of
  ``.at[].set``).
* :func:`init_decode_cache` / :func:`cache_window` — the cache
  (:func:`decode_cache_shapes` its shapes, nothing allocated).
* :func:`attn_logical` / :func:`decode_cache_logical` — the logical axes of
  the attention leaves and of the cache (``sharding.rules``).

Both kernels read the model's layouts through strides: q/k/v (B, S, H, D)
and the cache (B, W, Hkv, D) go in as transposed views; nothing is copied.
On CPU tensors the kernels' wrappers take their plain versions.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..kernels import attention as katt
from .layers import apply_rot, dense, mrope_tables, rms_norm, rope_tables

__all__ = ["rot_tables", "attention_full", "attention_decode", "cache_window",
           "init_decode_cache", "decode_cache_shapes", "attn_logical",
           "decode_cache_logical"]


def attn_logical(cfg) -> Dict[str, tuple]:
    """The logical axes of the attention leaves (the reference's)."""
    p = {
        "wq": (None, "w_embed", "heads"),
        "wk": (None, "w_embed", "kv"),
        "wv": (None, "w_embed", "kv"),
        "wo": (None, "heads", "w_embed"),
    }
    if cfg.qk_norm:
        p["qn"] = (None, None)
        p["kn"] = (None, None)
    return p


def decode_cache_logical() -> Dict[str, tuple]:
    """The logical axes of the stacked decode cache (the reference's)."""
    return {
        "k": (None, "batch", "kv_seq", "kv", None),
        "v": (None, "batch", "kv_seq", "kv", None),
        "abs_pos": (None, "batch", None),
        "pos": (None, "batch"),
    }


def rot_tables(cfg, positions):
    """(cos, sin) of ``positions`` for every layer's q and k: M-RoPE's over
    (B, 3, S) streams where ``cfg.mrope`` — a (B, S) stream, such as a text
    prompt's or a decode step's ``pos[:, None]``, taken as t = h = w, as the
    reference does — else RoPE's over (B, S) or (S,)."""
    if not cfg.mrope:
        return rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    if positions.dim() == 2:
        b, s = positions.shape
        positions = positions[:, None, :].expand(b, 3, s)
    return mrope_tables(positions, cfg.head_dim, cfg.mrope_sections,
                        cfg.rope_theta)


def _project_qkv(x, p, cfg, rot):
    """q, k, v (B,S,H,Dh): with ``cfg.qk_norm``, q and k RMS-normed over the
    head dim by the layer's ``qn`` / ``kn`` first; then rotated by ``rot``
    (:func:`rot_tables` of the tokens' positions)."""
    b, s, _ = x.shape
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = dense(x, p["wq"]).view(b, s, hq, dh)
    k = dense(x, p["wk"]).view(b, s, hkv, dh)
    v = dense(x, p["wv"]).view(b, s, hkv, dh)
    if cfg.qk_norm:
        q = rms_norm(q, p["qn"])
        k = rms_norm(k, p["kn"])
    return apply_rot(q, *rot), apply_rot(k, *rot), v


def attention_full(x, p, cfg, rot
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x (B,S,d), ``rot`` the positions' rotary tables -> (output (B,S,d),
    {k, v (B,S,Hkv,Dh)}, the rope'd K/V).

    The probabilities stay fp32 through P.V (the reference's XLA path casts
    them to the activation dtype first; in fp32 the two are equal)."""
    b, s, _ = x.shape
    q, k, v = _project_qkv(x, p, cfg, rot)
    out = katt.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), cfg.window)
    out = out.transpose(1, 2).reshape(b, s, cfg.attn_dim)
    return dense(out, p["wo"]), {"k": k, "v": v}


def cache_window(cfg, seq_len: int) -> int:
    """Slots kept in the decode cache: W for SWA archs, full context else."""
    return min(cfg.window, seq_len) if cfg.window > 0 else seq_len


def attention_decode(x, p, cfg, cache, rot) -> torch.Tensor:
    """x (B,1,d); cache: the layer's {k, v (B,W,Hkv,Dh), abs_pos (B,W)
    absolute position of each slot (-1 = empty), pos (B,) absolute position
    of the new token}, updated in place; ``rot`` the rotary tables of
    ``pos``.
    Returns the output (B,1,d)."""
    b = x.shape[0]
    pos = cache["pos"]
    q, k_new, v_new = _project_qkv(x, p, cfg, rot)
    k, v, abs_pos = cache["k"], cache["v"], cache["abs_pos"]
    slot = (pos % k.shape[1]).long()        # ring slot (== pos when W >= ctx)
    bidx = torch.arange(b, device=x.device)
    k.index_put_((bidx, slot), k_new[:, 0])
    v.index_put_((bidx, slot), v_new[:, 0])
    abs_pos.index_put_((bidx, slot), pos)
    out = katt.decode_attention(q[:, 0], k.transpose(1, 2), v.transpose(1, 2),
                                abs_pos, pos, cfg.window)
    pos.add_(1)
    return dense(out.reshape(b, 1, cfg.attn_dim), p["wo"])


def decode_cache_shapes(cfg, batch: int, seq_len: int, dtype
                        ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """{name: (shape, dtype)} of :func:`init_decode_cache`'s tensors."""
    w = cache_window(cfg, seq_len)
    nl = cfg.n_layers
    kv = (nl, batch, w, cfg.n_kv_heads, cfg.head_dim)
    return {"k": (kv, dtype), "v": (kv, dtype),
            "abs_pos": ((nl, batch, w), torch.int32),
            "pos": ((nl, batch), torch.int32)}


def init_decode_cache(cfg, batch: int, seq_len: int, dtype, device
                      ) -> Dict[str, torch.Tensor]:
    """Per-layer KV cache, stacked: k/v (L, B, W, Hkv, Dh) zeros, abs_pos
    (L, B, W) -1 (empty), pos (L, B) 0."""
    fill = {"abs_pos": -1}
    return {k: torch.full(shape, fill.get(k, 0), dtype=dt, device=device)
            for k, (shape, dt) in decode_cache_shapes(cfg, batch, seq_len,
                                                      dtype).items()}
