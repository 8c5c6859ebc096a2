"""The decoder stack in PyTorch: parameters, the full forward, prefill and
the decode step — the reference's ``models/transformer.py`` for the
``dense`` family (attention + SwiGLU or GELU MLP, tied or untied head) and
the ``ssm`` family (the Mamba-2 mixer alone: no attention, no MLP).

Parameters are a dict of tensors shaped as the reference's pytree: per-layer
weights stacked on a leading layer axis (``params["blocks"]["attn"]["wq"]``
is (L, d, Hq*Dh)), dense weights (in, out). The stack is a Python loop over
layer views. The families this port does not serve yet — ``moe``,
``hybrid``, ``vlm`` (M-RoPE), ``audio`` (``embed_stub``), ``qk_norm``,
meta tokens — raise ``NotImplementedError``; training (remat, the loss)
waits for a later slice.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from . import attention as attn
from . import ssm
from .layers import Leaf, dense, he_init, rms_norm, rope_tables

__all__ = ["check_supported", "param_shapes", "init_params", "forward", "prefill",
           "decode_step", "init_cache"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def check_supported(cfg) -> None:
    """Raise ``NotImplementedError`` for what this slice does not port."""
    why = None
    if cfg.family not in ("dense", "ssm"):
        why = f"family {cfg.family!r} comes with a later slice (ROADMAP A10)"
    elif cfg.is_moe or cfg.qk_norm or cfg.mrope or cfg.meta_tokens or (
            cfg.frontend != "text"):
        why = ("MoE, qk_norm, M-RoPE, meta tokens and stub frontends come "
               "with a later slice (ROADMAP A10)")
    elif cfg.family == "dense" and (not cfg.has_attention or cfg.has_ssm
                                    or cfg.d_ff <= 0):
        why = "a dense config needs attention and an MLP, and no SSM"
    elif cfg.family == "ssm" and (cfg.has_attention or not cfg.has_ssm
                                  or cfg.d_ff > 0):
        why = ("an ssm config is the Mamba-2 mixer alone (attention + SSM "
               "heads are the hybrid family: a later slice, ROADMAP A10)")
    if why:
        raise NotImplementedError(f"{cfg.name}: {why}")


def dtype_of(cfg) -> torch.dtype:
    return _DTYPES[cfg.dtype]


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------
def param_shapes(cfg) -> Dict[str, Any]:
    """The parameter tree's :class:`~.layers.Leaf` s (shape, fan-in or fill,
    dtype): the reference's ``init_params`` tree, leaf for leaf."""
    check_supported(cfg)
    nl, d, f, v = cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.vocab
    a, kv = cfg.attn_dim, cfg.kv_dim
    blocks: Dict[str, Any] = {"ln1": Leaf((nl, d))}
    if cfg.has_ssm:
        blocks["ssm"] = ssm.ssm_param_shapes(cfg)
    else:
        mlp = {"wu": Leaf((nl, d, f), d), "wd": Leaf((nl, f, d), f)}
        if cfg.mlp_gated:
            mlp["wg"] = Leaf((nl, d, f), d)
        blocks.update(
            attn={"wq": Leaf((nl, d, a), d), "wk": Leaf((nl, d, kv), d),
                  "wv": Leaf((nl, d, kv), d), "wo": Leaf((nl, a, d), a)},
            ln2=Leaf((nl, d)), mlp=mlp)
    tree: Dict[str, Any] = {"embed": Leaf((v, d), d),
                            "final_norm": Leaf((d,)), "blocks": blocks}
    if not cfg.tie_embeddings:
        tree["lm_head"] = Leaf((d, v), d)
    return tree


def init_params(cfg, seed: int = 0, device="cuda") -> Dict[str, Any]:
    """Random He-normal weights (constants where the leaf has a fill: norm
    scales 1, the SSM's dt_bias 0.5, a_log 0, skip_d 1), drawn by a
    ``torch.Generator`` on ``device``: a full-width model is never built on
    the host. Not the reference's numbers (``jax.random`` differs); carry
    the reference's with ``convert.params_from_reference``."""
    dtype = dtype_of(cfg)
    g = torch.Generator(device=device).manual_seed(seed)

    def make(tree):
        out = {}
        for k, leaf in tree.items():
            if isinstance(leaf, dict):
                out[k] = make(leaf)
            elif leaf.fan_in is None:
                out[k] = torch.full(leaf.shape, leaf.fill,
                                    dtype=leaf.dtype or dtype, device=device)
            else:
                out[k] = he_init(leaf.shape, leaf.fan_in,
                                 leaf.dtype or dtype, g)
        return out

    return make(param_shapes(cfg))


def _layers(stacked) -> list:
    """Per-layer dicts of views into a dict of stacked (L, ...) tensors."""
    cols = {k: (_layers(t) if isinstance(t, dict) else t.unbind(0))
            for k, t in stacked.items()}
    n = len(next(iter(cols.values())))
    return [{k: c[i] for k, c in cols.items()} for i in range(n)]


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------
def _mlp_apply(x, p, cfg):
    if cfg.mlp_gated:
        h = F.silu(dense(x, p["wg"]).float()).to(x.dtype) * dense(x, p["wu"])
    else:   # jax.nn.gelu's default is the tanh approximation
        h = F.gelu(dense(x, p["wu"]).float(), approximate="tanh").to(x.dtype)
    return dense(h, p["wd"])


def _block_full(x, pl, cfg, rot):
    a_out, kv = attn.attention_full(rms_norm(x, pl["ln1"]), pl["attn"], cfg,
                                    rot)
    x = x + a_out
    return x + _mlp_apply(rms_norm(x, pl["ln2"]), pl["mlp"], cfg), kv


def _block_decode(x, pl, cfg, cache, rot):
    x = x + attn.attention_decode(rms_norm(x, pl["ln1"]), pl["attn"], cfg,
                                  cache, rot)
    return x + _mlp_apply(rms_norm(x, pl["ln2"]), pl["mlp"], cfg)


def _ssm_block_full(x, pl, cfg, rot):
    """The ssm family's block: the mixer alone (the reference's
    ``x + mix / 1``), no MLP."""
    s_out, cache = ssm.ssm_mixer_full(rms_norm(x, pl["ln1"]), pl["ssm"], cfg)
    return x + s_out, cache


def _ssm_block_decode(x, pl, cfg, cache, rot):
    return x + ssm.ssm_mixer_decode(rms_norm(x, pl["ln1"]), pl["ssm"], cfg,
                                    cache)


# ---------------------------------------------------------------------------
# Head
# ---------------------------------------------------------------------------
def _lm_head(x, params, cfg) -> torch.Tensor:
    """fp32 logits of the activation-dtype product (the reference's
    ``preferred_element_type=float32``): on the card, one cuBLAS product
    that accumulates and emits fp32 (``torch.mm(..., out_dtype=float32)``);
    on the CPU, the product of the operands upcast to fp32 (bf16 products
    are exact in fp32, so both sum the same terms)."""
    w = params["embed"].t() if cfg.tie_embeddings else params["lm_head"]
    x2 = x.reshape(-1, x.shape[-1])
    if x2.is_cuda and x2.dtype != torch.float32:
        logits = torch.mm(x2, w, out_dtype=torch.float32)
    else:
        logits = x2.float() @ w.float()
    return logits.view(*x.shape[:-1], w.shape[-1])


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------
def forward(params, cfg, batch, collect_cache: bool = False,
            logits_last_only: bool = False):
    """The full-sequence forward without remat (the reference's
    ``forward_train(remat=False)``). batch: {tokens (B,S)[, positions]}.
    Returns (fp32 logits (B,S,V) — (B,1,V) with ``logits_last_only`` —,
    the per-layer cache list — {k, v}, or {conv, state} for ssm — or
    None)."""
    check_supported(cfg)
    tokens = batch["tokens"]
    x = params["embed"][tokens.long()]
    b, s = tokens.shape
    if cfg.has_ssm:                     # attention-free: no rope table
        block, rot = _ssm_block_full, None
    else:
        positions = batch.get("positions")
        if positions is None:
            positions = torch.arange(s, dtype=torch.int32,
                                     device=tokens.device)[None].expand(b, s)
        block = _block_full
        rot = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    caches = [] if collect_cache else None
    for pl in _layers(params["blocks"]):
        x, kv = block(x, pl, cfg, rot)
        if collect_cache:
            caches.append(kv)
    x = rms_norm(x, params["final_norm"])
    if logits_last_only:
        x = x[:, -1:]
    return _lm_head(x, params, cfg), caches


def prefill(params, cfg, batch, seq_len_cache: Optional[int] = None):
    """Forward over the prompt, then the decode cache.

    Returns (last-token logits (B,V), {"attn": {k, v (L,B,W,Hkv,Dh),
    abs_pos (L,B,W), pos (L,B)}}): absolute position p lives in ring slot
    p % W. With W <= S the last W keys are rolled into place; with W > S
    (decode headroom past the prompt) the keys are padded and the empty
    slots marked -1. The ssm family's cache is {"ssm": {conv (L,B,K-1,C),
    state (L,B,H,N,P) fp32}}, whatever ``seq_len_cache``."""
    logits, caches = forward(params, cfg, batch, collect_cache=True,
                             logits_last_only=True)
    if cfg.has_ssm:
        return logits[:, -1], {"ssm": {
            k: torch.stack([c[k] for c in caches]) for k in ("conv", "state")}}
    k = torch.stack([c["k"] for c in caches])       # (L,B,S,Hkv,Dh)
    v = torch.stack([c["v"] for c in caches])
    nl, b, s_tot = k.shape[:3]
    w = attn.cache_window(cfg, max(seq_len_cache or s_tot, s_tot))
    slots = torch.arange(w, dtype=torch.int32, device=k.device)
    if w <= s_tot:
        r = (s_tot - w) % w
        k = torch.roll(k[:, :, s_tot - w:], r, dims=2)
        v = torch.roll(v[:, :, s_tot - w:], r, dims=2)
        abs_pos = s_tot - w + (slots - r) % w
    else:
        pad = (0, 0, 0, 0, 0, w - s_tot)
        k = F.pad(k, pad)
        v = F.pad(v, pad)
        abs_pos = torch.where(slots < s_tot, slots, -1).to(torch.int32)
    cache = {"k": k.contiguous(), "v": v.contiguous(),
             "abs_pos": abs_pos.expand(nl, b, w).contiguous(),
             "pos": torch.full((nl, b), s_tot, dtype=torch.int32,
                               device=k.device)}
    return logits[:, -1], {"attn": cache}


def decode_step(params, cfg, batch, cache):
    """One decode step. batch: {tokens (B,)}. Returns (fp32 logits (B,V),
    cache) — the same cache dict, updated IN PLACE (each layer's new K/V
    slot, abs_pos and pos; for ssm each layer's conv window and state)."""
    check_supported(cfg)
    x = params["embed"][batch["tokens"].long()][:, None, :]
    if cfg.has_ssm:
        block, rot, layer_caches = _ssm_block_decode, None, cache["ssm"]
    else:
        # every layer's pos is the same (prefill sets them together, each
        # step advances each by one): one rope table serves the whole stack
        pos = cache["attn"]["pos"][0]
        block, layer_caches = _block_decode, cache["attn"]
        rot = rope_tables(pos[:, None], cfg.head_dim, cfg.rope_theta)
    for pl, lc in zip(_layers(params["blocks"]), _layers(layer_caches)):
        x = block(x, pl, cfg, lc, rot)
    x = rms_norm(x, params["final_norm"])
    return _lm_head(x[:, 0], params, cfg), cache


def init_cache(cfg, batch: int, seq_len: int, device="cuda"):
    """An empty decode cache for ``batch`` rows of ``seq_len`` context (the
    SSM's cache has no context length)."""
    check_supported(cfg)
    if cfg.has_ssm:
        return {"ssm": ssm.init_ssm_cache(cfg, batch, dtype_of(cfg), device)}
    return {"attn": attn.init_decode_cache(cfg, batch, seq_len,
                                           dtype_of(cfg), device)}
