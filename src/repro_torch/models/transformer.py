"""The decoder stack in PyTorch: parameters, the full forward, prefill and
the decode step — the reference's ``models/transformer.py`` for every
family of its pool:

* ``dense``  — attention + SwiGLU or GELU MLP, tied or untied head;
* ``moe``    — attention + the sort-dispatch MoE FFN (``models/moe.py``),
  with QK-norm where the config has it (Qwen3);
* ``ssm``    — the Mamba-2 mixer alone (no attention, no MLP);
* ``hybrid`` — Hymba: the attention and SSM mixers side by side on the
  same normed input, their sum over the two paths, then the MLP; meta
  tokens (learned rows ahead of every prompt, stripped before the head);
* ``vlm``    — the dense block with M-RoPE over (t, h, w) position streams,
  fed the (stubbed) vision frontend's embeddings;
* ``audio``  — the dense block fed the (stubbed) audio frontend's frame
  embeddings.

An ``embed_stub`` frontend takes ``batch["embeds"]`` (B, S, d) in place of
tokens (a decode step: (B, d)), cast to the model's dtype.

Parameters are a dict of tensors shaped as the reference's pytree: per-layer
weights stacked on a leading layer axis (``params["blocks"]["attn"]["wq"]``
is (L, d, Hq*Dh)), dense weights (in, out). The stack is a Python loop over
layer views.

Training: :func:`forward_train` is :func:`forward` with each block under
``torch.utils.checkpoint`` (remat: nothing inside a block is kept for the
backward, as the reference's ``nothing_saveable``), and :func:`loss_fn` the
masked next-token cross entropy of its fp32 logits. The kernels' wrappers
carry their own gradients (the plain versions' derivatives), so a loss
through them differentiates on the card as on the CPU.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from . import attention as attn
from . import moe
from . import ssm
from .layers import Leaf, dense, he_init, rms_norm

__all__ = ["check_supported", "param_shapes", "init_params", "forward",
           "forward_train", "loss_fn", "prefill", "decode_step", "init_cache",
           "cache_shapes", "logical_axes", "cache_logical", "head_logits",
           "mlp_hidden"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def check_supported(cfg) -> None:
    """Raise ``NotImplementedError`` for a config whose flags contradict its
    family (or a family or frontend the reference does not have)."""
    why = None
    attn_ffn = cfg.has_attention and cfg.d_ff > 0 and not cfg.has_ssm
    if cfg.family not in ("dense", "moe", "ssm", "hybrid", "vlm", "audio"):
        why = f"unknown family {cfg.family!r}"
    elif cfg.frontend not in ("text", "embed_stub"):
        why = f"unknown frontend {cfg.frontend!r}"
    elif cfg.family == "moe" and not (attn_ffn and 0 < cfg.top_k
                                      <= cfg.n_experts):
        why = ("a moe config needs attention and experts (0 < top_k <= "
               "n_experts) with a d_ff, and no SSM")
    elif cfg.family != "moe" and cfg.is_moe:
        why = "experts belong to the moe family"
    elif cfg.family in ("dense", "vlm", "audio") and not attn_ffn:
        why = f"a {cfg.family} config needs attention and an MLP, and no SSM"
    elif cfg.family in ("vlm", "audio") and cfg.frontend != "embed_stub":
        why = f"a {cfg.family} config takes the embed_stub frontend"
    elif cfg.family == "vlm" and not cfg.mrope:
        why = "a vlm config rotates by M-RoPE"
    elif cfg.family == "ssm" and (cfg.has_attention or not cfg.has_ssm
                                  or cfg.d_ff > 0):
        why = ("an ssm config is the Mamba-2 mixer alone (attention + SSM "
               "heads are the hybrid family)")
    elif cfg.family == "hybrid" and not (cfg.has_attention and cfg.has_ssm
                                         and cfg.d_ff > 0):
        why = "a hybrid config needs attention, an SSM and an MLP"
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
    if cfg.has_attention:
        blocks["attn"] = {
            "wq": Leaf((nl, d, a), d), "wk": Leaf((nl, d, kv), d),
            "wv": Leaf((nl, d, kv), d), "wo": Leaf((nl, a, d), a)}
        if cfg.qk_norm:
            blocks["attn"].update(qn=Leaf((nl, cfg.head_dim)),
                                  kn=Leaf((nl, cfg.head_dim)))
    if cfg.has_ssm:
        blocks["ssm"] = ssm.ssm_param_shapes(cfg)
    if f > 0:
        blocks["ln2"] = Leaf((nl, d))
        if cfg.is_moe:
            blocks["moe"] = moe.moe_param_shapes(cfg)
        else:
            mlp = {"wu": Leaf((nl, d, f), d), "wd": Leaf((nl, f, d), f)}
            if cfg.mlp_gated:
                mlp["wg"] = Leaf((nl, d, f), d)
            blocks["mlp"] = mlp
    tree: Dict[str, Any] = {"embed": Leaf((v, d), d),
                            "final_norm": Leaf((d,)), "blocks": blocks}
    if not cfg.tie_embeddings:
        tree["lm_head"] = Leaf((d, v), d)
    if cfg.meta_tokens:
        tree["meta"] = Leaf((cfg.meta_tokens, d), d)
    return tree


def _mlp_logical(cfg) -> Dict[str, tuple]:
    p = {"wu": (None, "w_embed", "ff"), "wd": (None, "ff", "w_embed")}
    if cfg.mlp_gated:
        p["wg"] = (None, "w_embed", "ff")
    return p


def logical_axes(cfg) -> Dict[str, Any]:
    """The logical axes of every leaf of :func:`param_shapes` (the
    reference's table; ``sharding.rules`` maps them onto a mesh)."""
    check_supported(cfg)
    blocks: Dict[str, Any] = {"ln1": (None, None)}
    if cfg.has_attention:
        blocks["attn"] = attn.attn_logical(cfg)
    if cfg.has_ssm:
        blocks["ssm"] = ssm.ssm_logical(cfg)
    if cfg.d_ff > 0:
        blocks["ln2"] = (None, None)
        if cfg.is_moe:
            blocks["moe"] = moe.moe_logical(cfg)
        else:
            blocks["mlp"] = _mlp_logical(cfg)
    out = {"embed": ("vocab", "w_embed"), "final_norm": (None,),
           "blocks": blocks}
    if not cfg.tie_embeddings:
        out["lm_head"] = ("w_embed", "vocab")
    if cfg.meta_tokens:
        out["meta"] = (None, None)
    return out


def init_params(cfg, seed: int = 0, device="cuda") -> Dict[str, Any]:
    """Random He-normal weights (constants where the leaf has a fill: norm
    scales 1, the SSM's dt_bias 0.5, a_log 0, skip_d 1), drawn by a
    ``torch.Generator`` on ``device`` (a stacked leaf a layer at a time:
    ``layers.he_init``): a full-width model is never built on the host.
    Not the reference's numbers (``jax.random`` differs); carry the
    reference's with ``convert.params_from_reference``."""
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


def _layers(stacked):
    """Per-layer dicts of views into a dict of stacked (L, ...) tensors. A
    ``blocks`` that is not a dict is taken as the layers themselves: an
    iterable of per-layer dicts (such as one that builds each layer as it
    is reached)."""
    if not isinstance(stacked, dict):
        return stacked
    cols = {k: (_layers(t) if isinstance(t, dict) else t.unbind(0))
            for k, t in stacked.items()}
    n = len(next(iter(cols.values())))
    return [{k: c[i] for k, c in cols.items()} for i in range(n)]


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------
def mlp_hidden(x, p, cfg):
    """The MLP's hidden activations: SiLU(x wg) * x wu, or GELU(x wu)."""
    if cfg.mlp_gated:
        return F.silu(dense(x, p["wg"]).float()).to(x.dtype) * dense(x,
                                                                    p["wu"])
    # jax.nn.gelu's default is the tanh approximation
    return F.gelu(dense(x, p["wu"]).float(), approximate="tanh").to(x.dtype)


def _mlp_apply(x, p, cfg):
    return dense(mlp_hidden(x, p, cfg), p["wd"])


def _ffn(x, pl, cfg):
    """The block's feed-forward on its normed input: the MoE FFN of a moe
    config, else the MLP."""
    if cfg.is_moe:
        return moe.moe_ffn(x, pl["moe"], cfg)
    return _mlp_apply(x, pl["mlp"], cfg)


# Each block: (x, the layer's params, cfg, rotary tables) -> (x, the layer's
# cache {"attn": {k, v}} / {"ssm": {conv, state}} / both) for the full
# sequence; (x, params, cfg, the layer's cache, rotary tables) -> x for a
# decode step, which updates that cache in place.
def _block_full(x, pl, cfg, rot):
    """The dense, moe, vlm and audio families' block: attention, then the
    MLP or the MoE FFN."""
    a_out, kv = attn.attention_full(rms_norm(x, pl["ln1"]), pl["attn"], cfg,
                                    rot)
    x = x + a_out
    x = x + _ffn(rms_norm(x, pl["ln2"]), pl, cfg)
    return x, {"attn": kv}


def _block_decode(x, pl, cfg, cache, rot):
    x = x + attn.attention_decode(rms_norm(x, pl["ln1"]), pl["attn"], cfg,
                                  cache["attn"], rot)
    return x + _ffn(rms_norm(x, pl["ln2"]), pl, cfg)


def _ssm_block_full(x, pl, cfg, rot):
    """The ssm family's block: the mixer alone (the reference's
    ``x + mix / 1``), no MLP."""
    s_out, sc = ssm.ssm_mixer_full(rms_norm(x, pl["ln1"]), pl["ssm"], cfg)
    return x + s_out, {"ssm": sc}


def _ssm_block_decode(x, pl, cfg, cache, rot):
    return x + ssm.ssm_mixer_decode(rms_norm(x, pl["ln1"]), pl["ssm"], cfg,
                                    cache["ssm"])


def _hybrid_block_full(x, pl, cfg, rot):
    """The hybrid family's block (Hymba): the attention and SSM mixers on
    the same normed input, their sum divided by the two paths (in the
    activation dtype, as the reference's ``mix / n_paths``), then the
    MLP."""
    h = rms_norm(x, pl["ln1"])
    a_out, kv = attn.attention_full(h, pl["attn"], cfg, rot)
    s_out, sc = ssm.ssm_mixer_full(h, pl["ssm"], cfg)
    x = x + (a_out + s_out) / 2
    x = x + _mlp_apply(rms_norm(x, pl["ln2"]), pl["mlp"], cfg)
    return x, {"attn": kv, "ssm": sc}


def _hybrid_block_decode(x, pl, cfg, cache, rot):
    h = rms_norm(x, pl["ln1"])
    a_out = attn.attention_decode(h, pl["attn"], cfg, cache["attn"], rot)
    s_out = ssm.ssm_mixer_decode(h, pl["ssm"], cfg, cache["ssm"])
    x = x + (a_out + s_out) / 2
    return x + _mlp_apply(rms_norm(x, pl["ln2"]), pl["mlp"], cfg)


# ---------------------------------------------------------------------------
# Head
# ---------------------------------------------------------------------------
class _Head(torch.autograd.Function):
    """x2 (T, d) @ w (d, V) -> fp32 logits by one cuBLAS product that emits
    fp32; the backward's two products in the activation dtype (fp32
    accumulation), the fp32 logits' gradient rounded to it first."""

    @staticmethod
    def forward(ctx, x2, w):
        ctx.save_for_backward(x2, w)
        return torch.mm(x2, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x2, w = ctx.saved_tensors
        g = g.to(x2.dtype)
        return g @ w.t(), x2.t() @ g


def _lm_head(x, params, cfg) -> torch.Tensor:
    """fp32 logits of the activation-dtype product (the reference's
    ``preferred_element_type=float32``): :func:`head_logits` by the tied
    embedding's transpose or the untied head."""
    w = params["embed"].t() if cfg.tie_embeddings else params["lm_head"]
    return head_logits(x, w)


def head_logits(x, w) -> torch.Tensor:
    """x (..., d) @ w (d, V) -> fp32 logits (..., V): on the card, one
    cuBLAS product that accumulates and emits fp32 (:class:`_Head`); on
    the CPU, the product of the operands upcast to fp32 (bf16 products are
    exact in fp32, so both sum the same terms)."""
    x2 = x.reshape(-1, x.shape[-1])
    if x2.is_cuda and x2.dtype != torch.float32:
        logits = _Head.apply(x2, w)
    else:
        logits = x2.float() @ w.float()
    return logits.view(*x.shape[:-1], w.shape[-1])


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------
_BLOCKS = {"dense": (_block_full, _block_decode),
           "moe": (_block_full, _block_decode),
           "vlm": (_block_full, _block_decode),
           "audio": (_block_full, _block_decode),
           "ssm": (_ssm_block_full, _ssm_block_decode),
           "hybrid": (_hybrid_block_full, _hybrid_block_decode)}


def _embed_inputs(params, cfg, batch):
    """The input rows (B,S,d) — the token embeddings, or under an
    ``embed_stub`` frontend ``batch["embeds"]`` cast to the model's dtype —
    and their positions: ``batch["positions"]`` ((B,S), or (B,3,S) M-RoPE
    streams) or 0 .. S-1. With meta tokens, the learned ``meta`` rows ahead
    of every row and the positions shifted past them (the meta tokens at
    0 .. M-1 in every stream)."""
    if cfg.frontend == "embed_stub":
        x = batch["embeds"].to(dtype_of(cfg))
    else:
        x = params["embed"][batch["tokens"].long()]
    b, s = x.shape[:2]
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32,
                                 device=x.device)[None].expand(b, s)
    m = cfg.meta_tokens
    if m:
        meta = params["meta"].to(x.dtype)[None].expand(b, m, x.shape[-1])
        x = torch.cat([meta, x], dim=1)
        mpos = torch.arange(m, dtype=torch.int32, device=x.device)
        mpos = mpos.expand(*positions.shape[:-1], m)
        positions = torch.cat([mpos, positions + m], dim=-1)
    return x, positions


def _recompute_contexts():
    """checkpoint's (forward, recompute) contexts: the recompute counts no
    MoE dispatch the forward already counted."""
    return contextlib.nullcontext(), moe.stats.paused()


def forward(params, cfg, batch, collect_cache: bool = False,
            logits_last_only: bool = False, remat: bool = False):
    """The full-sequence forward (the reference's ``forward_train``).
    batch: {tokens (B,S)} or {embeds (B,S,d)} (``embed_stub``), [positions
    (B,S) or (B,3,S)]. With ``remat`` each block runs under
    ``torch.utils.checkpoint`` (non-reentrant): its activations are
    recomputed in the backward, kernels included.
    Returns (fp32 logits (B,S,V) — (B,1,V) with ``logits_last_only`` —,
    the per-layer cache list — {"attn": {k, v}}, {"ssm": {conv, state}}
    or both, over the meta tokens too — or None)."""
    check_supported(cfg)
    x, positions = _embed_inputs(params, cfg, batch)
    block = _BLOCKS[cfg.family][0]
    rot = (attn.rot_tables(cfg, positions)
           if cfg.has_attention else None)    # attention-free: no table
    caches = [] if collect_cache else None
    for pl in _layers(params["blocks"]):
        if remat:
            x, kv = checkpoint(block, x, pl, cfg, rot, use_reentrant=False,
                               context_fn=_recompute_contexts)
        else:
            x, kv = block(x, pl, cfg, rot)
        if collect_cache:
            caches.append(kv)
    x = rms_norm(x, params["final_norm"])
    if cfg.meta_tokens:
        x = x[:, cfg.meta_tokens:]
    if logits_last_only:
        x = x[:, -1:]
    return _lm_head(x, params, cfg), caches


def forward_train(params, cfg, batch, remat: bool = True):
    """The training forward: (fp32 logits (B,S,V), None), each block under
    remat unless ``remat`` is False (then :func:`forward`)."""
    return forward(params, cfg, batch, remat=remat)


def loss_fn(params, cfg, batch, remat: bool = True) -> torch.Tensor:
    """Mean next-token cross entropy over the labels >= 0 of
    ``batch["labels"]`` (B,S): fp32 logsumexp of the logits less the
    label's logit, summed over the mask and divided by max(its count, 1)."""
    logits, _ = forward_train(params, cfg, batch, remat=remat)
    labels = batch["labels"].long()
    mask = (labels >= 0).float()
    lse = torch.logsumexp(logits, dim=-1)
    tgt = logits.gather(-1, labels.clamp(min=0)[..., None])[..., 0]
    nll = (lse - tgt) * mask
    return nll.sum() / mask.sum().clamp(min=1.0)


def _ring(kv, cfg, seq_len_cache):
    """The attention cache of a prefill from its per-layer {k, v} (B,S,..):
    absolute position p in ring slot p % W. With W <= S the last W keys are
    rolled into place; with W > S (decode headroom past the prompt) the
    keys are padded and the empty slots marked -1."""
    k = torch.stack([c["k"] for c in kv])        # (L,B,S,Hkv,Dh)
    v = torch.stack([c["v"] for c in kv])
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
    return {"k": k.contiguous(), "v": v.contiguous(),
            "abs_pos": abs_pos.expand(nl, b, w).contiguous(),
            "pos": torch.full((nl, b), s_tot, dtype=torch.int32,
                              device=k.device)}


def prefill(params, cfg, batch, seq_len_cache: Optional[int] = None):
    """Forward over the prompt (and the meta tokens ahead of it), then the
    decode cache.

    Returns (last-token logits (B,V), the cache): {"attn": {k, v
    (L,B,W,Hkv,Dh), abs_pos (L,B,W), pos (L,B)}} for an attention model
    (:func:`_ring`; ``pos`` counts the meta tokens), {"ssm": {conv
    (L,B,K-1,C), state (L,B,H,N,P) fp32}} for an SSM, whatever
    ``seq_len_cache``, and both for a hybrid."""
    logits, caches = forward(params, cfg, batch, collect_cache=True,
                             logits_last_only=True)
    out = {}
    if cfg.has_attention:
        out["attn"] = _ring([c["attn"] for c in caches], cfg, seq_len_cache)
    if cfg.has_ssm:
        out["ssm"] = {k: torch.stack([c["ssm"][k] for c in caches])
                      for k in ("conv", "state")}
    return logits[:, -1], out


def decode_step(params, cfg, batch, cache):
    """One decode step. batch: {tokens (B,)} or {embeds (B, d)}
    (``embed_stub``). Returns (fp32 logits (B,V), cache) — the same cache
    dict, updated IN PLACE (each layer's new K/V slot, abs_pos and pos;
    each layer's conv window and SSM state). The new token sits at the
    cache's ``pos``, in all three streams under M-RoPE."""
    check_supported(cfg)
    if cfg.frontend == "embed_stub":
        x = batch["embeds"][:, None, :].to(dtype_of(cfg))
    else:
        x = params["embed"][batch["tokens"].long()][:, None, :]
    block = _BLOCKS[cfg.family][1]
    rot = None
    if cfg.has_attention:
        # every layer's pos is the same (prefill sets them together, each
        # step advances each by one): one table serves the whole stack
        pos = cache["attn"]["pos"][0]
        rot = attn.rot_tables(cfg, pos[:, None])
    for pl, lc in zip(_layers(params["blocks"]), _layers(cache)):
        x = block(x, pl, cfg, lc, rot)
    x = rms_norm(x, params["final_norm"])
    return _lm_head(x[:, 0], params, cfg), cache


def cache_shapes(cfg, batch: int, seq_len: int) -> Dict[str, Any]:
    """{"attn" / "ssm": {name: (shape, dtype)}} of :func:`init_cache`'s
    tensors, nothing allocated."""
    check_supported(cfg)
    out = {}
    if cfg.has_attention:
        out["attn"] = attn.decode_cache_shapes(cfg, batch, seq_len,
                                               dtype_of(cfg))
    if cfg.has_ssm:
        out["ssm"] = ssm.ssm_cache_shapes(cfg, batch, dtype_of(cfg))
    return out


def cache_logical(cfg) -> Dict[str, Any]:
    """The logical axes of the decode cache's leaves (the reference's)."""
    out = {}
    if cfg.has_attention:
        out["attn"] = attn.decode_cache_logical()
    if cfg.has_ssm:
        out["ssm"] = ssm.ssm_cache_logical()
    return out


def init_cache(cfg, batch: int, seq_len: int, device="cuda"):
    """An empty decode cache for ``batch`` rows of ``seq_len`` context (the
    SSM's cache has no context length)."""
    check_supported(cfg)
    out = {}
    if cfg.has_attention:
        out["attn"] = attn.init_decode_cache(cfg, batch, seq_len,
                                             dtype_of(cfg), device)
    if cfg.has_ssm:
        out["ssm"] = ssm.init_ssm_cache(cfg, batch, dtype_of(cfg), device)
    return out
