"""Serving launchers of the port.

``python -m repro_torch.launch.serve lm ...`` — the continuous-batching LM
demo: ``--slots`` concurrent sequences in a fixed decode batch, each
arriving request prefilled on its own and its cache (a dense model's KV
ring, an SSM's conv window and state) spliced into a free slot
(per-sequence positions keep the slots independent); finished sequences
free their slot; reports the first prefill's time and tokens/s. ``--arch``
picks a dense config (through the ``flash_attention`` and
``decode_attention`` kernels), a MoE one (``mixtral_8x22b``,
``qwen3_moe_235b``: the same kernels, the MoE FFN in torch),
``mamba2_2p7b`` (through ``ssd_scan``) or the hybrid ``hymba_1p5b`` (all
three; its cache holds both the KV ring and the SSM state, its prompts
follow its meta tokens). The server takes tokens only, as the
reference's: an ``embed_stub`` architecture (``qwen2_vl_2b``,
``musicgen_medium``) is refused. It
runs on the card (``--device cuda``, the default), or on the CPU with
``--device cpu`` (the kernels' plain versions).

``python -m repro_torch.launch.serve [spatial] ...`` — the default: drive
the GLIN spatial serving tier (``repro_torch.serve.SpatialQueryServer``,
with async double-buffered republish) with a short open-loop demo load
(Poisson arrivals over ``intersects``, ``contains`` and ``dwithin:0.003``,
a write fraction of small 8-vertex rings) and print ``server.stats()`` as
JSON: queue depth, shed count, per-tenant admitted/rejected/served, the
batch-size histogram, per-replica query counts, coalesced duplicates and
the facade's per-stage telemetry (``engine_stages``). ``--explain`` first
prints the compiled execution plan of each relation. It runs on the card
(``--device cuda``, the default) or on the CPU with ``--device cpu`` (the
kernels' plain versions). Its other flags and defaults are the reference
launcher's.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import List

import numpy as np
import torch

from ..configs.base import get_arch
from ..models import transformer as tf

__all__ = ["SlotServer", "main"]


def _check_tokens_in(cfg) -> None:
    if cfg.frontend != "text":
        raise ValueError(f"{cfg.name}: its {cfg.frontend} frontend takes "
                         "embeddings, and the slot server takes tokens only "
                         "(drive models.transformer.prefill / decode_step "
                         "with {'embeds': ...})")


class SlotServer:
    """Fixed-slot continuous batching around prefill / decode_step, over
    token models (a text frontend)."""

    def __init__(self, cfg, params, slots: int, max_ctx: int,
                 device="cuda"):
        _check_tokens_in(cfg)
        self.cfg = cfg
        self.params = params
        self.slots = slots
        self.max_ctx = max_ctx
        self.device = torch.device(device)
        self.cache = tf.init_cache(cfg, slots, max_ctx, self.device)
        self.active = [False] * slots
        self.remaining = [0] * slots
        self.generated: List[List[int]] = [[] for _ in range(slots)]

    def admit(self, slot: int, prompt: np.ndarray, gen_len: int) -> None:
        """Prefill a request at batch 1 and splice every cache leaf (k, v,
        abs_pos, pos; conv, state; or both) into ``slot`` along axis 1."""
        tokens = torch.as_tensor(np.asarray(prompt)[None, :],
                                 device=self.device)
        _, cache1 = tf.prefill(self.params, self.cfg, {"tokens": tokens},
                               seq_len_cache=self.max_ctx)

        def splice(dst, src):
            for name, t in dst.items():
                if isinstance(t, dict):
                    splice(t, src[name])
                else:
                    t[:, slot] = src[name][:, 0]

        splice(self.cache, cache1)
        self.active[slot] = True
        self.remaining[slot] = gen_len
        self.generated[slot] = []

    def step(self, tokens: np.ndarray) -> np.ndarray:
        """One decode step of every slot; the greedy next tokens (the first
        maximal index, as ``jnp.argmax``)."""
        logits, self.cache = tf.decode_step(
            self.params, self.cfg,
            {"tokens": torch.as_tensor(np.asarray(tokens),
                                       device=self.device)}, self.cache)
        return logits.argmax(dim=-1).cpu().numpy()


# --------------------------------------------------------------- spatial mode
def main_spatial(args) -> int:
    from ..core.datasets import generate, make_query_windows
    from ..core.engine import EngineConfig, SpatialIndex, resolve_device
    from ..core.index import GLINConfig
    from ..serve import Rejected, ServerConfig, SpatialQueryServer

    device = resolve_device(args.device)     # no card: refuse, up front
    rng = np.random.default_rng(args.seed)
    gs = generate(args.dataset, args.n, seed=args.seed)
    index = SpatialIndex.build(
        gs, GLINConfig(piece_limitation=10_000),
        EngineConfig(device_min_batch=1, stale_rebuild_min_batch=1),
        device=device)
    cfg = ServerConfig(replicas=args.replicas, max_queue=args.max_queue,
                       min_batch=args.min_batch, max_batch=args.max_batch,
                       overlap_groups=not args.no_overlap,
                       max_workers=args.workers)
    server = SpatialQueryServer(index, async_republish=True, config=cfg)

    relations = ["intersects", "contains", "dwithin:0.003"]
    pool = make_query_windows(gs, 1e-4, 256, seed=args.seed + 1)
    if args.explain:
        for rel in relations:
            print(index.explain(pool[:cfg.min_batch], rel), flush=True)
    tenants = [f"tenant{i}" for i in range(max(args.tenants, 1))]
    print(f"[serve] {args.dataset} n={args.n}: {args.qps:.0f} qps offered "
          f"for {args.seconds:.0f}s over {len(tenants)} tenant(s), "
          f"replicas={cfg.replicas} workers={cfg.workers()} on "
          f"{index.device}", flush=True)
    server.start()
    tickets: List[int] = []
    t_end = time.perf_counter() + args.seconds
    next_arrival = time.perf_counter()
    served = 0
    try:
        while time.perf_counter() < t_end:
            now = time.perf_counter()
            while next_arrival <= now:
                w = pool[rng.integers(len(pool))]
                rel = relations[rng.integers(len(relations))]
                tickets.append(server.submit(
                    w, rel, tenant=tenants[rng.integers(len(tenants))]))
                if rng.random() < args.write_frac:
                    c = rng.uniform(0.15, 0.85, 2)
                    ang = np.sort(rng.uniform(0, 2 * np.pi, 8))
                    v = np.stack([c[0] + 2e-4 * np.cos(ang),
                                  c[1] + 2e-4 * np.sin(ang)], -1)
                    server.insert(v, 8, 0)
                next_arrival += rng.exponential(1.0 / args.qps)
            # collect what has resolved so far (non-blocking cadence)
            while tickets:
                try:
                    out = server.result(tickets[0], timeout=0.0)
                except TimeoutError:
                    break
                served += 0 if isinstance(out, Rejected) else 1
                tickets.pop(0)
            time.sleep(min(0.001, max(0.0, next_arrival - time.perf_counter())))
        for t in tickets:
            out = server.result(t, timeout=30.0)
            served += 0 if isinstance(out, Rejected) else 1
    finally:
        server.stop()
    st = server.stats()
    st["collected"] = served
    st["device"] = str(index.device)
    print(json.dumps(st, indent=2), flush=True)
    return 0


# -------------------------------------------------------------------- lm mode
def main_lm(args) -> int:
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    _check_tokens_in(cfg)
    device = torch.device(args.device)
    rng = np.random.default_rng(args.seed)
    params = tf.init_params(cfg, args.seed, device=device)
    server = SlotServer(cfg, params, args.slots, args.max_ctx, device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    queue = [(rng.integers(0, cfg.vocab, args.prompt_len).astype(np.int32),
              int(rng.integers(8, args.max_ctx - args.prompt_len)))
             for _ in range(args.requests)]
    done = 0
    cur_tokens = np.zeros(args.slots, np.int32)
    t0 = time.time()
    decoded = 0
    prefills = 0
    while done < args.requests:
        # admit queued requests into free slots
        for s in range(args.slots):
            if not server.active[s] and queue:
                prompt, gen = queue.pop(0)
                ta = time.time()
                server.admit(s, prompt, gen)
                prefills += 1
                cur_tokens[s] = prompt[-1]
                if prefills == 1:
                    sync()
                    print(f"[serve] first prefill {time.time()-ta:.2f}s",
                          flush=True)
        if not any(server.active):
            break
        nxt = server.step(cur_tokens)
        for s in range(args.slots):
            if server.active[s]:
                server.generated[s].append(int(nxt[s]))
                cur_tokens[s] = nxt[s]
                server.remaining[s] -= 1
                decoded += 1
                if server.remaining[s] <= 0:
                    server.active[s] = False
                    done += 1
    sync()
    dt = time.time() - t0
    print(f"[serve] {done} requests, {decoded} tokens in {dt:.1f}s "
          f"({decoded/max(dt,1e-9):.1f} tok/s, {prefills} prefills) "
          f"on {device}", flush=True)
    return 0


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] not in ("spatial", "lm"):
        argv = ["spatial"] + argv          # spatial serving is the default
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="mode", required=True)

    sp = sub.add_parser("spatial", help="GLIN spatial serving tier demo")
    sp.add_argument("--dataset", default="cluster")
    sp.add_argument("--n", type=int, default=50_000)
    sp.add_argument("--qps", type=float, default=200.0)
    sp.add_argument("--seconds", type=float, default=5.0)
    sp.add_argument("--write-frac", type=float, default=0.02)
    sp.add_argument("--tenants", type=int, default=2)
    sp.add_argument("--replicas", type=int, default=2)
    sp.add_argument("--max-queue", type=int, default=2048)
    sp.add_argument("--min-batch", type=int, default=8)
    sp.add_argument("--max-batch", type=int, default=4096)
    sp.add_argument("--workers", type=int, default=None)
    sp.add_argument("--no-overlap", action="store_true")
    sp.add_argument("--explain", action="store_true",
                    help="print the compiled execution plan per relation")
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")

    lm = sub.add_parser("lm", help="continuous-batching LM demo")
    lm.add_argument("--arch", default="granite_3_2b")
    # as the reference's: store_true with default True, so always reduced
    lm.add_argument("--reduced", action="store_true", default=True)
    lm.add_argument("--slots", type=int, default=4)
    lm.add_argument("--requests", type=int, default=12)
    lm.add_argument("--prompt-len", type=int, default=32)
    lm.add_argument("--max-ctx", type=int, default=128)
    lm.add_argument("--seed", type=int, default=0)
    lm.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")

    args = ap.parse_args(argv)
    return main_spatial(args) if args.mode == "spatial" else main_lm(args)


if __name__ == "__main__":
    raise SystemExit(main())
