"""The production meshes (``launch.mesh.make_production_mesh``: (16, 16)
``("data", "model")`` and (2, 16, 16) ``("pod", "data", "model")``) and the
cells the sharded steps take on them:

* every arch x shape cell's builders on both meshes, with and without
  sequence sharding, laid out on ``["cpu"] * 256`` / ``* 512`` (nothing
  allocated): no refusal, every query head on one position, and each MoE
  cell's capacity split as its layout needs;
* reduced configs with the production meshes' non-dividing counts, run
  against one device: qwen2_vl_2b's 12 query heads (2 kv heads) over 16
  ``model`` positions, where four positions hold no head, on a (1, 16)
  mesh; qwen3_moe_235b with 6 experts on a (2, 2, 2) ``("pod", "data",
  "model")`` mesh, the experts over ``data`` and the capacity slots over
  ``pod`` (6 divides ``data``'s 2 but not the batch axes' 4);
* a decode step with a batch of 1 (long_500k's), whole over ``data``.

Tolerances (``tests/test_torch_sharded_train.py``'s): loss, grad_norm and
lr within 1e-5 relative; the updated parameters within 2 lr everywhere and
1e-6 on all but 0.1% of the elements; logits and cache leaves within 1e-5
of the largest (integer leaves exactly); the MoE FFN's output within 1e-5
of its largest, its drops exactly.
"""
import dataclasses

import numpy as np
import pytest
import torch

from _sharded import close_rel, cpu_mesh, leaf_close, params_close
from repro_torch.configs import ARCH_IDS, SHAPES, ShapeConfig, get_arch
from repro_torch.configs.base import cell_supported
from repro_torch.core.distributed import make_mesh
from repro_torch.kernels import attention as katt
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import moe
from repro_torch.models import parallel as par
from repro_torch.models import parallel_moe as pmoe
from repro_torch.models import transformer as tf
from repro_torch.sharding import MeshRules, gather, place, place_tree
from repro_torch.sharding.rules import logical_to_spec
from repro_torch.train import optimizer as topt
from repro_torch.train import step as tstep
from repro_torch.utils.tree import leaves, paths

BUILD = {"train": tstep.build_train_step,
         "prefill": tstep.build_prefill_step,
         "decode": tstep.build_decode_step}
SEQ, PROMPT, SLOTS, STEPS = 64, 40, 48, 3


# ------------------------------------------------------------- the meshes
@pytest.mark.parametrize("multi_pod,shape,axes", [
    (False, (16, 16), ("data", "model")),
    (True, (2, 16, 16), ("pod", "data", "model"))])
def test_production_mesh_shapes(multi_pod, shape, axes):
    n = int(np.prod(shape))
    mesh = make_production_mesh(multi_pod=multi_pod, devices=["cpu"] * n)
    assert mesh.axis_names == axes and mesh.sizes == shape
    assert len(mesh.flat) == n and mesh.merge_device.type == "cpu"


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_needs_its_cards(multi_pod):
    """Without ``devices`` it takes the first 256 (512) cards and raises
    where there are fewer; nothing falls back to the CPU."""
    with pytest.raises(RuntimeError, match="CUDA cards"):
        make_production_mesh(multi_pod=multi_pod)


# ------------------------------------------------ every cell's builders
def _moe_caps(cfg, shape: ShapeConfig):
    """The capacity of each dispatch chunk of a cell: a train step's
    microbatch (the builder's default 8), a prefill's batch or a decode
    step's tokens, chunked along the sequence as ``moe_ffn`` does."""
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        b //= 8
    elif shape.kind == "decode":
        s = 1
    chunk = pmoe.chunk_len(b, s)
    return {moe.capacity(b * chunk, cfg.top_k, cfg.n_experts)}


@pytest.mark.parametrize("seq", [False, True], ids=["no_seq", "seq"])
@pytest.mark.parametrize("multi_pod", [False, True],
                         ids=["16x16", "2x16x16"])
def test_builders_take_every_production_cell(multi_pod, seq):
    mesh = make_production_mesh(multi_pod=multi_pod,
                                devices=["cpu"] * (512 if multi_pod else 256))
    rules = MeshRules(mesh, seq_sharding=seq)
    plan = par.Plan.of(rules)
    caps = {}
    cells = 0
    for arch in ARCH_IDS:
        cfg = get_arch(arch)
        for shape in SHAPES.values():
            if not cell_supported(cfg, shape)[0]:
                continue
            BUILD[shape.kind](cfg, shape, rules)
            cells += 1
            if cfg.has_attention:
                q_cols, _, cfgs, kv_ids = par._heads(cfg, plan)
                heads = [h for a, b in q_cols for h in range(a, b)]
                assert heads == list(range(cfg.n_heads * cfg.head_dim))
                empty = sum(not c.n_heads for c in cfgs)
                assert empty == max(0, plan.m - cfg.n_heads)
                assert all(len(k) == c.n_kv_heads
                           for k, c in zip(kv_ids, cfgs))
            if cfg.is_moe:
                spec = logical_to_spec(rules, moe.moe_logical(cfg)["wu"], (
                    cfg.n_layers, cfg.n_experts, cfg.d_model, cfg.d_ff))
                ex = spec.axes(1)
                cx, ne, nc, _ = pmoe._blocks(mesh, plan.dp, ex)
                assert cfg.n_experts % ne == 0
                for cap in _moe_caps(cfg, shape):
                    assert cap % nc == 0, (arch, shape.name, cap, cx)
                    caps.setdefault(arch, set()).add(cap)
    assert cells == 33     # 40, less long_500k on 7 full-attention models
    # the dispatch chunks' capacities: 65,536-token chunks and decode steps
    assert caps == {"mixtral_8x22b": {20480, 128},
                    "qwen3_moe_235b": {5120, 128}}
    if multi_pod:       # qwen3's 128 experts over data, its slots over pod
        assert pmoe._blocks(mesh, plan.dp, ("data",))[:3] == (("pod",), 16,
                                                              2)


# ------------------------------------ reduced cells with the same counts
def _qwen2_vl_12():
    return dataclasses.replace(get_arch("qwen2_vl_2b").reduced(),
                               n_heads=12, n_kv_heads=2)


def _qwen3_pod():
    return dataclasses.replace(get_arch("qwen3_moe_235b").reduced(),
                               n_experts=6)


CASES = {"qwen2_vl_12_heads_over_16": (_qwen2_vl_12, (1, 16),
                                       ("data", "model"), 2),
         "qwen3_experts_over_data_of_a_pod": (_qwen3_pod, (2, 2, 2),
                                              ("pod", "data", "model"), 8)}


def _case(name):
    make, shape, axes, batch = CASES[name]
    mesh = make_mesh(shape, axes, ["cpu"] * int(np.prod(shape)))
    return make(), mesh, batch


def _inputs(cfg, b, s, seed=0, labels=True):
    g = torch.Generator().manual_seed(seed)
    if cfg.frontend == "embed_stub":
        out = {"embeds": torch.randn(b, s, cfg.d_model, generator=g)}
        if cfg.mrope:
            out["positions"] = torch.randint(0, s, (b, 3, s), generator=g,
                                             dtype=torch.int32)
    else:
        out = {"tokens": torch.randint(0, cfg.vocab, (b, s), generator=g,
                                       dtype=torch.int32)}
    if labels:
        out["labels"] = torch.randint(0, cfg.vocab, (b, s), generator=g,
                                      dtype=torch.int32)
    return out


def _steps(cfg, b, seed=1):
    """STEPS decode inputs: a token or an embedding a row."""
    g = torch.Generator().manual_seed(seed)
    if cfg.frontend == "embed_stub":
        return [{"embeds": torch.randn(b, cfg.d_model, generator=g)}
                for _ in range(STEPS)]
    return [{"tokens": torch.randint(0, cfg.vocab, (b,), generator=g,
                                     dtype=torch.int32)}
            for _ in range(STEPS)]


@pytest.mark.parametrize("seq", [False, True], ids=["no_seq", "seq"])
@pytest.mark.parametrize("name", list(CASES))
def test_reduced_cell_trains_as_one_device(name, seq):
    cfg, mesh, b = _case(name)
    rules = MeshRules(mesh, seq_sharding=seq)
    params = tf.init_params(cfg, 0, device="cpu")
    batch = _inputs(cfg, b, SEQ)
    step, in_sh, _, _ = tstep.build_train_step(
        cfg, ShapeConfig("t", SEQ, b, "train"), rules, microbatches=1)
    pd = place_tree(params, in_sh[0])
    new, _, m = step(pd, tstep.sharded_adamw_init(pd),
                     place_tree(batch, in_sh[2]))
    p0, _, m0 = tstep.train_step(params, topt.adamw_init(params), batch,
                                 cfg)
    for k in ("loss", "grad_norm", "lr"):
        close_rel(float(gather(m[k])), float(m0[k]))
    params_close([gather(v).numpy() for v in leaves(new)],
                 [v.numpy() for v in leaves(p0)], float(m0["lr"]))


def _serve(cfg, mesh, b, seq, params):
    """The sharded prefill of a PROMPT-row prompt into SLOTS slots and
    STEPS decode steps, and the same on one device: (logits per step,
    final caches) of each."""
    rules = MeshRules(mesh, seq_sharding=seq)
    pf, pin, _, _ = tstep.build_prefill_step(
        cfg, ShapeConfig("p", SLOTS, b, "prefill"), rules)
    df, din, _, _ = tstep.build_decode_step(
        cfg, ShapeConfig("d", SLOTS, b, "decode"), rules)
    prompt = _inputs(cfg, b, PROMPT, labels=False)
    pd = place_tree(params, pin[0])
    lg, cache = pf(pd, place_tree(prompt, pin[1]))
    l0, c0 = tf.prefill(params, cfg, prompt, seq_len_cache=SLOTS)
    got, want = [gather(lg).numpy()], [l0.numpy()]
    for st in _steps(cfg, b):
        lg, cache = df(pd, cache, place_tree(st, din[2]))
        l0, c0 = tf.decode_step(params, cfg, st, c0)
        got.append(gather(lg).numpy())
        want.append(l0.numpy())
    return (got, {k: gather(v).numpy() for k, v in paths(cache)}), (
        want, {k: v.numpy() for k, v in paths(c0)})


def _same(got, want):
    (lg, cache), (lw, cw) = got, want
    for a, b in zip(lg, lw):
        leaf_close(a, b)
    assert cache.keys() == cw.keys()
    for k in cache:
        if np.issubdtype(cw[k].dtype, np.integer):
            np.testing.assert_array_equal(cache[k], cw[k])
        else:
            leaf_close(cache[k], cw[k])


@pytest.mark.parametrize("seq", [False, True], ids=["no_seq", "seq"])
@pytest.mark.parametrize("name", list(CASES))
def test_reduced_cell_serves_as_one_device(name, seq):
    cfg, mesh, b = _case(name)
    params = tf.init_params(cfg, 0, device="cpu")
    _same(*_serve(cfg, mesh, b, seq, params))


def test_positions_without_a_head_launch_nothing(monkeypatch):
    """12 query heads over 16 positions: 12 positions run the attention
    kernel on one head each, the other four launch nothing; in decode
    every position runs B8 on its slot range for all 12 heads."""
    cfg, mesh, b = _case("qwen2_vl_12_heads_over_16")
    prefills, decodes = [], []
    real_f, real_d = katt.flash_attention, katt.decode_attention

    def flash(q, *a, **k):
        prefills.append(tuple(q.shape))
        return real_f(q, *a, **k)

    def dec(q, *a, **k):
        decodes.append(tuple(q.shape))
        return real_d(q, *a, **k)
    monkeypatch.setattr(katt, "flash_attention", flash)
    monkeypatch.setattr(katt, "decode_attention", dec)
    params = tf.init_params(cfg, 0, device="cpu")
    (got, _), _ = _serve(cfg, mesh, b, False, params)
    # the sharded prefill, then one device's (12 heads a layer)
    one = (b, 12, PROMPT, cfg.head_dim)
    assert prefills == [(b, 1, PROMPT, cfg.head_dim)] * (12 * cfg.n_layers) \
        + [one] * cfg.n_layers
    assert decodes[:16 * cfg.n_layers] == [(b, 12, cfg.head_dim)] * (
        16 * cfg.n_layers)


def test_pod_experts_route_with_a_global_capacity():
    """6 experts over ``data`` (2), the capacity slots over ``pod`` (2),
    the router favouring expert 0 so that the global capacity drops
    replicas: the FFN equals one device's, drop for drop, and each
    position receives its (expert block, slot block)."""
    cfg, mesh, _ = _case("qwen3_experts_over_data_of_a_pod")
    cfg = dataclasses.replace(cfg, n_layers=1)
    rules = MeshRules(mesh)
    plan = par.Plan.of(rules)
    assert pmoe.expert_parallel(cfg, rules)
    assert pmoe._blocks(mesh, plan.dp, ("data",)) == (("pod",), 2, 2,
                                                      [0, 2, 1, 3])
    p = {k: v[0] for k, v in tf.init_params(cfg, 1, device="cpu")[
        "blocks"]["moe"].items()}
    p["router"][0, 0] += 5.0
    g = torch.Generator().manual_seed(1)
    x = torch.randn(8, 128, cfg.d_model, generator=g)
    x[..., 0] += 3.0
    lg = {k: v[1:] for k, v in moe.moe_logical(cfg).items()}
    pd = {k: place(v, mesh, logical_to_spec(rules, lg[k], tuple(v.shape)))
          for k, v in p.items()}
    assert tuple(pd["wu"].spec) == ("data", "pod", "model")
    xd = place(x, mesh, logical_to_spec(rules, ("batch", None, None),
                                        tuple(x.shape)))
    moe.stats.reset()
    y = pmoe.moe_ffn(xd, pd, cfg, plan)
    sharded = moe.stats.read()
    moe.stats.reset()
    y0 = moe.moe_ffn(x, p, cfg)
    one = moe.stats.read()
    assert sharded["dropped"] == one["dropped"] > 0
    leaf_close(gather(y).numpy(), y0.numpy())


@pytest.mark.parametrize("seq", [False, True], ids=["no_seq", "seq"])
def test_decode_batch_of_one(seq):
    """long_500k's batch of 1 lies whole over ``data``: the prefill and
    decode steps on the (4, 2) mesh equal one device's."""
    cfg = get_arch("granite_3_2b").reduced()
    params = tf.init_params(cfg, 3, device="cpu")
    _same(*_serve(cfg, cpu_mesh(), 1, seq, params))
