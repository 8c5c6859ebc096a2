"""The attention kernels' plain versions and wrappers against the reference.

On the CPU a wrapper takes its plain version, which must equal the
reference's oracles: ``kernels.ref.attention_ref`` for ``flash_attention``
and ``kernels.ref.decode_attention_ref`` for ``decode_attention`` — group
sizes 1, 4 and 8, windows 0 and 64, S and W that are not multiples of 64,
empty ring slots and a row with no live slot, fp32 and bf16 — and, on one
small case each, the Pallas kernels in interpret mode through
``repro.kernels.ops``. Tolerances (absolute, as the reference's own kernel
tests): 2e-5 in fp32 (summation order), 3e-2 in bf16 (one bf16 rounding of
the output). ``test_torch_cuda.py`` holds the CUDA kernels against these
plain versions on the card.
"""
import math

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")   # the reference needs jax
torch.set_num_threads(1)

from repro.kernels import ops as rops  # noqa: E402
from repro.kernels import ref as rref  # noqa: E402
from repro_torch.kernels import attention as katt  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

TOL = {"float32": 2e-5, "bfloat16": 3e-2}
B, HKV, D = 2, 2, 32


def _pair(a, dtype):
    """One numpy array -> (jax array, torch tensor) of ``dtype``."""
    return (jnp.asarray(a, dtype), torch.from_numpy(a).to(getattr(torch,
                                                                  dtype)))


def _err(j, t):
    return float(np.abs(np.asarray(j, np.float32)
                        - t.float().numpy()).max())


def _ring(rng, w, pos):
    """Ring slots as a decode cache holds them: slot s holds the latest
    absolute position p <= pos with p % w == s, -1 where none was written;
    row 0 has no live slot at all (-1 everywhere)."""
    slots = np.arange(w)[None, :]
    p = pos[:, None]
    ap = slots + w * ((p - slots) // w)
    ap = np.where(ap <= p, ap, -1)
    ap[0] = -1
    ap[1, rng.integers(0, w, 3)] = -1          # scattered empty slots
    return ap.astype(np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [0, 64])
@pytest.mark.parametrize("group", [1, 4, 8])
def test_flash_plain_matches_reference(group, window, dtype):
    rng = np.random.default_rng(group * 10 + window)
    s = 100                                   # not a multiple of 64
    q = rng.normal(0, 1, (B, HKV * group, s, D)).astype(np.float32)
    k = rng.normal(0, 1, (B, HKV, s, D)).astype(np.float32)
    v = rng.normal(0, 1, (B, HKV, s, D)).astype(np.float32)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (q, k, v))
    want = rref.attention_ref(jq, jk, jv, window=window)
    got = katt.flash_attention(tq, tk, tv, window)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    assert _err(want, got) < TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [0, 64])
@pytest.mark.parametrize("group", [1, 4, 8])
def test_decode_plain_matches_reference(group, window, dtype):
    rng = np.random.default_rng(100 + group * 10 + window)
    b, w = 3, 70                              # not a multiple of 64
    q = rng.normal(0, 1, (b, HKV * group, D)).astype(np.float32)
    k = rng.normal(0, 1, (b, HKV, w, D)).astype(np.float32)
    v = rng.normal(0, 1, (b, HKV, w, D)).astype(np.float32)
    pos = np.array([5, 150, 40], np.int32)    # row 1's ring has wrapped
    ap = _ring(rng, w, pos)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (q, k, v))
    want = rref.decode_attention_ref(jq, jk, jv, jnp.asarray(ap),
                                     jnp.asarray(pos), window=window)
    got = katt.decode_attention(tq, tk, tv, torch.from_numpy(ap),
                                torch.from_numpy(pos), window)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    assert _err(want, got) < TOL[dtype]
    # the row with no live slot averages every slot's value, as the
    # reference's all -1e30 softmax does
    np.testing.assert_allclose(got[0].float().numpy(),
                               np.repeat(tv[0].float().mean(1).numpy(),
                                         group, 0), atol=TOL[dtype])


@pytest.mark.parametrize("window", [0, 16])
def test_ops_flash_matches_pallas_interpret(window):
    """``ops.flash_attention`` (both sides) against the Pallas kernel in
    interpret mode (S divides its tiles) and the reference's plain side."""
    rng = np.random.default_rng(7)
    q = rng.normal(0, 1, (1, 4, 64, 16)).astype(np.float32)
    k = rng.normal(0, 1, (1, 2, 64, 16)).astype(np.float32)
    v = rng.normal(0, 1, (1, 2, 64, 16)).astype(np.float32)
    want = rops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), window=window)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    for use_kernel in (True, False):
        got = tops.flash_attention(tq, tk, tv, window=window,
                                   use_kernel=use_kernel)
        assert _err(want, got) < TOL["float32"]


@pytest.mark.parametrize("window", [0, 16])
def test_ops_decode_matches_pallas_interpret(window):
    rng = np.random.default_rng(8)
    b, w = 2, 64
    q = rng.normal(0, 1, (b, 4, 16)).astype(np.float32)
    k = rng.normal(0, 1, (b, 2, w, 16)).astype(np.float32)
    v = rng.normal(0, 1, (b, 2, w, 16)).astype(np.float32)
    pos = np.array([20, 90], np.int32)
    ap = _ring(rng, w, pos)
    ap[0, :21] = np.arange(21)               # row 0 live, its tail empty
    want = rops.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), jnp.asarray(ap),
                                 jnp.asarray(pos), window=window)
    args = [torch.from_numpy(a) for a in (q, k, v, ap, pos)]
    for use_kernel in (True, False):
        got = tops.decode_attention(*args, window=window,
                                    use_kernel=use_kernel)
        assert _err(want, got) < TOL["float32"]


def test_cpu_tensors_never_launch():
    """A CPU tensor takes the plain version: no launch is counted."""
    n0 = (katt.flash_attention.launches, katt.decode_attention.launches)
    q = torch.zeros(1, 2, 3, 16)
    katt.flash_attention(q, q[:, :1], q[:, :1])
    katt.decode_attention(q[:, :, 0], q[:, :1], q[:, :1],
                          torch.zeros(1, 3, dtype=torch.int32),
                          torch.zeros(1, dtype=torch.int32))
    assert (katt.flash_attention.launches,
            katt.decode_attention.launches) == n0


def test_wrappers_reject_devices_they_cannot_run_on():
    q = torch.zeros(1, 2, 3, 16, device="meta")
    with pytest.raises(ValueError, match="device"):
        katt.flash_attention(q, q[:, :1], q[:, :1])
    with pytest.raises(ValueError, match="different devices"):
        katt.flash_attention(torch.zeros(1, 2, 3, 16), q[:, :1], q[:, :1])


# ------------------------------------------------ what the kernels are given
# With ``_route`` patched to True and ``_launch`` to a recorder, CPU tensors
# go down the CUDA path as far as the launch: the entry point, the launch
# plan and the strides each kernel is handed, and what the wrappers refuse.
@pytest.fixture
def launches(monkeypatch):
    calls = []
    monkeypatch.setattr(katt, "_route", lambda *t: True)
    monkeypatch.setattr(katt, "_launch",
                        lambda name, device, *args: calls.append((name,
                                                                  args)))
    return calls


@pytest.mark.parametrize("dtype,entry", [
    (torch.bfloat16, "glin_flash_attention_bf16"),
    (torch.float32, "glin_flash_attention_fp32")])
@pytest.mark.parametrize("group", [1, 4, 48, 64])
def test_flash_entry_point_and_plan_by_dtype(launches, dtype, entry, group):
    """bf16 reaches the tensor-core entry point, fp32 the CUDA-core one,
    with the tokens per block that fill 64 rows with the group's heads and
    the (batch, head, position) strides of the model's transposed views."""
    b, s, hkv, d = 2, 77, 2, 64
    q = torch.zeros(b, s, hkv * group, d, dtype=dtype).transpose(1, 2)
    k = torch.zeros(b, s, hkv, d, dtype=dtype).transpose(1, 2)
    n0 = katt.flash_attention.launches
    out = katt.flash_attention(q, k, k, 16)
    assert katt.flash_attention.launches == n0 + 1
    assert out.transpose(1, 2).is_contiguous()
    (name, args), = launches
    bq = 64 // group
    assert name == entry
    assert args[4:12] == (b, hkv * group, hkv, s, d, 16, 1 / 8, bq)
    assert args[12:] == (*q.stride()[:3], *k.stride()[:3],
                         *out.stride()[:3])
    plan = katt.flash_plan(b, hkv, group, s, d, dtype)
    assert plan == {"entry": entry, "kernel": (
                        "flash_wgmma_kernel" if dtype == torch.bfloat16
                        else "flash_fp32_kernel"),
                    "tokens_per_block": bq, "blocks": -(-s // bq) * hkv * b,
                    "threads": 128 if dtype == torch.bfloat16 else 256}
    assert katt.flash_plan(b, hkv, group, s, 128, dtype)["kernel"] == (
        "flash_mma_kernel" if dtype == torch.bfloat16
        else "flash_fp32_kernel")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,hkv,group,w,d", [
    (8, 8, 4, 1024, 64), (1, 2, 4, 1, 64), (4, 4, 5, 129, 32),
    (64, 8, 4, 1024, 64), (2, 1, 64, 40, 256)])
def test_decode_arguments_for_the_models_cache_views(launches, dtype, b, hkv,
                                                     group, w, d):
    """The model hands in (B, W, Hkv, D) cache leaves transposed: the kernel
    gets their (batch, head, slot) strides, W, the dtype flag and the split
    of :func:`decode_plan`."""
    q = torch.zeros(b, 1, hkv * group, d, dtype=dtype)[:, 0]
    cache = torch.zeros(3, b, w, hkv, d, dtype=dtype)     # stacked layers
    k, v = cache[1].transpose(1, 2), cache[2].transpose(1, 2)
    ap = torch.full((3, b, w), -1, dtype=torch.int32)[1]
    pos = torch.zeros(3, b, dtype=torch.int32)[1]
    n0 = katt.decode_attention.launches
    out = katt.decode_attention(q, k, v, ap, pos, 7)
    assert katt.decode_attention.launches == n0 + 1
    assert out.shape == (b, hkv * group, d) and out.is_contiguous()
    (name, args), = launches
    plan = katt.decode_plan(b, hkv)
    assert name == "glin_decode_attention"
    assert args[8:17] == (b, hkv * group, hkv, w, d, 7, 1 / math.sqrt(d),
                          int(dtype == torch.bfloat16), plan["split"])
    assert args[17:] == (q.stride(0), q.stride(1), w * hkv * d, d, hkv * d,
                         w, None)           # no log-sum-exp asked for
    assert plan["blocks"] == plan["split"] * hkv * b
    # the blocks' partials (acc, m, l per head, a live flag per block) and
    # the per-(row, kv head) counters, which start at zero
    part, done = args[6], args[7]
    assert part.dtype == torch.float32 and part.numel() == (
        b * hkv * plan["split"] * (group * (d + 2) + 1))
    assert done.dtype == torch.int32 and done.numel() >= b * hkv
    assert not done.any()


def test_launch_plans_fill_the_card_at_the_serving_shapes():
    """granite_3_2b at 8 slots (8 kv heads, group 4, 512-token prompts):
    both kernels launch at least 132 blocks, the decode with each row's
    slots split over 4 blocks; a batch that fills the card alone is not
    split."""
    flash = katt.flash_plan(1, 8, 4, 512, 64, torch.bfloat16)
    assert flash["tokens_per_block"] == 16 and flash["blocks"] == 256
    decode = katt.decode_plan(8, 8)
    assert decode == {"split": 4, "blocks": 256, "threads": 128}
    assert katt.decode_plan(1, 1)["split"] == katt.DECODE_MAX_SPLIT
    assert katt.decode_plan(64, 8)["split"] == 1
    assert katt.flash_plan(1, 1, 48, 512, 128, torch.bfloat16)[
        "tokens_per_block"] == 1


@pytest.mark.parametrize("case", ["head_dim", "group", "kv_strides",
                                  "unaligned", "dtype", "last_dim"])
def test_flash_wrapper_refuses_what_the_kernels_do_not_take(launches, case):
    q = torch.zeros(1, 4, 9, 64, dtype=torch.bfloat16)
    k = v = torch.zeros(1, 2, 9, 64, dtype=torch.bfloat16)
    if case == "head_dim":
        q, k, v = q[..., :48], k[..., :48], v[..., :48]
    elif case == "group":
        q = torch.zeros(1, 130, 9, 64, dtype=torch.bfloat16)
    elif case == "kv_strides":
        v = torch.zeros(1, 9, 2, 64, dtype=torch.bfloat16).transpose(1, 2)
    elif case == "unaligned":
        q = torch.zeros(1, 4, 9, 68, dtype=torch.bfloat16)[..., 4:]
    elif case == "dtype":
        q = q.half()
    else:
        q = torch.zeros(1, 4, 9, 128, dtype=torch.bfloat16)[..., ::2]
    with pytest.raises((TypeError, ValueError)):
        katt.flash_attention(q, k, v)
    assert launches == []


@pytest.mark.parametrize("case", ["head_dim", "group", "abs_pos_dtype",
                                  "pos_shape", "kv_dtype", "unaligned"])
def test_decode_wrapper_refuses_what_the_kernel_does_not_take(launches,
                                                              case):
    q = torch.zeros(2, 4, 64)
    k = v = torch.zeros(2, 2, 10, 64)
    ap = torch.zeros(2, 10, dtype=torch.int32)
    pos = torch.zeros(2, dtype=torch.int32)
    if case == "head_dim":
        q, k, v = q[..., :40], k[..., :40], v[..., :40]
    elif case == "group":
        q = torch.zeros(2, 130, 64)
    elif case == "abs_pos_dtype":
        ap = ap.long()
    elif case == "pos_shape":
        pos = pos[:1]
    elif case == "kv_dtype":
        k = v = k.bfloat16()
    else:
        q = torch.zeros(2, 4, 66)[..., 2:]
    with pytest.raises((TypeError, ValueError)):
        katt.decode_attention(q, k, v, ap, pos)
    assert launches == []
