"""PyTorch port, the 3xTF32 design of the fp32 tensor-core flash kernels
(``csrc/flash_fwd_tf32x3.cu``, ``csrc/flash_bwd_tf32x3.cu``) on the CPU.

The kernels themselves run only on the card. Here their arithmetic is
emulated in PyTorch: tf32 is fp32 rounded to nearest at 10 mantissa bits,
ties away from zero, as ``cvt.rna.tf32.f32``; each operand x is split into
big = tf32(x) and small = tf32(x - big), and a product is
a_small.b_big + a_big.b_small + a_big.b_big with fp32 sums (the products of
two tf32 values are exact in fp32). The attention forward and the backward
formulas, with every product done so, are held against JAX's ``_fwd_impl``
and ``_bwd_fused_impl`` in interpret mode in fp32 (rate 0: JAX's keep bits
are the TPU's) within ``chip_smoke.py``'s fp32 limits (out, lse and every
gradient 1e-4), and the same formulas with one tf32 product each must miss
those limits at the same inputs: the limit binds, and the three products
are what meets it. T' 128-class shapes, where the gap is clearest: ragged T
and S, causal with T > S, padded keys, head dims 64 and 32, and 128 (the
iwslt presets' heads, which the fp32 pair takes with fp32 rows of 512
bytes: the emulation does not see the layout, only the products)."""

import functools
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fbk_fairseq_st_tpu.ops.pallas import attention_kernel as jkern

_spec = importlib.util.spec_from_file_location("chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

# the limits the card holds the fp32 kernels to
LIMITS = {"out": chip_smoke.ATOL_KERNEL[torch.float32], "lse": chip_smoke.ATOL_LSE,
          "dq": chip_smoke.ATOL_GRAD[torch.float32], "dk": chip_smoke.ATOL_GRAD[torch.float32],
          "dv": chip_smoke.ATOL_GRAD[torch.float32]}

# name: (bh, T, S, D, causal, padded keys)
CASES = {
    "encoder_t128": (4, 128, 128, 64, False, True),
    "ragged_t77_s111": (3, 77, 111, 64, False, True),
    "causal_t130_s77_d32": (2, 130, 77, 32, True, False),
    "causal_padded_t100": (4, 100, 100, 64, True, True),
    "cross_t48_s128": (2, 48, 128, 64, False, True),
    "iwslt_t56_d128": (4, 56, 56, 128, False, True),
    "causal_t130_s77_d128": (2, 130, 77, 128, True, False),
}


def tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to tf32 as cvt.rna.tf32.f32: add half a unit of the
    10th mantissa bit to the magnitude's bits, then drop the low 13."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def product(eq: str, a: torch.Tensor, b: torch.Tensor, passes: int) -> torch.Tensor:
    """einsum ``eq`` of fp32 a and b as the tensor cores compute it: one
    tf32 product (passes 1) or three (passes 3, the small ones first)."""
    a_big, b_big = tf32(a), tf32(b)
    if passes == 1:
        return torch.einsum(eq, a_big, b_big)
    a_small, b_small = tf32(a - a_big), tf32(b - b_big)
    return torch.einsum(eq, a_small, b_big) + torch.einsum(eq, a_big, b_small) + torch.einsum(eq, a_big, b_big)


def scores(q, k, bias, scale, causal, passes):
    s = product("btd,bsd->bts", q, k, passes) * scale + bias[:, None, :]
    if causal:
        t, n = q.shape[1], k.shape[1]
        s = torch.where(torch.arange(n)[None, :] <= torch.arange(t)[:, None], s, -1e9)
    return s


def forward(q, k, v, bias, scale, causal, passes):
    """The kernel's forward at rate 0 with every product emulated: out and
    the natural-log lse."""
    s = scores(q, k, bias, scale, causal, passes)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    return product("bts,bsd->btd", p, v, passes) / l, (m + torch.log(l))[..., 0]


def backward(q, k, v, bias, out, lse, g, scale, causal, passes):
    """The pair's formulas at rate 0 (``csrc/flash_bwd_tf32x3.cu``) with
    every product emulated: (dq, dk, dv)."""
    w = torch.exp(scores(q, k, bias, scale, causal, passes) - lse[..., None])
    ds = w * (product("btd,bsd->bts", g, v, passes) - (g * out).sum(-1)[..., None])
    return (product("bts,bsd->btd", ds, k, passes) * scale, product("bts,btd->bsd", ds, q, passes) * scale,
            product("bts,btd->bsd", w, g, passes))


@functools.lru_cache(maxsize=None)
def case_data(case: str):
    """The inputs from numpy, and JAX's out, lse, dq, dk, dv on them (its
    kernels in interpret mode, fp32, on the inputs it pads to x128)."""
    bh, t, s, d, causal, padded = CASES[case]
    rng = np.random.RandomState(sum(map(ord, case)))
    q, g = (rng.randn(bh, t, d).astype(np.float32) for _ in range(2))
    k, v = (rng.randn(bh, s, d).astype(np.float32) for _ in range(2))
    bias = np.zeros((bh, s), np.float32)
    if padded:
        lengths = rng.randint(s // 2, s + 1, size=bh)
        lengths[0] = s
        bias[np.arange(s)[None, :] >= lengths[:, None]] = -1e9
    scale = d ** -0.5
    tp, sp = jkern._pad_to(t), jkern._pad_to(s)
    pad = lambda x, n: jnp.asarray(np.pad(x, ((0, 0), (0, n - x.shape[1]), (0, 0))))  # noqa: E731
    bp = jnp.asarray(np.pad(bias, ((0, 0), (0, sp - s)), constant_values=-1e9))
    blocks = dict(causal=causal, scale=scale, rate=0.0, t_block=128, s_block=128, interpret=True)
    seed = jnp.zeros((1,), jnp.int32)
    qp, kp, vp, gp = pad(q, tp), pad(k, sp), pad(v, sp), pad(g, tp)
    out, lse = jkern._fwd_impl(qp, kp, vp, bp, seed, **blocks)
    dq, dk, dv = jkern._bwd_fused_impl(qp, kp, vp, bp, seed, out, lse, gp, **blocks)
    want = {"out": np.asarray(out)[:, :t], "lse": np.asarray(lse)[:, 0, :t], "dq": np.asarray(dq)[:, :t],
            "dk": np.asarray(dk)[:, :s], "dv": np.asarray(dv)[:, :s]}
    return tuple(map(torch.tensor, (q, k, v, bias, g))), scale, causal, want


def errors(case: str, passes: int):
    """max |emulated - JAX| of out, lse, dq, dk, dv; the backward on JAX's
    out and lse, as the kernels run on the forward's."""
    (q, k, v, bias, g), scale, causal, want = case_data(case)
    out, lse = forward(q, k, v, bias, scale, causal, passes)
    grads = backward(q, k, v, bias, torch.tensor(want["out"]), torch.tensor(want["lse"]), g, scale, causal, passes)
    got = {"out": out, "lse": lse, "dq": grads[0], "dk": grads[1], "dv": grads[2]}
    return {name: float(np.abs(got[name].numpy() - want[name]).max()) for name in LIMITS}


def test_tf32_rounds_to_nearest_ties_away():
    """The emulated cvt.rna: 10 mantissa bits kept, the rest rounded to
    nearest with ties away from zero, the same on both signs; a tf32 value
    is its own rounding; the split's parts sum back to x within 2^-22 |x|."""
    ulp = 2.0 ** -10
    x = torch.tensor([1.0, 1 + ulp / 4, 1 + ulp / 2, 1 + 3 * ulp / 4, 3.0, -(1 + ulp / 2), 1 + ulp])
    want = torch.tensor([1.0, 1.0, 1 + ulp, 1 + ulp, 3.0, -(1 + ulp), 1 + ulp])
    assert torch.equal(tf32(x), want)
    assert torch.equal(tf32(tf32(x)), tf32(x))
    y = torch.tensor(np.random.RandomState(0).randn(10000).astype(np.float32))
    big = tf32(y)
    assert float(((big - y).abs() / y.abs()).max()) <= 2.0 ** -11
    assert float(((big + tf32(y - big) - y).abs() / y.abs()).max()) <= 2.0 ** -22


@pytest.mark.parametrize("case", sorted(CASES))
def test_three_tf32_products_meet_the_fp32_limits(case):
    """3xTF32 everywhere: out, lse, dq, dk and dv within the card's fp32
    limits (1e-4) of JAX's fp32 kernels (the emulation on a CPU is within
    0.5-3.5e-6)."""
    got = errors(case, passes=3)
    assert all(got[name] <= LIMITS[name] for name in LIMITS), got


@pytest.mark.parametrize("case", sorted(CASES))
def test_one_tf32_product_misses_the_fp32_limits(case):
    """One tf32 product everywhere: out and every gradient miss the same
    limits (the emulation on a CPU misses by 2.3e-4 to 2.7e-3), so the
    limit binds and a 1xTF32 kernel could not pass it."""
    got = errors(case, passes=1)
    assert all(got[name] > LIMITS[name] for name in ("out", "dq", "dk", "dv")), got
