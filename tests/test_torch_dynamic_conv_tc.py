"""PyTorch port, the tensor-core dynamic convolution's tile plan on the CPU.

``csrc/dynamic_conv_tc.cu`` runs only on the card. Its index arithmetic is
mirrored in plain torch by ``ops/kernels/dynamic_conv.py``: the grid
(``tile_plan``, ``block_coords``), each block's window (``window_base``),
the band's index maps (``band_index``: tap k = j - i in the forward,
k = s - t + padding_l in dx) and the dw diagonals (``dw_diagonals``).
``emulate_forward`` / ``emulate_backward`` run that plan with a matrix
product on each warp's tile, and are held here against the JAX package's
``conv_kernels._xla_reference`` and ``jax.vjp`` of ``dynamic_conv_pallas``
(Pallas in interpret mode where its C % 128 / T gate takes it, else its
XLA route): out and dx at atol 1e-5, dw at 1e-5 of max|dw| (fp32 sums of K,
or C/H, products in another order). The same tiles with every product in
3xTF32 (the fp32 kernels' products, emulated as in
``tests/test_torch_tf32x3.py``) stay within ``chip_smoke.py``'s fp32
limits (1e-4; dw 1e-5 of max|dw|), where one TF32 product a product misses
the dw limit. Inputs come from numpy seeds.

The test marked ``cuda`` runs the kernels against the emulation when a
card is present (``python -m pytest --noconftest -m cuda
tests/test_torch_dynamic_conv_tc.py``); JAX is imported inside the tests
that use it, so the module imports on a machine without it."""

import numpy as np
import pytest
import torch

from fbk_fairseq_st_tpu_torch.ops.kernels import dynamic_conv as tdc
from fbk_fairseq_st_tpu_torch.ops.kernels.build import SMEM_LIMIT

# name: (B, T, C, H, K, padding_l); r = C / H in {3, 8, 16, 64, 128}; r 3
# takes the kernels' element-by-element copies (C and r not 16-byte multiples)
CASES = {
    "k5_t45_r3": (2, 45, 6, 2, 5, 2),
    "k1_t1_r8": (2, 1, 16, 2, 1, 0),
    "k3_causal_t37_r8": (2, 37, 24, 3, 3, 2),
    "k4_even_t37_r16": (2, 37, 48, 3, 4, 1),
    "k7_pad0_t56_r64": (2, 56, 128, 2, 7, 0),
    "k15_centred_t200_r16": (1, 200, 64, 4, 15, 7),
    "k31_centred_t56_r64": (2, 56, 128, 2, 31, 15),
    "k31_causal_t56_r128": (1, 56, 256, 2, 31, 30),
    "k3_centred_t200_r128": (1, 200, 128, 1, 3, 1),
}
ATOL = 1e-5
LIMIT_FP32 = 1e-4  # chip_smoke.py's ATOL_KERNEL / ATOL_GRAD in fp32
RTOL_DW_FP32 = 1e-5  # chip_smoke.py's RTOL_DW in fp32


def _inputs(case, seed):
    b, t, c, h, k, pad_l = CASES[case]
    rng = np.random.RandomState(seed)
    x = rng.randn(b, t, c).astype(np.float32)
    logits = rng.randn(b, t, h, k).astype(np.float32)
    w = (np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)).astype(np.float32)
    g = rng.randn(b, t, c).astype(np.float32)
    return x, w, g, pad_l


def _jax():
    import jax
    import jax.numpy as jnp

    from fbk_fairseq_st_tpu.ops.pallas import conv_kernels

    return jax, jnp, conv_kernels


def _jax_vjp(x, w, g, pad_l):
    jax, jnp, jck = _jax()
    _, vjp = jax.vjp(lambda a, b: jck.dynamic_conv_pallas(a, b, pad_l), jnp.asarray(x), jnp.asarray(w))
    return [np.asarray(v) for v in vjp(jnp.asarray(g))]


@pytest.mark.parametrize("jax_fn", ["xla_reference", "dynamic_conv_pallas"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_tiled_forward_matches_jax(case, jax_fn):
    """The forward as the kernel tiles it (each warp's band tile times its
    window rows) against JAX: atol 1e-5."""
    _, jnp, jck = _jax()
    x, w, _, pad_l = _inputs(case, 0)
    fn = jck._xla_reference if jax_fn == "xla_reference" else jck.dynamic_conv_pallas
    want = np.asarray(fn(jnp.asarray(x), jnp.asarray(w), pad_l))
    got = tdc.emulate_forward(torch.tensor(x), torch.tensor(w), pad_l)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_tiled_backward_matches_jax_vjp(case):
    """dx (the transposed band over g's window) at atol 1e-5 and dw (the
    K diagonals of each warp's G . Xwin^T, summed over channel chunks) at
    1e-5 of max|dw|, against jax.vjp of dynamic_conv_pallas."""
    x, w, g, pad_l = _inputs(case, 1)
    want_dx, want_dw = _jax_vjp(x, w, g, pad_l)
    dx, dw = tdc.emulate_backward(torch.tensor(x), torch.tensor(w), torch.tensor(g), pad_l)
    np.testing.assert_allclose(dx.numpy(), want_dx, rtol=0, atol=ATOL, err_msg="dx")
    np.testing.assert_allclose(dw.numpy(), want_dw, rtol=0, atol=ATOL * np.abs(want_dw).max(), err_msg="dw")


def _tf32x3_matmul(passes):
    from .test_torch_tf32x3 import product

    return lambda a, b: product("...ij,...jk->...ik", a, b, passes)


@pytest.mark.parametrize("case", sorted(CASES))
def test_tf32x3_tiles_within_the_fp32_limits(case):
    """Every tile product in 3xTF32, as the fp32 kernels compute it: out
    and dx within 1e-4 and dw within 1e-5 of max|dw| of JAX; with one TF32
    product instead, dw misses its limit wherever a sum has 64 or more
    channels (the limit binds at the model's widths)."""
    _, jnp, jck = _jax()
    x, w, g, pad_l = _inputs(case, 2)
    want = np.asarray(jck._xla_reference(jnp.asarray(x), jnp.asarray(w), pad_l))
    want_dx, want_dw = _jax_vjp(x, w, g, pad_l)
    tx, tw, tg = torch.tensor(x), torch.tensor(w), torch.tensor(g)
    mm3 = _tf32x3_matmul(3)
    np.testing.assert_allclose(tdc.emulate_forward(tx, tw, pad_l, matmul=mm3).numpy(), want, rtol=0,
                               atol=LIMIT_FP32)
    dx, dw = tdc.emulate_backward(tx, tw, tg, pad_l, matmul=mm3)
    dw_limit = RTOL_DW_FP32 * np.abs(want_dw).max()
    np.testing.assert_allclose(dx.numpy(), want_dx, rtol=0, atol=LIMIT_FP32, err_msg="dx")
    np.testing.assert_allclose(dw.numpy(), want_dw, rtol=0, atol=dw_limit, err_msg="dw")
    b, t, c, h, k, _ = CASES[case]
    if c // h >= 64:
        _, dw1 = tdc.emulate_backward(tx, tw, tg, pad_l, matmul=_tf32x3_matmul(1))
        assert np.abs(dw1.numpy() - want_dw).max() > dw_limit


@pytest.mark.parametrize("case", sorted(CASES))
def test_plan_covers_every_output_once(case):
    """The backward's grid writes each element of dx and of dw exactly
    once (its band half is the forward's grid)."""
    b, t, c, h, k, _ = CASES[case]
    dx, dw = tdc.plan_coverage(b, t, c, h, k)
    assert int(dx.min()) == int(dx.max()) == 1
    assert int(dw.min()) == int(dw.max()) == 1


@pytest.mark.parametrize("case", sorted(CASES))
def test_band_index_is_the_tap(case):
    """Within each warp's band, the forward's tap is j - i and dx's is
    s - t + padding_l, for output position s = s0 + i and the position
    t = window_base + j whose tap reads s; off the band, -1."""
    b, t, c, h, k, pad_l = CASES[case]
    plan = tdc.tile_plan(b, t, c, h, k)
    i = torch.arange(tdc.WARP_ROWS)[:, None]
    j = torch.arange(tdc.WARP_ROWS * plan.ksteps)[None, :]
    _, fwd = tdc.band_index("fwd", k, plan.ksteps)
    row, dx = tdc.band_index("dx", k, plan.ksteps)
    on = (j - i >= 0) & (j - i < k)
    assert torch.equal(fwd, torch.where(on, j - i, -1))
    for s0 in range(0, t, tdc.TILE):
        s = s0 + i
        tpos = tdc.window_base("dx", s0, k, pad_l) + j
        assert torch.equal(dx, torch.where(on, s - tpos + pad_l, -1))
        assert torch.equal(row, j.expand_as(row))


def test_dw_diagonals_keep_the_band():
    """Row i of a warp's product keeps taps 0..K - 1 from columns i..i + K
    - 1, where the band's tap map says they are."""
    k, ksteps = 7, 2
    p = torch.arange(16 * 16 * ksteps, dtype=torch.float32).reshape(16, 16 * ksteps)
    got = tdc.dw_diagonals(p, k)
    _, tap = tdc.band_index("fwd", k, ksteps)
    for i in range(16):
        for kk in range(k):
            assert got[i, kk] == p[i, int((tap[i] == kk).nonzero()[0, 0])]


def test_grid_takes_any_batch():
    """B above 65,535: the grid is B H n_tiles blocks on gridDim.x, dx then
    dw, so the last block is the last (batch row, head, tile)'s dw (only
    the plan runs: no tensor of that size); the wrapper has no batch cap.
    A K whose block needs more shared memory than a block can have is
    refused by the plan's size."""
    b = 70_000
    fwd = tdc.tile_plan(b, 56, 1024, 16, 31)
    bwd = tdc.tile_plan(b, 56, 1024, 16, 31, backward=True)
    assert (fwd.blocks, bwd.blocks) == (b * 16, 2 * b * 16)
    assert tdc.block_coords(bwd, bwd.blocks - 1) == ("dw", b - 1, 15, 0)
    assert tdc.block_coords(bwd, fwd.blocks - 1) == ("band", b - 1, 15, 0)
    assert tdc.block_coords(bwd, fwd.blocks) == ("dw", 0, 0, 0)
    assert tdc.block_coords(tdc.tile_plan(3, 200, 64, 4, 15), 5) == ("band", 0, 1, 64)
    with pytest.raises(IndexError):
        tdc.block_coords(bwd, bwd.blocks)
    for dtype in (torch.float32, torch.bfloat16):
        assert tdc.tile_plan(64, 56, 1024, 16, 31, dtype, backward=True).smem <= SMEM_LIMIT
        assert tdc.tile_plan(64, 56, 1024, 16, 600, dtype, backward=True).smem > SMEM_LIMIT
    x, w = torch.zeros(b, 1, 4), torch.zeros(b, 1, 2, 3)  # the CPU route takes the batch too
    assert tdc.dynamic_conv(x, w, 1).shape == (b, 1, 4)


def test_routes_and_counters_on_the_cpu():
    """A CPU tensor runs the plain versions and launches nothing; the
    direct-call entry and an unknown route refuse it."""
    x, w, _, pad_l = _inputs("k4_even_t37_r16", 3)
    tdc.reset_launches()
    out = tdc.dynamic_conv(torch.tensor(x), torch.tensor(w), pad_l)
    assert torch.equal(out, tdc.dynamic_conv_reference(torch.tensor(x), torch.tensor(w), pad_l))
    assert (tdc.launches_fwd, tdc.launches_bwd, tdc.launches_fwd_tc, tdc.launches_bwd_tc) == (0, 0, 0, 0)
    with pytest.raises(ValueError):
        tdc.dynamic_conv_forward(torch.tensor(x), torch.tensor(w), pad_l)
    with pytest.raises(ValueError):
        tdc.dynamic_conv_backward(torch.tensor(x), torch.tensor(w), torch.tensor(x), pad_l, route="band")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernels_match_the_tiled_plan_on_the_card(case, dtype):
    """On the card: dynamic_conv_fwd_tc and dynamic_conv_bwd_tc (one
    launch each) against the emulated plan in fp32, within chip_smoke.py's
    limits (fp32 1e-4, dw 1e-5 of max|dw|; bf16 out 2e-2, dx 5e-2, dw 1e-2
    of max|dw|), the backward bitwise equal across two launches, and w at
    an odd element offset (staged element by element) giving the same
    bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    dt = getattr(torch, dtype)
    *arrays, pad_l = _inputs(case, 4)
    x, w, g = (torch.tensor(v).to(dt) for v in arrays)
    want = tdc.emulate_forward(x.float(), w.float(), pad_l)
    want_dx, want_dw = tdc.emulate_backward(x.float(), w.float(), g.float(), pad_l)
    tdc.reset_launches()
    xc, wc, gc = x.cuda(), w.cuda(), g.cuda()
    out = tdc.dynamic_conv_forward(xc, wc, pad_l)
    dx, dw = tdc.dynamic_conv_backward(xc, wc, gc, pad_l)
    dx2, dw2 = tdc.dynamic_conv_backward(xc, wc, gc, pad_l)
    torch.cuda.synchronize()
    assert (tdc.launches_fwd_tc, tdc.launches_bwd_tc, tdc.launches_fwd, tdc.launches_bwd) == (1, 2, 0, 0)
    assert torch.equal(dx, dx2) and torch.equal(dw, dw2)
    limits = {"float32": (1e-4, 1e-4, 1e-5), "bfloat16": (2e-2, 5e-2, 1e-2)}[dtype]
    assert (out.float().cpu() - want).abs().max().item() <= limits[0]
    assert (dx.float().cpu() - want_dx).abs().max().item() <= limits[1]
    assert (dw.float().cpu() - want_dw).abs().max().item() <= limits[2] * want_dw.abs().max().item()
    w_odd = torch.empty(wc.numel() + 1, dtype=dt, device="cuda")[1:].view_as(wc)
    w_odd.copy_(wc)
    assert torch.equal(tdc.dynamic_conv_forward(xc, w_odd, pad_l), out)
    dx3, dw3 = tdc.dynamic_conv_backward(xc, w_odd, gc, pad_l)
    assert torch.equal(dx3, dx) and torch.equal(dw3, dw)
