"""PyTorch port, the flash sweep's slice on the CPU: the single-pass
forward's plain version against the JAX sweep's Pallas kernel
(``_fwd_single_kernel``, interpret mode, with ``fwd_single``'s block specs),
the wrapper's per-type shape limits, the SDPA yardstick's fused-only
helper, the sweep's decision helper and the flash route's auto mode.

The CUDA kernel itself runs only on the card: ``chip_smoke.py`` holds it
against this plain version there. Tolerances are stated per test."""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from fbk_fairseq_st_tpu.scripts import bench_flash_sweep as jsweep
from fbk_fairseq_st_tpu_torch.ops import attention as tattn
from fbk_fairseq_st_tpu_torch.ops.kernels import flash_attention as tflash
from fbk_fairseq_st_tpu_torch.ops.kernels import flash_fwd_single as single
from fbk_fairseq_st_tpu_torch.scripts import bench_flash_sweep as tsweep


def _jax_fwd_single(q, k, v, bias, causal, scale, t_block):
    """The JAX sweep's kernel through pl.pallas_call in interpret mode,
    with the grid and block specs of ``fwd_single`` (:67-87)."""
    bh, t, d = q.shape
    s = k.shape[1]
    return pl.pallas_call(
        functools.partial(jsweep._fwd_single_kernel, causal=causal, scale=scale),
        grid=(bh, t // t_block),
        in_specs=[
            pl.BlockSpec((1, t_block, d), lambda b, i: (b, i, 0)),
            pl.BlockSpec((1, s, d), lambda b, i: (b, 0, 0)),
            pl.BlockSpec((1, s, d), lambda b, i: (b, 0, 0)),
            pl.BlockSpec((1, 1, s), lambda b, i: (b, 0, 0)),
        ],
        out_specs=[
            pl.BlockSpec((1, t_block, d), lambda b, i: (b, i, 0)),
            pl.BlockSpec((1, 1, t_block), lambda b, i: (b, 0, i)),
        ],
        out_shape=[
            jax.ShapeDtypeStruct((bh, t, d), q.dtype),
            jax.ShapeDtypeStruct((bh, 1, t), jnp.float32),
        ],
        interpret=True,
    )(q, k, v, bias[:, None, :])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
def test_single_pass_reference_matches_the_jax_kernel(causal, dtype):
    """bh 2, T = S = 256, t_block 128, the last 7 keys of row 1 padded:
    out at atol 1e-5 in fp32 and 2e-2 in bf16 (one bf16 rounding of
    |out| < 4, P rounded alike on both sides), lse at atol 1e-5."""
    rng = np.random.RandomState(0)
    q, k, v = (rng.randn(2, 256, 64).astype(np.float32) for _ in range(3))
    bias = np.zeros((2, 256), np.float32)
    bias[1, -7:] = -1e9
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    scale = 64 ** -0.5
    jout, jlse = _jax_fwd_single(*(jnp.asarray(x).astype(jdt) for x in (q, k, v)), jnp.asarray(bias),
                                 causal, scale, 128)
    tout, tlse = single.flash_fwd_single(*(torch.tensor(x).to(tdt) for x in (q, k, v)), torch.tensor(bias),
                                         scale, causal=causal, t_block=16)
    assert tout.dtype == tdt and tlse.dtype == torch.float32
    atol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(tout.float().numpy(), np.asarray(jout.astype(jnp.float32)), rtol=0, atol=atol)
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse)[:, 0], rtol=0, atol=1e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_single_pass_reference_matches_the_flash_reference(causal):
    """In fp32 the single pass computes the flash forward's function:
    out and lse at atol 1e-5 against ``flash_attention_reference`` on a
    ragged shape (T 37, S 53, D 20, padded keys)."""
    rng = np.random.RandomState(1)
    q = torch.tensor(rng.randn(3, 37, 20).astype(np.float32))
    k, v = (torch.tensor(rng.randn(3, 53, 20).astype(np.float32)) for _ in range(2))
    bias = torch.zeros(3, 53)
    bias[2, 40:] = -1e9
    out, lse = single.flash_fwd_single(q, k, v, bias, 0.4, causal=causal)
    want_out, want_lse = tflash.flash_attention_reference(q, k, v, bias, 0.4, causal)
    torch.testing.assert_close(out, want_out, rtol=0, atol=1e-5)
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
def test_shared_memory_limit(dtype):
    """Both kernels take D 64 only. fp32: a block holds t_block x S fp32
    scores, the q tile and one 64-key chunk (rows padded to D + 1), so its
    tiles (t_block 8 and 16) fit S = 2048, t_block 16 up to S = 3307 and
    t_block 8 up to S = 6679. bf16: a block holds the q tile and a 3-slot
    ring of 64-key K and V chunks whatever S is, so its tiles (64 and 128)
    take any S. ``check_shape`` refuses the rest, needing no card."""
    assert single.HEAD_DIM == 64
    if dtype == torch.float32:
        assert single.T_BLOCKS[dtype] == (8, 16)
        assert single.smem_bytes(16, 2048, dtype) == 4 * (16 * 2048 + 16 * 65 + 64 * 65)
        assert all(single.smem_bytes(tb, 2048, dtype) <= single.SMEM_LIMIT for tb in single.T_BLOCKS[dtype])
        assert single.smem_bytes(16, 3307, dtype) == single.SMEM_LIMIT < single.smem_bytes(16, 3308, dtype)
        assert single.smem_bytes(8, 6679, dtype) <= single.SMEM_LIMIT < single.smem_bytes(8, 6680, dtype)
        single.check_shape(dtype, 64, 3307, 16)
        single.check_shape(dtype, 64, 6679, 8)
        refused = [(64, 3308, 16), (64, 6680, 8), (32, 256, 8), (64, 256, 64)]
    else:
        assert single.T_BLOCKS[dtype] == (64, 128)
        assert single.smem_bytes(64, 2048, dtype) == 2 * 64 * (64 + 3 * 2 * 64) == 57344
        assert single.smem_bytes(128, 1 << 20, dtype) == single.smem_bytes(128, 2048, dtype) == 65536
        for s in (1, 333, 3308, 8192, 1 << 20):
            for tb in single.T_BLOCKS[dtype]:
                single.check_shape(dtype, 64, s, tb)
        refused = [(32, 2048, 64), (128, 2048, 128), (64, 2048, 8), (64, 2048, 16), (64, 2048, 256)]
    for d, s, tb in refused:
        with pytest.raises(ValueError):
            single.check_shape(dtype, d, s, tb)
    # bh is the grid's x dimension and takes any size; the q tiles, its y,
    # at most 65,535
    tb = single.T_BLOCKS[dtype][0]
    single.check_shape(dtype, 64, 256, tb, t=65535 * tb)
    with pytest.raises(ValueError):
        single.check_shape(dtype, 64, 256, tb, t=65535 * tb + 1)


@pytest.mark.parametrize("padded", [False, True], ids=["unpadded", "padded"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_library_attention_runs_a_fused_backend(causal, padded):
    """The SDPA yardstick on the kernels' (BH, T, D) layouts under the CPU
    build's fused backend alone (flash) equals ``flash_attention_reference``
    at atol 1e-5 (fp32, the same function summed in another order): no
    mask, ``is_causal``, the (1, BH, 1, S) key bias, or the materialised
    causal + padded mask. Ragged T 37, S 53."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    rng = np.random.RandomState(2)
    q = torch.tensor(rng.randn(3, 37, 16).astype(np.float32))
    k, v = (torch.tensor(rng.randn(3, 53, 16).astype(np.float32)) for _ in range(2))
    bias = torch.zeros(3, 53)
    if padded:
        bias[1, 45:] = -1e9
        bias[2, 30:] = -1e9
    mask = tsweep.library_mask(bias, 37, causal, q.dtype)
    assert (mask is None) == (not padded)
    if padded:
        assert tuple(mask.shape) == ((1, 3, 37, 53) if causal else (1, 3, 1, 53))
    with sdpa_kernel([SDPBackend.FLASH_ATTENTION]):
        got = tsweep.library_attention(q, k, v, mask, 0.4, causal, "flash")
    want, _ = tflash.flash_attention_reference(q, k, v, bias, 0.4, causal)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


def test_library_attention_never_takes_the_math_path():
    """The 3-D call the yardstick used to make (q/k/v (BH, T, D), a
    (BH, T, S) mask) has no fused backend and raises under the fused-only
    context, as does ``library_attention`` with a backend that refuses
    the shape (the CPU build has no memory-efficient backend)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from torch.nn.functional import scaled_dot_product_attention

    q, k, v = (torch.randn(2, 8, 16, generator=torch.Generator().manual_seed(i)) for i in range(3))
    mask = torch.zeros(2, 8, 8)
    with sdpa_kernel([SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION, SDPBackend.CUDNN_ATTENTION]):
        with pytest.raises(RuntimeError):
            scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=0.25)
    with pytest.raises(RuntimeError):
        tsweep.library_attention(q, k, v, None, 0.25, False, "efficient")


def test_sweep_needs_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        tsweep.run()


def test_gate_from_rows():
    """Per caller, the gate length is the largest measured key length up
    to which the dense route's device time beats flash by more than 10 %
    at every length; whether the tensor-core pair wins comes from the
    device times of the ``bwd_route`` rows (``pair_wins``), and the S =
    2048 backwards are reported by device time, not wall time."""
    def route(kind, s, ratio):
        return {"kind": f"route_{kind}", "S": s, "dense_over_flash": ratio}

    bwd = [{"kind": "flash_bwd_fused", "S": 2048, "causal": False, "bwd_ms": 3.0, "bwd_device_ms": 2.9},
           {"kind": "flash_bwd_split", "S": 2048, "causal": False, "bwd_ms": 5.0, "bwd_device_ms": 1.1},
           {"kind": "bwd_route", "shape": "short", "S": 128, "fused_device_ms": 0.2, "pair_device_ms": 0.3},
           {"kind": "bwd_route", "shape": "long", "S": 2048, "fused_device_ms": 3.0, "pair_device_ms": 1.0}]
    rows = [route("mha", 128, 0.8), route("time_attention", 128, 0.85), route("mha", 512, 0.95),
            route("time_attention", 512, 0.8), route("mha", 2048, 0.5), route("time_attention", 2048, 1.3)]
    got = tsweep.gate_from(rows + bwd)
    assert got["dense_faster_by_10pct_up_to_key_len"] == {"mha": 128, "time_attention": 512}
    assert got["pair_wins_by_call"] == {"short": False, "long": True}
    assert not got["pair_wins_everywhere"]
    assert got["bwd_device_ms_at_2048_non_causal"] == {"flash_bwd_fused": 2.9, "flash_bwd_split": 1.1}
    rows[0]["dense_over_flash"] = 1.05
    assert tsweep.gate_from(rows + bwd)["dense_faster_by_10pct_up_to_key_len"]["mha"] is None


def test_auto_mode_sends_every_cuda_call_to_flash():
    """No key-length gate on the card (the sweep found none worth 10 %):
    auto mode sends a CUDA call to flash, a CPU call to the dense route;
    set_flash_attention forces either route."""
    cuda, cpu = types.SimpleNamespace(is_cuda=True), types.SimpleNamespace(is_cuda=False)
    assert tattn.flash_enabled(cuda) and not tattn.flash_enabled(cpu)
    try:
        tattn.set_flash_attention(True)
        assert tattn.flash_enabled(cpu)
        tattn.set_flash_attention(False)
        assert not tattn.flash_enabled(cuda)
    finally:
        tattn.set_flash_attention(None)


@pytest.mark.parametrize("head_dim", [16, 64, 128, 129, 256, 512])
def test_head_dims_above_128_take_the_dense_route(head_dim):
    """``flash_eligible`` is a pure function of the call: on a CUDA device
    head dims up to 128 take flash, above it the dense route (as JAX's
    non-TPU branch at any head dim), whatever ``set_flash_attention``
    forces; a cache, an additive mask, a penalty or need_weights take the
    dense route anywhere; the CPU takes flash only when forced."""
    fits = head_dim <= 128
    assert tattn.flash_eligible("cuda", head_dim) == fits
    assert tattn.flash_eligible("cuda", head_dim, "causal") == fits
    assert tattn.flash_eligible("cuda", head_dim, forced=True) == fits
    assert not tattn.flash_eligible("cpu", head_dim)
    assert tattn.flash_eligible("cpu", head_dim, forced=True) == fits
    assert not tattn.flash_eligible("cuda", head_dim, forced=False)
    for kwargs in (dict(mask="additive"), dict(cache=True), dict(penalty=True), dict(need_weights=True)):
        assert not tattn.flash_eligible("cuda", head_dim, **kwargs)
