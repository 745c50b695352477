"""PyTorch port, the flash sweep's slice on the CPU: the single-pass
forward's plain version against the JAX sweep's Pallas kernel
(``_fwd_single_kernel``, interpret mode, with ``fwd_single``'s block specs),
the wrapper's shared-memory limit, the sweep's decision helper and the
flash route's auto mode.

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


def test_shared_memory_limit():
    """A block holds t_block x S fp32 scores, the q tile and one 64-key
    chunk (rows padded to D + 1): the kernel's two tiles (D 64, t_block 8
    and 16) fit S = 2048, t_block 16 up to S = 3307 and t_block 8 up to
    S = 6679; the wrapper refuses anything past that on the card."""
    assert single.HEAD_DIM == 64 and single.T_BLOCKS == (8, 16)
    assert single.smem_bytes(16, 2048) == 4 * (16 * 2048 + 16 * 65 + 64 * 65)
    assert all(single.smem_bytes(tb, 2048) <= single.SMEM_LIMIT for tb in single.T_BLOCKS)
    assert single.smem_bytes(16, 3307) == single.SMEM_LIMIT < single.smem_bytes(16, 3308)
    assert single.smem_bytes(8, 6679) <= single.SMEM_LIMIT < single.smem_bytes(8, 6680)


def test_sweep_needs_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        tsweep.run()


def test_gate_from_rows():
    """Per caller, the gate length is the largest measured key length up
    to which the dense route's device time beats flash by more than 10 %
    at every length; the backward choice is the faster one at S = 2048."""
    def route(kind, s, ratio):
        return {"kind": f"route_{kind}", "S": s, "dense_over_flash": ratio}

    bwd = [{"kind": "flash_bwd_fused", "S": 2048, "causal": False, "bwd_ms": 3.0},
           {"kind": "flash_bwd_split", "S": 2048, "causal": False, "bwd_ms": 5.0}]
    rows = [route("mha", 128, 0.8), route("time_attention", 128, 0.85), route("mha", 512, 0.95),
            route("time_attention", 512, 0.8), route("mha", 2048, 0.5), route("time_attention", 2048, 1.3)]
    got = tsweep.gate_from(rows + bwd)
    assert got["dense_faster_by_10pct_up_to_key_len"] == {"mha": 128, "time_attention": 512}
    assert got["fused_bwd_faster_at_2048"]
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
