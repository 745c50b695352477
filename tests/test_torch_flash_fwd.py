"""PyTorch port, the flash forward's routing on the CPU: which kernel a
CUDA call would take (``fwd_route``), each route's shape limits
(``fwd_check_shape``: every kernel, bf16 and fp32, takes any bh and at
most 65,535 q tiles), the route's rule on device times
(``tc_fwd_wins``, which the flash sweep's ``gate_from`` also reads, in
each type), and the CPU route, which runs the plain forward and launches
nothing.

The kernels themselves run only on the card: ``chip_smoke.py`` holds them
against ``flash_attention_reference`` there, and the test marked ``cuda``
does here when a card is present (``python -m pytest --noconftest -m cuda
tests/test_torch_flash_fwd.py`` on a machine with one). Tolerances are
stated per test."""

import numpy as np
import pytest
import torch

from fbk_fairseq_st_tpu_torch.ops.kernels import flash_attention as tflash
from fbk_fairseq_st_tpu_torch.scripts import bench_flash_sweep as tsweep

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.mark.parametrize("d", tflash.KERNEL_HEAD_DIMS)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_fwd_route(dtype, d):
    """The tensor cores take both types at kernel head dims 32 and 64
    (every model's heads and the time attention's padded F' = 20), as the
    split backward: bf16 as "tc", fp32 as "tf32x3" (three tf32 products a
    product); at 128 (the iwslt presets' heads) both forwards too
    (``csrc/flash_fwd_tc.cu``, ``csrc/flash_fwd_tf32x3.cu``) and both
    pairs; 16 stays on the CUDA cores."""
    tc = {"bfloat16": "tc", "float32": "tf32x3"}[dtype]
    want = tc if d != 16 else "cuda_core"
    assert tflash.fwd_route(DTYPES[dtype], d) == want
    assert tflash.split_route(DTYPES[dtype], d) == (tc if d != 16 else "cuda_core")


@pytest.mark.parametrize("d", [32, 64, 128])
def test_tensor_core_forward_shapes(d):
    """bh is the grid's x dimension and takes any batch; the 64-row q tiles
    are its y dimension, at most 65,535; S is a loop and sets no limit."""
    for bh, t in [(1, 1), (512, 128), (65535, 2048), (65536, 48), (10 ** 6, 7), (3, 65535 * 64)]:
        tflash.fwd_check_shape("tc", bh, t, d)
    with pytest.raises(ValueError):
        tflash.fwd_check_shape("tc", 1, 65535 * 64 + 1, d)


@pytest.mark.parametrize("d", [16, 20, 48])
def test_tensor_core_forward_refuses_other_head_dims(d):
    with pytest.raises(ValueError):
        tflash.fwd_check_shape("tc", 8, 128, d)


@pytest.mark.parametrize("d", [32, 64, 128])
def test_tf32x3_forward_shapes(d):
    """The fp32 tensor-core forward's grid is the bf16 one's: any bh, at
    most 65,535 q tiles of 64 rows."""
    for bh, t in [(1, 1), (128, 750), (65536, 48), (10 ** 6, 7), (3, 65535 * 64)]:
        tflash.fwd_check_shape("tf32x3", bh, t, d)
    with pytest.raises(ValueError, match="flash_fwd_tf32x3"):
        tflash.fwd_check_shape("tf32x3", 1, 65535 * 64 + 1, d)


@pytest.mark.parametrize("d", [16, 20, 48])
def test_tf32x3_forward_refuses_other_head_dims(d):
    with pytest.raises(ValueError, match="flash_fwd_tf32x3"):
        tflash.fwd_check_shape("tf32x3", 8, 128, d)


@pytest.mark.parametrize("d", tflash.KERNEL_HEAD_DIMS)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_bh_cap_on_the_cuda_core_route_only(dtype, d):
    """No route caps bh any more: the CUDA-core kernel, as the tensor-core
    ones, puts bh on the grid's x dimension (70,000 is the chip check's
    call), and every route refuses more than 65,535 q tiles of 64 rows
    (the grid's y dimension)."""
    route = tflash.fwd_route(DTYPES[dtype], d)
    for bh in (65535, 65536, 70000, 10 ** 6):
        tflash.fwd_check_shape(route, bh, 128, d)
    tflash.fwd_check_shape(route, 3, 65535 * 64, d)
    with pytest.raises(ValueError):
        tflash.fwd_check_shape(route, 3, 65535 * 64 + 1, d)


# {call: (CUDA-core ms, tensor-core ms)} device times, and whether the
# tensor cores win at each
RULE_CASES = {
    "tc_wins_everywhere": ({"a": (0.11, 0.03), "b": (1.57, 0.3), "c": (0.05, 0.04)},
                           {"a": True, "b": True, "c": True}),
    "cuda_core_wins_everywhere": ({"a": (0.1, 0.2), "b": (0.05, 0.06)}, {"a": False, "b": False}),
    "cuda_core_wins_at_one_short_call": ({"s48": (0.02, 0.03), "s128": (0.11, 0.03), "s2048": (1.57, 0.3)},
                                         {"s48": False, "s128": True, "s2048": True}),
    "a_tie_takes_the_tensor_cores": ({"a": (0.2, 0.2)}, {"a": True}),
    "no_calls": ({}, {}),
}


@pytest.mark.parametrize("case", sorted(RULE_CASES))
def test_tc_fwd_wins(case):
    """The tensor-core forward wins a call when its device time is at most
    the CUDA-core forward's, call by call."""
    times, want = RULE_CASES[case]
    assert tflash.tc_fwd_wins(times) == want


@pytest.mark.parametrize("case", sorted(RULE_CASES))
def test_gate_from_takes_the_fp32_forward_rule_on_device_times(case):
    """``gate_from`` reads the fp32 ``fwd_route`` rows (the tf32x3 forward
    against the CUDA-core one) apart from the bf16 ones, under its
    ``tf32x3_fwd_`` flags; a bf16 row that the fp32 rule would judge
    otherwise does not move them."""
    times, want = RULE_CASES[case]
    rows = [{"kind": "fwd_route", "dtype": "float32", "shape": name, "S": 750, "cuda_core_device_ms": cc,
             "tf32x3_device_ms": tc, "cuda_core_wall_ms": tc, "tf32x3_wall_ms": cc} for name, (cc, tc) in times.items()]
    bf16 = {"kind": "fwd_route", "dtype": "bfloat16", "shape": "other", "S": 128, "cuda_core_device_ms": 0.1,
            "tc_device_ms": 0.2}
    got = tsweep.gate_from(rows + [bf16])
    assert got["tf32x3_fwd_wins_by_call"] == want
    assert got["tf32x3_fwd_wins_everywhere"] == all(want.values())
    assert got["tf32x3_fwd_device_ms_by_call"] == {r["shape"]: {"S": r["S"], "cuda_core": r["cuda_core_device_ms"],
                                                               "tf32x3": r["tf32x3_device_ms"]} for r in rows}
    assert got["tc_fwd_wins_by_call"] == {"other": False}


@pytest.mark.parametrize("case", sorted(RULE_CASES))
def test_gate_from_takes_the_forward_rule_on_device_times(case):
    """The sweep's ``gate_from`` applies the same rule to its ``fwd_route``
    rows' device times (never their wall times), reports those times, and
    says whether the tensor cores win at every call."""
    times, want = RULE_CASES[case]
    rows = [{"kind": "fwd_route", "shape": name, "S": 128, "cuda_core_device_ms": cc, "tc_device_ms": tc,
             "cuda_core_wall_ms": tc, "tc_wall_ms": cc} for name, (cc, tc) in times.items()]
    got = tsweep.gate_from(rows)
    assert got["tc_fwd_wins_by_call"] == want
    assert got["tc_fwd_wins_everywhere"] == all(want.values())
    assert got["fwd_device_ms_by_call"] == {r["shape"]: {"S": r["S"], "cuda_core": r["cuda_core_device_ms"],
                                                        "tc": r["tc_device_ms"]} for r in rows}


def _inputs(bh, t, s, d, dtype, seed=0):
    """q, k, v of N(0, 1) from numpy in ``dtype`` and a key bias with the
    last keys of row 1 padded."""
    rng = np.random.RandomState(seed)
    q = torch.tensor(rng.randn(bh, t, d).astype(np.float32)).to(dtype)
    k, v = (torch.tensor(rng.randn(bh, s, d).astype(np.float32)).to(dtype) for _ in range(2))
    bias = torch.zeros(bh, s)
    bias[1, s - s // 3:] = -1e9
    return q, k, v, bias


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_cpu_forward_is_the_plain_version_and_launches_nothing(dtype, causal):
    """On CPU tensors ``flash_attention`` is ``flash_attention_reference``
    exactly (atol 0), whatever route a CUDA call of that type and head dim
    would take, and no launch counter moves. bh 3, T 13, S 21, D 64 and 20,
    padded keys, rate 0.1."""
    tflash.reset_launches()
    for d in (64, 20):
        q, k, v, bias = _inputs(3, 13, 21, d, DTYPES[dtype])
        out, lse = tflash.flash_attention(q, k, v, bias, 0.3, causal=causal, dropout_rate=0.1,
                                          dropout_seed=5, return_lse=True)
        want_out, want_lse = tflash.flash_attention_reference(q, k, v, bias, 0.3, causal, 0.1, 5)
        assert out.dtype == DTYPES[dtype]
        torch.testing.assert_close(out, want_out, rtol=0, atol=0)
        torch.testing.assert_close(lse, want_lse, rtol=0, atol=0)
    counts = [tflash.launches] + [getattr(tflash, name) for name in tflash._COUNTERS]
    assert counts == [0] * (1 + len(tflash._COUNTERS))


def test_plain_forward_rounds_p_to_the_input_type():
    """The plain forward rounds exp(s - m) * keep to the input type before
    P.V, as ``_fwd_kernel``'s ``p.astype(v_ref.dtype)``: in bf16 its out is
    the fp32 P.V of the bf16-rounded weights (atol 0 after the final
    rounding), and in fp32 the rounding is the identity. bh 2, T 5, S 7,
    D 8, rate 0.3."""
    q, k, v, bias = _inputs(2, 5, 7, 8, torch.bfloat16, seed=3)
    out, lse = tflash.flash_attention_reference(q, k, v, bias, 0.5, False, 0.3, 11)
    scores = torch.einsum("btd,bsd->bts", q.float(), k.float()) * 0.5 + bias[:, None, :]
    p = torch.exp(scores - scores.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True)
    keep = tflash.philox.keep_mask(11, 2, 5, 7, 0.3).float()
    want = torch.einsum("bts,bsd->btd", (p * keep).to(torch.bfloat16).float(), v.float()) / (l * 0.7)
    torch.testing.assert_close(out, want.to(torch.bfloat16), rtol=0, atol=0)
    torch.testing.assert_close(lse, (scores.amax(-1) + torch.log(l[..., 0])), rtol=0, atol=1e-6)


# (bh, T, S, D before padding, causal, rate): a ragged call over several
# 64-key chunks, and the time attention's D 20 (padded to 32), causal with
# T > S
CARD_SHAPES = {"ragged_d64": (4, 200, 333, 64, False, 0.1), "causal_d20": (3, 130, 77, 20, True, 0.3)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CARD_SHAPES))
def test_tensor_core_kernel_matches_the_plain_version_on_the_card(case):
    """bf16 on the card: the tensor-core forward's out within 2e-2 of the
    plain version's (one bf16 rounding of |out| < 4, p rounded alike on
    both sides) and its lse within 1e-4, on the same inputs and seed; one
    launch of ``flash_fwd_tc`` a call and none of ``flash_fwd``."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    bh, t, s, d, causal, rate = CARD_SHAPES[case]
    q, k, v, bias = (x.cuda() for x in _inputs(bh, t, s, d, torch.bfloat16))
    tflash.reset_launches()
    out, lse = tflash.flash_attention(q, k, v, bias, d ** -0.5, causal=causal, dropout_rate=rate,
                                      dropout_seed=9, return_lse=True)
    want_out, want_lse = tflash.flash_attention_reference(q, k, v, bias, d ** -0.5, causal, rate, 9)
    torch.cuda.synchronize()
    assert (tflash.launches_fwd_tc, tflash.launches_fwd) == (1, 0)
    assert (out.float() - want_out.float()).abs().max().item() <= 2e-2
    assert (lse - want_lse).abs().max().item() <= 1e-4


# (bh, T, S, D before padding, causal, rate): fp32 calls of the tf32x3
# forward: the serving encoder's shape with padded keys, a ragged call over
# several 64-key chunks, the time attention's D 20 (padded to 32) causal
# with T > S, and a long ragged row
TF32X3_CARD_SHAPES = {"serve_d64": (8, 128, 128, 64, False, 0.0), "ragged_d64": (4, 200, 333, 64, False, 0.1),
                      "causal_d20": (3, 130, 77, 20, True, 0.3), "long_d32": (2, 700, 1500, 32, False, 0.1)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(TF32X3_CARD_SHAPES))
def test_tf32x3_kernel_matches_the_plain_version_on_the_card(case):
    """fp32 on the card, TF32 off on the plain side: the tf32x3 forward's
    out and lse within 1e-4 of the plain version's (three tf32 products a
    product leave about 2^-21 of |q||k| and |p||v|; the same keep bits);
    one launch of ``flash_fwd_tf32x3`` a call and none of the others."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    bh, t, s, d, causal, rate = TF32X3_CARD_SHAPES[case]
    q, k, v, bias = (x.cuda() for x in _inputs(bh, t, s, d, torch.float32))
    tflash.reset_launches()
    out, lse = tflash.flash_attention(q, k, v, bias, d ** -0.5, causal=causal, dropout_rate=rate,
                                      dropout_seed=9, return_lse=True)
    want_out, want_lse = tflash.flash_attention_reference(q, k, v, bias, d ** -0.5, causal, rate, 9)
    torch.cuda.synchronize()
    assert (tflash.launches_fwd_tf32x3, tflash.launches_fwd, tflash.launches_fwd_tc) == (1, 0, 0)
    assert (out - want_out).abs().max().item() <= 1e-4
    assert (lse - want_lse).abs().max().item() <= 1e-4
