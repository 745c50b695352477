"""PyTorch port, the flash backward's routing on the CPU: which kernels a
CUDA call would take (``split_route``, ``use_fused_backward``), the
tensor-core pairs' shape limits (bf16 and fp32), the decision rule on
device times (``pair_wins``, which the flash sweep's ``gate_from`` also
reads, in each type), and the CPU route, which runs the plain backward
whatever the decision.

The kernels themselves run only on the card: ``chip_smoke.py`` holds them
against ``flash_attention_backward_reference`` there. Tolerances are stated
per test."""

import numpy as np
import pytest
import torch

from fbk_fairseq_st_tpu_torch.ops.kernels import flash_attention as tflash
from fbk_fairseq_st_tpu_torch.scripts import bench_flash_sweep as tsweep

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.mark.parametrize("d", tflash.KERNEL_HEAD_DIMS)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_split_route(dtype, d):
    """The tensor cores take both types at kernel head dims 32 and 64
    (every model's heads and the time attention's padded F' = 20): bf16 as
    "tc", fp32 as "tf32x3" (three tf32 products a product, within the fp32
    limits where one is not); both also at 128 (the iwslt presets' heads,
    ``csrc/flash_bwd_tc128.cu`` and ``csrc/flash_bwd_tf32x3.cu``); 16
    stays on the CUDA cores."""
    tc_dims = {"bfloat16": (32, 64, 128), "float32": (32, 64, 128)}[dtype]
    want = ({"bfloat16": "tc", "float32": "tf32x3"}[dtype] if d in tc_dims else "cuda_core")
    assert tflash.split_route(DTYPES[dtype], d) == want


@pytest.mark.parametrize("d", [32, 64, 128])
def test_tensor_core_pair_shapes(d):
    """The 64-row and 64-key tiles must fit the grid's y dimension
    (65,535); bh takes any size (the grid's x), and T and S set no shared
    memory."""
    for t, s in [(1, 1), (48, 128), (2048, 2048), (65535 * 64, 7), (3, 65535 * 64)]:
        tflash.tc_check_shape(d, t, s)
    for t, s in [(65535 * 64 + 1, 64), (64, 65535 * 64 + 1)]:
        with pytest.raises(ValueError):
            tflash.tc_check_shape(d, t, s)


@pytest.mark.parametrize("d", [16, 20, 96])
def test_tensor_core_pair_refuses_other_head_dims(d):
    with pytest.raises(ValueError):
        tflash.tc_check_shape(d, 128, 128)


@pytest.mark.parametrize("d", [32, 64, 128])
def test_tf32x3_pair_shapes(d):
    """The fp32 pair's grids are the bf16 pair's: any bh, at most 65,535
    tiles of 64 rows or keys; its error names its kernels."""
    for t, s in [(1, 1), (48, 128), (2048, 2048), (65535 * 64, 7), (3, 65535 * 64)]:
        tflash.tc_check_shape(d, t, s, "tf32x3")
    for t, s in [(65535 * 64 + 1, 64), (64, 65535 * 64 + 1)]:
        with pytest.raises(ValueError, match="flash_bwd_tf32x3"):
            tflash.tc_check_shape(d, t, s, "tf32x3")


@pytest.mark.parametrize("d", [16, 20, 48])
def test_tf32x3_pair_refuses_other_head_dims(d):
    with pytest.raises(ValueError, match="flash_bwd_tf32x3"):
        tflash.tc_check_shape(d, 128, 128, "tf32x3")


# {call: (fused ms, pair ms)} device times, and whether the pair wins at each
RULE_CASES = {
    "pair_wins_everywhere": ({"a": (0.28, 0.15), "b": (0.05, 0.04), "c": (3.9, 1.2)},
                             {"a": True, "b": True, "c": True}),
    "fused_wins_everywhere": ({"a": (0.1, 0.2), "b": (0.05, 0.06), "c": (1.0, 1.2)},
                              {"a": False, "b": False, "c": False}),
    "fused_wins_at_short_keys": ({"s48": (0.03, 0.05), "s128": (0.10, 0.12), "s2048": (3.9, 1.2)},
                                 {"s48": False, "s128": False, "s2048": True}),
    "a_tie_takes_the_pair": ({"a": (0.2, 0.2), "b": (3.0, 1.0)}, {"a": True, "b": True}),
    "fused_at_one_call_only": ({"a": (0.01, 0.02), "b": (0.5, 0.1), "c": (3.0, 1.0)},
                               {"a": False, "b": True, "c": True}),
    "one_call": ({"long": (3.0, 1.0)}, {"long": True}),
    "no_calls": ({}, {}),
}


@pytest.mark.parametrize("case", sorted(RULE_CASES))
def test_pair_wins(case):
    """The pair wins a call when its device time is at most the fused
    kernel's, call by call."""
    times, want = RULE_CASES[case]
    assert tflash.pair_wins(times) == want


@pytest.mark.parametrize("case", sorted(RULE_CASES))
def test_gate_from_takes_the_fp32_rule_on_device_times(case):
    """``gate_from`` reads the fp32 ``bwd_route`` rows (the tf32x3 pair
    against the fused kernel) apart from the bf16 ones, under its
    ``tf32x3_bwd_`` flags, with the CUDA-core pair's time beside them."""
    times, want = RULE_CASES[case]
    rows = [{"kind": "bwd_route", "dtype": "float32", "shape": name, "S": 128, "fused_device_ms": f,
             "pair_device_ms": p, "cuda_core_pair_device_ms": 2 * f, "fused_wall_ms": p, "pair_wall_ms": f}
            for name, (f, p) in times.items()]
    bf16 = {"kind": "bwd_route", "dtype": "bfloat16", "shape": "other", "S": 128, "fused_device_ms": 0.1,
            "pair_device_ms": 0.2}
    got = tsweep.gate_from(rows + [bf16])
    assert got["tf32x3_bwd_wins_by_call"] == want
    assert got["tf32x3_bwd_wins_everywhere"] == all(want.values())
    assert got["tf32x3_bwd_device_ms_by_call"] == {
        r["shape"]: {"S": r["S"], "fused": r["fused_device_ms"], "pair": r["pair_device_ms"],
                     "cuda_core_pair": r["cuda_core_pair_device_ms"]} for r in rows}
    assert got["pair_wins_by_call"] == {"other": False}


@pytest.mark.parametrize("case", sorted(RULE_CASES))
def test_gate_from_takes_the_rule_on_device_times(case):
    """The sweep's ``gate_from`` applies the same rule to its ``bwd_route``
    rows' device times (never their wall times), reports those times, and
    says whether the pair wins at every call."""
    times, want = RULE_CASES[case]
    rows = [{"kind": "bwd_route", "shape": name, "S": 128, "fused_device_ms": f, "pair_device_ms": p,
             "fused_wall_ms": p, "pair_wall_ms": f} for name, (f, p) in times.items()]
    got = tsweep.gate_from(rows)
    assert got["pair_wins_by_call"] == want
    assert got["pair_wins_everywhere"] == all(want.values())
    assert got["bwd_device_ms_by_call"] == {r["shape"]: {"S": r["S"], "fused": r["fused_device_ms"],
                                                         "pair": r["pair_device_ms"]} for r in rows}


@pytest.mark.parametrize("forced", [None, True, False], ids=["rule", "fused", "split"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_use_fused_backward(monkeypatch, dtype, forced):
    """``FUSED_BWD`` forces a route when set; else no call takes the fused
    kernel: the tensor-core pair of the call's type at D 32, 64 and 128
    (the iwslt presets' heads), the CUDA-core pair at D 16, so every
    default route is bitwise repeatable."""
    monkeypatch.setattr(tflash, "FUSED_BWD", forced)
    cuda_core_dims = (16,)
    for d in tflash.KERNEL_HEAD_DIMS:
        assert (tflash.split_route(DTYPES[dtype], d) == "cuda_core") == (d in cuda_core_dims)
        assert tflash.use_fused_backward(DTYPES[dtype], d) == (forced if forced is not None else False)


@pytest.mark.parametrize("found", [None, True, False], ids=["rule", "fused", "split"])
def test_backward_forced_restores_the_found_value(monkeypatch, found):
    monkeypatch.setattr(tflash, "FUSED_BWD", found)
    for fused in (True, False, None):
        with tflash.backward_forced(fused):
            assert tflash.FUSED_BWD is fused
        assert tflash.FUSED_BWD is found
    with pytest.raises(RuntimeError):
        with tflash.backward_forced(not found):
            raise RuntimeError("inside")
    assert tflash.FUSED_BWD is found


@pytest.mark.parametrize("forced", [None, True, False], ids=["rule", "fused", "split"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_cpu_backward_is_the_plain_version_whatever_the_decision(monkeypatch, dtype, forced):
    """On CPU tensors ``flash_attention``'s backward is
    ``flash_attention_backward_reference`` exactly (atol 0) under every
    setting of the decision, and launches nothing. bh 3, T 13, S 21, D 20,
    padded keys, rate 0.1."""
    monkeypatch.setattr(tflash, "FUSED_BWD", forced)
    rng = np.random.RandomState(0)
    dt = DTYPES[dtype]
    q, g = (torch.tensor(rng.randn(3, 13, 20).astype(np.float32)).to(dt) for _ in range(2))
    k, v = (torch.tensor(rng.randn(3, 21, 20).astype(np.float32)).to(dt) for _ in range(2))
    bias = torch.zeros(3, 21)
    bias[1, 15:] = -1e9
    tflash.reset_launches()
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out, lse = tflash.flash_attention(*leaves, bias, 0.3, dropout_rate=0.1, dropout_seed=5, return_lse=True)
    out.backward(g)
    want = tflash.flash_attention_backward_reference(q, k, v, bias, out.detach(), lse, g, 0.3, False, 0.1, 5)
    direct = tflash.flash_attention_backward(q, k, v, bias, out.detach(), lse, g, 0.3, False, 0.1, 5)
    for leaf, w, dr in zip(leaves, want, direct):
        assert leaf.grad.dtype == dt
        torch.testing.assert_close(leaf.grad, w, rtol=0, atol=0)
        torch.testing.assert_close(dr, w, rtol=0, atol=0)
    counts = [getattr(tflash, name) for name in tflash._COUNTERS]
    assert counts == [0] * len(tflash._COUNTERS)


# (bh, T, S, D before padding, causal, rate): fp32 backward calls of the
# tf32x3 pair: a ragged call over several 64-row and 64-key chunks, causal
# with T > S at the time attention's D 20 (padded to 32), and a long one
@pytest.mark.cuda
@pytest.mark.parametrize("case", ["ragged_d64", "causal_d20", "long_d32"])
def test_tf32x3_pair_matches_the_plain_backward_on_the_card(case):
    """fp32 on the card, TF32 off on the plain side: dq, dk and dv of the
    tf32x3 pair within 1e-4 of ``flash_attention_backward_reference`` on
    the kernel forward's out and lse (3xTF32 products, the same keep
    bits), one launch each of its dq and dkv kernels and nothing else, and
    bitwise equal across two calls (each output written once)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    bh, t, s, d, causal, rate = {"ragged_d64": (4, 200, 333, 64, False, 0.1),
                                 "causal_d20": (3, 130, 77, 20, True, 0.3),
                                 "long_d32": (2, 700, 1500, 32, False, 0.1)}[case]
    rng = np.random.RandomState(4)
    q, g = (torch.tensor(rng.randn(bh, t, d).astype(np.float32)).cuda() for _ in range(2))
    k, v = (torch.tensor(rng.randn(bh, s, d).astype(np.float32)).cuda() for _ in range(2))
    bias = torch.zeros(bh, s, device="cuda")
    bias[1, s - s // 3:] = -1e9
    dk_ = tflash.kernel_head_dim(d)
    pad = lambda x: torch.nn.functional.pad(x, (0, dk_ - d))  # noqa: E731
    out, lse = tflash.flash_attention(pad(q), pad(k), pad(v), bias, d ** -0.5, causal=causal, dropout_rate=rate,
                                      dropout_seed=3, return_lse=True)
    args = (pad(q), pad(k), pad(v), bias, out, lse, pad(g), d ** -0.5, causal, rate, 3)
    tflash.reset_launches()
    got = tflash.flash_attention_backward(*args)
    again = tflash.flash_attention_backward(*args)
    want = tflash.flash_attention_backward_reference(q, k, v, bias, out[..., :d], lse, g, d ** -0.5, causal, rate, 3)
    torch.cuda.synchronize()
    counts = (tflash.launches_bwd_dq_tf32x3, tflash.launches_bwd_dkv_tf32x3, tflash.launches_bwd_fused,
              tflash.launches_bwd_dq, tflash.launches_bwd_dq_tc)
    assert counts == (2, 2, 0, 0, 0)
    for name, a, b, w in zip(("dq", "dk", "dv"), got, again, want):
        assert torch.equal(a, b), name
        assert (a[..., :d] - w).abs().max().item() <= 1e-4, name


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_rows_with_every_key_masked_average_uniformly(dtype):
    """A row whose every key is masked (a fixed-shape batch's padding row)
    gives the uniform average of V, with no gradient to its q or to k
    through it, as the dense route does, and finite gradients when one
    reaches it (without the guard the kernels' s - lse at |bias| ~ 1e9
    overflowed the backward of such a row on the card); other rows are
    untouched. fp32 within 1e-6, bf16 within one bf16 rounding (2^-7)."""
    g = torch.Generator().manual_seed(0)
    bh, t, s, d = 4, 5, 9, 16
    q, k, v = (torch.randn((bh, n, d), generator=g).to(DTYPES[dtype]).requires_grad_() for n in (t, s, s))
    bias = torch.zeros(bh, s)
    bias[1] = tflash.NEG_INF
    bias[2, 4:] = tflash.NEG_INF
    out = tflash.flash_attention(q, k, v, bias, 0.25)
    grad = torch.randn(out.shape, generator=g).to(out.dtype)
    out.backward(grad)
    tol = 1e-6 if dtype == "float32" else 2.0 ** -7
    np.testing.assert_allclose(out[1].float().detach().numpy(),
                               v[1].float().mean(0, keepdim=True).expand(t, d).detach().numpy(), rtol=0, atol=tol)
    assert float(q.grad[1].abs().max()) == 0.0
    np.testing.assert_allclose(v.grad[1].float().numpy(),
                               (grad[1].float().sum(0, keepdim=True) / s).expand(s, d).numpy(), rtol=0, atol=4 * tol)
    for x in (q, k, v):
        assert torch.isfinite(x.grad).all()
    live = [0, 2, 3]
    want, _ = tflash.flash_attention_reference(q[live].detach(), k[live].detach(), v[live].detach(), bias[live], 0.25)
    np.testing.assert_array_equal(out[live].detach().float().numpy(), want.float().numpy())
