"""PyTorch port, the flash backward's routing on the CPU: which kernels a
CUDA call would take (``split_route``, ``use_fused_backward``), the
tensor-core pair's shape limits, the decision rule on device times
(``pair_wins``, which the flash sweep's ``gate_from`` also reads), and the
CPU route, which runs the plain backward whatever the decision.

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
    """The tensor cores take bf16 at kernel head dims 32 and 64 (every
    model's heads and the time attention's padded F' = 20); fp32 (TF32
    would not be exact) and bf16 at 16 and 128 stay on the CUDA cores."""
    want = "tc" if dtype == "bfloat16" and d in (32, 64) else "cuda_core"
    assert tflash.split_route(DTYPES[dtype], d) == want


@pytest.mark.parametrize("d", [32, 64])
def test_tensor_core_pair_shapes(d):
    """The 64-row and 64-key tiles must fit the grid's y dimension
    (65,535); bh takes any size (the grid's x), and T and S set no shared
    memory."""
    for t, s in [(1, 1), (48, 128), (2048, 2048), (65535 * 64, 7), (3, 65535 * 64)]:
        tflash.tc_check_shape(d, t, s)
    for t, s in [(65535 * 64 + 1, 64), (64, 65535 * 64 + 1)]:
        with pytest.raises(ValueError):
            tflash.tc_check_shape(d, t, s)


@pytest.mark.parametrize("d", [16, 20, 128])
def test_tensor_core_pair_refuses_other_head_dims(d):
    with pytest.raises(ValueError):
        tflash.tc_check_shape(d, 128, 128)


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
    """``FUSED_BWD`` forces a route when set; else the fused kernel takes
    every call whose pair would run on the CUDA cores (fp32, bf16 at D 16
    and 128) and the tensor-core pair every other call."""
    monkeypatch.setattr(tflash, "FUSED_BWD", forced)
    for d in tflash.KERNEL_HEAD_DIMS:
        rule = tflash.split_route(DTYPES[dtype], d) != "tc"
        assert rule == (dtype == "float32" or d in (16, 128))
        assert tflash.use_fused_backward(DTYPES[dtype], d) == (forced if forced is not None else rule)


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
    counts = (tflash.launches_fwd, tflash.launches_bwd_fused, tflash.launches_bwd_dq, tflash.launches_bwd_dkv,
              tflash.launches_bwd_dq_tc, tflash.launches_bwd_dkv_tc)
    assert counts == (0,) * 6
