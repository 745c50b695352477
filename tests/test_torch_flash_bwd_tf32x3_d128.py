"""PyTorch port, the fp32 flash backward at kernel head dim 128 (the iwslt
lightconv presets' 4 heads over 512 dims) on the tensor cores in 3xTF32, on
the CPU: its route and kernels (``csrc/flash_bwd_tf32x3.cu``'s
``flash_bwd_dq_tf32x3`` and ``flash_bwd_dkv_tf32x3`` at D 128, with launch
counters of their own), the shapes it takes and refuses, that a failing
build or launch raises and nothing stands in, the sweep's rules holding it
to the fused kernel and the CUDA-core pair, and the plain fp32 backward at
D 128 against the JAX package's ``_bwd_impl`` (Pallas in interpret mode).

The kernels run only on the card: the tests marked ``cuda`` hold them
against the plain backward there (``python -m pytest --noconftest -m cuda
tests/test_torch_flash_bwd_tf32x3_d128.py``); JAX is imported inside the
test that uses it, so the module imports on a machine without it.
Tolerances are stated per test."""

import numpy as np
import pytest
import torch

from fbk_fairseq_st_tpu_torch.ops.kernels import flash_attention as tflash
from fbk_fairseq_st_tpu_torch.scripts import bench_flash_sweep as tsweep

from .test_torch_flash_fwd_d128 import _FailingLibrary, _inputs, _no_card

PAIR = ("flash_bwd_tf32x3", "flash_bwd_dq_tf32x3", "flash_bwd_dkv_tf32x3")


def test_fp32_d128_pair_route_and_kernels():
    """fp32 at kernel head dim 128 takes the tf32x3 pair, the D 32/64
    library's functions, whose launches at 128 count apart
    (``launches_bwd_{dq,dkv}_tf32x3_128``); no fused kernel unless forced."""
    assert tflash.split_route(torch.float32, 128) == "tf32x3"
    assert not tflash.use_fused_backward(torch.float32, 128)
    assert tflash.pair_kernels("tf32x3", 128) == PAIR
    assert list(tflash._SIGNATURES[PAIR[0]]) == list(PAIR[1:])
    tflash.reset_launches()
    for fn in PAIR[1:]:
        tflash._count(fn, 128)
        tflash._count(fn, 64)
    assert (tflash.launches_bwd_dq_tf32x3_128, tflash.launches_bwd_dkv_tf32x3_128,
            tflash.launches_bwd_dq_tf32x3, tflash.launches_bwd_dkv_tf32x3) == (1, 1, 1, 1)
    tflash.reset_launches()


@pytest.mark.parametrize("t,s", [(1, 1), (56, 56), (2048, 2048), (65535 * 64, 7), (3, 65535 * 64)])
def test_fp32_d128_pair_takes_65535_tiles(t, s):
    tflash.tc_check_shape(128, t, s, "tf32x3")


@pytest.mark.parametrize("t,s", [(65535 * 64 + 1, 64), (64, 65535 * 64 + 1)])
def test_fp32_d128_pair_refuses_past_65535_tiles(t, s):
    with pytest.raises(ValueError, match="flash_bwd_tf32x3"):
        tflash.tc_check_shape(128, t, s, "tf32x3")


def test_fp32_d128_pair_refuses_bf16():
    _, (q, k, v, bias) = _inputs(2, 8, 8, seed=0)
    with pytest.raises(TypeError, match="flash_bwd_tf32x3"):
        tflash.backward_pair("tf32x3", q, k, v, bias, q, torch.zeros(2, 8), q, 0.1)


@pytest.mark.parametrize("failure", ["build", "launch"])
def test_fp32_d128_pair_raises_when_its_kernel_fails(monkeypatch, failure):
    """No fallback: when the library cannot be built, or dq's launch
    returns an error, the fp32 D 128 pair raises, counts no launch and
    takes no other route (the plain backward runs only for CPU tensors, in
    ``flash_attention_backward``)."""
    asked = []

    def library(name):
        asked.append(name)
        if failure == "build":
            raise RuntimeError("nvcc not found")
        return _FailingLibrary()

    monkeypatch.setattr(tflash, "_library", library)
    _no_card(monkeypatch)
    _, (q, k, v, bias) = _inputs(2, 8, 8, seed=0, dtype=torch.float32)
    out, lse = tflash.flash_attention_reference(q, k, v, bias, 0.1)
    tflash.reset_launches()
    match = "nvcc not found" if failure == "build" else "flash_bwd_dq_tf32x3 launch failed"
    with pytest.raises(RuntimeError, match=match):
        tflash.backward_pair("tf32x3", q, k, v, bias, out, lse, q, 0.1)
    assert asked == ["flash_bwd_tf32x3"]
    assert [getattr(tflash, name) for name in tflash._COUNTERS] == [0] * len(tflash._COUNTERS)


# {call: (fused ms, CUDA-core pair ms, D 128 tf32x3 pair ms)} device times
RULE_CASES = {
    "pair_wins": ({"iwslt": (0.0985, 0.158, 0.06), "long": (8.0, 14.0, 3.0)},
                  ({"iwslt": True, "long": True}, {"iwslt": True, "long": True})),
    "fused_wins_at_iwslt": ({"iwslt": (0.0985, 0.158, 0.12), "long": (8.0, 14.0, 3.0)},
                            ({"iwslt": False, "long": True}, {"iwslt": True, "long": True})),
    "cuda_core_wins_at_long": ({"iwslt": (0.0985, 0.158, 0.06), "long": (8.0, 2.0, 3.0)},
                               ({"iwslt": True, "long": True}, {"iwslt": True, "long": False})),
}


@pytest.mark.parametrize("case", sorted(RULE_CASES))
def test_gate_from_holds_the_fp32_d128_pair_to_the_fused_kernel_and_the_cuda_core_pair(case):
    """The sweep's ``gate_from`` takes the fp32 ``bwd_route`` rows at kernel
    head dim 128 (pair route "tf32x3") into the fp32 pair's rule against the
    fused kernel (``tf32x3_bwd_wins``, which phase 13 asserts everywhere)
    and says call by call whether the pair is at least as fast as the
    CUDA-core pair (``tf32x3_d128_pair_wins``); the D 128 call's forward
    there is the CUDA-core one, and no fp32 call is left among the
    CUDA-core calls."""
    times, (want_fused, want_cc) = RULE_CASES[case]
    rows = [{"kind": "bwd_route", "dtype": "float32", "shape": name, "S": 56, "D": 128, "kernel_D": 128,
             "pair_route": "tf32x3", "fused_device_ms": f, "cuda_core_pair_device_ms": cc, "pair_device_ms": p}
            for name, (f, cc, p) in times.items()]
    rows += [{"kind": "fwd_route", "dtype": "float32", "shape": name, "S": 56, "D": 128, "kernel_D": 128,
              "route": "cuda_core", "cuda_core_device_ms": 0.0283} for name in times]
    got = tsweep.gate_from(rows)
    assert got["tf32x3_bwd_wins_by_call"] == want_fused
    assert got["tf32x3_d128_pair_wins_by_call"] == want_cc
    assert got["tf32x3_d128_pair_wins_everywhere"] == all(want_cc.values())
    assert {name: call["fwd"] for name, call in got["tf32x3_d128_calls"].items()} == {n: 0.0283 for n in times}
    assert got["tf32x3_cuda_core_calls"] == {}


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_plain_fp32_backward_at_d128_matches_jax_bwd_impl(causal):
    """``flash_attention_backward_reference`` (what the CPU route runs, and
    what the card's pair is held to) in fp32 at D 128 against JAX's
    ``_bwd_impl`` (the split ``_dq_kernel`` / ``_dkv_kernel`` in interpret
    mode, fp32 matmuls) on JAX's own out and lse, at the iwslt call's
    T = S = 56 (bh 2, keys padded on the left, rate 0; JAX pads T and S to
    128 as its ``flash_attention`` does, the padded keys at NEG_INF): dq,
    dk and dv within 1e-4, the card's limit for the pair."""
    import jax.numpy as jnp

    from fbk_fairseq_st_tpu.ops.pallas import attention_kernel as jkern

    bh, t, s, scale = 2, 56, 56, 128 ** -0.5
    (q, k, v, bias), _ = _inputs(bh, t, s, seed=2)
    g = np.random.RandomState(3).randn(bh, t, 128).astype(np.float32)
    tp, sp = jkern._pad_to(t), jkern._pad_to(s)
    pad = lambda x, n: jnp.asarray(np.pad(x, ((0, 0), (0, n - x.shape[1]), (0, 0))))  # noqa: E731
    qp, kp, vp, gp = pad(q, tp), pad(k, sp), pad(v, sp), pad(g, tp)
    bp = jnp.asarray(np.pad(bias, ((0, 0), (0, sp - s)), constant_values=-1e9))
    seed = jnp.zeros((1,), jnp.int32)
    blocks = dict(causal=causal, scale=scale, rate=0.0, t_block=tp, s_block=sp, interpret=True)
    out, lse = jkern._fwd_impl(qp, kp, vp, bp, seed, **blocks)
    want = jkern._bwd_impl(qp, kp, vp, bp, seed, out, lse, gp, **blocks)
    got = tflash.flash_attention_backward_reference(
        torch.tensor(q), torch.tensor(k), torch.tensor(v), torch.tensor(bias),
        torch.tensor(np.asarray(out)[:, :t]), torch.tensor(np.asarray(lse)[:, 0, :t]), torch.tensor(g), scale,
        causal)
    for name, a, b, n in zip(("dq", "dk", "dv"), got, want, (t, s, s)):
        assert a.dtype == torch.float32 and a.shape == (bh, n, 128)
        b = np.asarray(b)[:, :n]
        assert np.abs(b).max() > 1e-2
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-4, err_msg=name)


# (bh, T, S, causal, rate, keys padded on the left): the iwslt call at its
# rate and at 0; ragged calls over several 64-row and 64-key tiles and
# ring chunks, causal with T > S among them
D128_CARD_CASES = {
    "iwslt": (256, 56, 56, False, 0.1, True),
    "iwslt_rate0": (256, 56, 56, False, 0.0, True),
    "ragged": (4, 200, 333, False, 0.1, False),
    "causal_t_gt_s": (3, 130, 77, True, 0.3, False),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(D128_CARD_CASES))
def test_tf32x3_128_pair_matches_the_plain_backward_on_the_card(case):
    """fp32 at D 128 on the card, TF32 off on the plain side:
    ``flash_attention_backward`` launches the D 128 tf32x3 pair once each
    and nothing else; dq, dk and dv within 1e-4 of
    ``flash_attention_backward_reference`` on the D 128 tf32x3 forward's out
    and lse (3xTF32 products, the same keep bits), and bitwise equal across two
    calls (each output written once)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    bh, t, s, causal, rate, left = D128_CARD_CASES[case]
    rng = np.random.RandomState(5)
    q, g = (torch.tensor(rng.randn(bh, t, 128).astype(np.float32)).cuda() for _ in range(2))
    k, v = (torch.tensor(rng.randn(bh, s, 128).astype(np.float32)).cuda() for _ in range(2))
    pos = torch.arange(s, device="cuda")[None, :]
    lengths = torch.tensor(rng.randint(s // 2, s + 1, size=bh), device="cuda")
    lengths[0] = s
    bias = torch.where(pos < (s - lengths)[:, None] if left else pos >= lengths[:, None], -1e9, 0.0)
    scale = 128 ** -0.5
    out, lse = tflash.flash_attention(q, k, v, bias, scale, causal=causal, dropout_rate=rate, dropout_seed=9,
                                      return_lse=True)
    args = (q, k, v, bias, out, lse, g, scale, causal, rate, 9)
    tflash.reset_launches()
    got = tflash.flash_attention_backward(*args)
    again = tflash.flash_attention_backward(*args)
    want = tflash.flash_attention_backward_reference(*args)
    torch.cuda.synchronize()
    counts = {name: getattr(tflash, name) for name in tflash._COUNTERS if getattr(tflash, name)}
    assert counts == {"launches_bwd_dq_tf32x3_128": 2, "launches_bwd_dkv_tf32x3_128": 2}
    for name, a, b, w in zip(("dq", "dk", "dv"), got, again, want):
        assert torch.equal(a, b), name
        assert w.abs().max().item() > 0, name
        assert (a - w).abs().max().item() <= 1e-4, name
