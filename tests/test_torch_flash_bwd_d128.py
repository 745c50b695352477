"""PyTorch port, the bf16 flash backward at kernel head dim 128 (the iwslt
lightconv presets' 4 heads over 512 dims) on the CPU: the routes (the bf16
pair on the tensor cores, ``csrc/flash_bwd_tc128.cu``; the bf16 forward and
the fp32 pair there too, ``tests/test_torch_flash_fwd_d128.py`` and
``tests/test_torch_flash_bwd_tf32x3_d128.py``; the fp32 forward too,
``tests/test_torch_flash_fwd_tf32x3_d128.py``), the library and counters the pair takes, that a failing kernel raises and nothing stands in, and the
plain bf16 backward at D 128 against the JAX package's ``_bwd_impl``
(Pallas in interpret mode).

The kernels run only on the card: the tests marked ``cuda`` hold them
against the plain backward there (``python -m pytest --noconftest -m cuda
tests/test_torch_flash_bwd_d128.py``); JAX is imported inside the test that
uses it, so the module imports on a machine without it. Tolerances are
stated per test."""

import numpy as np
import pytest
import torch

from fbk_fairseq_st_tpu_torch.ops.kernels import flash_attention as tflash


def test_d128_routes():
    """bf16 at D 128: the backward and the forward on the tensor cores
    ("tc"); fp32 at D 128: the pair and the forward on the tensor cores
    ("tf32x3")."""
    assert tflash.split_route(torch.bfloat16, 128) == "tc"
    assert tflash.split_route(torch.float32, 128) == "tf32x3"
    assert tflash.fwd_route(torch.bfloat16, 128) == "tc"
    assert tflash.fwd_route(torch.float32, 128) == "tf32x3"
    assert not tflash.use_fused_backward(torch.bfloat16, 128)


def test_d128_pair_shapes():
    """Both pairs take D 128 with the grids of D 32/64 (any bh, at most
    65,535 tiles of 64 rows or keys); so do the forwards of both types on
    the tensor cores."""
    for route in ("tc", "tf32x3"):
        for t, s in [(1, 1), (56, 56), (2048, 2048), (65535 * 64, 7), (3, 65535 * 64)]:
            tflash.tc_check_shape(128, t, s, route)
        for t, s in [(65535 * 64 + 1, 64), (64, 65535 * 64 + 1)]:
            with pytest.raises(ValueError, match="flash_bwd_" + route):
                tflash.tc_check_shape(128, t, s, route)
    for route in ("tc", "tf32x3"):
        tflash.fwd_check_shape(route, 256, 56, 128)
        with pytest.raises(ValueError, match=tflash.TC_KERNELS[route][0]):
            tflash.fwd_check_shape(route, 1, 65535 * 64 + 1, 128)


@pytest.mark.parametrize("route,d,want", [
    ("tc", 128, ("flash_bwd_tc128", "flash_bwd_dq_tc128", "flash_bwd_dkv_tc128")),
    ("tc", 64, ("flash_bwd_tc", "flash_bwd_dq_tc", "flash_bwd_dkv_tc")),
    ("tc", 32, ("flash_bwd_tc", "flash_bwd_dq_tc", "flash_bwd_dkv_tc")),
    ("tf32x3", 64, ("flash_bwd_tf32x3", "flash_bwd_dq_tf32x3", "flash_bwd_dkv_tf32x3")),
    ("tf32x3", 128, ("flash_bwd_tf32x3", "flash_bwd_dq_tf32x3", "flash_bwd_dkv_tf32x3")),
    ("cuda_core", 128, ("flash_bwd", "flash_bwd_dq", "flash_bwd_dkv")),
    ("cuda_core", 16, ("flash_bwd", "flash_bwd_dq", "flash_bwd_dkv")),
])
def test_pair_kernels(route, d, want):
    """Each pair's library and functions: the bf16 pair at D 128 its own
    source, with its own launch counters beside those of D 32/64 (the fp32
    pair's D 128 launches count apart by ``D128_COUNTERS``)."""
    assert tflash.pair_kernels(route, d) == want
    for fn in want[1:]:
        assert "launches_" + fn.removeprefix("flash_") in tflash._COUNTERS
        assert fn in tflash._SIGNATURES[want[0]]


def test_d128_pair_raises_when_its_kernel_fails(monkeypatch):
    """No fallback: when the D 128 library cannot be built or loaded, the
    bf16 pair raises, counts no launch and takes no other route (the plain
    version runs only for CPU tensors, in ``flash_attention_backward``)."""
    asked = []

    def missing(name):
        asked.append(name)
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(tflash, "_library", missing)
    rng = np.random.RandomState(0)
    q, g = (torch.tensor(rng.randn(2, 8, 128).astype(np.float32)).to(torch.bfloat16) for _ in range(2))
    k, v = (torch.tensor(rng.randn(2, 8, 128).astype(np.float32)).to(torch.bfloat16) for _ in range(2))
    bias = torch.zeros(2, 8)
    out, lse = tflash.flash_attention_reference(q, k, v, bias, 0.1)
    tflash.reset_launches()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        tflash.backward_pair("tc", q, k, v, bias, out, lse, g, 0.1)
    assert asked == ["flash_bwd_tc128"]
    assert [getattr(tflash, name) for name in tflash._COUNTERS] == [0] * len(tflash._COUNTERS)


# {call: (CUDA-core pair ms, D 128 tensor-core pair ms)} device times
D128_RULE_CASES = {
    "tc_wins": ({"iwslt": (0.147, 0.03), "long": (14.3, 1.5)}, {"iwslt": True, "long": True}),
    "cuda_core_wins_at_one": ({"iwslt": (0.147, 0.03), "long": (1.0, 1.5)}, {"iwslt": True, "long": False}),
    "a_tie_takes_the_tensor_cores": ({"iwslt": (0.1, 0.1)}, {"iwslt": True}),
}


@pytest.mark.parametrize("case", sorted(D128_RULE_CASES))
def test_gate_from_holds_the_d128_pair_to_the_cuda_core_pair(case):
    """The sweep's ``gate_from`` takes the bf16 ``bwd_route`` rows at kernel
    head dim 128 (pair route "tc") into the pair's rule against the fused
    kernel like any tensor-core call, and says call by call whether the
    D 128 pair is at least as fast as the CUDA-core pair (``d128_pair_wins``);
    an fp32 row at D 128 (the CUDA-core pair) stays among the CUDA-core
    calls."""
    from fbk_fairseq_st_tpu_torch.scripts import bench_flash_sweep as tsweep

    times, want = D128_RULE_CASES[case]
    rows = [{"kind": "bwd_route", "dtype": "bfloat16", "shape": name, "S": 56, "D": 128, "kernel_D": 128,
             "pair_route": "tc", "fused_device_ms": 1.0 + 10 * cc, "pair_device_ms": p,
             "cuda_core_pair_device_ms": cc} for name, (cc, p) in times.items()]
    rows.append({"kind": "bwd_route", "dtype": "bfloat16", "shape": "d64", "S": 128, "D": 64, "kernel_D": 64,
                 "pair_route": "tc", "fused_device_ms": 0.2, "pair_device_ms": 0.1, "cuda_core_pair_device_ms": 0.05})
    rows.append({"kind": "bwd_route", "dtype": "float32", "shape": "iwslt", "S": 56, "D": 128, "kernel_D": 128,
                 "pair_route": "cuda_core", "fused_device_ms": 0.1, "pair_device_ms": 0.15,
                 "cuda_core_pair_device_ms": 0.15})
    got = tsweep.gate_from(rows)
    assert got["d128_pair_wins_by_call"] == want
    assert got["d128_pair_wins_everywhere"] == all(want.values())
    assert got["pair_wins_by_call"] == {**{name: True for name in times}, "d64": True}
    assert set(got["d128_calls"]) == set(times)
    assert got["cuda_core_calls"] == {}
    assert set(got["tf32x3_cuda_core_calls"]) == {"iwslt"}
    assert got["tf32x3_d128_pair_wins_by_call"] == {}


def _iwslt_inputs(bh, t, s, seed):
    """q, k, v, dO of N(0, 1) at D 128 and a key bias with the sources padded
    on the left, as the iwslt decoder's cross-attention sees them."""
    rng = np.random.RandomState(seed)
    q, g = (rng.randn(bh, t, 128).astype(np.float32) for _ in range(2))
    k, v = (rng.randn(bh, s, 128).astype(np.float32) for _ in range(2))
    bias = np.zeros((bh, s), np.float32)
    lengths = rng.randint(s // 2, s + 1, size=bh)
    lengths[0] = s
    bias[np.arange(s)[None, :] < (s - lengths)[:, None]] = -1e9
    return q, k, v, g, bias


def test_plain_bf16_backward_at_d128_matches_jax_bwd_impl():
    """``flash_attention_backward_reference`` in bf16 at D 128 against
    JAX's ``_bwd_impl`` (the split ``_dq_kernel`` / ``_dkv_kernel`` in
    interpret mode) on the same out and lse, at the iwslt call's T = S = 56
    (bh 2, keys padded on the left, rate 0; JAX pads T and S to 128 as its
    ``flash_attention`` does, the padded keys at NEG_INF): dq, dk and dv
    within half a bf16 ulp of the largest gradient, 2^-9 max|grad| (both
    round ds and w_v to bf16 before their products; the card's limit for
    the kernels against this plain version is 1e-2 of max|plain|)."""
    import jax.numpy as jnp

    from fbk_fairseq_st_tpu.ops.pallas import attention_kernel as jkern

    bh, t, s, scale = 2, 56, 56, 128 ** -0.5
    q, k, v, g, bias = _iwslt_inputs(bh, t, s, seed=3)
    tp, sp = jkern._pad_to(t), jkern._pad_to(s)
    pad = lambda x, n: jnp.asarray(np.pad(x, ((0, 0), (0, n - x.shape[1]), (0, 0))), jnp.bfloat16)  # noqa: E731
    qp, kp, vp, gp = pad(q, tp), pad(k, sp), pad(v, sp), pad(g, tp)
    bp = jnp.asarray(np.pad(bias, ((0, 0), (0, sp - s)), constant_values=-1e9))
    seed = jnp.zeros((1,), jnp.int32)
    blocks = dict(causal=False, scale=scale, rate=0.0, t_block=tp, s_block=sp, interpret=True)
    out, lse = jkern._fwd_impl(qp, kp, vp, bp, seed, **blocks)
    want = jkern._bwd_impl(qp, kp, vp, bp, seed, out, lse, gp, **blocks)
    as_port = lambda x, n: torch.tensor(np.asarray(x.astype(jnp.float32))[:, :n]).to(torch.bfloat16)  # noqa: E731
    got = tflash.flash_attention_backward_reference(
        as_port(qp, t), as_port(kp, s), as_port(vp, s), torch.tensor(bias), as_port(out, t),
        torch.tensor(np.asarray(lse)[:, 0, :t]), as_port(gp, t), scale, False)
    for name, a, b, n in zip(("dq", "dk", "dv"), got, want, (t, s, s)):
        assert a.dtype == torch.bfloat16 and a.shape == (bh, n, 128)
        b = np.asarray(b.astype(jnp.float32))[:, :n]
        assert np.abs(b).max() > 0
        np.testing.assert_allclose(a.float().numpy(), b, rtol=0, atol=2.0 ** -9 * np.abs(b).max(), err_msg=name)


# (bh, T, S, causal, rate, keys padded on the left): the iwslt call at its
# rate and at 0; ragged calls over several 64-row and 64-key tiles and
# 32-row chunks, causal with T > S among them
D128_CARD_CASES = {
    "iwslt": (256, 56, 56, False, 0.1, True),
    "iwslt_rate0": (256, 56, 56, False, 0.0, True),
    "ragged": (4, 200, 333, False, 0.1, False),
    "causal_t_gt_s": (3, 130, 77, True, 0.3, False),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(D128_CARD_CASES))
def test_tc128_pair_matches_the_plain_backward_on_the_card(case):
    """bf16 at D 128 on the card: ``flash_attention_backward`` launches the
    D 128 tensor-core pair once each and nothing else; dq, dk and dv each
    within 1e-2 of its own max|plain| of ``flash_attention_backward_reference``
    on the CUDA-core forward's out and lse (one bf16 rounding of the output,
    ds and w_v rounded alike on both sides), and bitwise equal across two
    calls (each output written once)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    bh, t, s, causal, rate, left = D128_CARD_CASES[case]
    rng = np.random.RandomState(5)
    q, g = (torch.tensor(rng.randn(bh, t, 128).astype(np.float32)).cuda().to(torch.bfloat16) for _ in range(2))
    k, v = (torch.tensor(rng.randn(bh, s, 128).astype(np.float32)).cuda().to(torch.bfloat16) for _ in range(2))
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
    assert counts == {"launches_bwd_dq_tc128": 2, "launches_bwd_dkv_tc128": 2}
    for name, a, b, w in zip(("dq", "dk", "dv"), got, again, want):
        assert torch.equal(a, b), name
        top = w.float().abs().max().item()
        assert top > 0, name
        assert (a.float() - w.float()).abs().max().item() <= 1e-2 * top, name


@pytest.mark.cuda
def test_tc128_pair_through_autograd_at_head_dim_96_on_the_card():
    """A head dim of 96 pads to the kernels' 128 outside the autograd
    Function; its bf16 forward is the D 128 tensor-core forward and its
    gradients come from the D 128 tensor-core pair (one launch each, no
    CUDA-core forward) within 1e-2 of max|plain| of the plain backward on
    the unpadded inputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    rng = np.random.RandomState(6)
    q, g = (torch.tensor(rng.randn(8, 40, 96).astype(np.float32)).cuda().to(torch.bfloat16) for _ in range(2))
    k, v = (torch.tensor(rng.randn(8, 70, 96).astype(np.float32)).cuda().to(torch.bfloat16) for _ in range(2))
    bias = torch.zeros(8, 70, device="cuda")
    bias[2, 50:] = -1e9
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    tflash.reset_launches()
    out, lse = tflash.flash_attention(*leaves, bias, 0.1, dropout_rate=0.1, dropout_seed=4, return_lse=True)
    out.backward(g)
    torch.cuda.synchronize()
    assert (tflash.launches_bwd_dq_tc128, tflash.launches_bwd_dkv_tc128, tflash.launches_fwd_tc128,
            tflash.launches_fwd) == (1, 1, 1, 0)
    want = tflash.flash_attention_backward_reference(q, k, v, bias, out.detach(), lse, g, 0.1, False, 0.1, 4)
    for name, leaf, w in zip(("dq", "dk", "dv"), leaves, want):
        top = w.float().abs().max().item()
        assert (leaf.grad.float() - w.float()).abs().max().item() <= 1e-2 * top, name
