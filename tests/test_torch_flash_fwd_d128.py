"""PyTorch port, the bf16 flash forward at kernel head dim 128 (the iwslt
lightconv presets' 4 heads over 512 dims) on the tensor cores, on the CPU:
its route and kernel (``csrc/flash_fwd_tc.cu``'s ``flash_fwd_tc`` at D 128,
with a launch counter of its own), the shapes it takes and refuses, that a failing
build or launch raises and nothing stands in, the sweep's rule holding it to
the CUDA-core forward, and the plain bf16 forward at D 128 against the JAX
package's ``_fwd_impl`` (Pallas in interpret mode).

The kernel runs only on the card: the tests marked ``cuda`` hold it against
the plain forward there (``python -m pytest --noconftest -m cuda
tests/test_torch_flash_fwd_d128.py``); JAX is imported inside the test that
uses it, so the module imports on a machine without it. Tolerances are
stated per test."""

import contextlib
import types

import numpy as np
import pytest
import torch

from fbk_fairseq_st_tpu_torch.ops.kernels import flash_attention as tflash
from fbk_fairseq_st_tpu_torch.scripts import bench_flash_sweep as tsweep


def test_d128_forward_route_and_kernel():
    """bf16 at kernel head dim 128 takes the tensor-core forward, the D 32/64
    library's ``flash_fwd_tc``, whose launches at 128 count apart
    (``launches_fwd_tc128``); fp32 at 128 takes the tf32x3 forward
    (``tests/test_torch_flash_fwd_tf32x3_d128.py``)."""
    assert tflash.fwd_route(torch.bfloat16, 128) == "tc"
    assert tflash.fwd_route(torch.float32, 128) == "tf32x3"
    assert tflash.FORWARDS["tc"] is tflash.forward_tc
    assert list(tflash._SIGNATURES["flash_fwd_tc"]) == ["flash_fwd_tc"]
    tflash.reset_launches()
    tflash._count("flash_fwd_tc", 128)
    tflash._count("flash_fwd_tc", 64)
    tflash._count("flash_fwd_tc", 32)
    tflash._count("flash_fwd", 128)
    assert (tflash.launches_fwd_tc128, tflash.launches_fwd_tc, tflash.launches_fwd, tflash.launches) == (1, 2, 1, 4)
    tflash.reset_launches()


@pytest.mark.parametrize("bh,t", [(1, 1), (256, 56), (32, 2048), (70000, 16), (3, 65535 * 64)])
def test_d128_forward_takes_any_bh_and_65535_q_tiles(bh, t):
    tflash.fwd_check_shape("tc", bh, t, 128)


def test_d128_forward_refuses_past_65535_q_tiles():
    with pytest.raises(ValueError, match="flash_fwd_tc"):
        tflash.fwd_check_shape("tc", 1, 65535 * 64 + 1, 128)


def _inputs(bh, t, s, seed, dtype=torch.bfloat16):
    """q, k, v of N(0, 1) from numpy at D 128 and a key bias with the
    sources padded on the left, as the iwslt decoder's cross-attention sees
    them; numpy arrays and the port's tensors."""
    rng = np.random.RandomState(seed)
    q = rng.randn(bh, t, 128).astype(np.float32)
    k, v = (rng.randn(bh, s, 128).astype(np.float32) for _ in range(2))
    bias = np.zeros((bh, s), np.float32)
    lengths = rng.randint(s // 2, s + 1, size=bh)
    lengths[0] = s
    bias[np.arange(s)[None, :] < (s - lengths)[:, None]] = -1e9
    return (q, k, v, bias), [torch.tensor(x).to(dtype) for x in (q, k, v)] + [torch.tensor(bias)]


class _FailingLibrary:
    """A loaded library whose every launch returns cudaErrorInvalidValue."""

    def __getattr__(self, name):
        return lambda *args: 1

    @staticmethod
    def error_string(err):
        return b"invalid argument"


def _no_card(monkeypatch):
    """Let a wrapper reach its launch with CPU tensors."""
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: types.SimpleNamespace(cuda_stream=0))


@pytest.mark.parametrize("failure", ["build", "launch"])
def test_d128_forward_raises_when_its_kernel_fails(monkeypatch, failure):
    """No fallback: when the library cannot be built, or its launch returns
    an error, the D 128 forward raises, counts no launch and takes no other
    route (the plain version runs only for CPU tensors, in
    ``flash_attention``)."""
    asked = []

    def library(name):
        asked.append(name)
        if failure == "build":
            raise RuntimeError("nvcc not found")
        return _FailingLibrary()

    monkeypatch.setattr(tflash, "_library", library)
    _no_card(monkeypatch)
    _, (q, k, v, bias) = _inputs(2, 8, 8, seed=0)
    tflash.reset_launches()
    match = "nvcc not found" if failure == "build" else "flash_fwd_tc launch failed"
    with pytest.raises(RuntimeError, match=match):
        tflash.forward_tc(q, k, v, bias, 0.1, False, 0.1, 3)
    assert asked == ["flash_fwd_tc"]
    assert [getattr(tflash, name) for name in tflash._COUNTERS] == [0] * len(tflash._COUNTERS)


# {call: (CUDA-core forward ms, D 128 tensor-core forward ms)} device times
D128_RULE_CASES = {
    "tc_wins": ({"iwslt": (0.0288, 0.008), "long": (2.0, 0.2)}, {"iwslt": True, "long": True}),
    "cuda_core_wins_at_one": ({"iwslt": (0.0288, 0.008), "long": (0.1, 0.2)}, {"iwslt": True, "long": False}),
    "a_tie_takes_the_tensor_cores": ({"iwslt": (0.01, 0.01)}, {"iwslt": True}),
}


@pytest.mark.parametrize("case", sorted(D128_RULE_CASES))
def test_gate_from_holds_the_d128_forward_to_the_cuda_core_forward(case):
    """The sweep's ``gate_from`` takes the bf16 ``fwd_route`` rows at kernel
    head dim 128 (route "tc") into the forward's rule like any tensor-core
    call (``tc_fwd_wins``, which phase 13 asserts everywhere), and reports
    the tensor-core forward's time as the D 128 call's forward; the fp32
    row at D 128 (the CUDA-core forward) stays out of the fp32 rule."""
    times, want = D128_RULE_CASES[case]
    rows = [{"kind": "fwd_route", "dtype": "bfloat16", "shape": name, "S": 56, "D": 128, "kernel_D": 128,
             "route": "tc", "cuda_core_device_ms": cc, "tc_device_ms": tc} for name, (cc, tc) in times.items()]
    rows += [{"kind": "bwd_route", "dtype": "bfloat16", "shape": name, "S": 56, "D": 128, "kernel_D": 128,
              "pair_route": "tc", "fused_device_ms": 0.09, "pair_device_ms": 0.03, "cuda_core_pair_device_ms": 0.15}
             for name in times]
    rows.append({"kind": "fwd_route", "dtype": "float32", "shape": "iwslt", "S": 56, "D": 128, "kernel_D": 128,
                 "route": "cuda_core", "cuda_core_device_ms": 0.0283})
    got = tsweep.gate_from(rows)
    assert got["tc_fwd_wins_by_call"] == want
    assert got["tc_fwd_wins_everywhere"] == all(want.values())
    assert {name: call["fwd"] for name, call in got["d128_calls"].items()} == {n: tc for n, (_, tc) in times.items()}
    assert got["tf32x3_fwd_wins_by_call"] == {}


def _jax_fwd(q, k, v, bias, scale, causal):
    """JAX's ``_fwd_impl`` in interpret mode in bf16 on the inputs JAX pads
    to multiples of 128 (keys with NEG_INF), as its ``flash_attention``
    pads them, at rate 0 (JAX's keep bits are the TPU's); (out as fp32, lse)
    cut back to T rows."""
    import jax.numpy as jnp

    from fbk_fairseq_st_tpu.ops.pallas import attention_kernel as jkern

    t, s = q.shape[1], k.shape[1]
    tp, sp = jkern._pad_to(t), jkern._pad_to(s)
    pad = lambda x, n: jnp.asarray(np.pad(x, ((0, 0), (0, n - x.shape[1]), (0, 0))), jnp.bfloat16)  # noqa: E731
    bp = jnp.asarray(np.pad(bias, ((0, 0), (0, sp - s)), constant_values=-1e9))
    out, lse = jkern._fwd_impl(pad(q, tp), pad(k, sp), pad(v, sp), bp, jnp.zeros((1,), jnp.int32), causal=causal,
                               scale=scale, rate=0.0, t_block=128, s_block=128, interpret=True)
    return np.asarray(out[:, :t].astype(jnp.float32)), np.asarray(lse)[:, 0, :t]


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_plain_bf16_forward_at_d128_matches_jax_fwd_impl(causal):
    """``flash_attention_reference`` (what the CPU route runs, and what the
    card's kernel is held to) in bf16 at D 128 against JAX's ``_fwd_impl``
    at the iwslt call's T = S = 56 (bh 2, keys padded on the left, rate 0):
    out within 2e-2 (the card's limit for the kernel: one bf16 rounding of
    |out| < 4, p rounded to bf16 before P.V on both sides), lse within
    1e-4."""
    (q, k, v, bias), port = _inputs(2, 56, 56, seed=1)
    scale = 128 ** -0.5
    jout, jlse = _jax_fwd(q, k, v, bias, scale, causal)
    out, lse = tflash.flash_attention_reference(*port, scale, causal)
    assert out.dtype == torch.bfloat16 and out.shape == (2, 56, 128)
    assert np.abs(jout).max() > 0.1
    np.testing.assert_allclose(out.float().numpy(), jout, rtol=0, atol=2e-2)
    np.testing.assert_allclose(lse.numpy(), jlse, rtol=0, atol=1e-4)


# (bh, T, S, causal, rate, keys padded on the left): the iwslt call at its
# rate and at 0; ragged calls over several 64-row tiles and 64-key chunks,
# causal with T > S among them
D128_CARD_CASES = {
    "iwslt": (256, 56, 56, False, 0.1, True),
    "iwslt_rate0": (256, 56, 56, False, 0.0, True),
    "ragged": (4, 200, 333, False, 0.1, False),
    "causal_t_gt_s": (3, 130, 77, True, 0.3, False),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(D128_CARD_CASES))
def test_tc128_forward_matches_the_plain_version_on_the_card(case):
    """bf16 at D 128 on the card: ``flash_attention`` launches
    ``flash_fwd_tc`` once a call (counted as ``launches_fwd_tc128``) and
    nothing else; out within 2e-2 of the plain version's (one bf16 rounding
    of |out| < 4, p rounded alike on both sides), lse within 1e-4, with the
    same seed's keep bits; bitwise equal across two calls."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    bh, t, s, causal, rate, left = D128_CARD_CASES[case]
    rng = np.random.RandomState(5)
    q = torch.tensor(rng.randn(bh, t, 128).astype(np.float32)).cuda().to(torch.bfloat16)
    k, v = (torch.tensor(rng.randn(bh, s, 128).astype(np.float32)).cuda().to(torch.bfloat16) for _ in range(2))
    pos = torch.arange(s, device="cuda")[None, :]
    lengths = torch.tensor(rng.randint(s // 2, s + 1, size=bh), device="cuda")
    lengths[0] = s
    bias = torch.where(pos < (s - lengths)[:, None] if left else pos >= lengths[:, None], -1e9, 0.0)
    scale = 128 ** -0.5
    tflash.reset_launches()
    out, lse = tflash.flash_attention(q, k, v, bias, scale, causal=causal, dropout_rate=rate, dropout_seed=9,
                                      return_lse=True)
    again = tflash.flash_attention(q, k, v, bias, scale, causal=causal, dropout_rate=rate, dropout_seed=9)
    want_out, want_lse = tflash.flash_attention_reference(q, k, v, bias, scale, causal, rate, 9)
    torch.cuda.synchronize()
    counts = {name: getattr(tflash, name) for name in tflash._COUNTERS if getattr(tflash, name)}
    assert counts == {"launches_fwd_tc128": 2}
    assert torch.equal(out, again)
    assert (out.float() - want_out.float()).abs().max().item() <= 2e-2
    assert (lse - want_lse).abs().max().item() <= 1e-4
