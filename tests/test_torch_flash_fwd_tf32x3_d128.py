"""PyTorch port, the fp32 flash forward at kernel head dim 128 (the iwslt
lightconv presets' 4 heads over 512 dims) on the tensor cores in 3xTF32,
on the CPU: its route and kernel (``csrc/flash_fwd_tf32x3.cu``'s
``flash_fwd_tf32x3`` at D 128, with a launch counter of its own that the
forwards' sum ``launches`` includes), the shapes it takes, that a failing
build or launch raises and nothing stands in, the sweep's rule holding it
to the CUDA-core forward, and the plain fp32 forward at D 128 against the
JAX package's ``_fwd_impl`` (Pallas in interpret mode), at rate 0.1
through a keep mask both sides share.

The kernel runs only on the card: the test marked ``cuda`` holds it against
the plain forward there (``python -m pytest --noconftest -m cuda
tests/test_torch_flash_fwd_tf32x3_d128.py``); JAX is imported inside the
test that uses it, so the module imports on a machine without it.
Tolerances are stated per test."""

import contextlib
import types

import numpy as np
import pytest
import torch

from fbk_fairseq_st_tpu_torch.ops.kernels import flash_attention as tflash
from fbk_fairseq_st_tpu_torch.ops.kernels import philox
from fbk_fairseq_st_tpu_torch.scripts import bench_flash_sweep as tsweep


def test_fp32_d128_forward_route_and_counter():
    """fp32 at kernel head dim 128 takes the tf32x3 forward (D 16 stays on
    the CUDA cores), the D 32/64 library's ``flash_fwd_tf32x3``, whose
    launches at 128 count apart (``launches_fwd_tf32x3_128``) and enter the
    forwards' sum ``launches`` that serving reads."""
    assert tflash.fwd_route(torch.float32, 128) == "tf32x3"
    assert tflash.fwd_route(torch.float32, 16) == "cuda_core"
    assert tflash.FORWARDS["tf32x3"] is tflash.forward_tf32x3
    assert list(tflash._SIGNATURES["flash_fwd_tf32x3"]) == ["flash_fwd_tf32x3"]
    assert "launches_fwd_tf32x3_128" in tflash._COUNTERS
    tflash.reset_launches()
    tflash._count("flash_fwd_tf32x3", 128)
    tflash._count("flash_fwd_tf32x3", 128)
    tflash._count("flash_fwd_tf32x3", 64)
    tflash._count("flash_fwd_tc", 128)
    assert (tflash.launches_fwd_tf32x3_128, tflash.launches_fwd_tf32x3, tflash.launches_fwd_tc128,
            tflash.launches) == (2, 1, 1, 4)
    tflash.reset_launches()
    assert tflash.launches == 0


@pytest.mark.parametrize("bh,t", [(1, 1), (256, 56), (32, 2048), (70000, 16), (3, 65535 * 64)])
def test_fp32_d128_forward_takes_any_bh_and_65535_q_tiles(bh, t):
    tflash.fwd_check_shape("tf32x3", bh, t, 128)


def test_fp32_d128_forward_refuses_past_65535_q_tiles():
    with pytest.raises(ValueError, match="flash_fwd_tf32x3"):
        tflash.fwd_check_shape("tf32x3", 1, 65535 * 64 + 1, 128)


def _inputs(bh, t, s, seed):
    """fp32 q, k, v of N(0, 1) from numpy at D 128 and a key bias with the
    sources padded on the left, as the iwslt decoder's cross-attention sees
    them; numpy arrays and the port's tensors."""
    rng = np.random.RandomState(seed)
    q = rng.randn(bh, t, 128).astype(np.float32)
    k, v = (rng.randn(bh, s, 128).astype(np.float32) for _ in range(2))
    bias = np.zeros((bh, s), np.float32)
    lengths = rng.randint(s // 2, s + 1, size=bh)
    lengths[0] = s
    bias[np.arange(s)[None, :] < (s - lengths)[:, None]] = -1e9
    return (q, k, v, bias), [torch.tensor(x) for x in (q, k, v, bias)]


class _FailingLibrary:
    """A loaded library whose every launch returns cudaErrorInvalidValue."""

    def __getattr__(self, name):
        return lambda *args: 1

    @staticmethod
    def error_string(err):
        return b"invalid argument"


@pytest.mark.parametrize("failure", ["build", "launch"])
def test_fp32_d128_forward_raises_when_its_kernel_fails(monkeypatch, failure):
    """No fallback: when the library cannot be built, or its launch returns
    an error, the fp32 D 128 forward raises, counts no launch and takes no
    other route (the plain version runs only for CPU tensors, in
    ``flash_attention``)."""
    asked = []

    def library(name):
        asked.append(name)
        if failure == "build":
            raise RuntimeError("nvcc not found")
        return _FailingLibrary()

    monkeypatch.setattr(tflash, "_library", library)
    # let the wrapper reach its launch with CPU tensors
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: types.SimpleNamespace(cuda_stream=0))
    _, (q, k, v, bias) = _inputs(2, 8, 8, seed=0)
    tflash.reset_launches()
    match = "nvcc not found" if failure == "build" else "flash_fwd_tf32x3 launch failed"
    with pytest.raises(RuntimeError, match=match):
        tflash.forward_tf32x3(q, k, v, bias, 0.1, False, 0.1, 3)
    assert asked == ["flash_fwd_tf32x3"]
    assert [getattr(tflash, name) for name in tflash._COUNTERS] == [0] * len(tflash._COUNTERS)


# {call: (CUDA-core forward ms, D 128 tf32x3 forward ms)} device times
D128_RULE_CASES = {
    "tf32x3_wins": ({"iwslt": (0.0280, 0.015), "long": (2.82, 1.9)}, {"iwslt": True, "long": True}),
    "cuda_core_wins_at_one": ({"iwslt": (0.0280, 0.015), "long": (1.5, 1.9)}, {"iwslt": True, "long": False}),
    "a_tie_takes_the_tensor_cores": ({"iwslt": (0.02, 0.02)}, {"iwslt": True}),
}


@pytest.mark.parametrize("case", sorted(D128_RULE_CASES))
def test_gate_from_holds_the_fp32_d128_forward_to_the_cuda_core_forward(case):
    """The sweep's ``gate_from`` takes the fp32 ``fwd_route`` rows at kernel
    head dim 128 (route "tf32x3") into the fp32 forward's rule like any
    tensor-core call (``tf32x3_fwd_wins``, which phase 13 asserts
    everywhere), and reports the tf32x3 forward's time as the D 128 call's
    forward."""
    times, want = D128_RULE_CASES[case]
    rows = [{"kind": "fwd_route", "dtype": "float32", "shape": name, "S": 56, "D": 128, "kernel_D": 128,
             "route": "tf32x3", "cuda_core_device_ms": cc, "tf32x3_device_ms": tc} for name, (cc, tc) in times.items()]
    rows += [{"kind": "bwd_route", "dtype": "float32", "shape": name, "S": 56, "D": 128, "kernel_D": 128,
              "pair_route": "tf32x3", "fused_device_ms": 0.098, "pair_device_ms": 0.06,
              "cuda_core_pair_device_ms": 0.158} for name in times]
    got = tsweep.gate_from(rows)
    assert got["tf32x3_fwd_wins_by_call"] == want
    assert got["tf32x3_fwd_wins_everywhere"] == all(want.values())
    assert {name: call["fwd"] for name, call in got["tf32x3_d128_calls"].items()} == {
        n: tc for n, (_, tc) in times.items()}
    assert got["tc_fwd_wins_by_call"] == {}


def _philox_keep_jnp(seed: int, head, shape, rate: float):
    """The port's keep mask (``philox.keep_mask``) of one head as jnp ops on
    uint32 values, for a tile of ``shape`` (rows, keys) from (0, 0): the
    same Philox4x32-10 words, each 32 x 32-bit product split in 16-bit
    halves so that nothing leaves uint32."""
    import jax.numpy as jnp

    u32 = lambda x: jnp.asarray(x, jnp.uint32)  # noqa: E731

    def mulhilo(m, x):
        m_lo, m_hi = u32(m & 0xFFFF), u32(m >> 16)
        x_lo, x_hi = x & u32(0xFFFF), x >> u32(16)
        ll, lh, hl, hh = m_lo * x_lo, m_lo * x_hi, m_hi * x_lo, m_hi * x_hi
        mid = (ll >> u32(16)) + (lh & u32(0xFFFF)) + (hl & u32(0xFFFF))
        return hh + (lh >> u32(16)) + (hl >> u32(16)) + (mid >> u32(16)), (ll & u32(0xFFFF)) | (mid << u32(16))

    rows = jnp.arange(shape[0], dtype=jnp.uint32)[:, None]
    cols = jnp.arange(shape[1], dtype=jnp.uint32)[None, :]
    c = [cols >> u32(2), jnp.broadcast_to(rows, shape), jnp.broadcast_to(u32(head), shape), u32(0)]
    k0, k1 = seed & philox.MASK32, (seed >> 32) & philox.MASK32
    for r in range(10):
        if r:
            k0, k1 = (k0 + philox.PHILOX_W0) & philox.MASK32, (k1 + philox.PHILOX_W1) & philox.MASK32
        hi0, lo0 = mulhilo(philox.PHILOX_M0, c[0])
        hi1, lo1 = mulhilo(philox.PHILOX_M1, c[2])
        c = [hi1 ^ c[1] ^ u32(k0), lo1, hi0 ^ c[3] ^ u32(k1), lo0]
    lane = cols & u32(3)
    bits = jnp.where(lane == 0, c[0], jnp.where(lane == 1, c[1], jnp.where(lane == 2, c[2], c[3])))
    return (bits >= u32(philox.keep_threshold(rate))).astype(jnp.float32)


def test_jnp_keep_mask_is_the_ports():
    """The jnp Philox above draws ``philox.keep_mask``'s bits, head by
    head, at the iwslt call's rows and keys (and the padding to 128)."""
    seed = 0xDEADBEEF12345
    want = philox.keep_mask(seed, 3, 128, 128, 0.1).numpy()
    got = np.stack([np.asarray(_philox_keep_jnp(seed, h, (128, 128), 0.1)) for h in range(3)])
    np.testing.assert_array_equal(got, want.astype(np.float32))


def _jax_fwd(monkeypatch, q, k, v, bias, scale, causal, rate, seed):
    """JAX's ``_fwd_impl`` in interpret mode in fp32 on the inputs JAX pads
    to multiples of 128 (keys with NEG_INF), as its ``flash_attention``
    pads them, one block a head (so a tile's ``block_id`` is its head). At
    a rate above 0 its ``_dropout_keep`` (the TPU's PRNG, which the CPU
    lacks) draws the port's Philox keep mask of the same seed instead
    (``_philox_keep_jnp``): both sides drop the same weights. Returns
    (out, lse) cut back to T rows."""
    import jax.numpy as jnp

    from fbk_fairseq_st_tpu.ops.pallas import attention_kernel as jkern

    t, s = q.shape[1], k.shape[1]
    tp, sp = jkern._pad_to(t), jkern._pad_to(s)
    if rate > 0:
        monkeypatch.setattr(jkern, "_dropout_keep",
                            lambda seed_, block_id, rate_, shape: _philox_keep_jnp(seed, block_id, shape, rate_))
    pad = lambda x, n: jnp.asarray(np.pad(x, ((0, 0), (0, n - x.shape[1]), (0, 0))))  # noqa: E731
    bp = jnp.asarray(np.pad(bias, ((0, 0), (0, sp - s)), constant_values=-1e9))
    out, lse = jkern._fwd_impl(pad(q, tp), pad(k, sp), pad(v, sp), bp, jnp.zeros((1,), jnp.int32), causal=causal,
                               scale=scale, rate=rate, t_block=tp, s_block=sp, interpret=True)
    return np.asarray(out[:, :t]), np.asarray(lse)[:, 0, :t]


@pytest.mark.parametrize("rate", [0.0, 0.1], ids=["rate0", "rate0.1"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_plain_fp32_forward_at_d128_matches_jax_fwd_impl(monkeypatch, causal, rate):
    """``flash_attention_reference`` (what the CPU route runs, and what the
    card's kernel is held to) in fp32 at D 128 against JAX's ``_fwd_impl``
    at the iwslt call's T = S = 56 (bh 2, keys padded on the left), at
    rates 0 and 0.1 (the same keep mask on both sides): out and lse within
    1e-5 (fp32 on both sides; the online and the plain softmax sum in
    other orders)."""
    (q, k, v, bias), port = _inputs(2, 56, 56, seed=1)
    scale, seed = 128 ** -0.5, 12345
    jout, jlse = _jax_fwd(monkeypatch, q, k, v, bias, scale, causal, rate, seed)
    out, lse = tflash.flash_attention_reference(*port, scale, causal, rate, seed)
    assert out.dtype == torch.float32 and out.shape == (2, 56, 128)
    assert np.abs(jout).max() > 0.1
    np.testing.assert_allclose(out.numpy(), jout, rtol=0, atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), jlse, rtol=0, atol=1e-5)
    if rate > 0:  # the mask dropped weights: the rate-0 output differs
        plain, _ = tflash.flash_attention_reference(*port, scale, causal)
        assert (plain - out).abs().max().item() > 1e-2


# (bh, T, S, causal, rate, keys padded on the left): the iwslt call at its
# rate and at 0; ragged calls over several 64-row tiles and 32-key chunks,
# causal with T > S among them
D128_CARD_CASES = {
    "iwslt": (256, 56, 56, False, 0.1, True),
    "iwslt_rate0": (256, 56, 56, False, 0.0, True),
    "ragged": (4, 200, 333, False, 0.1, False),
    "causal_t_gt_s": (3, 130, 77, True, 0.3, False),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(D128_CARD_CASES))
def test_tf32x3_128_forward_matches_the_plain_version_on_the_card(case):
    """fp32 at D 128 on the card (TF32 off for the plain version):
    ``flash_attention`` launches ``flash_fwd_tf32x3`` once a call (counted
    as ``launches_fwd_tf32x3_128``) and nothing else; out and lse within
    1e-4 of the plain version's, with the same seed's keep bits; bitwise
    equal across two calls."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    bh, t, s, causal, rate, left = D128_CARD_CASES[case]
    rng = np.random.RandomState(5)
    q = torch.tensor(rng.randn(bh, t, 128).astype(np.float32)).cuda()
    k, v = (torch.tensor(rng.randn(bh, s, 128).astype(np.float32)).cuda() for _ in range(2))
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
    assert counts == {"launches_fwd_tf32x3_128": 2}
    assert torch.equal(out, again)
    assert (out - want_out).abs().max().item() <= 1e-4
    assert (lse - want_lse).abs().max().item() <= 1e-4
