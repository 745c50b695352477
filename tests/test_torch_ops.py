"""PyTorch port, op level: each module that holds a kernel (and the ops
around it) against the JAX package on the same numpy inputs, on the CPU.

The port runs its plain versions here (CPU tensors); JAX runs its flash
route as its own tests do, through the Pallas kernel in interpret mode.
Tolerances are stated per test; everything is fp32 (conftest pins JAX
matmuls to fp32)."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fbk_fairseq_st_tpu.ops import attention as jattn
from fbk_fairseq_st_tpu.ops import core as jcore
from fbk_fairseq_st_tpu.ops import positional as jpos
from fbk_fairseq_st_tpu.ops.pallas import attention_kernel as jkern
from fbk_fairseq_st_tpu_torch.ops import attention as tattn
from fbk_fairseq_st_tpu_torch.ops import conv_frontend as tfront
from fbk_fairseq_st_tpu_torch.ops import core as tcore
from fbk_fairseq_st_tpu_torch.ops import positional as tpos
from fbk_fairseq_st_tpu_torch.ops.kernels import flash_attention as tflash
from fbk_fairseq_st_tpu_torch.utils.weights import state_dict_from_jax

# the JAX ops package re-exports a function named conv_frontend
jfront = importlib.import_module("fbk_fairseq_st_tpu.ops.conv_frontend")


def _np(x):
    return np.asarray(x.detach()) if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture
def flash_routes():
    """Set both packages' flash switch; restore auto afterwards."""
    def set_both(enabled):
        jattn.set_flash_attention(enabled)
        tattn.set_flash_attention(enabled)
    yield set_both
    jattn.set_flash_attention(None)
    tattn.set_flash_attention(None)


# ---------------------------------------------------------------------------
# flash_attention (plain route) against the JAX Pallas kernel
# ---------------------------------------------------------------------------

FLASH_CASES = {
    # name: (bh, T, S, D, causal, padded keys)
    "padded": (4, 16, 24, 8, False, True),
    "causal_padded": (3, 20, 20, 16, True, True),
    "t_ne_s": (2, 9, 33, 32, False, True),
    "causal_t_gt_s_unaligned": (2, 13, 7, 8, True, False),
    "d20_time_attention": (4, 21, 21, 20, False, True),
}


def _flash_inputs(bh, t, s, d, padded, seed=0):
    rng = np.random.RandomState(seed)
    q = rng.randn(bh, t, d).astype(np.float32)
    k = rng.randn(bh, s, d).astype(np.float32)
    v = rng.randn(bh, s, d).astype(np.float32)
    bias = np.zeros((bh, s), np.float32)
    if padded:
        lengths = rng.randint(s // 2, s + 1, size=bh)
        lengths[0] = s
        bias[np.arange(s)[None, :] >= lengths[:, None]] = -1e9
    return q, k, v, bias


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_attention_matches_jax_kernel(case):
    """out at atol 2e-5 against JAX flash_attention; lse at atol 2e-5
    against _fwd_impl on the inputs JAX pads to 128."""
    bh, t, s, d, causal, padded = FLASH_CASES[case]
    q, k, v, bias = _flash_inputs(bh, t, s, d, padded)
    scale = 0.7
    want = jkern.flash_attention(*map(jnp.asarray, (q, k, v, bias)), scale, causal=causal)
    got, lse = tflash.flash_attention(*map(torch.tensor, (q, k, v, bias)), scale,
                                      causal=causal, return_lse=True)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0, atol=2e-5)

    tp, sp = jkern._pad_to(t), jkern._pad_to(s)
    qp = np.pad(q, ((0, 0), (0, tp - t), (0, 0)))
    kp = np.pad(k, ((0, 0), (0, sp - s), (0, 0)))
    vp = np.pad(v, ((0, 0), (0, sp - s), (0, 0)))
    bp = np.pad(bias, ((0, 0), (0, sp - s)), constant_values=-1e9)
    _, jlse = jkern._fwd_impl(
        *map(jnp.asarray, (qp, kp, vp, bp)), jnp.zeros((1,), jnp.int32),
        causal=causal, scale=scale, rate=0.0, t_block=128, s_block=128, interpret=True,
    )
    np.testing.assert_allclose(_np(lse), np.asarray(jlse)[:, 0, :t], rtol=0, atol=2e-5)


def test_flash_attention_cpu_route_counts_no_launch_and_refuses_dropout():
    q, k, v, bias = map(torch.tensor, _flash_inputs(2, 5, 6, 8, True))
    before = tflash.launches
    tflash.flash_attention(q, k, v, bias, 1.0)
    assert tflash.launches == before  # the plain version is not a launch
    with pytest.raises(NotImplementedError):
        tflash.flash_attention(q, k, v, bias, 1.0, dropout_rate=0.1)
    with pytest.raises(ValueError):
        tflash.flash_attention(q, k, v, bias[:, :3], 1.0)


@pytest.mark.parametrize("d,expected", [(8, 16), (16, 16), (20, 32), (64, 64), (65, 128)])
def test_kernel_head_dim_padding(d, expected):
    assert tflash.kernel_head_dim(d) == expected


def test_kernel_head_dim_above_128_is_refused():
    with pytest.raises(ValueError):
        tflash.kernel_head_dim(129)


# ---------------------------------------------------------------------------
# mha
# ---------------------------------------------------------------------------

def _mha_pair(penalty=None, seed=0):
    cfg_kwargs = dict(embed_dim=16, num_heads=2, penalty=penalty, init_variance=0.8)
    jcfg = jattn.MHAConfig(**cfg_kwargs)
    params = jattn.init_mha(jax.random.PRNGKey(seed), jcfg)
    params = jax.tree_util.tree_map(np.asarray, params)
    module = tattn.MultiheadAttention(tattn.MHAConfig(**cfg_kwargs)).eval()
    sd = state_dict_from_jax({"params": {"self_attn": params}})
    module.load_state_dict({k[len("self_attn."):]: v for k, v in sd.items()}, strict=True)
    return jcfg, params, module


MHA_CASES = {
    # name: (route, attn_mask, key padding, penalty, need_weights)
    "dense_padded": ("dense", None, True, None, False),
    "flash_padded": ("flash", None, True, None, False),
    "dense_causal": ("dense", "causal", True, None, False),
    "flash_causal": ("flash", "causal", True, None, False),
    "dense_additive_mask": ("dense", "additive", False, None, False),
    "log_penalty": ("flash", None, True, "log", False),
    "gauss_penalty": ("dense", None, True, "gauss", False),
    "need_weights": ("flash", None, True, None, True),
}


@pytest.mark.parametrize("case", sorted(MHA_CASES))
def test_mha_matches_jax(case, flash_routes):
    """Output (and head-averaged weights) at atol 1e-5. Penalties and
    need_weights take the dense path even with flash forced, on both
    sides."""
    route, mask_kind, padded, penalty, need_weights = MHA_CASES[case]
    jcfg, params, module = _mha_pair(penalty)
    rng = np.random.RandomState(1)
    x = rng.randn(3, 12, 16).astype(np.float32)
    kpm = (np.arange(12)[None, :] >= np.array([12, 9, 7])[:, None]) if padded else None
    attn_mask = mask_kind
    if mask_kind == "additive":
        attn_mask = (rng.randn(12, 12) * 0.5).astype(np.float32)
    flash_routes(route == "flash")
    jout, jw, _ = jattn.mha(
        params, jcfg, jnp.asarray(x),
        key_padding_mask=None if kpm is None else jnp.asarray(kpm),
        attn_mask=attn_mask if not isinstance(attn_mask, np.ndarray) else jnp.asarray(attn_mask),
        need_weights=need_weights,
    )
    with torch.no_grad():
        tout, tw, _ = module(
            torch.tensor(x),
            key_padding_mask=None if kpm is None else torch.tensor(kpm),
            attn_mask=attn_mask if not isinstance(attn_mask, np.ndarray) else torch.tensor(attn_mask),
            need_weights=need_weights,
        )
    np.testing.assert_allclose(_np(tout), np.asarray(jout), rtol=0, atol=1e-5)
    if need_weights:
        np.testing.assert_allclose(_np(tw), np.asarray(jw), rtol=0, atol=1e-5)


def test_mha_cached_steps_match_jax():
    """Five incremental self-attention steps over a preallocated cache (slots
    not yet written masked) and a static cross-attention cache: outputs and
    the written cache at atol 1e-5."""
    jcfg, params, module = _mha_pair()
    rng = np.random.RandomState(2)
    b, t_max, s = 2, 8, 6
    xs = rng.randn(b, 5, 16).astype(np.float32)
    enc = rng.randn(b, s, 16).astype(np.float32)
    enc_kpm = np.arange(s)[None, :] >= np.array([6, 4])[:, None]

    jcache = jattn.init_cache(b, t_max, jcfg)
    tcache = tattn.init_cache(b, t_max, module.cfg)
    jcross = jattn.precompute_cross_cache(params, jcfg, jnp.asarray(enc))
    with torch.no_grad():
        tcross = module.precompute_cross_cache(torch.tensor(enc))
        for step in range(5):
            x = xs[:, step:step + 1]
            jout, _, jcache = jattn.mha(params, jcfg, jnp.asarray(x), cache=jcache, cache_index=step)
            tout, _, _ = module(torch.tensor(x), cache=tcache, cache_index=step)
            np.testing.assert_allclose(_np(tout), np.asarray(jout), rtol=0, atol=1e-5)
            jx, jw, _ = jattn.mha(params, jcfg, jnp.asarray(x), key_padding_mask=jnp.asarray(enc_kpm),
                                  cache=jcross, static_kv=True, need_weights=True)
            tx, tw, _ = module(torch.tensor(x), key_padding_mask=torch.tensor(enc_kpm),
                               cache=tcross, static_kv=True, need_weights=True)
            np.testing.assert_allclose(_np(tx), np.asarray(jx), rtol=0, atol=1e-5)
            np.testing.assert_allclose(_np(tw), np.asarray(jw), rtol=0, atol=1e-5)
    np.testing.assert_allclose(_np(tcache["k"]), np.asarray(jcache["k"]), rtol=0, atol=1e-5)
    np.testing.assert_allclose(_np(tcache["v"]), np.asarray(jcache["v"]), rtol=0, atol=1e-5)


def test_mha_flash_routing_rules(monkeypatch, flash_routes):
    """Auto mode sends nothing to the flash route on CPU tensors; forced on,
    only cache-free calls without penalty/need_weights/active dropout go."""
    _, _, module = _mha_pair()
    calls = []
    real = tattn.flash_attention
    monkeypatch.setattr(tattn, "flash_attention", lambda *a, **kw: calls.append(1) or real(*a, **kw))
    x = torch.randn(2, 5, 16)
    with torch.no_grad():
        flash_routes(None)
        module(x)
        assert calls == []
        flash_routes(True)
        module(x, attn_mask="causal")
        assert len(calls) == 1
        module(x, need_weights=True)
        cache = tattn.init_cache(2, 6, module.cfg)
        module(x[:, :1], cache=cache, cache_index=0)
        module.train()
        module.cfg = module.cfg._replace(dropout=0.1)
        module(x, generator=torch.Generator().manual_seed(0))
    assert len(calls) == 1


# ---------------------------------------------------------------------------
# conv frontend + ConvAttention2D
# ---------------------------------------------------------------------------

def _perturbed_frontend(convolutions, seed=0):
    cfg_kwargs = dict(convolutions=convolutions, audio_features=16, dropout=0.1,
                      attn_2d=True, attn_2d_heads=2)
    jcfg = jfront.ConvFrontendConfig(**cfg_kwargs)
    params, state = jfront.init_conv_frontend(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.RandomState(seed + 10)

    def perturb(path, leaf):
        name = jax.tree_util.keystr(path)
        leaf = np.asarray(leaf)
        if "'var'" in name:
            return (leaf * rng.uniform(0.5, 2.0, leaf.shape)).astype(np.float32)
        if "'mean'" in name or "'scale'" in name or "'bias'" in name or "'b'" in name:
            return (leaf + 0.2 * rng.randn(*leaf.shape)).astype(np.float32)
        return leaf

    params = jax.tree_util.tree_map_with_path(perturb, params)
    state = jax.tree_util.tree_map_with_path(perturb, state)
    module = tfront.ConvFrontend(tfront.ConvFrontendConfig(**cfg_kwargs)).eval()
    module.load_state_dict(state_dict_from_jax({"params": params, "state": state}), strict=True)
    return jcfg, params, state, module


@pytest.mark.parametrize("route", ["dense", "flash"])
@pytest.mark.parametrize("kernels", ["k3", "even_k"])
def test_conv_frontend_matches_jax(route, kernels, flash_routes):
    """conv_frontend (two stride-2 convs, BN with non-trivial running stats,
    two ConvAttention2D blocks) in eval mode with odd lengths: features at
    atol 1e-5, lengths exactly."""
    convolutions = ((8, 3, 3), (8, 3, 3)) if kernels == "k3" else ((8, 4, 2), (8, 3, 3))
    jcfg, params, state, module = _perturbed_frontend(convolutions)
    rng = np.random.RandomState(3)
    x = rng.randn(3, 37, 16).astype(np.float32)
    lengths = np.array([37, 30, 21], np.int32)
    flash_routes(route == "flash")
    jy, jlen, _ = jfront.conv_frontend(params, state, jcfg, jnp.asarray(x), jnp.asarray(lengths))
    with torch.no_grad():
        ty, tlen = tfront.conv_frontend(module, torch.tensor(x), torch.tensor(lengths).long())
    np.testing.assert_array_equal(_np(tlen), np.asarray(jlen))
    np.testing.assert_allclose(_np(ty), np.asarray(jy), rtol=0, atol=1e-5)


def test_conv_attention_2d_matches_jax_in_jax_layout(flash_routes):
    """The (B, T, F, C) entry point of one block, flash route: atol 1e-5."""
    jcfg, params, state, module = _perturbed_frontend(((8, 3, 3), (8, 3, 3)))
    rng = np.random.RandomState(4)
    x = np.abs(rng.randn(2, 11, 5, 8)).astype(np.float32)
    kpm = np.arange(11)[None, :] >= np.array([11, 8])[:, None]
    flash_routes(True)
    jy, _ = jfront.conv_attention_2d(params["attn_2d"][0], state["attn_2d"][0], 2,
                                     jnp.asarray(x), key_padding_mask=jnp.asarray(kpm))
    with torch.no_grad():
        ty = tfront.conv_attention_2d(module.attn_2d[0], torch.tensor(x), torch.tensor(kpm))
    np.testing.assert_allclose(_np(ty), np.asarray(jy), rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# core: batch_norm's training form, layer_norm, positions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mean", [0.0, 30.0])
def test_batch_norm_training_form_matches_jax(mean):
    """One-pass training statistics (NHWC, channel last), with stats_from.
    Both sides compute var = E[x^2] - mean^2 in fp32 and sum in different
    orders, so they may disagree by up to the sum's rounding bound
    n * eps32 * E[x^2] in var (n values per channel). Tolerances follow
    from that bound: y at 1.5x it (|x - mean| <= 3 std here), the running
    variance at momentum * n/(n-1) times it, never below 1e-5; the means
    at 1e-5. mean 0 keeps the bound tiny; mean 30 (|mean| >> std, the
    ROADMAP Queue C hazard) makes it ~1e-2 in var."""
    rng = np.random.RandomState(5)
    x = (mean + rng.randn(4, 6, 5, 3)).astype(np.float32)
    stats = x[:, 1:5]
    p = {"scale": rng.uniform(0.5, 1.5, 3).astype(np.float32), "bias": rng.randn(3).astype(np.float32)}
    st = {"mean": rng.randn(3).astype(np.float32), "var": rng.uniform(0.5, 2, 3).astype(np.float32)}
    jy, jst = jcore.batch_norm(p, st, jnp.asarray(x), axis=(0, 1, 2), training=True,
                               stats_from=jnp.asarray(stats))
    ty, tmean, tvar = tcore.batch_norm(
        torch.tensor(x), torch.tensor(p["scale"]), torch.tensor(p["bias"]),
        torch.tensor(st["mean"]), torch.tensor(st["var"]), (0, 1, 2), True,
        stats_from=torch.tensor(stats),
    )
    n = stats.size // stats.shape[-1]
    var_bound = n * np.finfo(np.float32).eps * float(np.mean(stats.astype(np.float64) ** 2))
    y_atol = max(1.5 * var_bound, 1e-5)
    var_atol = max(0.1 * n / (n - 1) * var_bound, 1e-5)
    np.testing.assert_allclose(_np(ty), np.asarray(jy), rtol=0, atol=y_atol)
    np.testing.assert_allclose(_np(tmean), np.asarray(jst["mean"]), rtol=0, atol=1e-5)
    np.testing.assert_allclose(_np(tvar), np.asarray(jst["var"]), rtol=0, atol=var_atol)


def test_batch_norm_module_updates_running_stats_in_training():
    bn = tcore.BatchNorm(3).train()
    x = torch.randn(4, 3, 5, 6) * 2 + 1
    bn(x)
    _, mean, var = tcore.batch_norm(x, torch.ones(3), torch.zeros(3), torch.zeros(3),
                                    torch.ones(3), (0, 2, 3), True)
    torch.testing.assert_close(bn.running_mean, mean)
    torch.testing.assert_close(bn.running_var, var)


def test_layer_norm_and_activations_match_jax():
    """atol 1e-6: fp32 statistics, same formula."""
    rng = np.random.RandomState(6)
    x = (rng.randn(3, 4, 10) * 3 + 1).astype(np.float32)
    w, b = rng.randn(10).astype(np.float32), rng.randn(10).astype(np.float32)
    jy = jcore.layer_norm({"scale": jnp.asarray(w), "bias": jnp.asarray(b)}, jnp.asarray(x))
    ty = tcore.layer_norm(torch.tensor(x), torch.tensor(w), torch.tensor(b))
    np.testing.assert_allclose(_np(ty), np.asarray(jy), rtol=0, atol=1e-6)
    for name in ("relu", "gelu", "gelu_accurate", "tanh", "linear", "glu"):
        np.testing.assert_allclose(
            _np(tcore.get_activation(name)(torch.tensor(x))),
            np.asarray(jcore.get_activation(name)(jnp.asarray(x))), rtol=0, atol=1e-6,
        )


def test_dropout_uses_the_explicit_generator():
    x = torch.ones(1000)
    a = tcore.dropout(x, 0.25, torch.Generator().manual_seed(3), True)
    b = tcore.dropout(x, 0.25, torch.Generator().manual_seed(3), True)
    torch.testing.assert_close(a, b)
    assert set(a.unique().tolist()) <= {0.0, torch.tensor(1.0 / 0.75).item()}
    assert abs((a == 0).float().mean().item() - 0.25) < 0.05
    torch.testing.assert_close(tcore.dropout(x, 0.25, None, False), x)
    with pytest.raises(ValueError):
        tcore.dropout(x, 0.25, None, True)


def test_positions_match_jax():
    """Exact positions; tables at atol 1e-6."""
    np.testing.assert_allclose(
        _np(tpos.sinusoidal_table(40, 10, 1)), np.asarray(jpos.sinusoidal_table(40, 10, 1)),
        rtol=0, atol=1e-6,
    )
    ids = np.array([[2, 5, 6, 1, 1], [2, 7, 8, 9, 4]], np.int32)
    np.testing.assert_array_equal(
        _np(tpos.make_positions(torch.tensor(ids), 1)), np.asarray(jpos.make_positions(jnp.asarray(ids), 1))
    )
    lengths = np.array([5, 3], np.int32)
    np.testing.assert_array_equal(
        _np(tpos.token_positions_from_lengths(torch.tensor(lengths), 6, 0)),
        np.asarray(jpos.token_positions_from_lengths(jnp.asarray(lengths), 6, 0)),
    )
    tp = tpos.PositionalEmbedding(30, 8, 1, learned=False)
    jp = jpos.PositionalEmbedding(30, 8, 1, learned=False)
    np.testing.assert_allclose(_np(tp.from_ids(torch.tensor(ids), step=4)),
                               np.asarray(jp.from_ids({}, jnp.asarray(ids), step=4)), rtol=0, atol=1e-6)
    np.testing.assert_allclose(_np(tp.from_lengths(torch.tensor(lengths), 5)),
                               np.asarray(jp.from_lengths({}, jnp.asarray(lengths), 5)), rtol=0, atol=1e-6)
