"""PyTorch port, SpecAugment and TimeStretch against the JAX package.

The port splits each op into a draw and an apply (``ops/specaugment.py``).
Here JAX's own draws, replayed from the same keys as
``fbk_fairseq_st_tpu/ops/specaugment.py`` splits them, go through the
port's apply, and the outputs must equal JAX's exactly (atol 0: masks
zero-fill, and TimeStretch gathers frames by indices computed in float32
on both sides). The port's own draws are held to their distributions by
statistics over many utterances, and ``augment_batch`` to its order
(TimeStretch, then SpecAugment, from one generator)."""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fbk_fairseq_st_tpu.ops import specaugment as jsa
from fbk_fairseq_st_tpu_torch.data import Dictionary
from fbk_fairseq_st_tpu_torch.ops import specaugment as tsa
from fbk_fairseq_st_tpu_torch.tasks import SpeechRecognitionTask


def jax_specaugment_draws(key, b, tau, v, cfg):
    """JAX's SpecAugment draws for a (b, tau, v) batch, from its keys."""
    out = {k: [] for k in ("apply", "f_width", "f_start", "t_width", "t_start")}
    for key_b in jax.random.split(key, b):
        keys = jax.random.split(key_b, 1 + 2 * (cfg.frequency_masking_num + cfg.time_masking_num))
        out["apply"].append(bool(jax.random.uniform(keys[0]) < cfg.rate))
        ki, fw, fs, tw, ts = 1, [], [], [], []
        for _ in range(cfg.frequency_masking_num):
            f = int(jnp.floor(jax.random.uniform(keys[ki], maxval=float(cfg.frequency_masking_pars))))
            fw.append(f)
            fs.append(int(jax.random.randint(keys[ki + 1], (), 0, v - f + 1)))
            ki += 2
        for _ in range(cfg.time_masking_num):
            t = int(jnp.floor(jax.random.uniform(keys[ki], minval=1.0,
                                                 maxval=float(min(cfg.time_masking_pars, tau)))))
            tw.append(t)
            ts.append(int(jax.random.randint(keys[ki + 1], (), 0, tau - t + 1)))
            ki += 2
        for name, vals in (("f_width", fw), ("f_start", fs), ("t_width", tw), ("t_start", ts)):
            out[name].append(vals)
    return {k: torch.tensor(v) for k, v in out.items()}


def jax_time_stretch_draws(key, lengths, t, cfg):
    n_windows = (t + cfg.w - 1) // cfg.w
    apply, u = [], []
    for key_b, length in zip(jax.random.split(key, len(lengths)), lengths):
        k_apply, k_sizes = jax.random.split(key_b)
        apply.append(bool(jax.random.uniform(k_apply) < cfg.rate))
        low = jnp.where(length < 10, jnp.maximum(cfg.low, 1.0), cfg.low)
        u.append(np.asarray(jax.random.uniform(k_sizes, (n_windows,), minval=low, maxval=cfg.high)))
    return {"apply": torch.tensor(apply), "u": torch.tensor(np.stack(u))}


SPEC_CASES = {
    # (batch, tau, n_freq, config)
    "tau_above_time_pars": (4, 40, 16, jsa.SpecAugmentConfig()),
    "tau_below_time_pars": (4, 8, 16, jsa.SpecAugmentConfig(time_masking_pars=13)),
    "tau_1": (2, 1, 16, jsa.SpecAugmentConfig()),
    "rate_half_wide_masks": (8, 30, 12, jsa.SpecAugmentConfig(10, 20, 3, 3, 0.5)),
}


@pytest.mark.parametrize("case", sorted(SPEC_CASES))
def test_specaugment_apply_equals_jax_given_its_draws(case):
    b, tau, v, cfg = SPEC_CASES[case]
    key = jax.random.PRNGKey(7)
    x = np.random.RandomState(0).randn(b, tau, v).astype(np.float32) + 3.0  # no frame is 0 by chance
    want = np.asarray(jsa.specaugment(key, jnp.asarray(x), cfg))
    draws = jax_specaugment_draws(key, b, tau, v, cfg)
    got = tsa.specaugment_apply(torch.tensor(x), draws)
    np.testing.assert_array_equal(got.numpy(), want)
    if case == "rate_half_wide_masks":
        assert 0 < int(draws["apply"].sum()) < b  # both branches taken


STRETCH_CASES = {
    # (lengths, T, F, config)
    "w1": ([40, 33, 21, 12], 40, 6, jsa.TimeStretchConfig()),
    "w3_short_under_10": ([30, 9, 4, 27], 30, 5, jsa.TimeStretchConfig(w=3)),
    "w5_rate_half": ([50, 44, 13, 7, 50, 31], 50, 4, jsa.TimeStretchConfig(rate=0.5, w=5, low=0.6, high=1.4)),
    "w8_stretch_past_buffer": ([16, 16, 15], 16, 3, jsa.TimeStretchConfig(w=8, low=1.2, high=1.25)),
}


@pytest.mark.parametrize("case", sorted(STRETCH_CASES))
def test_time_stretch_apply_equals_jax_given_its_draws(case):
    lengths, t, f, cfg = STRETCH_CASES[case]
    key = jax.random.PRNGKey(11)
    x = np.random.RandomState(1).randn(len(lengths), t, f).astype(np.float32)
    lengths = np.array(lengths, np.int32)
    want_x, want_len = jsa.time_stretch(key, jnp.asarray(x), jnp.asarray(lengths), cfg)
    draws = jax_time_stretch_draws(key, lengths, t, cfg)
    got_x, got_len = tsa.time_stretch_apply(torch.tensor(x), torch.tensor(lengths).long(), draws, cfg)
    np.testing.assert_array_equal(got_x.numpy(), np.asarray(want_x))
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    if case == "w5_rate_half":
        assert 0 < int(draws["apply"].sum()) < len(lengths)
    if case == "w8_stretch_past_buffer":  # stretched past the buffer: cut at T
        assert (np.asarray(want_len) == t).all()


def test_specaugment_draws_follow_their_distributions():
    """Over 20,000 utterances: the apply share within 4 sigma of the rate;
    widths in [0, F_para) and [1, min(T_para, tau)) with the uniform's
    mean within 4 sigma; every mask inside the spectrogram; starts
    uniform over the positions they may take (mean within 4 sigma)."""
    n, tau, v = 20000, 50, 80
    cfg = tsa.SpecAugmentConfig(frequency_masking_pars=13, time_masking_pars=20, rate=0.7)
    d = tsa.specaugment_draws(torch.Generator().manual_seed(0), n, tau, v, cfg)
    sigma = (0.7 * 0.3 / n) ** 0.5
    assert abs(d["apply"].float().mean().item() - 0.7) < 4 * sigma
    for width, start, lo, hi, size in ((d["f_width"], d["f_start"], 0, 13, v), (d["t_width"], d["t_start"], 1, 20, tau)):
        assert int(width.min()) == lo and int(width.max()) == hi - 1
        assert int(start.min()) >= 0 and bool(((start + width) <= size).all())
        k = hi - lo  # uniform over lo .. hi - 1
        w_sigma = ((k * k - 1) / 12 / width.numel()) ** 0.5
        assert abs(width.float().mean().item() - (lo + hi - 1) / 2) < 4 * w_sigma
        # given the width, the start is uniform over 0 .. size - width
        rel = (start.float() + 0.5) / (size - width + 1).float()
        assert abs(rel.mean().item() - 0.5) < 4 * (1 / 12 / rel.numel()) ** 0.5
    tight = tsa.specaugment_draws(torch.Generator().manual_seed(1), 1000, 5, v, cfg)
    assert int(tight["t_width"].max()) <= 4 and bool(((tight["t_start"] + tight["t_width"]) <= 5).all())


def test_time_stretch_draws_follow_their_distributions():
    """u uniform on [low, high), low clamped to 1.0 under 10 frames (mean
    within 4 sigma); the apply share within 4 sigma of the rate."""
    lengths = torch.tensor([50] * 3000 + [8] * 3000)
    cfg = tsa.TimeStretchConfig(rate=0.4, w=2, low=0.8, high=1.25)
    d = tsa.time_stretch_draws(torch.Generator().manual_seed(0), lengths, 50, cfg)
    assert d["u"].shape == (6000, 25) and d["u"].dtype == torch.float32
    for rows, low in ((slice(0, 3000), 0.8), (slice(3000, 6000), 1.0)):
        u = d["u"][rows]
        assert float(u.min()) >= low and float(u.max()) < 1.25
        sigma = ((1.25 - low) ** 2 / 12 / u.numel()) ** 0.5
        assert abs(u.mean().item() - (low + 1.25) / 2) < 4 * sigma
    assert abs(d["apply"].float().mean().item() - 0.4) < 4 * (0.24 / 6000) ** 0.5


def _task(**flags):
    args = argparse.Namespace(data="", target_lang=None, **flags)
    return SpeechRecognitionTask(args, Dictionary())


def test_augment_batch_stretches_then_masks():
    """``augment_batch`` with both on equals TimeStretch's draw and apply,
    then SpecAugment's, from the same generator in that order (exactly),
    and updates ``src_lengths``; with neither on it is the identity."""
    rng = np.random.RandomState(2)
    batch = {"src_tokens": torch.tensor(rng.randn(6, 40, 10).astype(np.float32)),
             "src_lengths": torch.tensor([40, 38, 30, 22, 9, 5]), "target": torch.zeros(6, 3)}
    flags = dict(specaugment=True, specaugment_rate=0.8, frequency_masking_pars=4, time_masking_pars=6,
                 frequency_masking_num=2, time_masking_num=2, time_stretch=True, time_stretch_rate=0.9,
                 time_stretch_w=2, time_stretch_low=0.8, time_stretch_high=1.25)
    task = _task(**flags)
    got = task.augment_batch(batch, torch.Generator().manual_seed(5))
    gen = torch.Generator().manual_seed(5)
    x, lengths = tsa.time_stretch(gen, batch["src_tokens"], batch["src_lengths"], task.time_stretch_cfg)
    x = tsa.specaugment(gen, x, task.specaugment_cfg)
    assert torch.equal(got["src_tokens"], x) and torch.equal(got["src_lengths"], lengths)
    assert not torch.equal(lengths, batch["src_lengths"])
    assert got["target"] is batch["target"]
    assert _task().augment_batch(batch, torch.Generator()) is batch


def test_jax_defaults_of_the_options():
    from fbk_fairseq_st_tpu.tasks.speech_recognition import SpeechRecognitionTask as JaxTask

    jparser, tparser = argparse.ArgumentParser(), argparse.ArgumentParser()
    JaxTask.add_args(jparser)
    SpeechRecognitionTask.add_args(tparser)
    want, got = vars(jparser.parse_args(["d"])), vars(tparser.parse_args(["d"]))
    for name in ("specaugment", "specaugment_rate", "frequency_masking_pars", "time_masking_pars",
                 "frequency_masking_num", "time_masking_num", "time_stretch", "time_stretch_rate", "time_stretch_w",
                 "time_stretch_low", "time_stretch_high"):
        assert got[name] == want[name], name
    assert got == want
