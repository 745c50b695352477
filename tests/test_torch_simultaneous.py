"""PyTorch port, simultaneous translation: the latency metrics and the
latency loss, monotonic multihead attention for the three --simul-types,
the monotonic and unidirectional transformers, the latency-augmented
criterion and its gradients against the JAX package on the same numpy
inputs, on the CPU (the agent and cli/simul_eval:
tests/test_torch_simul_eval.py).

Tiny widths (2 + 2 layers, 16 wide, 2 heads); JAX's weights are drawn in
the shapes of ``jax.eval_shape(model.init)`` and its forwards and
gradients jitted; fp32 with JAX's matmuls pinned to fp32
(tests/conftest.py). Sources are padded on the left, as the translation
task pads them. Tolerances are stated per test."""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fbk_fairseq_st_tpu import registry
from fbk_fairseq_st_tpu.criterions.latency_augmented import (
    LatencyAugmentedLabelSmoothedCrossEntropyCriterion as JaxLatencyCriterion,
)
from fbk_fairseq_st_tpu.generation import simultaneous_decoder as jsd
from fbk_fairseq_st_tpu.ops import latency as jlat
from fbk_fairseq_st_tpu_torch import models as tmodels
from fbk_fairseq_st_tpu_torch import options as toptions
from fbk_fairseq_st_tpu_torch.criterions import CRITERIONS
from fbk_fairseq_st_tpu_torch.generation import simultaneous_decoder as tsd
from fbk_fairseq_st_tpu_torch.models import transformer_monotonic as ttm
from fbk_fairseq_st_tpu_torch.ops import latency as tlat
from fbk_fairseq_st_tpu_torch.ops import monotonic_attention as tmma
from fbk_fairseq_st_tpu_torch.utils.weights import state_dict_from_jax

from .test_torch_model import random_variables, torch_dictionary
from .utils import dummy_dictionary, model_args

VOCAB = 24
PAD, EOS = 1, 2
TINY = dict(encoder_layers=2, decoder_layers=2, encoder_embed_dim=16, decoder_embed_dim=16,
            encoder_ffn_embed_dim=32, decoder_ffn_embed_dim=32, encoder_attention_heads=2,
            decoder_attention_heads=2, max_source_positions=64, max_target_positions=64)
SIMUL = {"hard_aligned": dict(simul_type="hard_aligned"),
         "infinite_lookback": dict(simul_type="infinite_lookback", energy_bias=True),
         "waitk": dict(simul_type="waitk", waitk_lagging=3)}
# energies pushed to saturation: sigmoid(e) is exactly 1.0 in fp32 for e > ~17
SATURATED = dict(simul_type="infinite_lookback", energy_bias=True, energy_bias_init=16.7)
LATENCY = dict(label_smoothing=0.1, latency_weight_avg=0.1, latency_weight_var=0.1,
               latency_weight_avg_type="differentiable_average_lagging", latency_weight_var_type="variance_delay",
               average_method="weighted_average", mass_preservation=True, sentence_avg=False)


class _Task:
    def __init__(self, d):
        self.source_dictionary = d
        self.target_dictionary = d


_PAIRS = {}


def _build_pair(name, arch="transformer_monotonic", over=None, layers=2):
    """JAX's model with seeded weights (eval_shape) and the port's loaded
    from them, once a case for the module."""
    key = (name, layers)
    if key not in _PAIRS:
        over = SIMUL[name] if over is None else over
        over = {**over, "encoder_layers": layers, "decoder_layers": layers}
        args = model_args(arch, **{**TINY, **over})
        registry.apply_architecture(args)
        jmodel = registry.build_model(args, _Task(dummy_dictionary(VOCAB)))
        variables = random_variables(jmodel, 0)
        if over.get("energy_bias_init"):
            for layer in variables["params"]["decoder"]["layers"]:
                layer["encoder_attn"]["energy_bias"] = np.full((1,), over["energy_bias_init"], np.float32)
        td = torch_dictionary(VOCAB)
        tmodel = tmodels.build_model(arch, td, td, device="cpu", **{**TINY, **over})
        tmodel.load_state_dict(state_dict_from_jax(variables), strict=True)
        _PAIRS[key] = (jmodel, variables, tmodel)
    return _PAIRS[key]


def _batch(seed=0, b=3, s=9, t=6):
    """Sources of lengths s, s - 3, s - 5 padded on the left; targets padded
    on the right."""
    rng = np.random.RandomState(seed)
    lengths = np.array([s, s - 3, s - 5][:b], np.int64)
    src = np.full((b, s), PAD, np.int64)
    for i, n in enumerate(lengths):
        src[i, s - n:] = rng.randint(4, VOCAB, size=n)
        src[i, -1] = EOS
    target = rng.randint(4, VOCAB, size=(b, t))
    target[-1, -2:] = PAD
    prev = np.concatenate([np.full((b, 1), EOS), target[:, :-1]], axis=1)
    prev[-1, -1] = PAD
    return {"src_tokens": src, "src_lengths": lengths, "prev_output_tokens": prev, "target": target}


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.tensor(v) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# latency metrics
# ---------------------------------------------------------------------------

def _delays(seed, b=3, t=7, hl=None):
    rng = np.random.RandomState(seed)
    shape = (b, t) if hl is None else (b, hl, t)
    delays = np.sort(rng.uniform(0, 9, size=shape), axis=-1).astype(np.float32)
    src_lens = np.array([[9.0], [6.0], [4.0]], np.float32)[:b]
    mask = np.zeros((b, t), bool)
    mask[1, -2:] = True
    mask[2, -4:] = True
    return delays, src_lens, mask


@pytest.mark.parametrize("start_from_zero", [True, False])
@pytest.mark.parametrize("metric", sorted(tlat.METRICS))
def test_latency_metrics_match_jax(metric, start_from_zero):
    """AP, AL and DAL with and without a target pad mask, within 1e-6."""
    delays, src_lens, mask = _delays(1)
    for m in (None, mask):
        want = getattr(jlat, metric)(jnp.asarray(delays), jnp.asarray(src_lens),
                                     None if m is None else jnp.asarray(m), start_from_zero)
        got = getattr(tlat, metric)(torch.tensor(delays), torch.tensor(src_lens),
                                    None if m is None else torch.tensor(m), start_from_zero)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


def test_variance_delay_and_expected_delays_match_jax():
    """variance_delay over heads x layers and the expected delays of
    alignments (stay_on_last_token both ways), within 1e-6."""
    delays, src_lens, mask = _delays(2, hl=4)
    for m in (None, mask):
        want = jlat.variance_delay(jnp.asarray(delays), jnp.asarray(src_lens), None if m is None else jnp.asarray(m))
        got = tlat.variance_delay(torch.tensor(delays), torch.tensor(src_lens), None if m is None else torch.tensor(m))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    rng = np.random.RandomState(3)
    att = [rng.dirichlet(np.ones(9), size=(3, 2, 7)).astype(np.float32) for _ in range(2)]
    spm = np.zeros((3, 9), bool)
    spm[1, :3] = True
    for stay in (True, False):
        want = jlat.expected_delays_from_attention([jnp.asarray(a) for a in att], jnp.asarray(spm),
                                                   jnp.asarray(mask), stay)
        got = tlat.expected_delays_from_attention([torch.tensor(a) for a in att], torch.tensor(spm),
                                                  torch.tensor(mask), stay)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-6)


@pytest.mark.parametrize("method", ["average", "weighted_average", "max"])
def test_latency_training_loss_matches_jax(method):
    """The latency loss for each average method and avg type, within 1e-6
    of its size (1e-6 relative)."""
    rng = np.random.RandomState(4)
    att = [rng.dirichlet(np.ones(9), size=(3, 2, 7)).astype(np.float32) for _ in range(2)]
    _, _, mask = _delays(1)
    spm = np.zeros((3, 9), bool)
    spm[2, :5] = True
    for avg_type in sorted(tlat.METRICS):
        kw = dict(avg_weight=0.1, var_weight=0.2, avg_type=avg_type, average_method=method)
        want = float(jlat.latency_training_loss([jnp.asarray(a) for a in att], jnp.asarray(spm), jnp.asarray(mask),
                                                **kw))
        got = float(tlat.latency_training_loss([torch.tensor(a) for a in att], torch.tensor(spm), torch.tensor(mask),
                                               **kw))
        assert abs(got - want) <= 1e-6 * max(1.0, abs(want)), (avg_type, got, want)


def test_agent_latency_metrics_match_jax():
    """The agent's AP / AL / DAL of a delay list (delays past the source
    clipped), within 1e-6."""
    delays = np.array([2, 2, 3, 5, 7, 8, 8], np.float32)
    for src_len in (5, 8, 12):
        want, got = jsd.latency_metrics(delays, src_len), tsd.latency_metrics(delays, src_len)
        for key in want:
            assert abs(got[key] - want[key]) <= 1e-6, (key, got[key], want[key])


# ---------------------------------------------------------------------------
# monotonic attention and the models
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(SIMUL))
def test_monotonic_model_matches_jax(name):
    """Logits within 1e-4, and each layer's p_choose, alpha and beta within
    1e-5, in fp32, for each --simul-type; the encoder states at the real
    source rows (a left-padded row whose causal prefix is all padding has
    no key: the flash route and JAX's dense route differ there) within 1e-4."""
    jmodel, variables, tmodel = _build_pair(name)
    batch = _batch()
    (jlogits, jextra) = jax.jit(lambda v, b: jmodel.forward(v, b)[0])(variables, _jax(batch))
    with torch.no_grad():
        tlogits, textra = tmodel(_torch(batch))
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), rtol=0, atol=1e-4)
    real = batch["src_tokens"] != PAD
    np.testing.assert_allclose(textra["encoder_out"].encoder_out.numpy()[real],
                               np.asarray(jextra["encoder_out"].encoder_out)[real], rtol=0, atol=1e-4)
    assert len(textra["attn_list"]) == len(jextra["attn_list"]) == TINY["decoder_layers"]
    for t_item, j_item in zip(textra["attn_list"], jextra["attn_list"]):
        for key in ("p_choose", "alpha", "beta"):
            np.testing.assert_allclose(t_item[key].numpy(), np.asarray(j_item[key]), rtol=0, atol=1e-5,
                                       err_msg=f"{name} {key}")
    alpha = textra["attn_list"][0]["alpha"].numpy()
    np.testing.assert_allclose(alpha.sum(-1), np.ones(alpha.shape[:-1]), atol=1e-4)


def test_unidirectional_encoder_is_causal_and_matches_jax():
    """transformer_unidirectional: the logits of JAX's within 1e-4 (real
    source rows' states too), and a later source token leaves earlier
    states unchanged."""
    jmodel, variables, tmodel = _build_pair("unidirectional", "transformer_unidirectional", {})
    batch = _batch(5)
    (jlogits, jextra) = jax.jit(lambda v, b: jmodel.forward(v, b)[0])(variables, _jax(batch))
    with torch.no_grad():
        tlogits, textra = tmodel(_torch(batch))
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), rtol=0, atol=1e-4)
        real = batch["src_tokens"] != PAD
        np.testing.assert_allclose(textra["encoder_out"].encoder_out.numpy()[real],
                                   np.asarray(jextra["encoder_out"].encoder_out)[real], rtol=0, atol=1e-4)
        src = torch.full((1, 6), 5, dtype=torch.int64)
        src2 = src.clone()
        src2[0, -1] = 9
        a = tmodel.encode(src, torch.tensor([6])).encoder_out
        b = tmodel.encode(src2, torch.tensor([6])).encoder_out
    torch.testing.assert_close(a[:, :5], b[:, :5], rtol=0, atol=1e-6)
    assert not torch.allclose(a[:, 5], b[:, 5])


def _criteria(over):
    args = argparse.Namespace(**LATENCY, **over)
    d = dummy_dictionary(VOCAB)
    return JaxLatencyCriterion(_Task(d), args), CRITERIONS["latency_augmented_label_smoothed_cross_entropy"](
        _Task(torch_dictionary(VOCAB)), args)


@pytest.mark.parametrize("name", sorted(SIMUL) + ["saturated"])
def test_latency_augmented_loss_and_gradients_match_jax(name):
    """One-layer models: the latency-augmented criterion's loss within 1e-4 and every
    parameter's gradient within 1e-4 x the largest |grad| of any (the key
    biases' gradients are 0 up to rounding) (eval mode: no noise,
    no dropout). ``saturated``: energies of 16.7 +- a little, so that many
    p_choose are exactly 1.0 in fp32, where JAX's clips split the gradient
    at a bound and torch.clamp would not."""
    over = SATURATED if name == "saturated" else SIMUL[name]
    jmodel, variables, tmodel = _build_pair(name, over=over, layers=1)
    jcrit, tcrit = _criteria(over)
    batch = _batch(7)

    batch_j = _jax(batch)
    want_loss, want_grads = jax.jit(jax.value_and_grad(
        lambda p: jcrit(jmodel, {"params": p, "state": {}}, batch_j, training=False)[0]))(variables["params"])
    tmodel.zero_grad()
    loss, _, _ = tcrit(tmodel, _torch(batch), None, training=False)
    loss.backward()
    assert abs(loss.item() - float(want_loss)) <= 1e-4, (loss.item(), float(want_loss))
    want = state_dict_from_jax({"params": jax.tree_util.tree_map(np.asarray, want_grads)})
    scale = max(float(g.abs().max()) for g in want.values())
    for pname, p in tmodel.named_parameters():
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        err = float((g - want[pname]).abs().max())
        assert err <= 1e-4 * scale, (pname, err, scale)
    if name == "saturated":
        with torch.no_grad():
            _, extra = tmodel(_torch(batch))
        pc = torch.cat([item["p_choose"].reshape(-1) for item in extra["attn_list"]])
        saturated = float((pc == 1.0).float().mean())
        assert 0.1 < saturated < 0.95, saturated


def test_clip_gradient_splits_at_the_bounds_as_jax():
    """``_clip``'s gradient is JAX's at (0, 0.5, 1) in [0, 1]: halved at
    each bound. ``expected_alignment_train``'s gradient equals JAX's
    (within 1e-5) at p_choose with exact 0s and 1s: without mass
    preservation everywhere; with it at the target steps whose alignment
    mass (the sum the preservation clips at 1) is the same fp32 value on
    both sides. Behind a p_choose of 1 that sum lies within an ulp of the
    bound, where the clip's gradient is 1, 1/2 or 0 by the last bit of
    alpha (exp and log round differently in XLA and in torch), and each
    step's gradient reaches the row's earlier steps: a row with such a
    step is left out (here 1 of 4)."""
    x = torch.tensor([0.0, 0.5, 1.0], requires_grad=True)
    tmma._clip(x, 0.0, 1.0).sum().backward()
    want = jax.grad(lambda v: jnp.clip(v, 0.0, 1.0).sum())(jnp.asarray([0.0, 0.5, 1.0]))
    np.testing.assert_array_equal(x.grad.numpy(), np.asarray(want))
    from fbk_fairseq_st_tpu.ops.monotonic_attention import expected_alignment_train as jeat

    rng = np.random.RandomState(8)
    pc = rng.uniform(0.05, 0.95, size=(4, 5, 7)).astype(np.float32)
    pc[:, :, 2] = 1.0
    pc[1, :, :2] = 0.0
    w = rng.randn(4, 5, 7).astype(np.float32)
    sums = [np.asarray(jax.jit(lambda p: jnp.sum(jeat(p, 1e-6, False)[..., :-1], axis=-1))(jnp.asarray(pc))),
            tmma.expected_alignment_train(torch.tensor(pc), 1e-6, False)[..., :-1].sum(-1).numpy()]
    # the steps of one row chain through alpha: a row is kept whole or not
    same = (sums[0] == sums[1]).all(axis=-1)
    for mass in (False, True):
        want = np.asarray(jax.jit(jax.grad(lambda p: jnp.sum(jeat(p, 1e-6, mass) * w)))(jnp.asarray(pc)))
        t = torch.tensor(pc, requires_grad=True)
        (tmma.expected_alignment_train(t, 1e-6, mass) * torch.tensor(w)).sum().backward()
        keep = same if mass else np.ones_like(same)
        np.testing.assert_allclose(t.grad.numpy()[keep], want[keep], rtol=1e-5, atol=1e-5)
    assert same.sum() >= same.size - 1, sums


def test_presets_and_registry():
    """The six preset names build and carry JAX's widths; the criterion is
    registered; the en_fr preset is the core en_fr big's (the reference's
    calls itself)."""
    for arch, (dim, heads) in {"transformer_monotonic": (512, 8), "transformer_monotonic_iwslt_de_en": (512, 4),
                               "transformer_monotonic_vaswani_wmt_en_de_big": (1024, 16),
                               "transformer_monotonic_vaswani_wmt_en_fr_big": (1024, 16),
                               "transformer_unidirectional": (512, 8),
                               "transformer_unidirectional_iwslt_de_en": (512, 4)}.items():
        d = tmodels.arch_defaults(arch)
        args = model_args(arch)
        if arch in registry.ARCHITECTURES:
            registry.apply_architecture(args)
        else:  # JAX's bare model name: its build_model applies the base preset
            from fbk_fairseq_st_tpu.models.transformer import base_architecture
            base_architecture(args)
        for key in ("encoder_embed_dim", "encoder_attention_heads", "decoder_ffn_embed_dim", "dropout",
                    "encoder_layers", "decoder_layers"):
            assert d[key] == getattr(args, key), (arch, key)
        assert (d["encoder_embed_dim"], d["encoder_attention_heads"]) == (dim, heads)
    assert tmodels.arch_defaults("transformer_monotonic_vaswani_wmt_en_fr_big")["dropout"] == 0.1
    assert "latency_augmented_label_smoothed_cross_entropy" in CRITERIONS


def test_monotonic_flags_parse_like_jax():
    """--simul-type, --no-mass-preservation, --energy-bias and the
    criterion's flags parse into the namespace the model and criterion read."""
    parser = toptions.get_training_parser(default_task="translation")
    args = toptions.parse_args_and_arch(parser, [
        "data", "--arch", "transformer_monotonic", "--simul-type", "waitk", "--waitk-lagging", "2",
        "--no-mass-preservation", "--energy-bias", "--noise-var", "2.0",
        "--criterion", "latency_augmented_label_smoothed_cross_entropy", "--latency-weight-avg", "0.1"])
    cfg = ttm.mono_cfg_from_args(args)
    assert (cfg.simul_type, cfg.waitk_lagging, cfg.mass_preservation, cfg.energy_bias, cfg.noise_var) == (
        "waitk", 2, False, True, 2.0)
    assert args.latency_weight_avg == 0.1 and args.average_method == "weighted_average"
    with pytest.raises(SystemExit):
        toptions.parse_args_and_arch(toptions.get_training_parser(), ["data", "--arch", "transformer_monotonic",
                                                                      "--simul-type", "bogus"])
