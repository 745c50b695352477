"""PyTorch port, the multi-decoder family: the triangle layer, the
dual-decoder / triangle / 2-stage models, their presets and weights,
``cross_entropy_dualdecoder`` and whole train steps against the JAX package
on the same numpy inputs, on the CPU.

The models are the tiny configs of tests/test_multitask_models.py (2+2
layers, width 16, 2 heads, 8 mels, source dictionary 10, target
dictionary 24), built once per arch for the file; the JAX side's init and
forwards run under ``jax.jit``. The port runs its plain PyTorch versions
(CPU tensors), everything in fp32. Tolerances are stated per test."""

import argparse
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fbk_fairseq_st_tpu import options, registry
from fbk_fairseq_st_tpu.criterions import cross_entropy_dualdecoder as jcrit
from fbk_fairseq_st_tpu.ops import attention as jattn
from fbk_fairseq_st_tpu.ops import transformer_layer as jtl
from fbk_fairseq_st_tpu.train.trainer import Trainer as JaxTrainer
from fbk_fairseq_st_tpu.utils.fairseq_interop import export_parameters
from fbk_fairseq_st_tpu_torch.criterions import CRITERIONS, CrossEntropyDualDecoder
from fbk_fairseq_st_tpu_torch.models import ARCHITECTURES, arch_defaults
from fbk_fairseq_st_tpu_torch.models import multi_task as tmt
from fbk_fairseq_st_tpu_torch.ops import attention as tattn
from fbk_fairseq_st_tpu_torch.ops import transformer_layer as ttl
from fbk_fairseq_st_tpu_torch.tasks import TASKS, SpeechTranslationDualDecodingTask
from fbk_fairseq_st_tpu_torch.train import Trainer
from fbk_fairseq_st_tpu_torch.utils.weights import state_dict_from_jax

from .test_torch_ctc import _Recorder
from .test_torch_model import jax_init, shared_root, torch_dictionary  # noqa: F401  (shared_root: the fixture)
from .utils import DummyTask, dummy_dictionary, model_args

ARCHS = ["conv_transformer_dualdecoder", "conv_transformer_triangle", "conv_transformer_2stage"]
SRC_VOCAB, TGT_VOCAB = 10, 24
SMALL = dict(
    encoder_layers=2,
    decoder_layers=2,
    encoder_embed_dim=16,
    decoder_embed_dim=16,
    encoder_ffn_embed_dim=32,
    decoder_ffn_embed_dim=32,
    encoder_attention_heads=2,
    decoder_attention_heads=2,
    encoder_convolutions="[(4,3,3)]*2",
    input_feat_per_channel=8,
    max_source_positions=64,
    max_target_positions=32,
)
# the triangle layer's leaves, whose names the JAX export does not translate
EXPORT_DEPARTURES = ("aux_decoder_attn.", "aux_decoder_attn_ln.", "aux_decoder_attn_layer_norm.")


def _np(x):
    return np.asarray(x.detach()) if isinstance(x, torch.Tensor) else np.asarray(x)


def _jax_task():
    return DummyTask(dummy_dictionary(TGT_VOCAB), dummy_dictionary(SRC_VOCAB))


def build_pair(arch):
    """(JAX model, its variables as numpy, the port's model with them)."""
    args = model_args(arch, **SMALL)
    registry.apply_architecture(args)
    jmodel = registry.build_model(args, _jax_task())
    variables = jax_init(jmodel, 0, "multi_task_" + arch)
    tmodel = tmt.build_model(arch, torch_dictionary(TGT_VOCAB), torch_dictionary(SRC_VOCAB), device="cpu", **SMALL)
    tmodel.load_state_dict(state_dict_from_jax(variables), strict=True)
    return jmodel, variables, tmodel


@functools.lru_cache(maxsize=None)
def built(arch):
    """``build_pair(arch)``, once for the file."""
    return build_pair(arch)


@pytest.fixture
def flash_routes():
    def set_both(enabled):
        jattn.set_flash_attention(enabled)
        tattn.set_flash_attention(enabled)
    yield set_both
    jattn.set_flash_attention(None)
    tattn.set_flash_attention(None)


def dual_batch(seed=0, b=3, t=29, tgt_len=6, tr_len=5):
    """Unequal source lengths; padded target and transcript tails."""
    rng = np.random.RandomState(seed)
    lengths = np.array([t, t - 6, t - 11][:b], np.int32)
    tgt = rng.randint(4, 4 + TGT_VOCAB, size=(b, tgt_len)).astype(np.int32)
    tgt[-1, -2:] = 1
    tr = rng.randint(4, 4 + SRC_VOCAB, size=(b, tr_len)).astype(np.int32)
    tr_lengths = np.array([tr_len, tr_len - 1, tr_len - 2][:b], np.int32)
    tr[np.arange(tr_len)[None, :] >= tr_lengths[:, None]] = 1
    prev = lambda x: np.concatenate([np.full((b, 1), 2, np.int32), x[:, :-1]], axis=1)  # noqa: E731
    return {
        "net_input": {
            "src_tokens": rng.randn(b, t, SMALL["input_feat_per_channel"]).astype(np.float32),
            "src_lengths": lengths,
            "prev_output_tokens": prev(tgt),
            "transcript_prev_output_tokens": prev(tr),
        },
        "target": tgt,
        "transcript_target": tr,
        "transcript_target_lengths": tr_lengths,
        "ntokens": int((tgt != 1).sum()),
        "nsentences": b,
    }


def _flat(sample):
    rest = {k: v for k, v in sample.items() if k not in ("net_input", "ntokens", "nsentences")}
    return {**sample["net_input"], **rest}


def _torch_batch(sample):
    return {k: torch.tensor(v) if v.dtype == np.float32 else torch.tensor(v).long() for k, v in _flat(sample).items()}


# ---------------------------------------------------------------------------
# the triangle layer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("normalize_before", [True, False])
def test_triangle_layer_matches_jax(normalize_before):
    """``TriangleDecoderLayer`` against ``triangle_decoder_layer`` on the
    same weights, atol 1e-5: the full sequence (causal, pad keys masked in
    the self-, encoder and auxiliary attentions), then a cached step at a
    time over the same tokens, whose caches hold ``self``, ``cross`` and
    ``aux``. Post-norm runs ``aux_decoder_attn_layer_norm``."""
    jcfg = jtl.TransformerLayerConfig(embed_dim=16, ffn_dim=32, num_heads=2, dropout=0.0,
                                      normalize_before=normalize_before)
    tcfg = ttl.TransformerLayerConfig(embed_dim=16, ffn_dim=32, num_heads=2, dropout=0.0,
                                      normalize_before=normalize_before)
    params = jax.tree_util.tree_map(np.asarray, jtl.init_triangle_decoder_layer(jax.random.PRNGKey(3), jcfg))
    holder = torch.nn.Module()
    holder.layers = torch.nn.ModuleList([ttl.TriangleDecoderLayer(tcfg)])
    holder.load_state_dict(state_dict_from_jax({"params": {"layers": [params]}}), strict=True)
    layer = holder.layers[0].eval()

    rng = np.random.RandomState(4)
    b, t, s, s_aux = 2, 5, 7, 4
    x = rng.randn(b, t, 16).astype(np.float32)
    enc = rng.randn(b, s, 16).astype(np.float32)
    aux = rng.randn(b, s_aux, 16).astype(np.float32)
    enc_mask = np.arange(s)[None, :] >= np.array([s, s - 3])[:, None]
    aux_mask = np.arange(s_aux)[None, :] >= np.array([s_aux, s_aux - 2])[:, None]
    self_mask = np.zeros((b, t), bool)
    self_mask[1, -1] = True
    want = jax.jit(lambda *a: jtl.triangle_decoder_layer(
        params, jcfg, a[0], encoder_out=a[1], encoder_padding_mask=a[2], aux_decoder_out=a[3],
        aux_decoder_padding_mask=a[4], self_attn_mask="causal", self_attn_padding_mask=a[5])[0])(
        *map(jnp.asarray, (x, enc, enc_mask, aux, aux_mask, self_mask)))
    T = torch.tensor
    with torch.no_grad():
        got = layer(T(x), encoder_out=T(enc), encoder_padding_mask=T(enc_mask), aux_decoder_out=T(aux),
                    aux_decoder_padding_mask=T(aux_mask), self_attn_mask="causal", self_attn_padding_mask=T(self_mask))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0, atol=1e-5)

    jcache = jtl.init_triangle_decoder_layer_cache(params, jcfg, b, t, jnp.asarray(enc), jnp.asarray(aux))
    jstep = jax.jit(lambda xi, cache, i: jtl.triangle_decoder_layer(
        params, jcfg, xi, encoder_padding_mask=jnp.asarray(enc_mask), aux_decoder_padding_mask=jnp.asarray(aux_mask),
        cache=cache, cache_index=i)[::2])
    with torch.no_grad():
        tcache = ttl.init_triangle_decoder_layer_cache(layer, b, t, T(enc), T(aux))
        assert sorted(tcache) == sorted(jcache) == ["aux", "cross", "self"]
        for i in range(t):
            jy, jcache = jstep(jnp.asarray(x[:, i:i + 1]), jcache, i)
            ty = layer(T(x[:, i:i + 1]), encoder_padding_mask=T(enc_mask), aux_decoder_padding_mask=T(aux_mask),
                       cache=tcache, cache_index=i)
            np.testing.assert_allclose(_np(ty), np.asarray(jy), rtol=0, atol=1e-5, err_msg=f"step {i}")
    # without self pads the step equals the full sequence's row
    np.testing.assert_allclose(_np(ty)[0], _np(got)[0, -1:], rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,route", [(arch, "dense") for arch in ARCHS] + [("conv_transformer_triangle", "flash")])
def test_teacher_forced_logits_match_jax(arch, route, flash_routes):
    """Target and auxiliary logits of each arch in eval mode at atol 1e-4,
    and the encoder output, on the dense route; and on the flash route for
    the triangle, whose every attention but the encoder's is a decoder's
    (JAX's Pallas kernel in interpret mode, the port's plain version). The
    auxiliary logits cover the source dictionary."""
    jmodel, variables, tmodel = built(arch)
    sample = dual_batch()
    flash_routes(route == "flash")
    ((jdec, jaux), _) = jax.jit(lambda v, b: jmodel.forward(v, b, training=False))(
        variables, {k: jnp.asarray(v) for k, v in sample["net_input"].items()})
    with torch.no_grad():
        tdec, taux = tmodel(_torch_batch(sample))
    assert taux[0].shape[-1] == len(torch_dictionary(SRC_VOCAB)) and tdec[0].shape[-1] == len(
        torch_dictionary(TGT_VOCAB))
    np.testing.assert_allclose(_np(tdec[1]["encoder_out"].encoder_out),
                               np.asarray(jdec[1]["encoder_out"].encoder_out), rtol=0, atol=1e-4)
    np.testing.assert_allclose(_np(tdec[0]), np.asarray(jdec[0]), rtol=0, atol=1e-4, err_msg="target logits")
    np.testing.assert_allclose(_np(taux[0]), np.asarray(jaux[0]), rtol=0, atol=1e-4, err_msg="aux logits")


@pytest.mark.parametrize("arch", ARCHS)
def test_dualdecoder_criterion_matches_jax(arch):
    """cross_entropy_dualdecoder (weights 0.8 / 0.2, label smoothing 0.1):
    the loss, the returned sample size and every logging output at rtol
    1e-5 in eval mode; reduce_metrics (both perplexities) at rtol 1e-6."""
    jmodel, variables, tmodel = built(arch)
    crit_args = argparse.Namespace(label_smoothing=0.1, sentence_avg=False, primary_loss_weight=0.8,
                                   auxiliary_loss_weight=0.2)
    jc = jcrit.CrossEntropyDualDecoder(_jax_task(), crit_args)
    tc = CRITERIONS["cross_entropy_dualdecoder"].build_criterion(crit_args, DummyTask(torch_dictionary(TGT_VOCAB)))
    sample = dual_batch(seed=2)
    jloss, jss, jlog = jax.jit(lambda v, b: jc(jmodel, v, b, training=False)[:3])(
        variables, {k: jnp.asarray(v) for k, v in _flat(sample).items()})
    tloss, tss, tlog = tc(tmodel, _torch_batch(sample), training=False)
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), rtol=1e-5)
    assert int(tss) == int(jss)
    assert sorted(tlog) == sorted(jlog)
    for key, value in jlog.items():
        np.testing.assert_allclose(float(tlog[key]), float(value), rtol=1e-5, err_msg=key)
    assert float(tlog["auxiliary_ntokens"]) == float(sample["transcript_target_lengths"].sum())
    rec = _Recorder()
    jcrit.CrossEntropyDualDecoder.reduce_metrics([{k: float(v) for k, v in jlog.items()}], rec)
    meters = {k: argparse.Namespace(avg=v) for k, v in rec.values.items() if not callable(v)}
    for key in ("primary_ppl", "auxiliary_ppl"):
        rec.values[key] = rec.values[key](meters)
    got = CrossEntropyDualDecoder.reduce_metrics([tlog])
    assert sorted(got) == sorted(rec.values)
    for key, value in rec.values.items():
        np.testing.assert_allclose(got[key], value, rtol=1e-6, err_msg=key)


@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_matches_export_but_the_triangle_cross_attention(arch):
    """state_dict_from_jax equals the JAX fork export name for name and
    value for value, except on the triangle layer's second cross-attention
    and its LayerNorm: the export leaves their JAX names
    (``aux_decoder_attn.q.weight``, ``aux_decoder_attn_ln.weight``), the
    port gives them the fork's attention names (``q_proj``...,
    ``_layer_norm``), value for value the same. The tree is the big
    preset's cut to 1+1 layers, seeded random values in the shapes of the
    JAX init; it loads strictly into the port's model."""
    over = dict(encoder_layers=1, decoder_layers=1, input_feat_per_channel=16)
    args = model_args(arch + "_big", **over)
    registry.apply_architecture(args)
    shapes = jax.eval_shape(registry.build_model(args, _jax_task()).init, jax.random.PRNGKey(1))
    rng = np.random.RandomState(1)
    variables = jax.tree_util.tree_map(lambda a: np.asarray(rng.randn(*a.shape)).astype(a.dtype), shapes)
    ours, theirs = state_dict_from_jax(variables), export_parameters(variables)
    depart = lambda n: any(p in n for p in EXPORT_DEPARTURES)  # noqa: E731
    assert sorted(n for n in ours if not depart(n)) == sorted(n for n in theirs if not depart(n))
    for name, arr in theirs.items():
        if not depart(name):
            np.testing.assert_array_equal(ours[name].numpy(), arr, err_msg=name)
    assert ("decoder.layers.0.aux_decoder_attn.q.weight" in theirs) == (arch == "conv_transformer_triangle")
    if arch == "conv_transformer_triangle":
        renamed = {"aux_decoder_attn." + a + ".": "aux_decoder_attn." + b + "." for a, b in
                   (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"), ("out", "out_proj"))}
        renamed["aux_decoder_attn_ln."] = "aux_decoder_attn_layer_norm."
        departed = sorted(n for n in theirs if depart(n))
        assert len(departed) == 10 and sorted(n for n in ours if depart(n)) == sorted(
            next((n.replace(a, b) for a, b in renamed.items() if a in n)) for n in departed)
        for name in departed:
            port_name = next(name.replace(a, b) for a, b in renamed.items() if a in name)
            np.testing.assert_array_equal(ours[port_name].numpy(), theirs[name], err_msg=name)
        assert "decoder.layers.0.fc_concat.weight" in theirs
    assert "auxiliary_decoder.output_projection.weight" in ours
    tmodel = tmt.build_model(arch + "_big", torch_dictionary(TGT_VOCAB), torch_dictionary(SRC_VOCAB),
                             device="cpu", **over)
    tmodel.load_state_dict(ours, strict=True)


@pytest.mark.parametrize("arch", sorted(tmt.ARCHITECTURES))
def test_arch_presets_match_jax(arch):
    """Each of the nine presets builds the JAX registry's encoder, target
    and auxiliary decoder configs (the auxiliary one over the source
    dictionary), field by field; the JAX decoder config's fields of other
    families stay at their defaults. The model class is the JAX one's
    namesake."""
    args = model_args(arch)
    registry.apply_architecture(args)
    jmodel = registry.build_model(args, _jax_task())
    enc, dec, aux = tmt.configs(arch, torch_dictionary(TGT_VOCAB), torch_dictionary(SRC_VOCAB))
    assert enc.frontend._asdict() == jmodel.encoder_cfg.frontend._asdict()
    assert {k: v for k, v in enc._asdict().items() if k != "frontend"} == {
        k: v for k, v in jmodel.encoder_cfg._asdict().items() if k != "frontend"}
    for ours, theirs in ((dec, jmodel.decoder_cfg), (aux, jmodel.aux_decoder_cfg)):
        jd = theirs._asdict()
        assert ours._asdict() == {k: jd[k] for k in ours._fields}
        jdefaults = type(theirs)._field_defaults
        assert {k: v for k, v in jd.items() if k not in ours._fields} == {
            k: jdefaults[k] for k in jd if k not in ours._fields}
    assert aux.vocab_size == len(torch_dictionary(SRC_VOCAB))
    assert tmt.ARCHITECTURES[arch][0].__name__ == type(jmodel).__name__
    assert arch in ARCHITECTURES and arch_defaults(arch)["auxiliary_decoder_embed_path"] is None


def test_off_path_options_raise():
    """A pre-trained auxiliary embedding raises NotImplementedError; a
    multi-decoder model needs the source dictionary."""
    with pytest.raises(NotImplementedError):
        tmt.build_model("conv_transformer_dualdecoder", torch_dictionary(TGT_VOCAB), torch_dictionary(SRC_VOCAB),
                        device="cpu", auxiliary_decoder_embed_path="/some/embeddings.txt", **SMALL)
    with pytest.raises(ValueError):
        tmt.build_model("conv_transformer_triangle", torch_dictionary(TGT_VOCAB), device="cpu", **SMALL)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

TRAIN_ARGV = [
    "/nonexistent", "--task", "speech_translation_dualdecoding", "-s", "en", "-t", "de",
    "--arch", "conv_transformer_triangle", "--criterion", "cross_entropy_dualdecoder",
    "--label-smoothing", "0.1", "--primary-loss-weight", "0.6", "--auxiliary-loss-weight", "0.4",
    "--optimizer", "adam", "--adam-betas", "(0.9, 0.98)", "--lr", "0.002",
    "--lr-scheduler", "inverse_sqrt", "--warmup-updates", "2", "--clip-norm", "10.0",
    "--max-tokens", "4000", "--distributed-world-size", "1",
] + [f"--{k.replace('_', '-')}={v}" for k, v in SMALL.items()]


class _DeterministicJaxDual(jcrit.CrossEntropyDualDecoder):
    def __call__(self, model, variables, batch, rng=None, training=False):
        return super().__call__(model, variables, batch, rng=rng, training=False)


class _DeterministicDual(CrossEntropyDualDecoder):
    def __call__(self, model, batch, generator=None, training=False):
        return super().__call__(model, batch, generator, training=False)


def test_dualdecoder_train_steps_match_jax_trainer():
    """Three steps of JAX's Trainer and of the port's on the triangle
    (both decoders and the fused cross-attentions in the backward), built
    through ``SpeechTranslationDualDecodingTask``, with the eval-mode
    criterion: per step every logging output at rtol 1e-5 and the gnorm at
    rtol 1e-5; then every parameter and BatchNorm buffer at atol 1e-5 (the
    key-projection biases, whose exact gradient is 0, at 2 x the summed
    lr, as in tests/test_torch_train.py)."""
    args = options.parse_args_and_arch(options.get_training_parser(), TRAIN_ARGV)
    jtask = _jax_task()
    jtrainer = JaxTrainer(args, jtask, registry.build_model(args, jtask), _DeterministicJaxDual(jtask, args))
    gnorms = []
    log_training = jtrainer._log_training
    jtrainer._log_training = lambda lo, gnorm, meta: (gnorms.append(gnorm), log_training(lo, gnorm, meta))

    ttask = TASKS["speech_translation_dualdecoding"](args, torch_dictionary(TGT_VOCAB), torch_dictionary(SRC_VOCAB))
    assert isinstance(ttask, SpeechTranslationDualDecodingTask)
    tmodel = ttask.build_model(args, device="cpu")
    assert isinstance(tmodel, tmt.ConvolutionalTransformerTriangle) and tmodel.training
    tmodel.load_state_dict(state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jtrainer.variables())),
                           strict=True)
    assert isinstance(ttask.build_criterion(args), CrossEntropyDualDecoder)
    ttrainer = Trainer(args, ttask, tmodel, _DeterministicDual(ttask, args))
    lr_sum = 0.0
    for step in range(3):
        lr_sum += jtrainer.lr_scheduler.step_update(step)
        samples = [dual_batch(seed=10 * step)]
        want, got = jtrainer.train_step(samples), ttrainer.train_step(samples)
        for key in ("loss", "primary_loss", "primary_nll_loss", "auxiliary_loss", "auxiliary_nll_loss", "ntokens",
                    "auxiliary_ntokens", "nsentences", "sample_size"):
            np.testing.assert_allclose(float(got[key]), want[key], rtol=1e-5, err_msg=f"{key} step {step}")
        np.testing.assert_allclose(float(got["gnorm"]), gnorms[step], rtol=1e-5, err_msg=f"gnorm step {step}")
    want_sd = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jtrainer.variables()))
    got_sd = ttrainer.model.state_dict()
    assert sorted(got_sd) == sorted(want_sd)
    for name, value in want_sd.items():
        atol = 2 * lr_sum if name.endswith("k_proj.bias") else 1e-5
        np.testing.assert_allclose(_np(got_sd[name]), value.numpy(), rtol=0, atol=atol, err_msg=name)
