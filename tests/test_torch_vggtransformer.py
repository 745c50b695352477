"""PyTorch port, the VGG-Transformer ASR family: ``asr_vggtransformer`` and
``asr_vggtransformer_encoder`` (JAX ``models/vggtransformer.py``) against
the JAX package on the same numpy inputs and weights, on the CPU.

The models are tiny (two VGG blocks, one with and one without its
LayerNorm; encoder layers of both norm placements; a decoder conv stack
whose width differs from its layers', so both ``proj`` Linears exist).
JAX's init and forwards run under ``jax.jit``, built once for the file;
weights cross through ``state_dict_from_jax``, held equal to
``export_parameters``. Everything is fp32 (JAX matmuls pinned to fp32 by
tests/conftest.py); logits agree within 1e-5. The train steps run both
Trainers with the criterion in eval mode (dropout cannot match bit for
bit), as tests/test_torch_ctc.py does."""

import argparse
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fbk_fairseq_st_tpu import options, registry
from fbk_fairseq_st_tpu.criterions import cross_entropy_acc as jacc
from fbk_fairseq_st_tpu.criterions import ctc as jctc
from fbk_fairseq_st_tpu.generation.sequence_generator import SequenceGenerator as JaxSequenceGenerator
from fbk_fairseq_st_tpu.train.trainer import Trainer as JaxTrainer
from fbk_fairseq_st_tpu.utils.fairseq_interop import export_parameters
from fbk_fairseq_st_tpu_torch.criterions import CTCCriterion, CrossEntropyWithAccCriterion
from fbk_fairseq_st_tpu_torch.generation import SequenceGenerator
from fbk_fairseq_st_tpu_torch.models import arch_defaults
from fbk_fairseq_st_tpu_torch.models import vggtransformer as tvgg
from fbk_fairseq_st_tpu_torch.ops import attention as tattn
from fbk_fairseq_st_tpu_torch.tasks import SpeechRecognitionTask
from fbk_fairseq_st_tpu_torch.train import Trainer
from fbk_fairseq_st_tpu_torch.utils.weights import state_dict_from_jax

from .test_torch_model import torch_dictionary
from .utils import DummyTask, dummy_dictionary, model_args

VOCAB = 14
FEAT = 8
SMALL = dict(
    input_feat_per_channel=FEAT,
    vggblock_enc_config="[(4, 3, 2, 1, True), (4, 3, 2, 1, False)]",
    transformer_enc_config="((16, 2, 32, True, 0.1, 0.1, 0.1), (16, 4, 24, False, 0.1, 0.1, 0.1))",
    enc_output_dim=16,
    tgt_embed_dim=8,
    transformer_dec_config="((16, 2, 32, True, 0.1, 0.1, 0.1),) * 2",
    conv_dec_config="((8, 3, True), (12, 2, False))",
)
ENC_ONLY = {k: SMALL[k] for k in ("input_feat_per_channel", "vggblock_enc_config", "transformer_enc_config",
                                  "enc_output_dim")}
CONTEXT = dict(transformer_context="(6, 2)", transformer_sampling="(2, 1)")
PRESETS = ("asr_vggtransformer", "vggtransformer_1", "vggtransformer_2", "vggtransformer_base",
           "vggtransformer_enc_1")


def _np(x):
    return np.asarray(x.detach()) if isinstance(x, torch.Tensor) else np.asarray(x)


def _dicts(blank=False):
    jd, td = dummy_dictionary(VOCAB), torch_dictionary(VOCAB)
    if blank:
        jd.add_symbol("<ctc_blank>")
        td.add_symbol("<ctc_blank>")
    return jd, td


def _build(arch, blank=False, variables=None, **over):
    """(JAX model, its variables, the port's model on them). The variables
    are drawn with numpy in the shapes of JAX's init (``jax.eval_shape``:
    no compile), N(0, 0.3^2) but the LayerNorm scales N(1, 0.1^2)."""
    jd, td = _dicts(blank)
    args = model_args(arch, **over)
    registry.apply_architecture(args)
    jmodel = registry.build_model(args, DummyTask(jd))
    if variables is None:
        rng = np.random.RandomState(0)
        shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
        variables = jax.tree_util.tree_map_with_path(
            lambda path, a: ((1.0 if str(path[-1]) == "['scale']" else 0.0) + (0.1 if str(path[-1]) == "['scale']"
                             else 0.3) * rng.randn(*a.shape)).astype(a.dtype), shapes)
    tmodel = tvgg.build_model(arch, td, device="cpu", **over)
    tmodel.load_state_dict(state_dict_from_jax(variables), strict=True)
    return jmodel, variables, tmodel


@pytest.fixture(scope="module")
def seq2seq():
    return _build("vggtransformer_base", **SMALL)


@pytest.fixture(scope="module")
def jit_forward(seq2seq):
    jmodel = seq2seq[0]
    return jax.jit(lambda v, b: jmodel.forward(v, b, training=False))


def _batch(seed=0, b=3, t=37, tgt_len=6):
    rng = np.random.RandomState(seed)
    lengths = np.array([t, t - 9, t - 20][:b], np.int64)
    tokens = rng.randint(4, VOCAB, size=(b, tgt_len)).astype(np.int64)
    tokens[-1, -2:] = 1  # a padded target tail
    tokens[0, -1] = 2
    prev = np.concatenate([np.full((b, 1), 2, np.int64), tokens[:, :-1]], axis=1)
    return {
        "net_input": {"src_tokens": rng.randn(b, t, FEAT).astype(np.float32), "src_lengths": lengths,
                      "prev_output_tokens": prev},
        "target": tokens,
        "target_lengths": (tokens != 1).sum(axis=1).astype(np.int64),
        "ntokens": int((tokens != 1).sum()),
        "nsentences": b,
    }


def _torch_net_input(sample):
    return {k: torch.tensor(v) for k, v in sample["net_input"].items()}


# ---------------------------------------------------------------------------
# the bridge and the presets
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,over", [("vggtransformer_base", SMALL), ("vggtransformer_enc_1", ENC_ONLY)],
                         ids=["seq2seq", "encoder_only"])
def test_bridge_matches_export_parameters(arch, over):
    """state_dict_from_jax equals export_parameters name for name and
    value for value (4-D VGG kernels to OIHW, the decoder's 3-D conv
    kernels kept in the fork's (K, C_in, C_out) layout, linears
    transposed), on seeded values in the shapes of JAX's init, and loads
    strictly into the port's model."""
    jd, td = _dicts()
    args = model_args(arch, **over)
    registry.apply_architecture(args)
    shapes = jax.eval_shape(registry.build_model(args, DummyTask(jd)).init, jax.random.PRNGKey(1))
    rng = np.random.RandomState(1)
    variables = jax.tree_util.tree_map(lambda a: rng.randn(*a.shape).astype(a.dtype), shapes)
    ours, theirs = state_dict_from_jax(variables), export_parameters(variables)
    assert sorted(ours) == sorted(theirs)
    for name, arr in theirs.items():
        np.testing.assert_array_equal(ours[name].numpy(), arr, err_msg=name)
    tvgg.build_model(arch, td, device="cpu", **over).load_state_dict(ours, strict=True)
    if arch == "vggtransformer_base":
        assert ours["decoder.convolutions.0.weight"].shape == (3, 8, 8)
        assert {"encoder.proj.0.weight", "decoder.proj.0.weight", "encoder.vgg.0.lns.0.weight"} <= set(ours)


def test_presets_match_jax_and_the_default_preset_raises_as_jax_fails():
    """Every preset gives JAX's options; ``asr_vggtransformer``'s 512-wide
    encoder output against its 256-wide decoder layers fails in JAX's
    forward (no key dim in the cross-attention) and raises in the port's
    build, naming the mismatch."""
    for arch in PRESETS:
        args = model_args(arch)
        registry.apply_architecture(args)
        want = {k: getattr(args, k) for k in arch_defaults(arch)}
        assert arch_defaults(arch) == want, arch
    jd, td = _dicts()
    args = model_args("asr_vggtransformer")
    registry.apply_architecture(args)
    jmodel = registry.build_model(args, DummyTask(jd))
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    batch = {"src_tokens": jax.ShapeDtypeStruct((1, 16, 40), jnp.float32),
             "src_lengths": jax.ShapeDtypeStruct((1,), jnp.int32),
             "prev_output_tokens": jax.ShapeDtypeStruct((1, 3), jnp.int32)}
    with pytest.raises(TypeError):
        jax.eval_shape(lambda v, b: jmodel.forward(v, b), shapes, batch)
    with pytest.raises(ValueError, match="JAX cannot run this configuration"):
        tvgg.build_model("asr_vggtransformer", td, device="cpu")
    # a matching width builds
    tvgg.build_model("asr_vggtransformer", td, device="cpu", enc_output_dim=256, input_feat_per_channel=8)


# ---------------------------------------------------------------------------
# logits
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("route", ["dense", "flash"])
def test_teacher_forced_logits_match_jax(seq2seq, jit_forward, route):
    """The logits, the encoder output, its mask and lengths (ceil'd by the
    subsampling factor 4) in eval mode within 1e-5, on the dense route and
    on the flash route's plain version."""
    _, variables, tmodel = seq2seq
    sample = _batch()
    (jlogits, jextra), _ = jit_forward(variables, {k: jnp.asarray(v) for k, v in sample["net_input"].items()})
    tattn.set_flash_attention(route == "flash")
    try:
        with torch.no_grad():
            tlogits, textra = tmodel(_torch_net_input(sample))
    finally:
        tattn.set_flash_attention(None)
    jenc, tenc = jextra["encoder_out"], textra["encoder_out"]
    np.testing.assert_array_equal(_np(tenc.src_lengths), np.asarray(jenc.src_lengths))
    np.testing.assert_array_equal(_np(tenc.src_lengths), [10, 7, 5])
    np.testing.assert_array_equal(_np(tenc.encoder_padding_mask), np.asarray(jenc.encoder_padding_mask))
    np.testing.assert_allclose(_np(tenc.encoder_out), np.asarray(jenc.encoder_out), rtol=0, atol=1e-5)
    np.testing.assert_allclose(_np(tlogits), np.asarray(jlogits), rtol=0, atol=1e-5)


@pytest.mark.parametrize("arch,over", [("vggtransformer_base", {**SMALL, **CONTEXT}),
                                       ("vggtransformer_enc_1", {**ENC_ONLY, **CONTEXT})],
                         ids=["seq2seq_context_sampling", "encoder_only_context_sampling"])
def test_context_and_sampling_logits_match_jax(seq2seq, arch, over):
    """``--transformer-context (6, 2)`` (a mask whose right edge clamps to
    the last column) and ``--transformer-sampling (2, 1)`` (strided frames,
    lengths and mask): the logits within 1e-5 and the strided lengths
    exactly; the encoder-only model's logits are its ``encoder_out`` and
    ``ctc_out``, its lengths ``ctc_lengths``. The masked calls take the
    dense route on the port (no flash launch), as JAX's mha does."""
    # the seq2seq case on the fixture's weights (the options add no parameter)
    jmodel, variables, tmodel = _build(arch, blank=arch == "vggtransformer_enc_1",
                                       variables=seq2seq[1] if arch == "vggtransformer_base" else None, **over)
    sample = _batch(seed=1)
    if arch == "vggtransformer_enc_1":
        del sample["net_input"]["prev_output_tokens"]
    (jlogits, jextra), _ = jax.jit(lambda v, b: jmodel.forward(v, b, training=False))(
        variables, {k: jnp.asarray(v) for k, v in sample["net_input"].items()})
    mask = tmodel.encoder.context_mask(10, 4, "cpu")
    assert mask[9, 9] < 0 and mask[0, 1] == 0 and mask[0, 2] < 0  # the clamp, the right context of 1
    with torch.no_grad():
        tlogits, textra = tmodel(_torch_net_input(sample))
    jenc, tenc = jextra["encoder_out"], textra["encoder_out"]
    np.testing.assert_array_equal(_np(tenc.src_lengths), np.asarray(jenc.src_lengths))
    np.testing.assert_array_equal(_np(tenc.src_lengths), [5, 4, 3])
    np.testing.assert_allclose(_np(tlogits), np.asarray(jlogits), rtol=0, atol=1e-5)
    if arch == "vggtransformer_enc_1":
        assert tenc.ctc_out is tenc.encoder_out and tenc.ctc_lengths is tenc.src_lengths
        np.testing.assert_allclose(_np(tenc.ctc_out), np.asarray(jenc.ctc_out), rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# decoding
# ---------------------------------------------------------------------------

def test_incremental_decoding_equals_teacher_forcing(seq2seq):
    """Step by step with the conv buffers and KV caches equals teacher
    forcing at every real token within 1e-5; a ``reorder_cache`` that
    swaps the rows swaps the next step's logits, conv frames included."""
    _, _, tmodel = seq2seq
    sample = _batch(seed=2)
    net = _torch_net_input(sample)
    prev = net["prev_output_tokens"]
    with torch.no_grad():
        full, _ = tmodel(net)
        enc = tmodel.encode(net["src_tokens"], net["src_lengths"])
        cache = tmodel.init_cache(prev.shape[0], prev.shape[1] + 1, enc)
        steps = [tmodel.decode_step(prev[:, t: t + 1], cache, t, enc) for t in range(prev.shape[1])]
        order = torch.tensor([1, 0, 2])
        swapped = tmodel.init_cache(3, prev.shape[1] + 1, enc)
        for t in range(2):
            tmodel.decode_step(prev[:, t: t + 1], swapped, t, enc)
        tmodel.reorder_cache(swapped, order)
        enc_swapped = enc._replace(encoder_padding_mask=enc.encoder_padding_mask[order])
        for layer in swapped["layers"]:
            layer["cross"] = {k: v[order] for k, v in layer["cross"].items()}
        after = tmodel.decode_step(prev[order][:, 2:3], swapped, 2, enc_swapped)
    valid = _np(prev) != 1
    np.testing.assert_allclose(_np(torch.stack(steps, 1))[valid], _np(full)[valid], rtol=0, atol=1e-5)
    np.testing.assert_allclose(_np(after), _np(steps[2])[[1, 0, 2]], rtol=0, atol=1e-5)


def test_beam_hypotheses_match_jax(seq2seq):
    """Beam 3 over the conv buffers and caches: token-identical hypotheses
    in the same order, scores and positional scores within 1e-4."""
    jmodel, variables, tmodel = seq2seq
    sample = _batch(seed=3)
    sample = {"net_input": {k: sample["net_input"][k] for k in ("src_tokens", "src_lengths")}}
    jd, td = _dicts()
    want = JaxSequenceGenerator(jd, beam_size=3, max_len_b=6).generate([(jmodel, variables)], sample)
    got = SequenceGenerator(td, beam_size=3, max_len_b=6).generate([tmodel], sample)
    for hyps_t, hyps_j in zip(got, want):
        assert len(hyps_t) == len(hyps_j) == 3
        for ht, hj in zip(hyps_t, hyps_j):
            np.testing.assert_array_equal(ht["tokens"], np.asarray(hj["tokens"]))
            assert abs(ht["score"] - hj["score"]) <= 1e-4
            np.testing.assert_allclose(ht["positional_scores"], hj["positional_scores"], rtol=0, atol=1e-4)


# ---------------------------------------------------------------------------
# train steps
# ---------------------------------------------------------------------------

TRAIN_ARGV = ["/nonexistent", "--task", "speech_recognition", "--optimizer", "adam", "--lr", "0.002",
              "--lr-scheduler", "inverse_sqrt", "--warmup-updates", "2", "--clip-norm", "10.0",
              "--max-tokens", "4000", "--distributed-world-size", "1"]


class _EvalJaxCE(jacc.CrossEntropyWithAccCriterion):
    def __call__(self, model, variables, batch, rng=None, training=False):
        return super().__call__(model, variables, batch, rng=rng, training=False)


class _EvalCE(CrossEntropyWithAccCriterion):
    def __call__(self, model, batch, generator=None, training=False):
        return super().__call__(model, batch, generator, training=False)


class _EvalJaxCTC(jctc.CTCCriterion):
    def __call__(self, model, variables, batch, rng=None, training=False):
        return super().__call__(model, variables, batch, rng=rng, training=False)


class _EvalCTC(CTCCriterion):
    def __call__(self, model, batch, generator=None, training=False):
        return super().__call__(model, batch, generator, training=False)


CASES = {
    "cross_entropy_acc": ("vggtransformer_base", SMALL, False, _EvalJaxCE, _EvalCE, 3),
    "ctc_loss": ("vggtransformer_enc_1", ENC_ONLY, True, _EvalJaxCTC, _EvalCTC, 2),
}


def _ctc_sample(sample):
    """The encoder-only model's batch: CTC targets without eos."""
    out = {**sample, "net_input": {k: v for k, v in sample["net_input"].items() if k != "prev_output_tokens"}}
    target = np.where(sample["target"] == 2, 1, sample["target"])
    out["target"], out["target_lengths"] = target, (target != 1).sum(axis=1)
    out["ntokens"] = int(out["target_lengths"].sum())
    return out


@pytest.mark.parametrize("criterion", sorted(CASES))
def test_train_steps_match_jax_trainer(criterion):
    """``cross_entropy_acc`` steps of the seq2seq model (3) and
    ``ctc_loss`` steps of the encoder-only model (2) by the port's Trainer
    against JAX's (Adam, inverse_sqrt warmup 2, clip-norm 10): per step
    the loss and the gnorm at rtol 1e-5 and the counts exactly, then
    every parameter at atol 1e-5. Two kinds of bias have an exact
    gradient of 0, so each side's Adam normalises its own rounding noise
    into steps of up to lr: the attention key projections' (as in
    tests/test_torch_train.py) and the VGG convs' before a LayerNorm over
    the frequency axis, which removes a per-channel constant. They are
    held to 2 x the summed lr."""
    arch, over, blank, jcrit_cls, tcrit_cls, n_steps = CASES[criterion]
    argv = [*TRAIN_ARGV, "--arch", arch, "--criterion", criterion]
    argv += [f"--{k.replace('_', '-')}={v}" for k, v in over.items()]
    args = options.parse_args_and_arch(options.get_training_parser(), argv)
    jd, td = _dicts(blank)
    jtask = DummyTask(jd)
    jmodel = registry.build_model(args, jtask)
    jtrainer = JaxTrainer(args, jtask, jmodel, jcrit_cls(jtask, args))
    gnorms = []
    log_training = jtrainer._log_training
    jtrainer._log_training = lambda lo, gnorm, meta: (gnorms.append(gnorm), log_training(lo, gnorm, meta))
    ttask = SpeechRecognitionTask(args, td)
    tmodel = ttask.build_model(args, device="cpu")
    tmodel.load_state_dict(state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jtrainer.variables())),
                           strict=True)
    ttrainer = Trainer(args, ttask, tmodel, tcrit_cls(ttask, args))
    lr_sum = 0.0
    for step in range(n_steps):
        lr_sum += jtrainer.lr_scheduler.step_update(step)
        sample = _batch(seed=10 + step)
        if blank:
            sample = _ctc_sample(sample)
        want = jtrainer.train_step([sample])
        got = ttrainer.train_step([sample])
        np.testing.assert_allclose(float(got["loss"]), want["loss"], rtol=1e-5, err_msg=f"loss step {step}")
        assert int(got["ntokens"]) == want["ntokens"] and int(got["sample_size"]) == want["sample_size"]
        np.testing.assert_allclose(float(got["gnorm"]), gnorms[step], rtol=1e-5, err_msg=f"gnorm step {step}")
    want_sd = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jtrainer.variables()))
    got_sd = ttrainer.model.state_dict()
    assert sorted(got_sd) == sorted(want_sd)
    for name, value in want_sd.items():
        zero_grad = name.endswith("k_proj.bias") or name.startswith("encoder.vgg.0.convolutions.0.bias")
        atol = 2 * lr_sum if zero_grad else 1e-5
        np.testing.assert_allclose(_np(got_sd[name]), value.numpy(), rtol=0, atol=atol, err_msg=name)


def test_family_options_reach_the_model(seq2seq):
    """The task builds the family from parsed options (JAX's names), and
    the arch table has all five presets."""
    assert set(PRESETS) <= set(tvgg.ARCHITECTURES)
    args = SimpleNamespace(arch="vggtransformer_base", seed=1, **SMALL)
    model = SpeechRecognitionTask(argparse.Namespace(**vars(args)), torch_dictionary(VOCAB)).build_model(
        args, device="cpu")
    assert sorted(model.state_dict()) == sorted(seq2seq[2].state_dict())
    assert model.training
