"""PyTorch port, the text transformer: the encoder, the decoder's
cross-self-attention and no-encoder-attention options, the model with
--share-all-embeddings, LayerDrop, incremental decoding, beam search, the
weight bridge, the presets and three train steps of the port's Trainer
against the JAX package on the same numpy inputs, on the CPU.

Tiny widths (2 + 2 layers, 16 wide, 2 heads); JAX's weights are drawn in
the shapes of ``jax.eval_shape(model.init)`` and its forwards jitted.
fp32 with JAX's matmuls pinned to fp32 (tests/conftest.py); tolerances
are stated per test."""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fbk_fairseq_st_tpu import options, registry
from fbk_fairseq_st_tpu.generation import SequenceGenerator as JaxSequenceGenerator
from fbk_fairseq_st_tpu.tasks.translation import TranslationTask as JaxTranslationTask
from fbk_fairseq_st_tpu.train.trainer import Trainer as JaxTrainer
from fbk_fairseq_st_tpu.utils.fairseq_interop import export_parameters
import fbk_fairseq_st_tpu.models.model_parallel  # noqa: F401  (registers the JAX presets)
from fbk_fairseq_st_tpu_torch import models as tmodels
from fbk_fairseq_st_tpu_torch.generation import SequenceGenerator
from fbk_fairseq_st_tpu_torch.models import transformer as ttr
from fbk_fairseq_st_tpu_torch.tasks import TranslationTask
from fbk_fairseq_st_tpu_torch.train import Trainer
from fbk_fairseq_st_tpu_torch.utils.weights import state_dict_from_jax

from .test_torch_model import random_variables, torch_dictionary
from .test_torch_train import _DeterministicJaxLSCE, _DeterministicLSCE
from .utils import dummy_dictionary, model_args

VOCAB = 24
PAD, EOS = 1, 2
TINY = dict(encoder_layers=2, decoder_layers=2, encoder_embed_dim=16, decoder_embed_dim=16,
            encoder_ffn_embed_dim=32, decoder_ffn_embed_dim=32, encoder_attention_heads=2,
            decoder_attention_heads=2, max_source_positions=64, max_target_positions=32)
VARIANTS = {
    "postnorm": {},
    "prenorm_layernorm_embedding_learned": dict(encoder_normalize_before=True, decoder_normalize_before=True,
                                                layernorm_embedding=True, encoder_learned_pos=True,
                                                decoder_learned_pos=True),
    "share_all_embeddings": dict(share_all_embeddings=True),
    "share_decoder_io_no_scale": dict(share_decoder_input_output_embed=True, no_scale_embedding=True),
    "cross_self_attention": dict(cross_self_attention=True),
    "no_cross_attention": dict(no_cross_attention=True),
    "cross_self_and_no_cross": dict(cross_self_attention=True, no_cross_attention=True),
}
ARCH = "transformer"


class _Task:
    def __init__(self, d):
        self.source_dictionary = d
        self.target_dictionary = d


_PAIRS = {}


def _build_pair(variant, arch=ARCH):
    """JAX's model with seeded weights (eval_shape) and the port's loaded
    from them, built once a variant for the module."""
    if (variant, arch) not in _PAIRS:
        over = VARIANTS[variant]
        jd = dummy_dictionary(VOCAB)
        args = model_args(arch, **TINY, **over)
        registry.apply_architecture(args)
        jmodel = registry.build_model(args, _Task(jd))
        variables = random_variables(jmodel, 0)
        td = torch_dictionary(VOCAB)
        tmodel = ttr.build_model(arch, td, td, device="cpu", seed=1, **TINY, **over)
        tmodel.load_state_dict(state_dict_from_jax(variables), strict=True)
        _PAIRS[(variant, arch)] = (jd, jmodel, variables, td, tmodel)
    return _PAIRS[(variant, arch)]


def _text_batch(seed=0, b=3, s=9, tgt_len=6):
    """Sources of mixed lengths padded on the left; targets padded on the right."""
    rng = np.random.RandomState(seed)
    lengths = np.array([s, s - 3, s - 5][:b], np.int64)
    src = np.full((b, s), PAD, np.int64)
    for i, n in enumerate(lengths):
        src[i, s - n:] = rng.randint(4, VOCAB, size=n)
        src[i, -1] = EOS
    prev = np.concatenate([np.full((b, 1), EOS), rng.randint(4, VOCAB, size=(b, tgt_len - 1))], axis=1)
    prev[-1, -2:] = PAD
    return {"src_tokens": src, "src_lengths": lengths, "prev_output_tokens": prev}


def _jit_forward(jmodel):
    return jax.jit(lambda v, b: jmodel.forward(v, b)[0])


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_teacher_forced_logits_match_jax(variant):
    """Encoder output and teacher-forced logits in eval mode at atol 1e-4
    (post-norm and pre-norm stacks, tied tables, cross-self-attention and
    decoders without encoder attention)."""
    _, jmodel, variables, _, tmodel = _build_pair(variant)
    batch = _text_batch()
    jlogits, jextra = _jit_forward(jmodel)(variables, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        tlogits, textra = tmodel({k: torch.tensor(v) for k, v in batch.items()})
    np.testing.assert_array_equal(textra["encoder_out"].encoder_padding_mask.numpy(),
                                  np.asarray(jextra["encoder_out"].encoder_padding_mask))
    np.testing.assert_allclose(textra["encoder_out"].encoder_out.numpy(),
                               np.asarray(jextra["encoder_out"].encoder_out), rtol=0, atol=1e-4)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), rtol=0, atol=1e-4)


@pytest.mark.parametrize("variant", ["postnorm", "cross_self_attention", "cross_self_and_no_cross"])
def test_incremental_decode_matches_jax_step_by_step(variant):
    """decode_step against JAX's at every step (atol 1e-4) from the same
    encoder output, and against the port's own teacher-forced logits; with
    cross-self-attention the self cache starts with the encoder's rows."""
    _, jmodel, variables, _, tmodel = _build_pair(variant)
    batch = _text_batch(seed=2)
    src, lengths, prev = batch["src_tokens"], batch["src_lengths"], batch["prev_output_tokens"]
    prev = np.where(prev == PAD, 5, prev)  # no pads inside the decoded prefix
    jenc = jax.jit(lambda v, s, n: jmodel.encode(v, s, n)[0])(variables, jnp.asarray(src), jnp.asarray(lengths))
    jcache = jmodel.init_cache(variables, 3, prev.shape[1], jenc)
    jstep = jax.jit(lambda v, t, c, i, e: jmodel.decode_step(v, t, c, i, e)[:2])
    with torch.no_grad():
        tenc = tmodel.encode(torch.tensor(src), torch.tensor(lengths))
        tcache = tmodel.init_cache(3, prev.shape[1], tenc)
        full, _ = tmodel({"src_tokens": torch.tensor(src), "src_lengths": torch.tensor(lengths),
                          "prev_output_tokens": torch.tensor(prev)})
        for i in range(prev.shape[1]):
            jlog, jcache = jstep(variables, jnp.asarray(prev[:, i:i + 1]), jcache, jnp.int32(i), jenc)
            tlog = tmodel.decode_step(torch.tensor(prev[:, i:i + 1]), tcache, i, tenc)
            np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=0, atol=1e-4, err_msg=f"step {i}")
            np.testing.assert_allclose(tlog.numpy(), full[:, i].numpy(), rtol=0, atol=1e-4)


@pytest.mark.parametrize("variant", ["share_all_embeddings", "cross_self_attention", "no_cross_attention"])
def test_beam5_hypotheses_match_jax(variant):
    """SequenceGenerator (beam 5) over a tiny transformer against JAX's: the
    same hypotheses token for token in the same order, scores and
    positional scores within 1e-4."""
    jd, jmodel, variables, td, tmodel = _build_pair(variant)
    batch = _text_batch(seed=4)
    sample = {"net_input": {"src_tokens": batch["src_tokens"], "src_lengths": batch["src_lengths"]}}
    kwargs = dict(beam_size=5, max_len_b=10)
    want = JaxSequenceGenerator(jd, **kwargs).generate([(jmodel, variables)], sample)
    got = SequenceGenerator(td, **kwargs).generate([tmodel], sample)
    assert len(got) == len(want)
    for hyps_t, hyps_j in zip(got, want):
        assert len(hyps_t) == len(hyps_j) == 5
        for ht, hj in zip(hyps_t, hyps_j):
            np.testing.assert_array_equal(ht["tokens"], np.asarray(hj["tokens"]))
            assert abs(ht["score"] - hj["score"]) <= 1e-4
            np.testing.assert_allclose(ht["positional_scores"], hj["positional_scores"], rtol=0, atol=1e-4)


@pytest.mark.parametrize("variant", ["postnorm", "prenorm_layernorm_embedding_learned", "share_all_embeddings"])
def test_state_dict_from_jax_matches_export_parameters(variant):
    """The bridge equals export_parameters name for name and value for value,
    but for the shared table of --share-all-embeddings, which JAX exports
    as ``shared_embed_tokens.weight`` and the fork names
    ``encoder.embed_tokens.weight`` and ``decoder.embed_tokens.weight``
    (ROADMAP Queue C, JAX side): one tensor in the port, under both."""
    _, _, variables, _, tmodel = _build_pair(variant)
    ours, theirs = state_dict_from_jax(variables), export_parameters(variables)
    assert sorted(ours) == sorted(tmodel.state_dict())
    shared = variant == "share_all_embeddings"
    assert ("shared_embed_tokens.weight" in theirs) == shared
    for name, arr in theirs.items():
        targets = ["encoder.embed_tokens.weight", "decoder.embed_tokens.weight"] if name.startswith("shared") \
            else [name]
        for target in targets:
            np.testing.assert_array_equal(ours[target].numpy(), arr, err_msg=name)
    assert set(ours) - set(theirs) == ({"encoder.embed_tokens.weight", "decoder.embed_tokens.weight"}
                                       if shared else set())
    if shared:
        assert tmodel.encoder.embed_tokens.weight is tmodel.decoder.embed_tokens.weight


@pytest.mark.parametrize("arch", sorted(ttr.ARCHITECTURES))
def test_arch_presets_match_jax(arch):
    """Each preset (the 7 of models/transformer.py and
    model_parallel_transformer) builds JAX's encoder and decoder configs
    field by field, and registers in the port's table."""
    jd = dummy_dictionary(VOCAB)
    args = model_args(arch)
    registry.apply_architecture(args)
    jmodel = registry.build_model(args, _Task(jd))
    enc, dec, share_all = ttr.configs(arch, torch_dictionary(VOCAB), torch_dictionary(VOCAB))
    assert enc._asdict() == jmodel.encoder_cfg._asdict()
    assert dec._asdict() == jmodel.decoder_cfg._asdict()
    assert share_all == jmodel.share_all_embeddings
    assert tmodels.ARCHITECTURES[arch] is ttr
    assert tmodels.arch_defaults(arch)["encoder_normalize_before"] == (arch == "transformer_wmt_en_de_big_t2t")


def test_share_all_embeddings_needs_a_joined_dictionary():
    """As JAX's build: --share-all-embeddings over two dictionaries that
    differ, or two widths, raises ValueError."""
    src, tgt = torch_dictionary(VOCAB), torch_dictionary(VOCAB + 8)
    with pytest.raises(ValueError, match="joined dictionary"):
        ttr.build_model(ARCH, tgt, src, device="cpu", share_all_embeddings=True, **TINY)
    with pytest.raises(ValueError, match="embed-dim"):
        ttr.build_model(ARCH, src, src, device="cpu", share_all_embeddings=True,
                        **{**TINY, "decoder_embed_dim": 32})
    # quant-noise is ported: its rate reaches every layer (tests/test_torch_quantization.py)
    noised = ttr.build_model(ARCH, src, src, device="cpu", quant_noise_pq=0.1, **TINY)
    assert {layer.cfg.quant_noise_pq for layer in [*noised.encoder.layers, *noised.decoder.layers]} == {0.1}


def test_layerdrop_one_drops_every_layer_as_jax():
    """In training mode with every dropout at 0 and LayerDrop 1.0 both
    sides drop every layer of both stacks (JAX masks each layer's output,
    the port skips it): the same logits at atol 1e-5; in eval mode
    LayerDrop does nothing."""
    over = dict(encoder_layerdrop=1.0, decoder_layerdrop=1.0, dropout=0.0, attention_dropout=0.0, relu_dropout=0.0)
    jd = dummy_dictionary(VOCAB)
    args = model_args(ARCH, **TINY, **over)
    registry.apply_architecture(args)
    jmodel = registry.build_model(args, _Task(jd))
    variables = random_variables(jmodel, 3)
    td = torch_dictionary(VOCAB)
    tmodel = ttr.build_model(ARCH, td, td, device="cpu", **TINY, **over)
    tmodel.load_state_dict(state_dict_from_jax(variables), strict=True)
    from fbk_fairseq_st_tpu.ops.core import RngStream

    batch = _text_batch(seed=5)
    jlogits = jax.jit(lambda v, b: jmodel.forward(v, b, RngStream(jax.random.PRNGKey(0)), training=True)[0][0])(
        variables, {k: jnp.asarray(v) for k, v in batch.items()})
    tmodel.train()
    with torch.no_grad():
        tlogits, _ = tmodel({k: torch.tensor(v) for k, v in batch.items()}, torch.Generator().manual_seed(0))
        tmodel.eval()
        evals, _ = tmodel({k: torch.tensor(v) for k, v in batch.items()})
        jevals = _jit_forward(jmodel)(variables, {k: jnp.asarray(v) for k, v in batch.items()})[0]
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), rtol=0, atol=1e-5)
    np.testing.assert_allclose(evals.numpy(), np.asarray(jevals), rtol=0, atol=1e-4)
    assert not np.allclose(evals.numpy(), tlogits.numpy(), atol=1e-3)


TRAIN_ARGV = [
    "/nonexistent", "--task", "translation", "-s", "en", "-t", "de", "--arch", "transformer_wmt_en_de",
    "--share-all-embeddings", "--criterion", "label_smoothed_cross_entropy", "--label-smoothing", "0.1",
    "--optimizer", "adam", "--adam-betas", "(0.9, 0.98)", "--weight-decay", "0.0001", "--lr", "0.002",
    "--lr-scheduler", "inverse_sqrt", "--warmup-updates", "2", "--clip-norm", "10.0", "--max-tokens", "4000",
    "--distributed-world-size", "1",
] + [f"--{k.replace('_', '-')}={v}" for k, v in TINY.items()]


def _translation_sample(seed):
    batch = _text_batch(seed=seed)
    prev = batch["prev_output_tokens"]
    target = np.concatenate([prev[:, 1:], np.full((3, 1), PAD)], axis=1)
    target[:-1, -1] = EOS
    target[-1, -3] = EOS
    return {"net_input": batch, "target": target, "ntokens": int((target != PAD).sum()), "nsentences": 3}


_JAX_RUN = {}


def _jax_run():
    """JAX's three updates, made once for the file: its start weights, each
    update's logging outputs and gnorm, the summed lr and its final weights.
    JAX's --bf16 leaves a text model in fp32 (ROADMAP Queue C), so the one
    run is the reference of the port's fp32 and bf16 steps alike."""
    if not _JAX_RUN:
        args = options.parse_args_and_arch(options.get_training_parser(), TRAIN_ARGV)
        jd = dummy_dictionary(VOCAB)
        jtask = JaxTranslationTask(args, jd, jd)
        jtrainer = JaxTrainer(args, jtask, jtask.build_model(args), _DeterministicJaxLSCE(
            jtask, argparse.Namespace(label_smoothing=0.1, sentence_avg=False)))
        gnorms = []
        log_training = jtrainer._log_training
        jtrainer._log_training = lambda lo, gnorm, meta: (gnorms.append(gnorm), log_training(lo, gnorm, meta))
        start = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jtrainer.variables()))
        logs, lr_sum = [], 0.0
        for step in range(3):
            lr_sum += jtrainer.lr_scheduler.step_update(step)
            logs.append(jtrainer.train_step([_translation_sample(10 + step)]))
        _JAX_RUN.update(start=start, logs=logs, gnorms=gnorms, lr_sum=lr_sum,
                        after=state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jtrainer.variables())))
    return _JAX_RUN


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_train_steps_match_jax_trainer(dtype):
    """Three train steps of the port's Trainer on the translation task
    against JAX's (a tiny post-norm transformer, --share-all-embeddings,
    warmup 2, weight decay on, the deterministic criterion). fp32: loss,
    nll_loss and gnorm at rtol 1e-5, then every weight at atol 1e-5 (the
    key-projection biases, whose exact gradient is 0, within 2 x the summed
    lr, as tests/test_torch_train.py). bf16 (the port computes the model in
    bf16, JAX's --bf16 leaves a text model in fp32: ROADMAP Queue C): loss
    and nll_loss rtol 2e-3, gnorm rtol 2e-2, weights within 2 x the summed
    lr, as tests/test_torch_lightconv.py holds the bf16 step. The shared
    table stays one tensor."""
    want = _jax_run()
    args = options.parse_args_and_arch(options.get_training_parser(),
                                       TRAIN_ARGV + (["--bf16"] if dtype == "bf16" else []))
    td = torch_dictionary(VOCAB)
    ttask = TranslationTask(args, td, td)
    tmodel = ttask.build_model(args, device="cpu")
    tmodel.load_state_dict(want["start"], strict=True)
    ttrainer = Trainer(args, ttask, tmodel, _DeterministicLSCE(ttask, args))
    rtol, grtol = (1e-5, 1e-5) if dtype == "fp32" else (2e-3, 2e-2)
    for step in range(3):
        got = ttrainer.train_step([_translation_sample(10 + step)])
        for key in ("loss", "nll_loss"):
            np.testing.assert_allclose(float(got[key]), want["logs"][step][key], rtol=rtol,
                                       err_msg=f"{key} step {step}")
        np.testing.assert_allclose(float(got["gnorm"]), want["gnorms"][step], rtol=grtol,
                                   err_msg=f"gnorm step {step}")
    got_sd = ttrainer.model.state_dict()
    assert sorted(got_sd) == sorted(want["after"])
    for name, value in want["after"].items():
        atol = 2 * want["lr_sum"] if (dtype == "bf16" or name.endswith("k_proj.bias")) else 1e-5
        np.testing.assert_allclose(got_sd[name].numpy(), value.numpy(), rtol=0, atol=atol, err_msg=name)
    model = ttrainer.model
    assert model.encoder.embed_tokens.weight is model.decoder.embed_tokens.weight


def test_task_builds_the_transformer_and_its_aliases():
    """Task.build_model dispatches the transformer presets and
    model_parallel_transformer to the family, in training mode."""
    td = torch_dictionary(VOCAB)
    for arch in ("transformer_iwslt_de_en", "model_parallel_transformer"):
        args = argparse.Namespace(arch=arch, seed=1, **TINY)
        model = TranslationTask(args, td, td).build_model(args, device="cpu")
        assert isinstance(model, tmodels.TransformerModel) and model.training
