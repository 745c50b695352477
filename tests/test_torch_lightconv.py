"""PyTorch port, lightconv slice: the dynamic convolution's plain versions,
the lightconv/dynamicconv translation models, the beam search over them,
the weight bridge, the collater and three train steps against the JAX
package on the same numpy inputs, on the CPU.

The port runs its plain versions here (CPU tensors), through the same
autograd Function as on the card when ``use_kernel`` is True. JAX runs
``dynamic_conv_pallas`` in interpret mode where its gate takes the Pallas
route, as tests/test_lightconv.py does. Tolerances are stated per test;
everything is fp32."""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fbk_fairseq_st_tpu import options, registry
from fbk_fairseq_st_tpu.data.language_pair_dataset import LanguagePairDataset as JaxLanguagePairDataset
from fbk_fairseq_st_tpu.generation import SequenceGenerator as JaxSequenceGenerator
from fbk_fairseq_st_tpu.ops import lightconv as jlc
from fbk_fairseq_st_tpu.ops.pallas import conv_kernels as jck
from fbk_fairseq_st_tpu.tasks.translation import TranslationTask as JaxTranslationTask
from fbk_fairseq_st_tpu.train.trainer import Trainer as JaxTrainer
from fbk_fairseq_st_tpu.utils.fairseq_interop import export_parameters
from fbk_fairseq_st_tpu_torch import models as tmodels
from fbk_fairseq_st_tpu_torch.data import LanguagePairDataset
from fbk_fairseq_st_tpu_torch.generation import SequenceGenerator
from fbk_fairseq_st_tpu_torch.models import lightconv as tlcm
from fbk_fairseq_st_tpu_torch.ops import lightconv as tlc
from fbk_fairseq_st_tpu_torch.ops.kernels import dynamic_conv as tdc
from fbk_fairseq_st_tpu_torch.tasks import SpeechRecognitionTask, TranslationTask
from fbk_fairseq_st_tpu_torch.train import Trainer
from fbk_fairseq_st_tpu_torch.utils.weights import state_dict_from_jax

from .test_torch_model import SMALL as CT_SMALL
from .test_torch_model import random_variables, torch_dictionary
from .test_torch_train import _DeterministicJaxLSCE, _DeterministicLSCE
from .utils import dummy_dictionary, model_args

VOCAB = 24
PAD, EOS = 1, 2
TINY = dict(  # tests/test_lightconv.py:73-82
    encoder_layers=2, decoder_layers=2,
    encoder_embed_dim=16, decoder_embed_dim=16,
    encoder_ffn_embed_dim=32, decoder_ffn_embed_dim=32,
    encoder_attention_heads=2, decoder_attention_heads=2,
    encoder_conv_dim=16, decoder_conv_dim=16,
    encoder_kernel_size_list="[3, 5]",
    decoder_kernel_size_list="[3, 5]",
    max_source_positions=64, max_target_positions=32,
)
ARCHS = ("lightconv_iwslt_de_en", "dynamicconv_iwslt_de_en")


def _np(x):
    return np.asarray(x.detach()) if isinstance(x, torch.Tensor) else np.asarray(x)


# ---------------------------------------------------------------------------
# the dynamic convolution
# ---------------------------------------------------------------------------

# (B, T, C, H, K, padding_l)
CONV_CASES = {
    "pallas_route_causal": (2, 128, 128, 4, 7, 6),
    "xla_route_even_k": (2, 37, 48, 3, 4, 1),
    "k31_h16": (1, 200, 64, 16, 31, 15),
}


def _conv_inputs(case, seed=0):
    b, t, c, h, k, pad_l = CONV_CASES[case]
    rng = np.random.RandomState(seed)
    x = rng.randn(b, t, c).astype(np.float32)
    logits = rng.randn(b, t, h, k).astype(np.float32)
    w = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    g = rng.randn(b, t, c).astype(np.float32)
    return x, w.astype(np.float32), g, pad_l


@pytest.mark.parametrize("jax_fn", ["xla_reference", "dynamic_conv_pallas"])
@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_dynamic_conv_plain_forward_matches_jax(case, jax_fn):
    """dynamic_conv_reference and the port's dynamic_conv (its autograd
    Function on the CPU) against JAX's _xla_reference and
    dynamic_conv_pallas (Pallas in interpret mode where its gate allows,
    else its XLA route): atol 1e-5 (sums of K products of O(1) values in
    another order)."""
    x, w, _, pad_l = _conv_inputs(case)
    fn = jck._xla_reference if jax_fn == "xla_reference" else jck.dynamic_conv_pallas
    want = np.asarray(fn(jnp.asarray(x), jnp.asarray(w), pad_l))
    for got in (tdc.dynamic_conv_reference(torch.tensor(x), torch.tensor(w), pad_l),
                tdc.dynamic_conv(torch.tensor(x), torch.tensor(w), pad_l)):
        np.testing.assert_allclose(_np(got), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_dynamic_conv_backward_matches_jax_vjp(case):
    """dynamic_conv_backward_reference (written out), autograd of the plain
    forward and the autograd Function against jax.vjp of
    dynamic_conv_pallas: dx at atol 1e-5 (K products a sum), dw at atol
    1e-5 (C/H <= 32 products a sum)."""
    x, w, g, pad_l = _conv_inputs(case, seed=1)
    _, vjp = jax.vjp(lambda a, b: jck.dynamic_conv_pallas(a, b, pad_l), jnp.asarray(x), jnp.asarray(w))
    want = [np.asarray(v) for v in vjp(jnp.asarray(g))]
    got = [tdc.dynamic_conv_backward_reference(torch.tensor(x), torch.tensor(w), torch.tensor(g), pad_l)]
    for fn in (tdc.dynamic_conv_reference, tdc.dynamic_conv):
        tx, tw = (torch.tensor(v, requires_grad=True) for v in (x, w))
        fn(tx, tw, pad_l).backward(torch.tensor(g))
        got.append((tx.grad, tw.grad))
    for dx, dw in got:
        np.testing.assert_allclose(_np(dx), want[0], rtol=0, atol=1e-5, err_msg="dx")
        np.testing.assert_allclose(_np(dw), want[1], rtol=0, atol=1e-5, err_msg="dw")


def test_dynamic_conv_wrapper_checks_its_inputs():
    x, w = torch.zeros(2, 5, 6), torch.zeros(2, 5, 4, 3)
    with pytest.raises(ValueError):
        tdc.dynamic_conv(x, w, 1)  # 6 channels, 4 heads
    with pytest.raises(ValueError):
        tdc.dynamic_conv(x, torch.zeros(2, 4, 3, 3), 1)
    with pytest.raises(ValueError):
        tdc.dynamic_conv(x, torch.zeros(2, 5, 3, 3), -1)


def _jax_conv_params(kind, c, k, h, seed):
    key = jax.random.PRNGKey(seed)
    if kind == "lightweight":
        p = jax.tree_util.tree_map(np.asarray, jlc.init_lightweight_conv(key, c, k, h, bias=True))
        p["weight"] = np.random.RandomState(seed).randn(h, k).astype(np.float32)
        conv = tlc.LightweightConv(c, k, h, bias=True)
        conv.weight.data = torch.tensor(p["weight"])
    else:
        p = jax.tree_util.tree_map(np.asarray, jlc.init_dynamic_conv(key, c, k, h, bias=True))
        conv = tlc.DynamicConv(c, k, h, bias=True)
        conv.weight_linear.weight.data = torch.tensor(p["weight_linear"]["w"].T.copy())
        conv.weight_linear.bias.data = torch.tensor(p["weight_linear"]["b"])
    p["bias"] = np.random.RandomState(seed + 1).randn(c).astype(np.float32)
    conv.bias.data = torch.tensor(p["bias"])
    return p, conv


@pytest.mark.parametrize("weight_softmax", [True, False])
@pytest.mark.parametrize("kind", ["lightweight", "dynamic"])
def test_conv_ops_and_steps_match_jax(kind, weight_softmax):
    """lightweight_conv, dynamic_conv (both routes) and their incremental
    steps against JAX's, biases included: atol 1e-5."""
    b, t, c, h, k = 2, 9, 12, 3, 5
    p, conv = _jax_conv_params(kind, c, k, h, seed=3)
    x = np.random.RandomState(4).randn(b, t, c).astype(np.float32)
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    for pad_l in (k - 1, k // 2):
        if kind == "lightweight":
            want = jlc.lightweight_conv(jp, jnp.asarray(x), k, h, pad_l, weight_softmax=weight_softmax)
            gots = [tlc.lightweight_conv(conv, torch.tensor(x), k, h, pad_l, weight_softmax=weight_softmax)]
        else:
            want = jlc.dynamic_conv(jp, jnp.asarray(x), k, h, pad_l, weight_softmax=weight_softmax)
            gots = [tlc.dynamic_conv(conv, torch.tensor(x), k, h, pad_l, weight_softmax=weight_softmax,
                                     use_kernel=use) for use in (False, True)]
        for got in gots:
            np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0, atol=1e-5)
    window = x[:, :k]
    jstep = jlc.lightweight_conv_step if kind == "lightweight" else jlc.dynamic_conv_step
    tstep = tlc.lightweight_conv_step if kind == "lightweight" else tlc.dynamic_conv_step
    want = jstep(jp, jnp.asarray(window), k, h, weight_softmax)
    got = tstep(conv, torch.tensor(window), k, h, weight_softmax)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------

class _Task:
    def __init__(self, d):
        self.source_dictionary = d
        self.target_dictionary = d


def _build_pair(arch, **over):
    jd = dummy_dictionary(VOCAB)
    args = model_args(arch, **TINY, **over)
    registry.apply_architecture(args)
    jmodel = registry.build_model(args, _Task(jd))
    variables = random_variables(jmodel, 0)
    td = torch_dictionary(VOCAB)
    tmodel = tlcm.build_model(arch, td, td, device="cpu", seed=1, **TINY, **over)
    tmodel.load_state_dict(state_dict_from_jax(variables), strict=True)
    return jd, jmodel, variables, td, tmodel


def _text_batch(seed=0, b=3, s=9, tgt_len=6):
    """Sources of mixed lengths padded on the left; targets padded on the
    right."""
    rng = np.random.RandomState(seed)
    lengths = np.array([s, s - 3, s - 5][:b], np.int64)
    src = np.full((b, s), PAD, np.int64)
    for i, n in enumerate(lengths):
        src[i, s - n:] = rng.randint(4, VOCAB, size=n)
        src[i, -1] = EOS
    prev = np.concatenate([np.full((b, 1), EOS), rng.randint(4, VOCAB, size=(b, tgt_len - 1))], axis=1)
    prev[-1, -2:] = PAD
    return {"src_tokens": src, "src_lengths": lengths, "prev_output_tokens": prev}


MODEL_VARIANTS = {
    "glu_postnorm": dict(encoder_glu=True, decoder_glu=True),
    "glu_prenorm": dict(encoder_glu=True, decoder_glu=True, encoder_normalize_before=True,
                        decoder_normalize_before=True),
    "noglu_postnorm": {},
    "noglu_prenorm_learned_tied": dict(encoder_normalize_before=True, decoder_normalize_before=True,
                                       encoder_learned_pos=True, share_decoder_input_output_embed=True),
}


@pytest.mark.parametrize("variant", sorted(MODEL_VARIANTS))
@pytest.mark.parametrize("arch", ARCHS)
def test_teacher_forced_logits_match_jax(arch, variant):
    """Encoder output and teacher-forced logits in eval mode at atol 1e-4,
    the port's dynamic conv by both routes (use_kernel: the autograd
    Function's plain version, or the plain unfold + einsum)."""
    _, jmodel, variables, _, tmodel = _build_pair(arch, **MODEL_VARIANTS[variant])
    batch = _text_batch()
    (jlogits, jextra), _ = jax.jit(lambda v, b: jmodel.forward(v, b))(
        variables, {k: jnp.asarray(v) for k, v in batch.items()})
    for use_kernel in (False, True):
        tmodel.use_kernel = use_kernel
        with torch.no_grad():
            tlogits, textra = tmodel({k: torch.tensor(v) for k, v in batch.items()})
        np.testing.assert_array_equal(textra["encoder_out"].encoder_padding_mask.numpy(),
                                      np.asarray(jextra["encoder_out"].encoder_padding_mask))
        np.testing.assert_allclose(textra["encoder_out"].encoder_out.numpy(),
                                   np.asarray(jextra["encoder_out"].encoder_out), rtol=0, atol=1e-4)
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), rtol=0, atol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_incremental_decode_matches_jax_step_by_step(arch):
    """decode_step against JAX's at every step (atol 1e-4) from the same
    encoder output, and against the port's own teacher-forced logits."""
    _, jmodel, variables, _, tmodel = _build_pair(arch, encoder_glu=True, decoder_glu=True)
    batch = _text_batch(seed=2)
    src, lengths, prev = batch["src_tokens"], batch["src_lengths"], batch["prev_output_tokens"]
    prev = np.where(prev == PAD, 5, prev)  # no pads inside the decoded prefix
    jenc = jax.jit(lambda v, s, n: jmodel.encode(v, s, n)[0])(variables, jnp.asarray(src), jnp.asarray(lengths))
    jcache = jmodel.init_cache(variables, 3, prev.shape[1], jenc)
    with torch.no_grad():
        tenc = tmodel.encode(torch.tensor(src), torch.tensor(lengths))
        tcache = tmodel.init_cache(3, prev.shape[1], tenc)
        full, _ = tmodel({"src_tokens": torch.tensor(src), "src_lengths": torch.tensor(lengths),
                          "prev_output_tokens": torch.tensor(prev)})
        for i in range(prev.shape[1]):
            jlog, jcache, _ = jmodel.decode_step(variables, jnp.asarray(prev[:, i:i + 1]), jcache,
                                                 jnp.int32(i), jenc)
            tlog = tmodel.decode_step(torch.tensor(prev[:, i:i + 1]), tcache, i, tenc)
            np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=0, atol=1e-4, err_msg=f"step {i}")
            np.testing.assert_allclose(tlog.numpy(), full[:, i].numpy(), rtol=0, atol=1e-4)


@pytest.mark.parametrize("case", ["beam5", "beam5_lenpen_ngram_minlen"])
def test_beam5_hypotheses_match_jax(case):
    """SequenceGenerator over a tiny dynamicconv against JAX's: the same
    hypotheses token for token in the same order, scores and positional
    scores within 1e-4. The decoder's conv windows must follow the beams
    (LightConvModel.reorder_cache) for the hypotheses to agree."""
    kwargs = {"beam5": dict(beam_size=5, max_len_b=10),
              "beam5_lenpen_ngram_minlen": dict(beam_size=5, max_len_b=9, len_penalty=1.3,
                                                no_repeat_ngram_size=2, min_len=3)}[case]
    jd, jmodel, variables, td, tmodel = _build_pair("dynamicconv_iwslt_de_en", encoder_glu=True,
                                                    decoder_glu=True)
    batch = _text_batch(seed=4)
    sample = {"net_input": {"src_tokens": batch["src_tokens"], "src_lengths": batch["src_lengths"]}}
    want = JaxSequenceGenerator(jd, **kwargs).generate([(jmodel, variables)], sample)
    got = SequenceGenerator(td, **kwargs).generate([tmodel], sample)
    assert len(got) == len(want)
    for hyps_t, hyps_j in zip(got, want):
        assert len(hyps_t) == len(hyps_j) == 5
        for ht, hj in zip(hyps_t, hyps_j):
            np.testing.assert_array_equal(ht["tokens"], np.asarray(hj["tokens"]))
            assert abs(ht["score"] - hj["score"]) <= 1e-4
            np.testing.assert_allclose(ht["positional_scores"], hj["positional_scores"], rtol=0, atol=1e-4)


# ---------------------------------------------------------------------------
# weights, presets, data, task
# ---------------------------------------------------------------------------

_EXPORT_SLIPS = ("encoder_embed.weight", "decoder_embed.weight", ".conv.weight")


@pytest.mark.parametrize("arch", ARCHS)
def test_state_dict_from_jax_matches_export_parameters(arch):
    """The bridge equals export_parameters name for name, and value for
    value except on the three kinds of leaf the export transposes (the
    lightweight conv's (H, K) kernel and the two (V, D) tables), where it
    equals the export's transpose; the port's model loads it strictly."""
    _, _, variables, _, tmodel = _build_pair(arch)
    ours = state_dict_from_jax(variables)
    theirs = export_parameters(variables)
    assert sorted(ours) == sorted(theirs) == sorted(tmodel.state_dict())
    slipped = set()
    for name, arr in theirs.items():
        if name.endswith(_EXPORT_SLIPS):
            slipped.add(name.rsplit(".", 2)[-2])
            arr = arr.T
        np.testing.assert_array_equal(ours[name].numpy(), arr, err_msg=name)
    want = {"encoder_embed", "decoder_embed"} | ({"conv"} if arch.startswith("lightconv") else set())
    assert slipped == want
    assert tuple(ours["encoder_embed.weight"].shape) == (VOCAB + 4, 16)


@pytest.mark.parametrize("arch", sorted(tlcm.ARCHITECTURES))
def test_arch_presets_match_jax(arch):
    """Each lightconv preset builds the JAX model's config, field by field
    (the per-layer configs included)."""
    jd = dummy_dictionary(VOCAB)
    args = model_args(arch)
    registry.apply_architecture(args)
    jcfg = registry.build_model(args, _Task(jd)).cfg
    cfg = tlcm.configs(arch, torch_dictionary(VOCAB), torch_dictionary(VOCAB))
    assert cfg._asdict() == jcfg._asdict()


def _pairs(seed=6, n=5):
    rng = np.random.RandomState(seed)
    src = [np.append(rng.randint(4, VOCAB, size=rng.randint(2, 9)), EOS) for _ in range(n)]
    tgt = [np.append(rng.randint(4, VOCAB, size=rng.randint(1, 7)), EOS) for _ in range(n)]
    return src, tgt


COLLATER_CASES = {
    "default": ({}, {}),
    "pad_to": ({}, dict(pad_to_src_len=12, pad_to_tgt_len=9, pad_to_bsz=7)),
    "right_src_left_tgt": (dict(left_pad_source=False, left_pad_target=True), {}),
    "all_padded_on_the_left": (dict(left_pad_target=True), dict(pad_to_tgt_len=8)),
}


@pytest.mark.parametrize("case", sorted(COLLATER_CASES))
def test_collater_matches_jax(case):
    """The port's LanguagePairDataset.collater equals JAX's on the same
    samples: every array, the counts and the key set."""
    ds_kwargs, call_kwargs = COLLATER_CASES[case]
    src, tgt = _pairs()
    sizes = [len(s) for s in src], [len(t) for t in tgt]
    jd, td = dummy_dictionary(VOCAB), torch_dictionary(VOCAB)
    jds = JaxLanguagePairDataset(src, sizes[0], jd, tgt, sizes[1], jd, shuffle=False, **ds_kwargs)
    tds = LanguagePairDataset(src, sizes[0], td, tgt, sizes[1], td, **ds_kwargs)
    order = [3, 0, 4, 1]
    want = jds.collater([jds[i] for i in order], **call_kwargs)
    got = tds.collater([tds[i] for i in order], **call_kwargs)
    assert sorted(got) == sorted(want) and sorted(got["net_input"]) == sorted(want["net_input"])
    assert (got["ntokens"], got["nsentences"]) == (want["ntokens"], want["nsentences"])
    for key in ("id", "target"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    for key, value in want["net_input"].items():
        np.testing.assert_array_equal(got["net_input"][key], value, err_msg=key)


# The JAX parser's --encoder/decoder-conv-type default ("lightweight") wins
# over the dynamicconv presets' own (ROADMAP Queue C): name the type.
TRAIN_ARGV = [
    "/nonexistent", "--task", "translation", "-s", "en", "-t", "de",
    "--arch", "dynamicconv_iwslt_de_en", "--encoder-conv-type", "dynamic", "--decoder-conv-type", "dynamic",
    "--criterion", "label_smoothed_cross_entropy", "--label-smoothing", "0.1",
    "--optimizer", "adam", "--adam-betas", "(0.9, 0.98)", "--weight-decay", "0.0001",
    "--lr", "0.002", "--lr-scheduler", "inverse_sqrt", "--warmup-updates", "2",
    "--clip-norm", "10.0", "--max-tokens", "4000", "--distributed-world-size", "1",
] + [f"--{k.replace('_', '-')}={v}" for k, v in TINY.items()]


def _translation_sample(seed):
    batch = _text_batch(seed=seed)
    prev = batch["prev_output_tokens"]
    target = np.concatenate([prev[:, 1:], np.full((3, 1), PAD)], axis=1)
    target[:-1, -1] = EOS
    target[-1, -3] = EOS
    return {"net_input": batch, "target": target, "ntokens": int((target != PAD).sum()), "nsentences": 3}


@pytest.mark.parametrize("use_kernel", [False, True])
def test_train_steps_match_jax_trainer(use_kernel):
    """Three train steps of the port's Trainer on the translation task
    against JAX's (a tiny dynamicconv, warmup 2, weight decay on, the
    deterministic criterion): per-step loss, nll_loss and gnorm at rtol
    1e-5, then every parameter at atol 1e-5, the port's dynamic conv by
    either route. The encoder-attention key-projection biases are held to
    2 x the summed lr: their exact gradient is 0 and each side's Adam
    normalises its own rounding noise (tests/test_torch_train.py)."""
    args = options.parse_args_and_arch(options.get_training_parser(), TRAIN_ARGV)
    jd = dummy_dictionary(VOCAB)
    jtask = JaxTranslationTask(args, jd, jd)
    jtrainer = JaxTrainer(args, jtask, jtask.build_model(args), _DeterministicJaxLSCE(
        jtask, argparse.Namespace(label_smoothing=0.1, sentence_avg=False)))
    gnorms = []
    log_training = jtrainer._log_training
    jtrainer._log_training = lambda lo, gnorm, meta: (gnorms.append(gnorm), log_training(lo, gnorm, meta))

    td = torch_dictionary(VOCAB)
    ttask = TranslationTask(args, td, td)
    tmodel = ttask.build_model(args, device="cpu")
    tmodel.load_state_dict(state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jtrainer.variables())),
                           strict=True)
    tmodel.use_kernel = use_kernel
    ttrainer = Trainer(args, ttask, tmodel, _DeterministicLSCE(ttask, args))
    lr_sum = 0.0
    for step in range(3):
        lr_sum += jtrainer.lr_scheduler.step_update(step)
        sample = _translation_sample(10 + step)
        want = jtrainer.train_step([sample])
        got = ttrainer.train_step([sample])
        for key in ("loss", "nll_loss"):
            np.testing.assert_allclose(float(got[key]), want[key], rtol=1e-5, err_msg=f"{key} step {step}")
        np.testing.assert_allclose(float(got["gnorm"]), gnorms[step], rtol=1e-5, err_msg=f"gnorm step {step}")
    want_sd = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jtrainer.variables()))
    got_sd = ttrainer.model.state_dict()
    assert sorted(got_sd) == sorted(want_sd)
    for name, value in want_sd.items():
        atol = 2 * lr_sum if name.endswith("k_proj.bias") else 1e-5
        np.testing.assert_allclose(_np(got_sd[name]), value.numpy(), rtol=0, atol=atol, err_msg=name)


def _spy_dynamic_conv(monkeypatch):
    """Record the input type of every call of the kernel wrapper."""
    dtypes = []
    wrapped = tdc.dynamic_conv

    def spy(x, w, padding_l):
        dtypes.append(x.dtype)
        return wrapped(x, w, padding_l)

    monkeypatch.setattr(tdc, "dynamic_conv", spy)
    return dtypes


def test_bf16_train_steps_against_jax(monkeypatch):
    """Under --bf16 the port's step computes the text model in bf16 (every
    dynamic conv sees bf16 inputs) where JAX's stays fp32, and the model
    keeps no type: an eval forward after the steps is fp32. Three steps
    against JAX's at bf16 tolerances: loss and nll_loss rtol 2e-3 (one
    bf16 rounding, 2^-8, averaged over the tokens: 3e-4 measured), gnorm
    rtol 2e-2 (2.3e-3 measured), every parameter atol 2 x the summed lr
    (an Adam step moves a weight by up to lr whatever its gradient's
    rounding: 3.8e-3 of 6e-3 measured)."""
    args = options.parse_args_and_arch(options.get_training_parser(), TRAIN_ARGV + ["--bf16"])
    jd = dummy_dictionary(VOCAB)
    jtask = JaxTranslationTask(args, jd, jd)
    jtrainer = JaxTrainer(args, jtask, jtask.build_model(args), _DeterministicJaxLSCE(
        jtask, argparse.Namespace(label_smoothing=0.1, sentence_avg=False)))
    gnorms = []
    log_training = jtrainer._log_training
    jtrainer._log_training = lambda lo, gnorm, meta: (gnorms.append(gnorm), log_training(lo, gnorm, meta))

    td = torch_dictionary(VOCAB)
    ttask = TranslationTask(args, td, td)
    tmodel = ttask.build_model(args, device="cpu")
    tmodel.load_state_dict(state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jtrainer.variables())),
                           strict=True)
    ttrainer = Trainer(args, ttask, tmodel, _DeterministicLSCE(ttask, args))
    dtypes = _spy_dynamic_conv(monkeypatch)
    lr_sum = 0.0
    for step in range(3):
        lr_sum += jtrainer.lr_scheduler.step_update(step)
        sample = _translation_sample(10 + step)
        want = jtrainer.train_step([sample])
        got = ttrainer.train_step([sample])
        for key in ("loss", "nll_loss"):
            np.testing.assert_allclose(float(got[key]), want[key], rtol=2e-3, err_msg=f"{key} step {step}")
        np.testing.assert_allclose(float(got["gnorm"]), gnorms[step], rtol=2e-2, err_msg=f"gnorm step {step}")
    assert dtypes == [torch.bfloat16] * 12  # 2 encoder + 2 decoder layers, 3 steps
    want_sd = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jtrainer.variables()))
    got_sd = ttrainer.model.state_dict()
    for name, value in want_sd.items():
        np.testing.assert_allclose(_np(got_sd[name]), value.numpy(), rtol=0, atol=2 * lr_sum, err_msg=name)
    with torch.no_grad():
        logits, _ = ttrainer.model.eval()({k: torch.tensor(v) for k, v in _text_batch().items()})
    assert logits.dtype == torch.float32 and dtypes[12:] == [torch.float32] * 4


def test_model_built_on_the_cpu_keeps_the_kernel_route(monkeypatch):
    """The route is the tensors' device: a model built on the CPU (by the
    task or by build_model) sends every full-sequence dynamic conv to the
    kernel wrapper, which runs its plain version here and launches the
    CUDA kernels once the model is on the card."""
    dtypes = _spy_dynamic_conv(monkeypatch)
    td = torch_dictionary(VOCAB)
    lc_args = argparse.Namespace(arch="dynamicconv_iwslt_de_en", seed=1, **TINY)
    models = [TranslationTask(lc_args, td, td).build_model(lc_args, device="cpu").eval(),
              tlcm.build_model("dynamicconv_iwslt_de_en", td, td, device="cpu", **TINY),
              tlcm.LightConvModel(tlcm.configs("dynamicconv_iwslt_de_en", td, td, **TINY)).eval()]
    batch = {k: torch.tensor(v) for k, v in _text_batch().items()}
    for model in models:
        assert model.use_kernel
        with torch.no_grad():
            model(batch)
    assert len(dtypes) == 4 * len(models)


def test_task_builds_both_families():
    """Task.build_model dispatches on --arch over models.ARCHITECTURES: a
    conv_transformer through the speech task, a dynamicconv through the
    translation task (the source dictionary sizes the encoder table), and
    an arch no family has raises NotImplementedError."""
    ct_args = argparse.Namespace(arch="conv_transformer", seed=1, **CT_SMALL)
    ct = SpeechRecognitionTask(ct_args, torch_dictionary()).build_model(ct_args, device="cpu")
    assert isinstance(ct, tmodels.ConvolutionalTransformerModel) and ct.training

    lc_args = argparse.Namespace(arch="dynamicconv_iwslt_de_en", seed=1, **TINY)
    src_dict, tgt_dict = torch_dictionary(30), torch_dictionary(VOCAB)
    task = TranslationTask(lc_args, src_dict, tgt_dict)
    lc = task.build_model(lc_args, device="cpu")
    assert isinstance(lc, tmodels.LightConvModel) and lc.training and lc.use_kernel
    assert lc.encoder_embed.weight.shape[0] == len(src_dict) and lc.decoder_embed.weight.shape[0] == len(tgt_dict)
    assert task.max_positions() == (64, 32)
    assert {"conv_transformer", "lightconv", "dynamicconv_wmt_en_de_big"} <= set(tmodels.ARCHITECTURES)
    assert tmodels.ARCHITECTURES["dynamicconv_wmt_en_de_big"] is tlcm

    for arch in ("fconv", "lstm"):
        with pytest.raises(NotImplementedError):
            task.build_model(argparse.Namespace(arch=arch, seed=1), device="cpu")
    # the text transformer family and --load-alignments are ported
    assert tmodels.ARCHITECTURES["transformer"] is not tlcm
    TranslationTask(argparse.Namespace(load_alignments=True), src_dict, tgt_dict)
    with pytest.raises(TypeError):
        tlcm.build_model("dynamicconv", tgt_dict, device="cpu", no_such_option=1)
