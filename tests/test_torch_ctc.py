"""PyTorch port, CTC slice: the edit distance, the CTC ops, the CTC
criterions, CTC compression in conv_transformer and whole ctc_multi_loss
train steps against the JAX package on the same numpy inputs, on the CPU.

The port runs its plain PyTorch versions here (CPU tensors); everything is
fp32. Whole-step parity runs in the deterministic mode of
tests/test_corpus_parity.py (criterion forced to ``training=False``), with
one JAX Trainer for the file. Tolerances are stated per test."""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fbk_fairseq_st_tpu import options, registry
from fbk_fairseq_st_tpu.criterions import ctc as jcrit
from fbk_fairseq_st_tpu.ops import attention as jattn
from fbk_fairseq_st_tpu.ops import ctc as jctc
from fbk_fairseq_st_tpu.ops import edit_distance as jed
from fbk_fairseq_st_tpu.train.trainer import Trainer as JaxTrainer
from fbk_fairseq_st_tpu.utils.fairseq_interop import export_parameters
from fbk_fairseq_st_tpu_torch.criterions import CTCCriterion, CTCMultiLoss
from fbk_fairseq_st_tpu_torch.models import conv_transformer as tct
from fbk_fairseq_st_tpu_torch.ops import attention as tattn
from fbk_fairseq_st_tpu_torch.ops import ctc as tctc
from fbk_fairseq_st_tpu_torch.ops import edit_distance as ted
from fbk_fairseq_st_tpu_torch.tasks import SpeechTranslationCTCTask
from fbk_fairseq_st_tpu_torch.train import Trainer
from fbk_fairseq_st_tpu_torch.utils.weights import state_dict_from_jax

from .test_torch_model import SMALL, VOCAB, jax_init, shared_root, torch_dictionary  # noqa: F401  (shared_root: the fixture)
from .utils import DummyTask, dummy_dictionary, model_args

SRC_VOCAB = 12
STRATEGIES = ("avg", "weighted", "softmax")


def _np(x):
    return np.asarray(x.detach()) if isinstance(x, torch.Tensor) else np.asarray(x)


def _src_dicts():
    """JAX and port source dictionaries with <ctc_blank> after the symbols
    (the port's task adds it itself under ctc_multi_loss)."""
    jsd = dummy_dictionary(SRC_VOCAB)
    jsd.add_symbol("<ctc_blank>")
    return jsd, torch_dictionary(SRC_VOCAB)


# ---------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------

def test_levenshtein_matches_jax():
    """Exactly JAX's distances on 16 random row pairs over a 4-symbol
    alphabet, lengths 0 to full on both sides."""
    rng = np.random.RandomState(0)
    pred = rng.randint(0, 4, size=(16, 11))
    tgt = rng.randint(0, 4, size=(16, 9))
    pred_len = rng.randint(0, 12, size=16)
    tgt_len = rng.randint(0, 10, size=16)
    pred_len[:2], tgt_len[1:3] = 0, 0
    want = jed.levenshtein(*map(jnp.asarray, (pred, pred_len, tgt, tgt_len)))
    got = ted.levenshtein(*map(torch.tensor, (pred, pred_len, tgt, tgt_len)))
    np.testing.assert_array_equal(_np(got), np.asarray(want))


def _compress_inputs(seed=1):
    """Logits on a coarse grid, so that argmax ties are frequent, and rows
    of every length, 1 included."""
    rng = np.random.RandomState(seed)
    logits = rng.randint(0, 3, size=(5, 9, 4)).astype(np.float32)
    logits[2, :, :] = 1.0  # every frame a 4-way tie: the first maximum wins
    x = rng.randn(5, 9, 6).astype(np.float32)
    lengths = np.array([9, 1, 5, 7, 1])
    g = rng.randn(5, 9, 6).astype(np.float32)
    return x, logits, lengths, g


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_ctc_compress_matches_jax(strategy):
    """Compressed states, new lengths and the gradients of <out, g> in x
    and in the logits (``weighted``/``softmax`` pass one through p_pred)
    against jax.vjp, at atol 1e-5; ties and rows of length 1 included."""
    x, logits, lengths, g = _compress_inputs()
    (jout, jlen), vjp = jax.vjp(lambda a, b: jctc.ctc_compress(a, b, jnp.asarray(lengths), strategy),
                                jnp.asarray(x), jnp.asarray(logits))
    jgx, jgl = vjp((jnp.asarray(g), jnp.zeros_like(jlen)))
    tx, tl = torch.tensor(x, requires_grad=True), torch.tensor(logits, requires_grad=True)
    out, new_len = tctc.ctc_compress(tx, tl, torch.tensor(lengths), strategy)
    (out * torch.tensor(g)).sum().backward()
    np.testing.assert_array_equal(_np(new_len), np.asarray(jlen))
    np.testing.assert_allclose(_np(out), np.asarray(jout), rtol=0, atol=1e-5)
    np.testing.assert_allclose(_np(tx.grad), np.asarray(jgx), rtol=0, atol=1e-5)
    logit_grad = tl.grad if tl.grad is not None else torch.zeros_like(tl)  # avg: no path through the logits
    np.testing.assert_allclose(_np(logit_grad), np.asarray(jgl), rtol=0, atol=1e-5)
    if strategy != "avg":
        assert np.abs(np.asarray(jgl)).max() > 1e-4  # the gradient through p_pred is exercised


def test_ctc_greedy_decode_matches_jax():
    """Tokens, padding and counts exactly as JAX's on tied logits."""
    _, logits, lengths, _ = _compress_inputs(seed=2)
    want = jctc.ctc_greedy_decode(jnp.asarray(logits), jnp.asarray(lengths), blank_id=3)
    got = tctc.ctc_greedy_decode(torch.tensor(logits), torch.tensor(lengths), blank_id=3)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(_np(a), np.asarray(b))


def test_ctc_loss_matches_jax():
    """The summed CTC loss and its gradient in the logits at rtol 1e-5,
    with a blank that is not 0 and a repeated label; row 2 is infeasible
    (2 frames for 2 labels that repeat) and contributes 0 on both sides."""
    rng = np.random.RandomState(3)
    logits = rng.randn(3, 8, 5).astype(np.float32)
    logit_lengths = np.array([8, 6, 2])
    labels = np.array([[1, 2, 2, 0], [3, 1, 0, 0], [1, 1, 0, 0]])
    label_lengths = np.array([4, 2, 2])

    def jloss(lg):
        return jctc.ctc_loss(lg, *map(jnp.asarray, (logit_lengths, labels, label_lengths)), blank_id=4)

    want, jgrad = jax.value_and_grad(jloss)(jnp.asarray(logits))
    tl = torch.tensor(logits, requires_grad=True)
    got = tctc.ctc_loss(tl, *map(torch.tensor, (logit_lengths, labels, label_lengths)), blank_id=4)
    got.backward()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    np.testing.assert_allclose(_np(tl.grad), np.asarray(jgrad), rtol=1e-5, atol=1e-6)
    only_infeasible = tctc.ctc_loss(torch.tensor(logits[2:]), *map(torch.tensor, (
        logit_lengths[2:], labels[2:], label_lengths[2:])), blank_id=4)
    assert float(only_infeasible) == 0.0
    assert np.abs(_np(tl.grad)[2]).max() == 0.0


# ---------------------------------------------------------------------------
# the model with CTC compression
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ctc_pair():
    """The tiny conv_transformer with a CTC head after layer 1 and CTC
    compression, built once for the file on the JAX side (initialised
    under jit) and, weights bridged, on the port's."""
    jd = dummy_dictionary(VOCAB)
    jsd, tsd = _src_dicts()
    opts = dict(SMALL, ctc_compress_out=True, ctc_encoder_layer=1)
    args = model_args("conv_transformer", **opts)
    args.criterion = "ctc_multi_loss"
    registry.apply_architecture(args)
    jmodel = registry.build_model(args, DummyTask(jd, jsd))
    variables = jax_init(jmodel, 0, "ctc_pair")
    targs = argparse.Namespace(criterion="ctc_multi_loss")
    task = SpeechTranslationCTCTask(targs, torch_dictionary(), tsd)
    tmodel = tct.build_model("conv_transformer", task.target_dictionary, task.source_dictionary, device="cpu",
                             criterion="ctc_multi_loss", **opts)
    tmodel.load_state_dict(state_dict_from_jax(variables), strict=True)
    return jmodel, variables, tmodel


def _with_strategy(pair, strategy):
    """The pair with its compression strategy set on both sides."""
    jmodel, _, tmodel = pair
    jmodel.encoder.cfg = jmodel.encoder.cfg._replace(ctc_compress_strategy=strategy)
    tmodel.encoder.cfg = tmodel.encoder.cfg._replace(ctc_compress_strategy=strategy)
    return pair


def _batch(seed=0, b=3, t=37, tgt_len=7, tr_len=5):
    rng = np.random.RandomState(seed)
    lengths = np.array([t, t - 8, t - 15][:b], np.int32)
    tokens = rng.randint(4, VOCAB, size=(b, tgt_len)).astype(np.int32)
    tokens[-1, -2:] = 1  # padded target tail
    tr = rng.randint(4, 4 + SRC_VOCAB, size=(b, tr_len)).astype(np.int32)
    tr_lengths = np.array([tr_len, tr_len - 1, tr_len + 3][:b], np.int32)  # row 3 > its 6 frames: infeasible
    tr = np.pad(tr, ((0, 0), (0, 3)), constant_values=1)
    return {
        "net_input": {
            "src_tokens": rng.randn(b, t, SMALL["input_feat_per_channel"]).astype(np.float32),
            "src_lengths": lengths,
            "prev_output_tokens": np.concatenate([np.full((b, 1), 2, np.int32), tokens[:, :-1]], axis=1),
            "transcript_prev_output_tokens": np.concatenate([np.full((b, 1), 2, np.int32), tr[:, :-1]], axis=1),
        },
        "target": tokens,
        "transcript_target": tr,
        "transcript_target_lengths": tr_lengths,
        "ntokens": int((tokens != 1).sum()),
        "nsentences": b,
    }


def _torch_batch(sample):
    flat = {**sample["net_input"], **{k: v for k, v in sample.items() if k not in ("net_input", "ntokens", "nsentences")}}
    return {k: torch.tensor(v) if v.dtype == np.float32 else torch.tensor(v).long() for k, v in flat.items()}


@pytest.mark.parametrize("strategy,route", [("weighted", "dense"), ("softmax", "flash")])
def test_compressed_model_logits_match_jax(ctc_pair, strategy, route):
    """Teacher-forced logits, the CTC logits and the compressed encoder
    output, mask and lengths of the whole model in eval mode, at atol 1e-4
    (layer 2 runs on the compressed states); the JAX forward runs under
    jit."""
    jmodel, variables, tmodel = _with_strategy(ctc_pair, strategy)
    sample = _batch()
    jattn.set_flash_attention(route == "flash")
    tattn.set_flash_attention(route == "flash")
    try:
        (jlogits, jextra), _ = jax.jit(lambda v, b: jmodel.forward(v, b, training=False))(
            variables, {k: jnp.asarray(v) for k, v in sample["net_input"].items()})
        with torch.no_grad():
            tlogits, textra = tmodel(_torch_batch(sample))
    finally:
        jattn.set_flash_attention(None)
        tattn.set_flash_attention(None)
    jenc, tenc = jextra["encoder_out"], textra["encoder_out"]
    np.testing.assert_array_equal(_np(tenc.src_lengths), np.asarray(jenc.src_lengths))
    assert int(tenc.src_lengths.max()) < tenc.ctc_lengths.max()  # compression shortened the rows
    np.testing.assert_array_equal(_np(tenc.encoder_padding_mask), np.asarray(jenc.encoder_padding_mask))
    np.testing.assert_allclose(_np(tenc.ctc_out), np.asarray(jenc.ctc_out), rtol=0, atol=1e-4)
    np.testing.assert_allclose(_np(tenc.encoder_out), np.asarray(jenc.encoder_out), rtol=0, atol=1e-4)
    np.testing.assert_allclose(_np(tlogits), np.asarray(jlogits), rtol=0, atol=1e-4)
    with torch.no_grad():
        np.testing.assert_allclose(_np(tmodel.encoder.ctc_features(torch.ones(2, 3, SMALL["encoder_embed_dim"]))),
                                   np.asarray(jmodel.encoder.ctc_features(
                                       variables["params"]["encoder"], jnp.ones((2, 3, SMALL["encoder_embed_dim"])))),
                                   rtol=0, atol=1e-5)


@pytest.mark.parametrize("arch", ["conv_transformer", "conv_transformer_big"])
def test_bridge_carries_the_ctc_head(arch):
    """state_dict_from_jax equals the fork export name for name and value
    for value on a tree with ``ctc_fc`` (the big preset's tree cut to 1+1
    layers; seeded random values in the shapes of the JAX model's init),
    and loads strictly into the port's model."""
    jd = dummy_dictionary(VOCAB)
    jsd, tsd = _src_dicts()
    over = dict(encoder_layers=1, decoder_layers=1, input_feat_per_channel=16, ctc_compress_out=True,
                ctc_encoder_layer=1)
    args = model_args(arch, **over)
    args.criterion = "ctc_multi_loss"
    registry.apply_architecture(args)
    shapes = jax.eval_shape(registry.build_model(args, DummyTask(jd, jsd)).init, jax.random.PRNGKey(1))
    rng = np.random.RandomState(1)
    variables = jax.tree_util.tree_map(lambda a: np.asarray(rng.randn(*a.shape)).astype(a.dtype), shapes)
    ours, theirs = state_dict_from_jax(variables), export_parameters(variables)
    assert "encoder.ctc_fc.weight" in ours and tuple(ours["encoder.ctc_fc.weight"].shape)[0] == len(jsd)
    assert sorted(ours) == sorted(theirs)
    for name, arr in theirs.items():
        np.testing.assert_array_equal(ours[name].numpy(), arr, err_msg=name)
    task = SpeechTranslationCTCTask(argparse.Namespace(criterion="ctc_multi_loss"), torch_dictionary(), tsd)
    tmodel = tct.build_model(arch, task.target_dictionary, task.source_dictionary, device="cpu",
                             criterion="ctc_multi_loss", **over)
    tmodel.load_state_dict(ours, strict=True)


# ---------------------------------------------------------------------------
# criterions and the train step
# ---------------------------------------------------------------------------

TRAIN_ARGV = [
    "/nonexistent", "--task", "speech_translation_with_transcription", "-s", "en", "-t", "de",
    "--arch", "conv_transformer", "--criterion", "ctc_multi_loss",
    "--underlying-criterion", "label_smoothed_cross_entropy", "--label-smoothing", "0.1",
    "--ctc-encoder-layer", "1", "--ctc-weight", "0.5", "--ctc-compress-out",
    "--optimizer", "adam", "--adam-betas", "(0.9, 0.98)", "--lr", "0.002",
    "--lr-scheduler", "inverse_sqrt", "--warmup-updates", "2", "--clip-norm", "10.0",
    "--max-tokens", "4000", "--distributed-world-size", "1",
] + [f"--{k.replace('_', '-')}={v}" for k, v in SMALL.items()]


class _DeterministicJaxCTC(jcrit.CTCMultiLoss):
    def __call__(self, model, variables, batch, rng=None, training=False):
        return super().__call__(model, variables, batch, rng=rng, training=False)


class _DeterministicCTC(CTCMultiLoss):
    def __call__(self, model, batch, generator=None, training=False):
        return super().__call__(model, batch, generator, training=False)


class _Recorder:
    """The JAX ``metrics`` module's logging calls, recorded."""

    def __init__(self):
        self.values = {}

    def log_scalar(self, key, value, weight=1, priority=10, round=None):
        self.values[key] = float(value)

    def log_derived(self, key, fn, priority=20):
        self.values[key] = fn


@pytest.fixture(scope="module")
def train_run():
    """Three steps of the JAX Trainer and of the port's Trainer from the
    same weights, each step over two microbatches, so that each divides
    by the sum of the two returned sample sizes (JAX's ``ss_acc``)."""
    args = options.parse_args_and_arch(options.get_training_parser(), TRAIN_ARGV)
    jd = dummy_dictionary(VOCAB)
    jsd, tsd = _src_dicts()
    jtask = DummyTask(jd, jsd)
    jmodel = registry.build_model(args, jtask)
    jtrainer = JaxTrainer(args, jtask, jmodel, _DeterministicJaxCTC(jtask, args))
    gnorms = []
    log_training = jtrainer._log_training
    jtrainer._log_training = lambda lo, gnorm, meta: (gnorms.append(gnorm), log_training(lo, gnorm, meta))

    ttask = SpeechTranslationCTCTask(args, torch_dictionary(), tsd)
    tmodel = ttask.build_model(args, device="cpu")
    tmodel.load_state_dict(state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jtrainer.variables())),
                           strict=True)
    ttrainer = Trainer(args, ttask, tmodel, _DeterministicCTC(ttask, args))
    steps, lr_sum = [], 0.0
    for step in range(3):
        lr_sum += jtrainer.lr_scheduler.step_update(step)
        samples = [_batch(10 * step + i) for i in range(2)]
        steps.append((jtrainer.train_step(samples), ttrainer.train_step(samples), gnorms[step]))
    return jtrainer, ttrainer, steps, lr_sum


def test_ctc_multi_loss_train_steps_match_jax_trainer(train_run):
    """Per step: every logging output (loss, nll_loss, ctc_loss, counts,
    UER errors) at rtol 1e-5 and the gnorm at rtol 1e-5, so the gradients
    were divided by the criterion's returned (transcript) sample size and
    not by the logged (target) one; then every parameter and BatchNorm
    buffer at atol 1e-5 (the key-projection biases, whose exact gradient is
    0, at 2 x the summed lr, as in tests/test_torch_train.py)."""
    jtrainer, ttrainer, steps, lr_sum = train_run
    for step, (want, got, jgnorm) in enumerate(steps):
        assert float(got["sample_size"]) == want["sample_size"] != float(got["ctc_total"])
        for key in ("loss", "nll_loss", "ctc_loss", "ntokens", "nsentences", "ctc_errors", "ctc_total", "nframes"):
            np.testing.assert_allclose(float(got[key]), want[key], rtol=1e-5, err_msg=f"{key} step {step}")
        np.testing.assert_allclose(float(got["gnorm"]), jgnorm, rtol=1e-5, err_msg=f"gnorm step {step}")
    want_sd = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jtrainer.variables()))
    got_sd = ttrainer.model.state_dict()
    assert sorted(got_sd) == sorted(want_sd)
    for name, value in want_sd.items():
        atol = 2 * lr_sum if name.endswith("k_proj.bias") else 1e-5
        np.testing.assert_allclose(_np(got_sd[name]), value.numpy(), rtol=0, atol=atol, err_msg=name)


def test_ctc_multi_loss_reduce_metrics_match_jax(train_run):
    """The port's reduce_metrics against the values the JAX criterion
    logs, over the three steps' logging outputs: rtol 1e-6."""
    _, _, steps, _ = train_run
    rec = _Recorder()
    jcrit.CTCMultiLoss.reduce_metrics([want for want, _, _ in steps], rec)
    got = CTCMultiLoss.reduce_metrics([got for _, got, _ in steps])
    rec.values["ppl"] = jcrit.get_perplexity(rec.values["nll_loss"])
    assert sorted(got) == sorted(rec.values)
    for key, value in rec.values.items():
        np.testing.assert_allclose(got[key], value, rtol=1e-6, err_msg=key)


def test_ctc_criterion_matches_jax(ctc_pair):
    """ctc_loss (encoder-only CTC over the CTC head's logits, the blank in
    the criterion task's target dictionary, here the source dictionary):
    loss, returned sample size and logging outputs at rtol 1e-5, and
    reduce_metrics at rtol 1e-6, in eval mode; the JAX criterion runs under
    jit."""
    jmodel, variables, tmodel = _with_strategy(ctc_pair, "weighted")
    jsd, tsd = _src_dicts()
    SpeechTranslationCTCTask(argparse.Namespace(criterion="ctc_multi_loss"), torch_dictionary(), tsd)
    sample = _batch(5)
    sample["target"] = sample["transcript_target"]
    sample["target_lengths"] = sample["transcript_target_lengths"]
    crit_args = argparse.Namespace(sentence_avg=False)
    jc = jcrit.CTCCriterion(DummyTask(jsd), crit_args)
    tc = CTCCriterion(DummyTask(tsd), crit_args)
    jbatch = {k: jnp.asarray(v) for k, v in {**sample["net_input"], "target": sample["target"],
                                             "target_lengths": sample["target_lengths"]}.items()}
    jloss, jss, jlog = jax.jit(lambda v, b: jc(jmodel, v, b, training=False)[:3])(variables, jbatch)
    tloss, tss, tlog = tc(tmodel, _torch_batch(sample), training=False)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    assert int(tss) == int(jss)
    for key, value in jlog.items():
        np.testing.assert_allclose(float(tlog[key]), float(value), rtol=1e-5, err_msg=key)
    rec = _Recorder()
    jcrit.CTCCriterion.reduce_metrics([{k: float(v) for k, v in jlog.items()}], rec)
    got = CTCCriterion.reduce_metrics([tlog])
    assert sorted(got) == sorted(rec.values)
    for key, value in rec.values.items():
        np.testing.assert_allclose(got[key], value, rtol=1e-6, err_msg=key)


def test_task_adds_the_blank_after_the_source_symbols():
    """Under ctc_multi_loss the task appends <ctc_blank> (once) and the
    model's CTC head has len(src_dict) outputs; otherwise the dictionary
    is left alone."""
    sd = torch_dictionary(SRC_VOCAB)
    n = len(sd)
    task = SpeechTranslationCTCTask(argparse.Namespace(criterion="ctc_multi_loss"), torch_dictionary(), sd)
    assert task.source_dictionary.index("<ctc_blank>") == n and len(sd) == n + 1
    SpeechTranslationCTCTask(argparse.Namespace(criterion="ctc_multi_loss"), torch_dictionary(), sd)
    assert len(sd) == n + 1
    other = torch_dictionary(SRC_VOCAB)
    SpeechTranslationCTCTask(argparse.Namespace(criterion="label_smoothed_cross_entropy"), torch_dictionary(), other)
    assert "<ctc_blank>" not in other.indices
