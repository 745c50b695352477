"""PyTorch port, ``cross_entropy``: the parser's default criterion, the
plain NLL over the non-pad targets, against JAX's ``CrossEntropyCriterion``
(``criterions/label_smoothed_cross_entropy.py:131-176``) on the same numpy
inputs and weights, on the CPU; ``cli/train`` with no ``--criterion``; and
``ctc_multi_loss --underlying-criterion cross_entropy``.

The model is a tiny conv_transformer (tests/test_torch_model.py's SMALL)
with seeded weights in the shapes of the JAX init; everything is fp32 in
eval mode. Tolerances are stated per test."""

import argparse
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fbk_fairseq_st_tpu import options as joptions
from fbk_fairseq_st_tpu import registry
from fbk_fairseq_st_tpu.criterions import ctc as jctc
from fbk_fairseq_st_tpu.criterions import label_smoothed_cross_entropy as jlsce
from fbk_fairseq_st_tpu_torch import options as toptions
from fbk_fairseq_st_tpu_torch.cli import train as ttrain
from fbk_fairseq_st_tpu_torch.criterions import CRITERIONS, CrossEntropyCriterion, CTCMultiLoss
from fbk_fairseq_st_tpu_torch.models import conv_transformer as tct
from fbk_fairseq_st_tpu_torch.tasks import SpeechTranslationCTCTask
from fbk_fairseq_st_tpu_torch.train import Trainer
from fbk_fairseq_st_tpu_torch.utils.weights import state_dict_from_jax

from .test_binaries import create_dummy_speech_data
from .test_torch_ctc import TRAIN_ARGV as CTC_ARGV
from .test_torch_ctc import _Recorder, _batch, _src_dicts, _torch_batch
from .test_torch_model import SMALL, VOCAB, torch_dictionary
from .utils import DummyTask, dummy_dictionary, model_args


def _np(x):
    return np.asarray(x.detach()) if isinstance(x, torch.Tensor) else np.asarray(x)


def _variables(jmodel, seed=0):
    """Seeded values in the shapes of the JAX init (a jitted init costs
    seconds on the CPU), BatchNorm variances positive."""
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        if getattr(path[-1], "key", None) == "var":
            return rng.uniform(0.5, 1.5, leaf.shape).astype(leaf.dtype)
        return (0.2 * rng.randn(*leaf.shape)).astype(leaf.dtype)

    return jax.tree_util.tree_map_with_path(fill, jax.eval_shape(jmodel.init, jax.random.PRNGKey(0)))


def _pair(criterion="cross_entropy", src_dicts=None, **over):
    """(JAX model, its variables, the port's model with them); ``src_dicts``
    the JAX and the port's source dictionaries, each with its blank."""
    args = model_args("conv_transformer", criterion=criterion, **{**SMALL, **over})
    registry.apply_architecture(args)
    jsd, tsd = src_dicts or (None, None)
    jmodel = registry.build_model(args, DummyTask(dummy_dictionary(VOCAB), jsd))
    variables = _variables(jmodel)
    tmodel = tct.build_model("conv_transformer", torch_dictionary(VOCAB), tsd, device="cpu", criterion=criterion,
                             **{**SMALL, **over})
    tmodel.load_state_dict(state_dict_from_jax(variables), strict=True)
    return jmodel, variables, tmodel


@pytest.mark.parametrize("sentence_avg", [False, True], ids=["per_token", "sentence_avg"])
def test_loss_and_gradients_match_jax(sentence_avg):
    """Eval mode, the same weights and batch (a padded target tail): the
    summed NLL, the sample size (tokens, or sentences with
    ``--sentence-avg``), every logging output within 1e-5 (rtol 1e-6 for
    sums above 10), and the gradient of the loss in every parameter within
    1e-5 of ``jax.grad``'s."""
    jmodel, variables, tmodel = _pair()
    crit_args = argparse.Namespace(sentence_avg=sentence_avg)
    jc = jlsce.CrossEntropyCriterion(DummyTask(dummy_dictionary(VOCAB)), crit_args)
    tc = CRITERIONS["cross_entropy"].build_criterion(crit_args, DummyTask(torch_dictionary(VOCAB)))
    sample = _batch(seed=3)
    flat = {**sample["net_input"], "target": sample["target"]}
    jbatch = {k: jnp.asarray(v) for k, v in flat.items()}

    def loss_fn(params):
        loss, ss, log, _ = jc(jmodel, {"params": params, "state": variables["state"]}, jbatch, training=False)
        return loss, (ss, log)

    (jloss, (jss, jlog)), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])
    tloss, tss, tlog = tc(tmodel, _torch_batch({"net_input": sample["net_input"], "target": sample["target"]}),
                          training=False)
    tloss.backward()
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), rtol=1e-6, atol=1e-5)
    assert int(tss) == int(jss) == (3 if sentence_avg else int((sample["target"] != 1).sum()))
    assert sorted(tlog) == sorted(jlog) == ["loss", "nsentences", "ntokens", "sample_size"]
    for key, value in jlog.items():
        np.testing.assert_allclose(float(tlog[key]), float(value), rtol=1e-6, atol=1e-5, err_msg=key)
    want = state_dict_from_jax({"params": jax.tree_util.tree_map(np.asarray, jgrads)})
    got = {name: p.grad for name, p in tmodel.named_parameters()}
    assert sorted(got) == sorted(want)
    for name, grad in want.items():
        np.testing.assert_allclose(_np(got[name]), grad.numpy(), rtol=0, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("sentence_avg", [False, True], ids=["per_token", "sentence_avg"])
def test_reduce_metrics_match_jax(sentence_avg):
    """The values JAX's ``reduce_metrics`` logs, within 1e-12: loss per
    sample-size unit in base 2, and ``nll_loss`` per token only when the
    sample size counts sentences; ``ppl`` from whichever is per token."""
    logs = [{"loss": 30.5, "ntokens": 12, "nsentences": 3, "sample_size": 3 if sentence_avg else 12},
            {"loss": 11.25, "ntokens": 5, "nsentences": 2, "sample_size": 2 if sentence_avg else 5}]
    rec = _Recorder()
    jlsce.CrossEntropyCriterion.reduce_metrics(logs, rec)
    got = CrossEntropyCriterion.reduce_metrics([{k: torch.tensor(v) for k, v in log.items()} for log in logs], rec)
    for key in ("loss", "nll_loss"):
        assert (key in got) == (key in rec.values), key
        if key in got:
            np.testing.assert_allclose(got[key], rec.values[key], rtol=1e-12, err_msg=key)
    per_token = got["nll_loss"] if sentence_avg else got["loss"]
    assert got["ppl"] == jlsce.get_perplexity(per_token)
    assert "nll_loss" in got if sentence_avg else "nll_loss" not in got


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    data_dir = str(tmp_path_factory.mktemp("cross_entropy") / "data")
    create_dummy_speech_data(data_dir, n=8)
    return data_dir


TINY_ARGV = ["--encoder-layers", "1", "--decoder-layers", "1", "--encoder-embed-dim", "16", "--decoder-embed-dim",
             "16", "--encoder-ffn-embed-dim", "32", "--decoder-ffn-embed-dim", "32", "--encoder-attention-heads",
             "2", "--decoder-attention-heads", "2", "--encoder-convolutions", "[(4, 3, 3)] * 2",
             "--input-feat-per-channel", "8", "--max-source-positions", "64", "--max-target-positions", "32"]


def test_train_cli_without_criterion_trains_with_cross_entropy(corpus, tmp_path, monkeypatch):
    """``cli/train`` with no ``--criterion`` (the parser's default, as JAX's
    parser gives it) trains with ``cross_entropy`` for an epoch: its logged
    losses finite, ``checkpoint_last.pt`` written."""
    argv = [corpus, "--task", "speech_recognition", "-t", "de", "--arch", "conv_transformer", "--optimizer", "adam",
            "--lr", "0.001", "--max-tokens", "400", "--max-epoch", "1", "--log-format", "none",
            "--save-dir", str(tmp_path / "ckpt"), "--cpu", *TINY_ARGV]
    jargs = joptions.parse_args_and_arch(joptions.get_training_parser(), argv)
    targs = toptions.parse_args_and_arch(toptions.get_training_parser(), argv)
    assert targs.criterion == jargs.criterion == "cross_entropy"
    from fbk_fairseq_st_tpu_torch.train import metrics

    losses, log_scalar = [], metrics.log_scalar
    monkeypatch.setattr(metrics, "log_scalar", lambda key, value, *a, **k: (
        losses.append(float(value)) if key == "loss" else None, log_scalar(key, value, *a, **k)))
    trainer, _ = ttrain.cli_main(argv)
    assert isinstance(trainer.criterion, CrossEntropyCriterion) and trainer.get_num_updates() > 0
    assert "checkpoint_last.pt" in os.listdir(tmp_path / "ckpt")
    assert losses and np.isfinite(losses).all()


def test_ctc_multi_loss_over_cross_entropy(tmp_path):
    """``ctc_multi_loss --underlying-criterion cross_entropy``: the criterion
    (CTC weight 0.5 after layer 1, compression) gives JAX's loss, nll_loss,
    ctc_loss and counts within 1e-5 (rtol 1e-6) in eval mode on the same
    weights; then one update of the port's Trainer takes it, its loss
    finite and every parameter moved or kept as its gradient says."""
    argv = [a if a != "label_smoothed_cross_entropy" else "cross_entropy" for a in CTC_ARGV]
    argv = [a for a in argv if a not in ("--label-smoothing", "0.1")]
    args = joptions.parse_args_and_arch(joptions.get_training_parser(), argv)
    jsd, tsd = _src_dicts()
    targs = toptions.parse_args_and_arch(toptions.get_training_parser(), argv)
    ttask = SpeechTranslationCTCTask(targs, torch_dictionary(VOCAB), tsd)  # appends the blank
    jmodel, variables, tmodel = _pair("ctc_multi_loss", (jsd, ttask.source_dictionary), ctc_compress_out=True,
                                      ctc_encoder_layer=1)
    jtask = DummyTask(dummy_dictionary(VOCAB), jsd)
    jc = jctc.CTCMultiLoss(jtask, args)
    tc = ttask.build_criterion(targs)
    assert isinstance(tc, CTCMultiLoss) and isinstance(tc.real_criterion, CrossEntropyCriterion)
    sample = _batch(seed=5)
    jbatch = {k: jnp.asarray(v) for k, v in {**sample["net_input"], **{
        k: v for k, v in sample.items() if k not in ("net_input", "ntokens", "nsentences")}}.items()}
    jloss, jss, jlog, _ = jax.jit(lambda v, b: jc(jmodel, v, b, training=False))(variables, jbatch)
    tloss, tss, tlog = tc(tmodel, _torch_batch(sample), training=False)
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), rtol=1e-6, atol=1e-5)
    assert int(tss) == int(jss)
    for key in ("loss", "nll_loss", "ctc_loss", "ntokens", "nsentences", "sample_size", "ctc_errors", "ctc_total"):
        np.testing.assert_allclose(float(tlog[key]), float(jlog[key]), rtol=1e-6, atol=1e-5, err_msg=key)
    model = ttask.build_model(targs, device="cpu")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    trainer = Trainer(targs, ttask, model, ttask.build_criterion(targs))
    logs = trainer.train_step([sample])
    trainer.flush_logs()
    assert np.isfinite(float(logs["loss"])) and float(logs["ctc_loss"]) > 0
    assert any(not torch.equal(before[k], v) for k, v in model.state_dict().items())
