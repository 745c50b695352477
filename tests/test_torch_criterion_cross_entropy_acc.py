"""PyTorch port, ``cross_entropy_acc``: the upstream ASR recipe's criterion
(the summed NLL of the non-pad targets with the argmax's ``correct`` and
``total``) against JAX's ``CrossEntropyWithAccCriterion``
(``criterions/cross_entropy_acc.py``) on the same numpy inputs and weights,
on the CPU; its ``reduce_metrics``; and ``cli/train --criterion
cross_entropy_acc`` on a conv_transformer.

The model is tests/test_torch_criterion_cross_entropy.py's tiny
conv_transformer in eval mode, fp32. Tolerances are stated per test."""

import argparse
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fbk_fairseq_st_tpu.criterions import cross_entropy_acc as jacc
from fbk_fairseq_st_tpu_torch.cli import train as ttrain
from fbk_fairseq_st_tpu_torch.criterions import CRITERIONS, CrossEntropyWithAccCriterion
from fbk_fairseq_st_tpu_torch.train import metrics
from fbk_fairseq_st_tpu_torch.utils.weights import state_dict_from_jax

from .test_binaries import create_dummy_speech_data
from .test_torch_criterion_cross_entropy import TINY_ARGV, _np, _pair
from .test_torch_ctc import _Recorder, _batch, _torch_batch
from .test_torch_model import VOCAB, torch_dictionary
from .utils import DummyTask, dummy_dictionary


@pytest.mark.parametrize("sentence_avg", [False, True], ids=["per_token", "sentence_avg"])
def test_loss_counts_and_gradients_match_jax(sentence_avg):
    """Eval mode, the same weights and batch (a padded target tail): the
    loss, ``correct``, ``total``, the sample size and every logging output
    within 1e-5 (rtol 1e-6 for sums above 10), the counts exactly, and the
    gradient of the loss in every parameter within 1e-5 of ``jax.grad``'s."""
    jmodel, variables, tmodel = _pair()
    crit_args = argparse.Namespace(sentence_avg=sentence_avg)
    jc = jacc.CrossEntropyWithAccCriterion(DummyTask(dummy_dictionary(VOCAB)), crit_args)
    tc = CRITERIONS["cross_entropy_acc"].build_criterion(crit_args, DummyTask(torch_dictionary(VOCAB)))
    sample = _batch(seed=7)
    jbatch = {k: jnp.asarray(v) for k, v in {**sample["net_input"], "target": sample["target"]}.items()}

    def loss_fn(params):
        loss, ss, log, _ = jc(jmodel, {"params": params, "state": variables["state"]}, jbatch, training=False)
        return loss, (ss, log)

    (jloss, (jss, jlog)), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])
    tloss, tss, tlog = tc(tmodel, _torch_batch({"net_input": sample["net_input"], "target": sample["target"]}),
                          training=False)
    tloss.backward()
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), rtol=1e-6, atol=1e-5)
    n_tokens = int((sample["target"] != 1).sum())
    assert int(tss) == int(jss) == (3 if sentence_avg else n_tokens)
    assert sorted(tlog) == sorted(jlog) == ["correct", "loss", "nsentences", "ntokens", "sample_size", "total"]
    for key, value in jlog.items():
        np.testing.assert_allclose(float(tlog[key]), float(value), rtol=1e-6, atol=1e-5, err_msg=key)
    assert int(tlog["correct"]) == int(jlog["correct"]) and int(tlog["total"]) == n_tokens
    want = state_dict_from_jax({"params": jax.tree_util.tree_map(np.asarray, jgrads)})
    got = {name: p.grad for name, p in tmodel.named_parameters()}
    assert sorted(got) == sorted(want)
    for name, grad in want.items():
        np.testing.assert_allclose(_np(got[name]), grad.numpy(), rtol=0, atol=1e-5, err_msg=name)


def test_accuracy_counts_the_argmax_hits():
    """With the target set to the model's own argmax on the first row (its
    last token a pad) and to another token on the rest, ``correct`` is the
    first row's non-pad count and ``total`` the batch's: the accuracy is
    computed, not copied from JAX."""
    _, _, tmodel = _pair()
    tc = CRITERIONS["cross_entropy_acc"].build_criterion(argparse.Namespace(), DummyTask(torch_dictionary(VOCAB)))
    batch = _torch_batch({"net_input": _batch(seed=2)["net_input"], "target": _batch(seed=2)["target"]})
    with torch.no_grad():
        preds = tmodel(batch)[0].argmax(-1)
    target = torch.where(preds == 4, 5, 4)
    target[0] = preds[0]
    target[0, -1] = 1  # one pad
    batch["target"] = target
    _, _, log = tc(tmodel, batch)
    assert int(log["correct"]) == int((target[0] != 1).sum()) > 0
    assert int(log["total"]) == int((target != 1).sum())


@pytest.mark.parametrize("sentence_avg", [False, True], ids=["per_token", "sentence_avg"])
def test_reduce_metrics_match_jax(sentence_avg):
    """The values JAX's ``reduce_metrics`` logs, within 1e-12: the loss per
    sample-size unit in base 2 and ``accuracy`` = 100 correct / total; no
    ``accuracy`` when no target was counted."""
    logs = [{"loss": 30.5, "ntokens": 12, "nsentences": 3, "sample_size": 3 if sentence_avg else 12,
             "correct": 7, "total": 12},
            {"loss": 11.25, "ntokens": 5, "nsentences": 2, "sample_size": 2 if sentence_avg else 5,
             "correct": 1, "total": 5}]
    rec = _Recorder()
    jacc.CrossEntropyWithAccCriterion.reduce_metrics(logs, rec)
    got = CrossEntropyWithAccCriterion.reduce_metrics([{k: torch.tensor(v) for k, v in log.items()} for log in logs],
                                                      rec)
    assert sorted(got) == sorted(rec.values) == ["accuracy", "loss"]
    for key in got:
        np.testing.assert_allclose(got[key], rec.values[key], rtol=1e-12, err_msg=key)
    assert got["accuracy"] == 100.0 * 8 / 17
    empty = [{"loss": 1.0, "sample_size": 1, "correct": 0, "total": 0}]
    rec = _Recorder()
    jacc.CrossEntropyWithAccCriterion.reduce_metrics(empty, rec)
    assert sorted(CrossEntropyWithAccCriterion.reduce_metrics(empty, _Recorder())) == sorted(rec.values) == ["loss"]


def test_train_cli_trains_conv_transformer(tmp_path, monkeypatch):
    """``cli/train --criterion cross_entropy_acc`` trains a conv_transformer
    for an epoch on the JAX CLIs' dummy corpus: the logged losses and
    accuracies finite, the accuracies within [0, 100],
    ``checkpoint_last.pt`` written."""
    data_dir = str(tmp_path / "data")
    create_dummy_speech_data(data_dir, n=8)
    argv = [data_dir, "--task", "speech_recognition", "-t", "de", "--arch", "conv_transformer", "--criterion",
            "cross_entropy_acc", "--optimizer", "adam", "--lr", "0.001", "--max-tokens", "400", "--max-epoch", "1",
            "--log-format", "none", "--save-dir", str(tmp_path / "ckpt"), "--cpu", *TINY_ARGV]
    logged, log_scalar = [], metrics.log_scalar
    monkeypatch.setattr(metrics, "log_scalar", lambda key, value, *a, **k: (
        logged.append((key, float(value))) if key in ("loss", "accuracy") else None,
        log_scalar(key, value, *a, **k)))
    trainer, _ = ttrain.cli_main(argv)
    assert isinstance(trainer.criterion, CrossEntropyWithAccCriterion) and trainer.get_num_updates() > 0
    assert "checkpoint_last.pt" in os.listdir(tmp_path / "ckpt")
    accuracies = [v for k, v in logged if k == "accuracy"]
    assert accuracies and all(0.0 <= a <= 100.0 for a in accuracies)
    assert np.isfinite([v for _, v in logged]).all()
