"""PyTorch port, ``--eval-bleu`` (validation BLEU) and ``--sacrebleu``
against JAX.

The translation task of both packages on the same tiny
``dynamicconv_iwslt_de_en`` weights (seeded JAX init, bridged into the
port) and the same validation batch: ``valid_step_extra`` gives the same
sacrebleu sufficient statistics (``_bleu_sys_len``, ``_bleu_ref_len``,
``_bleu_counts_i``, ``_bleu_totals_i``; exact), and ``reduce_metrics``
the same ``bleu`` (exact), with each detokenizer and BPE setting of the
flags. Then the port's ``cli/train --eval-bleu --best-checkpoint-metric
bleu`` on that corpus logs a validation ``bleu`` and writes
``checkpoint_best.pt`` (as tests/test_translation.py holds JAX's), and
``cli/generate --sacrebleu`` prints JAX's BLEU line."""

import logging
import os

import jax
import numpy as np
import pytest

from fbk_fairseq_st_tpu import options as joptions
from fbk_fairseq_st_tpu.cli import generate as jgenerate
from fbk_fairseq_st_tpu.registry import TASKS as JTASKS
from fbk_fairseq_st_tpu.train import metrics as jmetrics
from fbk_fairseq_st_tpu.train.checkpoint import save_state
from fbk_fairseq_st_tpu_torch import options as toptions
from fbk_fairseq_st_tpu_torch.cli import generate as tgenerate
from fbk_fairseq_st_tpu_torch.cli import train as ttrain
from fbk_fairseq_st_tpu_torch.registry import TASKS as TTASKS
from fbk_fairseq_st_tpu_torch.train import metrics as tmetrics
from fbk_fairseq_st_tpu_torch.utils.weights import state_dict_from_jax

from .test_torch_interactive import ARCH
from .test_translation import create_translation_data

BLEU_ARGS = ["--eval-bleu", "--eval-bleu-args", '{"beam": 2, "max_len_b": 8}', "--eval-bleu-print-samples"]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("eval_bleu"))
    data_dir = os.path.join(root, "data")
    create_translation_data(data_dir, n=12)
    return root, data_dir


def _argv(data_dir, *extra):
    return [data_dir, "--task", "translation", "-s", "en", "-t", "de", *ARCH, "--criterion",
            "label_smoothed_cross_entropy", "--max-tokens", "200", *BLEU_ARGS, *extra]


class _JaxTrainer:
    def __init__(self, model, variables):
        self.model, self._variables = model, variables

    def variables(self):
        return self._variables


class _PortTrainer:
    def __init__(self, model):
        self.model = model


def _bleu_of(metrics, aggregate, outputs, task, criterion):
    with aggregate(new_root=True) as agg:
        task.reduce_metrics(outputs, criterion, metrics)
        return agg.get_smoothed_values()


@pytest.mark.parametrize("extra", [[], ["--eval-bleu-detok", "moses", "--eval-bleu-remove-bpe"],
                                   ["--eval-tokenized-bleu"]], ids=["space", "moses_remove-bpe", "tokenized"])
def test_validation_bleu_fields_match_jax(corpus, extra):
    _, data_dir = corpus
    argv = _argv(data_dir, *extra)
    jargs = joptions.parse_args_and_arch(joptions.get_training_parser(), argv)
    targs = toptions.parse_args_and_arch(toptions.get_training_parser(), argv)
    jtask = JTASKS[jargs.task].setup_task(jargs)
    ttask = TTASKS[targs.task].setup_task(targs)
    jmodel = jtask.build_model(jargs)
    variables = jax.tree_util.tree_map(np.asarray, jax.jit(jmodel.init)(jax.random.PRNGKey(2)))
    tmodel = ttask.build_model(targs, device="cpu")
    tmodel.load_state_dict(state_dict_from_jax(variables), strict=True)
    jtask.load_dataset("valid")
    ds = jtask.dataset("valid")
    sample = ds.collater([ds[i] for i in range(len(ds))])
    want = jtask.valid_step_extra(sample, _JaxTrainer(jmodel, variables))
    got = ttask.valid_step_extra(sample, _PortTrainer(tmodel))
    assert sorted(got) == sorted(want) and len(got) == 10
    assert got == want
    assert tmodel.training  # the decode leaves the trainer's mode as it found it
    jbleu = _bleu_of(jmetrics, jmetrics.aggregate, [want], jtask, None)
    tbleu = _bleu_of(tmetrics, tmetrics.aggregate, [got], ttask, None)
    assert tbleu["bleu"] == jbleu["bleu"]


def test_train_logs_validation_bleu(corpus, caplog):
    root, data_dir = corpus
    save_dir = os.path.join(root, "train")
    with caplog.at_level(logging.INFO):
        ttrain.cli_main(_argv(data_dir, "--save-dir", save_dir, "--optimizer", "adam", "--lr", "0.001",
                              "--max-epoch", "1", "--best-checkpoint-metric", "bleu",
                              "--maximize-best-checkpoint-metric", "--cpu", "--log-format", "simple"))
    assert "checkpoint_best.pt" in os.listdir(save_dir)
    text = caplog.text
    assert "example hypothesis" in text and "example reference" in text
    assert "bleu" in text


def test_generate_sacrebleu_matches_jax(corpus):
    root, data_dir = corpus
    args = joptions.parse_args_and_arch(joptions.get_training_parser(), _argv(data_dir))
    task = JTASKS[args.task].setup_task(args)
    args.eval_bleu = False
    model = task.build_model(args)
    variables = jax.tree_util.tree_map(np.asarray, jax.jit(model.init)(jax.random.PRNGKey(3)))
    ckpt = os.path.join(root, "checkpoint.pt")
    save_state(ckpt, {"args": vars(args), "model": variables["params"], "model_state": variables["state"]})
    argv = [data_dir, "--task", "translation", "-s", "en", "-t", "de", "--path", ckpt, "--beam", "2",
            "--max-len-b", "8", "--gen-subset", "test", "--cpu", "--sacrebleu", "--quiet"]
    want = jgenerate.cli_main(argv + ["--results-path", os.path.join(root, "jax")])
    got = tgenerate.cli_main(argv + ["--results-path", os.path.join(root, "port")])
    assert str(got.result_string()) == str(want.result_string())
    assert got.sys == want.sys and got.ref == want.ref and len(got.sys) == 4


def test_namespace_of_eval_bleu_generator_args(corpus):
    """--eval-bleu-args is JSON of generator settings, as in JAX."""
    _, data_dir = corpus
    targs = toptions.parse_args_and_arch(toptions.get_training_parser(), _argv(data_dir))
    ttask = TTASKS[targs.task].setup_task(targs)
    ttask.build_model(targs, device="cpu")
    assert ttask._bleu_generator.beam_size == 2
    assert ttask.tokenizer.encode(" a  b ") == "a b"  # --eval-bleu-detok space
