"""PyTorch port, training from files: the port's ``cli/train`` against JAX's.

The JAX package writes a tiny speech-translation corpus (train, valid and
test splits of filterbanks, target and transcript text) with its own
``preprocess_audio`` and ``preprocess`` CLIs, and a seeded
``checkpoint_last.pt`` (``save_state``: a tiny ``conv_transformer``'s
weights and its optimiser's optax state, update 0) that goes into both save
dirs. Both CLIs then train from it for 2 epochs in fp32 with dropout 0,
``--log-format json --log-interval 1``, batches padded to JAX's shape
buckets on both sides. The criterion runs its model in eval mode on both
sides (as ``tests/test_torch_train.py``'s parity steps do): the conv front
end's dropout has a floor of 0.1 that no flag lowers, and the two sides
cannot draw the same bits. Compared, with the values each side hands to
its metrics stack (``metrics.log_scalar``, before rounding):

  * every update's loss, nll_loss, gnorm and lr, and every validation
    batch's loss and nll_loss: rtol 1e-5 (the same fp32 arithmetic in
    another order, over 8 updates);
  * the checkpoint files' names: identical;
  * the final parameters (JAX's through ``state_dict_from_jax``): atol 1e-5
    (the attention's key bias, whose gradient is 0 up to rounding, within
    the steps' sum of lr).

Three cases: label-smoothed CE with Adam and inverse_sqrt, ``ctc_multi_loss``
with CTC compression, and the parser's default ``nag`` + ``fixed``. Then
the port resumes JAX's end-of-epoch-1 ``checkpoint1.pt`` (its Adam moments
read without jax, the iterator and the scheduler state carried across)
and matches JAX's epoch 2 at the same tolerances.
"""

import json
import logging
import os
import shutil
import sys

import jax
import numpy as np
import pytest
import torch

from fbk_fairseq_st_tpu import options as joptions
from fbk_fairseq_st_tpu import registry as jregistry
from fbk_fairseq_st_tpu.cli import preprocess as jpreprocess
from fbk_fairseq_st_tpu.cli import preprocess_audio as jpreprocess_audio
from fbk_fairseq_st_tpu.cli import train as jtrain
from fbk_fairseq_st_tpu.train import checkpoint as jcheckpoint
from fbk_fairseq_st_tpu.train import metrics as jmetrics
from fbk_fairseq_st_tpu_torch import criterions as tcriterions
from fbk_fairseq_st_tpu_torch import options as toptions
from fbk_fairseq_st_tpu_torch.cli import train as ttrain
from fbk_fairseq_st_tpu_torch.train import checkpoint as tcheckpoint
from fbk_fairseq_st_tpu_torch.train import metrics as tmetrics
from fbk_fairseq_st_tpu_torch.utils.weights import state_dict_from_jax

from .test_torch_model import torch_dictionary

N_MELS = 8
SPLITS = {"train": 16, "valid": 6, "test": 6}
RTOL = 1e-5
ATOL_PARAMS = 1e-5
LOGGED = ("loss", "nll_loss", "gnorm", "lr")
MODEL = ["--arch", "conv_transformer", "--encoder-layers", "2", "--decoder-layers", "1", "--encoder-embed-dim", "16",
         "--decoder-embed-dim", "16", "--encoder-ffn-embed-dim", "32", "--decoder-ffn-embed-dim", "32",
         "--encoder-attention-heads", "2", "--decoder-attention-heads", "2",
         "--encoder-convolutions", "[(4, 3, 3)] * 2", "--input-feat-per-channel", str(N_MELS),
         "--max-source-positions", "64", "--max-target-positions", "32",
         "--dropout", "0", "--attention-dropout", "0", "--relu-dropout", "0"]
CASES = {
    "label_smoothed_cross_entropy": ["--criterion", "label_smoothed_cross_entropy", "--label-smoothing", "0.1",
                                     "--optimizer", "adam", "--adam-betas", "(0.9, 0.98)", "--lr", "0.002",
                                     "--lr-scheduler", "inverse_sqrt", "--warmup-updates", "4", "--clip-norm", "10"],
    "ctc_multi_loss": ["--criterion", "ctc_multi_loss", "--underlying-criterion", "label_smoothed_cross_entropy",
                       "--label-smoothing", "0.1", "--ctc-encoder-layer", "1", "--ctc-compress-out",
                       "--ctc-weight", "0.5", "--optimizer", "adam", "--lr", "0.002", "--lr-scheduler",
                       "inverse_sqrt", "--warmup-updates", "4", "--clip-norm", "10"],
    "nag_fixed": ["--criterion", "label_smoothed_cross_entropy", "--lr", "0.05"],
}


def write_corpus(data_dir, rng):
    """Each split's 33-46-frame utterances (one source bucket, 46), 2-6
    target and transcript tokens (one target bucket, 8)."""
    os.makedirs(data_dir, exist_ok=True)
    for split, n in SPLITS.items():
        raw = os.path.join(data_dir, f"{split}_raw.npz")
        feats = [rng.randn(rng.randint(33, 47), N_MELS).astype(np.float32) for _ in range(n)]
        with open(raw, "wb") as f:
            np.save(f, np.array([len(feats)]))
            for feat in feats:
                np.save(f, feat)
        jpreprocess_audio.cli_main(["--audio-features", raw, "--format", "npz",
                                    "--output", os.path.join(data_dir, f"{split}.npz")])
        for lang, vocab in (("de", 12), ("en", 9)):
            with open(os.path.join(data_dir, f"{split}_raw.{lang}"), "w") as f:
                for _ in range(n):
                    f.write(" ".join(f"{lang}{rng.randint(vocab)}" for _ in range(rng.randint(2, 7))) + "\n")
    for lang in ("de", "en"):
        prefix = os.path.join(data_dir, "{}_raw")
        jpreprocess.cli_main(["--target-lang", lang, "--trainpref", prefix.format("train"),
                              "--validpref", prefix.format("valid"), "--testpref", prefix.format("test"),
                              "--destdir", data_dir, "--dataset-impl", "cached"])


def argv(data_dir, save_dir, case, *extra):
    return [data_dir, "--task", "speech_translation_with_transcription", "-s", "en", "-t", "de", *MODEL,
            *CASES[case], "--max-sentences", "4", "--max-epoch", "2", "--log-format", "json", "--log-interval", "1",
            "--save-dir", save_dir, "--seed", "3", "--cpu", *extra]


def seed_checkpoint(path, data_dir, case):
    """JAX's update-0 state of ``case``: a seeded model and its optimiser's
    fresh optax state, as ``save_state`` writes a training run's."""
    args = joptions.parse_args_and_arch(joptions.get_training_parser(), argv(data_dir, "unused", case))
    task = jregistry.TASKS[args.task].setup_task(args)
    model = jregistry.build_model(args, task)
    variables = jax.tree_util.tree_map(np.asarray, jax.jit(model.init)(jax.random.PRNGKey(5)))
    opt_state = jregistry.OPTIMIZERS[args.optimizer].build_optimizer(args).init(variables["params"])
    jcheckpoint.save_state(path, {
        "args": vars(args), "model": variables["params"], "model_state": variables["state"],
        "opt_state": jax.tree_util.tree_map(np.asarray, opt_state), "lr_scheduler": None, "num_updates": 0,
    })


class Recorder:
    """The (key, value) pairs a metrics module's ``log_scalar`` is handed."""

    def __init__(self, monkeypatch, module):
        self.calls = []
        original = module.log_scalar

        def log_scalar(key, value, *a, **k):
            if key in LOGGED:
                self.calls.append((key, float(value)))
            return original(key, value, *a, **k)

        monkeypatch.setattr(module, "log_scalar", log_scalar)


def deterministic(cls):
    """``cls`` with its model in eval mode whatever the trainer asks."""

    class Deterministic(cls):
        def __call__(self, *args, training=False, **kwargs):
            return super().__call__(*args, training=False, **kwargs)

    return Deterministic


def eval_mode_criterions(m) -> None:
    for name in ("label_smoothed_cross_entropy", "ctc_multi_loss"):
        m.setitem(jregistry.CRITERIONS._entries, name, deterministic(jregistry.CRITERIONS[name]))
        m.setitem(tcriterions.CRITERIONS, name, deterministic(tcriterions.CRITERIONS[name]))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("train_cli"))
    data_dir = os.path.join(root, "data")
    write_corpus(data_dir, np.random.RandomState(0))
    return root, data_dir


def run_pair(root, data_dir, case, monkeypatch, jax_extra=(), port_extra=()):
    """JAX's and the port's cli/train on ``case`` from the same seeded
    checkpoint: (their logged values, their save dirs)."""
    seeded = os.path.join(root, f"seed_{case}.pt")
    if not os.path.exists(seeded):
        seed_checkpoint(seeded, data_dir, case)
    out = []
    for name, cli, module, extra in (("jax", jtrain, jmetrics, jax_extra), ("port", ttrain, tmetrics, port_extra)):
        save_dir = os.path.join(root, f"{name}_{case}_{len(extra)}")
        shutil.rmtree(save_dir, ignore_errors=True)
        os.makedirs(save_dir)
        shutil.copyfile(seeded, os.path.join(save_dir, "checkpoint_last.pt"))
        with monkeypatch.context() as m:
            eval_mode_criterions(m)
            rec = Recorder(m, module)
            cli.cli_main(argv(data_dir, save_dir, case, *extra))
        out.append((rec.calls, save_dir))
    return out


def assert_same_logs(got, want):
    assert [k for k, _ in got] == [k for k, _ in want]
    np.testing.assert_allclose([v for _, v in got], [v for _, v in want], rtol=RTOL, atol=0)


def final_params(save_dir, name="checkpoint_last.pt"):
    state = tcheckpoint.load_checkpoint_to_cpu(os.path.join(save_dir, name))
    return state["model"]


def assert_same_params(got, want, updates=8, lr=0.05):
    """atol 1e-5, but for the attention's key bias: softmax does not depend
    on it, so its gradient is 0 up to rounding, which Adam scales to a step
    of up to lr either way; it is held to updates * lr."""
    assert sorted(got) == sorted(want)
    for k in want:
        atol = updates * lr if k.endswith("k_proj.bias") else ATOL_PARAMS
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0, atol=atol, err_msg=k)


@pytest.fixture(scope="module")
def runs(corpus):
    return {}


@pytest.mark.parametrize("case", sorted(CASES))
def test_train_matches_jax(corpus, runs, case, monkeypatch):
    """2 epochs (8 updates, 2 validations) from the same checkpoint: the
    same logged values, checkpoint names and final parameters."""
    root, data_dir = corpus
    (want, jdir), (got, tdir) = run_pair(root, data_dir, case, monkeypatch)
    runs[case] = (want, jdir, tdir)
    n_updates = sum(k == "gnorm" for k, _ in want)
    assert n_updates == 8 and sum(k == "loss" for k, _ in want) == 8 + 2 * 2
    assert all(np.isfinite(v) for _, v in want)
    assert_same_logs(got, want)
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir)) == [
        "checkpoint1.pt", "checkpoint2.pt", "checkpoint_best.pt", "checkpoint_last.pt"]
    assert_same_params(final_params(tdir), final_params(jdir))
    port = torch.load(os.path.join(tdir, "checkpoint_last.pt"), weights_only=False)
    jax_state = jcheckpoint.load_checkpoint_to_cpu(os.path.join(jdir, "checkpoint_last.pt"))
    assert port["extra_state"]["train_iterator"] == jax_state["extra_state"]["train_iterator"]
    assert port["optimizer_history"][-1]["num_updates"] == jax_state["num_updates"] == 8
    assert port["optimizer_history"][-1]["lr_scheduler_state"] == pytest.approx(jax_state["lr_scheduler"])
    np.testing.assert_allclose(port["extra_state"]["best"], jax_state["extra_state"]["best"], rtol=RTOL)


def test_port_resumes_jax_checkpoint(corpus, runs, monkeypatch):
    """The port resumes JAX's ``checkpoint1.pt`` (end of epoch 1: its Adam
    moments, the scheduler, the iterator, the best loss) and trains epoch 2
    as JAX's uninterrupted run did."""
    root, data_dir = corpus
    case = "label_smoothed_cross_entropy"
    if case not in runs:
        test_train_matches_jax(corpus, runs, case, monkeypatch)
    want, jdir, _ = runs[case]
    save_dir = os.path.join(root, "port_resumes_jax")
    shutil.rmtree(save_dir, ignore_errors=True)
    os.makedirs(save_dir)
    shutil.copyfile(os.path.join(jdir, "checkpoint1.pt"), os.path.join(save_dir, "checkpoint_last.pt"))
    with monkeypatch.context() as m:
        eval_mode_criterions(m)
        rec = Recorder(m, tmetrics)
        trainer, epoch_itr = ttrain.cli_main(argv(data_dir, save_dir, case))
    assert trainer.get_num_updates() == 8 and epoch_itr.epoch == 2
    # JAX's epoch 2: its last 4 updates and its second validation
    epoch2 = want[len(want) - len(rec.calls):]
    assert len(rec.calls) == 4 * 4 + 2 * 2
    assert_same_logs(rec.calls, epoch2)
    assert_same_params(final_params(save_dir), final_params(jdir))


def test_train_needs_the_card_without_cpu(corpus, monkeypatch):
    root, data_dir = corpus
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = [a for a in argv(data_dir, os.path.join(root, "no_card"), "nag_fixed") if a != "--cpu"]
    with pytest.raises(RuntimeError):
        ttrain.cli_main(args)


@pytest.mark.parametrize("extra", [
    ["--steps-per-execution", "2"], ["--quantization-config-path", "q.yaml"],
], ids=lambda e: e[0].lstrip("-"))
def test_unported_training_options_raise(corpus, extra):
    """--steps-per-execution is unported (ROADMAP Queue A item 8); iPQ is
    ported and, as JAX's, reads its config first: a missing
    one raises FileNotFoundError."""
    root, data_dir = corpus
    expected = FileNotFoundError if extra[0] == "--quantization-config-path" else NotImplementedError
    with pytest.raises(expected):
        ttrain.cli_main(argv(data_dir, os.path.join(root, "unported"), "nag_fixed", *extra))


def test_eval_bleu_raises(monkeypatch):
    """--eval-bleu, a flag of the translation task, raises when the task
    is set up and ``sacrebleu`` is missing (as on the card's machine),
    naming the package."""
    from fbk_fairseq_st_tpu_torch.tasks.translation import TranslationTask

    args = toptions.parse_args_and_arch(toptions.get_training_parser(), [
        "/nonexistent", "--task", "translation", "-s", "en", "-t", "de", "--arch", "dynamicconv_iwslt_de_en",
        "--max-tokens", "100", "--cpu", "--eval-bleu"])
    assert args.eval_bleu and args.eval_bleu_detok == "space"
    monkeypatch.setitem(sys.modules, "sacrebleu", None)
    with pytest.raises(ImportError, match="--eval-bleu needs the 'sacrebleu' package"):
        TranslationTask(args, torch_dictionary(), torch_dictionary())


def test_json_log_lines(corpus, caplog):
    """The progress bar's JSON lines: one a update (--log-interval 1) with
    the keys of JAX's lines, then the validation's and the epoch's."""
    root, data_dir = corpus
    save_dir = os.path.join(root, "json_lines")
    os.makedirs(save_dir, exist_ok=True)
    caplog.set_level(logging.INFO)
    ttrain.cli_main(argv(data_dir, save_dir, "nag_fixed", "--max-epoch", "1", "--no-save"))
    lines = [json.loads(r.getMessage()) for r in caplog.records
             if r.name.endswith("train.progress") and r.getMessage().startswith("{")]
    inner = [r for r in lines if "update" in r]
    assert len(inner) == 4
    assert {"epoch", "update", "loss", "nll_loss", "ppl", "wps", "ups", "bsz", "num_updates", "lr", "gnorm",
            "train_wall", "wall"} <= set(inner[0])
    assert any("valid_loss" in r for r in lines) and any("train_loss" in r for r in lines)
    assert os.listdir(save_dir) == []
