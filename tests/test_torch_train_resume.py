"""PyTorch port, training from files: resume, the written checkpoint, and
``cli/validate``.

On the corpus of ``tests/test_torch_train_cli.py`` (written by the JAX
package's CLIs):

  * the port's ``cli/train`` in training mode with dropout 0.1 (and the
    conv front end's own 0.1), 2 epochs, straight; then again stopped at
    ``--max-update 6`` (mid epoch 2) and resumed from its
    ``checkpoint_last.pt``: every update after the stop logs the straight
    run's loss, nll_loss, gnorm and lr, and the final parameters are the
    straight run's, bitwise (dropout is seeded per update, the iterator,
    optimiser and scheduler state ride in the checkpoint);
  * the straight run's ``checkpoint_best.pt`` decodes through the port's
    ``cli/generate`` and through JAX's ``cli/import_fairseq_checkpoint`` +
    ``cli/generate`` to identical hypotheses (scores within 1e-4);
  * a fork ``.pt``'s optimiser state is not restored without
    ``--reset-optimizer``;
  * ``cli/validate`` on a JAX checkpoint gives JAX's ``cli/validate``
    values at rtol 1e-5.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from fbk_fairseq_st_tpu.cli import generate as jgenerate
from fbk_fairseq_st_tpu.cli import import_fairseq_checkpoint as jimport
from fbk_fairseq_st_tpu.cli import validate as jvalidate
from fbk_fairseq_st_tpu.train import metrics as jmetrics
from fbk_fairseq_st_tpu_torch.cli import generate as tgenerate
from fbk_fairseq_st_tpu_torch.cli import train as ttrain
from fbk_fairseq_st_tpu_torch.cli import validate as tvalidate
from fbk_fairseq_st_tpu_torch.train import checkpoint as tcheckpoint
from fbk_fairseq_st_tpu_torch.train import metrics as tmetrics

from .test_torch_generate_cli import _argv as generate_argv
from .test_torch_generate_cli import _records
from .test_torch_train_cli import Recorder, argv, seed_checkpoint, write_corpus

DROPOUT = ["--dropout", "0.1", "--attention-dropout", "0.1", "--relu-dropout", "0.1"]
STOP_AT = 6  # mid epoch 2 (4 updates an epoch)
SCORE_ATOL = 1e-4


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("train_resume"))
    data_dir = os.path.join(root, "data")
    write_corpus(data_dir, np.random.RandomState(1))
    return root, data_dir


def _train(root, data_dir, name, monkeypatch, *extra, fresh=True):
    save_dir = os.path.join(root, name)
    if fresh:
        shutil.rmtree(save_dir, ignore_errors=True)
    with monkeypatch.context() as m:
        rec = Recorder(m, tmetrics)
        trainer, epoch_itr = ttrain.cli_main(argv(data_dir, save_dir, "label_smoothed_cross_entropy",
                                                  *DROPOUT, *extra))
    return rec.calls, trainer, epoch_itr, save_dir


@pytest.fixture(scope="module")
def straight(corpus):
    root, data_dir = corpus
    with pytest.MonkeyPatch.context() as m:
        return _train(root, data_dir, "straight", m)


def _updates(calls):
    """The training updates' (key, value) pairs: each update logs gnorm
    first; a validation batch logs loss and nll_loss only."""
    out, i = [], 0
    while i < len(calls):
        if calls[i][0] == "gnorm":
            out.append(calls[i:i + 4])
            i += 4
        else:
            i += 1
    return out


def test_resume_mid_epoch_is_exact(corpus, straight, monkeypatch):
    root, data_dir = corpus
    want, trainer_a, itr_a, dir_a = straight
    first, trainer_b, itr_b, dir_b = _train(root, data_dir, "resumed", monkeypatch, "--max-update", str(STOP_AT))
    assert trainer_b.get_num_updates() == STOP_AT and itr_b.epoch == 2 and itr_b.iterations_in_epoch == 2
    state = torch.load(os.path.join(dir_b, "checkpoint_last.pt"), weights_only=False)
    assert state["extra_state"]["train_iterator"] == {"epoch": 2, "iterations_in_epoch": 2, "shuffle": True}
    got, trainer_b, itr_b, _ = _train(root, data_dir, "resumed", monkeypatch, fresh=False)
    assert (trainer_b.get_num_updates(), itr_b.epoch, itr_b.iterations_in_epoch) == (
        trainer_a.get_num_updates(), itr_a.epoch, itr_a.iterations_in_epoch) == (8, 2, 4)
    assert trainer_b.get_lr() == trainer_a.get_lr()
    straight_updates = _updates(want)
    assert len(straight_updates) == 8
    assert _updates(first) == straight_updates[:STOP_AT]
    assert _updates(got) == straight_updates[STOP_AT:]
    a, b = trainer_a.model.state_dict(), trainer_b.model.state_dict()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert tcheckpoint._manager.best == pytest.approx(
        torch.load(os.path.join(dir_a, "checkpoint_last.pt"), weights_only=False)["extra_state"]["best"])


def test_dropout_is_seeded_per_update(corpus, straight, monkeypatch):
    """Two seeds give other updates; the same seed the same (the straight
    run's first update again)."""
    root, data_dir = corpus
    want = _updates(straight[0])
    again, *_ = _train(root, data_dir, "again", monkeypatch, "--max-update", "1")
    other, *_ = _train(root, data_dir, "other_seed", monkeypatch, "--max-update", "1", "--seed", "4")
    assert _updates(again) == want[:1]
    assert _updates(other)[0][2][1] != want[0][2][1]


def test_port_checkpoint_decodes_through_both_generators(corpus, straight):
    """The port's checkpoint_best.pt, read by the port's cli/generate and,
    imported by JAX's cli/import_fairseq_checkpoint, by JAX's: the same
    records, scores within 1e-4."""
    root, data_dir = corpus
    best = os.path.join(straight[3], "checkpoint_best.pt")
    imported = os.path.join(root, "imported.pt")
    jimport.cli_main([best, imported])
    jresults, tresults = os.path.join(root, "jax_gen"), os.path.join(root, "port_gen")
    jgenerate.cli_main(generate_argv(data_dir, imported, jresults))
    tgenerate.cli_main(generate_argv(data_dir, best, tresults))
    (want, want_order), (got, got_order) = _records(jresults), _records(tresults)
    assert got_order == want_order and len(got["H"]) == 6
    for sid, (score, text) in want["H"].items():
        assert got["H"][sid][1] == text, sid
        assert abs(float(got["H"][sid][0]) - float(score)) <= SCORE_ATOL
    loaded = tcheckpoint.load_checkpoint_to_cpu(best)["model"]
    for k, v in straight[1].model.state_dict().items():
        assert k in loaded


def test_fork_optimizer_state_needs_reset(corpus, straight, monkeypatch):
    """A fork ``.pt`` (no parameter order of the port's) restores its model
    with --reset-optimizer and refuses its optimiser state without it."""
    root, data_dir = corpus
    fork = torch.load(os.path.join(straight[3], "checkpoint1.pt"), weights_only=False)
    del fork["last_optimizer_param_names"]
    save_dir = os.path.join(root, "from_fork")
    os.makedirs(save_dir, exist_ok=True)
    torch.save(fork, os.path.join(save_dir, "checkpoint_last.pt"))
    with pytest.raises(NotImplementedError):
        _train(root, data_dir, "from_fork", monkeypatch, fresh=False)
    _, trainer, itr, _ = _train(root, data_dir, "from_fork", monkeypatch, "--reset-optimizer", "--max-update", "1",
                                fresh=False)
    assert trainer.get_num_updates() == 1 and itr.epoch == 2


def test_validate_matches_jax(corpus, monkeypatch):
    """cli/validate on a JAX checkpoint: the values JAX's cli/validate logs
    (each batch's loss and nll_loss), rtol 1e-5."""
    root, data_dir = corpus
    ckpt = os.path.join(root, "validate_seed.pt")
    seed_checkpoint(ckpt, data_dir, "label_smoothed_cross_entropy")
    args = [data_dir, "--task", "speech_translation_with_transcription", "-s", "en", "-t", "de", "--path", ckpt,
            "--max-sentences", "4", "--valid-subset", "valid,test", "--cpu"]
    calls = []
    for cli, module in ((jvalidate, jmetrics), (tvalidate, tmetrics)):
        with monkeypatch.context() as m:
            rec = Recorder(m, module)
            cli.cli_main(args)
        calls.append(rec.calls)
    want, got = calls
    assert [k for k, _ in got] == [k for k, _ in want] and len(want) == 2 * 4
    np.testing.assert_allclose([v for _, v in got], [v for _, v in want], rtol=1e-5, atol=0)


def test_non_finite_gradient_norm_raises_at_the_flush(corpus):
    """A NaN in a weight gives a NaN gradient norm: the step returns
    without a sync, and ``flush_logs`` raises ``FloatingPointError`` naming
    the parameters the NaN detector found (after the update, all of
    them)."""
    from fbk_fairseq_st_tpu_torch import options
    from fbk_fairseq_st_tpu_torch.registry import TASKS
    from fbk_fairseq_st_tpu_torch.train import Trainer

    root, data_dir = corpus
    args = options.parse_args_and_arch(options.get_training_parser(),
                                       argv(data_dir, os.path.join(root, "nan"), "label_smoothed_cross_entropy"))
    task = TASKS[args.task].setup_task(args)
    task.load_dataset("train")
    model = task.build_model(args, device="cpu")
    trainer = Trainer(args, task, model, task.build_criterion(args))
    sample = next(iter(tcheckpoint.get_train_iterator(args, trainer, task).next_epoch_itr(shuffle=False)))
    with torch.no_grad():
        model.encoder.layers[0].fc1.weight[0, 0] = float("nan")
    out = trainer.train_step([sample])
    assert not bool(torch.isfinite(out["gnorm"]))
    with pytest.raises(FloatingPointError, match=r"NaN/Inf detected in gradients.*params/encoder\..* NaNs"):
        trainer.flush_logs()


def test_interrupt_saves_and_stops_at_the_update(corpus, monkeypatch):
    """What the SIGTERM/SIGINT handler sets (``_INTERRUPT``), seen after
    update 2: the run saves ``checkpoint_last.pt`` at that batch without
    validating, and stops."""
    import signal

    from fbk_fairseq_st_tpu_torch.train import Trainer

    root, data_dir = corpus
    original = Trainer.train_step

    def train_step(self, samples):
        out = original(self, samples)
        if self.get_num_updates() == 2:
            ttrain._INTERRUPT["sig"] = signal.SIGTERM
        return out

    monkeypatch.setattr(Trainer, "train_step", train_step)
    _, trainer, itr, save_dir = _train(root, data_dir, "interrupted", monkeypatch)
    assert trainer.get_num_updates() == 2 and itr.epoch == 1
    assert sorted(os.listdir(save_dir)) == ["checkpoint_last.pt"]
    state = torch.load(os.path.join(save_dir, "checkpoint_last.pt"), weights_only=False)
    assert state["extra_state"]["train_iterator"]["iterations_in_epoch"] == 2
    assert state["extra_state"]["val_loss"] is None


def test_profile_writes_a_trace(corpus, monkeypatch):
    """--profile: a torch.profiler trace of the run in <save-dir>/profile."""
    root, data_dir = corpus
    _, _, _, save_dir = _train(root, data_dir, "profiled", monkeypatch, "--profile", "--max-update", "1")
    assert os.path.getsize(os.path.join(save_dir, "profile", "trace.json")) > 0
