"""PyTorch port, knowledge distillation (CliC-IT 2020): the
``knowledge_distillation`` criterion, the teacher-output files and their
collation (``data/knowledge_distillation.py``), ``cli/generate_topk`` and
the ``speech_translation_with_transcription_kd`` task against the JAX
package on the same inputs, on the CPU; then the port's own teacher ->
top-k -> student pipeline through ``cli/train``, as tests/test_kd.py runs
JAX's.

The models are tiny conv_transformers (2+2 layers, width 16, 2 heads, 8
mels) in fp32; the JAX side's init and forward run under ``jax.jit``. The
corpus is the JAX CLIs' (``create_st_data``: 8 train, 4 valid and 4 test
utterances with target and transcript text), written once for the file;
a test that writes top-k files works on its own copy. Tolerances are
stated per test."""

import argparse
import functools
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fbk_fairseq_st_tpu import registry
from fbk_fairseq_st_tpu.cli import generate_topk as jtopk_cli
from fbk_fairseq_st_tpu.criterions import knowledge_distillation as jcrit
from fbk_fairseq_st_tpu.data import Dictionary as JaxDictionary
from fbk_fairseq_st_tpu.data import knowledge_distillation as jkd
from fbk_fairseq_st_tpu.train.checkpoint import save_state
from fbk_fairseq_st_tpu_torch.cli import generate_topk as ttopk_cli
from fbk_fairseq_st_tpu_torch.cli import train as ttrain
from fbk_fairseq_st_tpu_torch.cli import validate as tvalidate
from fbk_fairseq_st_tpu_torch.criterions import CRITERIONS, CrossEntropyKnowledgeDistillationCriterion
from fbk_fairseq_st_tpu_torch.data import knowledge_distillation as tkd
from fbk_fairseq_st_tpu_torch.models import conv_transformer as tct
from fbk_fairseq_st_tpu_torch.tasks import TASKS
from fbk_fairseq_st_tpu_torch.utils.weights import state_dict_from_jax

from .test_st_ctc import create_st_data
from .test_torch_ctc import _Recorder
from .test_torch_model import jax_init, shared_root, torch_dictionary  # noqa: F401  (shared_root: the fixture)
from .utils import DummyTask, dummy_dictionary, model_args

VOCAB = 24
K = 4
SMALL = dict(
    encoder_layers=2, decoder_layers=2, encoder_embed_dim=16, decoder_embed_dim=16, encoder_ffn_embed_dim=32,
    decoder_ffn_embed_dim=32, encoder_attention_heads=2, decoder_attention_heads=2,
    encoder_convolutions="[(4, 3, 3)] * 2", input_feat_per_channel=8, max_source_positions=64,
    max_target_positions=32,
)
COMMON = [
    "-s", "en", "-t", "de", "--arch", "conv_transformer", "--optimizer", "adam", "--lr", "0.001",
    "--lr-scheduler", "inverse_sqrt", "--warmup-updates", "4", "--max-tokens", "400", "--max-epoch", "1",
    "--encoder-layers", "2", "--decoder-layers", "2", "--encoder-embed-dim", "16", "--decoder-embed-dim", "16",
    "--encoder-ffn-embed-dim", "32", "--decoder-ffn-embed-dim", "32", "--encoder-attention-heads", "2",
    "--decoder-attention-heads", "2", "--encoder-convolutions", "[(4, 3, 3)] * 2", "--input-feat-per-channel", "8",
    "--max-source-positions", "64", "--max-target-positions", "32", "--log-format", "none",
]


def _np(x):
    return np.asarray(x.detach()) if isinstance(x, torch.Tensor) else np.asarray(x)


@functools.lru_cache(maxsize=None)
def built():
    """(JAX conv_transformer, its variables as numpy, the port's model with
    them), once for the file."""
    args = model_args("conv_transformer", **SMALL)
    registry.apply_architecture(args)
    jmodel = registry.build_model(args, DummyTask(dummy_dictionary(VOCAB)))
    variables = jax_init(jmodel, 0, "kd_built")
    tmodel = tct.build_model("conv_transformer", torch_dictionary(VOCAB), device="cpu", **SMALL)
    tmodel.load_state_dict(state_dict_from_jax(variables), strict=True)
    return jmodel, variables, tmodel


def kd_batch(seed=0, b=3, t=29, tgt_len=6):
    """Unequal source lengths, a padded target tail, and a teacher's top-K
    indices and logits (0 and pad at the padded positions, as the
    collater gives them)."""
    rng = np.random.RandomState(seed)
    tgt = rng.randint(4, 4 + VOCAB, size=(b, tgt_len)).astype(np.int32)
    tgt[-1, -2:] = 1
    idxs = np.stack([np.stack([rng.choice(4 + VOCAB, K, replace=False) for _ in range(tgt_len)])
                     for _ in range(b)]).astype(np.int64)
    probs = (3.0 * rng.randn(b, tgt_len, K)).astype(np.float32)
    idxs[tgt == 1], probs[tgt == 1] = 1, 0.0
    return {
        "src_tokens": rng.randn(b, t, 8).astype(np.float32),
        "src_lengths": np.array([t, t - 6, t - 11][:b], np.int32),
        "prev_output_tokens": np.concatenate([np.full((b, 1), 2, np.int32), tgt[:, :-1]], axis=1),
        "target": tgt,
        "teacher_idxs": idxs,
        "teacher_probs": probs,
    }


def _torch_batch(batch):
    return {k: torch.tensor(v) if v.dtype == np.float32 else torch.tensor(v).long() for k, v in batch.items()}


@pytest.mark.parametrize("temperature", [1.0, 2.0])
@pytest.mark.parametrize("kd_lambda", [0.0, 0.5, 1.0])
def test_criterion_matches_jax(kd_lambda, temperature):
    """knowledge_distillation in eval mode on the same weights and batch:
    the loss, nll_loss (the truth part, or the loss itself at lambda 1) and
    the sample size within 1e-5 of JAX's; reduce_metrics within 1e-6."""
    jmodel, variables, tmodel = built()
    crit_args = argparse.Namespace(kd_lambda=kd_lambda, kd_temperature=temperature, sentence_avg=False)
    jc = jcrit.CrossEntropyKnowledgeDistillationCriterion(DummyTask(dummy_dictionary(VOCAB)), crit_args)
    tc = CRITERIONS["knowledge_distillation"].build_criterion(crit_args, DummyTask(torch_dictionary(VOCAB)))
    batch = kd_batch(seed=1)
    jloss, jss, jlog = jax.jit(lambda v, b: jc(jmodel, v, b, training=False)[:3])(
        variables, {k: jnp.asarray(v) for k, v in batch.items()})
    tloss, tss, tlog = tc(tmodel, _torch_batch(batch), training=False)
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), rtol=0, atol=1e-5)
    assert int(tss) == int(jss)
    assert sorted(tlog) == sorted(jlog)
    for key, value in jlog.items():
        np.testing.assert_allclose(float(tlog[key]), float(value), rtol=0, atol=1e-5, err_msg=key)
    rec = _Recorder()
    jcrit.CrossEntropyKnowledgeDistillationCriterion.reduce_metrics([{k: float(v) for k, v in jlog.items()}], rec)
    got = CrossEntropyKnowledgeDistillationCriterion.reduce_metrics([tlog])
    for key in ("loss", "nll_loss"):
        np.testing.assert_allclose(got[key], rec.values[key], rtol=1e-6, err_msg=key)


def _items(rng, n=5):
    """(T, K) teacher items of unequal T: indices and logits."""
    lens = rng.randint(1, 9, size=n)
    return ([rng.randint(0, 30, size=(t, K)).astype(np.int32) for t in lens],
            [rng.randn(t, K).astype(np.float32) for t in lens])


@pytest.mark.parametrize("kind", ["idx", "out"])
def test_teacher_output_files_are_jax_bytes_and_read_both_ways(tmp_path, kind):
    """``TeacherOutputDataset.save_bin`` writes JAX's bytes (``.bin`` and
    ``.idx``, no Lua shift), and each side's reader gives the other's
    items back exactly (int64 indices, float32 logits)."""
    idxs, outs = _items(np.random.RandomState(2))
    items, dtype = (idxs, np.int32) if kind == "idx" else (outs, np.float32)
    tprefix, jprefix = str(tmp_path / "port"), str(tmp_path / "jax")
    tkd.TeacherOutputDataset.save_bin(tprefix, items, dtype)
    jkd.TeacherOutputDataset.save_bin(jprefix, items, dtype)
    for ext in (".bin", ".idx"):
        with open(tprefix + ext, "rb") as a, open(jprefix + ext, "rb") as b:
            assert a.read() == b.read(), ext
    for ds in (tkd.TeacherOutputDataset(jprefix), jkd.TeacherOutputDataset(tprefix, dtype)):
        assert len(ds) == len(items)
        for i, item in enumerate(items):
            got = ds[i]
            assert got.dtype == (np.int64 if kind == "idx" else np.float32)
            np.testing.assert_array_equal(got, item)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The JAX CLIs' speech-translation corpus, once for the file."""
    data_dir = str(tmp_path_factory.mktemp("kd") / "data")
    create_st_data(data_dir, n=8)
    return data_dir


def _copy(corpus, tmp_path):
    data_dir = str(tmp_path / "data")
    shutil.copytree(corpus, data_dir)
    return data_dir


def test_dataset_with_teacher_output_collates_as_jax(corpus, tmp_path):
    """``speech_translation_with_transcription_kd``'s test split over
    teacher files of unequal T (longer and shorter than the targets),
    collated by the port and by JAX's ``DatasetWithTeacherOutput`` over the
    same wrapped samples: ``teacher_idxs`` (pad past each item) and
    ``teacher_probs`` (0) equal, in the rows' order, with a fixed-shape
    batch's padding rows all pad and 0."""
    data_dir = _copy(corpus, tmp_path)
    rng = np.random.RandomState(4)
    lens = [rng.randint(2, 9) for _ in range(4)]
    prefix = os.path.join(data_dir, f"test.de.top{K}")
    tkd.TeacherOutputDataset.save_bin(prefix + "_idx", [rng.randint(4, 16, (t, K)) for t in lens], np.int32)
    tkd.TeacherOutputDataset.save_bin(prefix + "_out", [rng.randn(t, K) for t in lens], np.float32)
    targs = argparse.Namespace(data=data_dir, source_lang="en", target_lang="de", distill_topk=K, dataset_impl=None,
                               criterion="knowledge_distillation")
    task = TASKS["speech_translation_with_transcription_kd"].setup_task(targs)
    task.load_dataset("test")
    tds = task.dataset("test")
    assert isinstance(tds, tkd.DatasetWithTeacherOutput)
    jds = jkd.DatasetWithTeacherOutput(tds.src, jkd.TeacherOutputDataset(prefix + "_out"),
                                       jkd.TeacherOutputDataset(prefix + "_idx"), task.tgt_dict, K)
    samples_t, samples_j = [tds[i] for i in range(len(tds))], [jds[i] for i in range(len(jds))]
    for pad in ({}, {"pad_to_src_len": 24, "pad_to_tgt_len": 8, "pad_to_bsz": 8}):
        tb, jb = tds.collater(samples_t, **pad), jds.collater(samples_j, **pad)
        for key in ("id", "target", "teacher_idxs", "teacher_probs"):
            np.testing.assert_array_equal(tb[key], jb[key], err_msg=key)
        assert tb["teacher_idxs"].shape == tb["target"].shape + (K,)
        if pad:
            assert (tb["teacher_idxs"][4:] == 1).all() and (tb["teacher_probs"][4:] == 0).all()


def test_generate_topk_on_a_jax_teacher_matches_jax(corpus, tmp_path):
    """A JAX-written teacher checkpoint (seeded weights, ``save_state``):
    JAX's and the port's (``--cpu``) ``cli/generate_topk`` at K 5 over the
    train split write items of the same (T, 5) shapes, logits within 1e-5,
    and the same indices at every rank whose logit is more than 1e-4 above
    the next one (ranks 0-3; ties may come in either order)."""
    data_dir = _copy(corpus, tmp_path)
    args = model_args("conv_transformer", task="speech_translation_with_transcription", **SMALL)
    registry.apply_architecture(args)
    jmodel = registry.build_model(args, DummyTask(JaxDictionary.load(os.path.join(data_dir, "dict.de.txt"))))
    variables = jax.tree_util.tree_map(np.asarray, jax.jit(jmodel.init)(jax.random.PRNGKey(6)))
    path = str(tmp_path / "teacher.pt")
    save_state(path, {"args": vars(args), "model": variables["params"], "model_state": variables["state"],
                      "extra_state": {"train_iterator": {"epoch": 1, "iterations_in_epoch": 0}, "val_loss": None}})
    argv = [data_dir, "--task", "speech_translation_with_transcription", "-s", "en", "-t", "de", "--path", path,
            "--gen-subset", "train", "--distill-topk", "5", "--max-tokens", "400"]
    prefix = os.path.join(data_dir, "train.de.top5")
    read = lambda: [[tkd.TeacherOutputDataset(prefix + s)[i] for i in range(8)] for s in ("_idx", "_out")]  # noqa
    jtopk_cli.cli_main(argv)
    want_idx, want_out = read()
    ttopk_cli.cli_main(argv + ["--cpu"])
    got_idx, got_out = read()
    for i in range(8):
        assert got_idx[i].shape == want_idx[i].shape and got_idx[i].shape[1] == 5
        np.testing.assert_allclose(got_out[i], want_out[i], rtol=0, atol=1e-5, err_msg=str(i))
        apart = np.diff(-want_out[i], axis=1) > 1e-4
        np.testing.assert_array_equal(got_idx[i][:, :4][apart], want_idx[i][:, :4][apart], err_msg=str(i))
        assert apart.mean() > 0.9


def test_teacher_topk_student_pipeline(corpus, tmp_path):
    """The port's pipeline on the CPU, as tests/test_kd.py runs JAX's: a
    teacher through ``cli/train`` (label-smoothed CE), its top-4 on train
    and valid through ``cli/generate_topk`` (files read back as (T, 4)
    items, one an utterance, T the target's length with its eos), then a
    student through ``cli/train`` with
    ``speech_translation_with_transcription_kd`` and
    ``knowledge_distillation`` (lambda 0.5, temperature 2), and
    ``cli/validate`` on the student's checkpoint."""
    data_dir = _copy(corpus, tmp_path)
    teacher_dir, student_dir = str(tmp_path / "teacher"), str(tmp_path / "student")
    ttrain.cli_main([data_dir, "--save-dir", teacher_dir, "--task", "speech_translation_with_transcription",
                     "--criterion", "label_smoothed_cross_entropy", "--label-smoothing", "0.1", "--cpu"] + COMMON)
    for subset in ("train", "valid"):
        ttopk_cli.cli_main([data_dir, "--task", "speech_translation_with_transcription", "--path",
                            os.path.join(teacher_dir, "checkpoint_last.pt"), "--gen-subset", subset,
                            "--distill-topk", str(K), "--max-tokens", "400", "--cpu"] + COMMON[:4])
        for ext in ("idx", "out"):
            assert os.path.exists(os.path.join(data_dir, f"{subset}.de.top{K}_{ext}.bin"))
    ds = tkd.TeacherOutputDataset(os.path.join(data_dir, f"train.de.top{K}_idx"))
    targets = TASKS["speech_translation_with_transcription"].setup_task(argparse.Namespace(
        data=data_dir, source_lang="en", target_lang="de", criterion="label_smoothed_cross_entropy"))
    targets.load_dataset("train")
    assert len(ds) == 8
    for i in range(8):
        assert ds[i].shape == (len(targets.dataset("train")[i]["target"]), K)
    trainer, _ = ttrain.cli_main([data_dir, "--save-dir", student_dir, "--task",
                                  "speech_translation_with_transcription_kd", "--distill-topk", str(K), "--criterion",
                                  "knowledge_distillation", "--kd-lambda", "0.5", "--kd-temperature", "2.0",
                                  "--cpu"] + COMMON)
    assert "checkpoint_last.pt" in os.listdir(student_dir)
    assert trainer.get_num_updates() > 0
    stats = tvalidate.cli_main([data_dir, "--task", "speech_translation_with_transcription_kd", "-s", "en", "-t", "de",
                                "--distill-topk", str(K), "--path", os.path.join(student_dir, "checkpoint_last.pt"),
                                "--max-tokens", "400", "--cpu"])["valid"]
    assert np.isfinite([stats["loss"], stats["nll_loss"]]).all()


def test_generate_topk_runs_on_the_card_unless_told_the_cpu(corpus, monkeypatch):
    """Without ``--cpu`` ``cli/generate_topk`` asks for the CUDA card and
    raises where there is none; it never carries on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttopk_cli.cli_main([corpus, "--task", "speech_translation_with_transcription", "-s", "en", "-t", "de",
                            "--path", "unused.pt"])
