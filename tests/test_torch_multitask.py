"""PyTorch port, the ST + classifier multitask model (COLING 2020):
``multitask_conv_transformer``, ``cross_entropy_multi_task``,
``MultiTaskDataset``, ``speech_translation_multitask`` and
``cli/generate_multitask_classifier`` against the JAX package on the same
numpy inputs and weights, on the CPU; then the port's own ``cli/train`` ->
classifier pipeline from files.

The models are the tiny configs of tests/test_multitask_classifier.py (2+2
layers, width 16, 2 heads, 8 mels, a 24-symbol target dictionary), with 1
(sigmoid) and 2 (softmax) outputs, built once per output size for the
file; the JAX side's init and forwards run under ``jax.jit``. The corpus
is written by the JAX package's own CLIs (``create_dummy_speech_data``)
with a ``gender`` label file beside it, once for the file. Everything runs
in fp32; tolerances are stated per test."""

import argparse
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fbk_fairseq_st_tpu.models.multitask_conv_transformer  # noqa: F401  (registers the JAX model)
from fbk_fairseq_st_tpu import registry
from fbk_fairseq_st_tpu.cli import generate_multitask_classifier as jclf_cli
from fbk_fairseq_st_tpu.criterions import cross_entropy_multi_task as jcrit
from fbk_fairseq_st_tpu.data import datasets as jdatasets
from fbk_fairseq_st_tpu.data.indexed_dataset import IndexedDatasetBuilder
from fbk_fairseq_st_tpu.train.checkpoint import save_state
from fbk_fairseq_st_tpu.utils.fairseq_interop import export_parameters
from fbk_fairseq_st_tpu_torch.cli import generate_multitask_classifier as tclf_cli
from fbk_fairseq_st_tpu_torch.cli import train as ttrain
from fbk_fairseq_st_tpu_torch.cli import validate as tvalidate
from fbk_fairseq_st_tpu_torch.criterions import CRITERIONS, CrossEntropyMultitask
from fbk_fairseq_st_tpu_torch.data import datasets as tdatasets
from fbk_fairseq_st_tpu_torch.models import ARCHITECTURES, multitask_conv_transformer as tmc
from fbk_fairseq_st_tpu_torch.tasks import TASKS
from fbk_fairseq_st_tpu_torch.utils.weights import state_dict_from_jax

from .test_binaries import create_dummy_speech_data
from .test_torch_ctc import _Recorder
from .test_torch_model import jax_init, shared_root, torch_dictionary  # noqa: F401  (shared_root: the fixture)
from .utils import DummyTask, dummy_dictionary, model_args

ARCH = "multitask_conv_transformer"
VOCAB = 24
SMALL = dict(
    encoder_layers=2, decoder_layers=2, encoder_embed_dim=16, decoder_embed_dim=16, encoder_ffn_embed_dim=32,
    decoder_ffn_embed_dim=32, encoder_attention_heads=2, decoder_attention_heads=2,
    encoder_convolutions="[(4, 3, 3)] * 2", input_feat_per_channel=8, max_source_positions=64,
    max_target_positions=32,
)
TINY_ARGV = [
    "--encoder-layers", "2", "--decoder-layers", "2", "--encoder-embed-dim", "16", "--decoder-embed-dim", "16",
    "--encoder-ffn-embed-dim", "32", "--decoder-ffn-embed-dim", "32", "--encoder-attention-heads", "2",
    "--decoder-attention-heads", "2", "--encoder-convolutions", "[(4, 3, 3)] * 2",
    "--input-feat-per-channel", "8", "--max-source-positions", "64", "--max-target-positions", "32",
]


def _np(x):
    return np.asarray(x.detach()) if isinstance(x, torch.Tensor) else np.asarray(x)


@functools.lru_cache(maxsize=None)
def built(outputs):
    """(JAX model, its variables as numpy, the port's model with them) at
    ``outputs`` classifier outputs, once for the file."""
    args = model_args(ARCH, additional_output_size=outputs, **SMALL)
    registry.apply_architecture(args)
    jmodel = registry.build_model(args, DummyTask(dummy_dictionary(VOCAB)))
    variables = jax_init(jmodel, 0, f"multitask_{outputs}")
    tmodel = tmc.build_model(ARCH, torch_dictionary(VOCAB), device="cpu", additional_output_size=outputs, **SMALL)
    tmodel.load_state_dict(state_dict_from_jax(variables), strict=True)
    return jmodel, variables, tmodel


def mt_batch(seed=0, b=3, t=29, tgt_len=6, outputs=2):
    """Unequal source lengths, a padded target tail, a class per row."""
    rng = np.random.RandomState(seed)
    tgt = rng.randint(4, 4 + VOCAB, size=(b, tgt_len)).astype(np.int32)
    tgt[-1, -2:] = 1
    return {
        "src_tokens": rng.randn(b, t, 8).astype(np.float32),
        "src_lengths": np.array([t, t - 6, t - 11][:b], np.int32),
        "prev_output_tokens": np.concatenate([np.full((b, 1), 2, np.int32), tgt[:, :-1]], axis=1),
        "target": tgt,
        "auxiliary_target": np.array([0, 1, 1][:b], np.int64) if outputs <= 2 else rng.randint(outputs, size=b),
    }


def _torch_batch(batch):
    return {k: torch.tensor(v) if v.dtype == np.float32 else torch.tensor(v).long() for k, v in batch.items()}


@pytest.mark.parametrize("outputs", [1, 2])
def test_logits_and_classifier_match_jax(outputs):
    """Eval mode, the same weights: the translation logits, the classifier's
    logits (the mean over the padded time axis) and ``classify``'s
    probabilities (sigmoid at one output, softmax at two) within 1e-5."""
    jmodel, variables, tmodel = built(outputs)
    batch = mt_batch(outputs=outputs)
    (((jlogits, _), jaux), _) = jax.jit(lambda v, b: jmodel.forward(v, b, training=False))(
        variables, {k: jnp.asarray(v) for k, v in batch.items()})
    jprobs = jax.jit(jmodel.classify)(variables, jnp.asarray(batch["src_tokens"]), jnp.asarray(batch["src_lengths"]))
    tb = _torch_batch(batch)
    with torch.no_grad():
        (tlogits, _), taux = tmodel(tb)
        tprobs = tmodel.classify(tb["src_tokens"], tb["src_lengths"])
    assert taux.shape == (3, outputs) and tprobs.dtype == torch.float32
    np.testing.assert_allclose(_np(tlogits), np.asarray(jlogits), rtol=0, atol=1e-5)
    np.testing.assert_allclose(_np(taux), np.asarray(jaux), rtol=0, atol=1e-5)
    np.testing.assert_allclose(_np(tprobs), np.asarray(jprobs), rtol=0, atol=1e-5)
    if outputs > 1:
        np.testing.assert_allclose(_np(tprobs).sum(-1), 1.0, atol=1e-6)


def test_bridge_matches_export():
    """state_dict_from_jax equals the JAX fork export name for name and value
    for value (the classifier as ``auxiliary_decoder.fc1`` / ``.fc2``,
    weights transposed), on the big preset's shapes cut to 1+1 layers, and
    loads strictly."""
    over = dict(encoder_layers=1, decoder_layers=1, input_feat_per_channel=16, additional_output_size=2)
    args = model_args(ARCH + "_big", **over)
    registry.apply_architecture(args)
    shapes = jax.eval_shape(registry.build_model(args, DummyTask(dummy_dictionary(VOCAB))).init,
                            jax.random.PRNGKey(1))
    rng = np.random.RandomState(1)
    variables = jax.tree_util.tree_map(lambda a: np.asarray(rng.randn(*a.shape)).astype(a.dtype), shapes)
    ours, theirs = state_dict_from_jax(variables), export_parameters(variables)
    assert sorted(ours) == sorted(theirs)
    for name, arr in theirs.items():
        np.testing.assert_array_equal(ours[name].numpy(), arr, err_msg=name)
    assert ours["auxiliary_decoder.fc1.weight"].shape == (512, 512)
    assert ours["auxiliary_decoder.fc2.weight"].shape == (2, 512)
    tmc.build_model(ARCH + "_big", torch_dictionary(VOCAB), device="cpu", **over).load_state_dict(ours, strict=True)


@pytest.mark.parametrize("arch", sorted(tmc.ARCHITECTURES))
def test_arch_presets_match_jax(arch):
    """Each preset builds the JAX registry's encoder and decoder configs,
    field by field, and its classifier's width (1 output when none is
    given, as JAX's parser default)."""
    args = model_args(arch)
    registry.apply_architecture(args)
    jmodel = registry.build_model(args, DummyTask(dummy_dictionary(VOCAB)))
    enc, dec, outputs = tmc.configs(arch, torch_dictionary(VOCAB))
    assert ARCHITECTURES[arch] is tmc
    assert enc.frontend._asdict() == jmodel.encoder_cfg.frontend._asdict()
    assert {k: v for k, v in enc._asdict().items() if k != "frontend"} == {
        k: v for k, v in jmodel.encoder_cfg._asdict().items() if k != "frontend"}
    jd = jmodel.decoder_cfg._asdict()
    assert dec._asdict() == {k: jd[k] for k in dec._fields}
    assert (outputs, jmodel.auxiliary_decoder.output_size) == (1, 1)


@pytest.mark.parametrize("weights", [None, (1.0, 2.0)], ids=["unweighted", "class_weights"])
def test_criterion_matches_jax(weights):
    """cross_entropy_multi_task (label smoothing 0.1, auxiliary weight 0.5)
    at two outputs: the loss, nll_loss and auxiliary_loss and the sample
    size within 1e-5 of JAX's in eval mode, with and without class weights;
    reduce_metrics (base 2, auxiliary_loss per sentence) within 1e-6."""
    jmodel, variables, tmodel = built(2)
    crit_args = argparse.Namespace(label_smoothing=0.1, sentence_avg=False, auxiliary_loss_weight=0.5,
                                   auxiliary_loss_class_weights=None if weights is None else list(weights))
    jc = jcrit.CrossEntropyMultitask(DummyTask(dummy_dictionary(VOCAB)), crit_args)
    tc = CRITERIONS["cross_entropy_multi_task"].build_criterion(crit_args, DummyTask(torch_dictionary(VOCAB)))
    batch = mt_batch(seed=2)
    jloss, jss, jlog = jax.jit(lambda v, b: jc(jmodel, v, b, training=False)[:3])(
        variables, {k: jnp.asarray(v) for k, v in batch.items()})
    tloss, tss, tlog = tc(tmodel, _torch_batch(batch), training=False)
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), rtol=0, atol=1e-5)
    assert int(tss) == int(jss)
    assert sorted(tlog) == sorted(jlog)
    for key, value in jlog.items():
        np.testing.assert_allclose(float(tlog[key]), float(value), rtol=0, atol=1e-5, err_msg=key)
    rec = _Recorder()
    jcrit.CrossEntropyMultitask.reduce_metrics([{k: float(v) for k, v in jlog.items()}], rec)
    got = CrossEntropyMultitask.reduce_metrics([tlog])
    for key in ("loss", "nll_loss", "auxiliary_loss"):
        np.testing.assert_allclose(got[key], rec.values[key], rtol=1e-6, err_msg=key)


def test_criterion_with_one_output_is_the_binary_nll():
    """At one output (a sigmoid) each utterance's auxiliary NLL is
    -log sigmoid(z) for class 1 and -log sigmoid(-z) for class 0, times its
    class weight: the probability ``classify`` reports is class 1's. JAX
    gathers index y from its one-wide log-sigmoid, which gives NaN for
    class 1 (ROADMAP Queue C), so the port is held to the formula."""
    _, _, tmodel = built(1)
    crit_args = argparse.Namespace(label_smoothing=0.0, sentence_avg=False, auxiliary_loss_weight=1.0,
                                   auxiliary_loss_class_weights=[1.0, 3.0])
    tc = CRITERIONS["cross_entropy_multi_task"].build_criterion(crit_args, DummyTask(torch_dictionary(VOCAB)))
    tb = _torch_batch(mt_batch(seed=4, outputs=1))
    _, tlog = tc(tmodel, tb, training=False)[1:]
    with torch.no_grad():
        z = tmodel(tb)[1][:, 0].double()
    y = tb["auxiliary_target"]
    p1 = torch.sigmoid(z)
    want = -(torch.where(y == 1, p1.log() * 3.0, (1 - p1).log() * 1.0)).sum()
    np.testing.assert_allclose(float(tlog["auxiliary_loss"]), float(want), rtol=1e-6)


def _labels(data_dir, rng, splits=(("train", 8), ("valid", 4), ("test", 4))):
    """A binary class per utterance, ``<split>.de.gender``, with the JAX
    package's builder."""
    for split, count in splits:
        b = IndexedDatasetBuilder(os.path.join(data_dir, f"{split}.de.gender.bin"))
        for _ in range(count):
            b.add_item(np.array([rng.randint(2)], dtype=np.int64))
        b.finalize(os.path.join(data_dir, f"{split}.de.gender.idx"))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The JAX CLIs' dummy speech corpus (8 train, 4 valid, 4 test) with a
    gender label file, once for the file."""
    data_dir = str(tmp_path_factory.mktemp("multitask") / "data")
    create_dummy_speech_data(data_dir, n=8)
    _labels(data_dir, np.random.RandomState(3))
    return data_dir


def test_multitask_dataset_collates_as_jax(corpus):
    """``speech_translation_multitask``'s test split, collated by the port
    and by the JAX task (``MultiTaskDataset`` over the same files): the
    same arrays, ``auxiliary_target`` in the collater's row order, and
    zeros on the padding rows of a fixed-shape batch."""
    from fbk_fairseq_st_tpu import options as joptions
    from fbk_fairseq_st_tpu.registry import TASKS as JTASKS

    argv = [corpus, "--task", "speech_translation_multitask", "-t", "de", "--auxiliary-suffix", "gender"]
    jargs = joptions.parse_args_and_arch(joptions.get_training_parser(), argv + ["--arch", ARCH])
    jtask = JTASKS[jargs.task].setup_task(jargs)
    jtask.load_dataset("test")
    targs = argparse.Namespace(data=corpus, target_lang="de", auxiliary_suffix="gender", dataset_impl=None)
    ttask = TASKS["speech_translation_multitask"].setup_task(targs)
    ttask.load_dataset("test")
    jds, tds = jtask.dataset("test"), ttask.dataset("test")
    assert isinstance(jds, jdatasets.MultiTaskDataset) and isinstance(tds, tdatasets.MultiTaskDataset)
    samples_j, samples_t = [jds[i] for i in range(len(jds))], [tds[i] for i in range(len(tds))]
    for pad in ({}, {"pad_to_src_len": 24, "pad_to_tgt_len": 8, "pad_to_bsz": 8}):
        jb, tb = jds.collater(samples_j, **pad), tds.collater(samples_t, **pad)
        assert tb["auxiliary_target"].shape[0] == (8 if pad else 4)
        for key in ("id", "target", "auxiliary_target"):
            np.testing.assert_array_equal(tb[key], jb[key], err_msg=key)
        for key in ("src_tokens", "src_lengths", "prev_output_tokens"):
            np.testing.assert_array_equal(tb["net_input"][key], jb["net_input"][key], err_msg=key)


def test_train_then_classify_from_files(corpus, tmp_path, capsys):
    """The port's ``cli/train`` (``speech_translation_multitask``,
    ``multitask_conv_transformer`` with 2 outputs, ``cross_entropy_multi_task``
    with class weights 1 2, ``--cpu``) writes ``checkpoint_last.pt``; the
    port's ``cli/generate_multitask_classifier`` on it classifies the 4 test
    utterances, each row of probabilities summing to 1 within 1e-4, one
    ``CLASS-`` line each; ``cli/validate`` on the checkpoint logs a finite
    loss, nll_loss and auxiliary_loss."""
    save_dir = str(tmp_path / "ckpt")
    ttrain.cli_main([
        corpus, "--save-dir", save_dir, "--task", "speech_translation_multitask", "--auxiliary-suffix", "gender",
        "-t", "de", "--arch", ARCH, "--additional-output-size", "2", "--criterion", "cross_entropy_multi_task",
        "--label-smoothing", "0.1", "--auxiliary-loss-weight", "0.5", "--auxiliary-loss-class-weights", "1.0", "2.0",
        "--optimizer", "adam", "--lr", "0.001", "--lr-scheduler", "inverse_sqrt", "--warmup-updates", "4",
        "--max-tokens", "400", "--max-epoch", "1", "--log-format", "none", "--cpu", *TINY_ARGV])
    assert "checkpoint_last.pt" in os.listdir(save_dir)
    capsys.readouterr()
    results = tclf_cli.cli_main([corpus, "--task", "speech_recognition", "-t", "de", "--path",
                                 os.path.join(save_dir, "checkpoint_last.pt"), "--gen-subset", "test",
                                 "--max-tokens", "400", "--cpu"])
    lines = [line for line in capsys.readouterr().out.splitlines() if line.startswith("CLASS-")]
    assert sorted(results) == [0, 1, 2, 3] and len(lines) == 4
    for p in results.values():
        assert p.shape == (2,)
        np.testing.assert_allclose(np.sum(p), 1.0, atol=1e-4)
    stats = tvalidate.cli_main([corpus, "--task", "speech_translation_multitask", "--auxiliary-suffix", "gender",
                                "-t", "de", "--path", os.path.join(save_dir, "checkpoint_last.pt"),
                                "--max-tokens", "400", "--cpu"])["valid"]
    assert np.isfinite([stats["loss"], stats["nll_loss"], stats["auxiliary_loss"]]).all()


def test_classifier_cli_on_a_jax_checkpoint_matches_jax(corpus, tmp_path, capsys):
    """A JAX-written checkpoint (seeded weights of the tiny model with 2
    outputs, ``save_state``): the port's classifier CLI (``--cpu``) gives
    JAX's ``cli/generate_multitask_classifier`` probabilities within 1e-5
    for every test utterance, and the same CLASS- lines' ids and
    predictions."""
    args = model_args(ARCH, task="speech_translation_multitask", additional_output_size=2, **SMALL)
    registry.apply_architecture(args)
    from fbk_fairseq_st_tpu.data import Dictionary as JaxDictionary

    jmodel = registry.build_model(args, DummyTask(JaxDictionary.load(os.path.join(corpus, "dict.de.txt"))))
    variables = jax.tree_util.tree_map(np.asarray, jax.jit(jmodel.init)(jax.random.PRNGKey(5)))
    path = str(tmp_path / "checkpoint_jax.pt")
    save_state(path, {"args": vars(args), "model": variables["params"], "model_state": variables["state"],
                      "extra_state": {"train_iterator": {"epoch": 1, "iterations_in_epoch": 0}, "val_loss": None}})
    argv = [corpus, "--task", "speech_recognition", "-t", "de", "--path", path, "--gen-subset", "test",
            "--max-tokens", "400"]
    want = jclf_cli.cli_main(argv)
    jlines = [line.split("\t")[:2] for line in capsys.readouterr().out.splitlines() if line.startswith("CLASS-")]
    got = tclf_cli.cli_main(argv + ["--cpu"])
    tlines = [line.split("\t")[:2] for line in capsys.readouterr().out.splitlines() if line.startswith("CLASS-")]
    assert sorted(got) == sorted(want) == [0, 1, 2, 3]
    for sid in want:
        np.testing.assert_allclose(got[sid], np.asarray(want[sid]), rtol=0, atol=1e-5, err_msg=str(sid))
    assert tlines == jlines


def test_classifier_cli_runs_on_the_card_unless_told_the_cpu(corpus, monkeypatch):
    """Without ``--cpu`` the classifier CLI asks for the CUDA card and
    raises where there is none; it never carries on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tclf_cli.cli_main([corpus, "--task", "speech_recognition", "-t", "de", "--path", "unused.pt"])
