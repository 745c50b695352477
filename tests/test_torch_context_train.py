"""PyTorch port, context-aware ST (INTERSPEECH 2020) from files: the
``speech_recognition_context`` task's ``ContextAwareDataset`` collation,
the pretrained merge and ``frozen_param_filter``, three train steps with
frozen parameters, and the CLIs, against the JAX package on the CPU.

The corpus is the JAX CLIs' dummy corpus (``create_dummy_speech_data``, 8
mels) with its context files: ``<split>.context.de`` (line i the target
of line i-1, line 0 ``</s>``) written by JAX's ``cli/preprocess`` as
tests/test_context_model.py writes them, and ``<split>.context.npz``
(utterance i-1's frames, utterance 0 zeros of its own length) written with
the port's builder. The pretrained model is a JAX ``conv_transformer``
pickled as tests/test_context_model.py::test_pretrained_load_and_freeze
pickles it. The models are tests/test_context_model.py's SMALL config. The
train steps run in training mode with every dropout made the identity on
both sides (their masks cannot match bit for bit, and the conv front end's
dropout floor of 0.1 cannot be turned off otherwise), so the BatchNorm
statistics move as in a real step. Tolerances are stated per test."""

import os
import pickle
import shutil
import sys

import jax
import numpy as np
import pytest
import torch

import fbk_fairseq_st_tpu.criterions.label_smoothed_cross_entropy_ctx_reg  # noqa: F401  (registers it)
from fbk_fairseq_st_tpu import options as joptions
from fbk_fairseq_st_tpu import registry
from fbk_fairseq_st_tpu.cli import generate as jgenerate
from fbk_fairseq_st_tpu.cli import preprocess as jpreprocess
from fbk_fairseq_st_tpu.ops import core as jcore
from fbk_fairseq_st_tpu.parallel.mesh import _path_str
from fbk_fairseq_st_tpu.registry import CRITERIONS as JCRITERIONS
from fbk_fairseq_st_tpu.registry import TASKS as JTASKS
from fbk_fairseq_st_tpu.train.checkpoint import save_state
from fbk_fairseq_st_tpu.train.trainer import Trainer as JaxTrainer
from fbk_fairseq_st_tpu_torch import options as toptions
from fbk_fairseq_st_tpu_torch.cli import generate as tgenerate
from fbk_fairseq_st_tpu_torch.cli import train as ttrain
from fbk_fairseq_st_tpu_torch.data import indexed_dataset as tindexed
from fbk_fairseq_st_tpu_torch.data.datasets import ContextAwareDataset
from fbk_fairseq_st_tpu_torch.models import conv_transformer_context as tcc
from fbk_fairseq_st_tpu_torch.ops import core as tcore
from fbk_fairseq_st_tpu_torch.tasks import TASKS
from fbk_fairseq_st_tpu_torch.train import Trainer
from fbk_fairseq_st_tpu_torch.train import checkpoint as tcheckpoint
from fbk_fairseq_st_tpu_torch.utils.weights import fork_name, state_dict_from_jax

from .test_binaries import create_dummy_speech_data
from .test_context_model import SMALL
from .test_torch_context import ARCH, jax_model
from .test_torch_model import torch_dictionary
from .test_torch_multilingual import _assert_batches_equal, _records, random_variables
from .utils import DummyTask, dummy_dictionary, model_args

SCORE_ATOL = 1e-4
SMALL_ARGV = ["--encoder-layers", "2", "--decoder-layers", "2", "--encoder-embed-dim", "16", "--decoder-embed-dim",
              "16", "--encoder-ffn-embed-dim", "32", "--decoder-ffn-embed-dim", "32", "--encoder-attention-heads", "2",
              "--decoder-attention-heads", "2", "--encoder-convolutions", "[(4,3,3)]*2", "--input-feat-per-channel",
              "8", "--max-source-positions", "64", "--max-target-positions", "32"]
MODES = ("all", "encoder", "none")


def _np(x):
    return np.asarray(x.detach()) if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The dummy corpus (8 train, 4 valid, 4 test utterances) and its
    context files."""
    data_dir = str(tmp_path_factory.mktemp("context") / "data")
    create_dummy_speech_data(data_dir, n=8)
    for split in ("train", "valid"):
        lines = open(os.path.join(data_dir, f"{split}_raw.de")).read().splitlines()
        with open(os.path.join(data_dir, f"{split}_ctxraw.de"), "w") as f:
            f.write("\n".join(["</s>"] + lines[:-1]) + "\n")
    jpreprocess.cli_main(["--target-lang", "de", "--trainpref", os.path.join(data_dir, "train_ctxraw"),
                          "--validpref", os.path.join(data_dir, "valid_ctxraw"), "--destdir",
                          os.path.join(data_dir, "ctxbin"), "--tgtdict", os.path.join(data_dir, "dict.de.txt"),
                          "--dataset-impl", "cached"])
    for split in ("train", "valid"):
        for ext in ("bin", "idx"):
            shutil.copy(os.path.join(data_dir, "ctxbin", f"{split}.de.{ext}"),
                        os.path.join(data_dir, f"{split}.context.de.{ext}"))
        frames = tindexed.FilterBanksDataset(os.path.join(data_dir, f"{split}.npz"))
        builder = tindexed.AudioIndexedDatasetBuilder(os.path.join(data_dir, f"{split}.context.npz.bin"))
        for i in range(len(frames)):
            builder.add_item(np.asarray(frames[i - 1]) if i else np.zeros_like(np.asarray(frames[0])))
        builder.finalize(os.path.join(data_dir, f"{split}.context.npz.idx"))
    return data_dir


@pytest.fixture(scope="module")
def pretrained(tmp_path_factory):
    """A JAX conv_transformer's seeded variables, pickled with its args
    and BatchNorm state."""
    args = model_args("conv_transformer", **SMALL)
    registry.apply_architecture(args)
    variables = random_variables(registry.build_model(args, DummyTask(dummy_dictionary(12))), 7)
    path = str(tmp_path_factory.mktemp("pretrained") / "pre.pt")
    with open(path, "wb") as f:
        pickle.dump({"args": vars(args), "model": variables["params"], "model_state": variables["state"]}, f)
    return path, variables


def _argv(corpus, context_type="tgt", *extra):
    return [corpus, "--task", "speech_recognition_context", "--context-type", context_type, "-t", "de", "--arch",
            ARCH, *SMALL_ARGV, *extra]


def _tasks(argv, split="train"):
    jargs = joptions.parse_args_and_arch(joptions.get_training_parser(), argv)
    jtask = JTASKS[jargs.task].setup_task(jargs)
    jtask.load_dataset(split)
    targs = toptions.parse_args_and_arch(toptions.get_training_parser(), argv + ["--cpu"])
    ttask = TASKS[targs.task].setup_task(targs)
    ttask.load_dataset(split)
    return jargs, jtask, targs, ttask


@pytest.mark.parametrize("context_type", ["tgt", "src"])
def test_context_collation_matches_jax(corpus, context_type):
    """The train split collated by the port's task and by JAX's (a
    ``ContextAwareDataset``): the same arrays, with and without a
    fixed-shape batch's padding rows (context fill and length 0), the
    context rows in the collater's frame order; the same sizes and order.
    In inference mode (a namespace with ``beam``) the split is not
    wrapped."""
    _, jtask, targs, ttask = _tasks(_argv(corpus, context_type))
    jds, tds = jtask.dataset("train"), ttask.dataset("train")
    assert isinstance(tds, ContextAwareDataset) and tds.audio_context == (context_type == "src")
    samples = [tds[i] for i in range(len(tds))]
    for pad in ({}, {"pad_to_src_len": 24, "pad_to_tgt_len": 8, "pad_to_bsz": 16}):
        want = jds.collater([jds[i] for i in range(len(jds))], **pad)
        got = tds.collater(samples, **pad)
        _assert_batches_equal(got, want)
        assert got["net_input"]["context_tokens"].shape[0] == (16 if pad else 8)
        assert (got["net_input"]["context_lengths"][8:] == 0).all()
    for i in range(len(tds)):
        assert tds.num_tokens(i) == jds.num_tokens(i) and tds.size(i) == jds.size(i)
    np.testing.assert_array_equal(tds.ordered_indices(), jds.ordered_indices())
    targs.beam = 5
    inference = TASKS[targs.task].setup_task(targs)
    inference.load_dataset("test")
    assert not inference.training and not isinstance(inference.dataset("test"), ContextAwareDataset)
    np.testing.assert_array_equal(inference.dataset("test").ordered_indices(), np.arange(4))


@pytest.mark.parametrize("context_type", ["tgt", "src"])
def test_pretrained_merge_and_frozen_filter_match_jax(pretrained, context_type):
    """``--pretrained-model`` (a JAX pickle of a plain conv_transformer)
    into both packages' context models: the same parameters are merged
    (the encoder's and the decoder's, and with ``src`` the audio context
    encoder's from the checkpoint's encoder), with the checkpoint's values,
    the main encoder's BatchNorm statistics not, the audio encoder's yes;
    then, for every leaf of the JAX tree in each of the three freeze
    modes, JAX's ``frozen_param_filter`` of its path and the port's of its
    fork name agree."""
    path, pre = pretrained
    jmodel = jax_model(context_type=context_type, pretrained_model=path)
    jvars = jax.tree_util.tree_map(np.asarray, jax.jit(jmodel.init)(jax.random.PRNGKey(0)))
    tmodel = tcc.build_model(ARCH, torch_dictionary(24), device="cpu", context_type=context_type,
                             pretrained_model=path, **SMALL)
    jnames = {fork_name(p.split("/")) for p in jmodel._pretrained_param_paths}
    assert jnames == tmodel.pretrained_names
    assert ("context_encoder.audio_encoder.fc3.weight" in jnames) == (context_type == "src")
    source = state_dict_from_jax(pre)
    jsd, tsd = state_dict_from_jax(jvars), tmodel.state_dict()
    for name in tmodel.pretrained_names:
        src_name = name.replace("context_encoder.audio_encoder.", "encoder.")
        np.testing.assert_array_equal(_np(tsd[name]), source[src_name].numpy(), err_msg=name)
        np.testing.assert_array_equal(jsd[name].numpy(), source[src_name].numpy(), err_msg=name)
    assert "encoder.layers.0.context_attn.q_proj.weight" not in tmodel.pretrained_names
    np.testing.assert_array_equal(_np(tmodel.encoder.bn[0].running_var), np.ones(4, np.float32))
    if context_type == "src":
        for i, bn in enumerate(tmodel.context_encoder.audio_encoder.bn):
            np.testing.assert_array_equal(_np(bn.running_mean), pre["state"]["encoder"]["frontend"]["bns"][i]["mean"])
    leaves = [_path_str(p) for p, _ in jax.tree_util.tree_leaves_with_path(jvars["params"])]
    counts = {}
    for mode in MODES:
        jmodel.freeze_pretrained = tmodel.freeze_pretrained = mode
        frozen = [leaf for leaf in leaves if jmodel.frozen_param_filter(leaf)]
        assert frozen == [leaf for leaf in leaves if tmodel.frozen_param_filter(fork_name(leaf.split("/")))], mode
        counts[mode] = len(frozen)
    assert counts["all"] > counts["encoder"] > counts["none"] == 0
    tmodel.freeze_pretrained = "encoder"
    assert tmodel.frozen_param_filter("encoder.fc3.weight")
    assert not tmodel.frozen_param_filter("decoder.embed_tokens.weight")
    assert not tmodel.frozen_param_filter("encoder.layers.0.context_gating_wi.weight")


def _identity_dropout(x, *args, **kwargs):
    return x


@pytest.fixture(scope="module")
def train_run(corpus, pretrained, tmp_path_factory):
    """Three steps of JAX's Trainer and of the port's on one batch of the
    train split (collated to the shape buckets, as both CLIs batch):
    ``tgt`` context, parallel gating, ctxreg alpha 0.3, the pretrained
    conv_transformer with ``--freeze-pretrained encoder``, Adam with
    weight decay 0.01, clip 10; every dropout the identity. Then a fourth
    step of each, the port's from JAX's optimiser state after the third
    (its frozen parameters have state in JAX and none in the port), and
    JAX's trained weights saved as its pickled checkpoint."""
    path, _ = pretrained
    argv = _argv(corpus, "tgt", "--context-decoder-attention-type", "parallel", "--criterion",
                 "label_smoothed_cross_entropy_ctxreg", "--label-smoothing", "0.1", "--ctx-reg-alpha", "0.3",
                 "--pretrained-model", path, "--freeze-pretrained", "encoder", "--optimizer", "adam", "--lr", "0.002",
                 "--weight-decay", "0.01", "--clip-norm", "10", "--lr-scheduler", "inverse_sqrt", "--warmup-updates",
                 "2", "--max-tokens", "400")
    originals = (jcore.dropout, tcore.dropout)
    with pytest.MonkeyPatch.context() as mp:
        for mod in list(sys.modules.values()):
            if getattr(mod, "__name__", "").startswith("fbk_fairseq_st_tpu") and any(
                    getattr(mod, "dropout", None) is f for f in originals):
                mp.setattr(mod, "dropout", _identity_dropout)
        jargs, jtask, targs, ttask = _tasks(argv)
        jmodel = registry.build_model(jargs, jtask)
        jtrainer = JaxTrainer(jargs, jtask, jmodel, JCRITERIONS[jargs.criterion].build_criterion(jargs, jtask))
        gnorms = []
        log_training = jtrainer._log_training
        jtrainer._log_training = lambda lo, gnorm, meta: (gnorms.append(gnorm), log_training(lo, gnorm, meta))
        start = jax.tree_util.tree_map(np.asarray, jtrainer.variables())
        tmodel = ttask.build_model(targs, device="cpu")
        tmodel.load_state_dict(state_dict_from_jax(start), strict=True)
        ttrainer = Trainer(targs, ttask, tmodel, ttask.build_criterion(targs))
        sample = next(iter(ttask.get_batch_iterator(ttask.dataset("train"), max_tokens=targs.max_tokens,
                                                    max_positions=ttask.max_positions(), bucket_shapes=True,
                                                    required_batch_size_multiple=8).next_epoch_itr(shuffle=False)))
        steps, lr_sum = [], 0.0
        for step in range(3):
            lr_sum += jtrainer.lr_scheduler.step_update(step)
            steps.append((jtrainer.train_step([sample]), ttrainer.train_step([sample]), gnorms[step]))
        ttrainer.flush_logs()
        after3 = jax.tree_util.tree_map(np.asarray, jtrainer.variables())
        ckpt = str(tmp_path_factory.mktemp("jax_trained") / "checkpoint_jax.pt")
        save_state(ckpt, {"args": vars(jargs), "model": after3["params"], "model_state": after3["state"],
                          "opt_state": jax.tree_util.tree_map(np.asarray, jtrainer.train_state["opt_state"]),
                          "num_updates": 3, "extra_state": {"train_iterator": {"epoch": 1, "iterations_in_epoch": 0},
                                                            "val_loss": None}})
        # a fourth step: the port resumed from JAX's state after the third
        resumed = Trainer(targs, ttask, ttask.build_model(targs, device="cpu"), ttask.build_criterion(targs))
        state = tcheckpoint.load_checkpoint_to_cpu(ckpt)
        resumed.load_trainer_state(tcheckpoint.training_state(state, resumed, reset_optimizer=False))
        lr_sum4 = lr_sum + jtrainer.lr_scheduler.step_update(3)
        fourth = (jtrainer.train_step([sample]), resumed.train_step([sample]), gnorms[-1])
        resumed.flush_logs()
        after4 = jax.tree_util.tree_map(np.asarray, jtrainer.variables())
    return dict(start=start, steps=steps, lr_sum=lr_sum, after3=after3, ttrainer=ttrainer, ckpt=ckpt,
                fourth=fourth, gnorm4=gnorms[3], after4=after4, lr_sum4=lr_sum4, resumed=resumed, sample=sample,
                jmodel=jmodel)


def _assert_params(got_sd, want_sd, lr_sum):
    assert sorted(got_sd) == sorted(want_sd)
    for name, value in want_sd.items():
        atol = 2 * lr_sum if name.endswith("k_proj.bias") else 1e-5
        np.testing.assert_allclose(_np(got_sd[name]), value.numpy(), rtol=0, atol=atol, err_msg=name)


def test_train_steps_with_frozen_parameters_match_jax(train_run):
    """Per step: loss, nll_loss, the counts and the gnorm (of the
    trainable parameters only) at rtol 1e-5; then every parameter and
    buffer at atol 1e-5 (the key-projection biases, whose exact gradient
    is 0, at 2 x the summed lr, as in tests/test_torch_train.py). Every
    frozen parameter is bitwise its start value on both sides, weight
    decay included; every trainable one moved; the frozen front end's
    BatchNorm statistics moved, as JAX's did."""
    run = train_run
    for step, (want, got, jgnorm) in enumerate(run["steps"]):
        for key in ("loss", "nll_loss", "ntokens", "nsentences", "sample_size"):
            np.testing.assert_allclose(float(got[key]), want[key], rtol=1e-5, err_msg=f"{key} step {step}")
        np.testing.assert_allclose(float(got["gnorm"]), jgnorm, rtol=1e-5, err_msg=f"gnorm step {step}")
    model = run["ttrainer"].model
    _assert_params(model.state_dict(), state_dict_from_jax(run["after3"]), run["lr_sum"])
    start, after = state_dict_from_jax(run["start"]), state_dict_from_jax(run["after3"])
    frozen = [name for name, _ in model.named_parameters() if model.frozen_param_filter(name)]
    trainable = [name for name, p in model.named_parameters() if p.requires_grad]
    assert frozen and trainable and not set(frozen) & set(trainable)
    assert {id(p) for p in run["ttrainer"].params} == {id(p) for n, p in model.named_parameters() if n in trainable}
    params = dict(model.named_parameters())
    for name in frozen:
        assert torch.equal(params[name].detach(), start[name]), name
        assert torch.equal(after[name], start[name]), f"JAX moved frozen {name}"
    assert "encoder.fc3.weight" in frozen and "decoder.embed_tokens.weight" in trainable
    moved = [n for n in trainable if not torch.equal(params[n].detach(), start[n])]
    assert len(moved) > 0.9 * len(trainable)
    for stat in ("running_mean", "running_var"):
        got = getattr(model.encoder.bn[0], stat)
        assert not torch.equal(got, start[f"encoder.bn.0.{stat}"])
        np.testing.assert_allclose(_np(got), after[f"encoder.bn.0.{stat}"].numpy(), rtol=0, atol=1e-5)


def test_resume_from_jax_optimizer_state_with_frozen_parameters(train_run):
    """The port's trainer resumed from JAX's pickle after the third step
    (``optimizer_state_from_jax``: Adam's moments for the trainable
    parameters only) takes JAX's fourth step: the loss and gnorm at rtol
    1e-5, every parameter as JAX's at the step's tolerance, the frozen
    ones bitwise."""
    run = train_run
    want, got, _ = run["fourth"]
    np.testing.assert_allclose(float(got["loss"]), want["loss"], rtol=1e-5)
    np.testing.assert_allclose(float(got["gnorm"]), run["gnorm4"], rtol=1e-5)
    resumed = run["resumed"]
    state = resumed.optimizer.state_dict()["state"]
    assert len(state) == len(resumed.params) < sum(1 for _ in resumed.model.parameters())
    _assert_params(resumed.model.state_dict(), state_dict_from_jax(run["after4"]), run["lr_sum4"])
    start = state_dict_from_jax(run["start"])
    for name, p in resumed.model.named_parameters():
        if not p.requires_grad:
            assert torch.equal(p.detach(), start[name]), name


def test_src_step_keeps_the_audio_context_encoder(corpus, pretrained):
    """One port step with the previous audio as context (sequential
    gating, ``--freeze-pretrained encoder``): the audio context encoder's
    parameters and BatchNorm buffers are bitwise unchanged (frozen, and in
    eval mode inside the train step), the main encoder's statistics moved,
    and its N context layers trained."""
    path, pre = pretrained
    argv = _argv(corpus, "src", "--criterion", "label_smoothed_cross_entropy", "--pretrained-model", path,
                 "--optimizer", "adam", "--lr", "0.002", "--weight-decay", "0.01", "--max-tokens", "400")
    args = toptions.parse_args_and_arch(toptions.get_training_parser(), argv + ["--cpu"])
    task = TASKS[args.task].setup_task(args)
    task.load_dataset("train")
    model = task.build_model(args, device="cpu")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    trainer = Trainer(args, task, model, task.build_criterion(args))
    sample = next(iter(task.get_batch_iterator(task.dataset("train"), max_tokens=400, bucket_shapes=True,
                                               max_positions=task.max_positions(),
                                               required_batch_size_multiple=8).next_epoch_itr(shuffle=False)))
    logs = trainer.train_step([sample])
    trainer.flush_logs()
    assert np.isfinite(float(logs["loss"]))
    assert model.training and not model.context_encoder.audio_encoder.training
    after = model.state_dict()
    audio = [k for k in after if k.startswith("context_encoder.audio_encoder.")]
    assert audio and all(torch.equal(after[k], before[k]) for k in audio)
    assert not torch.equal(after["encoder.bn.0.running_mean"], before["encoder.bn.0.running_mean"])
    assert not torch.equal(after["context_encoder.layers.0.fc1.weight"], before["context_encoder.layers.0.fc1.weight"])
    np.testing.assert_array_equal(_np(model.context_encoder.audio_encoder.bn[0].running_var),
                                  pre["state"]["encoder"]["frontend"]["bns"][0]["var"])


def test_generate_on_a_jax_trained_checkpoint_matches_jax(corpus, train_run, tmp_path):
    """``cli/generate --task speech_recognition_context --max-sentences 1``
    on JAX's weights after the three steps: each test utterance's context
    is the previous one's best hypothesis; the port's H- lines (``--cpu``)
    carry JAX ``cli/generate``'s tokens and scores within 1e-4 (base 2),
    beam 2, in corpus order."""
    argv = [corpus, "--task", "speech_recognition_context", "--context-type", "tgt", "-t", "de", "--path",
            train_run["ckpt"], "--beam", "2", "--max-len-b", "8", "--max-sentences", "1", "--gen-subset", "test"]
    jgenerate.cli_main(argv + ["--results-path", str(tmp_path / "jax")])
    tgenerate.cli_main(argv + ["--results-path", str(tmp_path / "port"), "--cpu"])
    want = _records(str(tmp_path / "jax" / "generate-test.txt"))
    got = _records(str(tmp_path / "port" / "generate-test.txt"))
    assert sorted(got) == sorted(want) == [0, 1, 2, 3]
    for sid, (score, text) in want.items():
        assert got[sid][1] == text, sid
        assert abs(got[sid][0] - score) <= SCORE_ATOL, sid


@pytest.mark.parametrize("context_type", ["tgt", "src"])
def test_train_cli_from_a_port_checkpoint(corpus, tmp_path, context_type):
    """The port's ``cli/train`` pretrains a plain conv_transformer for an
    epoch, then trains ``conv_transformer_context`` for an epoch with that
    ``checkpoint_last.pt`` as ``--pretrained-model`` (``--freeze-pretrained
    encoder``): ``checkpoint_last.pt`` is written, its frozen parameters
    are bitwise the pretrained checkpoint's, and the logged losses are
    finite."""
    base = [corpus, "--task", "speech_recognition", "-t", "de", "--arch", "conv_transformer", *SMALL_ARGV,
            "--optimizer", "adam", "--lr", "0.001", "--max-tokens", "400", "--max-epoch", "1", "--log-format",
            "none", "--cpu", "--save-dir", str(tmp_path / "plain")]
    ttrain.cli_main(base)
    pre_path = str(tmp_path / "plain" / "checkpoint_last.pt")
    save_dir = str(tmp_path / context_type)
    trainer, _ = ttrain.cli_main(_argv(corpus, context_type, "--context-decoder-attention-type", "parallel",
                                       "--criterion", "label_smoothed_cross_entropy_ctxreg", "--label-smoothing",
                                       "0.1", "--ctx-reg-alpha", "0.1", "--pretrained-model", pre_path,
                                       "--freeze-pretrained", "encoder", "--optimizer", "adam", "--lr", "0.001",
                                       "--weight-decay", "0.01", "--max-tokens", "400", "--max-epoch", "1",
                                       "--log-format", "none", "--cpu", "--save-dir", save_dir))
    assert trainer.get_num_updates() > 0 and "checkpoint_last.pt" in os.listdir(save_dir)
    pre = tcheckpoint.load_checkpoint_to_cpu(pre_path)
    assert pre["format"] == "port"
    state = tcheckpoint.load_checkpoint_to_cpu(os.path.join(save_dir, "checkpoint_last.pt"))
    model = trainer.model
    frozen = [n for n, _ in model.named_parameters() if model.frozen_param_filter(n)]
    assert "encoder.fc3.weight" in frozen
    for name in frozen:
        src = name.replace("context_encoder.audio_encoder.", "encoder.")
        if name in model.pretrained_names:
            assert torch.equal(state["model"][name], pre["model"][src]), name
    rebuilt = TASKS["speech_recognition_context"].setup_task(state["args"]).build_model(state["args"], device="cpu")
    rebuilt.load_state_dict(state["model"], strict=True)
