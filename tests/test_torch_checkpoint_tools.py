"""PyTorch port, the checkpoint and scoring tools: ``average_checkpoints``
and ``cli/average_checkpoints`` on the port's files, on JAX pickles and on
fork ``.pt`` files; ``last_n_checkpoints`` against JAX's selection; and
``cli/score`` against JAX's.

The weights are made from a numpy seed in the shapes of a tiny
``conv_transformer``'s JAX tree (``jax.eval_shape`` of its init, no
forward). Averages are compared exactly: the float64 mean rounded to
float32, bitwise; the integer entries floor-divided. ``cli/score``'s
printed lines are compared as strings."""

import os
import sys

import jax
import numpy as np
import pytest
import torch

from fbk_fairseq_st_tpu import registry
from fbk_fairseq_st_tpu.cli import average_checkpoints as javerage_cli
from fbk_fairseq_st_tpu.cli import export_fairseq_checkpoint as jexport
from fbk_fairseq_st_tpu.cli import score as jscore
from fbk_fairseq_st_tpu.train import checkpoint as jcheckpoint
from fbk_fairseq_st_tpu_torch.cli import average_checkpoints as taverage_cli
from fbk_fairseq_st_tpu_torch.cli import score as tscore
from fbk_fairseq_st_tpu_torch.models import conv_transformer as tct
from fbk_fairseq_st_tpu_torch.train import checkpoint as tcheckpoint
from fbk_fairseq_st_tpu_torch.utils.weights import state_dict_from_jax

from .test_torch_model import torch_dictionary
from .utils import DummyTask, dummy_dictionary, model_args

TINY = dict(encoder_layers=1, decoder_layers=1, encoder_embed_dim=16, decoder_embed_dim=16, encoder_ffn_embed_dim=32,
            decoder_ffn_embed_dim=32, encoder_attention_heads=2, decoder_attention_heads=2,
            max_source_positions=64, max_target_positions=32, input_feat_per_channel=8)
BN_STATS = (".running_mean", ".running_var")


def _mean(states, key):
    """The float64 mean of ``key`` over state dicts, rounded to float32."""
    total = sum(np.asarray(s[key], np.float64) for s in states)
    return (total / len(states)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_files(tmp_path_factory):
    """Three JAX pickles (params and BatchNorm statistics from seeds 0-2,
    in the shapes of the tiny model's tree) and their fork exports."""
    root = tmp_path_factory.mktemp("average")
    args = model_args("conv_transformer", **TINY)
    registry.apply_architecture(args)
    model = registry.build_model(args, DummyTask(dummy_dictionary(40)))
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    pickles, forks = [], []
    for seed in range(3):
        rng = np.random.RandomState(seed)
        variables = jax.tree_util.tree_map(lambda s: rng.randn(*s.shape).astype(np.float32), shapes)
        path = str(root / f"checkpoint{seed + 1}.pt")
        jcheckpoint.save_state(path, {"args": vars(args), "model": variables["params"],
                                      "model_state": variables["state"], "extra_state": {"epoch": seed + 1}})
        pickles.append(path)
        os.makedirs(root / "fork", exist_ok=True)
        forks.append(str(root / "fork" / f"checkpoint{seed + 1}.pt"))
        jexport.cli_main([path, forks[-1]])
    return root, pickles, forks


def test_average_of_jax_pickles_matches_jax(jax_files, tmp_path):
    """The port's average of JAX pickles, through ``cli/average_checkpoints
    --num-epoch-checkpoints 2``: the params exactly JAX's average (after
    ``state_dict_from_jax``); the BatchNorm statistics, which JAX takes from
    the last file, the float64 mean as the reference averages them."""
    root, pickles, _ = jax_files
    out = str(tmp_path / "avg.pt")
    taverage_cli.cli_main(["--inputs", str(root), "--num-epoch-checkpoints", "2", "--output", out])
    got = torch.load(out, weights_only=False)
    jax_avg = jcheckpoint.average_checkpoints(pickles[1:])
    want = state_dict_from_jax({"params": jax_avg["model"], "state": {}})
    inputs = [tcheckpoint.load_checkpoint_to_cpu(p)["model"] for p in pickles[1:]]
    assert sorted(got["model"]) == sorted(inputs[0])
    n_stats = 0
    for name, value in got["model"].items():
        assert value.dtype == torch.float32
        if name.endswith(BN_STATS):
            n_stats += 1
            np.testing.assert_array_equal(value.numpy(), _mean(inputs, name), err_msg=name)
        else:
            np.testing.assert_array_equal(value.numpy(), want[name].numpy(), err_msg=name)
    assert n_stats > 0
    assert got["args"].arch == "conv_transformer" and got["optimizer_history"] == []


def test_average_of_fork_pts_equals_average_of_pickles(jax_files):
    """The fork exports of the same pickles average to the same tensors."""
    _, pickles, forks = jax_files
    a = tcheckpoint.average_checkpoints(pickles)["model"]
    b = tcheckpoint.average_checkpoints(forks)["model"]
    assert sorted(a) == sorted(b)
    for name in a:
        assert torch.equal(a[name], b[name]), name


def test_average_of_port_files(tmp_path):
    """The port's own files (``save_model_checkpoint`` of three seeded
    models, each with an int64 entry): every float tensor the float64 mean
    rounded to float32 (a float32 sum misses it), the integer entry
    floor-divided, the last file's other entries kept; the result loads
    strictly into the model."""
    paths, states = [], []
    for seed in (1, 2, 3):
        model = tct.build_model("conv_transformer", torch_dictionary(), device="cpu", seed=seed, **TINY)
        args = model_args("conv_transformer", task="speech_recognition", **TINY)
        path = str(tmp_path / f"m{seed}.pt")
        tcheckpoint.save_model_checkpoint(path, args, model)
        state = torch.load(path, weights_only=False)
        state["model"]["counts"] = torch.tensor([seed ** 2, 7], dtype=torch.int64)
        state["extra_state"] = {"seed": seed}
        tcheckpoint.save_state(path, state)
        paths.append(path)
        states.append({k: v.numpy() for k, v in state["model"].items()})
    avg = tcheckpoint.average_checkpoints(paths)
    assert avg["extra_state"] == {"seed": 3} and "format" not in avg
    for name, value in avg["model"].items():
        if name == "counts":
            assert value.dtype == torch.int64 and value.tolist() == [4, 7]  # 14 // 3
        else:
            np.testing.assert_array_equal(value.numpy(), _mean(states, name), err_msg=name)
    del avg["model"]["counts"]
    model = tct.build_model("conv_transformer", torch_dictionary(), device="cpu", seed=0, **TINY)
    model.load_state_dict(avg["model"], strict=True)


def test_average_refuses_files_of_other_models(tmp_path):
    paths = []
    for layers in (1, 2):
        options = {**TINY, "encoder_layers": layers}
        model = tct.build_model("conv_transformer", torch_dictionary(), device="cpu", seed=1, **options)
        paths.append(str(tmp_path / f"l{layers}.pt"))
        tcheckpoint.save_model_checkpoint(paths[-1], model_args("conv_transformer", **options), model)
    with pytest.raises(KeyError):
        tcheckpoint.average_checkpoints(paths)


@pytest.mark.parametrize("selection", [(3, False, None), (2, False, 5), (2, True, None), (1, True, 250)])
def test_last_n_checkpoints_matches_jax(tmp_path, selection):
    for name in [f"checkpoint{e}.pt" for e in (1, 2, 3, 10, 12)] + ["checkpoint_best.pt", "checkpoint_last.pt",
                                                                      "checkpoint_2_200.pt", "checkpoint_3_300.pt",
                                                                      "checkpoint_1_100.pt", "checkpoint12.pt.tmp"]:
        (tmp_path / name).write_bytes(b"")
    n, update_based, upper = selection
    want = javerage_cli.last_n_checkpoints([str(tmp_path)], n, update_based, upper_bound=upper)
    assert taverage_cli.last_n_checkpoints([str(tmp_path)], n, update_based, upper_bound=upper) == want
    with pytest.raises(Exception, match="need at least"):
        taverage_cli.last_n_checkpoints([str(tmp_path)], 9, update_based)


@pytest.fixture(scope="module")
def texts(tmp_path_factory):
    root = tmp_path_factory.mktemp("score")
    rng = np.random.RandomState(0)
    words = [f"w{i}" for i in range(12)] + ["Wa", "WA"]
    refs, hyps = [], []
    for _ in range(20):
        ref = list(rng.choice(words, size=rng.randint(4, 12)))
        hyp = [w if rng.rand() < 0.7 else str(rng.choice(words)) for w in ref][: len(ref) - rng.randint(0, 3)]
        refs.append(" ".join(ref) + "\n")
        hyps.append(" ".join(hyp) + "\n")
    (root / "ref.txt").write_text("".join(refs))
    (root / "sys.txt").write_text("".join(hyps))
    return root


@pytest.mark.parametrize("extra", [[], ["--sentence-bleu"], ["--ignore-case", "-o", "2"], ["--sacrebleu"]],
                         ids=["corpus", "sentence", "ignore-case-order-2", "sacrebleu"])
def test_score_matches_jax(texts, capsys, extra):
    argv = ["--sys", str(texts / "sys.txt"), "--ref", str(texts / "ref.txt"), *extra]
    jscore.cli_main(argv)
    want = capsys.readouterr().out
    tscore.cli_main(argv)
    got = capsys.readouterr().out
    assert got == want and len(got.splitlines()) == (20 if extra == ["--sentence-bleu"] else 1)


def test_score_sacrebleu_raises_without_the_package(texts, monkeypatch):
    monkeypatch.setitem(sys.modules, "sacrebleu", None)
    with pytest.raises(ImportError, match="--sacrebleu needs the sacrebleu package"):
        tscore.cli_main(["--sys", str(texts / "sys.txt"), "--ref", str(texts / "ref.txt"), "--sacrebleu"])
