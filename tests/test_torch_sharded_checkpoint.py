"""PyTorch port, JAX's sharded checkpoint layout and the asynchronous
writer (``train/sharded_checkpoint.py``).

  * A directory JAX's ``save_sharded`` writes (a conv_transformer's
    params, model state and optax Adam state, one leaf split into 4 shards
    over the CPU mesh) reads to the state its pickle reads to: the same
    state dict and, through ``optimizer_state_from_jax``, the same port
    optimiser state (exact), the same scalars.
  * A manifest with a shard left out, or a shard of the wrong shape, is
    refused (``ValueError``).
  * The port's own state written in that layout reads back bitwise, and
    JAX's ``load_sharded`` takes its manifest (the same arrays).
  * ``cli/train --checkpoint-format sharded --async-checkpoint``: a run
    stopped at ``--max-update 3`` and resumed from its sharded
    ``checkpoint_last.pt`` ends with the straight run's weights and
    optimiser state, bitwise, dropout on (tests/test_torch_train_resume.py's
    setting); the retention rules drop old directories.
"""

import os
import pickle

import jax
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec

from fbk_fairseq_st_tpu import registry as jregistry
from fbk_fairseq_st_tpu.train import sharded_checkpoint as jsharded
from fbk_fairseq_st_tpu.train.checkpoint import save_state
from fbk_fairseq_st_tpu_torch.cli import train as ttrain
from fbk_fairseq_st_tpu_torch.optim.optimizers import build_optimizer
from fbk_fairseq_st_tpu_torch.train import checkpoint as tcheckpoint
from fbk_fairseq_st_tpu_torch.train import sharded_checkpoint as tsharded
from fbk_fairseq_st_tpu_torch.utils.weights import optimizer_state_from_jax

from .test_torch_generate_cli import SMALL
from .test_torch_model import torch_dictionary
from .test_torch_train_cli import argv, write_corpus
from .utils import DummyTask, dummy_dictionary, model_args


def _jax_state():
    args = model_args("conv_transformer", task="speech_translation_with_transcription", **SMALL)
    jregistry.apply_architecture(args)
    model = jregistry.build_model(args, DummyTask(dummy_dictionary(40)))
    variables = jax.tree_util.tree_map(np.asarray, jax.jit(model.init)(jax.random.PRNGKey(4)))
    tx = optax.chain(optax.clip_by_global_norm(10.0), optax.adam(1e-3))
    opt = tx.init(variables["params"])
    rng = np.random.RandomState(0)
    for _ in range(2):
        grads = jax.tree_util.tree_map(lambda p: rng.randn(*p.shape).astype(np.float32), variables["params"])
        _, opt = tx.update(grads, opt, variables["params"])
    return args, variables, jax.tree_util.tree_map(np.asarray, opt)


def _state(args, variables, opt):
    return {"args": vars(args), "model": variables["params"], "model_state": variables["state"],
            "opt_state": opt, "lr_scheduler": {"lr": [0.001]}, "num_updates": 2,
            "extra_state": {"train_iterator": {"epoch": 1, "iterations_in_epoch": 2}, "val_loss": 3.5}}


@pytest.fixture(scope="module")
def jax_written(tmp_path_factory):
    root = tmp_path_factory.mktemp("sharded")
    args, variables, opt = _jax_state()
    state = _state(args, variables, opt)
    pickled, sharded = str(root / "pickle.pt"), str(root / "sharded.pt")
    save_state(pickled, state)
    # one leaf split over 4 devices of the CPU mesh: four shard files
    mesh = Mesh(np.array(jax.devices()[:4]), ("data",))
    params = dict(variables["params"])
    embed = params["decoder"]["embed_tokens"]
    params["decoder"] = {**params["decoder"], "embed_tokens": {
        **embed, "w": jax.device_put(embed["w"], NamedSharding(mesh, PartitionSpec("data", None)))}}
    jsharded.save_sharded(sharded, {**state, "model": params})
    return root, args, pickled, sharded


def test_jax_sharded_directory_reads_as_its_pickle(jax_written):
    root, args, pickled, sharded = jax_written
    with open(os.path.join(sharded, "meta.pkl"), "rb") as f:
        leaves = {e["path"]: e for e in pickle.load(f)["trees"]["model"]["leaves"]}
    assert len(leaves["decoder/embed_tokens/w"]["shards"]) == 4
    a, b = tcheckpoint.load_checkpoint_to_cpu(pickled), tcheckpoint.load_checkpoint_to_cpu(sharded)
    assert a["format"] == b["format"] == "jax"
    assert sorted(a["model"]) == sorted(b["model"]) and len(a["model"]) > 20
    for k, v in a["model"].items():
        assert torch.equal(v, b["model"][k]), k
    for key in ("num_updates", "lr_scheduler", "extra_state"):
        assert a[key] == b[key], key
    assert vars(a["args"]) == vars(b["args"])
    # the optax state, through the bridge, into a port Adam over the model
    from fbk_fairseq_st_tpu_torch.models import conv_transformer as tct

    model = tct.build_model("conv_transformer", torch_dictionary(), device="cpu",
                            **{k: v for k, v in SMALL.items()})
    args.optimizer = "adam"
    optimizer = build_optimizer(args, list(model.parameters()))
    sa = optimizer_state_from_jax(a["opt_state"], a["params_tree"], model, optimizer)
    sb = optimizer_state_from_jax(b["opt_state"], b["params_tree"], model, optimizer)
    assert sorted(sa["state"]) == sorted(sb["state"]) and len(sa["state"]) == len(list(model.parameters()))
    for i, entry in sa["state"].items():
        assert sorted(entry) == sorted(sb["state"][i]) == ["exp_avg", "exp_avg_sq", "step"]
        for k, v in entry.items():
            assert torch.equal(v, sb["state"][i][k]), (i, k)


def _rewrite_manifest(src, dst, change):
    import shutil

    shutil.copytree(src, dst)
    with open(os.path.join(dst, "meta.pkl"), "rb") as f:
        manifest = pickle.load(f)
    change(manifest)
    with open(os.path.join(dst, "meta.pkl"), "wb") as f:
        pickle.dump(manifest, f)


def test_holes_and_wrong_shapes_are_refused(jax_written):
    root, _, _, sharded = jax_written

    def entry(manifest):
        return next(e for e in manifest["trees"]["model"]["leaves"] if e["path"] == "decoder/embed_tokens/w")

    hole = str(root / "hole.pt")
    _rewrite_manifest(sharded, hole, lambda m: entry(m)["shards"].pop(1))
    with pytest.raises(ValueError, match="incomplete"):
        tcheckpoint.load_checkpoint_to_cpu(hole)
    with pytest.raises(ValueError, match="incomplete"):
        jsharded.load_sharded(hole)  # JAX refuses it too
    wrong = str(root / "wrong.pt")

    def widen(m):
        shard = entry(m)["shards"][0]
        (a, b), cols = shard["index"]
        shard["index"] = ((a, b + 1), cols)

    _rewrite_manifest(sharded, wrong, widen)
    with pytest.raises(ValueError, match="index says"):
        tcheckpoint.load_checkpoint_to_cpu(wrong)
    with pytest.raises(FileNotFoundError):
        os.makedirs(str(root / "empty.pt"))
        tcheckpoint.load_checkpoint_to_cpu(str(root / "empty.pt"))


def _port_state():
    from fbk_fairseq_st_tpu_torch.models import conv_transformer as tct

    model = tct.build_model("conv_transformer", torch_dictionary(), device="cpu", **SMALL)
    args = model_args("conv_transformer", **SMALL, optimizer="adam", lr=[0.001], adam_betas="(0.9, 0.98)",
                      adam_eps=1e-8, weight_decay=0.0)
    optimizer = build_optimizer(args, list(model.parameters()))
    for p in model.parameters():
        p.grad = torch.randn_like(p)
    optimizer.step()
    names = {id(p): n for n, p in model.named_parameters()}
    return {"args": args, "model": {k: v.detach().clone() for k, v in model.state_dict().items()},
            "optimizer_history": [{"criterion_name": "C", "optimizer_name": "Adam", "lr_scheduler_state": {"x": 1},
                                   "num_updates": 1}],
            "last_optimizer_state": optimizer.state_dict(),
            "last_optimizer_param_names": [names[id(p)] for g in optimizer.param_groups for p in g["params"]],
            "extra_state": {"val_loss": 2.0, "train_iterator": {"epoch": 1}}}


def test_port_layout_reads_back_bitwise_and_jax_reads_it(tmp_path):
    state = _port_state()
    path = str(tmp_path / "checkpoint_last.pt")
    tsharded.save_sharded([path, str(tmp_path / "checkpoint_best.pt")], tcheckpoint._sharded_state(state))
    for name in ("checkpoint_last.pt", "checkpoint_best.pt"):
        back = tcheckpoint.load_checkpoint_to_cpu(str(tmp_path / name))
        assert back["format"] == "port"
        assert sorted(back["model"]) == sorted(state["model"])
        for k, v in state["model"].items():
            assert back["model"][k].dtype == v.dtype and torch.equal(back["model"][k], v), k
        want, got = state["last_optimizer_state"], back["last_optimizer_state"]
        assert got["param_groups"] == want["param_groups"]
        assert sorted(got["state"]) == sorted(want["state"])
        for i, entry in want["state"].items():
            for k, v in entry.items():
                assert torch.equal(got["state"][i][k], v), (i, k)
        for key in ("optimizer_history", "last_optimizer_param_names", "extra_state"):
            assert back[key] == state[key], key
    # JAX's reader takes the manifest and unflattens the same arrays
    jstate = jsharded.load_sharded(path)
    for k, v in state["model"].items():
        np.testing.assert_array_equal(np.asarray(jstate["model"][k]), v.numpy())
    assert jstate["opt_state"]["state"]["0"]["exp_avg"].shape == tuple(state["model"][
        state["last_optimizer_param_names"][0]].shape)
    assert jstate["model_state"] is None


def test_tree_from_paths_rebuilds_containers():
    tree = tsharded.tree_from_paths([("1/0/.count", 3), ("1/0/.mu/a/0/w", 1), ("1/0/.mu/a/2/w", 2), ("b", 4)])
    assert tree["b"] == 4
    chain = tree["1"] if isinstance(tree, dict) else None
    assert chain is not None and chain[0]._fields == ("count", "mu")
    assert chain[0].mu["a"] == [{"w": 1}, None, {"w": 2}]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("sharded_train"))
    data_dir = os.path.join(root, "data")
    write_corpus(data_dir, np.random.RandomState(2))
    return root, data_dir


DROPOUT = ["--dropout", "0.1", "--attention-dropout", "0.1", "--relu-dropout", "0.1"]
SHARDED = ["--checkpoint-format", "sharded", "--async-checkpoint", "--max-update", "6",
           "--save-interval-updates", "2", "--keep-interval-updates", "1"]


def test_async_sharded_resume_is_bitwise_the_straight_run(corpus):
    root, data_dir = corpus
    straight_dir, resumed_dir = os.path.join(root, "straight"), os.path.join(root, "resumed")
    trainer_a, _ = ttrain.cli_main(argv(data_dir, straight_dir, "label_smoothed_cross_entropy", *DROPOUT, *SHARDED))
    ttrain.cli_main(argv(data_dir, resumed_dir, "label_smoothed_cross_entropy", *DROPOUT, *SHARDED[:-4],
                         "--max-update", "3", *SHARDED[-4:-2]))
    assert tsharded.is_sharded_checkpoint(os.path.join(resumed_dir, "checkpoint_last.pt"))
    trainer_b, itr_b = ttrain.cli_main(argv(data_dir, resumed_dir, "label_smoothed_cross_entropy", *DROPOUT,
                                            *SHARDED))
    assert trainer_a.get_num_updates() == trainer_b.get_num_updates() == 6
    sa, sb = trainer_a.model.state_dict(), trainer_b.model.state_dict()
    for k, v in sa.items():
        assert torch.equal(v, sb[k]), k
    oa, ob = trainer_a.optimizer.state_dict()["state"], trainer_b.optimizer.state_dict()["state"]
    for i, entry in oa.items():
        for k, v in entry.items():
            assert torch.equal(v, ob[i][k]), (i, k)
    files = sorted(os.listdir(straight_dir))
    assert all(tsharded.is_sharded_checkpoint(os.path.join(straight_dir, f)) for f in files), files
    assert [f for f in files if f.startswith("checkpoint_")] == [
        "checkpoint_2_6.pt", "checkpoint_best.pt", "checkpoint_last.pt"], files
    last = tcheckpoint.load_checkpoint_to_cpu(os.path.join(straight_dir, "checkpoint_last.pt"))
    for k, v in sa.items():
        assert torch.equal(last["model"][k], v.cpu()), k
    assert last["optimizer_history"][-1]["num_updates"] == 6
