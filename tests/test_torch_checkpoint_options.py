"""PyTorch port, the checkpoint options of ROADMAP Queue A item 3 against JAX.

  * Layer pruning at load (``--encoder-layers-to-keep`` /
    ``--decoder-layers-to-keep`` through ``--model-overrides``): the port's
    ``load_model_ensemble_and_task`` and JAX's on the same JAX checkpoint
    (3 + 3 layers, keep 0,2 and 1): the same layer counts, teacher-forced
    logits within 1e-4, and ``cli/generate`` with the overrides gives
    JAX's hypotheses.
  * ``merge_partial_state`` (``--allow-partial-restore``) in JAX's cases:
    leaves missing, leaves unexpected, a shape that differs; the merged
    weights and the missing / unexpected names equal JAX's through the
    bridge; ``cli/train --allow-partial-restore`` resumes from a
    checkpoint that lacks a layer.
  * ``--user-dir``: a module that registers an arch alias (trained
    through ``cli/train``) and a tokenizer; JAX's import rules (once per
    realpath, an alias on a name collision).
  * ``cli/export_fairseq_checkpoint``: the model equals JAX's
    ``export_parameters`` of the same pickle but at the known JAX faults
    (ROADMAP Queue C: the three lightconv leaves the export transposes);
    ``cli/import_fairseq_checkpoint`` of it gives back the same state dict
    bitwise, loaded strictly, with JAX's report.
  * ``--num-shards`` / ``--shard-id``: each shard's records equal JAX's,
    and the shards together give the unsharded run's."""

import argparse
import os
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fbk_fairseq_st_tpu import registry as jregistry
from fbk_fairseq_st_tpu.cli import generate as jgenerate
from fbk_fairseq_st_tpu.utils import fairseq_interop as jimport
from fbk_fairseq_st_tpu.train import checkpoint as jcheckpoint
from fbk_fairseq_st_tpu.utils.fairseq_interop import export_parameters
from fbk_fairseq_st_tpu_torch import options as toptions
from fbk_fairseq_st_tpu_torch import registry as tregistry
from fbk_fairseq_st_tpu_torch.cli import export_fairseq_checkpoint as texport
from fbk_fairseq_st_tpu_torch.cli import generate as tgenerate
from fbk_fairseq_st_tpu_torch.cli import import_fairseq_checkpoint as timport
from fbk_fairseq_st_tpu_torch.cli import train as ttrain
from fbk_fairseq_st_tpu_torch.train import checkpoint as tcheckpoint
from fbk_fairseq_st_tpu_torch.utils import user_dir as tuser_dir
from fbk_fairseq_st_tpu_torch.utils.weights import fork_name, state_dict_from_jax

from .test_torch_generate_cli import SMALL, _write_corpus
from .test_torch_lightconv import _EXPORT_SLIPS
from .test_torch_lightconv import _build_pair as _build_lc_pair
from .test_torch_train_cli import argv as train_argv
from .test_torch_train_cli import write_corpus
from .torch_shared import session_root, shared
from .utils import DummyTask, model_args

DEEP = {**SMALL, "encoder_layers": 3, "decoder_layers": 3}


def _corpus(root):
    from fbk_fairseq_st_tpu.data import Dictionary as JaxDictionary

    data_dir = os.path.join(root, "data")
    _write_corpus(data_dir, np.random.RandomState(0), n=8)
    args = model_args("conv_transformer", task="speech_translation_with_transcription", **DEEP)
    args.data, args.source_lang, args.target_lang = data_dir, "en", "de"
    jregistry.apply_architecture(args)
    model = jregistry.build_model(args, DummyTask(JaxDictionary.load(os.path.join(data_dir, "dict.de.txt"))))
    variables = jax.tree_util.tree_map(np.asarray, jax.jit(model.init)(jax.random.PRNGKey(6)))
    pickled = os.path.join(root, "checkpoint.pt")
    jcheckpoint.save_state(pickled, {"args": vars(args), "model": variables["params"],
                                     "model_state": variables["state"]})
    return root, data_dir, pickled


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """tests/test_torch_generate_cli.py's corpus and a JAX pickle of a
    3 + 3-layer conv_transformer on it, once for the session
    (``torch_shared``); each test writes under names of its own."""
    return shared(session_root(tmp_path_factory), "checkpoint_options", _corpus)


def _gen_argv(data_dir, path, *extra):
    return [data_dir, "--task", "speech_translation_with_transcription", "-s", "en", "-t", "de", "--path", path,
            "--beam", "3", "--max-len-b", "8", "--gen-subset", "test", "--max-sentences", "2", "--cpu", *extra]


def _hyps(path):
    out = {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            if line[:2] in ("H-", "T-"):
                head, *fields = line.rstrip("\n").split("\t")
                out[head] = fields
    return out


def _same_hyps(got, want):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k][-1] == w[-1], k
        if k.startswith("H-"):
            assert abs(float(got[k][0]) - float(w[0])) <= 1e-4


def test_pruned_model_matches_jax(corpus):
    root, data_dir, pickled = corpus
    overrides = {"encoder_layers_to_keep": "0,2", "decoder_layers_to_keep": "1"}
    jtask_args = toptions.parse_args_and_arch(toptions.get_generation_parser(), _gen_argv(data_dir, pickled))
    ttask = tregistry.TASKS[jtask_args.task].setup_task(jtask_args)
    (tmodel,), targs, _ = tcheckpoint.load_model_ensemble_and_task([pickled], dict(overrides), task=ttask,
                                                                    device="cpu")
    from fbk_fairseq_st_tpu import options as joptions

    jparsed = joptions.parse_args_and_arch(joptions.get_generation_parser(), _gen_argv(data_dir, pickled))
    jtask = jregistry.TASKS[jparsed.task].setup_task(jparsed)
    [(jmodel, variables)], jargs, _ = jcheckpoint.load_model_ensemble_and_task([pickled], dict(overrides),
                                                                              task=jtask)
    assert (targs.encoder_layers, targs.decoder_layers) == (jargs.encoder_layers, jargs.decoder_layers) == (2, 1)
    assert len(tmodel.encoder.layers) == 2 and len(tmodel.decoder.layers) == 1
    full = tcheckpoint.load_checkpoint_to_cpu(pickled)["model"]
    pruned = tmodel.state_dict()
    assert torch.equal(pruned["encoder.layers.1.fc1.weight"], full["encoder.layers.2.fc1.weight"])
    assert torch.equal(pruned["decoder.layers.0.fc2.weight"], full["decoder.layers.1.fc2.weight"])
    rng = np.random.RandomState(1)
    batch = {"src_tokens": rng.randn(2, 30, SMALL["input_feat_per_channel"]).astype(np.float32),
             "src_lengths": np.array([30, 24], np.int32),
             "prev_output_tokens": np.array([[2, 5, 6, 7], [2, 8, 9, 1]], np.int32)}
    (jlogits, _), _ = jax.jit(lambda v, b: jmodel.forward(v, b, training=False))(
        variables, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        tlogits, _ = tmodel({k: torch.tensor(v).long() if v.dtype != np.float32 else torch.tensor(v)
                             for k, v in batch.items()})
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), rtol=0, atol=1e-4)
    # cli/generate with the overrides
    extra = ["--model-overrides", repr(overrides)]
    jgenerate.cli_main(_gen_argv(data_dir, pickled, *extra, "--results-path", os.path.join(root, "jax_pruned")))
    tgenerate.cli_main(_gen_argv(data_dir, pickled, *extra, "--results-path", os.path.join(root, "port_pruned")))
    _same_hyps(_hyps(os.path.join(root, "port_pruned", "generate-test.txt")),
               _hyps(os.path.join(root, "jax_pruned", "generate-test.txt")))


def _jax_name(path: str) -> str:
    return fork_name(path.split("."))


@pytest.mark.parametrize("case", ["missing", "unexpected", "both"])
def test_merge_partial_state_matches_jax(case):
    args = model_args("conv_transformer", **DEEP)
    jregistry.apply_architecture(args)
    from fbk_fairseq_st_tpu.data import Dictionary as JaxDictionary

    d = JaxDictionary()
    for i in range(12):
        d.add_symbol(f"w{i}")
    model = jregistry.build_model(args, DummyTask(d))
    init = jax.tree_util.tree_map(np.asarray, jax.jit(model.init)(jax.random.PRNGKey(0)))["params"]
    ckpt = jax.tree_util.tree_map(lambda x: x + 1.0, init)
    ckpt = {**ckpt, "decoder": dict(ckpt["decoder"])}
    if case in ("missing", "both"):
        # a dict-level leaf and a whole subtree (JAX's merge takes a list,
        # the layers, from the checkpoint whole: ROADMAP Queue C)
        ckpt["decoder"]["final_ln"] = {k: v for k, v in ckpt["decoder"]["final_ln"].items() if k != "b"}
        del ckpt["decoder"]["embed_out"]
    if case in ("unexpected", "both"):
        ckpt["decoder"]["extra_head"] = {"w": np.ones((3, 4), np.float32)}
    from fbk_fairseq_st_tpu.train.checkpoint import merge_partial_state as jmerge

    jmerged, jmissing, junexpected = jmerge(init, ckpt)
    own, theirs = state_dict_from_jax({"params": init}), state_dict_from_jax({"params": ckpt})
    merged, missing, unexpected = tcheckpoint.merge_partial_state(own, theirs)
    want = state_dict_from_jax({"params": jmerged})
    assert sorted(merged) == sorted(want)
    for k, v in want.items():
        assert torch.equal(merged[k], v), k

    def leaves_under(names, sd):
        # JAX names a missing or unexpected subtree once, the port each leaf
        prefixes = [_jax_name(n) for n in names]
        return sorted(k for k in sd if any(k == p or k.startswith(p + ".") for p in prefixes))

    assert sorted(missing) == leaves_under(jmissing, own)
    assert sorted(unexpected) == leaves_under(junexpected, theirs)
    assert bool(missing) == (case != "unexpected") and bool(unexpected) == (case != "missing")
    bad = dict(theirs)
    bad["decoder.layers.0.fc1.weight"] = torch.zeros(2, 2)
    with pytest.raises(ValueError, match="partial restore: param 'decoder.layers.0.fc1.weight' has shape"):
        tcheckpoint.merge_partial_state(own, bad)


@pytest.fixture(scope="module")
def train_corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ckpt_options_train"))
    data_dir = os.path.join(root, "data")
    write_corpus(data_dir, np.random.RandomState(3))
    return root, data_dir


def test_train_allow_partial_restore(train_corpus):
    """A checkpoint without the last encoder layer's FFN: a plain resume
    refuses it, ``--allow-partial-restore`` keeps the model's own values
    for it and the checkpoint's for every other entry."""
    root, data_dir = train_corpus
    first = os.path.join(root, "first")
    trainer, _ = ttrain.cli_main(train_argv(data_dir, first, "nag_fixed", "--max-update", "1"))
    state = torch.load(os.path.join(first, "checkpoint_last.pt"), weights_only=False)
    dropped = [k for k in state["model"] if k.startswith("encoder.layers.1.fc1.")]
    assert dropped
    for k in dropped:
        del state["model"][k]
    part = os.path.join(root, "partial.pt")
    torch.save(state, part)
    with pytest.raises(RuntimeError):
        ttrain.cli_main(train_argv(data_dir, os.path.join(root, "strict"), "nag_fixed", "--max-update", "1",
                                   "--restore-file", part))
    trainer2, _ = ttrain.cli_main(train_argv(data_dir, os.path.join(root, "partial"), "nag_fixed", "--max-update",
                                             "1", "--restore-file", part, "--allow-partial-restore",
                                             "--no-save"))
    assert trainer2.get_num_updates() == 1  # the restored count, nothing left to train


USER_MODULE = '''
from fbk_fairseq_st_tpu_torch import registry

registry.register_architecture("{name}", "conv_transformer")


@registry.TOKENIZERS.register("{name}_upper")
class Upper:
    @classmethod
    def build_tokenizer(cls, args):
        return cls()

    def encode(self, x):
        return x.upper()

    def decode(self, x):
        return x.lower()
'''


@pytest.fixture
def registries():
    """The registries a user module adds to, restored after the test so
    that its names do not reach other tests in the process."""
    from fbk_fairseq_st_tpu_torch import models
    from fbk_fairseq_st_tpu_torch.data import encoders
    from fbk_fairseq_st_tpu_torch.models import conv_transformer

    tables = (models.ARCHITECTURES, conv_transformer.ARCHITECTURES, encoders.TOKENIZERS)
    saved = [dict(t) for t in tables]
    yield
    for table, before in zip(tables, saved):
        table.clear()
        table.update(before)


def test_user_dir_registers_an_arch_alias(train_corpus, tmp_path, registries):
    root, data_dir = train_corpus
    module = tmp_path / "fbk_port_user_module"
    module.mkdir()
    (module / "__init__.py").write_text(USER_MODULE.format(name="my_conv_transformer"))
    argv = train_argv(data_dir, os.path.join(root, "user_dir"), "nag_fixed", "--max-update", "1",
                      "--user-dir", str(module))
    argv[argv.index("conv_transformer")] = "my_conv_transformer"
    trainer, _ = ttrain.cli_main(argv)
    assert trainer.args.arch == "my_conv_transformer" and trainer.get_num_updates() == 1
    # imported once per realpath: another spelling of the path is a no-op
    tuser_dir.import_user_module(argparse.Namespace(user_dir=str(module) + "/."))
    assert "my_conv_transformer" in tregistry.ARCHITECTURES
    with pytest.raises(ValueError, match="duplicate"):
        tregistry.register_architecture("my_conv_transformer", "conv_transformer")
    # the module's codec joined the tokenizers the parser and the CLIs build
    from fbk_fairseq_st_tpu_torch.data import encoders

    assert encoders.build_tokenizer(argparse.Namespace(tokenizer="my_conv_transformer_upper")).encode("ab") == "AB"
    with pytest.raises(ValueError, match="duplicate"):
        tregistry.TOKENIZERS.register("space")(object)


def test_user_dir_collision_imports_under_an_alias(tmp_path, registries):
    """A directory named like an imported module (``json``) is imported
    from its ``__init__.py`` under a private alias, once."""
    module = tmp_path / "json"
    module.mkdir()
    (module / "__init__.py").write_text(USER_MODULE.format(name="collided_conv_transformer"))
    for _ in range(2):
        tuser_dir.import_user_module(argparse.Namespace(user_dir=str(module)))
    assert "collided_conv_transformer" in tregistry.ARCHITECTURES
    assert any(m.startswith("fbk_user_dir_") for m in sys.modules)
    with pytest.raises(FileNotFoundError):
        tuser_dir.import_user_module(argparse.Namespace(user_dir=str(tmp_path / "absent")))


def test_export_matches_jax_export_and_import_round_trips(corpus):
    root, _, pickled = corpus
    ours, theirs = os.path.join(root, "port_fork.pt"), os.path.join(root, "jax_fork.pt")
    texport.cli_main([pickled, ours])
    from fbk_fairseq_st_tpu.cli import export_fairseq_checkpoint as jexport

    jexport.cli_main([pickled, theirs])
    a, b = torch.load(ours, weights_only=False), torch.load(theirs, weights_only=False)
    assert sorted(a) == sorted(b) == ["args", "extra_state", "model", "optimizer_history"]
    assert sorted(a["model"]) == sorted(b["model"])
    for k, v in b["model"].items():
        assert torch.equal(a["model"][k], v), k
    assert vars(a["args"]) == vars(b["args"])
    # the port's import of the export: the same state dict, bitwise
    back = os.path.join(root, "imported.pt")
    report = timport.cli_main([ours, back])
    jreport = jimport.import_fairseq_checkpoint(ours, os.path.join(root, "jax_imported.pt"))
    assert report == {"missing": [], "unused": []} and jreport["unused"] == [] and jreport["missing"] == []
    state = tcheckpoint.load_checkpoint_to_cpu(back)
    assert state["format"] == "port" and state["extra_state"]["imported_from"] == ours
    for k, v in a["model"].items():
        assert torch.equal(state["model"][k], v), k
    # and JAX's cli/generate reads the port's export
    assert jcheckpoint.load_checkpoint_to_cpu(os.path.join(root, "jax_imported.pt"))["model"]


def test_import_report_matches_jax_on_a_partial_file(corpus):
    root, _, pickled = corpus
    fork = os.path.join(root, "partial_fork.pt")
    texport.export_fairseq_checkpoint(pickled, fork)
    state = torch.load(fork, weights_only=False)
    del state["model"]["decoder.layers.0.fc1.bias"]
    state["model"]["decoder.stray.weight"] = torch.zeros(2)
    torch.save(state, fork)
    with pytest.raises(ValueError, match="unported parameters"):
        timport.cli_main([fork, os.path.join(root, "strict.pt")])
    report = timport.cli_main([fork, os.path.join(root, "loose.pt"), "--non-strict"])
    jreport = jimport.import_fairseq_checkpoint(fork, os.path.join(root, "jax_loose.pt"), strict=False)
    assert report["unused"] == jreport["unused"] == ["decoder.stray.weight"]
    assert report["missing"] == ["decoder.layers.0.fc1.bias"] and len(jreport["missing"]) == 1


def test_lightconv_export_matches_jax_but_at_its_known_faults(tmp_path):
    _, jmodel, variables, _, _ = _build_lc_pair("dynamicconv_iwslt_de_en")
    args = model_args("dynamicconv_iwslt_de_en", encoder_conv_type="dynamic", decoder_conv_type="dynamic")
    pickled = str(tmp_path / "lc.pt")
    jcheckpoint.save_state(pickled, {"args": vars(args), "model": variables["params"],
                                     "model_state": variables["state"]})
    ours = str(tmp_path / "lc_fork.pt")
    texport.cli_main([pickled, ours])
    got = torch.load(ours, weights_only=False)["model"]
    want = export_parameters(variables)
    assert sorted(got) == sorted(want)
    slipped = set()
    for k, v in want.items():
        if k.endswith(_EXPORT_SLIPS):
            slipped.add(k)
            v = v.T
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    assert {k.rsplit(".", 2)[-2] for k in slipped} == {"encoder_embed", "decoder_embed"}


@pytest.mark.parametrize("shard_id", [0, 1])
def test_num_shards_match_jax(corpus, shard_id):
    root, data_dir, pickled = corpus
    extra = ["--num-shards", "2", "--shard-id", str(shard_id)]
    jres, tres = os.path.join(root, f"jax_shard{shard_id}"), os.path.join(root, f"port_shard{shard_id}")
    jgenerate.cli_main(_gen_argv(data_dir, pickled, *extra, "--results-path", jres))
    tgenerate.cli_main(_gen_argv(data_dir, pickled, *extra, "--results-path", tres))
    got = _hyps(os.path.join(tres, "generate-test.txt"))
    _same_hyps(got, _hyps(os.path.join(jres, "generate-test.txt")))
    assert 0 < sum(k.startswith("H-") for k in got) < 8


def test_shards_together_give_the_unsharded_run(corpus):
    root, data_dir, pickled = corpus
    whole = os.path.join(root, "port_whole")
    tgenerate.cli_main(_gen_argv(data_dir, pickled, "--results-path", whole))
    parts = {}
    for shard_id in (0, 1):
        res = os.path.join(root, f"port_part{shard_id}")
        shutil.rmtree(res, ignore_errors=True)
        tgenerate.cli_main(_gen_argv(data_dir, pickled, "--num-shards", "2", "--shard-id", str(shard_id),
                                     "--results-path", res))
        part = _hyps(os.path.join(res, "generate-test.txt"))
        assert not set(part) & set(parts)
        parts.update(part)
    want = _hyps(os.path.join(whole, "generate-test.txt"))
    assert sorted(parts) == sorted(want) and sum(k.startswith("H-") for k in want) == 8
    for k, w in want.items():
        assert parts[k] == w, k

