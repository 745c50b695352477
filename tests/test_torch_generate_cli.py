"""PyTorch port, serving from files: the port's ``cli/generate`` against
JAX's on a corpus and a checkpoint that the JAX package writes.

The JAX package writes a tiny speech-translation corpus with its own
``preprocess_audio`` and ``preprocess`` CLIs (filterbanks, target and
transcript text) and a tiny ``conv_transformer``'s seeded weights as its
pickled checkpoint (``train/checkpoint.py::save_state``, with an optax
Adam state beside the weights, as a training run saves it), exported to a
fork-layout ``.pt`` by ``cli/export_fairseq_checkpoint``. JAX's
``cli/generate`` decodes the split from the pickle; the port's, with
``--cpu``, from each of the two files. Tolerances: the hypotheses' tokens
identical, the printed scores within 1e-4 (base 2), and the BLEU
statistics and line identical."""

import os
import subprocess
import sys

import jax
import numpy as np
import optax
import pytest
import torch

from fbk_fairseq_st_tpu import registry
from fbk_fairseq_st_tpu.cli import export_fairseq_checkpoint as jexport
from fbk_fairseq_st_tpu.cli import generate as jgenerate
from fbk_fairseq_st_tpu.cli import preprocess as jpreprocess
from fbk_fairseq_st_tpu.cli import preprocess_audio as jpreprocess_audio
from fbk_fairseq_st_tpu.data import Dictionary as JaxDictionary
from fbk_fairseq_st_tpu.train.checkpoint import save_state
from fbk_fairseq_st_tpu_torch.cli import generate as tgenerate
from fbk_fairseq_st_tpu_torch.train import checkpoint as tcheckpoint

from .torch_shared import session_root, shared
from .utils import DummyTask, model_args

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_MELS = 8
SMALL = dict(
    encoder_layers=1, decoder_layers=1, encoder_embed_dim=16, decoder_embed_dim=16, encoder_ffn_embed_dim=32,
    decoder_ffn_embed_dim=32, encoder_attention_heads=2, decoder_attention_heads=2,
    encoder_convolutions="[(4, 3, 3)] * 2", input_feat_per_channel=N_MELS, max_source_positions=64,
    max_target_positions=32,
)
SCORE_ATOL = 1e-4


def _write_corpus(data_dir, rng, n=6):
    os.makedirs(data_dir, exist_ok=True)
    raw = os.path.join(data_dir, "test_raw.npz")
    feats = [rng.randn(rng.randint(20, 40), N_MELS).astype(np.float32) for _ in range(n)]
    with open(raw, "wb") as f:
        np.save(f, np.array([len(feats)]))
        for feat in feats:
            np.save(f, feat)
    jpreprocess_audio.cli_main(["--audio-features", raw, "--format", "npz",
                                "--output", os.path.join(data_dir, "test.npz")])
    for lang, vocab in (("de", 12), ("en", 9)):
        with open(os.path.join(data_dir, f"test_raw.{lang}"), "w") as f:
            for _ in range(n):
                f.write(" ".join(f"{lang}{rng.randint(vocab)}" for _ in range(rng.randint(2, 6))) + "\n")
        prefix = os.path.join(data_dir, "test_raw")
        jpreprocess.cli_main(["--target-lang", lang, "--trainpref", prefix, "--testpref", prefix,
                              "--destdir", data_dir, "--dataset-impl", "cached"])


def _corpus(root):
    data_dir = os.path.join(root, "data")
    _write_corpus(data_dir, np.random.RandomState(0))
    tgt_dict = JaxDictionary.load(os.path.join(data_dir, "dict.de.txt"))
    args = model_args("conv_transformer", task="speech_translation_with_transcription", **SMALL)
    registry.apply_architecture(args)
    model = registry.build_model(args, DummyTask(tgt_dict))
    variables = jax.tree_util.tree_map(np.asarray, jax.jit(model.init)(jax.random.PRNGKey(3)))
    pickled = os.path.join(root, "checkpoint_jax.pt")
    save_state(pickled, {
        "args": vars(args), "model": variables["params"], "model_state": variables["state"],
        "opt_state": jax.tree_util.tree_map(np.asarray, optax.adam(1e-3).init(variables["params"])),
        "extra_state": {"train_iterator": {"epoch": 1, "iterations_in_epoch": 0}, "val_loss": None},
    })
    fork = os.path.join(root, "checkpoint_fork.pt")
    jexport.cli_main([pickled, fork])
    return root, data_dir, pickled, fork


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The corpus and the checkpoints, once for the session
    (``torch_shared``); a test writes its results under a name of its own
    beside them, a module fixture in its worker's own temp directory."""
    return shared(session_root(tmp_path_factory), "generate_cli", _corpus)


def _argv(data_dir, path, results, *extra):
    return [data_dir, "--task", "speech_translation_with_transcription", "-s", "en", "-t", "de", "--path", path,
            "--beam", "3", "--max-len-b", "8", "--gen-subset", "test", "--max-sentences", "4", "--cpu",
            "--results-path", results, *extra]


def _records(results):
    """{kind: {id: fields}} of the S/T/H/D/P lines, and their order."""
    records, order = {}, []
    with open(os.path.join(results, "generate-test.txt"), encoding="utf-8") as f:
        for line in f:
            head = line.split("\t")[0]
            if "-" not in head or head.split("-")[0] not in ("S", "T", "H", "D", "P"):
                continue
            kind, sid = head.split("-", 1)
            records.setdefault(kind, {})[int(sid)] = line.rstrip("\n").split("\t")[1:]
            order.append(head)
    return records, order


@pytest.fixture(scope="module")
def jax_run(corpus, tmp_path_factory):
    _, data_dir, pickled, _ = corpus
    results = str(tmp_path_factory.mktemp("jax_results"))
    scorer = jgenerate.cli_main(_argv(data_dir, pickled, results))
    return scorer, _records(results)


@pytest.mark.parametrize("checkpoint", ["jax_pickle", "fork_pt"])
def test_generate_matches_jax(corpus, jax_run, checkpoint):
    """The same records in the same order: T- lines equal, H-/D- lines with
    the same tokens and scores within 1e-4 (base 2), P- lines within 1e-4
    per token; the same BLEU statistics and line."""
    root, data_dir, pickled, fork = corpus
    results = os.path.join(root, f"port_results_{checkpoint}")
    scorer = tgenerate.cli_main(_argv(data_dir, pickled if checkpoint == "jax_pickle" else fork, results))
    jscorer, (want, want_order) = jax_run
    got, got_order = _records(results)
    assert got_order == want_order
    assert set(got) == {"T", "H", "D", "P"} and len(got["H"]) == 6
    assert got["T"] == want["T"]
    for kind in ("H", "D"):
        for sid, (score, text) in want[kind].items():
            assert got[kind][sid][1] == text, (kind, sid)
            assert abs(float(got[kind][sid][0]) - float(score)) <= SCORE_ATOL
    for sid, (scores,) in want["P"].items():
        np.testing.assert_allclose(np.array(got["P"][sid][0].split(), float), np.array(scores.split(), float),
                                   rtol=0, atol=SCORE_ATOL)
    for field in type(scorer.stat).__slots__:
        assert getattr(scorer.stat, field) == getattr(jscorer.stat, field), field
    assert scorer.result_string() == jscorer.result_string()


def test_fork_pt_and_pickle_hold_the_same_weights(corpus):
    """Both formats read to the same state dict (exactly), which loads
    strictly into the port's model."""
    _, _, pickled, fork = corpus
    a, b = tcheckpoint.load_checkpoint_to_cpu(pickled), tcheckpoint.load_checkpoint_to_cpu(fork)
    assert sorted(a["model"]) == sorted(b["model"])
    for name, value in a["model"].items():
        assert torch.equal(value, b["model"][name]), name
    assert a["args"].arch == b["args"].arch == "conv_transformer"


def test_jax_checkpoint_reader_imports_no_jax(corpus):
    """Unpickling the JAX checkpoint (optax classes in its opt_state)
    imports neither jax nor optax: checked in a fresh interpreter."""
    _, _, pickled, _ = corpus
    code = ("import sys; from fbk_fairseq_st_tpu_torch.train.checkpoint import load_checkpoint_to_cpu; "
            f"s = load_checkpoint_to_cpu({pickled!r}); "
            "bad = [m for m in ('jax', 'jaxlib', 'optax', 'flax', 'fbk_fairseq_st_tpu') if m in sys.modules]; "
            "assert not bad, bad; assert type(s['opt_state'][0]).__module__.startswith('stub.'); "
            "print(len(s['model']))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) > 10


def test_generate_needs_the_card_without_cpu(corpus, monkeypatch):
    """Without --cpu and without a card the CLI raises before decoding."""
    root, data_dir, pickled, _ = corpus
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [a for a in _argv(data_dir, pickled, os.path.join(root, "no_card")) if a != "--cpu"]
    with pytest.raises(RuntimeError):
        tgenerate.cli_main(argv)


def test_unported_generation_options_raise(corpus):
    """A codec whose library is missing raises ``ImportError`` naming it
    (the alignments, ``--sacrebleu`` and ``--num-shards`` are ported:
    tests/test_torch_alignment.py and tests/test_torch_checkpoint_options.py;
    weight quantisation too: ``--quantize-weights int8`` decodes here, and
    tests/test_torch_quantization.py holds it against JAX)."""
    root, data_dir, pickled, _ = corpus
    scorer = tgenerate.cli_main(_argv(data_dir, pickled, os.path.join(root, "int8"), "--quantize-weights", "int8"))
    assert scorer.stat.predlen > 0
    with pytest.raises(ImportError, match="subword_nmt"):
        tgenerate.cli_main(_argv(data_dir, pickled, os.path.join(root, "unported"), "--bpe", "subword_nmt",
                                 "--bpe-codes", "codes"))



@pytest.mark.parametrize("arch", ["conv_transformer", "conv_transformer_big", "dynamicconv_iwslt_de_en",
                                  "conv_transformer_dualdecoder"])
def test_apply_architecture_matches_jax(arch):
    """The port's ``registry.apply_architecture`` fills each option the
    port reads with the value JAX's preset gives it (where JAX sets one),
    and keeps an option already on the namespace."""
    from fbk_fairseq_st_tpu_torch import registry as tregistry

    jargs, targs = model_args(arch, encoder_layers=3), model_args(arch, encoder_layers=3)
    registry.apply_architecture(jargs)
    tregistry.apply_architecture(targs)
    assert targs.encoder_layers == 3
    shared = [k for k in vars(targs) if hasattr(jargs, k)]
    assert len(shared) > 15
    for k in shared:
        assert getattr(targs, k) == getattr(jargs, k), k


def test_jax_optimizer_state_reads_whole(tmp_path):
    """A JAX pickle's optax Adam state after two updates reads back with
    its count, mu and nu equal to the saved arrays (the stub keeps the
    NamedTuple's fields), still without importing jax or optax: checked in
    a fresh interpreter against the arrays saved beside it."""
    rng = np.random.RandomState(2)
    params = {"layer": {"w": rng.randn(3, 4).astype(np.float32), "b": rng.randn(4).astype(np.float32)}}
    tx = optax.adam(1e-3)
    state = tx.init(params)
    for _ in range(2):
        grads = jax.tree_util.tree_map(lambda p: rng.randn(*p.shape).astype(np.float32), params)
        _, state = tx.update(grads, state, params)
    state = jax.tree_util.tree_map(np.asarray, state)
    path = str(tmp_path / "ckpt.pt")
    save_state(path, {"args": {"arch": "conv_transformer"}, "model": params, "opt_state": state})
    adam = state[0]
    np.savez(str(tmp_path / "want.npz"), count=adam.count, mu_w=adam.mu["layer"]["w"], mu_b=adam.mu["layer"]["b"],
             nu_w=adam.nu["layer"]["w"], nu_b=adam.nu["layer"]["b"])
    code = ("import sys, numpy as np; from fbk_fairseq_st_tpu_torch.train.checkpoint import load_checkpoint_to_cpu; "
            f"s = load_checkpoint_to_cpu({path!r}); w = np.load({str(tmp_path / 'want.npz')!r}); "
            "adam = s['opt_state'][0]; assert type(adam).__name__ == 'ScaleByAdamState', type(adam); "
            "count, mu, nu = adam.args; assert int(count) == int(w['count']) == 2; "
            "ok = all(np.array_equal(t['layer'][k], w[n + '_' + k]) for n, t in (('mu', mu), ('nu', nu)) "
            "for k in ('w', 'b')); assert ok; "
            "bad = [m for m in ('jax', 'jaxlib', 'optax', 'flax', 'fbk_fairseq_st_tpu') if m in sys.modules]; "
            "assert not bad, bad; print('read')")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[-1] == "read"
