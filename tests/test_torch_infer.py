"""PyTorch port, ``cli/infer``: the ASR inference CLI against JAX's on a
corpus and checkpoints that the JAX package writes.

JAX's ``preprocess_audio`` and ``preprocess`` CLIs write a tiny corpus of
filterbanks and character transcripts whose words end in the boundary
unit "|"; the test writes a wav2letter lexicon of its words and a 2-gram
``.arpa`` over them. JAX's ``train/checkpoint.py::save_state`` writes three
checkpoints of seeded weights: a tiny ``vggtransformer_base``
(``cross_entropy_acc``), a ``vggtransformer_enc_1`` (``ctc_loss``) and a
``w2l_conv_glu_enc`` with its ASG transitions (``asg_loss``). JAX's
``cli/infer`` and the port's (``--cpu``) decode the test split through the
five routes: seq2seq beam, greedy CTC, the lexicon beam with the ARPA LM
(``--w2l-decoder kenlm``), ASG Viterbi (``--w2l-decoder viterbi``) and
the ASG beam with the lexicon. The four sclite files must be byte-equal
and the WER and UER equal. Then the port trains the w2l model with
``asg_loss`` through its own ``cli/train`` and decodes the checkpoint."""

import os

import jax
import numpy as np
import pytest
import torch

from fbk_fairseq_st_tpu import registry
from fbk_fairseq_st_tpu.cli import infer as jinfer
from fbk_fairseq_st_tpu.cli import preprocess as jpreprocess
from fbk_fairseq_st_tpu.cli import preprocess_audio as jpreprocess_audio
from fbk_fairseq_st_tpu.data import Dictionary as JaxDictionary
from fbk_fairseq_st_tpu.train.checkpoint import save_state
from fbk_fairseq_st_tpu_torch.cli import infer as tinfer
from fbk_fairseq_st_tpu_torch.cli import train as ttrain

from .torch_shared import session_root, shared
from .utils import DummyTask, model_args

FEAT = 8
WORDS = ("ab", "bad", "cab", "dc", "add")
VGG = dict(input_feat_per_channel=FEAT, vggblock_enc_config="[(4, 3, 2, 1, True)]",
           transformer_enc_config="((16, 2, 32, True, 0.1, 0.1, 0.1),) * 2", enc_output_dim=16, tgt_embed_dim=8,
           transformer_dec_config="((16, 2, 32, True, 0.1, 0.1, 0.1),)", conv_dec_config="((12, 3, True),)")
VGG_ENC = {k: VGG[k] for k in ("input_feat_per_channel", "vggblock_enc_config", "transformer_enc_config",
                               "enc_output_dim")}
W2L = dict(input_feat_per_channel=FEAT, conv_enc_config="[(12, 3, 1, 0.1), (10, 5, 2, 0.1)]")
MODELS = {
    "seq2seq": ("vggtransformer_base", "cross_entropy_acc", VGG),
    "ctc": ("vggtransformer_enc_1", "ctc_loss", VGG_ENC),
    "asg": ("w2l_conv_glu_enc", "asg_loss", W2L),
}
ROUTES = {
    "seq2seq": ("seq2seq", ["--beam", "3", "--max-len-b", "6"]),
    "greedy": ("ctc", ["--ctc-decoding", "greedy"]),
    "lexicon_arpa": ("ctc", ["--w2l-decoder", "kenlm", "--lexicon", "{lexicon}", "--kenlm-model", "{arpa}",
                             "--ctc-beam-size", "8", "--lm-weight", "1.0", "--word-score", "-0.5"]),
    "viterbi": ("asg", ["--w2l-decoder", "viterbi"]),
    "asg_beam": ("asg", ["--ctc-decoding", "beam", "--lexicon", "{lexicon}", "--kenlm-model", "{arpa}",
                         "--ctc-beam-size", "8"]),
}
PREFIXES = ("hypo.word", "hypo.units", "ref.word", "ref.units")


def _write_corpus(data_dir, rng):
    os.makedirs(data_dir, exist_ok=True)
    for split, n in (("train", 8), ("valid", 4), ("test", 5)):
        raw = os.path.join(data_dir, f"{split}_raw.npz")
        feats = [rng.randn(rng.randint(14, 30), FEAT).astype(np.float32) for _ in range(n)]
        with open(raw, "wb") as f:
            np.save(f, np.array([n]))
            for feat in feats:
                np.save(f, feat)
        jpreprocess_audio.cli_main(["--audio-features", raw, "--format", "npz",
                                    "--output", os.path.join(data_dir, f"{split}.npz")])
        with open(os.path.join(data_dir, f"{split}_raw.de"), "w") as f:
            for _ in range(n):
                words = rng.choice(WORDS, size=rng.randint(1, 4))
                f.write(" ".join(" ".join(w) + " |" for w in words) + "\n")
    prefix = os.path.join(data_dir, "{}_raw")
    jpreprocess.cli_main(["--target-lang", "de", "--trainpref", prefix.format("train"),
                          "--validpref", prefix.format("valid"), "--testpref", prefix.format("test"),
                          "--destdir", data_dir, "--dataset-impl", "cached", "--padding-factor", "1"])
    with open(os.path.join(data_dir, "lexicon.txt"), "w") as f:
        f.writelines(f"{w}\t{' '.join(w)}\n" for w in WORDS)
    with open(os.path.join(data_dir, "lm.arpa"), "w") as f:
        f.write("\\data\\\nngram 1=7\nngram 2=3\n\n\\1-grams:\n-1.0\t<s>\t-0.3\n-1.1\t</s>\n")
        f.writelines(f"{-0.5 - 0.1 * i:.2f}\t{w}\t-0.2\n" for i, w in enumerate(WORDS))
        f.write("\n\\2-grams:\n-0.2\t<s> ab\n-0.3\tab cab\n-0.4\tdc </s>\n\n\\end\\\n")


def _checkpoint(root, data_dir, name, seed):
    arch, criterion, over = MODELS[name]
    d = JaxDictionary.load(os.path.join(data_dir, "dict.de.txt"))
    if criterion == "ctc_loss":
        d.add_symbol("<ctc_blank>")
    elif criterion == "asg_loss":
        for i in (1, 2):
            d.add_symbol(str(i))
    args = model_args(arch, task="speech_recognition", target_lang="de", data=data_dir, **over)
    args.criterion = criterion
    if criterion == "asg_loss":
        args.asg_transitions_init, args.max_replabel = 0.5, 2
    registry.apply_architecture(args)
    model = registry.build_model(args, DummyTask(d))
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(seed))
    rng = np.random.RandomState(seed)
    variables = jax.tree_util.tree_map(lambda a: (0.5 * rng.randn(*a.shape)).astype(a.dtype), shapes)
    path = os.path.join(root, f"checkpoint_{name}.pt")
    save_state(path, {"args": vars(args), "model": variables["params"], "model_state": variables["state"],
                      "extra_state": {"train_iterator": {"epoch": 1, "iterations_in_epoch": 0}, "val_loss": None}})
    return path


def _corpus(root):
    data_dir = os.path.join(root, "data")
    _write_corpus(data_dir, np.random.RandomState(0))
    paths = {name: _checkpoint(root, data_dir, name, seed) for seed, name in enumerate(MODELS)}
    return root, data_dir, paths


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The corpus and the three checkpoints, once for the session
    (``torch_shared``); each test writes its results under names of its
    own beside them."""
    return shared(session_root(tmp_path_factory), "infer", _corpus)


def _argv(data_dir, path, results, route, extra):
    _, criterion, _ = MODELS[ROUTES[route][0]]
    argv = [data_dir, "--task", "speech_recognition", "-t", "de", "--criterion", criterion, "--path", path,
            "--gen-subset", "test", "--results-path", results, "--max-sentences", "3"]
    if criterion == "asg_loss":
        argv += ["--max-replabel", "2"]
    return argv + [a.format(lexicon=os.path.join(data_dir, "lexicon.txt"), arpa=os.path.join(data_dir, "lm.arpa"))
                   for a in extra]


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_infer_writes_jax_files(corpus, route):
    """The four sclite files byte for byte JAX's and the WER / UER equal,
    for each decode route, and the CTC lexicon beam's hypotheses only
    lexicon words. (A Viterbi path that starts on a replabel unpacks to
    id -1, which both print as the dictionary's last symbol: ROADMAP
    Queue C, JAX side.)"""
    root, data_dir, paths = corpus
    model, extra = ROUTES[route]
    jres, tres = os.path.join(root, f"jax_{route}"), os.path.join(root, f"port_{route}")
    want = jinfer.cli_main(_argv(data_dir, paths[model], jres, route, extra))
    got = tinfer.cli_main(_argv(data_dir, paths[model], tres, route, extra) + ["--cpu"])
    assert got == want and got[0] is not None
    name = os.path.basename(paths[model])
    for prefix in PREFIXES:
        fname = f"{prefix}-{name}-test.txt"
        with open(os.path.join(jres, fname), "rb") as fj, open(os.path.join(tres, fname), "rb") as ft:
            assert ft.read() == fj.read(), fname
    with open(os.path.join(tres, f"hypo.word-{name}-test.txt"), encoding="utf-8") as f:
        lines = f.read().splitlines()
    assert len(lines) == 5
    words = [w for line in lines for w in line.rsplit("(", 1)[0].split()]
    if route == "lexicon_arpa":  # the CTC lexicon beam keeps the hypotheses that end a word
        assert set(words) <= set(WORDS)


def test_infer_refuses_what_jax_refuses(corpus):
    """``--w2l-decoder kenlm`` needs ``--lexicon`` and ``--kenlm-model``;
    greedy CTC needs a blank or ASG transitions; weight quantisation stays
    unported; without ``--cpu`` and without a card it raises."""
    root, data_dir, paths = corpus
    res = os.path.join(root, "refused")
    with pytest.raises(ValueError, match="requires --lexicon"):
        tinfer.cli_main(_argv(data_dir, paths["ctc"], res, "greedy", ["--w2l-decoder", "kenlm", "--cpu"]))
    with pytest.raises(ValueError, match="requires --kenlm-model"):
        tinfer.cli_main(_argv(data_dir, paths["ctc"], res, "greedy",
                              ["--w2l-decoder", "kenlm", "--lexicon", "{lexicon}", "--cpu"]))
    with pytest.raises(ValueError, match="<ctc_blank>"):
        tinfer.cli_main(_argv(data_dir, paths["seq2seq"], res, "seq2seq", ["--ctc-decoding", "greedy", "--cpu"]))
    with pytest.raises(NotImplementedError, match="quantisation"):
        tinfer.cli_main(_argv(data_dir, paths["ctc"], res, "greedy", ["--quantize-weights", "int8", "--cpu"]))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tinfer.cli_main(_argv(data_dir, paths["ctc"], res, "greedy", ["--ctc-decoding", "greedy"]))


def test_port_trains_asg_and_decodes_from_files(corpus):
    """The port's ``cli/train`` trains the w2l model with ``asg_loss``
    (LinSeg for the first update) from the corpus for 2 updates and writes
    the transitions into its checkpoint; its ``cli/infer`` decodes the
    checkpoint through ASG Viterbi and the ASG beam."""
    root, data_dir, _ = corpus
    save_dir = os.path.join(root, "port_ckpt")
    ttrain.cli_main([data_dir, "--task", "speech_recognition", "-t", "de", "--arch", "w2l_conv_glu_enc",
                     "--criterion", "asg_loss", "--max-replabel", "2", "--linseg-updates", "1",
                     "--hide-linseg-messages", "--optimizer", "adam", "--lr", "0.01", "--max-update", "2",
                     "--max-sentences", "4", "--save-dir", save_dir, "--log-format", "none", "--cpu",
                     "--no-epoch-checkpoints", *[f"--{k.replace('_', '-')}={v}" for k, v in W2L.items()]])
    path = os.path.join(save_dir, "checkpoint_last.pt")
    state = torch.load(path, map_location="cpu", weights_only=False)
    assert "asg_transitions" in state["model"]
    for route in ("viterbi", "asg_beam"):
        res = os.path.join(root, f"port_trained_{route}")
        wer, uer = tinfer.cli_main(_argv(data_dir, path, res, route, ROUTES[route][1]) + ["--cpu"])
        assert wer is not None and uer is not None
