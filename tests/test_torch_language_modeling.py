"""PyTorch port, language-model data and evaluation: ``TokenBlockDataset``
over its four break modes, ``MonolingualDataset``'s targets,
``LMContextWindowDataset``, the ``language_modeling`` task from files and
both ``cli/eval_lm``s on one JAX ``save_state`` checkpoint, against the
JAX package, on the CPU.

The corpus is written by the port's ``cli/preprocess`` (byte for byte
JAX's, tests/test_torch_preprocess.py) in a session-shared directory;
the checkpoint holds a tiny tied wiki103 LM's seeded weights."""

import argparse
import contextlib
import io
import os

import jax
import numpy as np
import pytest

from fbk_fairseq_st_tpu import registry
from fbk_fairseq_st_tpu.cli import eval_lm as jeval_lm
from fbk_fairseq_st_tpu.data import monolingual as jmono
from fbk_fairseq_st_tpu.data.dictionary import Dictionary as JaxDictionary
from fbk_fairseq_st_tpu.data.dictionary import TruncatedDictionary as JaxTruncatedDictionary
from fbk_fairseq_st_tpu.tasks.language_modeling import LanguageModelingTask as JaxLanguageModelingTask
from fbk_fairseq_st_tpu.train.checkpoint import save_state
from fbk_fairseq_st_tpu_torch.cli import eval_lm as teval_lm
from fbk_fairseq_st_tpu_torch.cli import preprocess as tpreprocess
from fbk_fairseq_st_tpu_torch.data import monolingual as tmono
from fbk_fairseq_st_tpu_torch.data.dictionary import Dictionary as TorchDictionary
from fbk_fairseq_st_tpu_torch.data.dictionary import TruncatedDictionary
from fbk_fairseq_st_tpu_torch.tasks import LanguageModelingTask

from .test_torch_model import SHARED_ROOT, random_variables, shared_root, torch_dictionary  # noqa: F401
from .torch_shared import shared
from .utils import dummy_dictionary, model_args

PAD, EOS = 1, 2
VOCAB = 40


def _stream(seed=0, n=12):
    """Sentences of 1-7 tokens ending in eos, some of them a lone eos (a
    document boundary for ``complete_doc``)."""
    rng = np.random.RandomState(seed)
    items = []
    for i in range(n):
        size = 0 if i in (4, 9) else rng.randint(1, 7)
        items.append(np.append(rng.randint(4, VOCAB, size=size), EOS).astype(np.int64))
    return items, np.array([len(x) for x in items])


def _same(a, b):
    if isinstance(b, (list, tuple)):
        assert isinstance(a, (list, tuple)) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("include_targets", [False, True])
@pytest.mark.parametrize("block", [1, 5, 8])
@pytest.mark.parametrize("mode", ["none", "complete", "complete_doc", "eos"])
def test_token_block_dataset_matches_jax(mode, block, include_targets):
    """Every item (and the shifted source / past-target streams) and the
    sizes equal JAX's."""
    items, sizes = _stream()
    kwargs = dict(pad=PAD, eos=EOS, break_mode=mode, include_targets=include_targets)
    want = jmono.TokenBlockDataset(items, sizes, block, **kwargs)
    got = tmono.TokenBlockDataset(items, sizes, block, **kwargs)
    assert len(got) == len(want) > 0
    np.testing.assert_array_equal(got.sizes, want.sizes)
    for i in range(len(want)):
        _same(got[i], want[i])


TARGETS = {"default": None, "future": ["future"], "self": ["self"], "past": ["past"],
           "all": ["self", "future", "past"]}


@pytest.mark.parametrize("truncated", [False, True])
@pytest.mark.parametrize("add_bos", [False, True])
@pytest.mark.parametrize("targets", sorted(TARGETS))
def test_monolingual_dataset_matches_jax(targets, add_bos, truncated):
    """Items and collated batches (padded to a fixed size too) equal JAX's
    for each target set, with and without --add-bos-token and a truncated
    output dictionary (ids past it become unk)."""
    items, sizes = _stream(1)
    jd, td = dummy_dictionary(VOCAB - 4), torch_dictionary(VOCAB - 4)
    jout, tout = (JaxTruncatedDictionary(jd, 20), TruncatedDictionary(td, 20)) if truncated else (jd, td)
    blocks = [mod.TokenBlockDataset(items, sizes, 6, pad=PAD, eos=EOS, break_mode="complete", include_targets=True)
              for mod in (jmono, tmono)]
    kwargs = dict(add_eos_for_other_targets=True, shuffle=False, targets=TARGETS[targets], add_bos_token=add_bos)
    want = jmono.MonolingualDataset(blocks[0], blocks[0].sizes, jd, jout, **kwargs)
    got = tmono.MonolingualDataset(blocks[1], blocks[1].sizes, td, tout, **kwargs)
    for i in range(len(want)):
        w, g = want[i], got[i]
        assert sorted(w) == sorted(g)
        _same(g["source"], w["source"])
        _same(g["target"], w["target"])
    np.testing.assert_array_equal(got.ordered_indices(), want.ordered_indices())
    for pad_kwargs in ({}, dict(pad_to_tgt_len=12, pad_to_bsz=8)):
        bw = want.collater([want[i] for i in (2, 0, 1)], **pad_kwargs)
        bg = got.collater([got[i] for i in (2, 0, 1)], **pad_kwargs)
        assert (bg["ntokens"], bg["nsentences"]) == (bw["ntokens"], bw["nsentences"])
        _same(bg["id"], bw["id"])
        _same(bg["target"], bw["target"])
        for key in ("src_tokens", "src_lengths"):
            _same(bg["net_input"][key], bw["net_input"][key])


def test_lm_context_window_dataset_matches_jax():
    """Batches collated in order (the carried context is state) equal JAX's:
    tokens, targets (pad at the context), lengths and start indices."""
    items, sizes = _stream(2, n=20)
    jd, td = dummy_dictionary(VOCAB - 4), torch_dictionary(VOCAB - 4)
    sets = []
    for mod, d in ((jmono, jd), (tmono, td)):
        block = mod.TokenBlockDataset(items, sizes, 4, pad=PAD, eos=EOS, break_mode="none", include_targets=True)
        mono = mod.MonolingualDataset(block, block.sizes, d, d, shuffle=False, targets=["future"])
        sets.append(mod.LMContextWindowDataset(mono, tokens_per_sample=4, context_window=6, pad_idx=PAD))
    want_ds, got_ds = sets
    for batch in ([0, 1, 2], [3], [4, 5], [6, 7, 8, 9]):
        bw = want_ds.collater([want_ds[i] for i in batch])
        bg = got_ds.collater([got_ds[i] for i in batch])
        for key in ("target", "start_indices"):
            _same(bg[key], bw[key])
        for key in ("src_tokens", "src_lengths"):
            _same(bg["net_input"][key], bw["net_input"][key])


def _write_lm_corpus(root):
    """raw text -> the port's cli/preprocess --only-source: train/valid/test
    and dict.txt in ``<root>/lm``."""
    rng = np.random.RandomState(0)
    raw = os.path.join(root, "raw")
    os.makedirs(raw)
    with open(os.path.join(raw, "dict.txt"), "w") as f:
        for i in range(4, VOCAB):
            f.write(f"w{i}{'@@' if i % 7 == 0 else ''} {VOCAB - i}\n")
    words = [f"w{i}{'@@' if i % 7 == 0 else ''}" for i in range(4, VOCAB)]
    for split, n in (("train", 24), ("valid", 8), ("test", 8)):
        with open(os.path.join(raw, f"lm.{split}"), "w") as f:
            for i in range(n):
                f.write("" if i == 3 else " ".join(rng.choice(words, size=rng.randint(3, 12))) + "\n")
                if i == 3:
                    f.write("\n")
    dest = os.path.join(root, "lm")
    tpreprocess.cli_main(["--only-source", "--trainpref", os.path.join(raw, "lm.train"), "--validpref",
                          os.path.join(raw, "lm.valid"), "--testpref", os.path.join(raw, "lm.test"), "--destdir", dest,
                          "--srcdict", os.path.join(raw, "dict.txt")])
    return dest


LM_ARGS = dict(decoder_layers=2, decoder_embed_dim=16, decoder_ffn_embed_dim=32, decoder_attention_heads=2,
               adaptive_input_cutoff="10,20", adaptive_softmax_cutoff="10,20")


def _make_corpus_and_checkpoint(root):
    data = _write_lm_corpus(root)
    d = JaxDictionary.load(os.path.join(data, "dict.txt"))
    args = model_args("transformer_lm_wiki103", task="language_modeling", data=data, tokens_per_sample=16,
                      max_target_positions=None, **LM_ARGS)
    registry.apply_architecture(args)
    model = registry.build_model(args, argparse.Namespace(target_dictionary=d, source_dictionary=d))
    variables = jax.tree_util.tree_map(np.asarray, random_variables(model, 5))
    ckpt = os.path.join(root, "checkpoint_jax.pt")
    save_state(ckpt, {"args": vars(args), "model": variables["params"], "model_state": variables["state"],
                      "extra_state": {"train_iterator": {"epoch": 1, "iterations_in_epoch": 0}, "val_loss": None}})
    return data, ckpt


def _corpus():
    return shared(SHARED_ROOT[0], "language_modeling", _make_corpus_and_checkpoint)


TASK_CASES = {
    "none": ["--sample-break-mode", "none"],
    "complete_bos": ["--sample-break-mode", "complete", "--add-bos-token"],
    "complete_doc_truncated_output": ["--sample-break-mode", "complete_doc", "--output-dictionary-size", "30"],
    "eos_truncate_sequence": ["--sample-break-mode", "eos", "--truncate-sequence", "--tokens-per-sample", "6"],
    "self_future_past": ["--sample-break-mode", "complete", "--self-target", "--future-target", "--past-target"],
}


@pytest.mark.parametrize("case", sorted(TASK_CASES))
def test_language_modeling_task_from_files_matches_jax(case):
    """The task set up from the same files and flags: dictionaries, every
    item of the train split, the max positions and the target set."""
    from fbk_fairseq_st_tpu import options as joptions
    from fbk_fairseq_st_tpu_torch import options as toptions

    data, _ = _corpus()
    argv = [data, "--task", "language_modeling", "--arch", "transformer_lm", "--tokens-per-sample", "16",
            *TASK_CASES[case]]
    jargs = joptions.parse_args_and_arch(joptions.get_training_parser(), argv)
    targs = toptions.parse_args_and_arch(toptions.get_training_parser(), argv)
    jtask = JaxLanguageModelingTask.setup_task(jargs)
    ttask = LanguageModelingTask.setup_task(targs)
    assert ttask.targets == jtask.targets
    assert len(ttask.target_dictionary) == len(jtask.target_dictionary)
    assert ttask.max_positions() == jtask.max_positions()
    jtask.load_dataset("train")
    ttask.load_dataset("train")
    jds, tds = jtask.dataset("train"), ttask.dataset("train")
    assert len(tds) == len(jds) > 0
    for i in range(len(jds)):
        _same(tds[i]["source"], jds[i]["source"])
        _same(tds[i]["target"], jds[i]["target"])
    np.testing.assert_array_equal(tds.sizes, jds.sizes)


def _run(cli_main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = cli_main(argv)
    lines = [line for line in out.getvalue().splitlines() if line and line.split(" ", 1)[0].isdigit()]
    return result, lines


def _word_probs(line):
    sid, rest = line.split(" ", 1)
    words = [w.rsplit(" [", 1) for w in rest.split("\t")]
    return int(sid), [w for w, _ in words], np.array([float(p.rstrip("]")) for _, p in words])


@pytest.mark.parametrize("context_window", [0, 8])
def test_eval_lm_clis_agree_on_a_jax_checkpoint(context_window):
    """JAX's and the port's ``cli/eval_lm`` (``--cpu``) on one JAX
    ``save_state`` checkpoint of a tiny tied wiki103 LM, with and without
    ``--context-window``: the same tokens scored, the loss (base 2) within
    1e-4, and the ``--output-word-probs`` lines row for row: the same ids
    and words (BPE pieces glued back), each word's log-probability within
    1e-4 (the lines print 6 decimals)."""
    data, ckpt = _corpus()
    argv = [data, "--path", ckpt, "--tokens-per-sample", "16", "--gen-subset", "valid", "--output-word-probs",
            "--max-sentences", "4", "--context-window", str(context_window)]
    (jloss, jtokens), jlines = _run(jeval_lm.cli_main, argv)
    (tloss, ttokens), tlines = _run(teval_lm.cli_main, argv + ["--cpu"])
    assert ttokens == jtokens > 0
    assert abs(tloss - jloss) <= 1e-4
    assert len(tlines) == len(jlines) > 0
    for tl, jl in zip(tlines, jlines):
        tid, twords, tprobs = _word_probs(tl)
        jid, jwords, jprobs = _word_probs(jl)
        assert (tid, twords) == (jid, jwords)
        np.testing.assert_allclose(tprobs, jprobs, rtol=0, atol=1e-4)
    assert any(len(w) > 3 and not w.endswith("@@") for line in tlines for w in _word_probs(line)[1])


def test_eval_lm_parser_defaults_match_jax():
    """The eval_lm parser's flags and defaults: --max-tokens 36,000 when
    neither batch limit is given (set in main), --context-window 0,
    --softmax-batch a parity flag."""
    from fbk_fairseq_st_tpu import options as joptions
    from fbk_fairseq_st_tpu_torch import options as toptions

    data, ckpt = _corpus()
    argv = [data, "--path", ckpt]
    jargs = joptions.parse_args_and_arch(joptions.get_eval_lm_parser(), argv)
    targs = toptions.parse_args_and_arch(toptions.get_eval_lm_parser(), argv)
    for dest in ("context_window", "softmax_batch", "output_word_probs", "output_word_stats", "task",
                 "tokens_per_sample", "sample_break_mode", "gen_subset", "max_tokens"):
        assert getattr(targs, dest) == getattr(jargs, dest), dest
    assert targs.task == "language_modeling"
    assert isinstance(TorchDictionary.load(os.path.join(data, "dict.txt")), TorchDictionary)
