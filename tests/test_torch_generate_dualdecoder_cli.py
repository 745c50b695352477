"""PyTorch port, ``cli/generate_dualdecoder``: the translation and the
transcript it descends from, against JAX's CLI.

The JAX package writes tests/test_torch_train_cli.py's tiny corpus (train,
valid and test splits of filterbanks, ``de`` targets and ``en``
transcripts) with its own CLIs, and JAX's ``cli/train`` trains a tiny
``conv_transformer_dualdecoder`` on it with ``cross_entropy_dualdecoder``
(``speech_translation_dualdecoding``) and writes ``checkpoint_last.pt``.
JAX's ``cli/generate_dualdecoder`` and the port's (``--cpu``) decode the
test split from it with beam 3. Tolerances: the T-, H-, D-, AUX- and
AUXD- texts identical, the scores and P- values within 1e-4 (base 2)."""

import os

import numpy as np
import pytest
import torch

from fbk_fairseq_st_tpu.cli import generate_dualdecoder as jgenerate
from fbk_fairseq_st_tpu.cli import train as jtrain
from fbk_fairseq_st_tpu_torch.cli import generate_dualdecoder as tgenerate

from .test_torch_train_cli import N_MELS, write_corpus
from .torch_shared import session_root, shared

SCORE_ATOL = 1e-4
KINDS = ("T", "H", "D", "P", "AUX", "AUXD")
MODEL = ["--arch", "conv_transformer_dualdecoder", "--encoder-layers", "2", "--decoder-layers", "1",
         "--encoder-embed-dim", "16", "--decoder-embed-dim", "16", "--encoder-ffn-embed-dim", "32",
         "--decoder-ffn-embed-dim", "32", "--encoder-attention-heads", "2", "--decoder-attention-heads", "2",
         "--encoder-convolutions", "[(4, 3, 3)] * 2", "--input-feat-per-channel", str(N_MELS),
         "--max-source-positions", "64", "--max-target-positions", "32"]


def _train(root):
    data_dir, save_dir = os.path.join(root, "data"), os.path.join(root, "ckpt")
    write_corpus(data_dir, np.random.RandomState(2))
    jtrain.cli_main([data_dir, "--task", "speech_translation_dualdecoding", "-s", "en", "-t", "de", *MODEL,
                     "--criterion", "cross_entropy_dualdecoder", "--label-smoothing", "0.1",
                     "--auxiliary-loss-weight", "0.5", "--optimizer", "adam", "--lr", "0.005",
                     "--max-sentences", "4", "--max-update", "4", "--disable-validation", "--log-format", "none",
                     "--save-dir", save_dir, "--seed", "3"])
    return root, data_dir, os.path.join(save_dir, "checkpoint_last.pt")


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The corpus and the checkpoint JAX's ``cli/train`` writes (4 updates),
    once for the session (``torch_shared``); each test writes its results
    under a name of its own beside them."""
    return shared(session_root(tmp_path_factory), "generate_dualdecoder", _train)


def _argv(data_dir, path, results, *extra):
    return [data_dir, "-s", "en", "-t", "de", "--path", path, "--beam", "3", "--max-len-b", "8", "--gen-subset", "test",
            "--max-sentences", "4", "--results-path", results, *extra]


def _records(results):
    """{kind: {id: fields}} of the record lines, and their order."""
    records, order = {}, []
    with open(os.path.join(results, "generate-test.txt"), encoding="utf-8") as f:
        for line in f:
            head = line.split("\t")[0]
            kind = head.split("-")[0]
            if "-" not in head or kind not in KINDS:
                continue
            records.setdefault(kind, {})[int(head.split("-", 1)[1])] = line.rstrip("\n").split("\t")[1:]
            order.append(head)
    return records, order


def test_generate_dualdecoder_matches_jax(trained):
    """The same records in the same order, one AUX- and one AUXD- line a
    hypothesis carrying its transcript under the translation's score (as
    JAX prints them); the BLEU statistics equal; ``--results-path`` holds
    them in ``generate-test.txt``."""
    root, data_dir, path = trained
    jscorer = jgenerate.cli_main(_argv(data_dir, path, os.path.join(root, "jax")))
    scorer = tgenerate.cli_main(_argv(data_dir, path, os.path.join(root, "port"), "--cpu"))
    want, want_order = _records(os.path.join(root, "jax"))
    got, got_order = _records(os.path.join(root, "port"))
    assert got_order == want_order
    assert set(got) == set(KINDS) and len(got["H"]) == len(got["AUX"]) == len(got["AUXD"]) == 6
    assert got["T"] == want["T"]
    for kind in ("H", "D", "AUX", "AUXD"):
        for sid, (score, text) in want[kind].items():
            assert got[kind][sid][1] == text, (kind, sid)
            assert abs(float(got[kind][sid][0]) - float(score)) <= SCORE_ATOL, (kind, sid)
    for sid in got["H"]:
        assert got["AUX"][sid][0] == got["H"][sid][0] == got["AUXD"][sid][0]
    for sid, (scores,) in want["P"].items():
        assert len(got["P"][sid][0].split()) == len(scores.split())
        for a, b in zip(got["P"][sid][0].split(), scores.split()):
            assert abs(float(a) - float(b)) <= SCORE_ATOL, (sid, a, b)
    for field in type(scorer.stat).__slots__:
        assert getattr(scorer.stat, field) == getattr(jscorer.stat, field), field


def test_generate_dualdecoder_prints_to_stdout_without_results_path(trained, capsys):
    """Without ``--results-path`` the records go to the standard output,
    with ``--quiet`` none but the closing lines."""
    _, data_dir, path = trained
    argv = [a for a in _argv(data_dir, path, "unused", "--cpu") if a not in ("--results-path", "unused")]
    tgenerate.cli_main(argv)
    out = capsys.readouterr().out
    assert sum(line.startswith("AUXD-") for line in out.splitlines()) == 6
    tgenerate.cli_main(argv + ["--quiet"])
    out = capsys.readouterr().out
    assert not any(line.startswith(("H-", "AUX-")) for line in out.splitlines())
    assert "Generate test with beam=3" in out


def test_generate_dualdecoder_needs_the_card_without_cpu(trained, monkeypatch):
    """Without ``--cpu`` it asks for the CUDA card and raises where there is
    none; it never carries on on the CPU."""
    _, data_dir, path = trained
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [a for a in _argv(data_dir, path, "unused") if a not in ("--results-path", "unused")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tgenerate.cli_main(argv)
