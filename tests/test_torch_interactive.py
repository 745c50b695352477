"""PyTorch port, ``cli/interactive``: the port's CLI against JAX's on a tiny
``dynamicconv_iwslt_de_en`` (2 + 2 layers, width 16, dynamic convolutions
with kernels [3, 5]) that JAX's ``cli/train`` wrote, over the translation
corpus of ``tests/test_translation.py``.

Both CLIs decode the same input lines (an unknown word among them) with
beam 3, ``--nbest 2`` and ``--buffer-size 2`` on the CPU. Tolerances: the
same S-/H-/D-/P- records in the same order with the same tokens, the H-/D-
scores within 1e-5 (the same fp32 decode, summed in another order) and the
P- values (printed at 4 decimals) within 1e-4."""

import io
import os
import pathlib
import sys

import numpy as np
import pytest
import torch

from fbk_fairseq_st_tpu.cli import interactive as jinteractive
from fbk_fairseq_st_tpu.cli import train as jtrain
from fbk_fairseq_st_tpu_torch.cli import interactive as tinteractive

from .test_translation import create_translation_data
from .torch_shared import session_root, shared

SCORE_ATOL = 1e-5
ARCH = ["--arch", "dynamicconv_iwslt_de_en", "--encoder-conv-type", "dynamic", "--decoder-conv-type", "dynamic",
        "--encoder-layers", "2", "--decoder-layers", "2", "--encoder-embed-dim", "16", "--decoder-embed-dim", "16",
        "--encoder-ffn-embed-dim", "32", "--decoder-ffn-embed-dim", "32", "--encoder-attention-heads", "2",
        "--decoder-attention-heads", "2", "--encoder-conv-dim", "16", "--decoder-conv-dim", "16",
        "--encoder-kernel-size-list", "[3, 5]", "--decoder-kernel-size-list", "[3, 5]",
        "--max-source-positions", "64", "--max-target-positions", "64"]


def _train(root):
    root = pathlib.Path(root)
    data_dir, save_dir = str(root / "data"), str(root / "ckpt")
    create_translation_data(data_dir, n=12)
    jtrain.cli_main([data_dir, "--save-dir", save_dir, "--task", "translation", "-s", "en", "-t", "de", *ARCH,
                     "--criterion", "label_smoothed_cross_entropy", "--label-smoothing", "0.1", "--optimizer", "adam",
                     "--lr", "0.001", "--lr-scheduler", "inverse_sqrt", "--warmup-updates", "4", "--max-tokens", "200",
                     "--max-epoch", "1", "--log-format", "none", "--no-epoch-checkpoints", "--disable-validation"])
    lines = open(os.path.join(data_dir, "raw", "test.en")).read().splitlines() + ["e1 e2 zz9 e3"]
    (root / "input.txt").write_text("\n".join(lines) + "\n")
    return data_dir, os.path.join(save_dir, "checkpoint_last.pt"), str(root / "input.txt"), len(lines)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """One epoch of JAX's ``cli/train`` on 12 pairs, its checkpoint_last.pt,
    and an input file of the test sources plus a line with an unknown
    word, once for the session (``torch_shared``)."""
    return shared(session_root(tmp_path_factory), "interactive", _train)


def _argv(trained, *extra):
    data_dir, path, input_path, _ = trained
    return [data_dir, "--task", "translation", "-s", "en", "-t", "de", "--path", path, "--beam", "3", "--nbest", "2",
            "--max-len-b", "8", "--buffer-size", "2", "--input", input_path, "--cpu", *extra]


def _records(out):
    return [line.split("\t") for line in out.splitlines() if line[:2] in ("S-", "H-", "D-", "P-")]


@pytest.fixture(scope="module")
def jax_records(trained):
    capture = io.StringIO()
    stdout, sys.stdout = sys.stdout, capture
    try:
        jinteractive.cli_main(_argv(trained))
    finally:
        sys.stdout = stdout
    return _records(capture.getvalue())


@pytest.mark.parametrize("source", ["file", "stdin"])
def test_interactive_matches_jax(trained, jax_records, capsys, monkeypatch, source):
    """The port's records equal JAX's, read from the file or from stdin."""
    argv = _argv(trained)
    if source == "stdin":
        monkeypatch.setattr(sys, "stdin", io.StringIO(open(trained[2]).read()))
        argv[argv.index("--input") + 1] = "-"
    tinteractive.cli_main(argv)
    got = _records(capsys.readouterr().out)
    n_lines = trained[3]
    assert len(got) == len(jax_records) == n_lines * (1 + 2 * 3)
    assert [r[0] for r in got] == [r[0] for r in jax_records]
    for g, w in zip(got, jax_records):
        kind = g[0][0]
        if kind == "S":
            assert g == w
        elif kind in ("H", "D"):
            assert g[2] == w[2] and abs(float(g[1]) - float(w[1])) <= SCORE_ATOL, (g, w)
        else:
            np.testing.assert_allclose(np.array(g[1].split(), float), np.array(w[1].split(), float), rtol=0,
                                       atol=1e-4)
    assert any("<unk>" in g[1] for g in got if g[0].startswith("S-"))


def test_interactive_refuses_what_jax_refuses(trained):
    """--max-sentences above --buffer-size asserts, as in JAX; weight
    quantisation raises ``NotImplementedError``, a codec whose library is
    missing ``ImportError`` naming it and a ``--user-dir`` that does not
    exist ``FileNotFoundError``, as in JAX; without --cpu and a card the
    CLI raises before loading anything."""
    with pytest.raises(AssertionError):
        tinteractive.cli_main(_argv(trained, "--max-sentences", "4"))
    with pytest.raises(NotImplementedError):
        tinteractive.cli_main(_argv(trained, "--quantize-weights", "int8"))
    with pytest.raises(ImportError, match="subword_nmt"):
        tinteractive.cli_main(_argv(trained, "--bpe", "subword_nmt", "--bpe-codes", "codes"))
    with pytest.raises(FileNotFoundError):
        tinteractive.cli_main(_argv(trained, "--user-dir", "/nonexistent"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError):
            tinteractive.cli_main([a for a in _argv(trained) if a != "--cpu"])
