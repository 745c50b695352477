"""PyTorch port, ``--score-reference``: the port's ``SequenceScorer``
against JAX's on a tiny ``conv_transformer`` (one model and an ensemble of
two), and the port's ``cli/generate --score-reference`` against JAX's on
the corpus and checkpoint of ``tests/test_torch_generate_cli.py``.

The port's models load JAX's weights through ``state_dict_from_jax`` and
run on the CPU (plain kernel versions). Tolerances: the positional scores
and the scores within 1e-5 of JAX's (the same fp32 forward, summed in
another order), the tokens identical; through the CLIs, the records in the
same order with the same tokens, the H- scores within 1e-5 and the P-
values (printed at 4 decimals) within 1e-4."""

import os

import jax
import numpy as np
import pytest
import torch

from fbk_fairseq_st_tpu import registry
from fbk_fairseq_st_tpu.cli import generate as jgenerate
from fbk_fairseq_st_tpu.generation.sequence_scorer import SequenceScorer as JaxSequenceScorer
from fbk_fairseq_st_tpu_torch.cli import generate as tgenerate
from fbk_fairseq_st_tpu_torch.generation import SequenceScorer
from fbk_fairseq_st_tpu_torch.models import conv_transformer as tct
from fbk_fairseq_st_tpu_torch.utils.weights import state_dict_from_jax

from .test_torch_generate_cli import _argv, _records, corpus  # noqa: F401  (the module fixture)
from .test_torch_model import torch_dictionary
from .utils import DummyTask, dummy_dictionary, model_args

VOCAB = 40
TINY = dict(encoder_layers=1, decoder_layers=2, encoder_embed_dim=16, decoder_embed_dim=16, encoder_ffn_embed_dim=32,
            decoder_ffn_embed_dim=32, encoder_attention_heads=2, decoder_attention_heads=2,
            max_source_positions=64, max_target_positions=32, input_feat_per_channel=8)
ATOL = 1e-5
SCORE_ARGS = ("--score-reference", "--max-sentences", "8")


class Jitted:
    """A JAX model whose eval forward runs under ``jax.jit`` (an eager
    forward takes seconds on the CPU): what JAX's scorer calls."""

    def __init__(self, model):
        self._forward = jax.jit(lambda variables, batch: model.forward(variables, batch, training=False))

    def forward(self, variables, batch, training=False):
        return self._forward(variables, batch)


def _pairs(n):
    """n (JAX model, variables) pairs of one architecture (one jitted
    forward) and the port's models on the same weights."""
    args = model_args("conv_transformer", **TINY)
    registry.apply_architecture(args)
    model = registry.build_model(args, DummyTask(dummy_dictionary(VOCAB)))
    jmodel = Jitted(model)
    init = jax.jit(model.init)
    pairs = []
    for key in range(n):
        variables = jax.tree_util.tree_map(np.asarray, init(jax.random.PRNGKey(key)))
        tmodel = tct.build_model("conv_transformer", torch_dictionary(), device="cpu", seed=1, **TINY)
        tmodel.load_state_dict(state_dict_from_jax(variables), strict=True)
        pairs.append(((jmodel, variables), tmodel.eval()))
    return pairs


def _sample(seed=0, b=3, t=29, tgt_len=6):
    rng = np.random.RandomState(seed)
    lengths = np.array([t, t - 5, t - 11], np.int32)[:b]
    target = np.ones((b, tgt_len), np.int64)
    prev = np.ones((b, tgt_len), np.int64)
    for i, n in enumerate((tgt_len, tgt_len - 1, tgt_len - 2)):  # shorter targets padded on the right
        target[i, :n] = np.append(rng.randint(4, VOCAB, size=n - 1), 2)
        prev[i, :n] = np.append(2, target[i, : n - 1])
    return {"net_input": {"src_tokens": rng.randn(b, t, TINY["input_feat_per_channel"]).astype(np.float32),
                          "src_lengths": lengths, "prev_output_tokens": prev}, "target": target}


@pytest.mark.parametrize("n_models", [1, 2])
def test_sequence_scorer_matches_jax(n_models):
    """Per sentence one hypothesis: the target's non-pad tokens, the
    positional log-probabilities (an ensemble's logaddexp over the models,
    minus log n) and their mean, each within 1e-5 of JAX's."""
    pairs = _pairs(n_models)
    sample = _sample()
    want = JaxSequenceScorer(dummy_dictionary(VOCAB)).generate([p[0] for p in pairs], sample)
    with torch.no_grad():
        got = SequenceScorer(torch_dictionary()).generate([p[1] for p in pairs], sample)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert len(g) == len(w) == 1
        g, w = g[0], w[0]
        np.testing.assert_array_equal(g["tokens"], w["tokens"])
        np.testing.assert_allclose(g["positional_scores"], w["positional_scores"], rtol=0, atol=ATOL)
        assert abs(g["score"] - w["score"]) <= ATOL
        assert g["score"] == pytest.approx(float(np.mean(g["positional_scores"])), abs=1e-6)
        assert g["alignment"] is None
    assert [len(g[0]["tokens"]) for g in got] == [6, 5, 4]


@pytest.fixture(scope="module")
def jax_scored(corpus, tmp_path_factory):  # noqa: F811
    """JAX's CLI, its ensemble's forward jitted, over the 6 utterances in
    one batch."""
    _, data_dir, pickled, _ = corpus
    results = str(tmp_path_factory.mktemp("jax_score_reference"))
    load = jgenerate.checkpoint_utils.load_model_ensemble

    def load_jitted(*args, **kwargs):
        ensemble, model_args = load(*args, **kwargs)
        return [(Jitted(model), variables) for model, variables in ensemble], model_args

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jgenerate.checkpoint_utils, "load_model_ensemble", load_jitted)
        jgenerate.cli_main(_argv(data_dir, pickled, results, *SCORE_ARGS))
    return _records(results)


@pytest.mark.parametrize("checkpoint", ["jax_pickle", "fork_pt"])
def test_generate_score_reference_matches_jax(corpus, jax_scored, checkpoint):  # noqa: F811
    """The same records in the same order from JAX's pickle and from the
    fork .pt: each H- line the reference (the T- line), its score the mean
    of its P- values, all within the stated tolerances of JAX's."""
    root, data_dir, pickled, fork = corpus
    results = os.path.join(root, f"port_score_reference_{checkpoint}")
    scorer = tgenerate.cli_main(_argv(data_dir, pickled if checkpoint == "jax_pickle" else fork, results,
                                      *SCORE_ARGS))
    want, want_order = jax_scored
    got, got_order = _records(results)
    assert got_order == want_order and len(got["H"]) == 6
    assert got["T"] == want["T"]
    for sid, (score, text) in want["H"].items():
        assert got["H"][sid][1] == text == got["T"][sid][0]
        assert abs(float(got["H"][sid][0]) - float(score)) <= ATOL
        positional = np.array(got["P"][sid][0].split(), float)
        np.testing.assert_allclose(positional, np.array(want["P"][sid][0].split(), float), rtol=0, atol=1e-4)
        assert abs(float(got["H"][sid][0]) - positional.mean()) <= 1e-4
    assert scorer.result_string().startswith("BLEU4 = 100.00")


@pytest.mark.parametrize("extra", [["--tokenizer", "moses"], ["--bpe", "subword_nmt"],
                                   ["--quantize-weights", "int8"], ["--user-dir", "/nonexistent"]])
def test_generate_still_refuses_the_unported_options(corpus, extra):  # noqa: F811
    """``--score-reference``, the codecs, the user modules and weight
    quantisation are ported; a codec whose library is missing
    raises ``ImportError`` naming it and a missing ``--user-dir``
    ``FileNotFoundError``, as in JAX; ``--tokenizer moses`` and
    ``--quantize-weights int8`` score."""
    root, data_dir, pickled, _ = corpus
    argv = _argv(data_dir, pickled, os.path.join(root, "refused"), *SCORE_ARGS, *extra)
    if extra[0] in ("--tokenizer", "--quantize-weights"):
        assert tgenerate.cli_main(argv).result_string().startswith("BLEU4 = 100.00")
        return
    expected = {"--bpe": ImportError, "--user-dir": FileNotFoundError}
    with pytest.raises(expected[extra[0]], match="subword_nmt" if extra[0] == "--bpe" else None):
        tgenerate.cli_main(argv)
