"""PyTorch port, the context-chained generators of context-aware ST
(INTERSPEECH 2020) against JAX's ``sequence_generator_with_context`` on
tests/test_torch_context.py's models (the same numpy weights), on the CPU:
the Target and the Audio generator over consecutive calls, their buffers
after each call. Tolerances are stated per test."""

import numpy as np
import pytest

from fbk_fairseq_st_tpu.generation import sequence_generator_with_context as jgen
from fbk_fairseq_st_tpu_torch.generation import (AudioContextAwareSequenceGenerator,
                                                 TargetContextAwareSequenceGenerator)

from .test_context_model import SMALL
from .test_torch_context import VOCAB, built
from .test_torch_model import torch_dictionary
from .utils import dummy_dictionary

SCORE_ATOL = 1e-4


def _utterance(rng, t):
    return {"net_input": {"src_tokens": rng.randn(1, t, SMALL["input_feat_per_channel"]).astype(np.float32),
                          "src_lengths": np.array([t])}, "id": np.array([0]), "target": None}


@pytest.mark.parametrize("context_type", ["tgt", "src"])
def test_chained_generation_matches_jax(context_type):
    """tests/test_context_model.py::test_context_chained_generation in both
    packages: three consecutive single-utterance calls (beam 2, max_len_b
    5), each utterance's context the previous call's best hypothesis
    (``tgt``) or audio (``src``), give the same hypotheses, scores within
    1e-4, and the same buffer after each call; for ``src`` then one call
    on a batch of 3 (row i's context row i-1's audio)."""
    jmodel, variables, tmodel = built(context_type, "both", "sequential")
    tgt_dict = torch_dictionary(VOCAB)
    jcls, tcls = ((jgen.AudioContextAwareSequenceGenerator, AudioContextAwareSequenceGenerator)
                  if context_type == "src" else
                  (jgen.TargetContextAwareSequenceGenerator, TargetContextAwareSequenceGenerator))
    jg = jcls(dummy_dictionary(VOCAB), beam_size=2, max_len_b=5)
    tg = tcls(tgt_dict, beam_size=2, max_len_b=5)
    if context_type == "tgt":
        np.testing.assert_array_equal(tg.buffer, [[tgt_dict.eos()]])
    else:
        assert tg.buffer is None
    rng = np.random.RandomState(1)
    samples = [_utterance(rng, t) for t in (24, 17, 29)]
    if context_type == "src":
        b = rng.randn(3, 26, SMALL["input_feat_per_channel"]).astype(np.float32)
        samples.append({"net_input": {"src_tokens": b, "src_lengths": np.array([26, 20, 11])},
                        "id": np.arange(3), "target": None})
    for call, sample in enumerate(samples):
        want = jg.generate([(jmodel, variables)], sample)
        got = tg.generate([tmodel], sample)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert [list(h["tokens"]) for h in g] == [list(np.asarray(h["tokens"])) for h in w], call
            np.testing.assert_allclose([h["score"] for h in g], [h["score"] for h in w], rtol=0, atol=SCORE_ATOL)
        np.testing.assert_array_equal(np.asarray(tg.buffer), np.asarray(jg.buffer), err_msg=f"call {call}")
        if context_type == "tgt":
            np.testing.assert_array_equal(tg.buffer[0], got[-1][0]["tokens"])
            assert got[0][0]["tokens"][-1] == tgt_dict.eos()
        else:
            np.testing.assert_array_equal(tg.buffer, sample["net_input"]["src_tokens"][-1])
