"""PyTorch port, two-phase decoding: ``TwoPhaseSequenceGenerator`` and the
generator options it needs (precomputed encoder outputs, step-0 scores,
per-beam context, temperature, match_source_len) against the JAX package
on the same weights and inputs, on the CPU.

The models are tests/test_torch_multi_task.py's tiny dual-decoder,
triangle and 2-stage pairs, built once per arch for the file. The port
runs its plain PyTorch versions. Scores are compared within 1e-4, tokens,
transcripts, origins and counts exactly."""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fbk_fairseq_st_tpu.generation import SequenceGenerator as JaxSequenceGenerator
from fbk_fairseq_st_tpu.generation import twophase_sequence_generator as jtp
from fbk_fairseq_st_tpu.generation.sequence_generator import EnsembleModel as JaxEnsembleModel
from fbk_fairseq_st_tpu.models.base import reorder_encoder_out as jax_reorder_encoder_out
from fbk_fairseq_st_tpu_torch.generation import BeamSearch, SequenceGenerator, TwoPhaseSequenceGenerator
from fbk_fairseq_st_tpu_torch.generation import twophase_sequence_generator as ttp
from fbk_fairseq_st_tpu_torch.generation.sequence_generator import EnsembleModel
from fbk_fairseq_st_tpu_torch.models import reorder_encoder_out
from fbk_fairseq_st_tpu_torch.tasks import SpeechTranslationDualDecodingTask

from .test_torch_model import shared_root, torch_dictionary  # noqa: F401  (shared_root: the fixture)
from .test_torch_multi_task import ARCHS, SMALL, SRC_VOCAB, TGT_VOCAB, built
from .utils import dummy_dictionary


def request(seed=1, lengths=(24, 16)):
    """B = 2 utterances of unequal lengths."""
    rng = np.random.RandomState(seed)
    feats = rng.randn(len(lengths), max(lengths), SMALL["input_feat_per_channel"]).astype(np.float32)
    return {"net_input": {"src_tokens": feats, "src_lengths": np.array(lengths)}}


def assert_same_hypotheses(got, want, transcripts=True):
    assert len(got) == len(want)
    for sent_t, sent_j in zip(got, want):
        assert len(sent_t) == len(sent_j) >= 1
        for ht, hj in zip(sent_t, sent_j):
            np.testing.assert_array_equal(ht["tokens"], np.asarray(hj["tokens"]))
            assert ht["origin"] == hj["origin"]
            assert abs(ht["score"] - hj["score"]) <= 1e-4
            np.testing.assert_allclose(ht["positional_scores"], hj["positional_scores"], rtol=0, atol=1e-4)
            if transcripts:
                np.testing.assert_array_equal(ht["transcript_tokens"], np.asarray(hj["transcript_tokens"]))
                assert abs(ht["transcript_score"] - hj["transcript_score"]) <= 1e-4


@pytest.mark.parametrize("beam", [2, 3])
@pytest.mark.parametrize("arch", ARCHS)
def test_twophase_hypotheses_match_jax(arch, beam):
    """Both phases end to end: per sentence the same hypotheses in the same
    order, each with the same transcript, origin and joint score; every
    hypothesis ends in eos and the scores are sorted."""
    jmodel, variables, tmodel = built(arch)
    sample = request()
    want = jtp.TwoPhaseSequenceGenerator(dummy_dictionary(SRC_VOCAB), dummy_dictionary(TGT_VOCAB), beam_size=beam,
                                         max_len_b=6).generate([(jmodel, variables)], sample)
    got = TwoPhaseSequenceGenerator(torch_dictionary(SRC_VOCAB), torch_dictionary(TGT_VOCAB), beam_size=beam,
                                    max_len_b=6).generate([tmodel], sample)
    assert_same_hypotheses(got, want)
    eos = torch_dictionary(TGT_VOCAB).eos()
    for sent in got:
        assert all(int(h["tokens"][-1]) == eos and int(h["transcript_tokens"][-1]) == eos for h in sent)
        scores = [h["score"] for h in sent]
        assert scores == sorted(scores, reverse=True)


def _phase2_inputs():
    """Three transcripts a sentence that differ from beam to beam (unequal
    lengths, one a bare eos) with close step-0 scores, so that the beams
    cross."""
    transcripts = np.array([
        [[5, 6, 7, 2, 1], [8, 2, 1, 1, 1], [5, 9, 9, 6, 2]],
        [[2, 1, 1, 1, 1], [11, 12, 13, 2, 1], [4, 4, 2, 1, 1]],
    ])
    scores = np.array([[-1.0, -1.1, -1.2], [-0.5, -0.55, -0.6]], np.float32)
    prev = np.concatenate([np.full(transcripts.shape[:2] + (1,), 2), transcripts[:, :, :-1]], axis=2)
    prev = np.where(transcripts == 1, 1, prev)
    return transcripts.reshape(-1, transcripts.shape[2]), prev.reshape(-1, prev.shape[2]), scores


@pytest.mark.parametrize("arch", ARCHS)
def test_phase2_search_with_init_scores_and_beam_ctx_matches_jax(arch):
    """Phase 2 alone, on hand-made transcripts that differ from beam to
    beam: ``_generate_impl`` with precomputed encoder outputs, step-0
    ``init_scores``, the transcripts' pad mask as ``beam_ctx`` and
    temperature 0.7, against JAX's ``_run`` with the same: the finalized
    buffers (tokens, lengths, counts, origins exactly; scores within 1e-4).
    The triangle's ``aux`` cache and the 2-stage decoder's ``cross`` cache
    hold per-beam rows here, which must follow the beams."""
    jmodel, variables, tmodel = built(arch)
    sample = request(seed=3)
    src, lengths = sample["net_input"]["src_tokens"], sample["net_input"]["src_lengths"]
    flat, prev, scores = _phase2_inputs()
    bsz, beam = scores.shape
    max_len = 7

    jgen = JaxSequenceGenerator(dummy_dictionary(TGT_VOCAB), beam_size=beam, temperature=0.7)
    jenc = jax_reorder_encoder_out(jax.jit(lambda v, s, n: jmodel.encode(v, s, n)[0])(
        variables, jnp.asarray(src), jnp.asarray(lengths)), jnp.repeat(jnp.arange(bsz), beam))
    jfeats = jmodel.aux_features(variables, jnp.asarray(prev), jenc)
    want = jgen._run(JaxEnsembleModel([(jtp._TgtAdapter(jmodel), variables)]),
                     {"src_tokens": jnp.asarray(src), "src_lengths": jnp.asarray(lengths)}, max_len, None,
                     encoder_outs=[jtp._PackedEncOut(jenc, jfeats)], init_scores=scores,
                     beam_ctx={"aux_padding_mask": jnp.asarray(flat == 1)})

    tgen = SequenceGenerator(torch_dictionary(TGT_VOCAB), beam_size=beam, temperature=0.7)
    src_t, lengths_t = torch.tensor(src), torch.tensor(lengths)
    with torch.no_grad():
        tenc = reorder_encoder_out(tmodel.encode(src_t, lengths_t), torch.arange(bsz).repeat_interleave(beam))
        tfeats = tmodel.aux_features(torch.tensor(prev), tenc)
        np.testing.assert_allclose(tfeats.numpy(), np.asarray(jfeats), rtol=0, atol=1e-4)
        got = tgen._generate_impl(EnsembleModel([ttp._TgtAdapter(tmodel)]), src_t, lengths_t, max_len, None,
                                  encoder_outs=[ttp._PackedEncOut(tenc, tfeats)], init_scores=torch.tensor(scores),
                                  beam_ctx={"aux_padding_mask": torch.tensor(flat == 1)})
    for key in ("fin_tokens", "fin_len", "fin_count", "fin_origin"):
        np.testing.assert_array_equal(got[key], np.asarray(want[key]), err_msg=key)
    for key in ("fin_score", "fin_cum"):
        np.testing.assert_allclose(got[key], np.asarray(want[key]), rtol=0, atol=1e-4, err_msg=key)
    assert len(set(got["fin_origin"].ravel().tolist())) > 1  # hypotheses descend from several transcripts


def test_generate_with_encoder_outs_temperature_and_match_source_len():
    """``generate(..., encoder_outs=)`` (phase 1's call: the auxiliary
    decoder over the shared, beam-replicated encoder output, which the
    generator does not recompute) with temperature 1.3 and
    ``match_source_len`` (max_len = the longest source, 24 frames), against
    JAX's; and a prefix on the same path."""
    jmodel, variables, tmodel = built("conv_transformer_2stage")
    sample = request(seed=5, lengths=(20, 24))
    src, lengths = sample["net_input"]["src_tokens"], sample["net_input"]["src_lengths"]
    beam = 3
    jenc = jax_reorder_encoder_out(jax.jit(lambda v, s, n: jmodel.encode(v, s, n)[0])(
        variables, jnp.asarray(src), jnp.asarray(lengths)), jnp.repeat(jnp.arange(2), beam))
    with torch.no_grad():
        tenc = reorder_encoder_out(tmodel.encode(torch.tensor(src), torch.tensor(lengths)),
                                   torch.arange(2).repeat_interleave(beam))
    kwargs = dict(beam_size=beam, temperature=1.3, match_source_len=True, max_len_b=3)
    for prefix in (None, np.array([[5, 6], [7, 1]])):
        want = JaxSequenceGenerator(dummy_dictionary(SRC_VOCAB), **kwargs).generate(
            [(jtp._AuxAdapter(jmodel), variables)], sample, prefix_tokens=prefix, encoder_outs=[jenc])
        got = SequenceGenerator(torch_dictionary(SRC_VOCAB), **kwargs).generate(
            [ttp._AuxAdapter(tmodel)], sample, prefix_tokens=prefix, encoder_outs=[tenc])
        assert_same_hypotheses(got, want, transcripts=False)
        assert max(len(h["tokens"]) for sent in got for h in sent) > 4  # longer than max_len_b allows


def _keep_transcripts(gen, keep):
    """``gen``'s phase 1 returning only the first ``keep[b]`` transcripts
    of sentence b."""
    phase1 = gen.aux_gen.generate
    gen.aux_gen.generate = lambda *a, **k: [sent[:n] for sent, n in zip(phase1(*a, **k), keep)]
    return gen


def test_fewer_transcripts_than_beams_as_jax():
    """Phase 1 giving fewer than K transcripts (sentence 0 one of three,
    sentence 1 none, sentence 2 all): the missing beams carry the last
    transcript again, or a bare eos at score -1e9, as in JAX; the triangle
    attends them. A sentence left with no real transcript finishes without
    hypotheses on both sides."""
    jmodel, variables, tmodel = built("conv_transformer_triangle")
    sample = request(seed=2, lengths=(24, 16, 20))
    keep = (1, 0, 3)
    want = _keep_transcripts(jtp.TwoPhaseSequenceGenerator(
        dummy_dictionary(SRC_VOCAB), dummy_dictionary(TGT_VOCAB), beam_size=3, max_len_b=5), keep).generate(
        [(jmodel, variables)], sample)
    got = _keep_transcripts(TwoPhaseSequenceGenerator(
        torch_dictionary(SRC_VOCAB), torch_dictionary(TGT_VOCAB), beam_size=3, max_len_b=5), keep).generate(
        [tmodel], sample)
    assert got[1] == want[1] == []
    assert_same_hypotheses(got[::2], want[::2])
    assert {tuple(h["transcript_tokens"]) for h in got[0]} == {tuple(got[0][0]["transcript_tokens"])}


def test_a_source_dictionary_smaller_than_the_beam_raises():
    """Phase 1's beam is clipped to len(src_dict) - 1 while the shared
    encoder output is replicated for the full beam: JAX fails on the
    mismatched rows; the port says why before it starts."""
    with pytest.raises(ValueError, match="source dictionary"):
        TwoPhaseSequenceGenerator(torch_dictionary(1), torch_dictionary(TGT_VOCAB), beam_size=5)
    gen = TwoPhaseSequenceGenerator(torch_dictionary(1), torch_dictionary(TGT_VOCAB), beam_size=4)
    assert gen.aux_gen.beam_size == 4


def test_task_builds_the_twophase_generator():
    """``build_generator`` reads the CLI's names (``_GEN_ARG_MAP``) into a
    TwoPhaseSequenceGenerator over the task's dictionaries, its phase-1
    generator over the source dictionary with the same options."""
    src, tgt = torch_dictionary(SRC_VOCAB), torch_dictionary(TGT_VOCAB)
    args = argparse.Namespace(criterion="cross_entropy_dualdecoder", beam=4, max_len_a=0.5, max_len_b=9, min_len=2,
                              lenpen=1.2, unkpen=0.3, temperature=0.8, match_source_len=False,
                              no_repeat_ngram_size=2, unnormalized=True)
    gen = SpeechTranslationDualDecodingTask(args, tgt, src).build_generator(None, args)
    assert isinstance(gen, TwoPhaseSequenceGenerator)
    for g, d in ((gen, tgt), (gen.aux_gen, src)):
        assert g.tgt_dict is d
        assert (g.beam_size, g.max_len_a, g.max_len_b, g.min_len, g.len_penalty, g.unk_penalty, g.temperature,
                g.match_source_len, g.no_repeat_ngram_size, g.normalize_scores) == (
                    4, 0.5, 9, 2, 1.2, 0.3, 0.8, False, 2, False)


@pytest.mark.parametrize("option", ["bos_token", "search_strategy", "seed"])
def test_generator_options_not_ported_raise(option):
    """``bos_token`` (a ``generate`` argument), ``search_strategy`` and
    ``seed`` are ported since PR 11 (their parity with JAX is
    ``tests/test_torch_search.py``'s): each is taken, an explicit
    ``BeamSearch`` and a seed give the default's hypotheses exactly, a bos
    token of its own changes them; an option the generator lacks still
    raises."""
    _, _, tmodel = built("conv_transformer_dualdecoder")
    d = torch_dictionary(TGT_VOCAB)
    plain = SequenceGenerator(d, beam_size=2).generate([tmodel], request())
    if option == "bos_token":
        got = SequenceGenerator(d, beam_size=2).generate([tmodel], request(), bos_token=5)
        assert any(not np.array_equal(a[0]["tokens"], b[0]["tokens"]) for a, b in zip(got, plain))
    else:
        value = BeamSearch(d) if option == "search_strategy" else 7
        got = SequenceGenerator(d, beam_size=2, **{option: value}).generate([tmodel], request())
        for a, b in zip(got, plain):
            np.testing.assert_array_equal(a[0]["tokens"], b[0]["tokens"])
            assert a[0]["score"] == b[0]["score"]
    with pytest.raises(TypeError):
        SequenceGenerator(d, beam_size=2, no_such_option=1)


