"""PyTorch port, the generator's search strategies and options against the
JAX package, on a tiny conv_transformer with the same weights (the pair of
``tests/test_torch_model.py``), on the CPU.

Deterministic strategies (length-constrained, diverse beam, diverse
siblings), ``bos_token`` and the ``eos`` override: hypotheses identical to
JAX's in the same order, scores and positional scores within 1e-4.
Sampling cannot match JAX draw for draw (another generator): a top-k = 1
request equals greedy search in both packages, token for token, and the
port's draws follow the renormalised top-k / top-p distribution within
5 sigma of their binomial spread."""

import argparse

import numpy as np
import pytest
import torch

from fbk_fairseq_st_tpu.generation import SequenceGenerator as JaxSequenceGenerator
from fbk_fairseq_st_tpu.generation import search as jsearch
from fbk_fairseq_st_tpu_torch.generation import SequenceGenerator, search as tsearch
from fbk_fairseq_st_tpu_torch.tasks import Task

from .test_torch_model import _batch, _build_pair, shared_root  # noqa: F401  (the fixture)

ATOL = 1e-4


@pytest.fixture(scope="module")
def pair():
    return _build_pair()


def _sample():
    batch = _batch(seed=4)
    return {"net_input": {"src_tokens": batch["src_tokens"], "src_lengths": batch["src_lengths"]}}


def _same(got, want, beam):
    assert len(got) == len(want)
    for hyps_t, hyps_j in zip(got, want):
        assert len(hyps_t) == len(hyps_j) == beam
        for ht, hj in zip(hyps_t, hyps_j):
            np.testing.assert_array_equal(ht["tokens"], np.asarray(hj["tokens"]))
            assert abs(ht["score"] - hj["score"]) <= ATOL
            np.testing.assert_allclose(ht["positional_scores"], hj["positional_scores"], rtol=0, atol=ATOL)


# name -> (the generator's kwargs, a strategy factory per package)
CASES = {
    "length_constrained": (dict(beam_size=3, max_len_b=10),
                           lambda s, d: s.LengthConstrainedBeamSearch(d, min_len_a=0, min_len_b=3, max_len_a=0.1,
                                                                      max_len_b=2)),
    "diverse_beam": (dict(beam_size=4, max_len_b=8), lambda s, d: s.DiverseBeamSearch(d, 2, 0.5)),
    "diverse_siblings": (dict(beam_size=3, max_len_b=8), lambda s, d: s.DiverseSiblingsSearch(d, 0.5)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_deterministic_strategies_match_jax(pair, case):
    jd, jmodel, variables, td, tmodel = pair
    kwargs, strategy = CASES[case]
    want = JaxSequenceGenerator(jd, search_strategy=strategy(jsearch, jd), **kwargs).generate(
        [(jmodel, variables)], _sample())
    got = SequenceGenerator(td, search_strategy=strategy(tsearch, td), **kwargs).generate([tmodel], _sample())
    _same(got, want, kwargs["beam_size"])
    if case == "length_constrained":  # eos forced at 0.1 * src_len + 2 tokens
        lengths = _sample()["net_input"]["src_lengths"]
        for hyps, n in zip(got, lengths):
            assert all(len(h["tokens"]) <= int(np.ceil(0.1 * n + 2)) + 1 for h in hyps)


@pytest.mark.parametrize("option", ["bos_token", "eos_override"])
def test_bos_token_and_eos_override_match_jax(pair, option):
    jd, jmodel, variables, td, tmodel = pair
    kwargs = dict(beam_size=3, max_len_b=8)
    gen_kwargs = {"bos_token": 5} if option == "bos_token" else {}
    if option == "eos_override":
        kwargs["eos"] = 7
    want = JaxSequenceGenerator(jd, **kwargs).generate([(jmodel, variables)], _sample(), **gen_kwargs)
    got = SequenceGenerator(td, **kwargs).generate([tmodel], _sample(), **gen_kwargs)
    _same(got, want, 3)
    plain = SequenceGenerator(td, beam_size=3, max_len_b=8).generate([tmodel], _sample())
    assert any(not np.array_equal(a[0]["tokens"], b[0]["tokens"]) for a, b in zip(got, plain))
    if option == "eos_override":
        assert all(h["tokens"][-1] == 7 for hyps in got for h in hyps)


def test_sampling_top1_is_greedy_in_both_packages(pair):
    """Top-k = 1 sampling (beam 2, two draws a beam) gives greedy search's
    hypothesis in every beam, in JAX and in the port."""
    jd, jmodel, variables, td, tmodel = pair
    greedy = SequenceGenerator(td, beam_size=1, max_len_b=8).generate([tmodel], _sample())
    got = SequenceGenerator(td, beam_size=2, max_len_b=8, search_strategy=tsearch.Sampling(td, 1), seed=3).generate(
        [tmodel], _sample())
    want = JaxSequenceGenerator(jd, beam_size=2, max_len_b=8, search_strategy=jsearch.Sampling(jd, 1)).generate(
        [(jmodel, variables)], _sample())
    for g, hyps_t, hyps_j in zip(greedy, got, want):
        for ht, hj in zip(hyps_t, hyps_j):
            np.testing.assert_array_equal(ht["tokens"], g[0]["tokens"])
            np.testing.assert_array_equal(np.asarray(hj["tokens"]), g[0]["tokens"])
            np.testing.assert_allclose(ht["positional_scores"], g[0]["positional_scores"], rtol=0, atol=ATOL)


def _renormalised(p, topk, topp):
    """The reference distribution in numpy: keep the top k (k > 0), then
    the smallest prefix of the sorted rest whose exclusive mass is < p."""
    p = p.astype(np.float64).copy()
    if topk > 0:
        p[p < np.sort(p)[::-1][topk - 1]] = 0
    if topp > 0:
        order = np.argsort(-p, kind="stable")
        exclusive = np.cumsum(p[order]) - p[order]
        keep = np.zeros_like(p, dtype=bool)
        keep[order[exclusive < topp]] = True
        p[~keep] = 0
    return p / p.sum()


@pytest.mark.parametrize("topk,topp", [(-1, -1.0), (5, -1.0), (-1, 0.6), (4, 0.9)])
def test_sampling_draws_follow_the_renormalised_distribution(topk, topp):
    """From fixed log-probs (B 1, K 2, V 12): ``Sampling.probs`` equals the
    renormalised distribution within 1e-6, and 20,000 steps' draws give
    every token's frequency within 5 sigma of it (tokens outside never)."""
    v = 12
    logits = torch.tensor(np.random.RandomState(0).randn(1, 2, v) * 1.5, dtype=torch.float32)
    lprobs = torch.log_softmax(logits, dim=-1)
    strategy = tsearch.Sampling(type("D", (), {"pad": lambda s: 1, "eos": lambda s: 2})(), topk, topp)
    want = np.stack([_renormalised(np.exp(lprobs[0, k].double().numpy()), topk, topp) for k in range(2)])
    np.testing.assert_allclose(strategy.probs(lprobs)[0].numpy(), want, rtol=0, atol=1e-6)
    n = 10000
    gen = torch.Generator().manual_seed(0)
    draws = torch.stack([strategy.step(1, lprobs, torch.zeros(1, 2), gen).indices[0] for _ in range(n)])
    for k in range(2):  # beam k's two draws: candidates k and K + k
        toks = torch.cat([draws[:, k], draws[:, 2 + k]]).numpy()
        freq = np.bincount(toks, minlength=v) / len(toks)
        sigma = np.sqrt(want[k] * (1 - want[k]) / len(toks))
        assert (np.abs(freq - want[k]) <= 5 * sigma + 1e-12).all(), (k, freq, want[k])


def test_build_generator_maps_the_options():
    """``Task.build_generator`` picks JAX's strategy for each option, with
    the generator's fields from the CLI names; exclusive options raise."""
    d = type("D", (), {"pad": lambda s: 1, "eos": lambda s: 2, "unk": lambda s: 3, "__len__": lambda s: 40})()

    class T(Task):
        target_dictionary = d

    def build(**flags):
        return T(argparse.Namespace()).build_generator([], argparse.Namespace(**flags))

    assert type(build().search) is tsearch.BeamSearch
    gen = build(sampling=True, sampling_topk=10, sampling_topp=0.5, seed=4, beam=3, lenpen=1.5, unkpen=0.2,
                max_len_a=1.2, max_len_b=7, min_len=2, no_repeat_ngram_size=3, temperature=0.7, unnormalized=True)
    assert isinstance(gen.search, tsearch.Sampling) and (gen.search.sampling_topk, gen.search.sampling_topp) == (10, 0.5)
    assert (gen.seed, gen.beam_size, gen.len_penalty, gen.unk_penalty, gen.max_len_a, gen.max_len_b, gen.min_len,
            gen.no_repeat_ngram_size, gen.temperature, gen.normalize_scores) == (4, 3, 1.5, 0.2, 1.2, 7, 2, 3, 0.7,
                                                                                  False)
    diverse = build(diverse_beam_groups=2, diverse_beam_strength=0.3).search
    assert isinstance(diverse, tsearch.DiverseBeamSearch) and diverse.diversity_strength == -0.3
    assert isinstance(build(match_source_len=True).search, tsearch.LengthConstrainedBeamSearch)
    assert isinstance(build(diversity_rate=0.5).search, tsearch.DiverseSiblingsSearch)
    with pytest.raises(ValueError):
        build(sampling=True, diverse_beam_groups=2)
    with pytest.raises(ValueError):
        build(sampling_topk=5)
