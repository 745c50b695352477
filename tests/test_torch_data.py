"""PyTorch port, the data path from files against the JAX package: the
indexed datasets' writers and readers (byte-identical files, both ways),
batch packing, collation, per-utterance CMVN, the tasks' batches from a
corpus on disk, and corpus BLEU. All comparisons are exact (atol 0):
these are integer and copy operations, and CMVN runs the same numpy
arithmetic in the same types."""

import argparse
import os

import numpy as np
import pytest

from fbk_fairseq_st_tpu.data import batching as jbatching
from fbk_fairseq_st_tpu.data import datasets as jdatasets
from fbk_fairseq_st_tpu.data import indexed_dataset as jidx
from fbk_fairseq_st_tpu.data.dictionary import Dictionary as JaxDictionary
from fbk_fairseq_st_tpu.scoring import bleu as jbleu
from fbk_fairseq_st_tpu.tasks.speech_translation_ctc import SpeechTranslationCTCTask as JaxSTTask
from fbk_fairseq_st_tpu.tasks.translation import TranslationTask as JaxTranslationTask
from fbk_fairseq_st_tpu_torch.data import batching as tbatching
from fbk_fairseq_st_tpu_torch.data import datasets as tdatasets
from fbk_fairseq_st_tpu_torch.data import indexed_dataset as tidx
from fbk_fairseq_st_tpu_torch.data.dictionary import Dictionary
from fbk_fairseq_st_tpu_torch.scoring import bleu as tbleu
from fbk_fairseq_st_tpu_torch.tasks import SpeechTranslationCTCTask, TranslationTask


def _tokens(rng, n, lo=1, hi=9, vocab=50):
    return [rng.randint(4, vocab, size=rng.randint(lo, hi)).astype(np.int64) for _ in range(n)]


def _frames(rng, n, f=5):
    return [rng.randn(rng.randint(3, 20), f).astype(np.float32) for _ in range(n)]


def _write(builder_cls, prefix, items, **kw):
    b = builder_cls(prefix + ".bin", **kw)
    for item in items:
        b.add_item(item)
    b.finalize(prefix + ".idx")


def _bytes(prefix):
    return [open(prefix + ext, "rb").read() for ext in (".bin", ".idx")]


# kind -> (JAX builder, port builder, JAX reader, port reader, items)
FORMATS = {
    "tnt_tokens": (jidx.IndexedDatasetBuilder, tidx.IndexedDatasetBuilder,
                   lambda p: jidx.IndexedDataset(p, fix_lua_indexing=True),
                   lambda p: tidx.IndexedDataset(p, fix_lua_indexing=True), _tokens),
    "tnt_filterbanks": (jidx.AudioIndexedDatasetBuilder, tidx.AudioIndexedDatasetBuilder, jidx.FilterBanksDataset,
                        tidx.FilterBanksDataset, _frames),
    "mmap_tokens": (lambda f: jidx.MMapIndexedDatasetBuilder(f, dtype=np.int32),
                    lambda f: tidx.MMapIndexedDatasetBuilder(f, dtype=np.int32), jidx.MMapIndexedDataset,
                    tidx.MMapIndexedDataset, _tokens),
}


@pytest.mark.parametrize("kind", sorted(FORMATS))
def test_index_files_round_trip_both_ways(tmp_path, kind):
    """Both writers give the same bytes; each reader reads the other's
    file to the items written (exactly), with the same sizes."""
    jb, tb, jr, tr, make = FORMATS[kind]
    items = make(np.random.RandomState(0), 13)
    jp, tp = str(tmp_path / "jax"), str(tmp_path / "port")
    _write(jb, jp, items)
    _write(tb, tp, items)
    assert _bytes(jp) == _bytes(tp)
    for reader, prefix in ((tr, jp), (jr, tp)):
        ds = reader(prefix)
        assert len(ds) == len(items)
        for i, item in enumerate(items):
            np.testing.assert_array_equal(ds[i], item)
            assert ds.size(i) == ds.num_tokens(i) == len(item)
    np.testing.assert_array_equal(tr(jp).sizes, jr(tp).sizes)
    assert tidx.infer_dataset_impl(jp) == jidx.infer_dataset_impl(jp)


@pytest.mark.parametrize("seed", range(4))
def test_batch_by_size_equals_jax(seed):
    """The same batches as JAX's packer (its C++ core where it builds)
    over random sizes, token budgets, sentence caps and multiples; the
    same refusal of an item over the budget."""
    rng = np.random.RandomState(seed)
    for _ in range(50):
        n = rng.randint(0, 80)
        sizes = rng.randint(1, 60, size=n)
        indices = rng.permutation(n)
        kw = dict(max_tokens=[None, 64, 150, 400][rng.randint(4)], max_sentences=[None, 3, 8, 16][rng.randint(4)],
                  required_batch_size_multiple=[1, 2, 8][rng.randint(3)])
        if kw["max_tokens"] is None and kw["max_sentences"] is None:
            kw["max_sentences"] = 5
        try:
            want = jbatching.batch_by_size(indices, sizes[indices], **kw)
        except AssertionError:
            with pytest.raises(AssertionError):
                tbatching.batch_by_size(indices, sizes[indices], **kw)
            continue
        assert tbatching.batch_by_size(indices, sizes[indices], **kw) == want
        assert tbatching.batch_by_size(indices, lambda i: int(sizes[i]), **kw) == want


def test_filter_by_size_equals_jax():
    rng = np.random.RandomState(1)
    src, tgt = rng.randint(1, 40, 30), rng.randint(1, 40, 30)
    idx = rng.permutation(30)
    for mp in (20, (25, 30), (None, 18)):
        want = jbatching.filter_by_size_vec(idx, src, tgt, mp)
        got = tbatching.filter_by_size_vec(idx, src, tgt, mp)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]
        size_fn = lambda i: (int(src[i]), int(tgt[i]))  # noqa: E731
        want = jbatching.filter_by_size(idx, size_fn, mp)
        got = tbatching.filter_by_size(idx, size_fn, mp)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]


def test_apply_mv_norm_and_collation_equal_jax():
    """CMVN bit for bit (a constant channel takes the eps branch), and the
    Seq2SeqCollater's batch, fixed-shape padding included."""
    rng = np.random.RandomState(2)
    frames = _frames(rng, 7, f=6)
    frames[3][:, 2] = 1.5  # zero variance
    for fr in frames:
        np.testing.assert_array_equal(tdatasets.apply_mv_norm(fr), jdatasets.apply_mv_norm(fr))
    samples = [{"id": i, "source": tdatasets.apply_mv_norm(fr), "target": t}
               for i, (fr, t) in enumerate(zip(frames, _tokens(rng, 7)))]
    for pad in ({}, {"pad_to_src_len": 24, "pad_to_tgt_len": 12, "pad_to_bsz": 10}):
        want = jdatasets.Seq2SeqCollater(1, 2).collate(samples, **pad)
        got = tdatasets.Seq2SeqCollater(1, 2).collate(samples, **pad)
        _same_batch(got, want)


def _same_batch(got, want):
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if isinstance(v, dict):
            _same_batch(v, got[k])
        elif v is None:
            assert got[k] is None
        else:
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(v), err_msg=k)


def _corpus(tmp_path, rng, n=23):
    """A speech corpus (filterbanks, target and transcript) and a
    translation corpus, written with the JAX builders."""
    d = str(tmp_path)
    _write(jidx.AudioIndexedDatasetBuilder, os.path.join(d, "test.npz"), _frames(rng, n, f=4))
    for lang, vocab in (("de", 30), ("en", 20)):
        jd = JaxDictionary()
        for i in range(vocab):
            jd.add_symbol(f"{lang}{i}", n=vocab - i)
        jd.finalize()
        jd.save(os.path.join(d, f"dict.{lang}.txt"))
        toks = [np.append(t, 2) for t in _tokens(rng, n, vocab=len(jd))]
        _write(jidx.IndexedDatasetBuilder, os.path.join(d, f"test.{lang}"), toks)
        _write(jidx.IndexedDatasetBuilder, os.path.join(d, f"test.de-en.{lang}"), toks)
    return d


def _args(data, **kw):
    return argparse.Namespace(data=data, target_lang="de", source_lang="en", dataset_impl=None,
                              skip_normalization=False, legacy_audio_fix_lua_indexing=False,
                              max_source_positions=1024, max_target_positions=1024, criterion="cross_entropy",
                              left_pad_source="True", left_pad_target="False", **kw)


@pytest.mark.parametrize("task", ["speech_translation_with_transcription", "translation"])
def test_task_batches_from_files_equal_jax(tmp_path, task):
    """``setup_task``, ``load_dataset`` and ``get_batch_iterator`` (batch-max
    padding, as ``cli/generate``) give JAX's batches one for one, in order:
    the filterbanks after CMVN and the transcripts' fields, or the
    translation pairs with sources padded on the left."""
    data = _corpus(tmp_path, np.random.RandomState(3))
    jcls, tcls = {"translation": (JaxTranslationTask, TranslationTask),
                  "speech_translation_with_transcription": (JaxSTTask, SpeechTranslationCTCTask)}[task]
    jtask, ttask = jcls.setup_task(_args(data)), tcls.setup_task(_args(data))
    assert ttask.target_dictionary == Dictionary.load(os.path.join(data, "dict.de.txt"))
    jtask.load_dataset("test")
    ttask.load_dataset("test")
    kw = dict(max_tokens=60, max_sentences=None, max_positions=jtask.max_positions(), required_batch_size_multiple=2)
    want = list(jtask.get_batch_iterator(jtask.dataset("test"), bucket_shapes=False, **kw).next_epoch_itr(
        shuffle=False))
    got = list(ttask.get_batch_iterator(ttask.dataset("test"), **kw).next_epoch_itr(shuffle=False))
    assert len(got) == len(want) > 2
    for g, w in zip(got, want):
        _same_batch(g, w)


def test_bleu_equals_jax():
    """The statistics, the score and the result line of the JAX scorer's
    pure-Python path and of its C++ core where it builds, over random
    references and hypotheses with unks, pads and eos, and with one_init."""
    rng = np.random.RandomState(4)
    for one_init in (False, True):
        scorers = (tbleu.Scorer(1, 2, 3), jbleu.Scorer(1, 2, 3))
        for s in scorers:
            s.reset(one_init=one_init)
        for _ in range(40):
            ref = np.append(rng.randint(3, 12, size=rng.randint(1, 15)), 2)
            pred = np.concatenate([rng.randint(3, 12, size=rng.randint(1, 15)), [2, 1, 1][: rng.randint(0, 4)]])
            for s in scorers:
                s.add(ref.astype(np.int32), pred.astype(np.int32))
        got, want = scorers
        for field in tbleu.BleuStat.__slots__:
            assert getattr(got.stat, field) == getattr(want.stat, field), field
        assert got.score() == want.score()
        assert got.result_string() == want.result_string()
