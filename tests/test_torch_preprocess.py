"""PyTorch port, the data writers: the port's ``cli/preprocess`` and
``cli/preprocess_audio`` against JAX's on the same raw files, byte for
byte in every file they write, then the port's tasks loading the result.

The raw corpus is a few lines of random words in two languages (made from
a numpy seed), Pharaoh alignments of each pair, and filterbanks as an
``npz`` stream and an ``h5`` file. Each case runs both CLIs into their own
directory and compares the directories' files; the port's ``--workers 2``
writes what ``--workers 1`` writes."""

import os

import numpy as np
import pytest

from fbk_fairseq_st_tpu.cli import preprocess as jpreprocess
from fbk_fairseq_st_tpu.cli import preprocess_audio as jpreprocess_audio
from fbk_fairseq_st_tpu_torch import options
from fbk_fairseq_st_tpu_torch.cli import preprocess as tpreprocess
from fbk_fairseq_st_tpu_torch.cli import preprocess_audio as tpreprocess_audio
from fbk_fairseq_st_tpu_torch.data import Dictionary
from fbk_fairseq_st_tpu_torch.data import indexed_dataset
from fbk_fairseq_st_tpu_torch.registry import TASKS

N_MELS = 6


def _lines(rng, n, lang, vocab):
    return [" ".join(f"{lang}{rng.randint(vocab)}" for _ in range(rng.randint(2, 8))) for _ in range(n)]


@pytest.fixture(scope="module")
def raw(tmp_path_factory):
    """{train,valid,test}.{en,de}, train/valid .align (Pharaoh), a
    train-split alignfile, a given dictionary per side, and the
    filterbanks of 5 utterances as an npz stream and an h5 file."""
    root = str(tmp_path_factory.mktemp("preprocess"))
    rng = np.random.RandomState(0)
    for split, n in (("train", 24), ("valid", 6), ("test", 5)):
        en, de = _lines(rng, n, "e", 15), _lines(rng, n, "d", 20)
        for lang, lines in (("en", en), ("de", de)):
            with open(os.path.join(root, f"{split}.{lang}"), "w") as f:
                f.write("\n".join(lines) + "\n")
        if split != "test":
            with open(os.path.join(root, f"{split}.align"), "w") as f:
                for s, t in zip(en, de):
                    ns, nt = len(s.split()), len(t.split())
                    f.write(" ".join(f"{i}-{rng.randint(nt)}" for i in range(ns) if rng.rand() < 0.7) + "\n")
    with open(os.path.join(root, "train.align")) as src, open(os.path.join(root, "alignfile.txt"), "w") as dst:
        dst.write(src.read())
    for lang, vocab in (("en", 15), ("de", 20)):
        d = Dictionary()
        for i in range(vocab - 3):  # some words of the text stay out of it: <unk>
            d.add_symbol(f"{lang[0]}{i}", n=vocab - i)
        d.finalize(padding_factor=8)
        d.save(os.path.join(root, f"given.{lang}.txt"))
    feats = [rng.randn(rng.randint(7, 20), N_MELS).astype(np.float32) for _ in range(5)]
    with open(os.path.join(root, "feats.npz"), "wb") as f:
        np.save(f, np.array([len(feats)]))
        for feat in feats:
            np.save(f, feat)
    import h5py

    with h5py.File(os.path.join(root, "feats.h5"), "w") as f:
        for i in (3, 0, 10, 2, 1):  # written out of order; read in integer key order
            f.create_dataset(str(i), data=feats[i if i < 5 else 4])
    return root, feats


def _files(dest):
    out = {}
    for name in sorted(os.listdir(dest)):
        with open(os.path.join(dest, name), "rb") as f:
            out[name] = f.read()
    return out


CASES = {
    "pair-mmap-built": ["-s", "en", "-t", "de", "--trainpref", "{r}/train", "--validpref", "{r}/valid",
                        "--testpref", "{r}/test", "--dataset-impl", "mmap"],
    "pair-cached-given": ["-s", "en", "-t", "de", "--srcdict", "{r}/given.en.txt", "--tgtdict", "{r}/given.de.txt",
                          "--validpref", "{r}/valid", "--testpref", "{r}/test", "--dataset-impl", "cached"],
    "pair-joined": ["-s", "en", "-t", "de", "--trainpref", "{r}/train", "--validpref", "{r}/valid",
                    "--joined-dictionary", "--dataset-impl", "mmap"],
    "thresholds-nwords": ["-s", "en", "-t", "de", "--trainpref", "{r}/train", "--thresholdsrc", "3",
                          "--nwordstgt", "12", "--padding-factor", "4", "--dataset-impl", "lazy"],
    "alignments": ["-s", "en", "-t", "de", "--trainpref", "{r}/train", "--validpref", "{r}/valid",
                   "--align-suffix", "align", "--alignfile", "{r}/alignfile.txt", "--dataset-impl", "cached"],
    "target-only-raw": ["--target-lang", "de", "--trainpref", "{r}/train", "--testpref", "{r}/test",
                        "--dataset-impl", "raw"],
    "only-source-lang": ["--only-source", "-s", "en", "--trainpref", "{r}/train", "--validpref", "{r}/valid"],
    "only-source-unnamed": ["--only-source", "--trainpref", "{r}/train.de", "--validpref", "{r}/valid.de",
                            "--dataset-impl", "cached"],
    "workers-2": ["-s", "en", "-t", "de", "--trainpref", "{r}/train", "--validpref", "{r}/valid", "--workers", "2"],
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_preprocess_writes_jax_files(raw, tmp_path, case):
    """The same file names and bytes as JAX's CLI (dictionaries, .bin,
    .idx, alignment datasets and the alignment dictionary)."""
    root, _ = raw
    argv = [a.format(r=root) for a in CASES[case]]
    jpreprocess.cli_main(argv + ["--destdir", str(tmp_path / "jax")])
    tpreprocess.cli_main(argv + ["--destdir", str(tmp_path / "port")])
    want, got = _files(tmp_path / "jax"), _files(tmp_path / "port")
    assert sorted(got) == sorted(want)
    assert len(want) >= 3
    for name in want:
        assert got[name] == want[name], name
    if case == "workers-2":
        one = [a for a in argv if a not in ("--workers", "2")]
        tpreprocess.cli_main(one + ["--destdir", str(tmp_path / "one")])
        assert _files(tmp_path / "one") == got


@pytest.mark.parametrize("impl", ["mmap", "cached"])
def test_merged_builders_write_jax_files(tmp_path, impl):
    """``make_builder`` (int32 at any vocabulary size, as JAX) and
    ``merge_file_``: a dataset merged from two written ones, byte for byte
    JAX's, its items the parts' in order."""
    from fbk_fairseq_st_tpu.data import indexed_dataset as jidx

    rng = np.random.RandomState(1)
    parts = [[rng.randint(4, 300, size=rng.randint(1, 9)) for _ in range(n)] for n in (3, 5)]
    for side, idx in (("jax", jidx), ("port", indexed_dataset)):
        os.makedirs(tmp_path / side)
        prefixes = [str(tmp_path / side / name) for name in ("a", "b", "merged")]
        for prefix, items in zip(prefixes, parts):
            builder = idx.make_builder(prefix + ".bin", impl=impl, vocab_size=300)
            for item in items:
                builder.add_item(item)
            builder.finalize(prefix + ".idx")
        merged = idx.make_builder(prefixes[2] + ".bin", impl=impl, vocab_size=300)
        for prefix in prefixes[:2]:
            merged.merge_file_(prefix)
        merged.finalize(prefixes[2] + ".idx")
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")
    ds = indexed_dataset.make_dataset(str(tmp_path / "port" / "merged"), impl, fix_lua_indexing=True)
    want = parts[0] + parts[1]
    assert len(ds) == len(want)
    for got, item in zip((ds[i] for i in range(len(ds))), want):
        np.testing.assert_array_equal(got, item)


@pytest.mark.parametrize("fmt", ["npz", "h5"])
def test_preprocess_audio_writes_jax_files(raw, tmp_path, fmt):
    """The TNT float32 files byte for byte JAX's, and the items read back
    in stream (npz) or integer key (h5) order."""
    root, feats = raw
    argv = ["--audio-features", os.path.join(root, f"feats.{fmt}"), "--format", fmt]
    jpreprocess_audio.cli_main(argv + ["--output", str(tmp_path / "jax" / "train.npz")])
    tpreprocess_audio.cli_main(argv + ["--output", str(tmp_path / "port" / "train.npz")])
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")
    ds = indexed_dataset.FilterBanksDataset(str(tmp_path / "port" / "train.npz"))
    assert len(ds) == 5  # the h5 keys 0, 1, 2, 3, 10 hold feats 0-4: not their string order
    for i in range(5):
        np.testing.assert_array_equal(ds[i], feats[i])


def test_translation_task_loads_the_written_pairs(raw, tmp_path):
    """The port's translation task loads the mmap pairs the port wrote: the
    items are the lines encoded with the written dictionaries."""
    root, _ = raw
    dest = str(tmp_path / "bin")
    tpreprocess.cli_main(["-s", "en", "-t", "de", "--trainpref", f"{root}/train", "--validpref", f"{root}/valid",
                          "--destdir", dest])
    args = options.parse_args_and_arch(options.get_training_parser(),
                                       [dest, "--task", "translation", "--arch", "lightconv_iwslt_de_en"])
    task = TASKS["translation"].setup_task(args)
    task.load_dataset("valid")
    ds = task.dataset("valid")
    src_dict = Dictionary.load(os.path.join(dest, "dict.en.txt"))
    with open(f"{root}/valid.en") as f:
        for i, line in enumerate(f):
            np.testing.assert_array_equal(ds[i]["source"], src_dict.encode_line(line, add_if_not_exist=False))
    assert len(ds) == 6


def test_speech_task_loads_the_written_corpus(raw, tmp_path):
    """``preprocess_audio`` + ``preprocess --target-lang`` (given target
    dictionary, cached) make a corpus the speech task loads: frames and
    targets equal to the raw files'."""
    root, feats = raw
    dest = str(tmp_path / "bin")
    with open(f"{root}/test5.de", "w") as f:
        f.writelines(open(f"{root}/test.de").readlines()[:5])
    tpreprocess_audio.cli_main(["--audio-features", f"{root}/feats.npz", "--output", f"{dest}/test.npz"])
    tpreprocess.cli_main(["--target-lang", "de", "--tgtdict", f"{root}/given.de.txt", "--testpref",
                          f"{root}/test5", "--destdir", dest, "--dataset-impl", "cached"])
    args = options.parse_args_and_arch(options.get_training_parser(),
                                       [dest, "--task", "speech_recognition", "-t", "de", "--arch", "conv_transformer"])
    task = TASKS["speech_recognition"].setup_task(args)
    task.load_dataset("test")
    ds = task.dataset("test")
    tgt_dict = Dictionary.load(f"{root}/given.de.txt")
    assert len(ds) == 5
    with open(f"{root}/test5.de") as f:
        for i, line in enumerate(f):
            item = ds[i]
            np.testing.assert_array_equal(item["target"], tgt_dict.encode_line(line, add_if_not_exist=False))
            assert item["source"].shape == feats[i].shape


def test_preprocess_refuses_unported_codecs(raw, tmp_path):
    """The codec and user-module flags, now ported, are parsed and not
    read by ``cli/preprocess``, as JAX's parses and ignores them: the
    files equal a run without them."""
    root, _ = raw
    base = ["--target-lang", "de", "--trainpref", f"{root}/train"]
    tpreprocess.cli_main([*base, "--destdir", str(tmp_path / "plain")])
    for i, extra in enumerate((["--tokenizer", "moses"], ["--bpe", "subword_nmt"], ["--user-dir", str(tmp_path)])):
        tpreprocess.cli_main([*base, "--destdir", str(tmp_path / f"x{i}"), *extra])
        assert sorted(os.listdir(tmp_path / f"x{i}")) == sorted(os.listdir(tmp_path / "plain"))
        for name in os.listdir(tmp_path / "plain"):
            assert (tmp_path / f"x{i}" / name).read_bytes() == (tmp_path / "plain" / name).read_bytes(), name
