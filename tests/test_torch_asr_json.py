"""PyTorch port, the JSON audio route (``--dataset-from-json``) against JAX.

``data/audio.py``: ``read_wav`` at 1-, 2- and 4-byte widths (mono and a
stereo file's first channel) equal to JAX's; ``mel_banks``,
``logmel_fbank`` and ``apply_mv_norm`` within 1e-4 relative (an FFT or a
log may part in an ulp). ``scripts/asr_prep_json.py`` writes JAX's
manifest byte for byte; ``data/asr_json.py``'s dataset gives JAX's items
and collated batches (features at 1e-4 relative, the rest exact).
``--spm-model`` without ``sentencepiece`` and a non-wav file without
``torchaudio`` raise naming the package. Then the port's ``cli/train
--task speech_recognition --dataset-from-json`` and JAX's, from the same
seeded ``checkpoint_last.pt`` with the criterion in eval mode, log the
same values (rtol 1e-5) for the first update and the validation."""

import filecmp
import os
import shutil
import sys
import wave

import jax
import numpy as np
import pytest

from fbk_fairseq_st_tpu import options as joptions
from fbk_fairseq_st_tpu import registry as jregistry
from fbk_fairseq_st_tpu.cli import train as jtrain
from fbk_fairseq_st_tpu.data import asr_json as jjson
from fbk_fairseq_st_tpu.data import audio as jaudio
from fbk_fairseq_st_tpu.data.dictionary import Dictionary as JaxDictionary
from fbk_fairseq_st_tpu.scripts import asr_prep_json as jprep
from fbk_fairseq_st_tpu.train import checkpoint as jcheckpoint
from fbk_fairseq_st_tpu.train import metrics as jmetrics
from fbk_fairseq_st_tpu_torch.cli import train as ttrain
from fbk_fairseq_st_tpu_torch.data import asr_json as tjson
from fbk_fairseq_st_tpu_torch.data import audio as taudio
from fbk_fairseq_st_tpu_torch.data.dictionary import Dictionary as TorchDictionary
from fbk_fairseq_st_tpu_torch.scripts import asr_prep_json as tprep
from fbk_fairseq_st_tpu_torch.train import metrics as tmetrics

from .test_torch_train_cli import Recorder, assert_same_logs, eval_mode_criterions

RTOL = 1e-4
RATE = 16000
N_MELS = 8


def write_wav(path, samples, width=2, channels=1, rate=RATE):
    """``samples`` in [-1, 1] as PCM of ``width`` bytes (8-bit unsigned)."""
    samples = np.clip(samples, -1.0, 1.0)
    if width == 1:
        pcm = np.round(samples * 127 + 128).astype(np.uint8)
    elif width == 2:
        pcm = (samples * 32767).astype("<i2")
    else:
        pcm = (samples * 2147483647).astype("<i4")
    if channels > 1:
        pcm = np.stack([pcm] + [pcm[::-1]] * (channels - 1), axis=1)
    with wave.open(path, "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(width)
        w.setframerate(rate)
        w.writeframes(pcm.tobytes())


@pytest.mark.parametrize("width,channels", [(1, 1), (2, 1), (4, 1), (2, 2)])
def test_read_wav_matches_jax(tmp_path, width, channels):
    path = str(tmp_path / "a.wav")
    rng = np.random.RandomState(width)
    write_wav(path, 0.3 * rng.randn(3000), width, channels)
    got, rate = taudio.read_wav(path)
    want, jrate = jaudio.read_wav(path)
    assert rate == jrate == RATE and got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert len(got) == 3000


def test_fbank_and_norm_match_jax():
    rng = np.random.RandomState(0)
    wav = (rng.randn(RATE // 2) * 3000).astype(np.float32)
    for bins in (8, 40, 80):
        np.testing.assert_allclose(taudio.mel_banks(bins, 512, RATE), jaudio.mel_banks(bins, 512, RATE),
                                   rtol=RTOL, atol=1e-12)
        got = taudio.logmel_fbank(wav, RATE, num_mel_bins=bins)
        want = jaudio.logmel_fbank(wav, RATE, num_mel_bins=bins)
        assert got.shape == want.shape == (1 + (RATE // 2 - 400) // 160, bins)
        np.testing.assert_allclose(got, want, rtol=RTOL)
        np.testing.assert_allclose(taudio.apply_mv_norm(got), jaudio.apply_mv_norm(want), rtol=RTOL, atol=1e-5)
    assert taudio.logmel_fbank(wav[:100], RATE).shape == (0, 80)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Seeded 16 kHz WAVs (0.3-0.5 s), a dictionary, labels, and each
    split's JSON written by JAX's asr_prep_json."""
    root = str(tmp_path_factory.mktemp("asr_json"))
    data_dir = os.path.join(root, "data")
    audio = {split: os.path.join(root, "audio", split) for split in ("train", "valid")}
    rng = np.random.RandomState(0)
    d = JaxDictionary()
    for i in range(10):
        d.add_symbol(f"w{i}")
    d.finalize(padding_factor=1)
    os.makedirs(data_dir)
    d.save(os.path.join(data_dir, "dict.txt"))
    labels = []
    for split, n in (("train", 8), ("valid", 4)):
        os.makedirs(audio[split])
        for i in range(n):
            utt = f"spk{i % 2}-{split}-{i:04d}"
            write_wav(os.path.join(audio[split], utt + ".wav"), 0.1 * rng.randn(rng.randint(RATE * 3 // 10,
                                                                                             RATE // 2)))
            labels.append(f"{utt} " + " ".join(f"w{rng.randint(10)}" for _ in range(rng.randint(2, 5))))
    labels_path = os.path.join(root, "labels.txt")
    with open(labels_path, "w") as f:
        f.write("\n".join(labels) + "\n")
    for split in audio:
        jprep.cli_main(["--audio-dirs", audio[split], "--labels", labels_path, "--dictionary",
                        os.path.join(data_dir, "dict.txt"), "--output", os.path.join(data_dir, f"{split}.json")])
    return root, data_dir, audio, labels_path


def test_asr_prep_json_writes_jax_manifest(corpus):
    root, data_dir, audio, labels = corpus
    out = os.path.join(root, "port_train.json")
    tprep.cli_main(["--audio-dirs", audio["train"], "--labels", labels, "--dictionary",
                    os.path.join(data_dir, "dict.txt"), "--output", out])
    assert filecmp.cmp(out, os.path.join(data_dir, "train.json"), shallow=False)


def test_missing_packages_raise_by_name(corpus, monkeypatch):
    root, data_dir, audio, labels = corpus
    monkeypatch.setitem(sys.modules, "sentencepiece", None)
    with pytest.raises(ImportError, match="sentencepiece"):
        tprep.cli_main(["--audio-dirs", audio["train"], "--labels", labels, "--dictionary",
                        os.path.join(data_dir, "dict.txt"), "--output", os.path.join(root, "x.json"),
                        "--spm-model", "m.model"])
    flac = os.path.join(root, "flac")
    os.makedirs(flac, exist_ok=True)
    open(os.path.join(flac, "spk0-train-0000.flac"), "wb").close()
    monkeypatch.setitem(sys.modules, "torchaudio", None)
    with pytest.raises(ImportError, match="torchaudio"):
        tprep.cli_main(["--audio-dirs", flac, "--labels", labels, "--dictionary", os.path.join(data_dir, "dict.txt"),
                        "--output", os.path.join(root, "y.json"), "--audio-format", "flac"])


@pytest.mark.parametrize("skip_norm", [False, True])
def test_dataset_items_and_collation_match_jax(corpus, skip_norm):
    _, data_dir, _, _ = corpus
    path = os.path.join(data_dir, "train.json")
    jds = jjson.get_asr_dataset_from_json(path, JaxDictionary.load(os.path.join(data_dir, "dict.txt")), skip_norm,
                                          num_mel_bins=N_MELS)
    tds = tjson.get_asr_dataset_from_json(path, TorchDictionary.load(os.path.join(data_dir, "dict.txt")),
                                          skip_norm, num_mel_bins=N_MELS)
    assert len(tds) == len(jds) == 8
    np.testing.assert_array_equal(tds.sizes, jds.sizes)
    assert tds.ids == jds.ids and tds.speakers == jds.speakers
    assert [tds.size(i) for i in range(8)] == [jds.size(i) for i in range(8)]
    for i in range(8):
        g, w = tds[i], jds[i]
        np.testing.assert_allclose(g["source"], w["source"], rtol=RTOL, atol=1e-5)
        np.testing.assert_array_equal(g["target"], w["target"])
    for pad in ({}, {"pad_to_src_len": 64, "pad_to_tgt_len": 8, "pad_to_bsz": 8}):
        gb = tds.collater([tds[i] for i in (3, 0, 5)], **pad)
        wb = jds.collater([jds[i] for i in (3, 0, 5)], **pad)
        assert sorted(gb) == sorted(wb)
        np.testing.assert_allclose(gb["net_input"]["src_tokens"], wb["net_input"]["src_tokens"], rtol=RTOL,
                                   atol=1e-5)
        for key in ("id", "target", "target_lengths", "ntokens", "nsentences"):
            np.testing.assert_array_equal(gb[key], wb[key])
        for key in ("src_lengths", "prev_output_tokens"):
            np.testing.assert_array_equal(gb["net_input"][key], wb["net_input"][key])


MODEL = ["--arch", "conv_transformer", "--encoder-layers", "2", "--decoder-layers", "1", "--encoder-embed-dim", "16",
         "--decoder-embed-dim", "16", "--encoder-ffn-embed-dim", "32", "--decoder-ffn-embed-dim", "32",
         "--encoder-attention-heads", "2", "--decoder-attention-heads", "2",
         "--encoder-convolutions", "[(4, 3, 3)] * 2", "--input-feat-per-channel", str(N_MELS),
         "--max-source-positions", "256", "--max-target-positions", "32",
         "--dropout", "0", "--attention-dropout", "0", "--relu-dropout", "0"]


def _argv(data_dir, save_dir):
    return [data_dir, "--task", "speech_recognition", "--dataset-from-json", *MODEL, "--criterion",
            "label_smoothed_cross_entropy", "--label-smoothing", "0.1", "--optimizer", "adam", "--lr", "0.001",
            "--lr-scheduler", "fixed", "--max-sentences", "8", "--max-update", "1", "--log-format", "json",
            "--log-interval", "1", "--save-dir", save_dir, "--seed", "3", "--cpu"]


def test_first_update_from_json_matches_jax(corpus, monkeypatch):
    """The first update (all 8 training utterances, one batch) and the
    validation after it: the same logged loss, nll_loss, gnorm and lr."""
    root, data_dir, _, _ = corpus
    args = joptions.parse_args_and_arch(joptions.get_training_parser(), _argv(data_dir, "unused"))
    task = jregistry.TASKS[args.task].setup_task(args)
    model = jregistry.build_model(args, task)
    variables = jax.tree_util.tree_map(np.asarray, jax.jit(model.init)(jax.random.PRNGKey(5)))
    opt_state = jregistry.OPTIMIZERS[args.optimizer].build_optimizer(args).init(variables["params"])
    seeded = os.path.join(root, "seed.pt")
    jcheckpoint.save_state(seeded, {
        "args": vars(args), "model": variables["params"], "model_state": variables["state"],
        "opt_state": jax.tree_util.tree_map(np.asarray, opt_state), "lr_scheduler": None, "num_updates": 0})
    logs = []
    for name, cli, module in (("jax", jtrain, jmetrics), ("port", ttrain, tmetrics)):
        save_dir = os.path.join(root, f"train_{name}")
        os.makedirs(save_dir)
        shutil.copyfile(seeded, os.path.join(save_dir, "checkpoint_last.pt"))
        with monkeypatch.context() as m:
            eval_mode_criterions(m)
            rec = Recorder(m, module)
            cli.cli_main(_argv(data_dir, save_dir))
        logs.append(rec.calls)
    want, got = logs
    assert sum(k == "gnorm" for k, _ in want) == 1 and sum(k == "loss" for k, _ in want) == 2
    assert all(np.isfinite(v) for _, v in want)
    assert_same_logs(got, want)
