#!/usr/bin/python3
"""Build the JSON manifest for the raw-audio ASR route.

Counterpart of examples/speech_recognition/datasets/asr_prep_json.py:23-96:
per utterance {input: {path, length_ms}, output: {text, token, tokenid}}
with sentencepiece-tokenized targets. Audio durations come from torchaudio
when available, else from an explicit ``--durations`` TSV (utt_id<TAB>ms) so
the tool works without audio backends. A WAV's duration comes from the
``wave`` module; another format needs ``torchaudio``, and ``--spm-model``
needs ``sentencepiece``: each raises ``ImportError`` naming the package
when it is missing.

The port's copy of ``fbk_fairseq_st_tpu/scripts/asr_prep_json.py``:

    python -m fbk_fairseq_st_tpu_torch.scripts.asr_prep_json --audio-dirs WAVS \
        --labels labels.txt --dictionary dict.txt --output train.json
"""

from __future__ import annotations

import argparse
import json
import os
from collections import namedtuple
from itertools import chain

from ..data.dictionary import Dictionary
from ..data.encoders import require_package

MILLISECONDS_TO_SECONDS = 0.001


def _load_spm(path):
    spm = require_package("sentencepiece", "--spm-model")

    sp = spm.SentencePieceProcessor()
    sp.Load(path)
    return sp


def _duration_ms(aud_path):
    if aud_path.endswith(".wav"):
        import wave

        with wave.open(aud_path, "rb") as w:
            return int(
                w.getnframes() / w.getframerate() / MILLISECONDS_TO_SECONDS
            )
    torchaudio = require_package("torchaudio", "a non-wav audio file")  # an audio backend

    info = torchaudio.info(aud_path)
    return int(
        info.num_frames / info.sample_rate / MILLISECONDS_TO_SECONDS
    )


def process_sample(aud_path, label, utt_id, sp, tgt_dict, durations):
    if durations is not None:
        length_ms = durations[utt_id]
    else:
        length_ms = _duration_ms(aud_path)
    token = " ".join(sp.EncodeAsPieces(label)) if sp is not None else label
    ids = tgt_dict.encode_line(token, add_if_not_exist=False, append_eos=False)
    return {
        utt_id: {
            "input": {"length_ms": int(length_ms), "path": aud_path},
            "output": {
                "text": label,
                "token": token,
                "tokenid": ", ".join(map(str, ids.tolist())),
            },
        }
    }


def cli_main(input_args=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--audio-dirs", nargs="+", required=True,
                        help="input directories with audio files")
    parser.add_argument("--labels", required=True,
                        help="aggregated input labels with format <ID LABEL> per line")
    parser.add_argument("--spm-model", default=None,
                        help="sentencepiece model for target tokenization")
    parser.add_argument("--dictionary", required=True,
                        help="fairseq dictionary file")
    parser.add_argument("--audio-format", choices=["flac", "wav"], default="wav")
    parser.add_argument("--durations", default=None,
                        help="optional TSV utt_id<TAB>length_ms (avoids "
                        "needing an audio backend)")
    parser.add_argument("--output", required=True, help="output json path")
    args = parser.parse_args(input_args)

    sp = _load_spm(args.spm_model) if args.spm_model else None
    tgt_dict = Dictionary.load(args.dictionary)

    labels = {}
    with open(args.labels, encoding="utf-8") as f:
        for line in f:
            utt_id, label = line.strip().split(" ", 1)
            labels[utt_id] = label
    if not labels:
        raise Exception("No labels found in", args.labels)

    durations = None
    if args.durations:
        durations = {}
        with open(args.durations, encoding="utf-8") as f:
            for line in f:
                utt_id, ms = line.strip().split("\t")
                durations[utt_id] = int(ms)

    Sample = namedtuple("Sample", "aud_path utt_id")
    samples = []
    for path, _, files in chain.from_iterable(
        os.walk(p) for p in args.audio_dirs
    ):
        for f in files:
            if f.endswith(args.audio_format):
                utt_id = os.path.splitext(f)[0]
                if utt_id in labels:
                    samples.append(Sample(os.path.join(path, f), utt_id))

    utts = {}
    for s in samples:
        utts.update(
            process_sample(
                s.aud_path, labels[s.utt_id], s.utt_id, sp, tgt_dict, durations
            )
        )
    with open(args.output, "w") as out:
        json.dump({"utts": utts}, out, indent=4)


if __name__ == "__main__":
    cli_main()
