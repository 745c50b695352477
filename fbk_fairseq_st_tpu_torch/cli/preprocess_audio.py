"""Audio preprocessing: pack precomputed filterbanks into an indexed dataset.

The port's copy of ``fbk_fairseq_st_tpu/cli/preprocess_audio.py``
(reference examples/speech_recognition/preprocess_audio.py:61-121): reads
the utterances of an ``npz`` stream (an array holding the count, then one
``np.save``'d array an utterance, read by consecutive ``np.load`` calls on
one file) or of an ``h5`` file (its keys in integer order; ``h5py`` is
imported only then), and writes them in that order as
``<output>.{bin,idx}``, the float32 TNT dataset the speech tasks load as
``<split>.npz``, byte for byte JAX's. No device is used:

    python -m fbk_fairseq_st_tpu_torch.cli.preprocess_audio --audio-features train.npz \\
        --format npz --output data-bin/train.npz
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

import numpy as np

from ..data.indexed_dataset import AudioIndexedDatasetBuilder

logger = logging.getLogger("fbk_fairseq_st_tpu_torch.cli.preprocess_audio")


def reader_npz(path):
    """The utterances of an npz stream: a shape array, then shape[0] arrays."""
    with open(path, "rb") as f:
        shape = np.load(f)
        for _ in range(int(shape[0])):
            yield np.load(f)


def reader_h5(path):
    import h5py

    with h5py.File(path, "r") as file:
        for key in sorted(file.keys(), key=lambda x: int(x)):
            yield file[str(key)][()]


SUPPORTED_TYPES = {"h5": reader_h5, "npz": reader_npz}


def main(args):
    reader = SUPPORTED_TYPES[args.format]
    os.makedirs(os.path.dirname(os.path.abspath(args.output)) or ".", exist_ok=True)
    builder = AudioIndexedDatasetBuilder(args.output + ".bin")
    n = 0
    for tensor in reader(args.audio_features):
        builder.add_item(np.asarray(tensor, dtype=np.float32))
        n += 1
    builder.finalize(args.output + ".idx")
    logger.info(f"Wrote {n} utterances to {args.output}.{{bin,idx}}")


def cli_main(input_args=None):
    logging.basicConfig(format="%(asctime)s | %(levelname)s | %(name)s | %(message)s",
                        datefmt="%Y-%m-%d %H:%M:%S", level=logging.INFO, stream=sys.stdout)
    parser = argparse.ArgumentParser(description="Pack precomputed audio features into indexed datasets")
    parser.add_argument("--audio-features", required=True, help="input .npz/.h5 file with the fbank tensors")
    parser.add_argument("--format", default="npz", choices=sorted(SUPPORTED_TYPES))
    parser.add_argument("--output", required=True,
                        help="output prefix (writes <output>.bin/.idx), e.g. data-bin/train.npz")
    main(parser.parse_args(input_args))


if __name__ == "__main__":
    cli_main()
