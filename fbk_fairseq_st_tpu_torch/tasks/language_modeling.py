"""language_modeling task: token-block chunked monolingual data for
decoder-only language models.

Counterpart of ``fbk_fairseq_st_tpu/tasks/language_modeling.py``
(reference fairseq/tasks/language_modeling.py:35-272): ``dict.txt``,
``<split>`` binarized streams cut by ``--sample-break-mode`` into blocks of
``--tokens-per-sample`` (``data/monolingual.py``), the ``self`` /
``future`` / ``past`` targets (``future`` when no flag is given; the
model's ``supported_targets`` must include each), ``--add-bos-token``,
``--output-dictionary-size`` (the output dictionary truncated),
``--truncate-sequence`` and ``--max-target-positions`` (the tokens per
sample when not given).

Batches are never padded to JAX's shape buckets (``get_batch_iterator``
drops ``bucket_shapes``): the rows and positions JAX adds hold pads that
no loss sees, so the updates are the same, and at wiki103's 3072 tokens a
row and 267,744 symbols each padded row would cost 3.3 GB of fp32
log-probabilities.
"""

from __future__ import annotations

import logging
import os

from ..data.dictionary import Dictionary, TruncatedDictionary
from ..data.indexed_dataset import load_indexed_dataset
from ..data.monolingual import MonolingualDataset, TokenBlockDataset
from ..data.wrappers import TruncateDataset
from .base import Task

logger = logging.getLogger(__name__)

_TARGETS = ("self", "future", "past")


class LanguageModelingTask(Task):
    @staticmethod
    def add_args(parser):
        parser.add_argument("data", help="path to data directory")
        parser.add_argument("--sample-break-mode", default="none", choices=["none", "complete", "complete_doc", "eos"],
                            help="how the token stream is cut into samples")
        parser.add_argument("--tokens-per-sample", default=1024, type=int,
                            help="block length of the stream (upper bound per sample)")
        parser.add_argument("--output-dictionary-size", default=-1, type=int,
                            help="predict only the first N dictionary entries (-1: all)")
        parser.add_argument("--self-target", action="store_true", help="train on the 'self' target")
        parser.add_argument("--future-target", action="store_true", help="train on the 'future' target")
        parser.add_argument("--past-target", action="store_true", help="train on the 'past' target")
        parser.add_argument("--add-bos-token", action="store_true", help="start every sample with <s>")
        parser.add_argument("--max-target-positions", type=int, metavar="N", default=None,
                            help="the model's length limit (default: --tokens-per-sample)")
        parser.add_argument("--truncate-sequence", action="store_true", default=False,
                            help="cut long sentences to --tokens-per-sample")

    def __init__(self, args, dictionary, output_dictionary=None, targets=None):
        super().__init__(args)
        self.dictionary = dictionary
        self.output_dictionary = output_dictionary or dictionary
        self.targets = targets if targets is not None else ["future"]
        if getattr(args, "max_target_positions", None) is None:
            args.max_target_positions = args.tokens_per_sample

    @classmethod
    def setup_task(cls, args, **kwargs):
        paths = args.data.split(os.pathsep)
        dictionary = Dictionary.load(os.path.join(paths[0], "dict.txt"))
        logger.info("dictionary: {} types".format(len(dictionary)))
        output_dictionary = dictionary
        if getattr(args, "output_dictionary_size", -1) >= 0:
            output_dictionary = TruncatedDictionary(dictionary, args.output_dictionary_size)
        targets = [t for t in _TARGETS if getattr(args, f"{t}_target", False)] or ["future"]
        return cls(args, dictionary, output_dictionary, targets=targets)

    def get_batch_iterator(self, dataset, **kwargs):
        kwargs["bucket_shapes"] = False
        return super().get_batch_iterator(dataset, **kwargs)

    def build_model(self, args, device=None):
        model = super().build_model(args, device=device)
        unsupported = [t for t in self.targets if t not in getattr(model, "supported_targets", {"future"})]
        if unsupported:
            raise ValueError(f"Unsupported language modeling target: {unsupported[0]}")
        return model

    def load_dataset(self, split, combine=False, epoch=1, **kwargs):
        paths = self.args.data.split(os.pathsep)
        data_path = paths[(epoch - 1) % len(paths)]
        ds = load_indexed_dataset(os.path.join(data_path, split), self.dictionary,
                                  getattr(self.args, "dataset_impl", None))
        if ds is None:
            raise FileNotFoundError(f"Dataset not found: {split} ({data_path})")
        if getattr(self.args, "truncate_sequence", False):
            ds = TruncateDataset(ds, self.args.tokens_per_sample)
        block = TokenBlockDataset(ds, ds.sizes, self.args.tokens_per_sample, pad=self.dictionary.pad(),
                                  eos=self.dictionary.eos(), break_mode=self.args.sample_break_mode,
                                  include_targets=True)
        break_mode = self.args.sample_break_mode
        self.datasets[split] = MonolingualDataset(
            block, block.sizes, self.dictionary, self.output_dictionary,
            add_eos_for_other_targets=bool(break_mode) and break_mode != "none", shuffle=(split == "train"),
            targets=self.targets, add_bos_token=getattr(self.args, "add_bos_token", False))

    @property
    def source_dictionary(self):
        return self.dictionary

    @property
    def target_dictionary(self):
        return self.output_dictionary

    def max_positions(self):
        return (self.args.max_target_positions, self.args.max_target_positions)
