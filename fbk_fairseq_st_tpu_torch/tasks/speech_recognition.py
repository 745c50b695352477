"""speech_recognition task: fbank -> text (ASR or direct ST).

Counterpart of ``fbk_fairseq_st_tpu/tasks/speech_recognition.py``
(reference examples/speech_recognition/tasks/speech_recognition.py:86-263):
the options (:47-96), ``setup_task`` (``dict.<tgt>.txt``, or ``dict.txt``;
``<ctc_blank>`` added under ``ctc_loss``, the replabel symbols "1" ..
``--max-replabel`` under ``asg_loss``), ``load_dataset`` over the
indexed precomputed filterbanks (``<split>.npz.{bin,idx}`` and the
``<split>.<lang>`` indexed text, in each of the data directories joined by
``os.pathsep``; per-utterance CMVN unless ``--skip-normalization``), and
``augment_batch``: TimeStretch, then SpecAugment, on the device batch
(reference train_step :255-258), drawn from the trainer's device
generator (``ops/specaugment.py``). With ``--dataset-from-json`` a split
is ``<split>.json`` of ``scripts/asr_prep_json.py`` in each directory,
its features made from the audio files as the batches are drawn
(``data/asr_json.py``).
"""

from __future__ import annotations

import logging
import os

from ..data.asr_json import get_asr_dataset_from_json
from ..data.datasets import ConcatDataset, FilterBankToTextDataset
from ..data.dictionary import Dictionary
from ..data.indexed_dataset import FilterBanksDataset, load_indexed_dataset
from ..data.replabels import replabel_symbol
from ..ops.core import device_generator
from ..ops.specaugment import SpecAugmentConfig, TimeStretchConfig, specaugment, time_stretch
from .base import Task

logger = logging.getLogger(__name__)


def get_datasets_from_indexed_filterbanks(data_path, tgt_lang, tgt_dict, split, dataset_impl, skip_norm,
                                          legacy_audio_fix_lua_indexing):
    """Reference tasks/speech_recognition.py:73-84."""
    prefix = os.path.join(data_path, split)
    src_dataset = FilterBanksDataset(prefix + ".npz", legacy_audio_fix_lua_indexing=legacy_audio_fix_lua_indexing)
    tgt_dataset = None
    if tgt_lang is not None:
        tgt_dataset = load_indexed_dataset(prefix + "." + tgt_lang, tgt_dict, dataset_impl)
    return FilterBankToTextDataset(src_dataset, tgt_dataset, tgt_dict, skip_norm)


class SpeechRecognitionTask(Task):
    @staticmethod
    def add_args(parser):
        parser.add_argument("data", help="path to data directory. For multiple directories, use column to "
                            "concatenate them.")
        parser.add_argument("--silence-token", default="▁", help="token for silence (used by w2l)")
        parser.add_argument("--max-source-positions", default=1024, type=int, metavar="N",
                            help="max number of tokens in the source sequence")
        parser.add_argument("--max-target-positions", default=1024, type=int, metavar="N",
                            help="max number of tokens in the target sequence")
        parser.add_argument("--dataset-from-json", action="store_true", default=False,
                            help="whether to read the data from a JSON file or from indexed data containing "
                            "the precomputed filterbanks")
        parser.add_argument("-t", "--target-lang", default=None, metavar="TARGET", help="target language")
        parser.add_argument("--skip-normalization", action="store_true", default=False,
                            help="if set, the input filterbanks are not normalized")
        parser.add_argument("--legacy-audio-fix-lua-indexing", action="store_true", default=False,
                            help="if set, the input filterbanks are subtracted 1 to remove +1 for lua indexing")
        parser.add_argument("--specaugment", action="store_true", default=False)
        parser.add_argument("--frequency-masking-pars", type=int, default=13,
                            help="Maximum number of frequencies that can be masked")
        parser.add_argument("--time-masking-pars", type=int, default=13,
                            help="Maximum number of time steps that can be masked")
        parser.add_argument("--frequency-masking-num", type=int, default=2,
                            help="Number of masks to apply along the frequency dimension")
        parser.add_argument("--time-masking-num", type=int, default=2,
                            help="Number of masks to apply along the time dimension")
        parser.add_argument("--specaugment-rate", type=float, default=1.0,
                            help="Probability to apply specaugment to a spectrogram")
        parser.add_argument("--time-stretch", action="store_true",
                            help="If set, activates time stretch on spectrograms")
        parser.add_argument("--time-stretch-rate", type=float, default=1.0,
                            help="Probability to apply time stretch to a spectrogram")
        parser.add_argument("--time-stretch-w", type=int, default=1, help="Window size for time stretch")
        parser.add_argument("--time-stretch-low", type=float, default=0.8, help="Low side of the stretch range")
        parser.add_argument("--time-stretch-high", type=float, default=1.25, help="High side of the stretch range")

    def __init__(self, args, tgt_dict):
        super().__init__(args)
        self.tgt_dict = tgt_dict
        self.paths = getattr(args, "data", "").split(os.pathsep)
        sa, ts = SpecAugmentConfig(), TimeStretchConfig()
        self.specaugment_cfg = SpecAugmentConfig(
            frequency_masking_pars=getattr(args, "frequency_masking_pars", sa.frequency_masking_pars),
            time_masking_pars=getattr(args, "time_masking_pars", sa.time_masking_pars),
            frequency_masking_num=getattr(args, "frequency_masking_num", sa.frequency_masking_num),
            time_masking_num=getattr(args, "time_masking_num", sa.time_masking_num),
            rate=getattr(args, "specaugment_rate", sa.rate),
        ) if getattr(args, "specaugment", False) else None
        self.time_stretch_cfg = TimeStretchConfig(
            rate=getattr(args, "time_stretch_rate", ts.rate),
            w=getattr(args, "time_stretch_w", ts.w),
            low=getattr(args, "time_stretch_low", ts.low),
            high=getattr(args, "time_stretch_high", ts.high),
        ) if getattr(args, "time_stretch", False) else None

    @classmethod
    def setup_task(cls, args, **kwargs):
        dict_basename = "dict.txt" if args.target_lang is None else "dict.{}.txt".format(args.target_lang)
        dict_path = os.path.join(args.data.split(os.pathsep)[0], dict_basename)
        if not os.path.isfile(dict_path):
            raise FileNotFoundError("Dict not found: {}".format(dict_path))
        tgt_dict = Dictionary.load(dict_path)
        if getattr(args, "criterion", None) == "ctc_loss":
            tgt_dict.add_symbol("<ctc_blank>")
        elif getattr(args, "criterion", None) == "asg_loss":
            # the replabel symbols must be dictionary entries, or packing
            # would map them to <unk> (JAX :136-143, reference
            # tasks/speech_recognition.py:168-170)
            for i in range(1, getattr(args, "max_replabel", 2) + 1):
                tgt_dict.add_symbol(replabel_symbol(i))
        logger.info("dictionary: {} types".format(len(tgt_dict)))
        return cls(args, tgt_dict, **kwargs)

    def load_dataset(self, split, combine=False, **kwargs):
        datasets = []
        for path in self.paths:
            try:
                if getattr(self.args, "dataset_from_json", False):
                    # the JSON route (JAX :151-163): <split>.json of
                    # asr_prep_json, features made from the audio on the fly
                    datasets.append(get_asr_dataset_from_json(
                        os.path.join(path, "{}.json".format(split)), self.tgt_dict,
                        getattr(self.args, "skip_normalization", False),
                        num_mel_bins=getattr(self.args, "input_feat_per_channel", 80)))
                    continue
                datasets.append(get_datasets_from_indexed_filterbanks(
                    path, self.args.target_lang, self.tgt_dict, split, getattr(self.args, "dataset_impl", None),
                    getattr(self.args, "skip_normalization", False),
                    getattr(self.args, "legacy_audio_fix_lua_indexing", False)))
            except FileNotFoundError:
                logger.warning("Split {} not found in {}. Skipping...".format(split, path))
        if not datasets:
            raise FileNotFoundError(f"no data found for split {split}")
        self.datasets[split] = ConcatDataset(datasets) if len(datasets) > 1 else datasets[0]

    def augment_batch(self, batch, generator):
        """TimeStretch, then SpecAugment, on the device batch's
        ``src_tokens`` and ``src_lengths``, each drawn from ``generator``'s
        device generator."""
        if self.time_stretch_cfg is None and self.specaugment_cfg is None:
            return batch
        gen = device_generator(generator)
        batch = dict(batch)
        x, lengths = batch["src_tokens"], batch["src_lengths"]
        if self.time_stretch_cfg is not None:
            x, lengths = time_stretch(gen, x, lengths, self.time_stretch_cfg)
        if self.specaugment_cfg is not None:
            x = specaugment(gen, x, self.specaugment_cfg)
        batch["src_tokens"], batch["src_lengths"] = x, lengths
        return batch

    @property
    def target_dictionary(self):
        return self.tgt_dict

    def max_positions(self):
        return (getattr(self.args, "max_source_positions", 1024), getattr(self.args, "max_target_positions", 1024))
