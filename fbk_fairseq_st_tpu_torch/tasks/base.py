"""Task base class: the component factory and the data policy.

Counterpart of ``fbk_fairseq_st_tpu/tasks/base.py`` (reference
fairseq/tasks/fairseq_task.py): ``setup_task``, ``load_dataset`` and
``dataset``; ``get_batch_iterator`` (size-ordered indices, filtered by
``max_positions``, packed by ``batch_by_size``, an ``EpochBatchIterator``
over them); ``build_model`` (any family of ``models.ARCHITECTURES``),
``build_criterion``, ``build_generator`` (the search strategy the options
name, or the ``--score-reference`` scorer, as JAX
``generation/__init__.py::build_generator``),
``inference_step`` and the ``augment_batch`` hook (identity here).

Batches are padded to their own longest item unless ``bucket_shapes`` is
set: the JAX iterator's shape buckets bound XLA's compiles, and the JAX
trainer pads to them (``cli/train`` and ``cli/validate`` ask for them, so
their batches are JAX's), while ``cli/generate`` turns them off in JAX too.
``prepare_sample``, ``valid_step_extra`` and ``reduce_metrics`` are the
trainer's hooks.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ..criterions import CRITERIONS, roadmap_item
from ..data.batching import ShapeBucketer, batch_by_size, filter_by_size
from ..data.iterators import EpochBatchIterator
from ..device import DeviceLike
from ..generation import (BeamSearch, DiverseBeamSearch, DiverseSiblingsSearch, LengthConstrainedBeamSearch,
                          Sampling, SequenceGenerator, SequenceScorer)
from ..models import arch_defaults, build_model


class Task:
    def __init__(self, args):
        self.args = args
        self.datasets: Dict[str, object] = {}

    @classmethod
    def add_args(cls, parser) -> None:
        pass

    @classmethod
    def setup_task(cls, args, **kwargs) -> "Task":
        return cls(args)

    def load_dataset(self, split: str, combine: bool = False, **kwargs) -> None:
        raise NotImplementedError(f"{type(self).__name__} reads no dataset")

    def dataset(self, split: str):
        if split not in self.datasets:
            raise KeyError(f"Dataset not loaded: {split}")
        return self.datasets[split]

    def get_batch_iterator(self, dataset, max_tokens: Optional[int] = None, max_sentences: Optional[int] = None,
                           max_positions=None, ignore_invalid_inputs: bool = False,
                           required_batch_size_multiple: int = 1, seed: int = 1, num_shards: int = 1,
                           shard_id: int = 0, epoch: int = 0, bucket_shapes: bool = False) -> EpochBatchIterator:
        """Reference fairseq_task.py:107-167. With ``bucket_shapes`` each
        batch is padded to the JAX iterator's shape buckets (source and
        target lengths on a sqrt(2) grid, the batch size on a grid of
        powers of 2, ``ShapeBucketer``), as the JAX trainer pads its
        training and validation batches; without it, to its longest item,
        as JAX's ``cli/generate`` does. ``args.data_buffer_size`` batches
        are collated ahead on a background thread."""
        state = np.random.get_state()
        np.random.seed(seed)
        try:
            indices = dataset.ordered_indices()
        finally:
            np.random.set_state(state)
        size_fn = getattr(dataset, "max_component_size", dataset.size)
        if max_positions is not None:
            vec_filter = getattr(dataset, "filter_indices_by_size", None)
            if vec_filter is not None:
                indices, _ = vec_filter(indices, max_positions, raise_exception=not ignore_invalid_inputs)
            else:
                indices, _ = filter_by_size(indices, size_fn, max_positions,
                                            raise_exception=not ignore_invalid_inputs)
        num_tokens = getattr(dataset, "num_tokens_vec", None)
        batch_sampler = batch_by_size(indices, num_tokens(indices) if num_tokens is not None else dataset.num_tokens,
                                      max_tokens=max_tokens, max_sentences=max_sentences,
                                      required_batch_size_multiple=required_batch_size_multiple)
        collate_pad_fn = None
        if bucket_shapes:
            src_bucketer = ShapeBucketer(min_size=8, max_size=self.max_positions()[0])
            tgt_bucketer = ShapeBucketer(min_size=8, max_size=self.max_positions()[1])
            bsz_bucketer = ShapeBucketer(min_size=8, max_size=4096, growth=2.0)

            def collate_pad_fn(batch_indices: List[int]) -> dict:
                sizes = [size_fn(i) for i in batch_indices]
                if isinstance(sizes[0], tuple):
                    src_max, tgt_max = max(s[0] for s in sizes), max(s[1] for s in sizes)
                else:
                    src_max, tgt_max = max(sizes), 0
                return {"pad_to_src_len": src_bucketer.bucket(int(src_max)),
                        "pad_to_tgt_len": tgt_bucketer.bucket(int(tgt_max) + 1),  # + the appended eos
                        "pad_to_bsz": bsz_bucketer.bucket(len(batch_indices))}

        return EpochBatchIterator(dataset, batch_sampler, seed=seed, num_shards=num_shards, shard_id=shard_id,
                                  buffer_size=getattr(self.args, "data_buffer_size", 2), epoch=epoch,
                                  collate_pad_fn=collate_pad_fn)

    def build_model(self, args, device: DeviceLike = None):
        """The model of ``args.arch`` (any preset of ``models.ARCHITECTURES``)
        in training mode, weights from ``args.seed``, on ``device`` (the CUDA
        card when None). The arch's options are read from ``args`` under the
        JAX package's names."""
        arch = args.arch
        options = {k: getattr(args, k) for k in arch_defaults(arch) if hasattr(args, k)}
        return build_model(arch, self.target_dictionary, self.source_dictionary, device=device,
                           seed=getattr(args, "seed", 1), train=True, **options)

    def build_criterion(self, args):
        name = args.criterion
        if name not in CRITERIONS:
            raise NotImplementedError(f"--criterion {name} is not ported ({roadmap_item(name)})")
        return CRITERIONS[name].build_criterion(args, self)

    def build_generator(self, models, args):
        """The generator of the options in ``args`` (reference
        fairseq_task.py:230-313): ``SequenceScorer`` under
        --score-reference; else --sampling (with --sampling-topk/-topp),
        --diverse-beam-groups, --match-source-len or --diversity-rate pick
        the search strategy, at most one of them."""
        if getattr(args, "score_reference", False):
            return SequenceScorer(self.target_dictionary)
        sampling = getattr(args, "sampling", False)
        sampling_topk = getattr(args, "sampling_topk", -1)
        sampling_topp = getattr(args, "sampling_topp", -1.0)
        diverse_beam_groups = getattr(args, "diverse_beam_groups", -1)
        diversity_rate = getattr(args, "diversity_rate", -1)
        match_source_len = getattr(args, "match_source_len", False)
        if sum(map(int, (sampling, diverse_beam_groups > 0, match_source_len, diversity_rate > 0))) > 1:
            raise ValueError("Provided Search parameters are mutually exclusive.")
        if (sampling_topk >= 0 or sampling_topp >= 0) and not sampling:
            raise ValueError("--sampling-topk and --sampling-topp require --sampling")
        tgt_dict = self.target_dictionary
        if sampling:
            search_strategy = Sampling(tgt_dict, sampling_topk, sampling_topp)
        elif diverse_beam_groups > 0:
            search_strategy = DiverseBeamSearch(tgt_dict, diverse_beam_groups,
                                                getattr(args, "diverse_beam_strength", 0.5))
        elif match_source_len:
            search_strategy = LengthConstrainedBeamSearch(tgt_dict, min_len_a=1, min_len_b=0, max_len_a=1,
                                                          max_len_b=0)
        elif diversity_rate > -1:
            search_strategy = DiverseSiblingsSearch(tgt_dict, diversity_rate)
        else:
            search_strategy = BeamSearch(tgt_dict)
        return SequenceGenerator(
            tgt_dict,
            beam_size=getattr(args, "beam", 5),
            max_len_a=getattr(args, "max_len_a", 0),
            max_len_b=getattr(args, "max_len_b", 200),
            min_len=getattr(args, "min_len", 1),
            normalize_scores=not getattr(args, "unnormalized", False),
            len_penalty=getattr(args, "lenpen", 1),
            unk_penalty=getattr(args, "unkpen", 0),
            temperature=getattr(args, "temperature", 1.0),
            match_source_len=match_source_len,
            no_repeat_ngram_size=getattr(args, "no_repeat_ngram_size", 0),
            search_strategy=search_strategy,
            seed=getattr(args, "seed", 1),
        )

    def inference_step(self, generator, models, sample, prefix_tokens=None):
        return generator.generate(models, sample, prefix_tokens=prefix_tokens)

    def augment_batch(self, batch, generator):
        """Training-time augmentation of the device batch (identity)."""
        return batch

    def prepare_sample(self, sample, num_updates: int, training: bool = True):
        """Host-side hook on a collated sample before the trainer moves it to
        the device (JAX ``prepare_sample``; identity here)."""
        return sample

    def valid_step_extra(self, sample, trainer) -> dict:
        """Extra logging entries of a validation batch, computed on the host
        from the collated sample (JAX ``valid_step_extra``; none here: the
        validation BLEU of ``--eval-bleu`` is the translation task's,
        ``tasks/translation.py``)."""
        return {}

    def reduce_metrics(self, logging_outputs, criterion, metrics) -> None:
        """Log the summed outputs into the metrics stack through the
        criterion's ``reduce_metrics`` (reference fairseq_task.py:372-402)."""
        if hasattr(criterion, "reduce_metrics"):
            criterion.reduce_metrics(logging_outputs, metrics)

    @property
    def source_dictionary(self):
        return None

    @property
    def target_dictionary(self):
        return None

    def max_positions(self):
        return (getattr(self.args, "max_source_positions", 1024), getattr(self.args, "max_target_positions", 1024))
