"""Task base class: the component factory and the data policy.

Counterpart of ``fbk_fairseq_st_tpu/tasks/base.py`` (reference
fairseq/tasks/fairseq_task.py): ``setup_task``, ``load_dataset`` and
``dataset``; ``get_batch_iterator`` (size-ordered indices, filtered by
``max_positions``, packed by ``batch_by_size``, an ``EpochBatchIterator``
over them); ``build_model`` (any family of ``models.ARCHITECTURES``),
``build_criterion``, ``build_generator`` (the search strategy the options
name, as JAX ``generation/__init__.py::build_generator``),
``inference_step`` and the ``augment_batch`` hook (identity here).

Batches are padded to their own longest item: the JAX iterator's shape
buckets (``bucket_shapes``) bound XLA's compiles and have no use here, and
``cli/generate`` turns them off in JAX too.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from ..criterions import CRITERIONS
from ..data.batching import batch_by_size, filter_by_size
from ..data.iterators import EpochBatchIterator
from ..device import DeviceLike
from ..generation import (BeamSearch, DiverseBeamSearch, DiverseSiblingsSearch, LengthConstrainedBeamSearch,
                          Sampling, SequenceGenerator)
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
                           shard_id: int = 0, epoch: int = 0) -> EpochBatchIterator:
        """Reference fairseq_task.py:107-167."""
        state = np.random.get_state()
        np.random.seed(seed)
        try:
            indices = dataset.ordered_indices()
        finally:
            np.random.set_state(state)
        if max_positions is not None:
            vec_filter = getattr(dataset, "filter_indices_by_size", None)
            if vec_filter is not None:
                indices, _ = vec_filter(indices, max_positions, raise_exception=not ignore_invalid_inputs)
            else:
                indices, _ = filter_by_size(indices, dataset.size, max_positions,
                                            raise_exception=not ignore_invalid_inputs)
        num_tokens = getattr(dataset, "num_tokens_vec", None)
        batch_sampler = batch_by_size(indices, num_tokens(indices) if num_tokens is not None else dataset.num_tokens,
                                      max_tokens=max_tokens, max_sentences=max_sentences,
                                      required_batch_size_multiple=required_batch_size_multiple)
        return EpochBatchIterator(dataset, batch_sampler, seed=seed, num_shards=num_shards, shard_id=shard_id,
                                  epoch=epoch)

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
            raise NotImplementedError(f"--criterion {name} is not ported (ROADMAP Queue A item 4)")
        return CRITERIONS[name].build_criterion(args, self)

    def build_generator(self, models, args) -> SequenceGenerator:
        """The generator of the options in ``args`` (reference
        fairseq_task.py:230-313): --sampling (with --sampling-topk/-topp),
        --diverse-beam-groups, --match-source-len or --diversity-rate pick
        the search strategy, at most one of them."""
        if getattr(args, "score_reference", False):
            raise NotImplementedError("--score-reference: the sequence scorer is not ported "
                                      "(ROADMAP Queue A item 3)")
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

    @property
    def source_dictionary(self):
        return None

    @property
    def target_dictionary(self):
        return None

    def max_positions(self):
        return (getattr(self.args, "max_source_positions", 1024), getattr(self.args, "max_target_positions", 1024))
