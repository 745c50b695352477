"""Task base class: the component factory of the train step.

Counterpart of ``fbk_fairseq_st_tpu/tasks/base.py`` as far as the train
step needs it: ``build_model`` (any family of ``models.ARCHITECTURES``),
``build_criterion`` and the ``augment_batch`` hook (identity here).
Datasets, batch iterators and the generator factory come with the wiring
(ROADMAP Queue A9).
"""

from __future__ import annotations

from ..criterions import CRITERIONS, NOT_YET
from ..device import DeviceLike
from ..models import arch_defaults, build_model


class Task:
    def __init__(self, args):
        self.args = args

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
        if name in NOT_YET:
            raise NotImplementedError(f"--criterion {name}: needs {NOT_YET[name]}")
        if name not in CRITERIONS:
            raise NotImplementedError(f"--criterion {name} is not ported (ROADMAP Queue A10)")
        return CRITERIONS[name].build_criterion(args, self)

    def augment_batch(self, batch, generator):
        """Training-time augmentation of the device batch (identity)."""
        return batch

    @property
    def source_dictionary(self):
        return None

    @property
    def target_dictionary(self):
        return None
