"""PyTorch/CUDA port of fbk_fairseq_st_tpu for NVIDIA Hopper (H100).

The JAX package ``fbk_fairseq_st_tpu`` is the reference; this package keeps
its module layout and names so each module's counterpart is easy to find.
It imports ``torch`` and ``numpy`` only — never ``jax`` and nothing of the
JAX package.

Implemented: serving and training of the ``conv_transformer`` family
(fbank frames in) and of the ``lightconv``/``dynamicconv`` family (token
ids in), every preset in ``models.ARCHITECTURES``::

    from fbk_fairseq_st_tpu_torch.models import build_model
    from fbk_fairseq_st_tpu_torch.generation import SequenceGenerator

    model = build_model("conv_transformer", tgt_dict, input_feat_per_channel=80)
    hypos = SequenceGenerator(tgt_dict, beam_size=5).generate([model], sample)

and ``train.Trainer`` with a task from ``tasks`` for the train step. A
corpus and a checkpoint on disk decode through ``cli/generate``::

    python -m fbk_fairseq_st_tpu_torch.cli.generate DATA --task speech_translation_with_transcription \
        -s en -t de --path checkpoint.pt --beam 5

Entry points run on the CUDA card unless the caller passes ``device="cpu"``.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
