"""The port's model families and the table of their arch presets.

``ARCHITECTURES`` maps each preset the port runs to its family's module,
which has ``defaults(arch)`` and ``build_model(arch, tgt_dict,
src_dict=None, device=None, seed=0, train=False, **overrides)`` (the
multilingual family takes the task's {language: Dictionary} in place of
``tgt_dict``);
``build_model`` and ``arch_defaults`` dispatch on it, and an arch that no
family has raises ``NotImplementedError``.
"""

from typing import Any, Dict

from . import (conv_transformer, conv_transformer_context, lightconv, model_parallel, multi_task,
               multilingual_conv_transformer, multitask_conv_transformer, transformer, transformer_align,
               transformer_lm, vggtransformer, w2l_conv_glu)
from .base import EncoderOut, reorder_encoder_out
from .conv_transformer import ConvolutionalTransformerModel
from .conv_transformer_context import ConvolutionalTransformerContextAwareModel
from .lightconv import LightConvModel
from .multi_task import (
    ConvolutionalTransformer2Stage,
    ConvolutionalTransformerDualDecoder,
    ConvolutionalTransformerTriangle,
    MultiTaskModel,
)
from .multilingual_conv_transformer import MultilingualConvolutionalTransformerModel
from .multitask_conv_transformer import MultitaskConvolutionalTransformer
from .transformer import TransformerModel
from .transformer_align import TransformerAlignModel
from .transformer_lm import TransformerLanguageModel
from .vggtransformer import VGGTransformerEncoderModel, VGGTransformerModel
from .w2l_conv_glu import W2lConvGluEncoderModel

ARCHITECTURES = {arch: family for family in (conv_transformer, lightconv, multi_task, multitask_conv_transformer,
                                             multilingual_conv_transformer, conv_transformer_context, vggtransformer,
                                             w2l_conv_glu, transformer, transformer_lm, transformer_align)
                 for arch in family.ARCHITECTURES}
# the model-parallel names (models/model_parallel.py) are presets of the
# text transformer and its language model
assert set(model_parallel.TRANSFORMER_ARCHS) | set(model_parallel.LM_ARCHS) <= set(ARCHITECTURES)


def _family(arch: str):
    if arch not in ARCHITECTURES:
        raise NotImplementedError(
            f"--arch {arch}: the port has the conv_transformer, lightconv, multi-decoder, multitask "
            "classifier, multilingual, context-aware, vggtransformer, w2l_conv_glu and text transformer "
            "families; the other JAX families are ROADMAP Queue A item 9")
    return ARCHITECTURES[arch]


def arch_defaults(arch: str) -> Dict[str, Any]:
    """The options ``arch`` reads, under the JAX package's arg names, with
    their values when none is given."""
    return _family(arch).defaults(arch)


def build_model(arch: str, tgt_dict, src_dict=None, **kwargs):
    """``arch``'s family's ``build_model``."""
    return _family(arch).build_model(arch, tgt_dict, src_dict, **kwargs)


__all__ = [
    "ARCHITECTURES",
    "ConvolutionalTransformer2Stage",
    "ConvolutionalTransformerContextAwareModel",
    "ConvolutionalTransformerDualDecoder",
    "ConvolutionalTransformerModel",
    "ConvolutionalTransformerTriangle",
    "EncoderOut",
    "LightConvModel",
    "MultiTaskModel",
    "MultilingualConvolutionalTransformerModel",
    "MultitaskConvolutionalTransformer",
    "TransformerAlignModel",
    "TransformerLanguageModel",
    "TransformerModel",
    "VGGTransformerEncoderModel",
    "VGGTransformerModel",
    "W2lConvGluEncoderModel",
    "arch_defaults",
    "build_model",
    "reorder_encoder_out",
]
