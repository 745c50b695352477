"""multitask_conv_transformer: speech translation plus an utterance-level
classifier (COLING 2020, speaker-gender tagging).

Counterpart of ``fbk_fairseq_st_tpu/models/multitask_conv_transformer.py``
(reference examples/speech_recognition/models/
multitask_conv_transformer.py:10-49): the conv_transformer and, over its
encoder's states, ``FFNDecoderClassifier``, two linears with a ReLU
between them (``auxiliary_decoder.fc1``, ``.fc2``, the fork's names),
averaged over the encoder's time axis. The mean runs over the padded time
axis as JAX's does (:44-47), pads included: a parity choice (ROADMAP
Queue C, JAX side). With one output the classifier's probability is a
sigmoid, with more a softmax.

``forward`` returns ``((logits, extra), aux_logits)`` for
``cross_entropy_multi_task``; ``classify`` the classifier's probabilities
for ``cli/generate_multitask_classifier``. The three presets are the
conv_transformer presets' widths plus ``additional_output_size`` (1 when
none is given).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..device import DeviceLike, resolve_device
from ..ops.core import GeneratorLike, Linear
from . import conv_transformer
from .base import EncoderOut
from .conv_transformer import ConvolutionalTransformerModel, ConvTransformerEncoderConfig
from .transformer_decoder import TransformerDecoderConfig


class FFNDecoderClassifier(nn.Module):
    """reference multitask_conv_transformer.py:26-36."""

    def __init__(self, input_size: int, output_size: int):
        super().__init__()
        self.output_size = output_size
        self.fc1 = Linear(input_size, input_size)
        self.fc2 = Linear(input_size, output_size)

    def init(self, generator: torch.Generator) -> None:
        self.fc1.init(generator)
        self.fc2.init(generator)

    def forward(self, encoder_out: EncoderOut) -> torch.Tensor:
        """(B, output_size): the mean over the padded time axis."""
        return self.fc2(F.relu(self.fc1(encoder_out.encoder_out))).mean(dim=1)

    def get_normalized_probs(self, logits: torch.Tensor, log_probs: bool = False) -> torch.Tensor:
        """fp32 probabilities: a sigmoid of one output, else a softmax."""
        logits = logits.float()
        if self.output_size == 1:
            return F.logsigmoid(logits) if log_probs else torch.sigmoid(logits)
        return F.log_softmax(logits, dim=-1) if log_probs else F.softmax(logits, dim=-1)


class MultitaskConvolutionalTransformer(ConvolutionalTransformerModel):
    def __init__(self, encoder_cfg: ConvTransformerEncoderConfig, decoder_cfg: TransformerDecoderConfig,
                 additional_output_size: int):
        super().__init__(encoder_cfg, decoder_cfg)
        self.auxiliary_decoder = FFNDecoderClassifier(encoder_cfg.embed_dim, additional_output_size)

    def init(self, generator: torch.Generator) -> "MultitaskConvolutionalTransformer":
        super().init(generator)
        self.auxiliary_decoder.init(generator)
        return self

    def forward(self, batch: Dict[str, Any], generator: GeneratorLike = None):
        """batch: src_tokens, src_lengths, prev_output_tokens. Returns
        ((logits, extra), aux_logits) with the EncoderOut in ``extra``."""
        decoder_out = super().forward(batch, generator)
        return decoder_out, self.auxiliary_decoder(decoder_out[1]["encoder_out"])

    def classify(self, src_tokens, src_lengths) -> torch.Tensor:
        """The classifier's probabilities (B, output_size), fp32."""
        return self.auxiliary_decoder.get_normalized_probs(self.auxiliary_decoder(self.encode(src_tokens, src_lengths)))

    def get_auxiliary_target(self, batch, auxiliary_output):
        return batch["auxiliary_target"]


# ---------------------------------------------------------------------------
# Arch presets and construction
# ---------------------------------------------------------------------------

# arch -> (encoder dim, FFN dim, heads), JAX :129-144
ARCHITECTURES = {
    "multitask_conv_transformer": (256, 768, 4),
    "multitask_conv_transformer_big": (512, 1024, 8),
    "multitask_conv_transformer_big2": (512, 2048, 8),
}


def defaults(arch: str) -> Dict[str, Any]:
    """The options of ``arch`` with their values when none is given."""
    return dict(conv_transformer._base_defaults(*ARCHITECTURES[arch]), additional_output_size=1)


def configs(arch: str, tgt_dict, src_dict=None, **overrides
            ) -> Tuple[ConvTransformerEncoderConfig, TransformerDecoderConfig, int]:
    """Encoder and decoder configs of ``arch`` and the classifier's output
    size."""
    outputs = overrides.pop("additional_output_size", 1)
    args = conv_transformer._base_defaults(*ARCHITECTURES[arch])
    return (*conv_transformer.configs_from(args, tgt_dict, src_dict, **overrides), outputs)


def build_model(arch: str, tgt_dict, src_dict=None, device: DeviceLike = None,
                seed: int = 0, train: bool = False, **overrides) -> MultitaskConvolutionalTransformer:
    """Build ``arch`` with weights drawn from ``seed`` on ``device`` (the
    CUDA card when None; raises without one), in eval mode unless
    ``train``."""
    device = resolve_device(device)
    model = MultitaskConvolutionalTransformer(*configs(arch, tgt_dict, src_dict, **overrides))
    model.init(torch.Generator().manual_seed(seed))
    return model.to(device).train(train)
