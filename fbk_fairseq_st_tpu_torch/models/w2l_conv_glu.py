"""wav2letter-style Conv+GLU encoder-only ASR model (``w2l_conv_glu_enc``).

Counterpart of ``fbk_fairseq_st_tpu/models/w2l_conv_glu.py`` (reference
examples/speech_recognition/models/w2l_conv_glu_enc.py:42-200,
``asr_w2l_conv_glu_encoder``): same-padded 1-D convolutions, each followed
by a GLU over the channels (halving them) and dropout, then two linears
(GLU and dropout after the first), emitting per-frame vocabulary logits
that are the model's ``encoder_out`` and ``ctc_out``. The reference
wraps every conv and linear in weight_norm, a reparameterisation of the
same function; JAX stores the plain weights, and so does the port. The
convs keep the fork's (K, C_in, C_out) ``ConvTBC`` layout, JAX's kernel
as the weight bridge copies it.

The stack must keep the frame count (JAX :79-88, the reference's
assert), so the input lengths are the emission lengths. Under
``asg_loss`` the model holds ASG's learned (V, V) transition matrix as
its parameter ``asg_transitions`` (``--asg-transitions-init`` on the
diagonal), which the criterion reads.
"""

from __future__ import annotations

import ast
import math
from types import SimpleNamespace
from typing import Any, Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..device import DeviceLike, resolve_device
from ..ops.core import ConvTBC, GeneratorLike, Linear, dropout, lengths_to_padding_mask, normal_
from .base import EncoderOut

DEFAULT_CONV_ENC_CONFIG = """[
    (400, 13, 170, 0.2),
    (440, 14, 0, 0.214),
    (484, 15, 0, 0.22898),
    (532, 16, 0, 0.2450086),
    (584, 17, 0, 0.262159202),
    (642, 18, 0, 0.28051034614),
    (706, 19, 0, 0.30014607037),
    (776, 20, 0, 0.321156295296),
    (852, 21, 0, 0.343637235966),
    (936, 22, 0, 0.367691842484),
    (1028, 23, 0, 0.393430271458),
    (1130, 24, 0, 0.42097039046),
    (1242, 25, 0, 0.450438317792),
    (1366, 26, 0, 0.481969000038),
    (1502, 27, 0, 0.51570683004),
    (1652, 28, 0, 0.551806308143),
    (1816, 29, 0, 0.590432749713),
]"""


class W2lConvGluEncoderModel(nn.Module):
    def __init__(self, vocab_size: int, input_feat: int, conv_enc_config: List[Tuple[int, int, int, float]],
                 use_asg: bool = False, asg_transitions_init: float = 0.0):
        super().__init__()
        self.conv_enc_config = conv_enc_config
        self.asg_transitions_init = asg_transitions_init
        convs, cur = [], input_feat
        for out_c, k, _pad, _dp in conv_enc_config:
            if out_c % 2 != 0:
                raise ValueError("odd # of out_channels is incompatible with GLU")
            convs.append(ConvTBC(cur, out_c, k))
            cur = out_c // 2
        self.convolutions = nn.ModuleList(convs)
        self.linears = nn.ModuleList([Linear(cur, 2 * cur), Linear(cur, vocab_size)])
        self.asg_transitions = nn.Parameter(torch.zeros(vocab_size, vocab_size)) if use_asg else None
        self.max_source_positions = 1_000_000
        self.max_target_positions = 1_000_000

    def init(self, generator: torch.Generator) -> "W2lConvGluEncoderModel":
        """wav2letter's init: N(0, sqrt(3 / fan_in)) for every conv and linear."""
        for conv, (_, k, _, _) in zip(self.convolutions, self.conv_enc_config):
            conv.init(generator, math.sqrt(3.0 / (k * conv.weight.shape[1])))
        for lin in self.linears:
            normal_(lin.weight, generator, math.sqrt(3.0 / lin.in_features))
            nn.init.zeros_(lin.bias)
        if self.asg_transitions is not None:
            with torch.no_grad():
                self.asg_transitions.copy_(self.asg_transitions_init * torch.eye(self.asg_transitions.shape[0]))
        return self

    def _forward_encoder(self, x, generator):
        """x (B, T, F) -> per-frame vocabulary logits (B, T, V)."""
        for conv, (_, _, pad, dp) in zip(self.convolutions, self.conv_enc_config):
            x = F.glu(conv(x, (pad, pad)), dim=-1)
            x = dropout(x, dp, generator, self.training)
        x = F.glu(self.linears[0](x), dim=-1)
        x = dropout(x, self.conv_enc_config[-1][3], generator, self.training)
        return self.linears[1](x)

    def encode(self, src_tokens, src_lengths, generator: GeneratorLike = None) -> EncoderOut:
        logits = self._forward_encoder(src_tokens, generator)
        padding_mask = lengths_to_padding_mask(src_lengths, logits.shape[1])
        return EncoderOut(encoder_out=logits, encoder_padding_mask=padding_mask, src_lengths=src_lengths,
                          ctc_out=logits, ctc_padding_mask=padding_mask, ctc_lengths=src_lengths)

    def forward(self, batch: Dict[str, Any], generator: GeneratorLike = None):
        enc = self.encode(batch["src_tokens"], batch["src_lengths"], generator)
        return enc.encoder_out, {"encoder_out": enc}


def w2l_conv_glu_enc(args):
    """``w2l_conv_glu_enc`` (JAX :188-193)."""
    args.input_feat_per_channel = getattr(args, "input_feat_per_channel", 80)
    args.in_channels = getattr(args, "in_channels", 1)
    args.conv_enc_config = getattr(args, "conv_enc_config", DEFAULT_CONV_ENC_CONFIG)


# JAX takes the bare model name as --arch too: its build applies the preset
ARCHITECTURES = {"w2l_conv_glu_enc": w2l_conv_glu_enc, "asr_w2l_conv_glu_encoder": w2l_conv_glu_enc}
# options another component's flags set (the criterion's), which the model reads
_CRITERION_OPTIONS = {"criterion": None, "asg_transitions_init": 0.0}


def defaults(arch: str) -> Dict[str, Any]:
    """The options of ``arch`` with their values when none is given."""
    args = SimpleNamespace()
    ARCHITECTURES[arch](args)
    return {**vars(args), **_CRITERION_OPTIONS}


def apply_preset(arch: str, args) -> None:
    ARCHITECTURES[arch](args)


def conv_config(expr) -> List[Tuple[int, int, int, float]]:
    """The conv stack's config, which must keep the frame count."""
    cfg = [tuple(t) for t in ast.literal_eval(expr or DEFAULT_CONV_ENC_CONFIG)]
    delta = sum(2 * pad - k + 1 for _, k, pad, _ in cfg)
    if delta != 0:
        raise ValueError(f"conv_enc_config must preserve sequence length (net length change {delta:+d} frames); "
                         "the reference model asserts this too")
    return cfg


def build_model(arch: str, tgt_dict, src_dict=None, device: DeviceLike = None, seed: int = 0,
                train: bool = False, **overrides) -> W2lConvGluEncoderModel:
    """Build ``arch`` with weights drawn from ``seed`` on ``device`` (the
    CUDA card when None; raises without one), in eval mode unless
    ``train``; ``asg_transitions`` when ``criterion`` is ``asg_loss``."""
    unknown = set(overrides) - set(defaults(arch))
    if unknown:
        raise TypeError(f"unknown w2l_conv_glu options: {sorted(unknown)}")
    device = resolve_device(device)
    args = SimpleNamespace(**{**_CRITERION_OPTIONS, **overrides})
    ARCHITECTURES[arch](args)
    if args.in_channels != 1:
        raise ValueError("only 1 input channel is currently supported")
    model = W2lConvGluEncoderModel(len(tgt_dict), args.input_feat_per_channel, conv_config(args.conv_enc_config),
                                   use_asg=args.criterion == "asg_loss",
                                   asg_transitions_init=args.asg_transitions_init or 0.0)
    model.init(torch.Generator().manual_seed(seed))
    return model.to(device).train(train)
