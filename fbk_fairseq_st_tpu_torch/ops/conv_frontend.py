"""Convolutional audio frontend: strided 2-D convs + 2-D conv attention.

Counterpart of ``fbk_fairseq_st_tpu/ops/conv_frontend.py`` (the unchunked
loop, :243-265, and ``conv_attention_2d``, :326-441). The public functions
keep the JAX layouts — ``conv_frontend`` takes (B, T, F) and returns
(B, T', C*F), ``conv_attention_2d`` takes and returns (B, T, F, C) — while
the modules compute in NCHW, PyTorch's convolution layout.

Semantics kept:
  * each conv has stride 2 on time and frequency; odd kernels pad k//2 on
    both sides, even kernels ((k-1)//2, k//2); lengths become ceil(len/2);
  * activation BEFORE BatchNorm, then dropout at max(p, 0.1);
  * ConvAttention2D: one packed 3x3 conv gives q|k|v head channels, q is
    scaled by C**-0.5 before BN+ReLU, time attention (over T, padded keys
    masked) goes through the flash route with scale 1.0 and, in training,
    the kernel's dropout at ``dropout_p`` (one seed per call from the run's
    CPU generator), frequency attention (over F, no mask) is dense, then a
    3x3 out conv + BN + ReLU;
    the frontend adds the residual around each block;
  * the channels-major flatten (B, C, T, F) -> (B, T, C*F).

The batch-time rechunked pipeline of the JAX module
(``_conv_pipeline_chunked``) is an exact re-layout for TPU tiling and is
not ported (ROADMAP Queue A4).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .attention import flash_enabled, key_bias
from .core import (
    NEG_INF,
    BatchNorm,
    GeneratorLike,
    draw_seed,
    dropout,
    get_activation,
    normal_,
    xavier_uniform_,
)
from .kernels.flash_attention import flash_attention


class ConvFrontendConfig(NamedTuple):
    # ((out_channels, k_time, k_freq), ...) — reference encoder_convolutions
    convolutions: Tuple[Tuple[int, int, int], ...] = ((64, 3, 3), (64, 3, 3))
    audio_features: int = 40
    dropout: float = 0.3
    activation: str = "relu"
    attn_2d: bool = True
    attn_2d_heads: int = 4
    stride: int = 2

    @property
    def out_channels(self) -> int:
        return self.convolutions[-1][0]

    @property
    def flat_dim(self) -> int:
        """C * ceil(F / stride^n) — input dim of the fc3 projection."""
        f = self.audio_features
        for _ in self.convolutions:
            f = math.ceil(f / self.stride)
        return f * self.out_channels

    def out_length(self, t: int) -> int:
        for _ in self.convolutions:
            t = math.ceil(t / self.stride)
        return t


def _same_pad(k: int) -> Tuple[int, int]:
    return (k // 2, k // 2) if k % 2 == 1 else ((k - 1) // 2, k // 2)


def _conv2d(x, weight, bias, stride: int, pad_t: Tuple[int, int], pad_f: Tuple[int, int]):
    """NCHW conv with (possibly asymmetric) zero padding on T and F."""
    weight = weight.to(x.dtype)
    bias = None if bias is None else bias.to(x.dtype)
    if pad_t[0] == pad_t[1] and pad_f[0] == pad_f[1]:
        return F.conv2d(x, weight, bias, stride=stride, padding=(pad_t[0], pad_f[0]))
    x = F.pad(x, (pad_f[0], pad_f[1], pad_t[0], pad_t[1]))
    return F.conv2d(x, weight, bias, stride=stride)


# ---------------------------------------------------------------------------
# ConvAttention2D
# ---------------------------------------------------------------------------

class ConvAttention2D(nn.Module):
    """Self-attention over time and over frequency of a (B, C, T, F) map."""

    def __init__(self, embed_dim: int, num_heads: int, bias: bool = True):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        # one packed conv producing q|k|v head channels
        self.in_proj_weight = nn.Parameter(torch.zeros(3 * num_heads, embed_dim, 3, 3))
        if bias:
            self.in_proj_bias = nn.Parameter(torch.zeros(3 * num_heads))
        else:
            self.register_parameter("in_proj_bias", None)
        self.out_proj = nn.Conv2d(2 * num_heads, embed_dim, 3, padding=1, bias=bias)
        self.bn_q = BatchNorm(num_heads)
        self.bn_k = BatchNorm(num_heads)
        self.bn_v = BatchNorm(num_heads)
        self.bn_out = BatchNorm(embed_dim)

    def init(self, generator: torch.Generator) -> None:
        c, h = self.embed_dim, self.num_heads
        xavier_uniform_(self.in_proj_weight, generator, 9 * c, 9 * 3 * h)
        xavier_uniform_(self.out_proj.weight, generator, 9 * 2 * h, 9 * c)
        for bias in (self.in_proj_bias, self.out_proj.bias):
            if bias is not None:
                nn.init.zeros_(bias)
        for bn in (self.bn_q, self.bn_k, self.bn_v, self.bn_out):
            bn.init()

    def forward(self, x, key_padding_mask=None, dropout_p: float = 0.0,
                generator: GeneratorLike = None):
        """x: (B, C, T, F); key_padding_mask: (B, T) True at pads.
        Returns (B, C, T, F) (without the residual)."""
        b, c, t, f = x.shape
        h = self.num_heads
        qkv = _conv2d(x, self.in_proj_weight, self.in_proj_bias, 1, (1, 1), (1, 1))
        q, k, v = qkv.split(h, dim=1)  # each (B, H, T, F)
        q = q * float(c) ** -0.5
        q = F.relu(self.bn_q(q))
        k = F.relu(self.bn_k(k))
        v = F.relu(self.bn_v(v))

        # time attention: contract over frequency -> (B, H, T, T); F' acts as
        # the head dim of the flash kernel (the wrapper pads it)
        dropout_active = self.training and dropout_p > 0.0 and generator is not None
        if flash_enabled(x):
            attn_t = flash_attention(
                q.reshape(b * h, t, f),
                k.reshape(b * h, t, f),
                v.reshape(b * h, t, f),
                key_bias(key_padding_mask, b, t, h, x.device),
                1.0,  # q is pre-scaled above
                dropout_rate=dropout_p if dropout_active else 0.0,
                dropout_seed=draw_seed(generator) if dropout_active else None,
            ).reshape(b, h, t, f)
        else:
            wt = torch.matmul(q.float(), k.float().transpose(-1, -2))
            if key_padding_mask is not None:
                wt = torch.where(key_padding_mask[:, None, None, :], NEG_INF, wt)
            wt = torch.softmax(wt, dim=-1).to(x.dtype)
            wt = dropout(wt, dropout_p, generator, self.training)
            attn_t = torch.matmul(wt, v)

        # frequency attention: contract over time -> (B, H, F, F)
        wf = torch.matmul(q.float().transpose(-1, -2), k.float())
        wf = torch.softmax(wf, dim=-1).to(x.dtype)
        wf = dropout(wf, dropout_p, generator, self.training)
        attn_f = torch.matmul(v, wf.transpose(-1, -2))

        # concat over heads -> (B, 2H, T, F), fuse with the 3x3 out conv
        attn = torch.cat([attn_t, attn_f], dim=1)
        out = _conv2d(attn, self.out_proj.weight, self.out_proj.bias, 1, (1, 1), (1, 1))
        return F.relu(self.bn_out(out))


def conv_attention_2d(block: ConvAttention2D, x, key_padding_mask=None,
                      dropout_p: float = 0.0, generator: GeneratorLike = None):
    """JAX-layout entry: x (B, T, F, C) -> (B, T, F, C)."""
    y = block(x.permute(0, 3, 1, 2), key_padding_mask, dropout_p, generator)
    return y.permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# Frontend
# ---------------------------------------------------------------------------

class ConvFrontend(nn.Module):
    """The conv stack, its BatchNorms and the ConvAttention2D blocks, under
    the fork's names (``convolutions``, ``bn``, ``attn_2d``). The
    conv_transformer encoder subclasses it so those names sit at its root."""

    def __init__(self, cfg: ConvFrontendConfig):
        super().__init__()
        self.frontend_cfg = cfg
        convs, bns = [], []
        c_in = 1
        for c_out, k_t, k_f in cfg.convolutions:
            convs.append(nn.Conv2d(c_in, c_out, (k_t, k_f), stride=cfg.stride))
            bns.append(BatchNorm(c_out))
            c_in = c_out
        self.convolutions = nn.ModuleList(convs)
        self.bn = nn.ModuleList(bns)
        if cfg.attn_2d:
            self.attn_2d = nn.ModuleList(
                [ConvAttention2D(c_in, cfg.attn_2d_heads) for _ in range(2)]
            )

    def init(self, generator: torch.Generator) -> None:
        """Reference Conv2D init N(0, sqrt(4*(1-dropout)/(k_t*c_in)))."""
        for conv, bn in zip(self.convolutions, self.bn):
            c_in, k_t = conv.in_channels, conv.kernel_size[0]
            normal_(conv.weight, generator, math.sqrt(4.0 * (1.0 - self.frontend_cfg.dropout) / (k_t * c_in)))
            nn.init.zeros_(conv.bias)
            bn.init()
        if self.frontend_cfg.attn_2d:
            for blk in self.attn_2d:
                blk.init(generator)

    def forward(self, x, lengths, generator: GeneratorLike = None):
        return conv_frontend(self, x, lengths, generator)


def conv_frontend(frontend: ConvFrontend, x, lengths, generator: GeneratorLike = None):
    """x: (B, T, F) fbank, lengths (B,) -> ((B, T', C*F), new lengths)."""
    cfg = frontend.frontend_cfg
    act = get_activation(cfg.activation)
    training = frontend.training
    x = x[:, None]  # (B, 1, T, F)
    for (c_out, k_t, k_f), conv, bn in zip(cfg.convolutions, frontend.convolutions, frontend.bn):
        x = _conv2d(x, conv.weight, conv.bias, cfg.stride, _same_pad(k_t), _same_pad(k_f))
        x = bn(act(x))
        lengths = -(-lengths // cfg.stride)
        x = dropout(x, max(cfg.dropout, 0.1), generator, training)

    if cfg.attn_2d:
        t_now = x.shape[2]
        pad_mask = torch.arange(t_now, device=x.device)[None, :] >= lengths[:, None]
        for blk in frontend.attn_2d:
            x = blk(x, pad_mask, cfg.dropout, generator) + x

    b, c, t, f = x.shape
    # channels-major flattening, matching the reference's view of (B, C, T, F)
    x = x.permute(0, 2, 1, 3).reshape(b, t, c * f)
    return x, lengths
