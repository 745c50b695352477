"""Lightweight and dynamic convolutions (Wu et al. 2019, Pay Less Attention).

Counterpart of ``fbk_fairseq_st_tpu/ops/lightconv.py``:

  * lightweight conv: per-head kernels (H, K), optionally softmax-normalized
    over K, shared by the C/H channels of each head, depthwise over time;
  * dynamic conv: per-position kernels predicted from the input (or a
    ``query``) by a linear layer C -> H*K, softmax over K in fp32, then
    cast to x's type.

The JAX package computes the lightweight conv and both incremental steps
as einsums outside Pallas, and so does the port, in plain PyTorch. The
full-sequence dynamic conv takes ``use_kernel`` (JAX's ``use_pallas``):
True, the default, routes it to ``ops/kernels/dynamic_conv.py::dynamic_conv``
(the CUDA kernels for CUDA tensors, their plain versions on the CPU), False
to the plain unfold + einsum on any device, for route cross-checks. Weight
dropout acts on the kernels before the band product, outside the CUDA
kernel.

The modules hold the JAX tree's leaves under its names: ``weight`` (H, K)
of a lightweight conv, ``weight_linear`` of a dynamic conv, and ``bias``
(C,) when the conv has one.
"""

from __future__ import annotations

import torch
from torch import nn

from .core import GeneratorLike, Linear, dropout, normal_
from .kernels import dynamic_conv as dconv


class LightweightConv(nn.Module):
    def __init__(self, conv_dim: int, kernel_size: int, num_heads: int, bias: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(num_heads, kernel_size))
        self.bias = nn.Parameter(torch.zeros(conv_dim)) if bias else None

    def init(self, generator: torch.Generator) -> None:
        normal_(self.weight, generator, 0.02)
        if self.bias is not None:
            nn.init.zeros_(self.bias)


class DynamicConv(nn.Module):
    def __init__(self, conv_dim: int, kernel_size: int, num_heads: int, bias: bool = False):
        super().__init__()
        self.weight_linear = Linear(conv_dim, num_heads * kernel_size)
        self.bias = nn.Parameter(torch.zeros(conv_dim)) if bias else None

    def init(self, generator: torch.Generator) -> None:
        self.weight_linear.init(generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)


def _add_bias(conv, out):
    return out if conv.bias is None else out + conv.bias.to(out.dtype)


def _lightweight_weights(conv: LightweightConv, weight_softmax: bool, dtype):
    w = conv.weight.float()
    if weight_softmax:
        w = torch.softmax(w, dim=-1)
    return w.to(dtype)


def lightweight_conv(conv: LightweightConv, x, kernel_size: int, num_heads: int, padding_l: int,
                     weight_softmax: bool = True, weight_dropout: float = 0.0,
                     generator: GeneratorLike = None, training: bool = False):
    """x: (B, T, C) -> (B, T, C)."""
    b, t, c = x.shape
    w = dropout(_lightweight_weights(conv, weight_softmax, x.dtype), weight_dropout, generator, training)
    win = dconv.unfold(x, kernel_size, padding_l).reshape(b, t, kernel_size, num_heads, c // num_heads)
    return _add_bias(conv, torch.einsum("hk,btkhd->bthd", w, win).reshape(b, t, c))


def dynamic_conv(conv: DynamicConv, x, kernel_size: int, num_heads: int, padding_l: int,
                 weight_softmax: bool = True, weight_dropout: float = 0.0,
                 generator: GeneratorLike = None, training: bool = False, query=None,
                 use_kernel: bool = True):
    """x: (B, T, C) -> (B, T, C); kernels predicted per position from
    ``query`` (x when None)."""
    b, t, c = x.shape
    if query is None:
        query = x
    w = conv.weight_linear(query).reshape(b, t, num_heads, kernel_size)
    if weight_softmax:
        w = torch.softmax(w.float(), dim=-1).to(x.dtype)
    w = dropout(w, weight_dropout, generator, training)
    band = dconv.dynamic_conv if use_kernel else dconv.dynamic_conv_reference
    return _add_bias(conv, band(x, w, padding_l))


def lightweight_conv_step(conv: LightweightConv, x_window, kernel_size: int, num_heads: int,
                          weight_softmax: bool = True):
    """Incremental step: x_window (B, K, C), the last K inputs with the
    current one last -> (B, C). Matches causal padding_l = K - 1."""
    b, k, c = x_window.shape
    w = _lightweight_weights(conv, weight_softmax, x_window.dtype)
    win = x_window.reshape(b, k, num_heads, c // num_heads)
    return _add_bias(conv, torch.einsum("hk,bkhd->bhd", w, win).reshape(b, c))


def dynamic_conv_step(conv: DynamicConv, x_window, kernel_size: int, num_heads: int,
                      weight_softmax: bool = True, query=None):
    """Incremental step of the dynamic conv: the kernel is predicted from
    the current position (the window's last element) unless ``query``."""
    b, k, c = x_window.shape
    if query is None:
        query = x_window[:, -1]
    w = conv.weight_linear(query).reshape(b, num_heads, kernel_size)
    if weight_softmax:
        w = torch.softmax(w.float(), dim=-1).to(x_window.dtype)
    win = x_window.reshape(b, k, num_heads, c // num_heads)
    return _add_bias(conv, torch.einsum("bhk,bkhd->bhd", w, win).reshape(b, c))
