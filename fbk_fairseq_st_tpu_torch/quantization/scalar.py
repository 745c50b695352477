"""Scalar (int8) quantisation emulation and ``--quant-noise-scalar``.

Counterpart of ``fbk_fairseq_st_tpu/quantization/scalar.py`` (reference
fairseq/modules/quantization/scalar/ops.py:8-48): fake-quantise weights in
training so that the network adapts to int8. Observers: ``tensor`` (min /
max affine), ``channel`` (symmetric per channel: JAX's last axis, the
output units of its (in, out) linears, which is axis 0 of the port's (out,
in) ones: ``channel_axis``), ``histogram`` (min / max of the 0.1 and 99.9
percentiles, linearly interpolated in fp32 as ``jnp.percentile``). The
straight-through estimator keeps the gradient of the rounding the identity.

``--quant-noise-scalar p``: at each train step every floating parameter
of at least 256 elements is replaced, element by element with probability
p, by its int8 value, for that step's forward and backward (JAX ``Trainer
._loss_fn`` :298-305 applies it to the parameter tree inside the step):
``scalar_quant_noise_`` swaps the noised values in and hands the stored
ones back, so the gradient computed at the noised weights lands on the
stored ones, which is the STE's gradient; the stored parameters do not
change.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch
from torch import nn

from ..ops.core import GeneratorLike, device_generator

MIN_SIZE = 256  # elements: biases and norms of fewer stay as they are


def quantize(w, scale, zero_point, bits: int = 8):
    """Affine fake quantisation (reference ops.py:14-15)."""
    qmax = 2 ** bits - 1
    return (torch.clamp(torch.round(w / scale + zero_point), 0, qmax) - zero_point) * scale


def _qparams_minmax(w_min, w_max, bits: int):
    qmax = 2 ** bits - 1
    w_min = torch.clamp(w_min, max=0.0)
    w_max = torch.clamp(w_max, min=0.0)
    scale = torch.clamp((w_max - w_min) / qmax, min=1e-8)
    zero_point = torch.clamp(torch.round(-w_min / scale), 0, qmax)
    return scale, zero_point


def percentile(w, q: float):
    """``jnp.percentile(w, q)`` (linear interpolation) in fp32, as XLA
    computes it in a jitted step: the position q / 100 x (n - 1) in fp32,
    the two neighbours' weighted sum rounded once."""
    flat = torch.sort(w.reshape(-1)).values
    f32 = torch.float32
    pos = torch.tensor(q, dtype=f32) / torch.tensor(100.0, dtype=f32) * torch.tensor(flat.numel() - 1, dtype=f32)
    low, high = math.floor(float(pos)), math.ceil(float(pos))
    high_weight = pos - low
    low_weight = 1.0 - high_weight
    value = flat[low].double() * low_weight.double().item() + flat[high].double() * high_weight.double().item()
    return value.float()


def emulate_int(w, bits: int = 8, method: str = "tensor", scale=None, zero_point=None, channel_axis: int = -1):
    """(w quantised, scale, zero point), the quantised values in ``w``'s type."""
    w32 = w.float()
    if scale is None:
        if method == "tensor":
            scale, zero_point = _qparams_minmax(w32.min(), w32.max(), bits)
        elif method == "histogram":
            scale, zero_point = _qparams_minmax(percentile(w32, 0.1), percentile(w32, 99.9), bits)
        elif method == "channel":
            axis = channel_axis % w32.dim()
            amax = w32.abs()
            others = tuple(a for a in range(w32.dim()) if a != axis)
            if others:
                amax = amax.amax(dim=others, keepdim=True)
            qmax = 2 ** bits - 1
            scale = torch.clamp(2 * amax / qmax, min=1e-8)
            zero_point = torch.full_like(scale, (qmax + 1) // 2)
        else:
            raise ValueError(f"unknown scalar quantization method: {method}")
    return quantize(w32, scale, zero_point, bits).to(w.dtype), scale, zero_point


def fake_quantize(w, bits: int = 8, method: str = "tensor", channel_axis: int = -1):
    """The quantised value forward, the identity backward."""
    q, _, _ = emulate_int(w, bits, method, channel_axis=channel_axis)
    return w + (q - w).detach()


def scalar_quant_noise(w, p: float, bits: int = 8, method: str = "tensor", generator: GeneratorLike = None,
                       keep: Optional[torch.Tensor] = None, channel_axis: int = -1):
    """Each element replaced by its int8 value with probability p, the STE
    backward (JAX ``scalar_quant_noise``); ``keep`` (True where the float
    value stays) is drawn from ``generator`` when None."""
    if p <= 0:
        return w
    q, _, _ = emulate_int(w, bits, method, channel_axis=channel_axis)
    if keep is None:
        keep = torch.rand(w.shape, generator=device_generator(generator), device=w.device) < (1.0 - p)
    noise = torch.where(keep, 0.0, q - w)
    return w + noise.detach().to(w.dtype)


def _channel_axis(module: nn.Module, name: str) -> int:
    """The output units' axis of a parameter in the port's layout: 0 for the
    weights of linears and convolutions, else JAX's last axis."""
    if name == "weight" and isinstance(module, (nn.Linear, nn.modules.conv._ConvNd)):
        return 0
    return -1


@contextlib.contextmanager
def scalar_quant_noise_(model: nn.Module, p: float, generator: GeneratorLike, bits: int = 8,
                        method: str = "tensor", min_size: int = MIN_SIZE):
    """Within the block every floating parameter of ``min_size`` elements or
    more holds its noised value (each tied parameter once); on exit the
    stored values come back, and the gradients stay."""
    saved = []
    seen = set()
    with torch.no_grad():
        for module in model.modules():
            for name, param in module.named_parameters(recurse=False):
                if id(param) in seen or param.numel() < min_size or not param.is_floating_point():
                    continue
                seen.add(id(param))
                saved.append((param, param.detach().clone()))
                param.copy_(scalar_quant_noise(param, p, bits, method, generator,
                                               channel_axis=_channel_axis(module, name)))
    try:
        yield
    finally:
        with torch.no_grad():
            for param, value in saved:
                param.copy_(value)
