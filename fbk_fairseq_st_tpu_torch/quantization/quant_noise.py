"""Quant-noise: random weight blocks dropped in training, so that the model
stands a later block quantisation ("Training with Quantization Noise for
Extreme Model Compression", Fan et al. 2020).

Counterpart of ``fbk_fairseq_st_tpu/quantization/quant_noise.py``
(reference fairseq/modules/quant_noise.py:10-107) and of its use in the
transformer layers (JAX ``ops/transformer_layer.py::_pq_noised`` :86-116,
applied in ``encoder_layer`` :132 and ``decoder_layer`` :368): under
``--quant-noise-pq`` a layer in training runs on copies of its fc1 / fc2
and attention q / k / v / out weights whose blocks are dropped with
probability p and the rest scaled by 1 / (1 - p). The port's ``nn.Linear``
weights are (out, in), so a mask bit covers one output unit's block of
``block_size`` input features (JAX's (in, out) weight: one bit per (in
block, out unit)); a weight whose in-features are not a multiple of the
block passes unchanged. The draws come from the run's device generator;
the bits are not JAX's.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ..ops.core import GeneratorLike, device_generator

# the projections JAX's ``_pq_noised`` sweeps in a layer, in its order
LAYER_PROJECTIONS = ("fc1", "fc2", *(f"{attn}.{proj}_proj" for attn in ("self_attn", "encoder_attn")
                                     for proj in ("q", "k", "v", "out")))


def _drop_mask(shape, p: float, generator: GeneratorLike, device) -> torch.Tensor:
    return torch.rand(shape, generator=device_generator(generator), device=device) < p


def quant_noise(w, p: float, block_size: int, generator: GeneratorLike = None, deterministic: bool = False,
                drop: Optional[torch.Tensor] = None):
    """Drop size-``block_size`` blocks of the last axis with probability p
    and rescale by 1 / (1 - p) (JAX ``quant_noise``); ``drop`` (the last
    axis in blocks) is the mask, drawn from ``generator`` when None."""
    if p <= 0 or deterministic:
        return w
    in_features = w.shape[-1]
    if in_features % block_size != 0:
        raise ValueError("in_features must be a multiple of block_size")
    if drop is None:
        drop = _drop_mask(w.shape[:-1] + (in_features // block_size,), p, generator, w.device)
    drop = drop.repeat_interleave(block_size, dim=-1)
    return torch.where(drop, 0.0, w) / (1.0 - p)


def quant_noise_linear(w, p: float, block_size: int, generator: GeneratorLike = None,
                       drop: Optional[torch.Tensor] = None):
    """``--quant-noise-pq`` on an ``nn.Linear`` (out, in) weight: one mask
    bit per (out unit, in block), ``drop`` of shape (out, in / block); an
    in-feature count off the block is returned unchanged (JAX
    ``quant_noise_linear``)."""
    if p <= 0:
        return w
    out_features, in_features = w.shape
    if in_features % block_size != 0:
        return w
    if drop is None:
        drop = _drop_mask((out_features, in_features // block_size), p, generator, w.device)
    drop = drop.repeat_interleave(block_size, dim=1)
    return (torch.where(drop, 0.0, w) / (1.0 - p)).to(w.dtype)


def noised_layer_weights(layer: nn.Module, p: float, block_size: int,
                         generator: GeneratorLike) -> Dict[str, torch.Tensor]:
    """The block-dropped copies of a layer's projection weights, by
    parameter name (a quantised projection, int8 or iPQ, is left as it is)."""
    out = {}
    for name in LAYER_PROJECTIONS:
        try:
            module = layer.get_submodule(name)
        except AttributeError:
            continue
        if isinstance(module, nn.Linear):
            out[f"{name}.weight"] = quant_noise_linear(module.weight, p, block_size, generator)
    return out


class QuantNoiseMixin:
    """A transformer layer's ``--quant-noise-pq``: ``pq_noised`` reruns the
    layer's call on noised weights (``torch.func.functional_call``) when the
    layer trains with the noise on, else gives None."""

    _noising = False

    def pq_noised(self, generator: GeneratorLike, *args, **kwargs):
        cfg = self.cfg
        if cfg.quant_noise_pq <= 0 or not self.training or generator is None or self._noising:
            return None
        weights = noised_layer_weights(self, cfg.quant_noise_pq, cfg.quant_noise_block, generator)
        self._noising = True
        try:
            return torch.func.functional_call(self, weights, args, {**kwargs, "generator": generator})
        finally:
            self._noising = False
