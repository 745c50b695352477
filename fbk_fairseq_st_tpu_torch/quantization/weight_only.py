"""Weight-only int8 quantisation for serving.

Counterpart of ``fbk_fairseq_st_tpu/quantization/weight_only.py``: a
linear's weight is stored as int8 with an fp32 scale per output channel
(max |w| / 127, round to nearest even), and dequantised at its use site
(JAX ``ops/core.py::weight_of`` :91-113): int8 -> the compute type, then
x scale in the compute type (bf16 under ``--bf16``, as JAX's
``wq.astype(dtype) * scale.astype(dtype)``). The port's weight is (out,
in), so its int8 codes are JAX's transposed and its scale (out, 1) lies
on dim 0.

The layers quantised are JAX's ``_is_linear_leaf`` set under the port's
names: the ``nn.Linear`` modules (a bias or none; an ``nn.Linear`` holds
nothing else) whose 2-D weight has at least ``MIN_SIZE`` elements and
whose name holds neither ``embed`` nor ``adaptive`` (the embeddings and
the adaptive input / softmax trees, which are gathered or transposed, not
multiplied through a linear); convolutions are not ``nn.Linear`` (JAX:
their rank excludes them), and a decoder's ``output_projection`` is JAX's
bare ``embed_out`` leaf, no linear's dict, which JAX leaves in fp32.
``--quantize-weights int8`` on ``cli/generate``, ``cli/infer`` and
``cli/interactive`` applies it to the loaded ensemble
(``maybe_quantize_ensemble``).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

SKIP_PATH_PATTERNS: Tuple[str, ...] = ("embed", "adaptive", "output_projection")
MIN_SIZE = 4096


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, in) weight -> (int8 codes, fp32 scale (out, 1)): symmetric per
    output channel, scale_o = max_i |w_oi| / 127 (1 where that is 0)."""
    w = w.detach().float()
    scale = w.abs().amax(dim=1, keepdim=True) / 127.0
    scale = torch.where(scale == 0.0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return q, scale


class Int8Linear(nn.Module):
    """A linear with int8 ``weight_q`` (out, in) and fp32 ``weight_scale``
    (out, 1) buffers and the float ``bias``; ``weight_as(dtype)`` is the
    dequantised weight, which ``forward`` multiplies."""

    def __init__(self, weight_q: torch.Tensor, weight_scale: torch.Tensor, bias=None):
        super().__init__()
        self.out_features, self.in_features = weight_q.shape
        self.register_buffer("weight_q", weight_q)
        self.register_buffer("weight_scale", weight_scale)
        self.bias = bias

    @classmethod
    def from_linear(cls, linear: nn.Linear) -> "Int8Linear":
        q, scale = quantize_weight(linear.weight)
        return cls(q, scale, linear.bias)

    def weight_as(self, dtype: torch.dtype) -> torch.Tensor:
        return self.weight_q.to(dtype) * self.weight_scale.to(dtype)

    @property
    def weight(self) -> torch.Tensor:
        return self.weight_as(torch.float32)

    def forward(self, x):
        return F.linear(x, self.weight_as(x.dtype), None if self.bias is None else self.bias.to(x.dtype))

    def extra_repr(self) -> str:
        return f"in_features={self.in_features}, out_features={self.out_features}, bias={self.bias is not None}"


def weight_of(module: nn.Module, dtype: torch.dtype) -> torch.Tensor:
    """A linear's weight in ``dtype``, dequantised (int8) or rebuilt (iPQ)
    at the use site when the module stores it so."""
    if hasattr(module, "weight_as"):
        return module.weight_as(dtype)
    return module.weight.to(dtype)


def linear_layers(model: nn.Module, min_size: int = MIN_SIZE) -> List[str]:
    """The names of the linears weight-only int8 takes, in module order."""
    return [name for name, m in model.named_modules()
            if isinstance(m, nn.Linear) and m.weight.dim() == 2 and m.weight.numel() >= min_size
            and not any(s in name for s in SKIP_PATH_PATTERNS)]


def swap_module(model: nn.Module, name: str, new: nn.Module) -> None:
    parent, _, attr = name.rpartition(".")
    setattr(model.get_submodule(parent) if parent else model, attr, new)


def quantize_linear_weights(model: nn.Module, min_size: int = MIN_SIZE) -> Dict[str, object]:
    """Swap the eligible linears of ``model`` for ``Int8Linear``s in place;
    the stats of JAX's ``quantize_linear_weights`` and the names."""
    names = linear_layers(model, min_size)
    stats = {"quantized": 0, "bytes_before": 0, "bytes_after": 0, "names": names}
    for name in names:
        linear = model.get_submodule(name)
        q = Int8Linear.from_linear(linear)
        swap_module(model, name, q)
        stats["quantized"] += 1
        stats["bytes_before"] += linear.weight.numel() * 4
        stats["bytes_after"] += q.weight_q.numel() + q.weight_scale.numel() * 4
    return stats


def maybe_quantize_ensemble(models, args, logger=None):
    """``--quantize-weights`` on a loaded ensemble (in place)."""
    mode = getattr(args, "quantize_weights", None)
    if not mode or mode == "none":
        return models
    if mode != "int8":
        raise ValueError(f"unsupported --quantize-weights {mode!r}")
    for model in models:
        stats = quantize_linear_weights(model)
        if logger is not None:
            logger.info("weight-only int8: %d linears, %.1f MB -> %.1f MB", stats["quantized"],
                        stats["bytes_before"] / 1e6, stats["bytes_after"] / 1e6)
    return models
