"""Building blocks: linear, LayerNorm, BatchNorm, embedding, dropout.

Counterpart of ``fbk_fairseq_st_tpu/ops/core.py``. Where the JAX module is
a set of ``init_*`` + pure functions over parameter pytrees, the port has
``nn.Module``s whose parameter names are the fork's ``state_dict`` names
(``weight``, ``bias``, ``running_mean``, ``running_var``) and plain functions
on tensors that hold the arithmetic. Compute runs in the input dtype, with
LayerNorm and BatchNorm statistics always in fp32.

Randomness is drawn from an explicit ``torch.Generator`` (or the
``Generators`` pair of a training run); the meaning of ``dropout`` is the
JAX non-TPU branch (a Bernoulli keep mask, ``x / keep``).
"""

from __future__ import annotations

import contextlib
import math
from typing import NamedTuple, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

# A large-but-finite negative for masked logits (never -inf): a fully masked
# row stays uniform after softmax instead of turning into NaNs.
NEG_INF = -1e9


# ---------------------------------------------------------------------------
# Initialisation (drawn on the CPU generator so a seed gives the same
# weights on every device)
# ---------------------------------------------------------------------------

# set while a model is built only to take a checkpoint's weights
_NO_DRAWS = [False]


@contextlib.contextmanager
def weights_from_state_dict():
    """Within the block ``xavier_uniform_`` and ``normal_`` draw nothing: a
    model built there takes every weight from a state dict that it then
    loads strictly (``train/checkpoint.py``), so the draws would be lost."""
    _NO_DRAWS[0] = True
    try:
        yield
    finally:
        _NO_DRAWS[0] = False


def xavier_uniform_(t: torch.Tensor, generator: torch.Generator, fan_in: int,
                    fan_out: int, gain: float = 1.0) -> None:
    if _NO_DRAWS[0]:
        return
    limit = gain * (6.0 / (fan_in + fan_out)) ** 0.5
    _fill(t, torch.rand(t.shape, generator=generator) * (2 * limit) - limit)


def normal_(t: torch.Tensor, generator: torch.Generator, std: float) -> None:
    if _NO_DRAWS[0]:
        return
    _fill(t, torch.randn(t.shape, generator=generator) * std)


def _fill(t: torch.Tensor, values: torch.Tensor) -> None:
    with torch.no_grad():
        t.copy_(values.to(dtype=t.dtype, device=t.device))


# ---------------------------------------------------------------------------
# Linear / embedding
# ---------------------------------------------------------------------------

def linear(x, weight, bias=None):
    """``y = x W^T + b`` with the nn.Linear (out, in) weight layout, the
    weight and bias cast to the input's type where it differs."""
    if weight.dtype != x.dtype:
        weight = weight.to(x.dtype)
    if bias is not None and bias.dtype != x.dtype:
        bias = bias.to(x.dtype)
    return F.linear(x, weight, bias)


class Linear(nn.Linear):
    """nn.Linear with the reference init: xavier-uniform weight, zero bias
    (reference conv_transformer.py Linear helper :371-376)."""

    def forward(self, x):
        return linear(x, self.weight, self.bias)

    def init(self, generator: torch.Generator) -> None:
        xavier_uniform_(self.weight, generator, self.in_features, self.out_features)
        if self.bias is not None:
            nn.init.zeros_(self.bias)


def embedding(weight, ids, dtype=None):
    w = weight if dtype is None else weight.to(dtype)
    return F.embedding(ids, w)


# ---------------------------------------------------------------------------
# LayerNorm (fp32 statistics whatever the compute dtype)
# ---------------------------------------------------------------------------

def layer_norm(x, weight, bias, eps: float = 1e-5):
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * weight + bias
    return y.to(x.dtype)


class LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        return layer_norm(x, self.weight, self.bias, self.eps)

    def init(self, generator: Optional[torch.Generator] = None) -> None:
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)


# ---------------------------------------------------------------------------
# Randomness and dropout
# ---------------------------------------------------------------------------

class Generators(NamedTuple):
    """The randomness of a training run: dropout masks are drawn on
    ``device``, a generator on the activations' device; the flash kernels'
    dropout seeds on ``host``, a CPU generator, so that taking one as a
    Python int never waits for the card."""
    device: torch.Generator
    host: torch.Generator


GeneratorLike = Union[torch.Generator, Generators, None]


def make_generators(seed: int, device) -> Generators:
    device = torch.device(device)
    host = torch.Generator().manual_seed(seed)
    if device.type == "cpu":
        return Generators(host, host)
    return Generators(torch.Generator(device=device).manual_seed(seed), host)


def device_generator(generator: GeneratorLike) -> Optional[torch.Generator]:
    return generator.device if isinstance(generator, Generators) else generator


def draw_seed(generator: GeneratorLike) -> int:
    """One 63-bit seed for a flash kernel's in-kernel dropout, drawn per
    call (the counterpart of JAX's ``rng.next()`` at each flash call)."""
    host = generator.host if isinstance(generator, Generators) else generator
    if host is None or host.device.type != "cpu":
        raise ValueError("flash dropout seeds come from a CPU generator: pass Generators "
                         "(a draw on the card would sync the host at every layer)")
    return int(torch.randint(0, 2 ** 63 - 1, (), generator=host))


def dropout(x, rate: float, generator: GeneratorLike, training: bool):
    """Inverted dropout with a Bernoulli(1 - rate) keep mask drawn from
    ``generator`` (which must live on ``x``'s device)."""
    if not training or rate == 0.0:
        return x
    generator = device_generator(generator)
    if generator is None:
        raise ValueError("dropout in training mode needs an explicit torch.Generator")
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


# ---------------------------------------------------------------------------
# Activations
# ---------------------------------------------------------------------------

# "gelu" is the tanh approximation, as jax.nn.gelu's default in the JAX
# package (the reference fairseq's "gelu" is the erf form: ROADMAP Queue C).
ACTIVATIONS = {
    "relu": F.relu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "gelu_accurate": lambda x: F.gelu(x, approximate="tanh"),
    "tanh": torch.tanh,
    "linear": lambda x: x,
    "glu": lambda x: F.glu(x, dim=-1),
}


def get_activation(name: str):
    if name not in ACTIVATIONS:
        raise KeyError(f"unknown activation {name!r}")
    return ACTIVATIONS[name]


# ---------------------------------------------------------------------------
# BatchNorm
# ---------------------------------------------------------------------------

def batch_norm(
    x,
    weight,
    bias,
    running_mean,
    running_var,
    axis: Sequence[int],
    training: bool,
    momentum: float = 0.1,
    eps: float = 1e-5,
    stats_from=None,
    group=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """BatchNorm over ``axis`` (the one remaining axis is the channel).

    Returns ``(y, new_running_mean, new_running_var)``; nothing is updated in
    place. torch.nn.BatchNorm2d semantics: biased variance normalises, the
    unbiased one enters the running estimate, ``(1-momentum)*old +
    momentum*batch``. Training statistics are one pass, ``E[x^2] - mean^2``
    clamped at 0, as in the JAX module; ``stats_from`` takes them from
    another tensor of the same layout. With a process ``group`` (the
    data-parallel ranks, each holding its rows of one global batch) the
    sums of x and x^2 and the count are all-reduced over it before the
    division, in the same one-pass form, so the statistics and the running
    update are the global batch's, as under JAX's data sharding; the
    all-reduce's backward is an all-reduce, as every rank's loss reads the
    statistics.
    """
    axis = tuple(a % x.dim() for a in axis)
    xf = x.float()
    if training:
        sf = xf if stats_from is None else stats_from.float()
        n = math.prod(sf.shape[a] for a in axis)
        if group is None:
            mean = sf.mean(dim=axis)
            meansq = sf.square().mean(dim=axis)
        else:
            from ..parallel.collectives import all_reduce_sum, group_size

            sums = all_reduce_sum(torch.stack([sf.sum(dim=axis), sf.square().sum(dim=axis)]), group)
            n *= group_size(group)
            mean, meansq = sums[0] / n, sums[1] / n
        var = torch.clamp(meansq - mean.square(), min=0.0)
        unbiased = var * (n / max(n - 1, 1))
        new_mean = (1 - momentum) * running_mean + momentum * mean
        new_var = (1 - momentum) * running_var + momentum * unbiased
    else:
        mean, var = running_mean, running_var
        new_mean, new_var = running_mean, running_var
    caxis = [a for a in range(x.dim()) if a not in axis]
    if len(caxis) != 1:
        raise ValueError(f"batch_norm needs exactly one channel axis, got axis={axis}")
    shape = [1] * x.dim()
    shape[caxis[0]] = -1
    y = (xf - mean.reshape(shape)) * torch.rsqrt(var.reshape(shape) + eps)
    y = y * weight.reshape(shape) + bias.reshape(shape)
    return y.to(x.dtype), new_mean, new_var


class BatchNorm(nn.Module):
    """Channel-first BatchNorm (NCHW, channel axis 1) with the fork's names
    and no ``num_batches_tracked`` buffer. In training mode it normalises
    with batch statistics and updates the running buffers in place; the
    statistics are over the ranks of ``sync_group`` when the trainer sets
    one (``batch_norm``'s ``group``)."""

    def __init__(self, dim: int, momentum: float = 0.1, eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.register_buffer("running_mean", torch.zeros(dim))
        self.register_buffer("running_var", torch.ones(dim))
        self.sync_group = None

    def forward(self, x):
        axis = tuple(a for a in range(x.dim()) if a != 1)
        y, mean, var = batch_norm(
            x, self.weight, self.bias, self.running_mean, self.running_var,
            axis, self.training, self.momentum, self.eps, group=self.sync_group,
        )
        if self.training:
            with torch.no_grad():
                self.running_mean.copy_(mean)
                self.running_var.copy_(var)
        return y

    def init(self, generator: Optional[torch.Generator] = None) -> None:
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)
        nn.init.zeros_(self.running_mean)
        nn.init.ones_(self.running_var)


def lengths_to_padding_mask(lengths, max_len: int):
    """True at padded positions (reference encoder_padding_mask)."""
    positions = torch.arange(max_len, device=lengths.device)[None, :]
    return positions >= lengths[:, None]


# ---------------------------------------------------------------------------
# 1-D convolution over (B, T, C) with a (K, C_in, C_out) kernel
# ---------------------------------------------------------------------------

class ConvTBC(nn.Module):
    """A time convolution whose ``weight`` has the (K, C_in, C_out) layout of
    the fork's ``ConvTBC`` / ``LinearizedConvolution`` (the JAX package's
    ``WIO`` kernel, which the weight bridge copies as it is). ``forward``
    takes (B, T, C_in) and pads ``padding = (left, right)`` zero frames
    around T; compute runs in the input dtype."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(kernel_size, in_channels, out_channels))
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def init(self, generator: torch.Generator, std: float) -> None:
        normal_(self.weight, generator, std)
        nn.init.zeros_(self.bias)

    def forward(self, x, padding: Tuple[int, int]):
        w = self.weight.to(x.dtype).permute(2, 1, 0)  # (C_out, C_in, K)
        y = F.conv1d(F.pad(x.transpose(1, 2), padding), w, self.bias.to(x.dtype))
        return y.transpose(1, 2)

    def step(self, window):
        """One output frame from the last K input frames, window (B, K, C_in)
        -> (B, C_out)."""
        w = self.weight.to(window.dtype)
        return torch.einsum("bkc,kcd->bd", window, w) + self.bias.to(window.dtype)
