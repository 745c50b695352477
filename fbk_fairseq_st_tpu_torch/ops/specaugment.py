"""SpecAugment and TimeStretch on the device, each a draw and an apply.

Counterpart of ``fbk_fairseq_st_tpu/ops/specaugment.py`` (``specaugment``
:42, ``time_stretch`` :86), which JAX runs as XLA ops inside the train
step; here plain tensor ops on the batch's device. Each is split in two:

  * a *draw* (``specaugment_draws``, ``time_stretch_draws``) takes every
    random number of a batch at once from an explicit ``torch.Generator``
    on the batch's device, so the step never syncs the host;
  * an *apply* (``specaugment_apply``, ``time_stretch_apply``) takes the
    draws and is deterministic, so JAX's own draws, replayed from its keys,
    give JAX's outputs exactly.

The distributions are JAX's (reference specaugment.py:72-112 and
time_stretch.py:41-57):

  * SpecAugment: per spectrogram applied with probability ``rate``;
    ``frequency_masking_num`` frequency masks of width floor(U[0, F_para))
    starting at randint(0, n_freq - width + 1), and ``time_masking_num``
    time masks of width floor(U[1, min(T_para, tau))) starting at
    randint(0, tau - width + 1); masks zero-fill and may overlap; tau is
    the padded batch length (the reference masks the collated tensor);
  * TimeStretch: per window of w frames, resample to
    int(U[low, high) * min(w, remaining)) frames by the rounded linspace
    of the window's indices (round half to even, in float32 as JAX's);
    ``low`` is clamped to 1.0 for an utterance under 10 frames; frames
    past the padded buffer are dropped (a fixed-shape deviation the JAX
    package shares); the new length is at least 1.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple

import torch


class SpecAugmentConfig(NamedTuple):
    frequency_masking_pars: int = 13
    time_masking_pars: int = 13
    frequency_masking_num: int = 2
    time_masking_num: int = 2
    rate: float = 1.0


class TimeStretchConfig(NamedTuple):
    rate: float = 1.0
    w: int = 1
    low: float = 0.8
    high: float = 1.25


def _randint(u: torch.Tensor, high: torch.Tensor) -> torch.Tensor:
    """randint(0, high) from U[0, 1) draws, elementwise."""
    return torch.minimum((u * high).long(), high - 1)


def specaugment_draws(generator: torch.Generator, batch: int, tau: int, n_freq: int,
                      cfg: SpecAugmentConfig) -> Dict[str, torch.Tensor]:
    """Every random number of one batch's SpecAugment, on the generator's
    device: ``apply`` (B,) bool; ``f_width``, ``f_start`` (B, m_F) and
    ``t_width``, ``t_start`` (B, m_T) int64."""
    device = generator.device
    m_f, m_t = cfg.frequency_masking_num, cfg.time_masking_num
    u = torch.rand((batch, 1 + 2 * (m_f + m_t)), generator=generator, device=device)
    apply = u[:, 0] < cfg.rate
    f_u, t_u = u[:, 1:1 + 2 * m_f], u[:, 1 + 2 * m_f:]
    f_width = torch.floor(f_u[:, 0::2] * float(cfg.frequency_masking_pars)).long()
    f_start = _randint(f_u[:, 1::2], n_freq - f_width + 1)
    t_max = float(min(cfg.time_masking_pars, tau))
    t_width = torch.floor(1.0 + t_u[:, 0::2] * (t_max - 1.0)).long()
    t_start = _randint(t_u[:, 1::2], tau - t_width + 1)
    return {"apply": apply, "f_width": f_width, "f_start": f_start, "t_width": t_width, "t_start": t_start}


def _span_mask(n: int, start: torch.Tensor, width: torch.Tensor) -> torch.Tensor:
    """(B, n) True inside any of the (B, M) spans [start, start + width)."""
    idx = torch.arange(n, device=start.device)[None, None, :]
    inside = (idx >= start[:, :, None]) & (idx < (start + width)[:, :, None])
    return inside.any(dim=1)


def specaugment_apply(x: torch.Tensor, draws: Dict[str, torch.Tensor]) -> torch.Tensor:
    """x (B, T, F) padded fbank batch -> the masked batch (same shape and
    type): zero wherever a frequency or a time mask of an applied
    utterance lies."""
    b, tau, v = x.shape
    freq = _span_mask(v, draws["f_start"], draws["f_width"])  # (B, F)
    time = _span_mask(tau, draws["t_start"], draws["t_width"])  # (B, T)
    masked = (freq[:, None, :] | time[:, :, None]) & draws["apply"][:, None, None]
    return torch.where(masked, torch.zeros((), dtype=x.dtype, device=x.device), x)


def specaugment(generator: torch.Generator, x: torch.Tensor, cfg: SpecAugmentConfig) -> torch.Tensor:
    """Draw and apply SpecAugment on x (B, T, F)."""
    return specaugment_apply(x, specaugment_draws(generator, x.shape[0], x.shape[1], x.shape[2], cfg))


def time_stretch_draws(generator: torch.Generator, lengths: torch.Tensor, t: int,
                       cfg: TimeStretchConfig) -> Dict[str, torch.Tensor]:
    """Every random number of one batch's TimeStretch, on the generator's
    device: ``apply`` (B,) bool and ``u`` (B, n_windows) float32, each
    window's stretch factor in [low, high), low clamped to 1.0 for an
    utterance under 10 frames."""
    device = generator.device
    n_windows = (t + cfg.w - 1) // cfg.w
    u = torch.rand((lengths.shape[0], 1 + n_windows), generator=generator, device=device)
    low = torch.where(lengths.to(device) < 10, max(cfg.low, 1.0), cfg.low).float()[:, None]
    return {"apply": u[:, 0] < cfg.rate, "u": low + u[:, 1:] * (cfg.high - low)}


def time_stretch_apply(x: torch.Tensor, lengths: torch.Tensor, draws: Dict[str, torch.Tensor],
                       cfg: TimeStretchConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, T, F), lengths (B,) -> (stretched (B, T, F), new lengths),
    JAX's index arithmetic in float32 and int32 step for step."""
    b, t, f = x.shape
    w = cfg.w
    n_windows = (t + w - 1) // w
    max_per_win = math.ceil(cfg.high * w) + 1
    device = x.device
    length = lengths.to(device=device, dtype=torch.int32)[:, None]  # (B, 1)
    win_idx = torch.arange(n_windows, device=device, dtype=torch.int32)[None, :]
    win_start = win_idx * w
    avail = torch.minimum(torch.clamp(length - win_start, min=0), torch.tensor(w, dtype=torch.int32, device=device))
    sizes = torch.where(avail > 0, (draws["u"] * avail.float()).to(torch.int32), 0)
    sizes = torch.minimum(sizes, torch.tensor(max_per_win, dtype=torch.int32, device=device))
    win_end = torch.minimum(length, w * (win_idx + 1))

    # the rounded linspace(start, end - 1, size) of each window
    j = torch.arange(max_per_win, device=device, dtype=torch.int32)[None, None, :]
    start, end, s = win_start[:, :, None], win_end[:, :, None], sizes[:, :, None]
    denom = torch.clamp(s - 1, min=1)
    span = (end - 1) - start
    ids = torch.round(start.float() + (span * j).float() / denom.float()).to(torch.int32)
    ids = torch.where(s == 1, start, ids)
    valid = j < s  # (B, n_w, max_per_win)

    # compact the valid (window, slot) pairs to output positions
    flat_valid = valid.reshape(b, -1)
    flat_ids = ids.reshape(b, -1).long().clamp(0, t - 1)
    out_pos = torch.cumsum(flat_valid.long(), dim=1) - 1
    new_length = torch.clamp(flat_valid.long().sum(dim=1), min=1).clamp(max=t)
    scatter_to = torch.where(flat_valid & (out_pos < t), out_pos, t)
    gathered = x.gather(1, flat_ids[:, :, None].expand(-1, -1, f))
    gathered = torch.where(flat_valid[:, :, None], gathered, torch.zeros((), dtype=x.dtype, device=device))
    out = torch.zeros((b, t + 1, f), dtype=x.dtype, device=device)
    out.scatter_(1, scatter_to[:, :, None].expand(-1, -1, f), gathered)
    out = out[:, :t]
    apply = draws["apply"]
    return (torch.where(apply[:, None, None], out, x),
            torch.where(apply, new_length, lengths.to(device=device, dtype=torch.long)))


def time_stretch(generator: torch.Generator, x: torch.Tensor, lengths: torch.Tensor,
                 cfg: TimeStretchConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Draw and apply TimeStretch on x (B, T, F) of ``lengths`` frames."""
    return time_stretch_apply(x, lengths, time_stretch_draws(generator, lengths, x.shape[1], cfg), cfg)
