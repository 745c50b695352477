"""Monotonic multihead attention (MMA) for simultaneous translation.

Counterpart of ``fbk_fairseq_st_tpu/ops/monotonic_attention.py``
(reference examples/simultaneous_translation/modules/
monotonic_multihead_attention.py:26-590; Ma et al. 2020), by
``--simul-type``:

  * ``hard_aligned`` (MMA-H): the expected attention beta is the expected
    alignment alpha (:455-463);
  * ``infinite_lookback`` (MMA-IL): soft attention over the prefix up to
    the expected alignment (:466-541), with its own query and key
    projections (``q_proj_soft``, ``k_proj_soft``);
  * ``waitk``: the deterministic diagonal band of lagging k as p_choose
    (:544-590).

Activations are batch-first and the per-head tensors (B, H, T, S). The
energies are fp32 whatever the compute type (JAX :111). The expected
alignment is an exclusive cumprod of 1 - p_choose (through a log-cumsum),
then a loop over the target steps, each of which needs the last one's
alignment: JAX runs it as a ``lax.scan`` outside any Pallas kernel, and
the port as plain tensor ops (no TPU kernel stands behind it), four a
step. The clips follow JAX's gradient: ``jnp.clip`` is
``minimum(maximum(x, lo), hi)``, whose gradient at a bound is halved
(``torch.clamp`` passes all of it), which matters where the sigmoid
saturates to exactly 1 (the gradient of ``log(1 - p + 1e-10)`` there is
1e10 times that factor) and at masked keys, where p_choose is exactly 0.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
from torch import nn

from .attention import _merge_heads, _split_heads
from .core import NEG_INF, GeneratorLike, Linear, device_generator, dropout

# the reference's --simul-type registry (modules/__init__.py:10-14)
MONOTONIC_ATTENTION = ("hard_aligned", "infinite_lookback", "waitk")


class MonotonicAttentionConfig(NamedTuple):
    embed_dim: int
    num_heads: int
    simul_type: str = "hard_aligned"
    dropout: float = 0.0
    mass_preservation: bool = True
    noise_mean: float = 0.0
    noise_var: float = 1.0
    energy_bias: bool = False
    energy_bias_init: float = -2.0
    eps: float = 1e-6
    waitk_lagging: int = 0

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads


class _JaxClip(torch.autograd.Function):
    """``jnp.clip(x, lo, hi)``, i.e. ``minimum(maximum(x, lo), hi)``, in one
    op: the gradient is 1 inside the bounds, 1/2 at a bound, 0 outside."""

    @staticmethod
    def forward(ctx, x, lo, hi):
        ctx.save_for_backward(x)
        ctx.bounds = (lo, hi)
        return torch.clamp(x, lo, hi)

    @staticmethod
    def backward(ctx, grad):
        (x,) = ctx.saved_tensors
        lo, hi = ctx.bounds
        inside = torch.ones_like(x, dtype=torch.bool)
        at_bound = torch.zeros_like(inside)
        for bound, side in ((lo, torch.gt), (hi, torch.lt)):
            if bound is not None:
                inside &= side(x, bound)
                at_bound |= x == bound
        return grad * (inside.to(grad.dtype) + 0.5 * at_bound.to(grad.dtype)), None, None


def _clip(x, lo: Optional[float] = None, hi: Optional[float] = None):
    """``jnp.clip``: ``minimum(maximum(x, lo), hi)``, half the gradient at a bound."""
    if not (x.requires_grad and torch.is_grad_enabled()):
        return torch.clamp(x, lo, hi)
    return _JaxClip.apply(x, lo, hi)


def expected_alignment_train(pc, eps: float, mass_preservation: bool):
    """The expected alignment alpha (..., T, S) of p_choose ``pc`` (reference
    expected_alignment_train :98-147): an exclusive cumprod of 1 - p along
    the source, then one step a target position, each ``clip(pc_i * cp_i *
    cumsum(alpha_{i-1} / cp_clamped_i), 0, 1)`` (the first product taken
    for every step at once, in JAX's order)."""
    log1mp = torch.log(_clip(1.0 - pc, lo=0.0) + 1e-10)
    zeros = torch.zeros_like(pc[..., :1])
    cumprod_1mp = torch.exp(torch.cat([zeros, torch.cumsum(log1mp, dim=-1)[..., :-1]], dim=-1))
    cumprod_clamp = _clip(cumprod_1mp, eps, 1.0)
    prev = torch.zeros_like(pc[..., 0, :])
    prev[..., 0] = 1.0
    alphas = []
    for pcp_i, cpc_i in zip(torch.unbind(pc * cumprod_1mp, dim=-2), torch.unbind(cumprod_clamp, dim=-2)):
        prev = _clip(pcp_i * torch.cumsum(prev / cpc_i, dim=-1), 0.0, 1.0)
        alphas.append(prev)
    alpha = torch.stack(alphas, dim=-2)
    if mass_preservation:
        resid = 1.0 - _clip(alpha[..., :-1].sum(dim=-1), 0.0, 1.0)
        alpha = torch.cat([alpha[..., :-1], resid[..., None]], dim=-1)
    return alpha


def waitk_p_choose(batch: int, heads: int, tgt_len: int, src_len: int, lagging: int, device=None):
    """The wait-k band (B, H, T, S): 1 where the source position is the
    target position + k - 1 (reference :565-590)."""
    if lagging <= 0:
        raise ValueError("waitk requires --waitk-lagging > 0")
    rows = torch.arange(tgt_len, device=device)[:, None]
    cols = torch.arange(src_len, device=device)[None, :]
    band = (cols == rows + lagging - 1).to(torch.float32)
    return band.expand(batch, heads, tgt_len, src_len)


class MonotonicMultiheadAttention(nn.Module):
    """The monotonic cross-attention of a decoder layer: ``q_proj``,
    ``k_proj``, ``v_proj``, ``out_proj`` (the fork's names), an
    ``energy_bias`` with ``--energy-bias``, and ``q_proj_soft`` /
    ``k_proj_soft`` for infinite lookback (waitk shares the monotonic
    ones, :547-549)."""

    def __init__(self, cfg: MonotonicAttentionConfig):
        super().__init__()
        if cfg.simul_type not in MONOTONIC_ATTENTION:
            raise ValueError(f"unknown --simul-type {cfg.simul_type!r}: one of {MONOTONIC_ATTENTION}")
        self.cfg = cfg
        e = cfg.embed_dim
        self.q_proj = Linear(e, e)
        self.k_proj = Linear(e, e)
        self.v_proj = Linear(e, e)
        self.out_proj = Linear(e, e)
        self.energy_bias = nn.Parameter(torch.full((1,), cfg.energy_bias_init)) if cfg.energy_bias else None
        soft = cfg.simul_type == "infinite_lookback"
        self.q_proj_soft = Linear(e, e) if soft else None
        self.k_proj_soft = Linear(e, e) if soft else None

    def init(self, generator: torch.Generator) -> None:
        for proj in (self.q_proj, self.k_proj, self.v_proj, self.out_proj, self.q_proj_soft, self.k_proj_soft):
            if proj is not None:
                proj.init(generator)
        if self.energy_bias is not None:
            nn.init.constant_(self.energy_bias, self.cfg.energy_bias_init)

    def energy(self, query, key, key_padding_mask=None, soft: bool = False):
        """(B, H, T, S) fp32 energies (reference attn_energy :71-96); NEG_INF
        at padded keys, finite so that an all-pad row's max-shift stays finite."""
        cfg = self.cfg
        q_proj = self.q_proj_soft if soft and self.q_proj_soft is not None else self.q_proj
        k_proj = self.k_proj_soft if soft and self.k_proj_soft is not None else self.k_proj
        q = _split_heads(q_proj(query), cfg.num_heads) * cfg.head_dim ** -0.5
        k = _split_heads(k_proj(key), cfg.num_heads)
        e = torch.matmul(q.float(), k.float().transpose(-1, -2))
        if self.energy_bias is not None:
            e = e + self.energy_bias.float()
        if key_padding_mask is not None:
            e = torch.where(key_padding_mask[:, None, None, :], NEG_INF, e)
        return e

    def p_choose(self, query, key, key_padding_mask=None, generator: GeneratorLike = None):
        """The read/write probability (B, H, T, S): sigmoid(energy + noise),
        the noise in training only (:419-453); waitk's band."""
        cfg = self.cfg
        if cfg.simul_type == "waitk":
            return waitk_p_choose(query.shape[0], cfg.num_heads, query.shape[1], key.shape[1], cfg.waitk_lagging,
                                  query.device)
        e = self.energy(query, key, key_padding_mask)
        if self.training and generator is not None:
            noise = torch.randn(e.shape, generator=device_generator(generator), device=e.device)
            e = e + (cfg.noise_mean + cfg.noise_var * noise)
        return torch.sigmoid(e)

    def infinite_lookback(self, alpha, query, key, key_padding_mask, generator: GeneratorLike = None):
        """MMA-IL's beta (:489-541): the soft attention renormalised over the
        prefix, weighted by the alignment's mass."""
        e = self.energy(query, key, key_padding_mask, soft=True)
        e = e - torch.amax(e, dim=-1, keepdim=True)
        exp_e = torch.exp(e)
        cum = torch.cumsum(exp_e, dim=-1)
        if key_padding_mask is not None:
            cum = torch.where(key_padding_mask[:, None, None, :], self.cfg.eps, cum)
        inner = alpha / cum
        beta = exp_e * torch.flip(torch.cumsum(torch.flip(inner, (-1,)), dim=-1), (-1,))
        return dropout(beta, self.cfg.dropout, generator, self.training)

    def forward(self, query, key, value=None, key_padding_mask=None, generator: GeneratorLike = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The full-sequence MMA: query (B, T, D), key/value (B, S, D) ->
        (out (B, T, D), {"alpha", "beta", "p_choose"} each (B, H, T, S))."""
        cfg = self.cfg
        value = key if value is None else value
        pc = self.p_choose(query, key, key_padding_mask, generator)
        alpha = expected_alignment_train(pc, cfg.eps, cfg.mass_preservation)
        if cfg.simul_type == "hard_aligned":
            beta = alpha
        else:
            beta = self.infinite_lookback(alpha, query, key, key_padding_mask, generator)
        v = _split_heads(self.v_proj(value), cfg.num_heads)
        out = self.out_proj(_merge_heads(torch.matmul(beta.to(v.dtype), v)))
        return out, {"alpha": alpha, "beta": beta, "p_choose": pc}
