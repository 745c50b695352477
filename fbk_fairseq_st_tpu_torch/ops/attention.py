"""Multi-head attention with a fixed-shape incremental KV cache.

Counterpart of ``fbk_fairseq_st_tpu/ops/attention.py`` (``mha``): separate
q/k/v/out projections with q pre-scaled by ``head_dim**-0.5``; the
``"causal"`` mask sentinel; a key padding mask (True at pads); an additive
``attn_mask``; the ``log``/``gauss`` encoder distance penalties; a
preallocated ``(B, H, T_max, Dh)`` self-attention cache written in place at
``cache_index`` (slots not yet written are masked); precomputed cross K/V;
head-averaged ``need_weights``. Activations are batch-first (B, T, D).

Flash routing follows the JAX eligibility rules: no cache, mask ``None`` or
causal, no penalty, no ``need_weights``. Calls with dropout active take the
flash route too, with the kernel's in-kernel dropout and one seed drawn per
call from the run's CPU generator (JAX sent them there on the TPU only,
whose hardware PRNG the CPU interpreter lacks); the dense path keeps the
non-TPU meaning (an fp32 softmax VJP and a Bernoulli mask). In auto mode
(``set_flash_attention(None)``) every eligible call on a CUDA tensor goes to
the hand-written kernel, at every key length: the JAX ``FLASH_MIN_KEY_LEN``
gate was a TPU v5e crossover, and the port's sweep
(``scripts/bench_flash_sweep.py``, two runs on an NVIDIA H100 80GB HBM3 at
700 W) found no key length at which the dense route's device time beats the
flash route's by more than 10 %: forward + backward in training mode, bf16,
batch x keys = 16,384 rows, this module (256 wide, 4 heads) dense/flash
1.07 at 128 keys, 1.12-1.23 at 512, 1.12-1.14 at 2048, and the
ConvAttention2D time attention (F' = 20) 0.99-1.02, 1.12, 1.31. So no gate
is adopted, for either caller. On a CPU tensor the flash route runs the
kernel's plain version, so the same function runs either way.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch
from torch import nn

from .core import NEG_INF, GeneratorLike, Linear, draw_seed, dropout
from .kernels.flash_attention import flash_attention


class MHAConfig(NamedTuple):
    embed_dim: int
    num_heads: int
    dropout: float = 0.0
    bias: bool = True
    # 'log' | 'gauss' | None — encoder LocalAttention distance penalties
    penalty: Optional[str] = None
    init_variance: float = 1.0


# True/False force the flash route on/off; None = auto (on for CUDA tensors).
_FLASH_ATTENTION: Optional[bool] = None


def set_flash_attention(enabled: Optional[bool]) -> None:
    """True/False force; None restores the device-dependent auto mode."""
    global _FLASH_ATTENTION
    _FLASH_ATTENTION = enabled if enabled is None else bool(enabled)


def flash_enabled(x: torch.Tensor) -> bool:
    if _FLASH_ATTENTION is not None:
        return _FLASH_ATTENTION
    return x.is_cuda


def key_bias(key_padding_mask, batch: int, src_len: int, heads: int, device):
    """(B*H, S) additive fp32 key bias: NEG_INF at pads, else 0."""
    if key_padding_mask is None:
        bias = torch.zeros((batch, src_len), dtype=torch.float32, device=device)
    else:
        bias = torch.where(key_padding_mask, NEG_INF, 0.0).to(torch.float32)
    return bias.repeat_interleave(heads, dim=0)


def init_cache(batch: int, max_len: int, cfg: MHAConfig, dtype=torch.float32,
               device=None) -> Dict[str, torch.Tensor]:
    """Preallocated self-attention KV cache for incremental decoding."""
    head_dim = cfg.embed_dim // cfg.num_heads
    shape = (batch, cfg.num_heads, max_len, head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
    }


def causal_mask(size: int, dtype=torch.float32, device=None):
    """Additive future mask (reference buffered_future_mask)."""
    return torch.triu(torch.full((size, size), NEG_INF, dtype=dtype, device=device), diagonal=1)


def _split_heads(x, num_heads: int):
    b, t, d = x.shape
    return x.reshape(b, t, num_heads, d // num_heads).transpose(1, 2)


def _merge_heads(x):
    b, h, t, dh = x.shape
    return x.transpose(1, 2).reshape(b, t, h * dh)


class MultiheadAttention(nn.Module):
    def __init__(self, cfg: MHAConfig):
        super().__init__()
        self.cfg = cfg
        e = cfg.embed_dim
        self.q_proj = Linear(e, e, bias=cfg.bias)
        self.k_proj = Linear(e, e, bias=cfg.bias)
        self.v_proj = Linear(e, e, bias=cfg.bias)
        self.out_proj = Linear(e, e, bias=cfg.bias)
        if cfg.penalty == "gauss":
            self.penalty_variance = nn.Parameter(torch.full((cfg.num_heads,), float(cfg.init_variance)))
        elif cfg.penalty not in (None, "log"):
            raise ValueError(f"unknown distance penalty {cfg.penalty!r}")

    def init(self, generator: torch.Generator) -> None:
        for proj in (self.q_proj, self.k_proj, self.v_proj, self.out_proj):
            proj.init(generator)
        if self.cfg.penalty == "gauss":
            nn.init.constant_(self.penalty_variance, float(self.cfg.init_variance))

    def distance_penalty(self, tgt_len: int, src_len: int, device):
        """Additive penalty subtracted from the logits (Di Gangi 2019)."""
        t_pos = torch.arange(tgt_len, dtype=torch.float32, device=device)[:, None]
        s_pos = torch.arange(src_len, dtype=torch.float32, device=device)[None, :]
        dist = torch.abs(t_pos - s_pos)
        if self.cfg.penalty == "log":
            pen = torch.clamp(torch.log(torch.clamp(dist, min=1e-9)), min=0.0)
            return pen[None, None]
        var = self.penalty_variance.float()
        return (dist * dist)[None, None] / (2.0 * var * var)[None, :, None, None]

    def precompute_cross_cache(self, encoder_out) -> Dict[str, torch.Tensor]:
        """Encoder K/V projected once before the decode loop."""
        h = self.cfg.num_heads
        return {
            "k": _split_heads(self.k_proj(encoder_out), h),
            "v": _split_heads(self.v_proj(encoder_out), h),
        }

    def forward(
        self,
        query,
        key=None,
        value=None,
        key_padding_mask=None,
        attn_mask=None,
        generator: GeneratorLike = None,
        cache: Optional[Dict[str, Any]] = None,
        cache_index: Optional[int] = None,
        static_kv: bool = False,
        need_weights: bool = False,
    ):
        """query (B, Tq, D); key/value default to query. ``key_padding_mask``
        (B, S) bool, True at pads; ``attn_mask`` (Tq, S) additive or
        ``"causal"``. With a self-attention ``cache`` this step's K/V are
        written into it in place at ``cache_index``; with ``static_kv`` the
        cache holds precomputed encoder K/V.

        Returns (out (B, Tq, D), head-averaged weights (B, Tq, S) or None,
        cache)."""
        cfg = self.cfg
        if key is None:
            key = query
        if value is None:
            value = key
        head_dim = cfg.embed_dim // cfg.num_heads
        q = _split_heads(self.q_proj(query) * head_dim ** -0.5, cfg.num_heads)

        if cache is not None and static_kv:
            k, v = cache["k"].to(q.dtype), cache["v"].to(q.dtype)
        else:
            k = _split_heads(self.k_proj(key), cfg.num_heads)
            v = _split_heads(self.v_proj(value), cfg.num_heads)
            if cache is not None:
                end = cache_index + k.shape[2]
                cache["k"][:, :, cache_index:end] = k
                cache["v"][:, :, cache_index:end] = v
                k, v = cache["k"].to(q.dtype), cache["v"].to(q.dtype)

        causal = isinstance(attn_mask, str) and attn_mask == "causal"
        dropout_active = self.training and cfg.dropout > 0.0 and generator is not None
        b, h, tq, hd = q.shape
        s = k.shape[2]
        if (
            flash_enabled(q)
            and cache is None
            and (attn_mask is None or causal)
            and cfg.penalty is None
            and not need_weights
        ):
            out = flash_attention(
                q.reshape(b * h, tq, hd),
                k.reshape(b * h, s, hd),
                v.reshape(b * h, s, hd),
                key_bias(key_padding_mask, b, s, h, q.device),
                1.0,  # q is pre-scaled above
                causal=causal,
                dropout_rate=cfg.dropout if dropout_active else 0.0,
                dropout_seed=draw_seed(generator) if dropout_active else None,
            ).reshape(b, h, tq, hd)
            return self.out_proj(_merge_heads(out)), None, cache

        if causal:
            attn_mask = causal_mask(tq, device=q.device)
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
        if cfg.penalty is not None:
            logits = logits - self.distance_penalty(tq, s, q.device)
        if attn_mask is not None:
            logits = logits + attn_mask[None, None].float()
        if cache is not None and not static_kv:
            # cache slots not yet written (>= cache_index + q_len)
            valid = torch.arange(s, device=q.device) < cache_index + tq
            logits = torch.where(valid[None, None, None, :], logits, NEG_INF)
        if key_padding_mask is not None:
            logits = torch.where(key_padding_mask[:, None, None, :], NEG_INF, logits)

        weights_f32 = torch.softmax(logits, dim=-1)
        weights = weights_f32.to(q.dtype)
        if generator is not None:
            weights = dropout(weights, cfg.dropout, generator, self.training)
        out = self.out_proj(_merge_heads(torch.matmul(weights, v)))
        attn = weights_f32.mean(dim=1) if need_weights else None
        return out, attn, cache
