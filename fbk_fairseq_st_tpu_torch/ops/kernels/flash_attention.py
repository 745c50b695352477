"""Flash attention: the CUDA kernels' wrappers, the autograd Function and
the plain versions.

Counterpart of ``fbk_fairseq_st_tpu/ops/pallas/attention_kernel.py``
(public ``flash_attention`` :554, the ``_flash`` custom_vjp :504-551). The
kernels are ``csrc/flash_fwd.cu`` (``_fwd_kernel``, dropout included),
``csrc/flash_bwd.cu`` (``_bwd_fused_kernel``, and ``_dq_kernel`` /
``_dkv_kernel`` on the CUDA cores) and ``csrc/flash_bwd_tc.cu``
(``_dq_kernel`` / ``_dkv_kernel`` on the tensor cores); their source notes
say what bounds them.

``flash_attention`` keeps the JAX contract: q (BH, T, D), k/v (BH, S, D),
``mask_bias`` (BH, S) additive key bias (0, or NEG_INF at pads), ``scale``
applied to q.k, optional top-left aligned causal mask, attention dropout at
``dropout_rate`` with the bits of ``philox.keep_mask(dropout_seed, ...)``.
It is differentiable in q, k and v. Unlike the JAX entry it never pads the
sequence axes (the kernels mask ragged T and S themselves); on CUDA it
zero-pads the head dim to the kernels' next size in {16, 32, 64, 128},
outside the autograd Function, so that autograd slices the padded gradient
columns off.

Routing is by the tensors' device and nothing else: CUDA tensors launch the
kernels or raise; CPU tensors run ``flash_attention_reference`` and
``flash_attention_backward_reference``, at any rate. Which backward kernels
a CUDA call launches is decided before the launch, from its type and head
dim (``use_fused_backward``, ``split_route``), and a kernel that fails to
build or launch raises.
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..core import NEG_INF
from . import philox
from .build import bind, raise_on

KERNEL_HEAD_DIMS = (16, 32, 64, 128)
TC_HEAD_DIMS = (32, 64)  # the tensor-core split pair's head dims
TC_TILE = 64  # q rows or keys a block of the tensor-core pair

# The backward of a CUDA call: the fused kernel (dQ, dK, dV in one launch,
# dQ added with fp32 atomics, so its last bits vary from run to run) or the
# split dq + dkv pair (deterministic). None: ``use_fused_backward``'s
# measured rule; True / False force the fused kernel / the split pair.
FUSED_BWD: Optional[bool] = None

# Kernel launches since the last reset (the plain versions do not count).
launches_fwd = 0
launches_bwd_fused = 0
launches_bwd_dq = 0  # the split pair on the CUDA cores
launches_bwd_dkv = 0
launches_bwd_dq_tc = 0  # the split pair on the tensor cores
launches_bwd_dkv_tc = 0


def __getattr__(name: str):
    # ``launches``: the forward count, the name the serving path reads
    if name == "launches":
        return launches_fwd
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def reset_launches() -> None:
    global launches_fwd, launches_bwd_fused, launches_bwd_dq, launches_bwd_dkv
    global launches_bwd_dq_tc, launches_bwd_dkv_tc
    launches_fwd = launches_bwd_fused = launches_bwd_dq = launches_bwd_dkv = 0
    launches_bwd_dq_tc = launches_bwd_dkv_tc = 0


def kernel_head_dim(d: int) -> int:
    for size in KERNEL_HEAD_DIMS:
        if d <= size:
            return size
    raise ValueError(f"flash_attention: head dim {d} > {KERNEL_HEAD_DIMS[-1]} is not supported")


# ---------------------------------------------------------------------------
# The backward's routes (pure: they need no card)
# ---------------------------------------------------------------------------

def split_route(dtype, d: int) -> str:
    """The split pair's kernels for a call of ``dtype`` at kernel head dim
    ``d``: "tc", the tensor cores (``csrc/flash_bwd_tc.cu``), for bf16 at
    D 32 and 64 (every model's heads, and the time attention's F' = 20
    padded to 32); "cuda_core" (``csrc/flash_bwd.cu``) for fp32, where TF32
    would not be exact against the fp32 plain version, and for bf16 at D 16
    and 128, which no model reaches."""
    return "tc" if dtype == torch.bfloat16 and d in TC_HEAD_DIMS else "cuda_core"


def use_fused_backward(dtype, d: int) -> bool:
    """Whether a CUDA call of ``dtype`` at kernel head dim ``d`` takes the
    fused kernel: ``FUSED_BWD`` when set; else the fused kernel where the
    split pair would run on the CUDA cores (1.5x slower than fused) and the
    tensor-core pair everywhere it runs, since it beat the fused kernel at
    every backward call of the train steps (``pair_wins``, PERF.md
    section 6)."""
    if FUSED_BWD is not None:
        return FUSED_BWD
    return split_route(dtype, d) != "tc"


@contextlib.contextmanager
def backward_forced(fused: Optional[bool]):
    """Within the block ``FUSED_BWD`` is ``fused``; after it, the value it
    had before."""
    global FUSED_BWD
    found = FUSED_BWD
    FUSED_BWD = fused
    try:
        yield
    finally:
        FUSED_BWD = found


def pair_wins(times: Dict[str, Tuple[float, float]]) -> Dict[str, bool]:
    """The backward decision's rule, per call: from {call: (fused ms, pair
    ms)} device times, whether the tensor-core pair is at least as fast as
    the fused kernel there. ``use_fused_backward`` takes the pair on every
    call because this held at each of the train steps' backward calls; a
    call where it fails is a crossover that needs a key-count gate."""
    return {name: pair <= fused for name, (fused, pair) in times.items()}


def tc_check_shape(d: int, t: int, s: int) -> None:
    """Raise ValueError for a shape the tensor-core pair does not take;
    needs no card. bh is the grid's x dimension and takes any batch; the
    64-row and 64-key tiles are its y dimension, at most 65,535. Its shared
    memory does not depend on T or S (``csrc/flash_bwd_tc.cu``)."""
    if d not in TC_HEAD_DIMS:
        raise ValueError(f"flash_bwd_tc: head dim {d} not in {TC_HEAD_DIMS}")
    if max(-(-t // TC_TILE), -(-s // TC_TILE)) > 65535:
        raise ValueError(f"flash_bwd_tc: T {t} or S {s} over 65,535 tiles of {TC_TILE}")


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def _compute_dtype(x: torch.Tensor) -> torch.dtype:
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def _masked_scores(q, k, mask_bias, scale: float, causal: bool):
    ct = _compute_dtype(q)
    t, s = q.shape[1], k.shape[1]
    scores = torch.einsum("btd,bsd->bts", q.to(ct), k.to(ct)) * scale
    scores = scores + mask_bias.to(ct)[:, None, :]
    if causal:
        rows = torch.arange(t, device=q.device)[:, None]
        cols = torch.arange(s, device=q.device)[None, :]
        scores = torch.where(cols <= rows, scores, NEG_INF)
    return scores


def _keep(q, k, dropout_rate: float, dropout_seed: int, dtype):
    """The keep mask as 0/1 in ``dtype``, or None at rate 0."""
    if dropout_rate == 0.0:
        return None
    mask = philox.keep_mask(dropout_seed, q.shape[0], q.shape[1], k.shape[1], dropout_rate, q.device)
    return mask.to(dtype)


def flash_attention_reference(q, k, v, mask_bias, scale: float, causal: bool = False,
                              dropout_rate: float = 0.0, dropout_seed: int = 0
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain masked-softmax attention with the kernel's semantics, in fp32
    (fp64 for fp64 inputs). m, l and lse come from the undropped weights;
    the dropped ones enter the weighted sum, divided by l * (1 - rate).
    Returns (out in q's dtype, lse (BH, T))."""
    scores = _masked_scores(q, k, mask_bias, scale, causal)
    m = torch.clamp(scores.amax(dim=-1, keepdim=True), min=NEG_INF)
    p = torch.exp(scores - m)
    l = p.sum(dim=-1, keepdim=True)
    keep = _keep(q, k, dropout_rate, dropout_seed, p.dtype)
    if keep is not None:
        p = p * keep
    out = torch.einsum("bts,bsd->btd", p, v.to(p.dtype)) / torch.clamp(l * (1.0 - dropout_rate), min=1e-30)
    lse = (m + torch.log(torch.clamp(l, min=1e-30)))[..., 0]
    return out.to(q.dtype), lse


def flash_attention_backward_reference(q, k, v, mask_bias, out, lse, grad, scale: float,
                                       causal: bool = False, dropout_rate: float = 0.0,
                                       dropout_seed: int = 0):
    """The backward kernels' formulas in dense form (``_bwd_fused_kernel``
    :298-318): w = exp(s - lse), w_v = w * keep / (1 - rate), dV = w_v^T dO,
    dp = dO V^T * keep / (1 - rate), ds = w * (dp - delta) with
    delta = rowsum(dO * O), dK = ds^T q * scale, dQ = ds k * scale. As the
    Pallas kernels' ``.astype``, w_v is rounded to dO's type and ds to q's
    (for dK) and k's (for dQ) before the products when that type is
    narrower than the compute type (bf16); in fp32 the rounding is the
    identity. Returns (dq, dk, dv) in the inputs' dtypes."""
    scores = _masked_scores(q, k, mask_bias, scale, causal)
    ct = scores.dtype
    g = grad.to(ct)
    w = torch.exp(scores - lse.to(ct)[..., None])
    delta = (g * out.to(ct)).sum(dim=-1)
    dp = torch.einsum("btd,bsd->bts", g, v.to(ct))
    w_v = w
    keep = _keep(q, k, dropout_rate, dropout_seed, ct)
    if keep is not None:
        w_v = w * keep / (1.0 - dropout_rate)
        dp = dp * keep / (1.0 - dropout_rate)
    dv = torch.einsum("bts,btd->bsd", _rounded(w_v, grad.dtype), g)
    ds = w * (dp - delta[..., None])
    dk = torch.einsum("bts,btd->bsd", _rounded(ds, q.dtype), q.to(ct)) * scale
    dq = torch.einsum("bts,bsd->btd", _rounded(ds, k.dtype), k.to(ct)) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _rounded(x: torch.Tensor, dtype) -> torch.Tensor:
    """``x`` rounded to ``dtype`` when that is narrower than x's type."""
    if torch.finfo(dtype).bits < torch.finfo(x.dtype).bits:
        return x.to(dtype).to(x.dtype)
    return x


# ---------------------------------------------------------------------------
# Public entry and the autograd Function
# ---------------------------------------------------------------------------

def _check(q, k, v, mask_bias) -> None:
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError("flash_attention: q, k, v must be (BH, T, D) / (BH, S, D)")
    bh, t, d = q.shape
    if k.shape[0] != bh or v.shape[0] != bh or k.shape[2] != d or v.shape != k.shape:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    if tuple(mask_bias.shape) != (bh, k.shape[1]):
        raise ValueError(f"flash_attention: mask_bias {tuple(mask_bias.shape)} != {(bh, k.shape[1])}")
    if t == 0 or k.shape[1] == 0:
        raise ValueError("flash_attention: empty sequence")
    devices = {x.device for x in (q, k, v, mask_bias)}
    if len(devices) != 1:
        raise ValueError(f"flash_attention: inputs on several devices {devices}")
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"flash_attention: unsupported device {q.device}")


class _FlashAttention(torch.autograd.Function):
    """The ``_flash`` custom_vjp: saves q, k, v, bias, seed, out and lse;
    gradients for q, k and v only (JAX returns None for bias and seed)."""

    @staticmethod
    def forward(ctx, q, k, v, bias, scale, causal, rate, seed):
        if q.is_cuda:
            out, lse = _forward_cuda(q, k, v, bias, scale, causal, rate, seed)
        else:
            out, lse = flash_attention_reference(q, k, v, bias, scale, causal, rate, seed)
        ctx.save_for_backward(q, k, v, bias, out, lse)
        ctx.args = (scale, causal, rate, seed)
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, grad_out, grad_lse):
        q, k, v, bias, out, lse = ctx.saved_tensors
        scale, causal, rate, seed = ctx.args
        dq, dk, dv = flash_attention_backward(q, k, v, bias, out, lse, grad_out, scale, causal, rate, seed)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q, k, v, mask_bias, scale: float, causal: bool = False,
                    dropout_rate: float = 0.0, dropout_seed: Optional[int] = None,
                    return_lse: bool = False):
    """softmax(scale * q k^T + bias[key], causal-masked) v, with attention
    dropout at ``dropout_rate`` drawn from ``dropout_seed`` (a 64-bit int).

    Returns out (BH, T, D) in q's dtype, and with ``return_lse`` also the
    fp32 per-row log-sum-exp (BH, T) of the undropped weights."""
    _check(q, k, v, mask_bias)
    philox.keep_threshold(dropout_rate)  # raises outside [0, 1)
    if dropout_rate > 0.0 and dropout_seed is None:
        raise ValueError("flash_attention: dropout needs a dropout_seed")
    seed = int(dropout_seed or 0)
    d = q.shape[2]
    bias = mask_bias
    if q.is_cuda:
        if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype or v.dtype != q.dtype:
            raise TypeError(f"flash_attention: q/k/v must share fp32 or bf16, got {q.dtype}/{k.dtype}/{v.dtype}")
        if q.shape[0] > 65535:
            raise ValueError(f"flash_attention: bh {q.shape[0]} > 65535")
        dk = kernel_head_dim(d)
        if dk != d:
            pad = (0, dk - d)
            q, k, v = F.pad(q, pad), F.pad(k, pad), F.pad(v, pad)
        bias = mask_bias.to(torch.float32)
    out, lse = _FlashAttention.apply(q, k, v, bias, float(scale), bool(causal), float(dropout_rate), seed)
    if out.shape[2] != d:
        out = out[..., :d]
    return (out, lse) if return_lse else out


# ---------------------------------------------------------------------------
# CUDA launches
# ---------------------------------------------------------------------------

def _dropout_args(rate: float, seed: int):
    return philox.keep_threshold(rate), 1.0 - rate, seed & 0xFFFFFFFFFFFFFFFF


def _forward_cuda(q, k, v, bias, scale, causal, rate, seed):
    global launches_fwd
    q, k, v, bias = q.contiguous(), k.contiguous(), v.contiguous(), bias.contiguous()
    bh, t, d = q.shape
    s = k.shape[1]
    out = torch.empty_like(q)
    lse = torch.empty((bh, t), dtype=torch.float32, device=q.device)
    thresh, keep_prob, seed = _dropout_args(rate, seed)
    lib = _library("flash_fwd")
    with torch.cuda.device(q.device):
        err = lib.flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            out.data_ptr(), lse.data_ptr(), bh, t, s, d, scale, int(causal),
            thresh, keep_prob, seed, int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    raise_on(lib, "flash_fwd", err)
    launches_fwd += 1
    return out, lse


def flash_attention_backward(q, k, v, bias, out, lse, grad, scale: float, causal: bool = False,
                             rate: float = 0.0, seed: int = 0):
    """(dq, dk, dv) of ``flash_attention``. CPU tensors run
    ``flash_attention_backward_reference``. CUDA tensors, at the kernels'
    head dim, launch the fused kernel or the split pair
    (``use_fused_backward``), the pair on the tensor cores or the CUDA cores
    (``split_route``). delta = rowsum(dO * O) is a PyTorch op in fp32 here,
    as JAX computes it in XLA outside its kernels."""
    global launches_bwd_fused, launches_bwd_dq, launches_bwd_dkv, launches_bwd_dq_tc, launches_bwd_dkv_tc
    if not q.is_cuda:
        return flash_attention_backward_reference(q, k, v, bias, out, lse, grad, scale, causal, rate, seed)
    bh, t, d = q.shape
    s = k.shape[1]
    route = "fused" if use_fused_backward(q.dtype, d) else split_route(q.dtype, d)
    if route == "tc":
        tc_check_shape(d, t, s)
    # contiguous, and 16-byte aligned for the tensor-core pair's cp.async
    q, k, v, grad = (x if x.data_ptr() % 16 == 0 else x.clone()
                     for x in (q.contiguous(), k.contiguous(), v.contiguous(), grad.to(q.dtype).contiguous()))
    bias = bias.contiguous()
    delta = (grad.float() * out.float()).sum(dim=-1)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    thresh, keep_prob, seed = _dropout_args(rate, seed)
    is_bf16 = int(q.dtype == torch.bfloat16)
    common = (q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), grad.data_ptr(),
              lse.data_ptr(), delta.data_ptr())
    tail = (scale, int(causal), thresh, keep_prob, seed)
    if route == "tc":
        dq = torch.empty_like(q)
        lib = _library("flash_bwd_tc")
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream
            err = lib.flash_bwd_dq_tc(*common, dq.data_ptr(), bh, t, s, d, *tail, stream)
            raise_on(lib, "flash_bwd_dq_tc", err)
            launches_bwd_dq_tc += 1
            err = lib.flash_bwd_dkv_tc(*common, dk.data_ptr(), dv.data_ptr(), bh, t, s, d, *tail, stream)
            raise_on(lib, "flash_bwd_dkv_tc", err)
            launches_bwd_dkv_tc += 1
        return dq, dk, dv
    lib = _library("flash_bwd")
    tail = tail + (is_bf16,)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if route == "fused":
            dq32 = torch.zeros((bh, t, d), dtype=torch.float32, device=q.device)
            err = lib.flash_bwd_fused(*common, dq32.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                                      bh, t, s, d, *tail, stream)
            raise_on(lib, "flash_bwd_fused", err)
            launches_bwd_fused += 1
            dq = dq32.to(q.dtype)
        else:
            dq = torch.empty_like(q)
            err = lib.flash_bwd_dq(*common, dq.data_ptr(), bh, t, s, d, *tail, stream)
            raise_on(lib, "flash_bwd_dq", err)
            launches_bwd_dq += 1
            err = lib.flash_bwd_dkv(*common, dk.data_ptr(), dv.data_ptr(), bh, t, s, d, *tail, stream)
            raise_on(lib, "flash_bwd_dkv", err)
            launches_bwd_dkv += 1
    return dq, dk, dv


_P = ctypes.c_void_p
_I = ctypes.c_int
_TAIL = [ctypes.c_float, _I, ctypes.c_uint32, ctypes.c_float, ctypes.c_uint64, _I, _P]
_TC_TAIL = [ctypes.c_float, _I, ctypes.c_uint32, ctypes.c_float, ctypes.c_uint64, _P]
_SIGNATURES = {
    "flash_fwd": {
        "flash_fwd": [_P] * 6 + [_I] * 4 + _TAIL,
    },
    "flash_bwd": {
        "flash_bwd_fused": [_P] * 10 + [_I] * 4 + _TAIL,
        "flash_bwd_dq": [_P] * 8 + [_I] * 4 + _TAIL,
        "flash_bwd_dkv": [_P] * 9 + [_I] * 4 + _TAIL,
    },
    "flash_bwd_tc": {
        "flash_bwd_dq_tc": [_P] * 8 + [_I] * 4 + _TC_TAIL,
        "flash_bwd_dkv_tc": [_P] * 9 + [_I] * 4 + _TC_TAIL,
    },
}


def _library(name: str) -> ctypes.CDLL:
    return bind(name, _SIGNATURES[name])
