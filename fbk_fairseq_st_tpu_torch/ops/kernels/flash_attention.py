"""Flash attention: the CUDA kernels' wrappers, the autograd Function and
the plain versions.

Counterpart of ``fbk_fairseq_st_tpu/ops/pallas/attention_kernel.py``
(public ``flash_attention`` :554, the ``_flash`` custom_vjp :504-551). The
kernels are ``csrc/flash_fwd.cu`` (``_fwd_kernel``, dropout included, on the
CUDA cores), ``csrc/flash_fwd_tc.cu`` (``_fwd_kernel`` on the tensor cores,
bf16 at head dim 32, 64 and 128), ``csrc/flash_fwd_tf32x3.cu``
(``_fwd_kernel`` on the tensor cores, fp32 in 3xTF32 products at 32, 64
and 128), ``csrc/flash_bwd.cu`` (``_bwd_fused_kernel``, and ``_dq_kernel`` /
``_dkv_kernel`` on the CUDA cores), ``csrc/flash_bwd_tc.cu`` (``_dq_kernel``
/ ``_dkv_kernel`` on the tensor cores, bf16 at head dim 32 and 64),
``csrc/flash_bwd_tc128.cu`` (the same pair, bf16 at head dim 128) and
``csrc/flash_bwd_tf32x3.cu`` (the same pair, fp32 in 3xTF32 products at 32,
64 and 128); their source notes say what bounds them.

``flash_attention`` keeps the JAX contract: q (BH, T, D), k/v (BH, S, D),
``mask_bias`` (BH, S) additive key bias (0, or NEG_INF at pads), ``scale``
applied to q.k, optional top-left aligned causal mask, attention dropout at
``dropout_rate`` with the bits of ``philox.keep_mask(dropout_seed, ...)``.
It is differentiable in q, k and v. A row whose every key is masked (a
fixed-shape batch's padding row) gives the uniform average of V with no
gradient to q or k, as the dense route does: its q and bias are zeroed
before the kernels (``_uniform_dead_rows``), since at |bias| ~ 1e9 the
kernels' s - lse carries the bias's rounding (ulp 64 in fp32) into exp and
overflows the backward of such a row as soon as a gradient reaches it (the
context-aware criterion's gate penalty counts padding rows). Unlike the
JAX entry it never pads the
sequence axes (the kernels mask ragged T and S themselves); on CUDA it
zero-pads the head dim to the kernels' next size in {16, 32, 64, 128},
outside the autograd Function, so that autograd slices the padded gradient
columns off.

Routing is by the tensors' device and nothing else: CUDA tensors launch the
kernels or raise; CPU tensors run ``flash_attention_reference`` and
``flash_attention_backward_reference``, at any rate. Which kernels a CUDA
call launches is decided before the launch, from its type and head dim
(``fwd_route``, ``use_fused_backward``, ``split_route``), and a kernel that
fails to build or launch raises.
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
# the head dims of each tensor-core route's forward and split pair (the
# bf16 pair at 128 in csrc/flash_bwd_tc128.cu)
FWD_HEAD_DIMS = {"tc": (32, 64, 128), "tf32x3": (32, 64, 128)}
PAIR_HEAD_DIMS = {"tc": (32, 64, 128), "tf32x3": (32, 64, 128)}
TC_TILE = 64  # q rows or keys a block of the tensor-core kernels
# the kernels of each tensor-core route: the forward, dq and dkv (the bf16
# pair at D 128: pair_kernels)
TC_KERNELS = {"tc": ("flash_fwd_tc", "flash_bwd_dq_tc", "flash_bwd_dkv_tc"),
              "tf32x3": ("flash_fwd_tf32x3", "flash_bwd_dq_tf32x3", "flash_bwd_dkv_tf32x3")}
TC_DTYPES = {"tc": torch.bfloat16, "tf32x3": torch.float32}

# The backward of a CUDA call: the fused kernel (dQ, dK, dV in one launch,
# dQ added with fp32 atomics, so its last bits vary from run to run) or the
# split dq + dkv pair (deterministic). None: ``use_fused_backward``'s rule,
# the pair everywhere; True / False force the fused kernel / the pair.
FUSED_BWD: Optional[bool] = None

# Kernel launches since the last reset (the plain versions do not count).
launches_fwd = 0  # the forward on the CUDA cores
launches_fwd_tc = 0  # the forward on the tensor cores, bf16 at D 32/64
launches_fwd_tc128 = 0  # the same at D 128 (D128_COUNTERS)
launches_fwd_tf32x3 = 0  # the forward on the tensor cores, fp32 at D 32/64
launches_fwd_tf32x3_128 = 0  # the same at D 128 (D128_COUNTERS)
launches_bwd_fused = 0
launches_bwd_dq = 0  # the split pair on the CUDA cores
launches_bwd_dkv = 0
launches_bwd_dq_tc = 0  # the split pair on the tensor cores, bf16 at D 32/64
launches_bwd_dkv_tc = 0
launches_bwd_dq_tc128 = 0  # the same at D 128
launches_bwd_dkv_tc128 = 0
launches_bwd_dq_tf32x3 = 0  # the split pair on the tensor cores, fp32 at D 32/64
launches_bwd_dkv_tf32x3 = 0
launches_bwd_dq_tf32x3_128 = 0  # the same at D 128 (D128_COUNTERS)
launches_bwd_dkv_tf32x3_128 = 0
_COUNTERS = ("launches_fwd", "launches_fwd_tc", "launches_fwd_tc128", "launches_fwd_tf32x3",
             "launches_fwd_tf32x3_128", "launches_bwd_fused",
             "launches_bwd_dq", "launches_bwd_dkv", "launches_bwd_dq_tc", "launches_bwd_dkv_tc",
             "launches_bwd_dq_tc128", "launches_bwd_dkv_tc128", "launches_bwd_dq_tf32x3", "launches_bwd_dkv_tf32x3",
             "launches_bwd_dq_tf32x3_128", "launches_bwd_dkv_tf32x3_128")


def __getattr__(name: str):
    # ``launches``: the forward count of every route, the name the serving
    # path reads
    if name == "launches":
        return launches_fwd + launches_fwd_tc + launches_fwd_tc128 + launches_fwd_tf32x3 + launches_fwd_tf32x3_128
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def reset_launches() -> None:
    for name in _COUNTERS:
        globals()[name] = 0


# the library functions whose launches at kernel head dim 128 are counted
# apart, under these names (the bf16 pair at D 128 has functions of its own)
D128_COUNTERS = {"flash_fwd_tc": "flash_fwd_tc128", "flash_fwd_tf32x3": "flash_fwd_tf32x3_128",
                 "flash_bwd_dq_tf32x3": "flash_bwd_dq_tf32x3_128", "flash_bwd_dkv_tf32x3": "flash_bwd_dkv_tf32x3_128"}


def _count(kernel: str, d: int) -> None:
    """One launch of ``kernel`` (a library function's name) at kernel head
    dim ``d``."""
    if d == 128:
        kernel = D128_COUNTERS.get(kernel, kernel)
    globals()["launches_" + kernel.removeprefix("flash_")] += 1


def kernel_head_dim(d: int) -> int:
    for size in KERNEL_HEAD_DIMS:
        if d <= size:
            return size
    raise ValueError(f"flash_attention: head dim {d} > {KERNEL_HEAD_DIMS[-1]} is not supported")


# ---------------------------------------------------------------------------
# The routes (pure: they need no card)
# ---------------------------------------------------------------------------

def _tc_route(dtype, d: int, head_dims) -> str:
    """The tensor-core route of ``dtype`` ("tc" in bf16, "tf32x3" in fp32)
    when ``head_dims`` ({route: head dims}) lets it take ``d``; else
    "cuda_core"."""
    for route, dt in TC_DTYPES.items():
        if dtype == dt and d in head_dims[route]:
            return route
    return "cuda_core"


def fwd_route(dtype, d: int) -> str:
    """The forward kernel of a CUDA call of ``dtype`` at kernel head dim
    ``d`` (``FWD_HEAD_DIMS``): on the tensor cores "tc" in bf16 and
    "tf32x3" in fp32 at D 32, 64 and 128 (``csrc/flash_fwd_tc.cu``,
    ``csrc/flash_fwd_tf32x3.cu``; 128 is the iwslt presets' decoder
    cross-attention); else "cuda_core" (``csrc/flash_fwd.cu``): D 16. Each
    tensor-core kernel is held to beat the CUDA-core one at every
    train-step call of its type (``tc_fwd_wins``)."""
    return _tc_route(dtype, d, FWD_HEAD_DIMS)


def fwd_check_shape(route: str, bh: int, t: int, d: int) -> None:
    """Raise ValueError for a forward that the route's kernel does not
    take; needs no card. Every route puts bh on the grid's x dimension,
    which takes any batch, and the 64-row q tiles on its y dimension, at
    most 65,535. "tc" and "tf32x3" take the head dims of
    ``FWD_HEAD_DIMS``."""
    name = TC_KERNELS[route][0] if route in TC_KERNELS else "flash_fwd"
    if route in TC_KERNELS and d not in FWD_HEAD_DIMS[route]:
        raise ValueError(f"{name}: head dim {d} not in {FWD_HEAD_DIMS[route]}")
    if -(-t // TC_TILE) > 65535:
        raise ValueError(f"{name}: T {t} over 65,535 tiles of {TC_TILE}")


def tc_fwd_wins(times: Dict[str, Tuple[float, float]]) -> Dict[str, bool]:
    """The forward route's rule, per call: from {call: (CUDA-core ms,
    tensor-core ms)} device times, whether the tensor-core kernel of the
    call's type ("tc" in bf16, "tf32x3" in fp32) is at least as fast as the
    CUDA-core one there. ``fwd_route`` takes the tensor cores at every call
    at D 32, 64 and 128 because this held at each of the train steps' calls
    there; a call where it fails needs a gate."""
    return {name: tc <= cuda_core for name, (cuda_core, tc) in times.items()}


def split_route(dtype, d: int) -> str:
    """The split pair's kernels for a call of ``dtype`` at kernel head dim
    ``d`` (``PAIR_HEAD_DIMS``): on the tensor cores "tc" in bf16 at D 32
    and 64 (every model's heads, and the time attention's F' = 20 padded to
    32; ``csrc/flash_bwd_tc.cu``) and 128 (``csrc/flash_bwd_tc128.cu``),
    "tf32x3" in fp32 at D 32, 64 and 128 (``csrc/flash_bwd_tf32x3.cu``,
    three tf32 products a product, within the fp32 limits where one is
    not); "cuda_core" (``csrc/flash_bwd.cu``) at D 16. A model reaches
    D 128: the iwslt lightconv presets' 4 heads over 512 dims,
    whose decoder cross-attention every train step of theirs runs
    (``TRAIN_BACKWARD_SHAPES``' ``lightconv_iwslt_cross_attention``)."""
    return _tc_route(dtype, d, PAIR_HEAD_DIMS)


def pair_kernels(route: str, d: int) -> Tuple[str, str, str]:
    """(library, dq function, dkv function) of the split pair of ``route``
    at kernel head dim ``d``; a kernel's name in a trace is its function's
    with ``_kernel`` after it (the CUDA-core pair's excepted)."""
    if route not in TC_KERNELS:
        return "flash_bwd", "flash_bwd_dq", "flash_bwd_dkv"
    if route == "tc" and d == 128:
        return "flash_bwd_tc128", "flash_bwd_dq_tc128", "flash_bwd_dkv_tc128"
    return "flash_bwd_" + route, *TC_KERNELS[route][1:]


def use_fused_backward(dtype, d: int) -> bool:
    """Whether a CUDA call of ``dtype`` at kernel head dim ``d`` takes the
    fused kernel: ``FUSED_BWD`` when set; else never. Every default route is
    a split pair and bitwise repeatable: at D 32, 64 and 128 the tensor-core
    pair of the call's type, which beat the fused kernel at every backward
    call of the train steps in its type (``pair_wins``, PERF.md section 6);
    at D 16 the CUDA-core pair, chosen when the fused kernel's dQ was not
    repeatable (it is now, in kv-tile order) and kept since."""
    if FUSED_BWD is not None:
        return FUSED_BWD
    return False


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
    ms)} device times, whether the tensor-core pair of the call's type is
    at least as fast as the fused kernel there. ``use_fused_backward`` takes
    the tensor-core pair on every call at D 32 and 64 because this held at
    each of the train steps' backward calls there in both types (and at
    D 128); a call where it fails is a crossover that needs a key-count
    gate. Calls at D 16 have no tensor-core pair and are not ruled by it."""
    return {name: pair <= fused for name, (fused, pair) in times.items()}


def tc_check_shape(d: int, t: int, s: int, route: str = "tc") -> None:
    """Raise ValueError for a shape the tensor-core pair of ``route`` ("tc"
    or "tf32x3") does not take; needs no card. Its head dims are
    ``PAIR_HEAD_DIMS[route]``. bh is the grid's x dimension and takes any
    batch; the 64-row and 64-key tiles are its y dimension, at most 65,535.
    Its shared memory does not depend on T or S (``csrc/flash_bwd_tc.cu``,
    ``csrc/flash_bwd_tc128.cu``, ``csrc/flash_bwd_tf32x3.cu``)."""
    name = "flash_bwd_" + route
    if d not in PAIR_HEAD_DIMS[route]:
        raise ValueError(f"{name}: head dim {d} not in {PAIR_HEAD_DIMS[route]}")
    if max(-(-t // TC_TILE), -(-s // TC_TILE)) > 65535:
        raise ValueError(f"{name}: T {t} or S {s} over 65,535 tiles of {TC_TILE}")


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
    the dropped ones enter the weighted sum, divided by l * (1 - rate),
    rounded to the input type first as ``_fwd_kernel``'s
    ``p.astype(v_ref.dtype)`` (the identity in fp32).
    Returns (out in q's dtype, lse (BH, T))."""
    scores = _masked_scores(q, k, mask_bias, scale, causal)
    m = torch.clamp(scores.amax(dim=-1, keepdim=True), min=NEG_INF)
    p = torch.exp(scores - m)
    l = p.sum(dim=-1, keepdim=True)
    keep = _keep(q, k, dropout_rate, dropout_seed, p.dtype)
    if keep is not None:
        p = p * keep
    out = torch.einsum("bts,bsd->btd", _rounded(p, q.dtype), v.to(p.dtype))
    out = out / torch.clamp(l * (1.0 - dropout_rate), min=1e-30)
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
    q, mask_bias = _uniform_dead_rows(q, mask_bias)
    bias = mask_bias
    if q.is_cuda:
        if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype or v.dtype != q.dtype:
            raise TypeError(f"flash_attention: q/k/v must share fp32 or bf16, got {q.dtype}/{k.dtype}/{v.dtype}")
        dk = kernel_head_dim(d)
        if dk != d:
            pad = (0, dk - d)
            q, k, v = F.pad(q, pad), F.pad(k, pad), F.pad(v, pad)
        bias = mask_bias.to(torch.float32)
    out, lse = _FlashAttention.apply(q, k, v, bias, float(scale), bool(causal), float(dropout_rate), seed)
    if out.shape[2] != d:
        out = out[..., :d]
    return (out, lse) if return_lse else out


def _uniform_dead_rows(q, mask_bias):
    """(q, mask_bias) with the rows whose every key is masked zeroed in
    both: their scores are then all 0, so they average V uniformly, and q's
    gradient there is 0."""
    live = mask_bias.amax(dim=1, keepdim=True) > NEG_INF / 2
    return q * live[..., None], mask_bias * live


# ---------------------------------------------------------------------------
# CUDA launches
# ---------------------------------------------------------------------------

def _dropout_args(rate: float, seed: int):
    return philox.keep_threshold(rate), 1.0 - rate, seed & 0xFFFFFFFFFFFFFFFF


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """``x`` contiguous and 16-byte aligned, for the tensor-core kernels'
    cp.async (a copy only when the storage offset breaks the alignment)."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _forward_cuda(q, k, v, bias, scale, causal, rate, seed):
    return FORWARDS[fwd_route(q.dtype, q.shape[2])](q, k, v, bias, scale, causal, rate, seed)


def forward_cuda_core(q, k, v, bias, scale: float, causal: bool, rate: float, seed: int):
    """One launch of ``csrc/flash_fwd.cu`` (fp32 or bf16, any kernel head
    dim) on CUDA tensors; returns (out, lse). ``flash_attention`` takes it
    by ``fwd_route``; the flash sweep calls it directly to time it."""
    global launches_fwd
    q, k, v, bias = q.contiguous(), k.contiguous(), v.contiguous(), bias.contiguous()
    bh, t, d = q.shape
    fwd_check_shape("cuda_core", bh, t, d)
    out, lse, args = _forward_args(q, k, v, bias, scale, causal, rate, seed)
    lib = _library("flash_fwd")
    with torch.cuda.device(q.device):
        err = lib.flash_fwd(*args, int(q.dtype == torch.bfloat16), torch.cuda.current_stream(q.device).cuda_stream)
    raise_on(lib, "flash_fwd", err)
    launches_fwd += 1
    return out, lse


def forward_tc(q, k, v, bias, scale: float, causal: bool, rate: float, seed: int):
    """One launch of ``csrc/flash_fwd_tc.cu`` (bf16 at kernel head dim 32 or
    64 or 128) on CUDA tensors; returns (out, lse)."""
    return _forward_tensor_cores("tc", q, k, v, bias, scale, causal, rate, seed)


def forward_tf32x3(q, k, v, bias, scale: float, causal: bool, rate: float, seed: int):
    """One launch of ``csrc/flash_fwd_tf32x3.cu`` (fp32 at kernel head dim
    32, 64 or 128, 3xTF32 products) on CUDA tensors; returns (out, lse)."""
    return _forward_tensor_cores("tf32x3", q, k, v, bias, scale, causal, rate, seed)


def _forward_tensor_cores(route, q, k, v, bias, scale, causal, rate, seed):
    """A failing build or launch raises: no other route stands in."""
    name = TC_KERNELS[route][0]
    q, k, v, bias = _aligned(q), _aligned(k), _aligned(v), bias.contiguous()
    bh, t, d = q.shape
    fwd_check_shape(route, bh, t, d)
    if q.dtype != TC_DTYPES[route]:
        raise TypeError(f"{name}: {TC_DTYPES[route]} only, got {q.dtype}")
    out, lse, args = _forward_args(q, k, v, bias, scale, causal, rate, seed)
    lib = _library(name)
    with torch.cuda.device(q.device):
        err = getattr(lib, name)(*args, torch.cuda.current_stream(q.device).cuda_stream)
    raise_on(lib, name, err)
    _count(name, d)
    return out, lse


# each forward route's launch, on CUDA tensors at a kernel head dim
FORWARDS = {"tc": forward_tc, "tf32x3": forward_tf32x3, "cuda_core": forward_cuda_core}


def _forward_args(q, k, v, bias, scale, causal, rate, seed):
    """The outputs and the launch arguments both forward kernels share."""
    bh, t, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((bh, t), dtype=torch.float32, device=q.device)
    thresh, keep_prob, seed = _dropout_args(rate, seed)
    return out, lse, (q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), out.data_ptr(), lse.data_ptr(),
                      bh, t, k.shape[1], d, scale, int(causal), thresh, keep_prob, seed)


def flash_attention_backward(q, k, v, bias, out, lse, grad, scale: float, causal: bool = False,
                             rate: float = 0.0, seed: int = 0):
    """(dq, dk, dv) of ``flash_attention``. CPU tensors run
    ``flash_attention_backward_reference``. CUDA tensors, at the kernels'
    head dim, launch the fused kernel (``backward_fused``) or the split
    pair (``backward_pair``; ``use_fused_backward``), the pair on the
    tensor cores in bf16 or fp32 or on the CUDA cores (``split_route``)."""
    if not q.is_cuda:
        return flash_attention_backward_reference(q, k, v, bias, out, lse, grad, scale, causal, rate, seed)
    if use_fused_backward(q.dtype, q.shape[2]):
        return backward_fused(q, k, v, bias, out, lse, grad, scale, causal, rate, seed)
    return backward_pair(split_route(q.dtype, q.shape[2]), q, k, v, bias, out, lse, grad, scale, causal, rate, seed)


def _backward_args(q, k, v, bias, out, lse, grad, scale, causal, rate, seed):
    """The contiguous (16-byte aligned, for the tensor-core pairs' cp.async)
    inputs' pointers, and the launch arguments' tail. delta = rowsum(dO * O)
    is a PyTorch op in fp32 here, as JAX computes it in XLA outside its
    kernels; it is returned so that it lives until the launches."""
    q, k, v, grad = (_aligned(x) for x in (q, k, v, grad.to(q.dtype)))
    bias = bias.contiguous()
    delta = (grad.float() * out.float()).sum(dim=-1)
    thresh, keep_prob, seed = _dropout_args(rate, seed)
    common = (q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), grad.data_ptr(),
              lse.data_ptr(), delta.data_ptr())
    return (q, k, v, grad, bias, delta), common, (scale, int(causal), thresh, keep_prob, seed)


def backward_fused(q, k, v, bias, out, lse, grad, scale: float, causal: bool = False, rate: float = 0.0,
                   seed: int = 0):
    """One launch of ``csrc/flash_bwd.cu::flash_bwd_fused`` (fp32 or bf16,
    any kernel head dim; the kv tiles add dQ into a zeroed fp32 buffer in
    kv-tile order, kept by one zeroed int32 counter per (bh, q tile), so dQ
    is bitwise repeatable) on CUDA tensors; returns (dq, dk, dv)."""
    global launches_bwd_fused
    bh, t, d = q.shape
    kept, common, tail = _backward_args(q, k, v, bias, out, lse, grad, scale, causal, rate, seed)
    dk, dv = torch.empty_like(kept[1]), torch.empty_like(kept[2])
    dq32 = torch.zeros((bh, t, d), dtype=torch.float32, device=q.device)
    order = torch.zeros((bh, -(-t // 64)), dtype=torch.int32, device=q.device)
    lib = _library("flash_bwd")
    with torch.cuda.device(q.device):
        err = lib.flash_bwd_fused(*common, dq32.data_ptr(), dk.data_ptr(), dv.data_ptr(), order.data_ptr(), bh, t,
                                  k.shape[1], d,
                                  *tail, int(q.dtype == torch.bfloat16), torch.cuda.current_stream(q.device).cuda_stream)
    raise_on(lib, "flash_bwd_fused", err)
    launches_bwd_fused += 1
    return dq32.to(q.dtype), dk, dv


def backward_pair(route: str, q, k, v, bias, out, lse, grad, scale: float, causal: bool = False,
                  rate: float = 0.0, seed: int = 0):
    """One launch each of the dq and the dkv kernel of the split pair of
    ``route`` on CUDA tensors: "tc" (bf16; ``csrc/flash_bwd_tc.cu`` at head
    dim 32 and 64, ``csrc/flash_bwd_tc128.cu`` at 128), "tf32x3"
    (``csrc/flash_bwd_tf32x3.cu``, fp32) or "cuda_core"
    (``csrc/flash_bwd.cu``, either type, any kernel head dim); returns
    (dq, dk, dv), each written once (deterministic). A kernel that fails
    to build or launch raises: no other route stands in."""
    bh, t, d = q.shape
    s = k.shape[1]
    if route in TC_KERNELS:
        tc_check_shape(d, t, s, route)
        if q.dtype != TC_DTYPES[route]:
            raise TypeError(f"flash_bwd_{route}: {TC_DTYPES[route]} only, got {q.dtype}")
    lib_name, dq_name, dkv_name = pair_kernels(route, d)
    kept, common, tail = _backward_args(q, k, v, bias, out, lse, grad, scale, causal, rate, seed)
    if route not in TC_KERNELS:
        tail = tail + (int(q.dtype == torch.bfloat16),)
    dq, dk, dv = torch.empty_like(kept[0]), torch.empty_like(kept[1]), torch.empty_like(kept[2])
    lib = _library(lib_name)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = getattr(lib, dq_name)(*common, dq.data_ptr(), bh, t, s, d, *tail, stream)
        raise_on(lib, dq_name, err)
        _count(dq_name, d)
        err = getattr(lib, dkv_name)(*common, dk.data_ptr(), dv.data_ptr(), bh, t, s, d, *tail, stream)
        raise_on(lib, dkv_name, err)
        _count(dkv_name, d)
    return dq, dk, dv


_P = ctypes.c_void_p
_I = ctypes.c_int
_TAIL = [ctypes.c_float, _I, ctypes.c_uint32, ctypes.c_float, ctypes.c_uint64, _I, _P]
_TC_TAIL = [ctypes.c_float, _I, ctypes.c_uint32, ctypes.c_float, ctypes.c_uint64, _P]
_SIGNATURES = {
    "flash_fwd": {
        "flash_fwd": [_P] * 6 + [_I] * 4 + _TAIL,
    },
    "flash_fwd_tc": {
        "flash_fwd_tc": [_P] * 6 + [_I] * 4 + _TC_TAIL,
    },
    "flash_fwd_tf32x3": {
        "flash_fwd_tf32x3": [_P] * 6 + [_I] * 4 + _TC_TAIL,
    },
    "flash_bwd": {
        "flash_bwd_fused": [_P] * 11 + [_I] * 4 + _TAIL,
        "flash_bwd_dq": [_P] * 8 + [_I] * 4 + _TAIL,
        "flash_bwd_dkv": [_P] * 9 + [_I] * 4 + _TAIL,
    },
    "flash_bwd_tc": {
        "flash_bwd_dq_tc": [_P] * 8 + [_I] * 4 + _TC_TAIL,
        "flash_bwd_dkv_tc": [_P] * 9 + [_I] * 4 + _TC_TAIL,
    },
    "flash_bwd_tc128": {
        "flash_bwd_dq_tc128": [_P] * 8 + [_I] * 4 + _TC_TAIL,
        "flash_bwd_dkv_tc128": [_P] * 9 + [_I] * 4 + _TC_TAIL,
    },
    "flash_bwd_tf32x3": {
        "flash_bwd_dq_tf32x3": [_P] * 8 + [_I] * 4 + _TC_TAIL,
        "flash_bwd_dkv_tf32x3": [_P] * 9 + [_I] * 4 + _TC_TAIL,
    },
}


def _library(name: str) -> ctypes.CDLL:
    return bind(name, _SIGNATURES[name])
