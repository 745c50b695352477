"""Dynamic convolution: the CUDA kernels' wrappers, the autograd Function
and the plain versions.

Counterpart of ``fbk_fairseq_st_tpu/ops/pallas/conv_kernels.py``
(``dynamic_conv_pallas`` :98-114, the ``_dynamic_conv_kernel`` :24 it
launches and ``_xla_reference`` :47). The kernels are
``csrc/dynamic_conv.cu``: ``dynamic_conv_fwd`` (the Pallas kernel) and
``dynamic_conv_bwd`` (dx and dw in one launch; JAX took the VJP of
``_xla_reference`` through XLA). The source's note says what bounds them.

``dynamic_conv(x, w, padding_l)`` keeps the JAX contract: x (B, T, C), w
(B, T, H, K) normalized per-position kernels in x's type, ``out[b, t, c] =
sum_k w[b, t, c // (C/H), k] * x[b, t + k - padding_l, c]`` with zeros
outside [0, T), summed in fp32 and returned in x's type. It is
differentiable in x and w and saves (x, w), as JAX's ``_fwd`` does.

Routing is by the tensors' device and nothing else: CUDA tensors launch the
kernels or raise; CPU tensors run ``dynamic_conv_reference`` and
``dynamic_conv_backward_reference``. Unlike the JAX entry there is no
C % 128 or T-block gate: the kernels take any C with C % H == 0.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from .build import bind, raise_on

# Kernel launches since the last reset (the plain versions do not count).
launches_fwd = 0
launches_bwd = 0


def reset_launches() -> None:
    global launches_fwd, launches_bwd
    launches_fwd = launches_bwd = 0


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def _compute_dtype(x: torch.Tensor) -> torch.dtype:
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def unfold(x, kernel_size: int, padding_l: int):
    """x (B, T, C) -> windows (B, T, K, C): windows[b, t, k] = x[b, t + k -
    padding_l], zero outside [0, T) (JAX ``_unfold``)."""
    t = x.shape[1]
    pad_r = kernel_size - 1 - padding_l
    xp = F.pad(x, (0, 0, padding_l, max(pad_r, 0)))
    if pad_r < 0:
        xp = xp[:, :pad_r]
    return torch.stack([xp[:, k:k + t] for k in range(kernel_size)], dim=2)


def dynamic_conv_reference(x, w, padding_l: int):
    """The unfold + einsum of ``_xla_reference``, in fp32 (fp64 for fp64
    inputs), returned in x's type."""
    ct = _compute_dtype(x)
    b, t, c = x.shape
    h, k = w.shape[2:]
    win = unfold(x.to(ct), k, padding_l).reshape(b, t, k, h, c // h)
    return torch.einsum("bthk,btkhd->bthd", w.to(ct), win).reshape(b, t, c).to(x.dtype)


def dynamic_conv_backward_reference(x, w, grad, padding_l: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dx, dw) of ``dynamic_conv`` written out, in fp32 (fp64 for fp64):

        dw[b, t, h, k] = sum_{c of head h} g[b, t, c] x[b, t + k - padding_l, c]
        dx[b, s, c]    = sum_k w[b, s - k + padding_l, h, k] g[b, s - k + padding_l, c]

    dx scatters each tap's w * g back to the position it read. Returned in
    x's and w's types."""
    ct = _compute_dtype(x)
    b, t, c = x.shape
    h, k = w.shape[2:]
    g = grad.to(ct).reshape(b, t, h, c // h)
    win = unfold(x.to(ct), k, padding_l).reshape(b, t, k, h, c // h)
    dw = torch.einsum("bthd,btkhd->bthk", g, win)
    taps = torch.einsum("bthk,bthd->btkhd", w.to(ct), g).reshape(b, t, k, c)
    dx = torch.zeros((b, t, c), dtype=ct, device=x.device)
    for tap in range(k):
        shift = tap - padding_l  # position s read x[s + shift]
        lo, hi = max(0, shift), min(t, t + shift)
        if lo < hi:
            dx[:, lo:hi] += taps[:, lo - shift:hi - shift, tap]
    return dx.to(x.dtype), dw.to(w.dtype)


# ---------------------------------------------------------------------------
# Public entry and the autograd Function
# ---------------------------------------------------------------------------

def _check(x, w, padding_l: int) -> None:
    if x.dim() != 3 or w.dim() != 4:
        raise ValueError("dynamic_conv: x must be (B, T, C) and w (B, T, H, K)")
    b, t, c = x.shape
    h, k = w.shape[2:]
    if tuple(w.shape[:2]) != (b, t):
        raise ValueError(f"dynamic_conv: shapes x {tuple(x.shape)} w {tuple(w.shape)}")
    if t == 0 or c == 0 or h == 0 or k == 0 or c % h != 0:
        raise ValueError(f"dynamic_conv: needs T, C, H, K > 0 and C % H == 0, got x {tuple(x.shape)} "
                         f"w {tuple(w.shape)}")
    if padding_l < 0:
        raise ValueError(f"dynamic_conv: padding_l {padding_l} < 0")
    if x.device != w.device:
        raise ValueError(f"dynamic_conv: x on {x.device}, w on {w.device}")
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"dynamic_conv: unsupported device {x.device}")
    if x.is_cuda:
        if x.dtype not in (torch.float32, torch.bfloat16) or w.dtype != x.dtype:
            raise TypeError(f"dynamic_conv: x and w must share fp32 or bf16, got {x.dtype}/{w.dtype}")
        if b > 65535:
            raise ValueError(f"dynamic_conv: batch {b} > 65535")


class _DynamicConv(torch.autograd.Function):
    """The ``dynamic_conv_pallas`` custom_vjp: saves (x, w); gradients for
    x and w (none for padding_l)."""

    @staticmethod
    def forward(ctx, x, w, padding_l):
        out = _forward_cuda(x, w, padding_l) if x.is_cuda else dynamic_conv_reference(x, w, padding_l)
        ctx.save_for_backward(x, w)
        ctx.padding_l = padding_l
        return out

    @staticmethod
    def backward(ctx, grad):
        x, w = ctx.saved_tensors
        if x.is_cuda:
            dx, dw = dynamic_conv_backward(x, w, grad, ctx.padding_l)
        else:
            dx, dw = dynamic_conv_backward_reference(x, w, grad, ctx.padding_l)
        return dx, dw, None


def dynamic_conv(x, w, padding_l: int):
    """sum_k w[b, t, h(c), k] * x[b, t + k - padding_l, c]: (B, T, C) in x's
    type, differentiable in x and w."""
    _check(x, w, padding_l)
    return _DynamicConv.apply(x, w, int(padding_l))


# ---------------------------------------------------------------------------
# CUDA launches
# ---------------------------------------------------------------------------

def _dims(x, w, padding_l):
    b, t, c = x.shape
    h, k = w.shape[2:]
    return b, t, c, h, k, int(padding_l), int(x.dtype == torch.bfloat16)


def _forward_cuda(x, w, padding_l):
    global launches_fwd
    x, w = x.contiguous(), w.contiguous()
    out = torch.empty_like(x)
    lib = _library()
    with torch.cuda.device(x.device):
        err = lib.dynamic_conv_fwd(x.data_ptr(), w.data_ptr(), out.data_ptr(), *_dims(x, w, padding_l),
                                   torch.cuda.current_stream(x.device).cuda_stream)
    raise_on(lib, "dynamic_conv_fwd", err)
    launches_fwd += 1
    return out


def dynamic_conv_backward(x, w, grad, padding_l: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dx, dw) of ``dynamic_conv`` on CUDA tensors, by one launch of the
    backward kernel."""
    global launches_bwd
    x, w = x.contiguous(), w.contiguous()
    grad = grad.to(x.dtype).contiguous()
    dx = torch.empty_like(x)
    dw = torch.empty_like(w)
    lib = _library()
    with torch.cuda.device(x.device):
        err = lib.dynamic_conv_bwd(x.data_ptr(), w.data_ptr(), grad.data_ptr(), dx.data_ptr(), dw.data_ptr(),
                                   *_dims(x, w, padding_l), torch.cuda.current_stream(x.device).cuda_stream)
    raise_on(lib, "dynamic_conv_bwd", err)
    launches_bwd += 1
    return dx, dw


_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "dynamic_conv_fwd": [_P] * 3 + [_I] * 7 + [_P],
    "dynamic_conv_bwd": [_P] * 5 + [_I] * 7 + [_P],
}


def _library() -> ctypes.CDLL:
    return bind("dynamic_conv", _SIGNATURES)
