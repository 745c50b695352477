"""Flash-attention forward: the CUDA kernel's wrapper and its plain version.

Counterpart of ``fbk_fairseq_st_tpu/ops/pallas/attention_kernel.py``
(public ``flash_attention`` :554, kernel ``_fwd_kernel`` :117). The kernel
is ``csrc/flash_fwd.cu``; its source note says what bounds it.

``flash_attention`` keeps the JAX contract: q (BH, T, D), k/v (BH, S, D),
``mask_bias`` (BH, S) additive key bias (0, or NEG_INF at pads), ``scale``
applied to q.k, optional top-left aligned causal mask. Unlike the JAX entry
it never pads the sequence axes (the kernel masks ragged T and S itself);
it zero-pads the head dim to the kernel's next size in {16, 32, 64, 128}
and slices the extra output columns off.

Routing is by the tensors' device and nothing else: CUDA tensors launch the
kernel or raise; CPU tensors run ``flash_attention_reference``.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from ..core import NEG_INF

KERNEL_HEAD_DIMS = (16, 32, 64, 128)

# Kernel launches since the last reset (the plain version does not count).
launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


def kernel_head_dim(d: int) -> int:
    for size in KERNEL_HEAD_DIMS:
        if d <= size:
            return size
    raise ValueError(f"flash_attention: head dim {d} > {KERNEL_HEAD_DIMS[-1]} is not supported")


def flash_attention_reference(q, k, v, mask_bias, scale: float, causal: bool = False
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain masked-softmax attention in fp32 with the kernel's semantics.
    Returns (out in q's dtype, lse (BH, T) fp32)."""
    t, s = q.shape[1], k.shape[1]
    scores = torch.einsum("btd,bsd->bts", q.float(), k.float()) * scale
    scores = scores + mask_bias.float()[:, None, :]
    if causal:
        rows = torch.arange(t, device=q.device)[:, None]
        cols = torch.arange(s, device=q.device)[None, :]
        scores = torch.where(cols <= rows, scores, NEG_INF)
    m = torch.clamp(scores.amax(dim=-1, keepdim=True), min=NEG_INF)
    p = torch.exp(scores - m)
    denom = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    out = torch.einsum("bts,bsd->btd", p, v.float()) / denom
    lse = (m + torch.log(denom))[..., 0]
    return out.to(q.dtype), lse


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


def flash_attention(q, k, v, mask_bias, scale: float, causal: bool = False,
                    dropout_rate: float = 0.0, return_lse: bool = False):
    """softmax(scale * q k^T + bias[key], causal-masked) v.

    Returns out (BH, T, D) in q's dtype, and with ``return_lse`` also the
    fp32 per-row log-sum-exp (BH, T)."""
    _check(q, k, v, mask_bias)
    if q.device.type == "cuda":
        out, lse = _flash_forward_cuda(q, k, v, mask_bias, scale, causal, dropout_rate)
    elif q.device.type == "cpu":
        if dropout_rate > 0.0:
            raise NotImplementedError(
                "attention dropout on the flash route needs the in-kernel Philox "
                "dropout (ROADMAP Queue B3); dropout-active calls take the dense path"
            )
        out, lse = flash_attention_reference(q, k, v, mask_bias, scale, causal)
    else:
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    return (out, lse) if return_lse else out


def _flash_forward_cuda(q, k, v, mask_bias, scale, causal, dropout_rate):
    global launches
    if dropout_rate > 0.0:
        raise NotImplementedError("in-kernel attention dropout (Philox) is ROADMAP Queue B3")
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        raise NotImplementedError("the flash backward kernel is ROADMAP Queue B2; call under torch.no_grad()")
    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: q/k/v must share fp32 or bf16, got {q.dtype}/{k.dtype}/{v.dtype}")
    bh, t, d = q.shape
    s = k.shape[1]
    if bh > 65535:
        raise ValueError(f"flash_attention: bh {bh} > 65535")
    dk = kernel_head_dim(d)
    if dk != d:
        pad = (0, dk - d)
        q, k, v = F.pad(q, pad), F.pad(k, pad), F.pad(v, pad)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    bias = mask_bias.to(torch.float32).contiguous()
    out = torch.empty((bh, t, dk), dtype=q.dtype, device=q.device)
    lse = torch.empty((bh, t), dtype=torch.float32, device=q.device)

    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            out.data_ptr(), lse.data_ptr(), bh, t, s, dk, float(scale),
            int(bool(causal)), int(q.dtype == torch.bfloat16), stream,
        )
    if err != 0:
        msg = lib.flash_fwd_error_string(err).decode()
        raise RuntimeError(f"flash_fwd launch failed: {msg} (cudaError {err})")
    launches += 1
    if dk != d:
        out = out[..., :d]
    return out, lse


def _library() -> ctypes.CDLL:
    from .build import load

    lib = load("flash_fwd")
    if lib.flash_fwd.argtypes is None:
        p = ctypes.c_void_p
        lib.flash_fwd.argtypes = [
            p, p, p, p, p, p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_int, ctypes.c_int, p,
        ]
        lib.flash_fwd.restype = ctypes.c_int
        lib.flash_fwd_error_string.argtypes = [ctypes.c_int]
        lib.flash_fwd_error_string.restype = ctypes.c_char_p
    return lib
