"""The single-pass attention forward: the CUDA kernel's wrapper and its
plain version.

Counterpart of ``fbk_fairseq_st_tpu/scripts/bench_flash_sweep.py``
(``_fwd_single_kernel`` :28, ``fwd_single`` :60): one tile of ``t_block``
query rows against the whole S at once, a plain softmax with no online
rescale, P rounded to the input type before the P.V product. It is a
candidate of the flash sweep (``scripts/bench_flash_sweep.py``) and nothing
on a model path calls it. The kernel is ``csrc/flash_fwd_single.cu``.

``flash_fwd_single`` takes the port's flash layouts: q (BH, T, D), k/v
(BH, S, D) in fp32 or bf16, ``mask_bias`` (BH, S) fp32, and returns out
(BH, T, D) in q's type and lse (BH, T) fp32. On a CUDA tensor it launches
the kernel or raises: the kernel is built for the sweep's D = 64 at
``t_block`` 8 and 16 only, and a shape whose rows' scores do not fit the
block's shared memory (``smem_bytes`` > ``SMEM_LIMIT``) is refused too. On
a CPU tensor it runs ``flash_fwd_single_reference``, at any shape.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ..core import NEG_INF
from .build import bind, raise_on

HEAD_DIM = 64  # the one head dim the kernel is built for
T_BLOCKS = (8, 16)
SMEM_LIMIT = 232448  # bytes of shared memory an H100 block can opt into
_CHUNK = 64  # keys the kernel stages per chunk

# Kernel launches since the last reset (the plain version does not count).
launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


def smem_bytes(t_block: int, s: int) -> int:
    """Shared memory of one block: the rows' fp32 scores over the whole S,
    the q tile and one k/v chunk (rows padded to D + 1 floats)."""
    return 4 * (t_block * s + (t_block + _CHUNK) * (HEAD_DIM + 1))


def flash_fwd_single_reference(q, k, v, mask_bias, scale: float, causal: bool = False
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense masked softmax with the Pallas kernel's arithmetic, in fp32
    (fp64 for fp64 inputs): m = max, p = exp(s - m), l = sum p, P = p /
    max(l, 1e-30) rounded to v's type, out = P v, lse = m + log(max(l,
    1e-30)). Returns (out in q's type, lse (BH, T))."""
    ct = torch.float64 if q.dtype == torch.float64 else torch.float32
    t, s = q.shape[1], k.shape[1]
    scores = torch.einsum("btd,bsd->bts", q.to(ct), k.to(ct)) * scale + mask_bias.to(ct)[:, None, :]
    if causal:
        rows = torch.arange(t, device=q.device)[:, None]
        cols = torch.arange(s, device=q.device)[None, :]
        scores = torch.where(cols <= rows, scores, NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    l = p.sum(dim=-1, keepdim=True)
    pn = (p / torch.clamp(l, min=1e-30)).to(v.dtype).to(ct)
    out = torch.einsum("bts,bsd->btd", pn, v.to(ct))
    return out.to(q.dtype), (m + torch.log(torch.clamp(l, min=1e-30)))[..., 0]


def flash_fwd_single(q, k, v, mask_bias, scale: float, causal: bool = False, t_block: int = 16
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """softmax(scale * q k^T + bias[key], causal-masked) v in one pass over
    the whole S per ``t_block`` rows. Returns (out, lse)."""
    if q.dim() != 3 or k.shape != v.shape or k.shape[0] != q.shape[0] or k.shape[2] != q.shape[2]:
        raise ValueError(f"flash_fwd_single: shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    bh, t, d = q.shape
    s = k.shape[1]
    if tuple(mask_bias.shape) != (bh, s):
        raise ValueError(f"flash_fwd_single: mask_bias {tuple(mask_bias.shape)} != {(bh, s)}")
    if not q.is_cuda:
        return flash_fwd_single_reference(q, k, v, mask_bias, scale, causal)
    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_fwd_single: q/k/v must share fp32 or bf16, got {q.dtype}/{k.dtype}/{v.dtype}")
    if d != HEAD_DIM or t_block not in T_BLOCKS:
        raise ValueError(f"flash_fwd_single: the kernel takes D {HEAD_DIM} and t_block in {T_BLOCKS}, "
                         f"got D {d} t_block {t_block}")
    if smem_bytes(t_block, s) > SMEM_LIMIT:
        raise ValueError(f"flash_fwd_single: t_block {t_block} x S {s} needs {smem_bytes(t_block, s)} bytes "
                         f"of shared memory, over the {SMEM_LIMIT} a block can have")
    if bh > 65535:
        raise ValueError(f"flash_fwd_single: bh {bh} > 65535")
    return _forward_cuda(q, k, v, mask_bias.to(torch.float32), float(scale), bool(causal), t_block)


def _forward_cuda(q, k, v, bias, scale, causal, t_block):
    global launches
    q, k, v, bias = q.contiguous(), k.contiguous(), v.contiguous(), bias.contiguous()
    bh, t, _ = q.shape
    s = k.shape[1]
    out = torch.empty_like(q)
    lse = torch.empty((bh, t), dtype=torch.float32, device=q.device)
    lib = bind("flash_fwd_single", _SIGNATURES)
    with torch.cuda.device(q.device):
        err = lib.flash_fwd_single(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), out.data_ptr(), lse.data_ptr(),
            bh, t, s, HEAD_DIM, t_block, scale, int(causal), int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    raise_on(lib, "flash_fwd_single", err)
    launches += 1
    return out, lse


_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {"flash_fwd_single": [_P] * 6 + [_I] * 5 + [ctypes.c_float, _I, _I, _P]}
