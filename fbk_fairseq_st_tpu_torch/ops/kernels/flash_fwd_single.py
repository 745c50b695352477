"""The single-pass attention forward: the CUDA kernels' wrapper and their
plain version.

Counterpart of ``fbk_fairseq_st_tpu/scripts/bench_flash_sweep.py``
(``_fwd_single_kernel`` :28, ``fwd_single`` :60): one tile of ``t_block``
query rows against the whole S, a plain softmax with no online rescale of
the output, P rounded to the input type before the P.V product. It is a
candidate of the flash sweep (``scripts/bench_flash_sweep.py``) and nothing
on a model path calls it. The kernels are ``csrc/flash_fwd_single.cu``.

``flash_fwd_single`` takes the port's flash layouts: q (BH, T, D), k/v
(BH, S, D) in fp32 or bf16, ``mask_bias`` (BH, S) fp32, and returns out
(BH, T, D) in q's type and lse (BH, T) fp32. On a CUDA tensor it launches
the kernel or raises (``check_shape``): both are built for D = 64 only;
bf16 runs on the tensor cores at ``t_block`` 64 and 128 and any S; fp32
on the CUDA cores at ``t_block`` 8 and 16, where the rows' scores over S
must fit the block's shared memory (``smem_bytes`` <= ``SMEM_LIMIT``). On
a CPU tensor it runs ``flash_fwd_single_reference``, at any shape.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ..core import NEG_INF
from .build import SMEM_LIMIT, bind, raise_on

HEAD_DIM = 64  # the one head dim the kernels are built for
T_BLOCKS = {torch.float32: (8, 16), torch.bfloat16: (64, 128)}  # built tiles, per input type
DEFAULT_T_BLOCK = {torch.float32: 16, torch.bfloat16: 64}  # the faster tile at the sweep's shapes (PERF.md)
_CHUNK = 64  # keys the kernels stage per chunk
_STAGES = 3  # the bf16 kernel's ring of K + V chunks

# Kernel launches since the last reset (the plain version does not count).
launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


def smem_bytes(t_block: int, s: int, dtype=torch.float32) -> int:
    """Shared memory of one block. fp32: the rows' scores over the whole S,
    the q tile and one k/v chunk (rows padded to D + 1 floats). bf16: the q
    tile and a ring of 64-key K and V chunks, whatever S is."""
    if dtype == torch.bfloat16:
        return 2 * HEAD_DIM * (t_block + _STAGES * 2 * _CHUNK)
    return 4 * (t_block * s + (t_block + _CHUNK) * (HEAD_DIM + 1))


def check_shape(dtype, d: int, s: int, t_block: int, bh: int = 1) -> None:
    """Raise ValueError for a shape the kernel of ``dtype`` is not built
    for; needs no card."""
    if d != HEAD_DIM or t_block not in T_BLOCKS[dtype]:
        raise ValueError(f"flash_fwd_single: the {dtype} kernel takes D {HEAD_DIM} and t_block in "
                         f"{T_BLOCKS[dtype]}, got D {d} t_block {t_block}")
    if smem_bytes(t_block, s, dtype) > SMEM_LIMIT:
        raise ValueError(f"flash_fwd_single: t_block {t_block} x S {s} needs {smem_bytes(t_block, s, dtype)} "
                         f"bytes of shared memory, over the {SMEM_LIMIT} a block can have")
    if bh > 65535:
        raise ValueError(f"flash_fwd_single: bh {bh} > 65535")


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


def flash_fwd_single(q, k, v, mask_bias, scale: float, causal: bool = False, t_block: Optional[int] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """softmax(scale * q k^T + bias[key], causal-masked) v in one pass over
    the whole S per ``t_block`` rows (default ``DEFAULT_T_BLOCK``).
    Returns (out, lse)."""
    if q.dim() != 3 or k.shape != v.shape or k.shape[0] != q.shape[0] or k.shape[2] != q.shape[2]:
        raise ValueError(f"flash_fwd_single: shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    bh, t, d = q.shape
    s = k.shape[1]
    if tuple(mask_bias.shape) != (bh, s):
        raise ValueError(f"flash_fwd_single: mask_bias {tuple(mask_bias.shape)} != {(bh, s)}")
    if not q.is_cuda:
        return flash_fwd_single_reference(q, k, v, mask_bias, scale, causal)
    if q.dtype not in T_BLOCKS or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_fwd_single: q/k/v must share fp32 or bf16, got {q.dtype}/{k.dtype}/{v.dtype}")
    t_block = DEFAULT_T_BLOCK[q.dtype] if t_block is None else t_block
    check_shape(q.dtype, d, s, t_block, bh)
    return _forward_cuda(q, k, v, mask_bias.to(torch.float32), float(scale), bool(causal), t_block)


def _forward_cuda(q, k, v, bias, scale, causal, t_block):
    global launches
    # contiguous, and 16-byte aligned for the bf16 kernel's cp.async
    q, k, v = (x if x.data_ptr() % 16 == 0 else x.clone() for x in (q.contiguous(), k.contiguous(), v.contiguous()))
    bias = bias.contiguous()
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
