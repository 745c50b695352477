"""Dynamic convolution: the CUDA kernels' wrappers, the autograd Function
and the plain versions.

Counterpart of ``fbk_fairseq_st_tpu/ops/pallas/conv_kernels.py``
(``dynamic_conv_pallas`` :98-114, the ``_dynamic_conv_kernel`` :24 it
launches and ``_xla_reference`` :47). The kernels are
``csrc/dynamic_conv_tc.cu``, on the tensor cores: ``dynamic_conv_fwd_tc``
(the Pallas kernel) and ``dynamic_conv_bwd_tc`` (dx and dw in one launch;
JAX took the VJP of ``_xla_reference`` through XLA), bf16 by
``mma.sync.m16n8k16`` and fp32 in 3xTF32 products. ``csrc/dynamic_conv.cu``
keeps the first CUDA-core pair (``dynamic_conv_fwd`` / ``dynamic_conv_bwd``),
reached only by a direct call with ``route="cuda_core"``, to compare them.
The sources' notes say what bounds them.

``dynamic_conv(x, w, padding_l)`` keeps the JAX contract: x (B, T, C), w
(B, T, H, K) normalized per-position kernels in x's type, ``out[b, t, c] =
sum_k w[b, t, c // (C/H), k] * x[b, t + k - padding_l, c]`` with zeros
outside [0, T), summed in fp32 and returned in x's type. It is
differentiable in x and w and saves (x, w), as JAX's ``_fwd`` does.

Routing is by the tensors' device and nothing else: CUDA tensors launch the
tensor-core kernels or raise; CPU tensors run ``dynamic_conv_reference`` and
``dynamic_conv_backward_reference``. Unlike the JAX entry there is no
C % 128 or T-block gate: the kernels take any B, T, K >= 1 and C with
C % H == 0 (K up to what a block's shared memory holds: 369 in fp32 and
530 in bf16 at C/H >= 64; ``_check`` refuses more).

``tile_plan`` is the tensor-core kernels' tile plan in Python (the grid,
each block's window, the band's index maps and the dw diagonals), which
the wrapper passes to the kernels and they check; ``emulate_forward`` and
``emulate_backward`` run the same plan with a matrix product on each tile,
so the CPU tests reach the index arithmetic of the CUDA source.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from .build import SMEM_LIMIT, bind, raise_on

# Kernel launches since the last reset (the plain versions do not count).
launches_fwd = 0  # the first, CUDA-core kernels, by direct call only
launches_bwd = 0
launches_fwd_tc = 0  # the tensor-core kernels, every model path
launches_bwd_tc = 0

ROUTES = ("tc", "cuda_core")


def reset_launches() -> None:
    global launches_fwd, launches_bwd, launches_fwd_tc, launches_bwd_tc
    launches_fwd = launches_bwd = launches_fwd_tc = launches_bwd_tc = 0


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
# The tensor-core kernels' tile plan (csrc/dynamic_conv_tc.cu), in Python
# ---------------------------------------------------------------------------

TILE = 64  # positions a block: 4 warps of 16 (kTile)
WARP_ROWS = 16


class TilePlan(NamedTuple):
    """The grid and tiles of ``dynamic_conv_fwd_tc`` / ``dynamic_conv_bwd_tc``
    for (B, T, C, H, K): a block per (batch row, head, position tile), on
    ``gridDim.x``, the backward's dx blocks then as many dw blocks. A warp's
    band is 16 rows by 16 ``ksteps`` window columns; a block stages
    ``window`` rows of the head's channels, ``chunk`` at a time."""

    b: int
    t: int
    h: int
    r: int          # channels a head
    k: int
    n_tiles: int    # position tiles of a (batch row, head)
    ksteps: int     # 16-row k-steps of a warp's band: ceil((K + 15) / 16)
    window: int     # window rows a block stages: TILE - 16 + 16 ksteps
    chunk: int      # channels a step: 16, 32 or 64 (bf16)
    blocks: int     # B H n_tiles, twice that in the backward
    smem: int       # shared memory a block


def chunk_for(r: int, dtype) -> int:
    """Channels a step: 16, 32 or 64 in bf16, 16 or 32 in fp32."""
    return 16 if r <= 16 else 32 if r <= 32 or dtype != torch.bfloat16 else 64


def tile_plan(b: int, t: int, c: int, h: int, k: int, dtype=torch.bfloat16, backward: bool = False) -> TilePlan:
    """The plan, and its shared memory as ``Layout`` lays it out: a band
    block's window in rows of chunk + 8 elements, its w rows of rw 16-byte
    pieces (K elements from any offset in a piece), and 4 band tiles
    of 16 rows of 16 ksteps + 8 bf16 or + 4 floats; a dw block's g rows and
    x window in rows of chunk + 8 bf16 or chunk + 4 floats and a 64 x
    (16 ksteps + 16) fp32 tile of sums."""
    item = torch.tensor([], dtype=dtype).element_size()
    r = c // h
    n_tiles = -(-t // TILE)
    ksteps = (k + 30) // WARP_ROWS
    window = TILE - WARP_ROWS + WARP_ROWS * ksteps
    chunk = chunk_for(r, dtype)
    rw = (k * item + 15) // 16 + 1
    nj = WARP_ROWS * ksteps
    la = 2 * (nj + 8) if item == 2 else 4 * (nj + 4)
    smem = window * (item * (chunk + 8) + 16 * rw) + TILE * la
    if backward:
        lg = 2 * (chunk + 8) if item == 2 else 4 * (chunk + 4)
        smem = max(smem, (TILE + window) * lg + 4 * TILE * (nj + WARP_ROWS))
    return TilePlan(b, t, h, r, k, n_tiles, ksteps, window, chunk, b * h * n_tiles * (2 if backward else 1), smem)


def block_coords(plan: TilePlan, i: int) -> Tuple[str, int, int, int]:
    """(kind, batch row, head, first position) of block ``i``: kind "band"
    (the forward, or dx in the backward) or "dw"."""
    if not 0 <= i < plan.blocks:
        raise IndexError(f"block {i} of {plan.blocks}")
    n = plan.b * plan.h * plan.n_tiles
    kind = "dw" if i >= n else "band"
    j = i - n if kind == "dw" else i
    bh = j // plan.n_tiles
    return kind, bh // plan.h, bh % plan.h, (j % plan.n_tiles) * TILE


def window_base(kind: str, t0: int, k: int, padding_l: int) -> int:
    """The position of window row 0 of a block at t0: x's for the forward
    and dw, g's for dx (the first position whose taps reach t0)."""
    return t0 + padding_l - (k - 1) if kind == "dx" else t0 - padding_l


def band_index(kind: str, k: int, ksteps: int, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(w row offset, tap) of each element (i, j) of a warp's 16 x 16 ksteps
    band, tap -1 off the band. Forward: w[tw + i, j - i]; dx: w[tw + j,
    i - j + K - 1] (k = s - t + padding_l); on the band 0 <= j - i < K."""
    i = torch.arange(WARP_ROWS, device=device)[:, None]
    j = torch.arange(WARP_ROWS * ksteps, device=device)[None, :]
    on = (j - i >= 0) & (j - i < k)
    if kind == "dx":
        row, tap = j.expand(WARP_ROWS, -1), i - j + k - 1
    else:
        row, tap = i.expand(-1, j.shape[1]), j - i
    return row, torch.where(on, tap, -1)


def _rows(a, first: int, n: int):
    """Rows first..first + n of a (B, H, T, ...) tensor along T, zero
    outside [0, T)."""
    t = a.shape[2]
    pos = torch.arange(first, first + n, device=a.device)
    ok = (pos >= 0) & (pos < t)
    out = a[:, :, pos.clamp(0, t - 1)]
    return out * ok.view(1, 1, n, *([1] * (a.dim() - 3))).to(out.dtype)


def _band(wh, kind: str, tw: int, plan: TilePlan):
    """A warp's band tiles (B, H, 16, 16 ksteps) from wh (B, H, T, K), its
    w rows from tw."""
    row, tap = band_index(kind, plan.k, plan.ksteps, wh.device)
    rows = _rows(wh, tw, int(row.max()) + 1)  # (B, H, n, K)
    vals = rows[:, :, row, tap.clamp(min=0)]
    return torch.where(tap >= 0, vals, torch.zeros((), dtype=vals.dtype, device=vals.device))


def dw_diagonals(p, k: int):
    """dw rows from a warp's (..., 16, 16 ksteps) product G . Xwin^T: row i
    keeps taps 0..K - 1, which sit at columns i..i + K - 1."""
    idx = torch.arange(WARP_ROWS, device=p.device)[:, None] + torch.arange(k, device=p.device)[None, :]
    return torch.gather(p, -1, idx.expand(*p.shape[:-2], -1, -1))


def _heads(a, h: int):
    """(B, T, C) -> (B, H, T, r)."""
    b, t, c = a.shape
    return a.reshape(b, t, h, c // h).permute(0, 2, 1, 3)


def emulate_forward(x, w, padding_l: int, kind: str = "fwd", matmul=torch.matmul):
    """The forward (``kind`` "fwd", x) or dx ("dx", x := g) as the kernel
    tiles it, in fp32 (fp64 for fp64): for each position tile and warp,
    ``matmul`` of the band tile and the warp's window rows. Returns the
    result in x's type."""
    ct = _compute_dtype(x)
    b, t, c = x.shape
    h, k = w.shape[2:]
    plan = tile_plan(b, t, c, h, k, x.dtype)
    xh, wh = _heads(x.to(ct), h), w.to(ct).permute(0, 2, 1, 3)
    out = torch.zeros_like(xh)
    nj = WARP_ROWS * plan.ksteps
    for tile in range(plan.n_tiles):
        t0 = tile * TILE
        base = window_base(kind, t0, k, padding_l)
        for warp in range(TILE // WARP_ROWS):
            p0 = t0 + WARP_ROWS * warp
            if p0 >= t:
                break
            tw = (base if kind == "dx" else t0) + WARP_ROWS * warp
            res = matmul(_band(wh, kind, tw, plan), _rows(xh, base + WARP_ROWS * warp, nj))
            n = min(WARP_ROWS, t - p0)
            out[:, :, p0:p0 + n] = res[:, :, :n]
    return out.permute(0, 2, 1, 3).reshape(b, t, c).to(x.dtype)


def emulate_backward(x, w, grad, padding_l: int, matmul=torch.matmul):
    """(dx, dw) as the backward kernel tiles them: dx by ``emulate_forward``
    with the transposed band; dw, for each tile and warp, ``matmul`` of the
    warp's 16 rows of g and its window of x, transposed, summed over the
    channel chunks in order, and the K diagonals kept."""
    ct = _compute_dtype(x)
    b, t, c = x.shape
    h, k = w.shape[2:]
    plan = tile_plan(b, t, c, h, k, x.dtype)
    dx = emulate_forward(grad, w, padding_l, "dx", matmul)
    xh, gh = _heads(x.to(ct), h), _heads(grad.to(ct), h)
    dw = torch.zeros((b, h, t, k), dtype=ct, device=x.device)
    nj = WARP_ROWS * plan.ksteps
    for tile in range(plan.n_tiles):
        t0 = tile * TILE
        base = window_base("dw", t0, k, padding_l)
        for warp in range(TILE // WARP_ROWS):
            p0 = t0 + WARP_ROWS * warp
            if p0 >= t:
                break
            g16 = _rows(gh, p0, WARP_ROWS)
            xw = _rows(xh, base + WARP_ROWS * warp, nj)
            acc = torch.zeros((b, h, WARP_ROWS, k), dtype=ct, device=x.device)
            for cc in range(0, plan.r, plan.chunk):
                p = matmul(g16[..., cc:cc + plan.chunk], xw[..., cc:cc + plan.chunk].transpose(-1, -2))
                acc = acc + dw_diagonals(p, k)
            n = min(WARP_ROWS, t - p0)
            dw[:, :, p0:p0 + n] = acc[:, :, :n]
    return dx, dw.permute(0, 2, 1, 3).to(w.dtype)


def plan_coverage(b: int, t: int, c: int, h: int, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """How often the backward's blocks write each element of dx (B, T, C)
    and of dw (B, T, H, K), block by block from ``block_coords`` (the
    forward's grid is its band half): a block writes its positions below T
    of its head's channels, chunk by chunk, or all K taps."""
    plan = tile_plan(b, t, c, h, k, backward=True)
    dx = torch.zeros((b, t, c), dtype=torch.int32)
    dw = torch.zeros((b, t, h, k), dtype=torch.int32)
    for i in range(plan.blocks):
        kind, bb, hh, t0 = block_coords(plan, i)
        rows = slice(t0, min(t0 + TILE, t))
        if kind == "dw":
            dw[bb, rows, hh] += 1
        else:
            for cc in range(0, plan.r, plan.chunk):
                dx[bb, rows, hh * plan.r + cc:hh * plan.r + min(cc + plan.chunk, plan.r)] += 1
    return dx, dw


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
        plan = tile_plan(b, t, c, h, k, x.dtype, backward=True)
        if plan.smem > SMEM_LIMIT:
            raise ValueError(f"dynamic_conv: K {k} needs {plan.smem} bytes of shared memory a block, over the "
                             f"{SMEM_LIMIT} a block can have")
        if plan.blocks > 2 ** 31 - 1:
            raise ValueError(f"dynamic_conv: {plan.blocks} blocks, over gridDim.x's 2^31 - 1")


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


def _plan_args(x, w):
    plan = tile_plan(*x.shape, *w.shape[2:], x.dtype)
    return plan.n_tiles, plan.ksteps, plan.chunk


def _forward_cuda(x, w, padding_l, route: str = "tc"):
    global launches_fwd, launches_fwd_tc
    x, w = x.contiguous(), w.contiguous()
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if route == "tc":
        lib = _library_tc()
        with torch.cuda.device(x.device):
            err = lib.dynamic_conv_fwd_tc(x.data_ptr(), w.data_ptr(), out.data_ptr(), *_dims(x, w, padding_l),
                                          *_plan_args(x, w), stream)
        raise_on(lib, "dynamic_conv_fwd_tc", err)
        launches_fwd_tc += 1
    elif route == "cuda_core":
        lib = _library()
        with torch.cuda.device(x.device):
            err = lib.dynamic_conv_fwd(x.data_ptr(), w.data_ptr(), out.data_ptr(), *_dims(x, w, padding_l), stream)
        raise_on(lib, "dynamic_conv_fwd", err)
        launches_fwd += 1
    else:
        raise ValueError(f"dynamic_conv: route {route!r} not in {ROUTES}")
    return out


def dynamic_conv_forward(x, w, padding_l: int, route: str = "tc"):
    """The forward on CUDA tensors by one launch of ``route``'s kernel (no
    autograd): "tc", the kernel every model path takes, or "cuda_core",
    the first, CUDA-core one, reached only here, to compare the two."""
    _check(x, w, padding_l)
    if not x.is_cuda:
        raise ValueError("dynamic_conv_forward: CUDA tensors only (the CPU runs dynamic_conv_reference)")
    return _forward_cuda(x, w, padding_l, route)


def dynamic_conv_backward(x, w, grad, padding_l: int, route: str = "tc") -> Tuple[torch.Tensor, torch.Tensor]:
    """(dx, dw) of ``dynamic_conv`` on CUDA tensors, by one launch of
    ``route``'s backward kernel ("tc", or "cuda_core" by direct call)."""
    global launches_bwd, launches_bwd_tc
    if route not in ROUTES:
        raise ValueError(f"dynamic_conv: route {route!r} not in {ROUTES}")
    x, w = x.contiguous(), w.contiguous()
    grad = grad.to(x.dtype).contiguous()
    dx = torch.empty_like(x)
    dw = torch.empty_like(w)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    ptrs = (x.data_ptr(), w.data_ptr(), grad.data_ptr(), dx.data_ptr(), dw.data_ptr())
    if route == "tc":
        lib = _library_tc()
        with torch.cuda.device(x.device):
            err = lib.dynamic_conv_bwd_tc(*ptrs, *_dims(x, w, padding_l), *_plan_args(x, w), stream)
        raise_on(lib, "dynamic_conv_bwd_tc", err)
        launches_bwd_tc += 1
    else:
        lib = _library()
        with torch.cuda.device(x.device):
            err = lib.dynamic_conv_bwd(*ptrs, *_dims(x, w, padding_l), stream)
        raise_on(lib, "dynamic_conv_bwd", err)
        launches_bwd += 1
    return dx, dw


_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "dynamic_conv_fwd": [_P] * 3 + [_I] * 7 + [_P],
    "dynamic_conv_bwd": [_P] * 5 + [_I] * 7 + [_P],
}
_SIGNATURES_TC = {
    "dynamic_conv_fwd_tc": [_P] * 3 + [_I] * 10 + [_P],
    "dynamic_conv_bwd_tc": [_P] * 5 + [_I] * 10 + [_P],
}


def _library() -> ctypes.CDLL:
    return bind("dynamic_conv", _SIGNATURES)


def _library_tc() -> ctypes.CDLL:
    return bind("dynamic_conv_tc", _SIGNATURES_TC)
