"""Flash-kernel sweep on the CUDA card, at the long-context train shapes.

Counterpart of ``fbk_fairseq_st_tpu/scripts/bench_flash_sweep.py``
(:150-183). It measures, on the card, what the port's flash dispatch is
chosen from:

  * the single-pass forward (``ops/kernels/flash_fwd_single.py``) at each
    ``t_block`` its bf16 kernel takes (64 and 128), each first checked
    against the port's flash forward (max |out difference| < 2e-2,
    asserted, as the JAX sweep's ``measure_fwd_single`` does);
  * the flash forward (on the tensor cores and on the CUDA cores) and the
    fused and the split backward;
  * the forward route: at each of the model path's attention calls
    (``TRAIN_BACKWARD_SHAPES``, at their dropout rates), in bf16 and in
    fp32, the tensor-core forward's device time (``flash_attention.forward_tc``
    in bf16, ``forward_tf32x3`` in fp32) against the CUDA-core forward's
    (``forward_cuda_core``; the median of a trace's launches,
    ``device_ms``), each launched directly after their outputs are checked
    against each other, from which ``gate_from`` reports, call by call and
    type by type, whether the tensor cores win
    (``flash_attention.tc_fwd_wins``);
  * the backward decision: at each of the model path's backward calls
    (``TRAIN_BACKWARD_SHAPES``), in bf16 and in fp32, the fused kernel's
    device time against the tensor-core split pair's ("tc" in bf16,
    "tf32x3" in fp32), each the device time of its kernels' launches (the
    median launch of each, ``device_ms``: dq + dkv against the fused
    kernel; delta's reduction, which both pay, and the fused kernel's dQ
    buffer are left out), from which ``gate_from`` reports, call by call and
    type by type, whether the pair wins (``flash_attention.pair_wins``);
    beside them the CUDA-core pair's
    (``flash_attention.backward_pair("cuda_core", ...)``), which no default
    route takes at these head dims, and which the tensor-core pairs at
    D 128 must beat (``d128_pair_wins``, in each type);
  * ``scaled_dot_product_attention`` with the same mask, forward and
    forward + backward, as a yardstick (the port never calls it): each of
    its fused backends (flash, memory-efficient, cuDNN) alone, through
    ``library_attention``, and the fastest kept with its name. PyTorch's
    math fallback is never timed: a shape that no fused backend takes
    has no library time;
  * the port's dense route against its flash route, forward + backward of
    ``MultiheadAttention`` (the encoder self-attention: 256 wide, 4 heads,
    attention dropout 0.1, training mode) and of ``ConvAttention2D`` (the
    frontend's time attention, F' = 20), at key lengths 128, 512 and 2048
    with batch x length = 16,384 rows as in the train steps: the device
    time (the kernels' summed durations in a torch.profiler trace, per
    call), which the dispatch is chosen from, the device kernels a call
    launches, and the wall time per call (CUDA events), which the host's
    launch overhead sets at these sizes.

The kernel shapes are the JAX sweep's: bh 32, S 2048, not causal (the 8 x
8192-frame train step's encoder self-attention) and bh 64, S 2048, causal;
D 64, bf16. The port's online kernels have fixed 64 x 64 tiles, so the JAX
sweep's (t_block, s_block) grid has no counterpart here. Times are CUDA
events around 20 calls, the best of 3 repeats, after a warm-up.

``chip_smoke.py`` drives ``run`` as a path and times with this module's
``time_ms``, ``device_ms``, ``device_busy`` and ``time_library`` too.

Run on a machine with the card:

    python -m fbk_fairseq_st_tpu_torch.scripts.bench_flash_sweep

It prints the card's ``nvidia-smi`` name and power limit, a table, and one
JSON line per measurement.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import warnings
from typing import Callable, Dict, List, Optional, Tuple

import torch

from ..ops import attention
from ..ops.conv_frontend import ConvAttention2D
from ..ops.core import NEG_INF, make_generators
from ..ops.kernels import flash_attention as fa
from ..ops.kernels import flash_fwd_single as single

D = 64
FWD_KERNEL_NAMES = {"tc": "flash_fwd_tc_kernel", "tf32x3": "flash_fwd_tf32x3_kernel",
                    "cuda_core": "flash_fwd_kernel"}  # by fwd_route
# each backward route's kernels in a trace (the fused kernel; dq, dkv); the
# "tc" names match the pair at D 32/64 (flash_bwd_dq_tc_kernel) and at D 128
# (flash_bwd_dq_tc128_kernel) alike, one call launching one of them
BWD_KERNEL_NAMES = {
    "fused": (lambda n: "flash_bwd_kv_kernel" in n and "true>" in n,),
    "cuda_core": ("flash_bwd_q_kernel", lambda n: "flash_bwd_kv_kernel" in n and "false>" in n),
    "tc": ("flash_bwd_dq_tc", "flash_bwd_dkv_tc"),
    "tf32x3": ("flash_bwd_dq_tf32x3_kernel", "flash_bwd_dkv_tf32x3_kernel"),
}
KERNEL_SHAPES = ((32, 2048, False), (64, 2048, True))  # (bh, S, causal)
# (name, bh, T, S, D, causal, dropout rate, keys padded on the left): the
# flash calls of the train steps, each with keys padded as the batches pad
# them: the conv_transformer step at batch 128 (4 heads, T' = 512 / 4
# frames, 48 target tokens), the dual-decoder step's auxiliary decoder at
# the same batch (64 transcript tokens), the lightconv decoder's encoder
# attention at batch 64 (16 heads, 56 tokens, sources padded on the left),
# the iwslt lightconv presets' (4 heads over 512 dims: D 128; batch 64)
# and the long-context step's encoder self-attention and time attention
# (batch 8, T' = 2048)
TRAIN_BACKWARD_SHAPES = [
    ("encoder_self_attention", 512, 128, 128, 64, False, 0.1, False),
    ("time_attention", 512, 128, 128, 20, False, 0.3, False),
    ("decoder_causal_self_attention", 512, 48, 48, 64, True, 0.1, False),
    ("cross_attention", 512, 48, 128, 64, False, 0.1, False),
    ("aux_decoder_causal_self_attention", 512, 64, 64, 64, True, 0.1, False),
    ("aux_decoder_cross_attention", 512, 64, 128, 64, False, 0.1, False),
    ("lightconv_cross_attention", 1024, 56, 56, 64, False, 0.1, True),
    ("lightconv_iwslt_cross_attention", 256, 56, 56, 128, False, 0.1, True),
    ("long_encoder_self_attention", 32, 2048, 2048, 64, False, 0.1, False),
    ("long_time_attention", 32, 2048, 2048, 20, False, 0.3, False),
]
# the pair against the fused kernel: bf16 of max|fused| (a rounding of
# ds and w_v to bf16 in the pair, none in the fused kernel), fp32 absolute
# (each within 1e-4 of the plain backward on the card)
BWD_AGREE = {torch.bfloat16: ("rtol", 1e-2), torch.float32: ("atol", 1e-4)}
# the two forwards' out and lse: bf16 one rounding of |out| < 4; fp32 each
# within 1e-4 of the plain forward
FWD_AGREE_ATOL = {torch.bfloat16: (2e-2, 1e-4), torch.float32: (1e-4, 1e-4)}
# the tensor-core route of each type, and gate_from's names for its forward
# flag, its backward flag and its device times (bf16 under the names they
# had before fp32 had a route)
TC_ROUTES = {"bfloat16": "tc", "float32": "tf32x3"}
FLAG_NAMES = {"tc": ("tc_fwd_wins", "pair_wins", ""), "tf32x3": ("tf32x3_fwd_wins", "tf32x3_bwd_wins", "tf32x3_")}
ROUTE_KEY_LENGTHS = (128, 512, 2048)
ROUTE_ROWS = 16384  # batch x key length of the train steps' encoder
SINGLE_ATOL = 2e-2
LIBRARY_BACKENDS = ("flash", "efficient", "cudnn")  # SDPA's fused backends


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def device_busy(fn: Callable, iters: int = 10) -> Tuple[float, float]:
    """The device kernels and copies that a call of ``fn`` launches and
    their summed duration in ms, per call over ``iters`` calls after a
    warm-up (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    return len(events) / iters, sum(e.device_time_total for e in events) / 1e3 / iters


def device_ms(fn: Callable, match, iters: int = 20, tries: int = 5) -> Optional[float]:
    """Device time of the one kernel launch of a call of ``fn`` whose name
    ``match`` accepts (a substring or a predicate): the median duration of
    the matching events of a torch.profiler (CUPTI) trace over ``iters``
    calls. A trace may miss some of its kernel records (chip runs saw one
    of a wrapper's 20 launches at a fifth of its CUDA-event time, a trace
    with none, and traces that kept 2 of 10 launches of a forward kernel;
    a full run saw three empty traces in a row for the CUDA-core pair at
    the iwslt call), so the median and not the sum is taken, and a trace
    that caught none is taken again, up to ``tries`` times; None if every
    try was empty."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    accept = match if callable(match) else (lambda name: match in name)
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        times = [e.device_time_total for e in prof.events()
                 if e.device_type == DeviceType.CUDA and accept(e.name)]
        if times:
            return float(statistics.median(times)) / 1e3
    return None


def time_ms(fn: Callable, iters: int = 20) -> float:
    """Best of 3 means over ``iters`` calls, by CUDA events, after a
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(3):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / iters)
    return best


def inputs(bh: int, s: int):
    """q, k, v (bh, s, D) of N(0, 1) in bf16 and a zero key bias, as the
    JAX sweep's ``_mk``."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn((bh, s, D), generator=gen, device="cuda").to(torch.bfloat16) for _ in range(3))
    return q, k, v, torch.zeros((bh, s), device="cuda")


def library_mask(bias, t: int, causal: bool, dtype):
    """The ``attn_mask`` of ``library_attention`` for a (BH, S) key bias,
    made once per input set (it reads the bias on the host): None when the
    bias is all zero; else the bias as (1, BH, 1, S), or materialised as
    (1, BH, T, S) with NEG_INF above the diagonal when also causal."""
    if not bool(bias.any()):
        return None
    mask = bias.to(dtype)[None, :, None, :]
    if causal:
        future = torch.ones((t, bias.shape[1]), dtype=torch.bool, device=bias.device).triu(1)
        mask = mask.masked_fill(future, NEG_INF)
    return mask


def library_attention(q, k, v, mask, scale: float, causal: bool, backend: str):
    """``scaled_dot_product_attention`` on the kernels' (BH, T, D) layouts,
    viewed as (1, BH, T, D), under ``sdpa_kernel`` with the one fused
    ``backend`` ("flash", "efficient" or "cudnn") allowed: a shape it does
    not take raises and never runs on the math path. ``mask`` from
    ``library_mask``; causal with no mask is ``is_causal`` (top-left
    aligned, as the kernels). Returns (BH, T, D). The port never calls
    this on a model path: it is the yardstick of the kernels' times."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from torch.nn.functional import scaled_dot_product_attention

    chosen = {"flash": SDPBackend.FLASH_ATTENTION, "efficient": SDPBackend.EFFICIENT_ATTENTION,
              "cudnn": SDPBackend.CUDNN_ATTENTION}[backend]
    with sdpa_kernel([chosen]):
        return scaled_dot_product_attention(q[None], k[None], v[None], attn_mask=mask,
                                            is_causal=causal and mask is None, scale=scale)[0]


def time_library(q, k, v, bias, scale: float, causal: bool, grad=None, iters: int = 20):
    """The fastest fused SDPA backend on these inputs, forward alone (grad
    None) or forward + backward of ``grad``: each backend timed alone
    (``time_ms``), those that refuse the shape skipped. Returns (ms,
    backend), or (None, None) when every backend refuses."""
    mask = library_mask(bias, q.shape[1], causal, q.dtype)
    if grad is not None:
        q, k, v = (x.detach().clone().requires_grad_() for x in (q, k, v))
    best = (None, None)
    for name in LIBRARY_BACKENDS:
        def call(name=name):
            out = library_attention(q, k, v, mask, scale, causal, name)
            if grad is not None:
                torch.autograd.grad(out, (q, k, v), grad)
        try:
            with warnings.catch_warnings():  # a refusing backend warns why, then raises
                warnings.simplefilter("ignore")
                call()
                torch.cuda.synchronize()
        except RuntimeError:
            continue
        ms = time_ms(call, iters)
        if best[0] is None or ms < best[0]:
            best = (ms, name)
    return best


def library_device_ms(q, k, v, bias, scale: float, causal: bool, grad=None, iters: int = 20, tries: int = 5):
    """SDPA's device time on these inputs: for each fused backend alone,
    the kernels one call launches, summed, per call over ``iters`` calls in
    a trace (``device_busy``); the forward alone, or with ``grad`` the
    backward alone (``autograd.grad`` of a forward made before the trace).
    Returns (ms, backend) of the fastest, or (None, None) when every
    backend refuses the shape. A trace that caught no device event reads
    0 ms: it is taken again (up to ``tries`` times), and a backend whose
    every trace was empty is left out."""
    mask = library_mask(bias, q.shape[1], causal, q.dtype)
    if grad is not None:
        q, k, v = (x.detach().clone().requires_grad_() for x in (q, k, v))
    best = (None, None)
    for name in LIBRARY_BACKENDS:
        try:
            with warnings.catch_warnings():  # a refusing backend warns why, then raises
                warnings.simplefilter("ignore")
                out = library_attention(q, k, v, mask, scale, causal, name)
                if grad is not None:  # cuDNN's backward refuses some shapes its forward takes (bh 70,000)
                    torch.autograd.grad(out, (q, k, v), grad, retain_graph=True)
                torch.cuda.synchronize()
        except RuntimeError:
            continue
        if grad is None:
            call = lambda name=name: library_attention(q, k, v, mask, scale, causal, name)  # noqa: E731
        else:
            call = lambda out=out: torch.autograd.grad(out, (q, k, v), grad, retain_graph=True)  # noqa: E731
        ms = 0.0
        for _ in range(tries):
            ms = device_busy(call, iters)[1]
            if ms > 0:
                break
        if ms > 0 and (best[0] is None or ms < best[0]):
            best = (ms, name)
    return best


def measure_single(bh: int, s: int, causal: bool, t_block: int) -> Dict:
    """The single-pass forward at ``t_block``: checked against the port's
    flash forward first, then timed."""
    row = {"kind": "single_pass_fwd", "bh": bh, "S": s, "D": D, "causal": causal, "t_block": t_block,
           "smem_bytes": single.smem_bytes(t_block, s, torch.bfloat16)}
    q, k, v, bias = inputs(bh, s)
    scale = D ** -0.5
    out, lse = single.flash_fwd_single(q, k, v, bias, scale, causal=causal, t_block=t_block)
    ref_out, ref_lse = fa.flash_attention(q, k, v, bias, scale, causal=causal, return_lse=True)
    err = (out.float() - ref_out.float()).abs().max().item()
    lse_err = (lse - ref_lse).abs().max().item()
    if not err < SINGLE_ATOL:
        raise AssertionError(f"single-pass fwd mismatch at bh {bh} S {s} t_block {t_block}: {err}")
    ms = time_ms(lambda: single.flash_fwd_single(q, k, v, bias, scale, causal=causal, t_block=t_block))
    return {**row, "max_abs_err_vs_flash": err, "lse_max_abs_err_vs_flash": lse_err, "fwd_ms": ms}


def measure_flash(bh: int, s: int, causal: bool) -> List[Dict]:
    """The flash forward, the fused and the split backward, and SDPA with
    the same mask, forward and forward + backward."""
    q, k, v, bias = inputs(bh, s)
    scale = D ** -0.5
    out, lse = fa.flash_attention(q, k, v, bias, scale, causal=causal, return_lse=True)
    g = torch.randn(out.shape, generator=torch.Generator(device="cuda").manual_seed(1), device="cuda").to(out.dtype)

    def bwd(fused: bool):
        def run():
            with fa.backward_forced(fused):
                return fa.flash_attention_backward(q, k, v, bias, out, lse, g, scale, causal)
        return run

    base = {"bh": bh, "S": s, "D": D, "causal": causal}
    fwd_ms = time_ms(lambda: fa.flash_attention(q, k, v, bias, scale, causal=causal))
    fwd_dev = {route: device_ms(lambda launch=launch: launch(q, k, v, bias, scale, causal, 0.0, 0),
                                FWD_KERNEL_NAMES[route])
               for route, launch in (("tc", fa.forward_tc), ("cuda_core", fa.forward_cuda_core))}
    fused_ms, split_ms = time_ms(bwd(True)), time_ms(bwd(False))
    fused_dev, split_dev = device_busy(bwd(True))[1], device_busy(bwd(False))[1]
    sdpa_fwd_ms, fwd_backend = time_library(q, k, v, bias, scale, causal)
    sdpa_ms, fwd_bwd_backend = time_library(q, k, v, bias, scale, causal, grad=g)
    return [
        {**base, "kind": "flash_fwd", "fwd_ms": fwd_ms, "route": fa.fwd_route(torch.bfloat16, D),
         "tc_fwd_device_ms": fwd_dev["tc"], "cuda_core_fwd_device_ms": fwd_dev["cuda_core"]},
        {**base, "kind": "flash_bwd_fused", "bwd_ms": fused_ms, "fwd_bwd_ms": fwd_ms + fused_ms,
         "bwd_device_ms": fused_dev},
        {**base, "kind": "flash_bwd_split", "bwd_ms": split_ms, "fwd_bwd_ms": fwd_ms + split_ms,
         "bwd_device_ms": split_dev, "route": fa.split_route(torch.bfloat16, D)},
        {**base, "kind": "sdpa", "fwd_ms": sdpa_fwd_ms, "fwd_backend": fwd_backend, "fwd_bwd_ms": sdpa_ms,
         "fwd_bwd_backend": fwd_bwd_backend,
         "note": "yardstick with the same mask, the fastest fused backend; the port never calls it"},
    ]


def backward_inputs(bh: int, t: int, s: int, d: int, causal: bool, rate: float, left: bool, seed: int = 0,
                    dtype=torch.bfloat16):
    """q, k, v, dO of N(0, 1) in ``dtype`` at the kernels' head dim
    (zero-padded from ``d``), a key bias with lengths in [S/2, S] (padded on
    the left when ``left``), and the forward's out and lse at ``rate`` with
    a seed drawn from ``seed``; returns (args of
    ``flash_attention_backward``)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    dk = fa.kernel_head_dim(d)
    pad = lambda x: torch.nn.functional.pad(x, (0, dk - d)).contiguous()  # noqa: E731
    q = pad(torch.randn((bh, t, d), generator=gen, device="cuda").to(dtype))
    k, v = (pad(torch.randn((bh, s, d), generator=gen, device="cuda").to(dtype)) for _ in range(2))
    g = pad(torch.randn((bh, t, d), generator=gen, device="cuda").to(dtype))
    lengths = torch.randint(s // 2, s + 1, (bh,), generator=gen, device="cuda")
    lengths[0] = s
    pos = torch.arange(s, device="cuda")[None, :]
    pads = pos < (s - lengths)[:, None] if left else pos >= lengths[:, None]
    bias = torch.where(pads, NEG_INF, 0.0)
    drop_seed = int(torch.randint(0, 2 ** 62, (), generator=torch.Generator().manual_seed(seed)))
    scale = d ** -0.5
    out, lse = fa.flash_attention(q, k, v, bias, scale, causal=causal, dropout_rate=rate,
                                  dropout_seed=drop_seed, return_lse=True)
    return q, k, v, bias, out, lse, g, scale, causal, rate, drop_seed


def measure_forward(name: str, bh: int, t: int, s: int, d: int, causal: bool, rate: float,
                    left: bool, dtype=torch.bfloat16) -> Dict:
    """The tensor-core forward of ``dtype`` ("tc" in bf16, "tf32x3" in
    fp32) against the CUDA-core forward at one attention call of the model
    path, each launched directly: the device time of its one kernel launch
    (``device_ms``, the median over a trace, which stays right when the
    trace misses records), which the route's rule reads, and the wall time
    of a call; their outputs are first checked against each other (out and
    lse within ``FWD_AGREE_ATOL``, asserted)."""
    q, k, v, bias, _, _, _, scale, causal, rate, seed = backward_inputs(bh, t, s, d, causal, rate, left,
                                                                        dtype=dtype)
    tc = fa.fwd_route(dtype, fa.kernel_head_dim(d))
    calls = {route: (lambda launch=fa.FORWARDS[route]: launch(q, k, v, bias, scale, causal, rate, seed))
             for route in (tc, "cuda_core")}
    (out_tc, lse_tc), (out_cc, lse_cc) = calls[tc](), calls["cuda_core"]()
    err = (out_tc.float() - out_cc.float()).abs().max().item()
    lse_err = (lse_tc - lse_cc).abs().max().item()
    if not (err <= FWD_AGREE_ATOL[dtype][0] and lse_err <= FWD_AGREE_ATOL[dtype][1]):
        raise AssertionError(f"{name} {dtype}: the tensor-core forward differs from the CUDA-core one by {err} "
                             f"(out), {lse_err} (lse)")
    row = {"kind": "fwd_route", "shape": name, "bh": bh, "T": t, "S": s, "D": d, "kernel_D": fa.kernel_head_dim(d),
           "causal": causal, "rate": rate, "dtype": str(dtype).replace("torch.", ""), "route": tc,
           "max_abs_err_tc_vs_cuda_core": err, "lse_max_abs_err_tc_vs_cuda_core": lse_err}
    for route, call in calls.items():
        row[f"{route}_device_ms"] = device_ms(call, FWD_KERNEL_NAMES[route])
        row[f"{route}_wall_ms"] = time_ms(call)
    return row


def measure_backward(name: str, bh: int, t: int, s: int, d: int, causal: bool, rate: float,
                     left: bool, dtype=torch.bfloat16) -> Dict:
    """The fused kernel against the tensor-core split pair of ``dtype`` at
    one backward call of the model path: the device time of each route's
    kernels (the median launch of each, ``device_ms``, summed over dq and
    dkv), which the decision reads, and the wall time of a wrapper call,
    with the CUDA-core pair's beside them (which the pairs at D 128 are
    held to beat, ``gate_from``'s ``d128_pair_wins``). Medians, not a trace's sum:
    traces lose records (fp32 calls kept 2.9-3.2 of their 4 kernels a call
    in ``device_busy``), and a lost record reads as speed. The pair's
    gradients are first checked against the fused kernel's (within
    ``BWD_AGREE``, asserted)."""
    args = backward_inputs(bh, t, s, d, causal, rate, left, dtype=dtype)

    def bwd(fused: bool):
        def run():
            with fa.backward_forced(fused):
                return fa.flash_attention_backward(*args)
        return run

    kind, limit = BWD_AGREE[dtype]
    for a, b, grad in zip(bwd(False)(), bwd(True)(), ("dq", "dk", "dv")):
        err, top = (a.float() - b.float()).abs().max().item(), b.float().abs().max().item()
        if not err <= (limit * top if kind == "rtol" else limit):
            raise AssertionError(f"{name} {dtype}: the split pair's {grad} differs from the fused kernel's by "
                                 f"{err} (max|fused| {top})")
    row = {"kind": "bwd_route", "shape": name, "bh": bh, "T": t, "S": s, "D": d, "kernel_D": fa.kernel_head_dim(d),
           "causal": causal, "rate": rate, "dtype": str(dtype).replace("torch.", ""),
           "pair_route": fa.split_route(dtype, fa.kernel_head_dim(d))}
    cuda_core_pair = lambda: fa.backward_pair("cuda_core", *args)  # noqa: E731
    for route, run, kernels in (("fused", bwd(True), "fused"), ("pair", bwd(False), row["pair_route"]),
                                ("cuda_core_pair", cuda_core_pair, "cuda_core")):
        times = [device_ms(run, name) for name in BWD_KERNEL_NAMES[kernels]]
        if None in times:
            raise RuntimeError(f"{name} {dtype}: no trace kept a launch of the {route} kernels")
        row[f"{route}_device_ms"] = sum(times)
        row[f"{route}_wall_ms"] = time_ms(run)
    if row["kernel_D"] == 128:
        # the iwslt call: SDPA's forward + backward beside the kernels, at
        # rate 0 (no fused backend takes the kernels' Philox dropout), the
        # yardstick of the D 128 kernels
        q, k, v, bias, _, _, g, scale, causal = args[:9]
        row["library_fwd_bwd_ms"], row["library_backend"] = time_library(q, k, v, bias, scale, causal, grad=g)
    return row


def _route_module(kind: str):
    gen = torch.Generator().manual_seed(0)
    if kind == "mha":
        module = attention.MultiheadAttention(attention.MHAConfig(256, 4, dropout=0.1))
    else:
        module = ConvAttention2D(64, 4)
    module.init(gen)
    return module.to("cuda").train()


def measure_routes(kind: str, s: int) -> Dict:
    """Forward + backward of the port's ``MultiheadAttention`` ("mha", x
    (B, S, 256)) or ``ConvAttention2D`` ("time_attention", x (B, 64, S, 20))
    in training mode with bf16 activations, by the dense and the flash
    route; keys padded to lengths in [0.8 S, S] as the train batches."""
    b = ROUTE_ROWS // s
    module = _route_module(kind)
    gen = torch.Generator(device="cuda").manual_seed(2)
    shape = (b, s, 256) if kind == "mha" else (b, 64, s, 20)
    x = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16).requires_grad_()
    lengths = torch.randint(int(0.8 * s), s + 1, (b,), generator=gen, device="cuda")
    pad = torch.arange(s, device="cuda")[None, :] >= lengths[:, None]
    gens = make_generators(0, "cuda")

    def step():
        if kind == "mha":
            y = module(x, key_padding_mask=pad, generator=gens)[0]
        else:
            y = module(x, pad, 0.3, gens)
        y.float().sum().backward()

    row = {"kind": f"route_{kind}", "batch": b, "S": s, "heads": 4, "dtype": "bfloat16"}
    try:
        for route in ("dense", "flash"):
            attention.set_flash_attention(route == "flash")
            row[f"{route}_kernels_per_call"], row[f"{route}_device_ms"] = device_busy(step)
            row[f"{route}_wall_ms"] = time_ms(step, iters=10)
    finally:
        attention.set_flash_attention(None)
    row["dense_over_flash"] = row["dense_device_ms"] / row["flash_device_ms"]
    return row


def run() -> List[Dict]:
    """Every measurement of the sweep, as rows; raises without a card."""
    if not torch.cuda.is_available():
        raise RuntimeError("bench_flash_sweep measures the CUDA card and there is none")
    rows = []
    for bh, s, causal in KERNEL_SHAPES:
        rows += [measure_single(bh, s, causal, tb) for tb in single.T_BLOCKS[torch.bfloat16]]
        rows += measure_flash(bh, s, causal)
    for dtype in (torch.bfloat16, torch.float32):
        rows += [measure_forward(*shape, dtype=dtype) for shape in TRAIN_BACKWARD_SHAPES]
        rows += [measure_backward(*shape, dtype=dtype) for shape in TRAIN_BACKWARD_SHAPES]
    for kind in ("mha", "time_attention"):
        rows += [measure_routes(kind, s) for s in ROUTE_KEY_LENGTHS]
    return rows


def gate_from(rows: List[Dict]) -> Dict:
    """Per caller, the largest measured key length up to which the dense
    route's device time beats the flash route's by more than 10 % at every
    measured length (None when it does not at the shortest); the fused and
    pair device times of the bf16 ``bwd_route`` rows, whether the pair wins
    at each (``fa.pair_wins``) and at all of them; the same for the bf16
    forward's ``fwd_route`` rows, CUDA-core against tensor-core
    (``fa.tc_fwd_wins``); both again for the fp32 rows under ``tf32x3_``
    names; and the device times of both backwards at S = 2048, not causal.
    A row without a ``dtype`` is bf16.

    The flags decide the tensor-core routes, so they are taken over the
    calls that a tensor-core kernel serves (a row whose ``route`` /
    ``pair_route`` is not "cuda_core"; a row without one is such a call),
    and every such call stays in them. At kernel head dim 128 (the iwslt
    presets') both pairs run on the tensor cores (``d128_pair_wins``:
    whether the pair of the type is at least as fast as the CUDA-core pair,
    call by call), and so does the forward of each type (under
    ``tc_fwd_wins`` / ``tf32x3_fwd_wins``); ``{prefix}d128_calls`` gives
    each such call's default forward ("fwd"), fused, pair and CUDA-core pair device times
    and SDPA's. A call whose pair no tensor core takes (D 16) is routed to
    the CUDA-core pair by its bitwise repeat, not by time: its times are
    reported on their own, under ``{prefix}cuda_core_calls``."""
    gates = {}
    for kind in sorted({r["kind"] for r in rows if r["kind"].startswith("route_")}):
        ratios = sorted((r["S"], r["dense_over_flash"]) for r in rows if r["kind"] == kind)
        below = None
        for s, ratio in ratios:
            if ratio >= 1 / 1.1:
                break
            below = s
        gates[kind[len("route_"):]] = below
    out = {"dense_faster_by_10pct_up_to_key_len": gates}
    for dtype, tc in TC_ROUTES.items():
        fwd_flag, bwd_flag, prefix = FLAG_NAMES[tc]
        of_type = [r for r in rows if r.get("dtype", "bfloat16") == dtype]
        fwd_all = [r for r in of_type if r["kind"] == "fwd_route"]
        fwd_calls = [r for r in fwd_all if r.get("route", tc) != "cuda_core"]
        fwd_wins = fa.tc_fwd_wins({r["shape"]: (r["cuda_core_device_ms"], r[f"{tc}_device_ms"]) for r in fwd_calls})
        bwd_all = [r for r in of_type if r["kind"] == "bwd_route"]
        calls = [r for r in bwd_all if r.get("pair_route", tc) != "cuda_core"]
        fwd_cc = {r["shape"]: r["cuda_core_device_ms"] for r in fwd_all if r not in fwd_calls}
        fwd_default = {r["shape"]: r[f"{r.get('route', tc)}_device_ms"] for r in fwd_all}
        wins = fa.pair_wins({r["shape"]: (r["fused_device_ms"], r["pair_device_ms"]) for r in calls})
        d128_wins = {r["shape"]: r["pair_device_ms"] <= r["cuda_core_pair_device_ms"] for r in calls
                     if r.get("kernel_D") == 128}
        out.update({
            f"{fwd_flag}_by_call": fwd_wins, f"{fwd_flag}_everywhere": all(fwd_wins.values()),
            f"{prefix}fwd_device_ms_by_call": {r["shape"]: {"S": r["S"], "cuda_core": r["cuda_core_device_ms"],
                                                            tc: r[f"{tc}_device_ms"]} for r in fwd_calls},
            f"{bwd_flag}_by_call": wins, f"{bwd_flag}_everywhere": all(wins.values()),
            f"{prefix}d128_pair_wins_by_call": d128_wins, f"{prefix}d128_pair_wins_everywhere": all(d128_wins.values()),
            f"{prefix}d128_calls": {
                r["shape"]: {"S": r["S"], "D": r["D"], "fwd": fwd_default.get(r["shape"]), "fused": r["fused_device_ms"],
                             "pair": r["pair_device_ms"], "cuda_core_pair": r["cuda_core_pair_device_ms"],
                             "library_fwd_bwd_ms": r.get("library_fwd_bwd_ms"),
                             "library_backend": r.get("library_backend")}
                for r in calls if r.get("kernel_D") == 128},
            f"{prefix}bwd_device_ms_by_call": {
                r["shape"]: {"S": r["S"], "fused": r["fused_device_ms"], "pair": r["pair_device_ms"],
                             **{k: r[k + "_device_ms"] for k in ("cuda_core_pair",) if k + "_device_ms" in r}}
                for r in calls},
            f"{prefix}cuda_core_calls": {
                r["shape"]: {"S": r["S"], "D": r["D"], "fwd": fwd_cc.get(r["shape"]), "fused": r["fused_device_ms"],
                             "pair": r["pair_device_ms"], "pair_over_fused": r["pair_device_ms"] / r["fused_device_ms"],
                             "library_fwd_bwd_ms": r.get("library_fwd_bwd_ms"),
                             "library_backend": r.get("library_backend")}
                for r in bwd_all if r not in calls},
        })
    out["bwd_device_ms_at_2048_non_causal"] = {
        r["kind"]: r["bwd_device_ms"] for r in rows if r["kind"].startswith("flash_bwd") and r["S"] == 2048
        and not r["causal"]}
    return out


def print_table(rows: List[Dict]) -> None:
    for r in rows:
        shape = (f"bh={r['bh']} S={r['S']} causal={int(r['causal'])}" if "bh" in r
                 else f"B={r['batch']} S={r['S']}")
        if r["kind"] == "single_pass_fwd":
            print(f"{shape:<26} single-pass fwd t_block={r['t_block']:>3}: {r['fwd_ms']:8.3f} ms "
                  f"(max|d| vs flash {r['max_abs_err_vs_flash']:.2e})")
        elif r["kind"] == "fwd_route":
            tc = r["route"]
            print(f"{r['shape']:<26} {r['dtype']:<8} forward device ms: cuda_core {r['cuda_core_device_ms']:8.3f}  "
                  f"{tc} {r[f'{tc}_device_ms']:8.3f}; wall ms: cuda_core {r['cuda_core_wall_ms']:8.3f}  "
                  f"{tc} {r[f'{tc}_wall_ms']:8.3f}")
        elif r["kind"] == "bwd_route":
            print(f"{r['shape']:<26} {r['dtype']:<8} backward device ms: fused {r['fused_device_ms']:8.3f}  "
                  f"pair ({r['pair_route']}) {r['pair_device_ms']:8.3f}  cuda_core pair "
                  f"{r['cuda_core_pair_device_ms']:8.3f}; wall ms: fused {r['fused_wall_ms']:8.3f}  "
                  f"pair {r['pair_wall_ms']:8.3f}"
                  + (f"; SDPA fwd+bwd {r['library_fwd_bwd_ms']} ms ({r['library_backend']})"
                     if "library_fwd_bwd_ms" in r else ""))
        elif r["kind"].startswith("route_"):
            print(f"{shape:<26} {r['kind']:<22} fwd+bwd device ms: dense {r['dense_device_ms']:8.3f}  "
                  f"flash {r['flash_device_ms']:8.3f}; wall ms: dense {r['dense_wall_ms']:8.3f}  "
                  f"flash {r['flash_wall_ms']:8.3f}; kernels: dense {r['dense_kernels_per_call']:.0f}  "
                  f"flash {r['flash_kernels_per_call']:.0f}")
        else:
            times = "  ".join(f"{k} {r[k]:8.3f}" if r[k] is not None else f"{k} refused"
                              for k in ("fwd_ms", "bwd_ms", "fwd_bwd_ms", "tc_fwd_device_ms", "cuda_core_fwd_device_ms")
                              if k in r)
            times += "".join(f" ({k} {r[k]})" for k in ("fwd_backend", "fwd_bwd_backend") if k in r)
            print(f"{shape:<26} {r['kind']:<22} {times}")


def main() -> None:
    card = card_line()
    print(card, flush=True)
    rows = run()
    print_table(rows)
    for r in rows:
        print(json.dumps({**r, "card": card}))
    print(json.dumps({"decision_inputs": gate_from(rows), "card": card}))


if __name__ == "__main__":
    main()
