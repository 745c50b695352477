#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card, and only the port.

    python3 chip_smoke.py

Phases (each prints JSON lines; any failure raises, exit code != 0):

  1. device: the card's name and power limit (nvidia-smi) — raises without
     CUDA;
  2. build: compiles every kernel from the sources in this checkout (one
     nvcc per source, all started together, sm_90a: flash_fwd, flash_bwd,
     flash_bwd_tc, dynamic_conv, flash_fwd_single) and reports the seconds
     and the ptxas registers and spills of each;
  3. kernels at the serving shapes: the flash forward against its plain
     PyTorch version in fp32 (TF32 off) and bf16, with kernel, plain and
     library (scaled_dot_product_attention, a yardstick the port never
     calls: the fastest of its fused backends, flash, memory-efficient
     and cuDNN, each timed alone and named, never its math fallback) times
     per call (CUDA events), the kernel's own device time (torch.profiler),
     and the card's bound for the same work;
  4. kernels at the training shapes (the train step's four attention
     calls at batch 128, the lightconv decoder's encoder attention at
     batch 64 with keys padded on the left, and the long-context step's
     two at S 2048), in fp32 and bf16, and one bf16 call at D 16: the
     forward's dropout keep mask against ``philox.keep_mask`` (exactly),
     the forward at the training dropout rate, and the fused backward and
     the split pair (on the tensor cores in bf16 at D 32 and 64, on the CUDA
     cores in fp32 and at D 16), against the plain versions on the same
     inputs and seed, with the same times and bounds (the library time of a
     backward is SDPA's forward + backward at rate 0); then, at the long
     D 64 call in bf16, the pair's dq, dk, dv again, bitwise equal to the
     first (asserted), and the fused kernel's dQ spread;
  5. dynamic-conv kernels: ``dynamic_conv_fwd`` and ``dynamic_conv_bwd``
     against ``dynamic_conv_reference`` / ``dynamic_conv_backward_reference``
     in fp32 (TF32 off) and bf16 at the serving shapes (B 32, T 60, C 1024,
     H 16, centred K 3, 7, 15, 31; B 8, T 250, K 31), the training shapes
     (B 64, T 56, every K of 3, 7, 15, 31 centred and causal) and a ragged
     one (T 37, C 48, H 3, even K 4),
     with the wrapper's, the kernel's device, the plain and the bound times
     (no single PyTorch call computes a per-position band product, so no
     library time);
  6. serve (main path 1): the conv_transformer base preset at full width
     (256/768/4, 6+6 layers, 80 mels, vocabulary 8000, random weights from
     a seed) serves three requests with beam 5 through
     ``SequenceGenerator``; checks the hypotheses and the forward launches
     per request, times the encoder, profiles one request, and holds the
     flash route against the dense route and the card against the plain
     CPU path;
  7. train (main path 2): the ``bench.py::_measure_train`` configuration
     (label-smoothed CE 0.1, Adam (0.9, 0.98), lr 2e-3 inverse_sqrt over
     4000 warmup updates, clip-norm 10, --bf16) at full width on a fixed
     batch of 128 utterances of 409-512 frames and 48 target tokens:
     3 warm-up steps, then 20 timed steps 3 times; step ms, frames/s and
     MFU; exactly 20 flash forward launches a step, 20 + 20 tensor-core
     dq + dkv and no fused or CUDA-core backward (``BF16_BACKWARD``); the
     loss finite and falling; one profiled step; then short runs with each backward forced
     (fused, the pair in bf16, the pair in fp32 on the CUDA cores), their
     launches exact;
  8. train-step cross-checks in fp32 (TF32 off): flash against dense
     route and fused against split backward (training mode, every dropout
     rate 0 but the frontend's forced 0.1, drawn alike on both sides), and
     card against the plain CPU path on 2 utterances (eval-mode criterion),
     and the card's dense route against the CPU as the floor of the two;
  9. serve (main path 3): ``dynamicconv_wmt_en_de_big`` at full width
     (1024/4096/16, conv_dim 1024, GLU, 7 + 6 layers, K = 3, 7, 15, 31...,
     source and target dictionaries of 32,768 symbols, random weights from
     a seed) serves three requests (32 sentences of 10-60 tokens, 8 of
     200-250, 1 of 30) collated by the port's ``LanguagePairDataset``
     (sources padded on the left), beam 5; checks the hypotheses and
     exactly 7 ``dynamic_conv_fwd`` and 0 flash launches a request, source
     tokens/s, the idle share of one profiled request, the kernel route
     against the plain route on every request (fp32 encoder output and
     teacher-forced logits, and identical top hypotheses) and the card
     against the CPU on 2 sentences;
 10. train (main path 4): ``TranslationTask.build_model`` ->
     ``Trainer.train_step`` with the arguments of phase 7 and ``--bf16`` on
     one batch of 64 pairs of 40-56 source and 40-56 target tokens: step
     ms, target tokens/s, MFU, peak memory, one profiled step; exactly 13
     ``dynamic_conv_fwd``, 13 ``dynamic_conv_bwd``, 6 flash forward and
     6 + 6 tensor-core dq + dkv a step; the loss finite and falling;
 11. lightconv train-step cross-checks in fp32: the kernel route against
     the plain route of the dynamic conv (training mode, dropout rates 0),
     and the card against the plain CPU path on 2 pairs (eval-mode
     criterion);
 12. the single-pass kernels: ``flash_fwd_single`` against
     ``flash_fwd_single_reference`` in fp32 (TF32 off, the CUDA-core
     kernel at t_block 8 and 16) and bf16 (the tensor-core kernel at
     t_block 64 and 128) at the sweep's shapes (bh 32, S 2048, not causal;
     bh 64, S 2048, causal) and a ragged case (bh 4, T 300, S 333, keys
     padded), and in bf16 a long ragged row (bh 2, T 700, S 8192, padded)
     past the fp32 kernel's shared memory, with the wrapper's, the device,
     the plain, the SDPA and the bound times; then the refusals: D 32 in
     both types, S 3308 at t_block 16 in fp32 and t_block 16 in bf16;
 13. the flash sweep (main path 5, the one path that runs the single-pass
     kernel): ``scripts/bench_flash_sweep.run`` in full, its rows and the
     inputs of the gate and backward decisions (the fused kernel's and the
     pair's device time at each of the model path's backward calls, and
     whether the pair wins there: it must win at every call, asserted);
 14. train (main path 6), the ``bench.py::_measure_ctc_flagship``
     configuration: ``conv_transformer_big`` with ``ctc_multi_loss`` over
     label-smoothed CE 0.1, CTC after encoder layer 4 with weight 0.5 and
     CTC compression, the arguments of phase 7, through
     ``SpeechTranslationCTCTask`` -> ``Trainer.train_step`` on 128
     utterances of 409-512 frames, 48 target and 64 transcript tokens
     (a 700-symbol source dictionary; the task adds ``<ctc_blank>`` after
     its symbols): step ms, frames/s, MFU, peak memory, exactly 20 flash
     forward launches and 20 + 20 tensor-core dq + dkv a step, the
     loss finite and
     falling, the logged ``ctc_loss`` finite, one profiled step, and the
     launches and device time of the UER's edit distance;
 15. CTC cross-checks in fp32 (TF32 off): flash against dense route at
     batch 32 (training mode, dropout rates 0) and the card against the
     plain CPU path on 2 utterances (eval-mode criterion), with the
     compressed lengths identical on both sides (asserted);
 16. train (main path 7), ``bench.py``'s ``flash_longcontext_train``: the
     base conv_transformer on 8 utterances of 6554-8192 frames (T' = 2048
     after the frontend), ``max_source_positions`` 8192, bf16: step ms,
     frames/s, MFU, peak memory, exactly 20 flash forward launches and
     20 + 20 tensor-core dq + dkv a step, the loss finite, one
     profiled step; then flash against dense route in fp32 at the same
     shapes (the dense route's (8, 4, 2048, 2048) scores fit the card);
 17. the ``kernels`` line, the card line, and the final ``ok`` line.

Tolerances (stated here, checked below):
  * kernels against their plain versions: atol 1e-4 in fp32 (the same
    sums in another order); in bf16 2e-2 for out (one bf16 rounding of
    |out| < 4); lse 1e-4 (fp32 in both types); the keep mask exactly; the
    flash dq, dk and dv in bf16 each within 1e-2 of its own max|plain|
    (one bf16 rounding of the output, 2^-8 of it at most, with ds and w_v
    rounded to bf16 alike on both sides; the fused kernel keeps them in
    fp32, which moves a sum of S terms by about 2^-9 of it): at S = 2048
    every gradient is a sum of ~2048 terms of weight ~1/2048 and typically
    0.02-0.04, so the 5e-2 atol it replaces passed a kernel that returned
    zeros, and a zero gradient now misses by its whole max; the single-pass
    kernel's bf16 out
    besides element by element within 1e-3 + 8e-3 |plain| (one bf16 ulp of
    the plain value, 2^-7 of it at most, and P rounded alike on both
    sides): at S = 2048 a typical |out| is about 0.03, so 2e-2 alone would
    pass a dropped key chunk;
  * dynamic conv against its plain version: out and dx at atol 1e-4 in
    fp32, in bf16 out at 2e-2 and dx at 5e-2 (out and dx are sums of K
    products, convex in x for out, with |out|, |dx| < 5: one bf16
    rounding); dw, a sum of C/H = 64 products that reaches |dw| ~
    40, at 1e-5 (fp32) and 1e-2 (bf16, one rounding at 2^-8) of max|dw|;
  * the serving models, flash vs dense, kernel vs plain route and card vs
    CPU: atol 1e-3 in fp32 (8 attention or 13 conv layers summed in
    another order);
  * train-step cross-checks: the loss rtol 1e-5 (the same forward in fp32);
    gnorm and the gradients' global relative difference 5e-3 where the two
    sides compute the forward differently (flash vs dense, conv kernel vs
    plain route, card vs CPU) and
    1e-5 where they share it (fused vs split). A forward that differs in its
    last bits flips the ReLU derivative of the pre-activations that lie
    within rounding of 0, and each flip moves whole rows of a weight
    gradient: two correct fp32 paths, the dense route on the card and on the
    CPU, differ by 1.8e-4 at 32 utterances and 7.3e-4 at 4 (H100, fp32, TF32
    off, a chip run of this script's checks at both batch sizes), while
    the same path run twice on the card differs by 2e-7; the
    ``dense_card_vs_cpu`` line measures that floor in every run. The
    largest parameter difference is reported and held to 2 lr + 1e-6,
    since one Adam step moves a weight by up to lr whatever its gradient's
    size, and a gradient that is 0 up to rounding may take either sign.

MFU counts 3x the forward's matmul, conv and attention FLOPs (2 per
multiply-add) at the shapes the step computes (``train_flops``,
``lightconv_train_flops``), against the H100's 989 TFLOP/s of dense bf16.
"""

from __future__ import annotations

import json
import math
import os
import sys
import time
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
# the timers, the card line and the SDPA yardstick: the sweep module's
from fbk_fairseq_st_tpu_torch.scripts.bench_flash_sweep import (  # noqa: E402
    TRAIN_BACKWARD_SHAPES, card_line, device_busy, time_library, time_ms)

# H100 SXM data sheet (dense): memory 3.35 TB/s; fp32 outside the tensor
# cores 67 TFLOP/s; bf16 tensor cores 989 TFLOP/s.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
PEAK_BF16 = 989e12

ATOL_KERNEL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
ATOL_GRAD = {torch.float32: 1e-4, torch.bfloat16: 5e-2}
RTOL_GRAD_BF16 = 1e-2  # flash dq / dk / dv in bf16: of max|plain|, tensor by tensor
ATOL_LSE = 1e-4
SINGLE_BF16_LIMIT = (1e-3, 8e-3)  # (atol, rtol of |plain|), element by element
RTOL_DW = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
ATOL_MODEL = 1e-3
RTOL_STEP_LOSS = 1e-5
RTOL_STEP_GRAD = {"other_forward": 5e-3, "same_forward": 1e-5}

N_MELS = 80
VOCAB = 8000
BEAM = 5
MAX_LEN_B = 100
FRAME_SECONDS = 0.01  # 10 ms fbank hop
FLASH_LAUNCHES_PER_REQUEST = 8  # 2 ConvAttention2D blocks + 6 encoder layers

# the train step (bench.py:43-82)
TRAIN_BATCH = 128
TRAIN_FRAMES = 512
TGT_LEN = 48
WARMUP_STEPS = 3
TIMED_STEPS = 20
REPEATS = 3
SPLIT_STEPS = 5  # the short runs with each backward forced

# (name, bh, T, S, D, causal, padded keys): the flash calls of the serving path
KERNEL_SHAPES = [
    ("encoder_self_attention", 128, 128, 128, 64, False, True),
    ("time_attention", 128, 128, 128, 20, False, True),
    ("decoder_causal_self_attention", 32, 100, 100, 64, True, True),
    ("cross_attention", 32, 37, 128, 64, False, True),
    ("long_encoder_self_attention", 32, 750, 750, 64, False, True),
]

# (name, bh, T, S, D, causal, dropout rate, keys padded on the left,
# types): the flash calls of the train steps (the sweep's
# TRAIN_BACKWARD_SHAPES: the conv_transformer step at batch 128, the
# lightconv decoder's encoder attention at batch 64, the long-context step
# at T' = 2048; all with padded keys) in fp32 and bf16, and one bf16 call at
# D 16, where the split pair runs on the CUDA cores (no model reaches it)
TRAIN_KERNEL_SHAPES = [(*shape, (torch.float32, torch.bfloat16)) for shape in TRAIN_BACKWARD_SHAPES] + [
    ("d16_bf16", 64, 100, 100, 16, False, 0.1, False, (torch.bfloat16,)),
]
DETERMINISM_AT = "long_encoder_self_attention"  # bf16: the pair's bits compared across launches

# flash calls a conv_transformer train step makes: 2 time attention (F' =
# 20 padded to 32), 6 encoder self-attention, 6 decoder causal
# self-attention, 6 cross-attention; each one forward and one backward
CT_FLASH_CALLS_PER_STEP = 20
# the route every bf16 backward call of the train steps takes (kernel D 32
# and 64): the tensor-core dq + dkv pair, since the sweep measured it
# faster than the fused kernel at each of them (phase 13 asserts that it
# still is); the step phases hold their launch counts to it
BF16_BACKWARD = "split_tc"
BACKWARD_KERNELS = {"fused": ("flash_bwd_fused",), "split_tc": ("flash_bwd_dq_tc", "flash_bwd_dkv_tc"),
                    "split_cuda_core": ("flash_bwd_dq", "flash_bwd_dkv")}

# the lightconv paths (dynamicconv_wmt_en_de_big, models/lightconv.py)
LC_ARCH = "dynamicconv_wmt_en_de_big"
LC_VOCAB = 32768  # each of the source and target dictionaries, a 32 k BPE
LC_TRAIN_BATCH = 64
LC_TRAIN_LEN = (40, 56)  # source and target tokens a pair
LC_TIMED_STEPS = 10
DCONV_LAUNCHES_PER_REQUEST = 7  # the encoder's layers
DCONV_LAUNCHES_PER_STEP = 13  # 7 encoder + 6 teacher-forced decoder layers
LC_FLASH_LAUNCHES_PER_STEP = 6  # the decoder's encoder attention

# (name, B, T, C, H, K, padding_l): the dynamic conv's calls on the main
# paths, every (K, padding_l) pair of the encoder (centred) and of the
# teacher-forced decoder (causal), and the long serving request
DCONV_SHAPES = [
    ("serve_k3", 32, 60, 1024, 16, 3, 1),
    ("serve_k7", 32, 60, 1024, 16, 7, 3),
    ("serve_k15", 32, 60, 1024, 16, 15, 7),
    ("serve_k31", 32, 60, 1024, 16, 31, 15),
    ("serve_long_k31", 8, 250, 1024, 16, 31, 15),
    ("train_k31_centred", 64, 56, 1024, 16, 31, 15),
    ("train_k3", 64, 56, 1024, 16, 3, 1),
    ("train_k7", 64, 56, 1024, 16, 7, 3),
    ("train_k15", 64, 56, 1024, 16, 15, 7),
    ("train_k3_causal", 64, 56, 1024, 16, 3, 2),
    ("train_k7_causal", 64, 56, 1024, 16, 7, 6),
    ("train_k15_causal", 64, 56, 1024, 16, 15, 14),
    ("train_k31_causal", 64, 56, 1024, 16, 31, 30),
    ("ragged", 4, 37, 48, 3, 4, 1),
]

# the single-pass kernels' checks: (name, bh, T, S, causal, padded keys,
# types), each at every t_block the type's kernel takes
# (flash_fwd_single.T_BLOCKS); S 8192 is past the fp32 kernel's shared memory
SINGLE_SHAPES = [
    ("bh32_S2048", 32, 2048, 2048, False, False, (torch.float32, torch.bfloat16)),
    ("bh64_S2048_causal", 64, 2048, 2048, True, False, (torch.float32, torch.bfloat16)),
    ("ragged_bh4_T300_S333", 4, 300, 333, False, True, (torch.float32, torch.bfloat16)),
    ("ragged_bh2_T700_S8192", 2, 700, 8192, False, True, (torch.bfloat16,)),
]
SINGLE_TIMED_AT = ("bh32_S2048", "bfloat16", 64)  # the kernels line's row

# the CTC flagship (bench.py:344-423)
CTC_ARCH = "conv_transformer_big"
CTC_SRC_SYMBOLS = 700
CTC_TR_LEN = 64
CTC_TIMED_STEPS = 10

# the long-context train step (bench.py:505-507)
LONG_BATCH = 8
LONG_FRAMES = 8192
LONG_TIMED_STEPS = 5

KERNEL_SOURCES = ("flash_fwd", "flash_bwd", "flash_bwd_tc", "dynamic_conv", "flash_fwd_single")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def _device_events(prof):
    """The trace's device-side events (kernels, copies), not the host-side
    runtime calls that also report their kernels' durations."""
    from torch.autograd import DeviceType

    return [e for e in prof.events() if e.device_type == DeviceType.CUDA]


CARD = [None]  # the card's nvidia-smi line, set by main


def device_ms(fn, match, iters: int = 20, tries: int = 3):
    """Device time of the one kernel launch of a call of ``fn`` whose name
    ``match`` accepts (a substring or a predicate): the median duration of
    the matching events of a torch.profiler (CUPTI) trace over ``iters``
    calls. A trace may miss some of its kernel records (a chip run saw one
    of a wrapper's 20 launches at a fifth of its CUDA-event time, and
    another trace with none), so the median and not the sum is taken, and
    a trace that caught none is taken again; None if every try was empty."""
    from torch.profiler import ProfilerActivity, profile

    accept = match if callable(match) else (lambda name: match in name)
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        times = [e.device_time_total for e in _device_events(prof) if accept(e.name)]
        if times:
            return float(np.median(times)) / 1e3
    return None


# kernel classes of a profile: (class, a name substring that marks it)
KERNEL_CLASSES = (("dynamic_conv", "dynamic_conv_"), ("flash", "flash_"), ("gemm", "gemm"),
                  ("gemm", "nvjet"), ("gemm", "gemv"))


def profile_window(fn):
    """Device busy time, the kernels that take it and its split by kernel
    class while ``fn`` runs (torch.profiler, device activity only), beside
    the host wall time. A trace that caught no device event (a chip run
    saw one, for a long-context step) is taken again."""
    from torch.profiler import ProfilerActivity, profile

    by_name = {}
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
        for e in _device_events(prof):
            by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total / 1e6
        if by_name:
            break
    busy_s = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    classes = {}
    for name, sec in by_name.items():
        cls = next((c for c, mark in KERNEL_CLASSES if mark in name), "other")
        classes[cls] = classes.get(cls, 0.0) + sec
    return wall_s, busy_s, [(name[:80], s) for name, s in top], classes


def causal_pairs(t: int, s: int, causal: bool) -> int:
    return sum(min(r + 1, s) for r in range(t)) if causal else t * s


def bound_ms(nbytes: float, flops: float, dtype):
    """Least time for the function on this card: the bytes it must move at
    the memory rate against its operations at the peak rate of the type."""
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = flops / PEAK_FLOPS[dtype] * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations")


def attention_bound_ms(bh, t, s, d, causal, dtype):
    """The forward: q, k, v, bias in, out and lse out; 2 products."""
    item = torch.tensor([], dtype=dtype).element_size()
    nbytes = item * bh * d * (2 * t + 2 * s) + 4 * bh * s + 4 * bh * t
    return bound_ms(nbytes, 4.0 * bh * causal_pairs(t, s, causal) * d, dtype)


def backward_bound_ms(kind, bh, t, s, d, causal, dtype):
    """A backward: q, k, v, dO, bias, lse, delta in; its gradients out.
    Products of 2*T*S*D per bh: fused 5 (s, dO V^T, dV, dK, dQ), dq 3
    (s, dO V^T, dQ), dkv 4 (s, dO V^T, dV, dK)."""
    item = torch.tensor([], dtype=dtype).element_size()
    inputs = item * bh * d * (2 * t + 2 * s) + 4 * bh * s + 8 * bh * t
    outputs = {"fused": item * bh * d * (t + 2 * s), "dq": item * bh * d * t, "dkv": item * bh * d * 2 * s}[kind]
    products = {"fused": 5, "dq": 3, "dkv": 4}[kind]
    return bound_ms(inputs + outputs, 2.0 * products * bh * causal_pairs(t, s, causal) * d, dtype)


def random_attention_inputs(gen, bh, t, s, d, dtype, padded=True, left=False):
    q = torch.randn((bh, t, d), generator=gen, device="cuda").to(dtype)
    k = torch.randn((bh, s, d), generator=gen, device="cuda").to(dtype)
    v = torch.randn((bh, s, d), generator=gen, device="cuda").to(dtype)
    bias = torch.zeros((bh, s), device="cuda")
    if padded:  # ragged key lengths, as the batches give them
        lengths = torch.randint(s // 2, s + 1, (bh,), generator=gen, device="cuda")
        lengths[0] = s
        pos = torch.arange(s, device="cuda")[None, :]
        pads = pos < (s - lengths)[:, None] if left else pos >= lengths[:, None]
        bias = torch.where(pads, -1e9, 0.0)
    return q, k, v, bias


def build_kernels(kernel_build):
    """One nvcc per source, all started together."""
    def one(name):
        t0 = time.perf_counter()
        path = kernel_build.build(name)
        return name, path, time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        built = list(pool.map(one, KERNEL_SOURCES))
    total_s = time.perf_counter() - t0
    for name, path, seconds in built:
        ptxas = [line.strip() for line in path.with_suffix(".log").read_text().splitlines()
                 if "registers" in line or "spill" in line or "Compiling entry" in line]
        emit({"phase": "build", "kernel": name, "seconds": seconds, "ptxas": ptxas})
    emit({"phase": "build", "all_seconds": total_s})


# ---------------------------------------------------------------------------
# 3. kernels at the serving shapes
# ---------------------------------------------------------------------------

def check_serving_kernels(fa):
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows, worst = [], {torch.float32: 0.0, torch.bfloat16: 0.0}
    for name, bh, t, s, d, causal, padded in KERNEL_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, bias = random_attention_inputs(gen, bh, t, s, d, dtype, padded)
            scale = d ** -0.5
            out_k, lse_k = fa.flash_attention(q, k, v, bias, scale, causal=causal, return_lse=True)
            out_p, lse_p = fa.flash_attention_reference(q, k, v, bias, scale, causal)
            torch.cuda.synchronize()
            err = (out_k.float() - out_p.float()).abs().max().item()
            lse_err = (lse_k - lse_p).abs().max().item()
            if not (err <= ATOL_KERNEL[dtype] and lse_err <= ATOL_LSE):
                raise AssertionError(f"flash_fwd disagrees with its plain version at {name} {dtype}: "
                                     f"max|out| err {err}, max|lse| err {lse_err}")
            worst[dtype] = max(worst[dtype], err)
            fwd = lambda: fa.flash_attention(q, k, v, bias, scale, causal=causal)  # noqa: E731
            library_ms, library_backend = time_library(q, k, v, bias, scale, causal)
            row = {
                "phase": "kernel_check", "kernel": "flash_attention_fwd", "shape": name,
                "bh": bh, "T": t, "S": s, "D": d, "causal": causal, "rate": 0.0,
                "dtype": str(dtype).replace("torch.", ""),
                "max_abs_err": err, "lse_max_abs_err": lse_err, "atol": ATOL_KERNEL[dtype],
                "kernel_ms": time_ms(fwd), "kernel_device_ms": device_ms(fwd, "flash_fwd_kernel"),
                "plain_ms": time_ms(lambda: fa.flash_attention_reference(q, k, v, bias, scale, causal)),
                "library_ms": library_ms, "library_backend": library_backend,
            }
            row["bound_ms"], row["bound_by"] = attention_bound_ms(bh, t, s, d, causal, dtype)
            emit(row)
            rows.append(row)
    return rows, worst


# ---------------------------------------------------------------------------
# 4. kernels at the training shapes
# ---------------------------------------------------------------------------

def kernel_keep_mask(fa, bh, t, s, causal, rate, seed, device="cuda"):
    """The keep mask as the forward kernel applies it. With q = k = 0 and
    bias 0 every unmasked weight is 1 and l_i counts row i's keys, so with
    V the identity on a window of D keys (0 elsewhere) out[i, c] =
    keep(i, j0 + c) / (l_i (1 - rate)); the windows tile the S keys, one
    launch each. Returns (mask, the entries it is defined on)."""
    d = fa.kernel_head_dim(min(s, fa.KERNEL_HEAD_DIMS[-1]))
    q = torch.zeros((bh, t, d), device=device)
    k = torch.zeros((bh, s, d), device=device)
    windows = []
    for j0 in range(0, s, d):
        n = min(d, s - j0)
        v = torch.zeros((s, d), device=device)
        v[j0:j0 + n, :n] = torch.eye(n, device=device)
        windows.append(fa.flash_attention(q, k, v.expand(bh, s, d), torch.zeros((bh, s), device=device), 1.0,
                                          causal=causal, dropout_rate=rate, dropout_seed=seed)[..., :n])
    out = torch.cat(windows, dim=-1)
    rows = torch.arange(t, device=device)[:, None]
    cols = torch.arange(s, device=device)[None, :]
    keys = torch.clamp(rows + 1, max=s) if causal else torch.full_like(rows, s)
    scaled = out * keys[None].float() * (1.0 - rate)
    if not torch.all((scaled - scaled.round()).abs() < 1e-3):
        raise AssertionError("the probe's output is not a 0/1 mask times 1 / (l (1 - rate))")
    valid = (cols <= rows) if causal else torch.ones((t, s), dtype=torch.bool, device=device)
    return scaled.round() == 1, valid.expand(bh, t, s)


def _pad_d(x, d_kernel):
    return torch.nn.functional.pad(x, (0, d_kernel - x.shape[-1])).contiguous()


def grad_errors(got, want, dtype):
    """Against the plain gradients: fp32 the largest absolute difference of
    dq, dk, dv; bf16 the largest of each tensor's max|kernel - plain| over
    its max|plain|. Returns (max abs err, that ratio, the max|plain| of dq,
    dk, dv, within the limit)."""
    errs = [(a.float() - b.float()).abs().max().item() for a, b in zip(got, want)]
    tops = [b.float().abs().max().item() for b in want]
    ratio = max(e / max(t, 1e-30) for e, t in zip(errs, tops))
    ok = ratio <= RTOL_GRAD_BF16 if dtype == torch.bfloat16 else max(errs) <= ATOL_GRAD[dtype]
    return max(errs), ratio, tops, ok


def check_training_kernels(fa, philox):
    """Each training-shape call in its types: mask, forward, the fused
    backward and the split pair (on the tensor cores in bf16 at D 32 and 64,
    on the CUDA cores otherwise) against the plain versions; the pair's
    determinism; times and bounds."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    worst = {(kind, dtype): 0.0 for kind in ("fwd", "bwd_fused", "bwd_cuda_core", "bwd_tc")
             for dtype in (torch.float32, torch.bfloat16)}
    worst_ratio = {}
    for name, bh, t, s, d, causal, rate, left, dtypes in TRAIN_KERNEL_SHAPES:
        seed = int(torch.randint(0, 2 ** 63 - 1, (), generator=torch.Generator().manual_seed(len(rows))))
        got, valid = kernel_keep_mask(fa, bh, t, s, causal, rate, seed)
        want = philox.keep_mask(seed, bh, t, s, rate, device="cuda")
        mismatches = int((got != want)[valid].sum())
        keep_frac = float(want[valid].float().mean())
        emit({"phase": "keep_mask_check", "shape": name, "bh": bh, "T": t, "S": s, "rate": rate,
              "elements": int(valid.sum()), "mismatches": mismatches, "keep_fraction": keep_frac})
        if mismatches:
            raise AssertionError(f"{name}: the forward kernel's keep mask differs from philox.keep_mask "
                                 f"at {mismatches} elements")

        for dtype in dtypes:
            q, k, v, bias = random_attention_inputs(gen, bh, t, s, d, dtype, left=left)
            g = torch.randn((bh, t, d), generator=gen, device="cuda").to(dtype)
            scale = d ** -0.5
            drop = dict(dropout_rate=rate, dropout_seed=seed)
            out_k, lse_k = fa.flash_attention(q, k, v, bias, scale, causal=causal, return_lse=True, **drop)
            out_p, lse_p = fa.flash_attention_reference(q, k, v, bias, scale, causal, rate, seed)
            # both backwards against the plain one, on the kernel's out and lse
            dk = fa.kernel_head_dim(d)
            route = fa.split_route(dtype, dk)
            split = "bwd_tc" if route == "tc" else "bwd_cuda_core"
            qp, kp, vp, op, gp = (_pad_d(x, dk) for x in (q, k, v, out_k, g))
            bwd_args = (qp, kp, vp, bias, op, lse_k, gp, scale, causal, rate, seed)
            want_grads = fa.flash_attention_backward_reference(q, k, v, bias, out_k, lse_k, g, scale,
                                                               causal, rate, seed)

            def bwd(fused):
                def run():
                    with fa.backward_forced(fused):
                        return fa.flash_attention_backward(*bwd_args)
                return run

            grads = {kind: [x[..., :d] for x in bwd(fused)()] for kind, fused in (("bwd_fused", True), (split, False))}
            torch.cuda.synchronize()
            errs = {"fwd": (out_k.float() - out_p.float()).abs().max().item()}
            lse_err = (lse_k - lse_p).abs().max().item()
            checks = {kind: grad_errors(gr, want_grads, dtype) for kind, gr in grads.items()}
            for kind, (err, ratio, _, _) in checks.items():
                errs[kind] = err
                if dtype == torch.bfloat16:
                    worst_ratio[kind] = max(worst_ratio.get(kind, 0.0), ratio)
            ok = (errs["fwd"] <= ATOL_KERNEL[dtype] and lse_err <= ATOL_LSE
                  and all(c[3] for c in checks.values()))
            for kind, err in errs.items():
                worst[(kind, dtype)] = max(worst[(kind, dtype)], err)

            library_ms, library_backend = time_library(q, k, v, bias, scale, causal)
            fwd = lambda: fa.flash_attention(q, k, v, bias, scale, causal=causal, **drop)  # noqa: E731
            base = {"phase": "train_kernel_check", "shape": name, "bh": bh, "T": t, "S": s, "D": d,
                    "causal": causal, "rate": rate, "keys_padded_on_the_left": left,
                    "dtype": str(dtype).replace("torch.", ""), "card": CARD[0]}

            def grad_fields(kind):
                err, ratio, tops, _ = checks[kind]
                limit = ({"max_err_over_max_plain": ratio, "rtol_of_max_plain": RTOL_GRAD_BF16}
                         if dtype == torch.bfloat16 else {"atol": ATOL_GRAD[dtype]})
                return dict(max_abs_err=err, max_abs_plain_dq_dk_dv=tops, **limit)

            tc = route == "tc"
            dq_name, dkv_name = ("flash_bwd_dq_tc_kernel", "flash_bwd_dkv_tc_kernel") if tc else (
                "flash_bwd_q_kernel", lambda n: "flash_bwd_kv_kernel" in n and "false>" in n)
            suffix = "_tc" if tc else ""
            timings = {
                "flash_attention_fwd": dict(
                    kernel_ms=time_ms(fwd), kernel_device_ms=device_ms(fwd, "flash_fwd_kernel"),
                    plain_ms=time_ms(lambda: fa.flash_attention_reference(q, k, v, bias, scale, causal, rate, seed)),
                    library_ms=library_ms, library_backend=library_backend,
                    max_abs_err=errs["fwd"], lse_max_abs_err=lse_err, atol=ATOL_KERNEL[dtype],
                    bound=attention_bound_ms(bh, t, s, d, causal, dtype)),
                "flash_attention_bwd_fused": dict(
                    kernel_ms=time_ms(bwd(True)),
                    kernel_device_ms=device_ms(bwd(True), lambda n: "flash_bwd_kv_kernel" in n and "true>" in n),
                    wrapper_device_ms=device_busy(bwd(True))[1],
                    bound=backward_bound_ms("fused", bh, t, s, d, causal, dtype), **grad_fields("bwd_fused")),
                "flash_attention_bwd_dq" + suffix: dict(
                    kernel_device_ms=device_ms(bwd(False), dq_name),
                    bound=backward_bound_ms("dq", bh, t, s, d, causal, dtype), **grad_fields(split)),
                "flash_attention_bwd_dkv" + suffix: dict(
                    kernel_device_ms=device_ms(bwd(False), dkv_name),
                    bound=backward_bound_ms("dkv", bh, t, s, d, causal, dtype), **grad_fields(split)),
            }
            split_ms = time_ms(bwd(False))
            split_device_ms = device_busy(bwd(False))[1]
            plain_bwd_ms = time_ms(lambda: fa.flash_attention_backward_reference(
                q, k, v, bias, out_k, lse_k, g, scale, causal, rate, seed))
            library_bwd_ms, library_bwd_backend = time_library(q, k, v, bias, scale, causal, grad=g)
            for kernel in list(timings)[1:]:
                timings[kernel].update(plain_ms=plain_bwd_ms, library_ms=library_bwd_ms,
                                       library_backend=library_bwd_backend,
                                       library="sdpa forward+backward, rate 0")
            # the split pair's wrapper call launches both kernels
            for kernel in list(timings)[2:]:
                timings[kernel].update(kernel_ms=split_ms, wrapper_device_ms=split_device_ms, split_route=route)
            for kernel, tm in timings.items():
                tm["bound_ms"], tm["bound_by"] = tm.pop("bound")
                row = {**base, "kernel": kernel, **tm}
                emit(row)
                rows.append(row)
            if not ok:
                raise AssertionError(f"training-shape check failed at {name} {dtype}: {errs}, lse {lse_err}, "
                                     f"{ {kind: c[:3] for kind, c in checks.items()} }")
            if name == DETERMINISM_AT and dtype == torch.bfloat16:
                check_determinism(bwd, grads[split], grads["bwd_fused"], d)
            del q, k, v, bias, g, out_k, out_p, want_grads, grads
            torch.cuda.empty_cache()
    return rows, worst, worst_ratio


def check_determinism(bwd, pair, fused, d):
    """The split pair again on the same inputs: bitwise equal (asserted);
    the fused kernel's dQ again: its spread reported (fp32 atomics)."""
    pair2 = [x[..., :d] for x in bwd(False)()]
    fused2 = [x[..., :d] for x in bwd(True)()]
    torch.cuda.synchronize()
    same = [torch.equal(a, b) for a, b in zip(pair, pair2)]
    spread = [(a.float() - b.float()).abs().max().item() for a, b in zip(fused, fused2)]
    emit({"phase": "backward_determinism", "shape": DETERMINISM_AT, "dtype": "bfloat16",
          "pair_bitwise_equal_dq_dk_dv": same, "fused_max_abs_spread_dq_dk_dv": spread,
          "fused_dq_elements_that_differ": int((fused[0] != fused2[0]).sum()), "card": CARD[0]})
    if not all(same):
        raise AssertionError(f"the split pair is not deterministic at {DETERMINISM_AT}: {same}")


# ---------------------------------------------------------------------------
# 6. serve
# ---------------------------------------------------------------------------

def make_request(rng, n, lo, hi, max_frames):
    lengths = rng.randint(lo, hi + 1, size=n).astype(np.int64)
    lengths[0] = max_frames
    feats = rng.randn(n, max_frames, N_MELS).astype(np.float32)
    return {"net_input": {"src_tokens": feats, "src_lengths": lengths}}


def check_hypotheses(hypos, eos, n):
    if len(hypos) != n:
        raise AssertionError(f"{len(hypos)} hypothesis lists for {n} utterances")
    for sent in hypos:
        if not sent:
            raise AssertionError("an utterance finished without hypotheses")
        scores = [h["score"] for h in sent]
        if not all(np.isfinite(scores)) or scores != sorted(scores, reverse=True):
            raise AssertionError(f"scores not finite and sorted: {scores}")
        for h in sent:
            if len(h["tokens"]) == 0 or int(h["tokens"][-1]) != eos:
                raise AssertionError(f"hypothesis does not end in eos: {h['tokens']}")
            if not np.isfinite(h["positional_scores"]).all():
                raise AssertionError("non-finite positional scores")


def teacher_forced_tokens(hypos, pad, eos):
    tops = [sent[0]["tokens"] for sent in hypos]
    width = max(len(t) for t in tops)
    prev = np.full((len(tops), width), pad, np.int64)
    for i, t in enumerate(tops):
        prev[i, 0] = eos
        prev[i, 1:len(t)] = t[:-1]
    return prev


def serve(card, d, fa, dconv, single, attention, build_model, SequenceGenerator):
    model = build_model(
        "conv_transformer", d, seed=0, input_feat_per_channel=N_MELS,
        max_source_positions=2048, max_target_positions=512,
    )
    gen = SequenceGenerator(d, beam_size=BEAM, max_len_b=MAX_LEN_B)
    rng = np.random.RandomState(0)
    requests = [
        ("bench_decode_32x409-512", make_request(rng, 32, 409, 512, 512)),
        ("long_8x2400-3000", make_request(rng, 8, 2400, 3000, 3000)),
        ("single_1x512", make_request(rng, 1, 512, 512, 512)),
    ]
    attention.set_flash_attention(None)  # auto: every eligible call on the card
    gen.generate([model], requests[2][1])  # warm-up (cuDNN plans, allocator)

    reset_counts(fa, dconv, single)
    served = []
    for name, sample in requests:
        before = fa.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hypos = gen.generate([model], sample)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        n = len(sample["net_input"]["src_lengths"])
        check_hypotheses(hypos, d.eos(), n)
        grew = fa.launches - before
        if grew != FLASH_LAUNCHES_PER_REQUEST:
            raise AssertionError(f"{name}: flash launches grew by {grew}, expected {FLASH_LAUNCHES_PER_REQUEST}")
        audio_s = float(sample["net_input"]["src_lengths"].sum()) * FRAME_SECONDS
        served.append((name, sample, hypos))
        emit({"phase": "serve", "request": name, "utterances": n, "decode_s": decode_s,
              "audio_s": audio_s, "rtf": decode_s / audio_s, "flash_launches": grew,
              "mean_hyp_len": float(np.mean([len(s[0]["tokens"]) for s in hypos])),
              "card": card})
    launches = launch_counts(fa, dconv, single)

    # where the time goes in the first request: the encoder alone, then the
    # device's busy time over a profiled run of the whole request
    name, sample, hypos = served[0]
    src = torch.as_tensor(sample["net_input"]["src_tokens"], device="cuda")
    lengths = torch.as_tensor(sample["net_input"]["src_lengths"], device="cuda")
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.encode(src, lengths)
        torch.cuda.synchronize()
        encode_s = time.perf_counter() - t0
    wall_s, busy_s, top, classes = profile_window(lambda: gen.generate([model], sample))
    emit({"phase": "profile", "request": name, "encode_s": encode_s,
          "decode_s_profiled": wall_s, "device_busy_s": busy_s,
          "device_idle_share_profiled": 1.0 - busy_s / wall_s,
          "top_kernels_s": top, "busy_by_class_s": classes, "card": card})

    # flash route against the dense route on the first request
    batch = {"src_tokens": src, "src_lengths": lengths,
             "prev_output_tokens": torch.as_tensor(teacher_forced_tokens(hypos, d.pad(), d.eos()), device="cuda")}
    with torch.no_grad():
        before = fa.launches
        logits_flash, extra_flash = model(batch)
        tf_launches = fa.launches - before
        attention.set_flash_attention(False)
        logits_dense, extra_dense = model(batch)
        hypos_dense = gen.generate([model], sample)
        attention.set_flash_attention(None)
    enc_err = (extra_flash["encoder_out"].encoder_out - extra_dense["encoder_out"].encoder_out).abs().max().item()
    logit_err = (logits_flash - logits_dense).abs().max().item()
    same = sum(list(a[0]["tokens"]) == list(b[0]["tokens"]) for a, b in zip(hypos, hypos_dense))
    emit({"phase": "flash_vs_dense", "request": name, "encoder_max_abs_err": enc_err,
          "logits_max_abs_err": logit_err, "atol": ATOL_MODEL,
          "teacher_forced_flash_launches": tf_launches,
          "identical_top_hypotheses": f"{same}/{len(hypos)}"})
    if not (enc_err <= ATOL_MODEL and logit_err <= ATOL_MODEL):
        raise AssertionError("flash and dense routes disagree on the full-width model")

    # the card against the plain CPU path on the small request
    name, sample, hypos = served[2]
    cpu_model = build_model(
        "conv_transformer", d, device="cpu", seed=0, input_feat_per_channel=N_MELS,
        max_source_positions=2048, max_target_positions=512,
    )
    prev = teacher_forced_tokens(hypos, d.pad(), d.eos())
    batch_cpu = {"src_tokens": torch.as_tensor(sample["net_input"]["src_tokens"]),
                 "src_lengths": torch.as_tensor(sample["net_input"]["src_lengths"]),
                 "prev_output_tokens": torch.as_tensor(prev)}
    with torch.no_grad():
        logits_cpu, extra_cpu = cpu_model(batch_cpu)
        logits_gpu, extra_gpu = model({k: v.cuda() for k, v in batch_cpu.items()})
    enc_err = (extra_gpu["encoder_out"].encoder_out.cpu() - extra_cpu["encoder_out"].encoder_out).abs().max().item()
    logit_err = (logits_gpu.cpu() - logits_cpu).abs().max().item()
    hypos_cpu = gen.generate([cpu_model], sample)
    same = list(hypos_cpu[0][0]["tokens"]) == list(hypos[0][0]["tokens"])
    emit({"phase": "card_vs_cpu", "request": name, "encoder_max_abs_err": enc_err,
          "logits_max_abs_err": logit_err, "atol": ATOL_MODEL, "identical_top_hypothesis": same})
    if not (enc_err <= ATOL_MODEL and logit_err <= ATOL_MODEL):
        raise AssertionError("the card and the plain CPU path disagree on the full-width model")
    return launches


# ---------------------------------------------------------------------------
# 7. train
# ---------------------------------------------------------------------------

def train_args(**overrides):
    """The arguments of bench.py:63-82 under the JAX package's names."""
    args = dict(
        arch="conv_transformer", criterion="label_smoothed_cross_entropy", label_smoothing=0.1,
        optimizer="adam", adam_betas="(0.9, 0.98)", adam_eps=1e-8, weight_decay=0.0,
        lr=[0.002], lr_scheduler="inverse_sqrt", warmup_updates=4000, warmup_init_lr=-1.0,
        clip_norm=10.0, bf16=True, max_source_positions=2048, max_target_positions=512,
        input_feat_per_channel=N_MELS, seed=1,
    )
    args.update(overrides)
    return types.SimpleNamespace(**args)


def train_sample(d, rng, batch=TRAIN_BATCH, frames=TRAIN_FRAMES):
    """bench.py::_host_sample: lengths in [0.8 frames, frames], random
    target tokens after eos."""
    lengths = rng.randint(int(frames * 0.8), frames + 1, size=batch).astype(np.int64)
    lengths[0] = frames
    prev = rng.randint(4, VOCAB - 1, size=(batch, TGT_LEN)).astype(np.int64)
    prev[:, 0] = d.eos()
    target = np.concatenate([prev[:, 1:], np.full((batch, 1), d.eos())], axis=1).astype(np.int64)
    return {
        "net_input": {
            "src_tokens": rng.randn(batch, frames, N_MELS).astype(np.float32),
            "src_lengths": lengths,
            "prev_output_tokens": prev,
        },
        "target": target,
        "ntokens": int((target != d.pad()).sum()),
        "nsentences": batch,
    }


def staged(sample, dtype, device="cuda"):
    """The sample's arrays on the device ahead of the step, the features in
    the compute type (bench.py's stage_sample)."""
    put = lambda x, fl=False: torch.as_tensor(x).to(device, dtype if fl else None)  # noqa: E731
    net = sample["net_input"]
    return {**sample, "target": put(sample["target"]),
            "net_input": {"src_tokens": put(net["src_tokens"], True), "src_lengths": put(net["src_lengths"]),
                          "prev_output_tokens": put(net["prev_output_tokens"])}}


def train_flops(enc, dec, batch, frames, tgt_len):
    """FLOPs of one train step: 3x the forward's, counting 2 per multiply-add
    of every matmul, conv and attention product at the padded shapes:

      conv i (c_in -> c_out, k_t x k_f, stride 2):  2 B c_out T_i F_i k_t k_f c_in
      ConvAttention2D (H heads, C channels), per block:
          qkv conv 2 B 3H T F 9 C + out conv 2 B C T F 9 2H
          + time attention 4 B H T T F + frequency attention 4 B H F F T
      fc3: 2 B T (C F) E
      encoder layer: 8 B T E^2 (q, k, v, out) + 4 B T E FFN + 4 B T T E
      decoder layer: 8 B L E^2 (self) + 4 B L E^2 + 4 B T E^2 (cross q/out,
          k/v on the encoder) + 4 B L E FFN + 4 B E (L(L+1)/2 + L T)
      output projection: 2 B L E V
    """
    fr = enc.frontend
    b, f, t, c_in = batch, fr.audio_features, frames, 1
    fwd = 0.0
    for c_out, kt, kf in fr.convolutions:
        t, f = math.ceil(t / fr.stride), math.ceil(f / fr.stride)
        fwd += 2.0 * b * c_out * t * f * kt * kf * c_in
        c_in = c_out
    if fr.attn_2d:
        h, c = fr.attn_2d_heads, c_in
        per_block = (2.0 * b * 3 * h * t * f * 9 * c + 2.0 * b * c * t * f * 9 * 2 * h
                     + 4.0 * b * h * t * t * f + 4.0 * b * h * f * f * t)
        fwd += 2 * per_block
    e = enc.embed_dim
    fwd += 2.0 * b * t * (c_in * f) * e
    fwd += enc.layers * (8.0 * b * t * e * e + 4.0 * b * t * e * enc.ffn_dim + 4.0 * b * t * t * e)
    ed, l = dec.embed_dim, tgt_len
    fwd += dec.layers * (8.0 * b * l * ed * ed + 4.0 * b * l * ed * ed + 4.0 * b * t * ed * ed
                         + 4.0 * b * l * ed * dec.ffn_dim + 4.0 * b * ed * (l * (l + 1) / 2 + l * t))
    fwd += 2.0 * b * l * ed * dec.vocab_size
    return 3.0 * fwd


def train(card, d, fa, dconv, single, modules):
    Trainer, SpeechRecognitionTask = modules["Trainer"], modules["SpeechRecognitionTask"]
    args = train_args()
    task = SpeechRecognitionTask(args, d)
    model = task.build_model(args)
    trainer = Trainer(args, task, model, task.build_criterion(args))
    sample = staged(train_sample(d, np.random.RandomState(0)), torch.bfloat16)
    frames_per_batch = int(sample["net_input"]["src_lengths"].sum())
    flops = train_flops(model.encoder_cfg, model.decoder_cfg, TRAIN_BATCH, TRAIN_FRAMES, TGT_LEN)

    outs = []
    for _ in range(WARMUP_STEPS):
        outs.append(trainer.train_step([sample]))
    torch.cuda.synchronize()

    reset_counts(fa, dconv, single)
    torch.cuda.reset_peak_memory_stats()
    step_ms = []
    for _ in range(REPEATS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(TIMED_STEPS):
            outs.append(trainer.train_step([sample]))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) / TIMED_STEPS * 1e3)
    launches = launch_counts(fa, dconv, single)
    steps = REPEATS * TIMED_STEPS
    want = step_launches(launches, steps, CT_FLASH_CALLS_PER_STEP)
    if launches != want:
        raise AssertionError(f"train launches {launches}, expected {want} over {steps} steps")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    per_token = [float(o["loss"]) / float(o["sample_size"]) for o in outs]
    gnorms = [float(o["gnorm"]) for o in outs]
    if not (np.isfinite(per_token).all() and np.isfinite(gnorms).all()):
        raise AssertionError("non-finite loss or gnorm in the train phase")
    first, last = float(np.mean(per_token[1:6])), float(np.mean(per_token[-5:]))
    if not last < first:
        raise AssertionError(f"the loss did not fall on a fixed batch: {first} -> {last}")
    median = float(np.median(step_ms))
    emit({"phase": "train", "arch": "conv_transformer", "batch": TRAIN_BATCH, "frames": TRAIN_FRAMES,
          "tgt_len": TGT_LEN, "dtype": "bfloat16", "backward": BF16_BACKWARD,
          "step_ms_median": median, "step_ms_repeats": step_ms, "step_ms_spread": max(step_ms) - min(step_ms),
          "frames_per_s": frames_per_batch / (median / 1e3), "flops_per_step": flops,
          "mfu": flops / (median / 1e3) / PEAK_BF16, "flash_launches_per_step":
          {k: v / steps for k, v in launches.items()}, "peak_memory_gb": peak_gb,
          "loss_per_token_first": per_token[0], "loss_per_token_steps_1_5": first,
          "loss_per_token_last5": last, "gnorm_last": gnorms[-1], "lr_last": float(outs[-1]["lr"]),
          "card": card})

    wall_s, busy_s, top, classes = profile_window(lambda: trainer.train_step([sample]))
    emit({"phase": "train_profile", "step_s": wall_s, "device_busy_s": busy_s,
          "device_idle_share": 1.0 - busy_s / wall_s, "top_kernels_s": top, "busy_by_class_s": classes, "card": card})

    # the same path with each backward forced, in short runs: the fused
    # kernel and the split pair in bf16, and the split pair in fp32, where
    # it runs on the CUDA cores
    total = dict(launches)
    fp32_args = train_args(bf16=False)
    fp32_trainer = Trainer(fp32_args, task, task.build_model(fp32_args), task.build_criterion(fp32_args))
    fp32_sample = staged(train_sample(d, np.random.RandomState(0)), torch.float32)
    for route, fused, tr, smp, dtype, n in (("fused", True, trainer, sample, torch.bfloat16, SPLIT_STEPS),
                                             ("split_tc", False, trainer, sample, torch.bfloat16, SPLIT_STEPS),
                                             ("split_cuda_core", False, fp32_trainer, fp32_sample, torch.float32, 2)):
        with fa.backward_forced(fused):
            tr.train_step([smp])
            torch.cuda.synchronize()
            reset_counts(fa, dconv, single)
            t0 = time.perf_counter()
            for _ in range(n):
                tr.train_step([smp])
            torch.cuda.synchronize()
            forced_ms = (time.perf_counter() - t0) / n * 1e3
            got = launch_counts(fa, dconv, single)
            want = step_launches(got, n, CT_FLASH_CALLS_PER_STEP, route)
        if got != want:
            raise AssertionError(f"{route} backward ({dtype}) launches {got}, expected {want}")
        emit({"phase": "train", "backward": route,
              "dtype": str(dtype).replace("torch.", ""), "steps": n, "step_ms": forced_ms,
              "flash_launches_per_step": {k: v / n for k, v in got.items()}, "card": card})
        total = {k: total[k] + got[k] for k in total}
    del fp32_trainer
    return total


def step_launches(counts, steps, calls, route=BF16_BACKWARD):
    """The launches ``steps`` train steps make, as ``counts``' keys:
    ``calls`` flash forwards a step and as many backwards by ``route``
    (``BACKWARD_KERNELS``), besides nothing else."""
    want = {k: 0 for k in counts}
    for name in ("flash_fwd",) + BACKWARD_KERNELS[route]:
        want[name] = steps * calls
    return want


class _EvalCriterion:
    """The criterion in eval mode (no dropout, BatchNorm running stats):
    the deterministic step of tests/test_corpus_parity.py."""

    def __init__(self, criterion):
        self.criterion = criterion

    def __call__(self, model, batch, generator=None, training=False):
        return self.criterion(model, batch, generator, training=False)


def one_step(d, modules, device, sample, deterministic=False, **overrides):
    """A fresh full-width fp32 model (seed 1) after one train step with
    lr 2e-3 from the first update; returns (model, step outputs)."""
    Trainer, SpeechRecognitionTask = modules["Trainer"], modules["SpeechRecognitionTask"]
    args = train_args(bf16=False, dropout=0.0, attention_dropout=0.0, relu_dropout=0.0,
                      warmup_updates=1, warmup_init_lr=0.002, **overrides)
    task = SpeechRecognitionTask(args, d)
    model = task.build_model(args, device=device)
    criterion = task.build_criterion(args)
    trainer = Trainer(args, task, model, _EvalCriterion(criterion) if deterministic else criterion)
    out = trainer.train_step([sample])
    return model, out


def compare_steps(label, a, b, forward, lr=0.002):
    """One train step of two paths: loss, gnorm, the gradients' global
    relative difference and the largest parameter difference, against the
    tolerances of ``forward`` ("same_forward" or "other_forward")."""
    (model_a, out_a), (model_b, out_b) = a, b
    loss_a, loss_b = float(out_a["loss"]), float(out_b["loss"])
    gn_a, gn_b = float(out_a["gnorm"]), float(out_b["gnorm"])
    pa = dict(model_a.named_parameters())
    num = den = 0.0
    max_dp = 0.0
    apart = {}
    for name, p in model_b.named_parameters():
        q = pa[name]
        ga, gb = q.grad.detach().double().cpu(), p.grad.detach().double().cpu()
        num += float((ga - gb).square().sum())
        den += float(ga.square().sum())
        dp = (q.detach().cpu() - p.detach().cpu()).abs()
        max_dp = max(max_dp, float(dp.max()))
        apart[name] = int((dp > lr).sum())
    moved_apart = sum(apart.values())
    most_apart = sorted(((n, c) for n, c in apart.items() if c), key=lambda nc: -nc[1])[:4]
    grad_rel = (num / max(den, 1e-30)) ** 0.5
    rtol = RTOL_STEP_GRAD[forward]
    row = {"phase": "train_step_check", "check": label, "loss": [loss_a, loss_b], "gnorm": [gn_a, gn_b],
           "loss_rel_err": abs(loss_a - loss_b) / abs(loss_b), "gnorm_rel_err": abs(gn_a - gn_b) / abs(gn_b),
           "grad_global_rel_diff": grad_rel, "max_param_abs_diff": max_dp,
           "param_elements_apart_by_more_than_lr": moved_apart, "most_apart": most_apart,
           "loss_rtol": RTOL_STEP_LOSS, "grad_rtol": rtol}
    emit(row)
    if not (row["loss_rel_err"] <= RTOL_STEP_LOSS and row["gnorm_rel_err"] <= rtol
            and grad_rel <= rtol and max_dp <= 2 * lr + 1e-6):
        raise AssertionError(f"train-step check {label} failed: {row}")


def check_train_steps(d, fa, attention, modules):
    sample = staged(train_sample(d, np.random.RandomState(1), batch=32), torch.float32)
    attention.set_flash_attention(None)
    flash = one_step(d, modules, "cuda", sample)
    attention.set_flash_attention(False)
    dense = one_step(d, modules, "cuda", sample)
    attention.set_flash_attention(None)
    compare_steps("flash_vs_dense", flash, dense, "other_forward")

    with fa.backward_forced(False):  # fp32: the split pair on the CUDA cores
        split = one_step(d, modules, "cuda", sample)
    compare_steps("fused_vs_split", flash, split, "same_forward")

    # the plain CPU path (dense: auto mode sends no CPU call to the flash
    # route) against the card's flash route, and the floor: its dense route
    small = train_sample(d, np.random.RandomState(2), batch=2)
    cpu = one_step(d, modules, "cpu", staged(small, torch.float32, device="cpu"), deterministic=True)
    card = one_step(d, modules, "cuda", staged(small, torch.float32), deterministic=True)
    compare_steps("card_vs_cpu", card, cpu, "other_forward")
    attention.set_flash_attention(False)
    card_dense = one_step(d, modules, "cuda", staged(small, torch.float32), deterministic=True)
    attention.set_flash_attention(None)
    compare_steps("dense_card_vs_cpu", card_dense, cpu, "other_forward")


# ---------------------------------------------------------------------------
# 5. dynamic-conv kernels
# ---------------------------------------------------------------------------

def valid_taps(t: int, k: int, padding_l: int) -> int:
    """(position, tap) pairs whose input t + tap - padding_l lies in [0, T):
    the multiply-adds a channel needs (taps on the zero halo need none)."""
    return sum(max(0, min(t, pos + k - padding_l) - max(0, pos - padding_l)) for pos in range(t))


def dconv_bound_ms(kind, b, t, c, h, k, padding_l, dtype):
    """The forward moves x, w in and out back; the backward x, w, g in and
    dx, dw out. Multiply-adds: B C valid_taps for out, twice that for dx
    and dw."""
    item = torch.tensor([], dtype=dtype).element_size()
    xs, ws = b * t * c, b * t * h * k
    nbytes = item * ((2 * xs + ws) if kind == "fwd" else (3 * xs + 2 * ws))
    macs = b * c * valid_taps(t, k, padding_l) * (1 if kind == "fwd" else 2)
    return bound_ms(nbytes, 2.0 * macs, dtype)


def check_dconv_kernels(dconv):
    """Each dynamic-conv call in fp32 and bf16: the forward and the backward
    against the plain versions on the same inputs; times and bounds."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    rows = []
    worst = {(kind, dtype): 0.0 for kind in ("fwd", "bwd") for dtype in (torch.float32, torch.bfloat16)}
    for name, b, t, c, h, k, pad_l in DCONV_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn((b, t, c), generator=gen, device="cuda").to(dtype)
            w = torch.softmax(torch.randn((b, t, h, k), generator=gen, device="cuda"), dim=-1).to(dtype)
            g = torch.randn((b, t, c), generator=gen, device="cuda").to(dtype)
            out_k = dconv.dynamic_conv(x, w, pad_l)
            dx_k, dw_k = dconv.dynamic_conv_backward(x, w, g, pad_l)
            out_p = dconv.dynamic_conv_reference(x, w, pad_l)
            dx_p, dw_p = dconv.dynamic_conv_backward_reference(x, w, g, pad_l)
            torch.cuda.synchronize()
            err = lambda a, b_: (a.float() - b_.float()).abs().max().item()  # noqa: E731
            errs = {"fwd": err(out_k, out_p), "dx": err(dx_k, dx_p), "dw": err(dw_k, dw_p)}
            dw_tol = RTOL_DW[dtype] * dw_p.float().abs().max().item()
            ok = errs["fwd"] <= ATOL_KERNEL[dtype] and errs["dx"] <= ATOL_GRAD[dtype] and errs["dw"] <= dw_tol
            worst[("fwd", dtype)] = max(worst[("fwd", dtype)], errs["fwd"])
            worst[("bwd", dtype)] = max(worst[("bwd", dtype)], errs["dx"], errs["dw"])
            base = {"phase": "dconv_kernel_check", "shape": name, "B": b, "T": t, "C": c, "H": h, "K": k,
                    "padding_l": pad_l, "dtype": str(dtype).replace("torch.", ""), "library_ms": None}
            fwd = lambda: dconv.dynamic_conv(x, w, pad_l)  # noqa: E731
            bwd = lambda: dconv.dynamic_conv_backward(x, w, g, pad_l)  # noqa: E731
            timings = {
                "dynamic_conv_fwd": dict(
                    kernel_ms=time_ms(fwd), kernel_device_ms=device_ms(fwd, "dynamic_conv_fwd_kernel"),
                    plain_ms=time_ms(lambda: dconv.dynamic_conv_reference(x, w, pad_l)),
                    max_abs_err=errs["fwd"], atol=ATOL_KERNEL[dtype],
                    bound=dconv_bound_ms("fwd", b, t, c, h, k, pad_l, dtype)),
                "dynamic_conv_bwd": dict(
                    kernel_ms=time_ms(bwd), kernel_device_ms=device_ms(bwd, "dynamic_conv_bwd_kernel"),
                    plain_ms=time_ms(lambda: dconv.dynamic_conv_backward_reference(x, w, g, pad_l)),
                    max_abs_err=max(errs["dx"], errs["dw"]), dx_max_abs_err=errs["dx"],
                    dw_max_abs_err=errs["dw"], atol=ATOL_GRAD[dtype], dw_tol=dw_tol,
                    bound=dconv_bound_ms("bwd", b, t, c, h, k, pad_l, dtype)),
            }
            for kernel, tm in timings.items():
                tm["bound_ms"], tm["bound_by"] = tm.pop("bound")
                row = {**base, "kernel": kernel, **tm}
                emit(row)
                rows.append(row)
            if not ok:
                raise AssertionError(f"dynamic conv disagrees with its plain version at {name} {dtype}: "
                                     f"{errs}, dw tolerance {dw_tol}")
    return rows, worst


# ---------------------------------------------------------------------------
# 9.-11. the lightconv paths
# ---------------------------------------------------------------------------

def lc_dictionary(Dictionary):
    d = Dictionary()
    for i in range(LC_VOCAB - 4):
        d.add_symbol(f"tok{i}")
    d.finalize(padding_factor=8)
    return d


def text_pairs(rng, n, lo, hi, vocab, tgt=None):
    """n random sentences of lo-hi tokens (the last one eos), and targets
    of ``tgt`` = (lo, hi) tokens when given; the first source is hi long."""
    lengths = rng.randint(lo, hi + 1, size=n)
    lengths[0] = hi
    src = [np.append(rng.randint(4, vocab, size=m - 1), 2) for m in lengths]
    if tgt is None:
        return src, None
    tgt_lengths = rng.randint(tgt[0], tgt[1] + 1, size=n)
    return src, [np.append(rng.randint(4, vocab, size=m - 1), 2) for m in tgt_lengths]


def collate(LanguagePairDataset, src_dict, tgt_dict, src, tgt=None):
    """The port's collater over all pairs (sources padded on the left)."""
    ds = LanguagePairDataset(src, [len(s) for s in src], src_dict, tgt,
                             None if tgt is None else [len(t) for t in tgt], tgt_dict)
    return ds.collater([ds[i] for i in range(len(src))])


def launch_counts(fa, dconv, single):
    return {"flash_fwd": fa.launches_fwd, "flash_bwd_fused": fa.launches_bwd_fused,
            "flash_bwd_dq": fa.launches_bwd_dq, "flash_bwd_dkv": fa.launches_bwd_dkv,
            "flash_bwd_dq_tc": fa.launches_bwd_dq_tc, "flash_bwd_dkv_tc": fa.launches_bwd_dkv_tc,
            "dconv_fwd": dconv.launches_fwd, "dconv_bwd": dconv.launches_bwd,
            "flash_fwd_single": single.launches}


def reset_counts(fa, dconv, single):
    fa.reset_launches()
    dconv.reset_launches()
    single.reset_launches()


def serve_lightconv(card, dicts, fa, dconv, single, modules):
    build_model, SequenceGenerator = modules["build_model"], modules["SequenceGenerator"]
    LanguagePairDataset = modules["LanguagePairDataset"]
    src_dict, tgt_dict = dicts
    model = build_model(LC_ARCH, tgt_dict, src_dict, seed=0)
    params = sum(p.numel() for p in model.parameters())
    cfg = model.cfg
    emit({"phase": "lightconv_model", "arch": LC_ARCH, "params": params, "embed_dim": cfg.embed_dim,
          "ffn_dim": cfg.ffn_dim, "heads": cfg.encoder_layers[0].heads, "conv_dim": cfg.encoder_layers[0].conv_dim,
          "encoder_kernels": [lc.kernel_size for lc in cfg.encoder_layers],
          "decoder_kernels": [lc.kernel_size for lc in cfg.decoder_layers],
          "glu": cfg.encoder_layers[0].glu, "dropout": cfg.dropout,
          "attention_dropout": cfg.encoder_layers[0].attention_dropout,
          "weight_dropout": cfg.encoder_layers[0].weight_dropout,
          "input_dropout": cfg.encoder_layers[0].input_dropout,
          "src_vocab": cfg.src_vocab, "tgt_vocab": cfg.tgt_vocab, "use_kernel": model.use_kernel})
    gen = SequenceGenerator(tgt_dict, beam_size=BEAM, max_len_b=MAX_LEN_B)
    rng = np.random.RandomState(3)
    requests = [(name, collate(LanguagePairDataset, src_dict, tgt_dict, text_pairs(rng, n, lo, hi, LC_VOCAB)[0]))
                for name, n, lo, hi in (("wmt_32x10-60", 32, 10, 60), ("long_8x200-250", 8, 200, 250),
                                        ("single_1x30", 1, 30, 30))]
    gen.generate([model], requests[2][1])  # warm-up

    reset_counts(fa, dconv, single)
    served = []
    for name, sample in requests:
        before = launch_counts(fa, dconv, single)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hypos = gen.generate([model], sample)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        n = len(sample["net_input"]["src_lengths"])
        check_hypotheses(hypos, tgt_dict.eos(), n)
        grew = {k: v - before[k] for k, v in launch_counts(fa, dconv, single).items()}
        want = {k: DCONV_LAUNCHES_PER_REQUEST if k == "dconv_fwd" else 0 for k in grew}
        if grew != want:
            raise AssertionError(f"{name}: launches grew by {grew}, expected {want}")
        src_tokens = int(sample["net_input"]["src_lengths"].sum())
        served.append((name, sample, hypos))
        emit({"phase": "serve_lightconv", "request": name, "sentences": n, "decode_s": decode_s,
              "source_tokens": src_tokens, "source_tokens_per_s": src_tokens / decode_s,
              "launches": grew, "mean_hyp_len": float(np.mean([len(s[0]["tokens"]) for s in hypos])),
              "card": card})
    launches = launch_counts(fa, dconv, single)

    name, sample, hypos = served[0]
    wall_s, busy_s, top, classes = profile_window(lambda: gen.generate([model], sample))
    emit({"phase": "profile_lightconv", "request": name, "decode_s_profiled": wall_s, "device_busy_s": busy_s,
          "device_idle_share_profiled": 1.0 - busy_s / wall_s, "top_kernels_s": top,
          "busy_by_class_s": classes, "card": card})

    # the kernel route against the plain route of the dynamic conv
    def teacher_forced(sample, hypos, device="cuda"):
        net = sample["net_input"]
        return {"src_tokens": torch.as_tensor(net["src_tokens"], device=device),
                "src_lengths": torch.as_tensor(net["src_lengths"], device=device),
                "prev_output_tokens": torch.as_tensor(
                    teacher_forced_tokens(hypos, tgt_dict.pad(), tgt_dict.eos()), device=device)}

    for name, sample, hypos in served:
        batch = teacher_forced(sample, hypos)
        with torch.no_grad():
            logits_k, extra_k = model(batch)
            model.use_kernel = False
            logits_p, extra_p = model(batch)
            hypos_p = gen.generate([model], sample)
            model.use_kernel = True
        enc_err = (extra_k["encoder_out"].encoder_out - extra_p["encoder_out"].encoder_out).abs().max().item()
        logit_err = (logits_k - logits_p).abs().max().item()
        same = sum(list(a[0]["tokens"]) == list(b[0]["tokens"]) for a, b in zip(hypos, hypos_p))
        del logits_k, logits_p
        emit({"phase": "lightconv_kernel_vs_plain", "request": name, "encoder_max_abs_err": enc_err,
              "logits_max_abs_err": logit_err, "atol": ATOL_MODEL,
              "identical_top_hypotheses": f"{same}/{len(hypos)}"})
        if not (enc_err <= ATOL_MODEL and logit_err <= ATOL_MODEL and same == len(hypos)):
            raise AssertionError(f"{name}: the dynamic conv's kernel and plain routes disagree on the "
                                 "full-width model")

    # the card against the plain CPU path on 2 sentences
    two_src, _ = text_pairs(np.random.RandomState(4), 2, 20, 30, LC_VOCAB)
    two = collate(LanguagePairDataset, src_dict, tgt_dict, two_src)
    hypos_two = gen.generate([model], two)
    cpu_model = build_model(LC_ARCH, tgt_dict, src_dict, device="cpu", seed=0)
    with torch.no_grad():
        logits_cpu, extra_cpu = cpu_model(teacher_forced(two, hypos_two, "cpu"))
        logits_gpu, extra_gpu = model(teacher_forced(two, hypos_two))
    enc_err = (extra_gpu["encoder_out"].encoder_out.cpu() - extra_cpu["encoder_out"].encoder_out).abs().max().item()
    logit_err = (logits_gpu.cpu() - logits_cpu).abs().max().item()
    hypos_cpu = gen.generate([cpu_model], two)
    same = sum(list(a[0]["tokens"]) == list(b[0]["tokens"]) for a, b in zip(hypos_two, hypos_cpu))
    emit({"phase": "lightconv_card_vs_cpu", "sentences": 2, "encoder_max_abs_err": enc_err,
          "logits_max_abs_err": logit_err, "atol": ATOL_MODEL, "identical_top_hypotheses": f"{same}/2"})
    if not (enc_err <= ATOL_MODEL and logit_err <= ATOL_MODEL):
        raise AssertionError("the card and the plain CPU path disagree on the full-width lightconv model")
    return launches


def lightconv_train_flops(cfg, batch, src_len, tgt_len):
    """FLOPs of one lightconv train step: 3x the forward's, 2 per
    multiply-add, at the padded shapes (B, S source, L target tokens;
    E embed, Cd conv_dim, F ffn, H heads, K taps, V target vocabulary):

      conv layer on N tokens: 2 B N E Cd (x2 with GLU) + 2 B N Cd H K
          (kernel prediction) + 2 B N Cd K (band) + 2 B N Cd E + 4 B N E F
      decoder layer adds encoder attention: 4 B L E^2 (q, out)
          + 4 B S E^2 (k, v) + 4 B L S E
      output projection: 2 B L E V
    """
    def conv_layer(lc, n):
        lin1 = 2 * lc.conv_dim if lc.glu else lc.conv_dim
        return batch * n * (2.0 * lc.embed_dim * lin1 + 2.0 * lc.conv_dim * lc.heads * lc.kernel_size
                            + 2.0 * lc.conv_dim * lc.kernel_size + 2.0 * lc.conv_dim * lc.embed_dim
                            + 4.0 * lc.embed_dim * lc.ffn_dim)

    e = cfg.embed_dim
    fwd = sum(conv_layer(lc, src_len) for lc in cfg.encoder_layers)
    fwd += sum(conv_layer(lc, tgt_len) + 4.0 * batch * tgt_len * e * e + 4.0 * batch * src_len * e * e
               + 4.0 * batch * tgt_len * src_len * e for lc in cfg.decoder_layers)
    fwd += 2.0 * batch * tgt_len * e * cfg.tgt_vocab
    return 3.0 * fwd


def lc_train_sample(modules, dicts, rng, batch):
    src_dict, tgt_dict = dicts
    src, tgt = text_pairs(rng, batch, *LC_TRAIN_LEN, LC_VOCAB, tgt=LC_TRAIN_LEN)
    return collate(modules["LanguagePairDataset"], src_dict, tgt_dict, src, tgt)


def staged_text(sample, device="cuda"):
    """The collated sample's arrays on the device ahead of the step."""
    put = lambda x: torch.as_tensor(x).to(device)  # noqa: E731
    return {**sample, "target": put(sample["target"]),
            "net_input": {k: put(v) for k, v in sample["net_input"].items()}}


def lc_train_args(**overrides):
    return train_args(arch=LC_ARCH, max_source_positions=1024, max_target_positions=1024, **overrides)


def train_lightconv(card, dicts, fa, dconv, single, modules):
    Trainer, TranslationTask = modules["Trainer"], modules["TranslationTask"]
    args = lc_train_args()
    task = TranslationTask(args, *dicts)
    model = task.build_model(args)
    trainer = Trainer(args, task, model, task.build_criterion(args))
    sample = staged_text(lc_train_sample(modules, dicts, np.random.RandomState(5), LC_TRAIN_BATCH))
    net = sample["net_input"]
    src_len, tgt_len = net["src_tokens"].shape[1], net["prev_output_tokens"].shape[1]
    flops = lightconv_train_flops(model.cfg, LC_TRAIN_BATCH, src_len, tgt_len)

    outs = [trainer.train_step([sample]) for _ in range(WARMUP_STEPS)]
    torch.cuda.synchronize()
    reset_counts(fa, dconv, single)
    torch.cuda.reset_peak_memory_stats()
    step_ms = []
    for _ in range(REPEATS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(LC_TIMED_STEPS):
            outs.append(trainer.train_step([sample]))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) / LC_TIMED_STEPS * 1e3)
    launches = launch_counts(fa, dconv, single)
    steps = REPEATS * LC_TIMED_STEPS
    want = step_launches(launches, steps, LC_FLASH_LAUNCHES_PER_STEP)
    want.update(dconv_fwd=DCONV_LAUNCHES_PER_STEP * steps, dconv_bwd=DCONV_LAUNCHES_PER_STEP * steps)
    if launches != want:
        raise AssertionError(f"lightconv train launches {launches}, expected {want} over {steps} steps")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    per_token = [float(o["loss"]) / float(o["sample_size"]) for o in outs]
    gnorms = [float(o["gnorm"]) for o in outs]
    if not (np.isfinite(per_token).all() and np.isfinite(gnorms).all()):
        raise AssertionError("non-finite loss or gnorm in the lightconv train phase")
    first, last = float(np.mean(per_token[1:6])), float(np.mean(per_token[-5:]))
    if not last < first:
        raise AssertionError(f"the lightconv loss did not fall on a fixed batch: {first} -> {last}")
    median = float(np.median(step_ms))
    tgt_tokens = int(sample["ntokens"])
    emit({"phase": "train_lightconv", "arch": LC_ARCH, "batch": LC_TRAIN_BATCH, "src_len": src_len,
          "tgt_len": tgt_len, "target_tokens": tgt_tokens, "dtype": "bfloat16",
          "backward": BF16_BACKWARD,
          "step_ms_median": median, "step_ms_repeats": step_ms, "step_ms_spread": max(step_ms) - min(step_ms),
          "target_tokens_per_s": tgt_tokens / (median / 1e3), "flops_per_step": flops,
          "mfu": flops / (median / 1e3) / PEAK_BF16, "launches_per_step": {k: v / steps for k, v in launches.items()},
          "peak_memory_gb": peak_gb, "loss_per_token_first": per_token[0], "loss_per_token_steps_1_5": first,
          "loss_per_token_last5": last, "gnorm_last": gnorms[-1], "lr_last": float(outs[-1]["lr"]), "card": card})

    wall_s, busy_s, top, classes = profile_window(lambda: trainer.train_step([sample]))
    emit({"phase": "train_lightconv_profile", "step_s": wall_s, "device_busy_s": busy_s,
          "device_idle_share": 1.0 - busy_s / wall_s, "top_kernels_s": top, "busy_by_class_s": classes, "card": card})
    return launches


def one_lc_step(dicts, modules, device, sample, use_kernel, deterministic=False):
    """A fresh full-width fp32 lightconv (seed 1) after one train step with
    lr 2e-3 from the first update; returns (model, step outputs)."""
    Trainer, TranslationTask = modules["Trainer"], modules["TranslationTask"]
    args = lc_train_args(bf16=False, dropout=0.0, attention_dropout=0.0, relu_dropout=0.0,
                         weight_dropout=0.0, input_dropout=0.0, warmup_updates=1, warmup_init_lr=0.002)
    task = TranslationTask(args, *dicts)
    model = task.build_model(args, device=device)
    model.use_kernel = use_kernel
    criterion = task.build_criterion(args)
    trainer = Trainer(args, task, model, _EvalCriterion(criterion) if deterministic else criterion)
    return model, trainer.train_step([sample])


def check_lightconv_steps(dicts, modules):
    sample = staged_text(lc_train_sample(modules, dicts, np.random.RandomState(6), 32))
    kernel = one_lc_step(dicts, modules, "cuda", sample, use_kernel=True)
    plain = one_lc_step(dicts, modules, "cuda", sample, use_kernel=False)
    compare_steps("lightconv_kernel_vs_plain", kernel, plain, "other_forward")
    del kernel, plain
    small = lc_train_sample(modules, dicts, np.random.RandomState(7), 2)
    cpu = one_lc_step(dicts, modules, "cpu", staged_text(small, "cpu"), use_kernel=False, deterministic=True)
    card = one_lc_step(dicts, modules, "cuda", staged_text(small), use_kernel=True, deterministic=True)
    compare_steps("lightconv_card_vs_cpu", card, cpu, "other_forward")


# ---------------------------------------------------------------------------
# 12.-13. the single-pass kernel and the flash sweep
# ---------------------------------------------------------------------------

def check_single_kernel(single):
    """flash_fwd_single against its plain version in fp32 and bf16 at the
    sweep's shapes and ragged ones, at every t_block each type's kernel
    takes; then the shapes it refuses."""
    gen = torch.Generator(device="cuda").manual_seed(8)
    rows, worst = [], {torch.float32: 0.0, torch.bfloat16: 0.0}
    for name, bh, t, s, causal, padded, dtypes in SINGLE_SHAPES:
        d = 64
        scale = d ** -0.5
        for dtype in dtypes:
            q, k, v, bias = random_attention_inputs(gen, bh, s, s, d, dtype, padded)
            q = q[:, :t].contiguous()
            out_p, lse_p = single.flash_fwd_single_reference(q, k, v, bias, scale, causal)
            plain_ms = time_ms(lambda: single.flash_fwd_single_reference(q, k, v, bias, scale, causal), iters=5)
            library_ms, library_backend = time_library(q, k, v, bias, scale, causal, iters=5)
            for tb in single.T_BLOCKS[dtype]:
                run = lambda: single.flash_fwd_single(q, k, v, bias, scale, causal=causal, t_block=tb)  # noqa: E731
                out_k, lse_k = run()
                torch.cuda.synchronize()
                diff = (out_k.float() - out_p.float()).abs()
                err = diff.max().item()
                lse_err = (lse_k - lse_p).abs().max().item()
                atol, rtol = SINGLE_BF16_LIMIT if dtype == torch.bfloat16 else (ATOL_KERNEL[dtype], 0.0)
                limit_ratio = (diff / (atol + rtol * out_p.float().abs())).max().item()
                row = {"phase": "single_kernel_check", "kernel": "flash_fwd_single", "shape": name, "bh": bh,
                       "T": t, "S": s, "D": d, "causal": causal, "rate": 0.0, "t_block": tb,
                       "dtype": str(dtype).replace("torch.", ""), "max_abs_err": err, "lse_max_abs_err": lse_err,
                       "atol": ATOL_KERNEL[dtype], "elementwise_limit": [atol, rtol],
                       "max_err_over_elementwise_limit": limit_ratio, "kernel_ms": time_ms(run, iters=5),
                       "kernel_device_ms": device_ms(run, "flash_fwd_single_kernel", iters=5),
                       "plain_ms": plain_ms, "library_ms": library_ms, "library_backend": library_backend}
                row["bound_ms"], row["bound_by"] = attention_bound_ms(bh, t, s, d, causal, dtype)
                emit(row)
                rows.append(row)
                if not (err <= ATOL_KERNEL[dtype] and limit_ratio <= 1.0 and lse_err <= ATOL_LSE):
                    raise AssertionError(f"flash_fwd_single disagrees with its plain version at {name} {dtype} "
                                         f"t_block {tb}: max|out| err {err} ({limit_ratio} of the element-wise "
                                         f"limit), max|lse| err {lse_err}")
                worst[dtype] = max(worst[dtype], err)
            del q, k, v, bias, out_p, lse_p
            torch.cuda.empty_cache()
    # another head dim in either type, past the fp32 kernel's shared memory
    # (t_block 16 at S 3308), or a tile the bf16 kernel is not built for:
    # the wrapper raises before any launch and nothing falls back
    for dtype, s, d, tb in ((torch.float32, 256, 32, 8), (torch.bfloat16, 256, 32, 64),
                            (torch.float32, 3308, 64, 16), (torch.bfloat16, 256, 64, 16)):
        q, k, v, bias = random_attention_inputs(gen, 1, s, s, d, dtype, padded=False)
        before = single.launches
        try:
            single.flash_fwd_single(q, k, v, bias, d ** -0.5, t_block=tb)
        except ValueError as exc:
            emit({"phase": "single_kernel_refuses", "dtype": str(dtype).replace("torch.", ""), "S": s, "D": d,
                  "t_block": tb, "error": str(exc)})
        else:
            raise AssertionError(f"flash_fwd_single took {dtype} S {s} D {d} t_block {tb}, past what it is built for")
        if single.launches != before:
            raise AssertionError("flash_fwd_single launched a shape it refuses")
    return rows, worst


def flash_sweep(card, sweep, fa, dconv, single):
    """The port's flash sweep in full (its own asserts hold each
    single-pass tile against the flash forward)."""
    t0 = time.perf_counter()
    reset_counts(fa, dconv, single)
    rows = sweep.run()
    launches = launch_counts(fa, dconv, single)
    sweep.print_table(rows)
    for r in rows:
        emit({"phase": "flash_sweep", **r})
    decision = sweep.gate_from(rows)
    emit({"phase": "flash_sweep_decision_inputs", **decision, "seconds": time.perf_counter() - t0, "card": card})
    if not decision["pair_wins_everywhere"]:
        raise AssertionError(f"the fused backward beat the tensor-core pair at a train step's call, so the "
                             f"committed route {BF16_BACKWARD} needs a gate: {decision['pair_wins_by_call']}")
    return launches


# ---------------------------------------------------------------------------
# 14.-15. the CTC flagship
# ---------------------------------------------------------------------------

def ctc_dictionaries(Dictionary, d):
    """The target dictionary and a 700-symbol source dictionary; the task
    adds <ctc_blank> after the source symbols."""
    sd = Dictionary()
    for i in range(CTC_SRC_SYMBOLS):
        sd.add_symbol(f"s{i}")
    sd.finalize(padding_factor=8)
    return d, sd


def ctc_args(**overrides):
    """bench.py:367-380 under the JAX package's names."""
    return train_args(arch=CTC_ARCH, criterion="ctc_multi_loss",
                      underlying_criterion="label_smoothed_cross_entropy", ctc_encoder_layer=4,
                      ctc_weight=0.5, ctc_compress_out=True, **overrides)


def ctc_sample(d, rng, batch=TRAIN_BATCH):
    """bench.py:390-398: the train sample plus 64 transcript tokens a row
    over the source symbols (4 .. 703, never the blank at 704)."""
    sample = train_sample(d, rng, batch=batch)
    tr = rng.randint(4, 4 + CTC_SRC_SYMBOLS, size=(batch, CTC_TR_LEN)).astype(np.int64)
    sample["transcript_target"] = tr
    sample["transcript_target_lengths"] = np.full((batch,), CTC_TR_LEN, np.int64)
    sample["net_input"]["transcript_prev_output_tokens"] = np.concatenate(
        [np.full((batch, 1), d.eos(), np.int64), tr[:, :-1]], axis=1)
    return sample


def staged_ctc(sample, dtype, device="cuda"):
    out = staged(sample, dtype, device)
    for key in ("transcript_target", "transcript_target_lengths"):
        out[key] = torch.as_tensor(sample[key]).to(device)
    out["net_input"]["transcript_prev_output_tokens"] = torch.as_tensor(
        sample["net_input"]["transcript_prev_output_tokens"]).to(device)
    return out


def timed_steps(trainer, sample, steps, repeats=REPEATS):
    outs, step_ms = [], []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            outs.append(trainer.train_step([sample]))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) / steps * 1e3)
    return outs, step_ms


def train_ctc(card, dicts, fa, dconv, single, modules):
    Trainer, Task = modules["Trainer"], modules["SpeechTranslationCTCTask"]
    args = ctc_args()
    task = Task(args, *dicts)
    model = task.build_model(args)
    trainer = Trainer(args, task, model, task.build_criterion(args))
    sample = staged_ctc(ctc_sample(dicts[0], np.random.RandomState(0)), torch.bfloat16)
    frames_per_batch = int(sample["net_input"]["src_lengths"].sum())
    enc = model.encoder_cfg
    t_out = enc.frontend.out_length(TRAIN_FRAMES)
    flops = (train_flops(enc, model.decoder_cfg, TRAIN_BATCH, TRAIN_FRAMES, TGT_LEN)
             + 3 * 2.0 * TRAIN_BATCH * t_out * enc.embed_dim * enc.ctc_vocab_size)  # ctc_fc

    outs = [trainer.train_step([sample]) for _ in range(WARMUP_STEPS)]
    torch.cuda.synchronize()
    reset_counts(fa, dconv, single)
    torch.cuda.reset_peak_memory_stats()
    timed, step_ms = timed_steps(trainer, sample, CTC_TIMED_STEPS)
    outs += timed
    launches = launch_counts(fa, dconv, single)
    steps = REPEATS * CTC_TIMED_STEPS
    want = step_launches(launches, steps, CT_FLASH_CALLS_PER_STEP)  # compression keeps T' static rows
    if launches != want:
        raise AssertionError(f"ctc flagship launches {launches}, expected {want} over {steps} steps")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    per_sample = [float(o["loss"]) / float(o["sample_size"]) for o in outs]
    ctc_losses = [float(o["ctc_loss"]) for o in outs]
    gnorms = [float(o["gnorm"]) for o in outs]
    if not (np.isfinite(per_sample).all() and np.isfinite(gnorms).all() and np.isfinite(ctc_losses).all()):
        raise AssertionError("non-finite loss, ctc_loss or gnorm in the ctc flagship phase")
    first, last = float(np.mean(per_sample[1:6])), float(np.mean(per_sample[-5:]))
    if not last < first:
        raise AssertionError(f"the ctc flagship loss did not fall on a fixed batch: {first} -> {last}")
    median = float(np.median(step_ms))
    metrics = modules["CTCMultiLoss"].reduce_metrics([outs[-1]])
    emit({"phase": "train_ctc_flagship", "arch": CTC_ARCH, "batch": TRAIN_BATCH, "frames": TRAIN_FRAMES,
          "tgt_len": TGT_LEN, "transcript_len": CTC_TR_LEN, "ctc_vocab": enc.ctc_vocab_size,
          "blank": dicts[1].index("<ctc_blank>"), "dtype": "bfloat16", "backward": BF16_BACKWARD,
          "step_ms_median": median,
          "step_ms_repeats": step_ms, "step_ms_spread": max(step_ms) - min(step_ms),
          "frames_per_s": frames_per_batch / (median / 1e3), "flops_per_step": flops,
          "mfu": flops / (median / 1e3) / PEAK_BF16, "launches_per_step": {k: v / steps for k, v in launches.items()},
          "peak_memory_gb": peak_gb, "loss_per_sample_size_first": per_sample[0],
          "loss_per_sample_size_steps_1_5": first, "loss_per_sample_size_last5": last,
          "ctc_loss_first": ctc_losses[0], "ctc_loss_last": ctc_losses[-1], "metrics_last": metrics,
          "gnorm_last": gnorms[-1], "lr_last": float(outs[-1]["lr"]), "card": card})

    wall_s, busy_s, top, classes = profile_window(lambda: trainer.train_step([sample]))
    # the UER's edit distance at the step's shapes: (B, T') predictions
    # against (B, 64) transcripts
    model.eval()
    with torch.no_grad():
        enc_out = model.encode(sample["net_input"]["src_tokens"], sample["net_input"]["src_lengths"])
        pred, counts = modules["ctc_greedy_decode"](enc_out.ctc_out, enc_out.ctc_lengths, dicts[1].index("<ctc_blank>"))
    lev = lambda: modules["levenshtein"](pred, counts, sample["transcript_target"],  # noqa: E731
                                         sample["transcript_target_lengths"])
    lev_kernels, lev_busy_ms = device_busy(lev, iters=3)
    emit({"phase": "train_ctc_flagship_profile", "step_s": wall_s, "device_busy_s": busy_s,
          "device_idle_share": 1.0 - busy_s / wall_s, "top_kernels_s": top, "busy_by_class_s": classes,
          "edit_distance_kernels": lev_kernels, "edit_distance_device_ms": lev_busy_ms,
          "compressed_len_mean": float(enc_out.src_lengths.float().mean()), "card": card})
    return launches


def one_ctc_step(dicts, modules, device, sample, deterministic=False):
    """A fresh full-width fp32 CTC flagship model (seed 1) after one train
    step; returns (model, step outputs, the compressed lengths of the
    step's forward)."""
    Trainer, Task = modules["Trainer"], modules["SpeechTranslationCTCTask"]
    args = ctc_args(bf16=False, dropout=0.0, attention_dropout=0.0, relu_dropout=0.0,
                    warmup_updates=1, warmup_init_lr=0.002)
    task = Task(args, *dicts)
    model = task.build_model(args, device=device)
    criterion = task.build_criterion(args)
    trainer = Trainer(args, task, model, _EvalCriterion(criterion) if deterministic else criterion)
    seen = []
    hook = model.encoder.register_forward_hook(lambda m, i, out: seen.append(out.src_lengths.detach().cpu()))
    out = trainer.train_step([sample])
    hook.remove()
    return (model, out), seen[0]


def check_ctc_steps(dicts, modules, attention):
    sample = staged_ctc(ctc_sample(dicts[0], np.random.RandomState(9), batch=32), torch.float32)
    attention.set_flash_attention(None)
    flash, len_flash = one_ctc_step(dicts, modules, "cuda", sample)
    attention.set_flash_attention(False)
    dense, len_dense = one_ctc_step(dicts, modules, "cuda", sample)
    attention.set_flash_attention(None)
    check_lengths("ctc_flash_vs_dense", len_flash, len_dense)
    compare_steps("ctc_flash_vs_dense", flash, dense, "other_forward")
    del flash, dense
    small = ctc_sample(dicts[0], np.random.RandomState(10), batch=2)
    cpu, len_cpu = one_ctc_step(dicts, modules, "cpu", staged_ctc(small, torch.float32, "cpu"), deterministic=True)
    card, len_card = one_ctc_step(dicts, modules, "cuda", staged_ctc(small, torch.float32), deterministic=True)
    check_lengths("ctc_card_vs_cpu", len_card, len_cpu)
    compare_steps("ctc_card_vs_cpu", card, cpu, "other_forward")


def check_lengths(label, a, b):
    same = torch.equal(a, b)
    emit({"phase": "ctc_compressed_lengths", "check": label, "identical": same,
          "mean_length": float(a.float().mean()), "rows": int(a.numel())})
    if not same:
        raise AssertionError(f"{label}: the compressed lengths differ: {a.tolist()} vs {b.tolist()}")


# ---------------------------------------------------------------------------
# 16. the long-context train step
# ---------------------------------------------------------------------------

def train_long(card, d, fa, dconv, single, modules):
    Trainer, SpeechRecognitionTask = modules["Trainer"], modules["SpeechRecognitionTask"]
    args = train_args(max_source_positions=LONG_FRAMES)
    task = SpeechRecognitionTask(args, d)
    model = task.build_model(args)
    trainer = Trainer(args, task, model, task.build_criterion(args))
    sample = staged(train_sample(d, np.random.RandomState(0), batch=LONG_BATCH, frames=LONG_FRAMES), torch.bfloat16)
    frames_per_batch = int(sample["net_input"]["src_lengths"].sum())
    flops = train_flops(model.encoder_cfg, model.decoder_cfg, LONG_BATCH, LONG_FRAMES, TGT_LEN)

    outs = [trainer.train_step([sample]) for _ in range(WARMUP_STEPS)]
    torch.cuda.synchronize()
    reset_counts(fa, dconv, single)
    torch.cuda.reset_peak_memory_stats()
    timed, step_ms = timed_steps(trainer, sample, LONG_TIMED_STEPS)
    outs += timed
    launches = launch_counts(fa, dconv, single)
    steps = REPEATS * LONG_TIMED_STEPS
    want = step_launches(launches, steps, CT_FLASH_CALLS_PER_STEP)
    if launches != want:
        raise AssertionError(f"long-context launches {launches}, expected {want} over {steps} steps")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    per_token = [float(o["loss"]) / float(o["sample_size"]) for o in outs]
    if not (np.isfinite(per_token).all() and np.isfinite([float(o["gnorm"]) for o in outs]).all()):
        raise AssertionError("non-finite loss or gnorm in the long-context phase")
    median = float(np.median(step_ms))
    emit({"phase": "train_longcontext", "arch": "conv_transformer", "batch": LONG_BATCH, "frames": LONG_FRAMES,
          "encoder_len": model.encoder_cfg.frontend.out_length(LONG_FRAMES), "tgt_len": TGT_LEN,
          "dtype": "bfloat16", "backward": BF16_BACKWARD, "step_ms_median": median,
          "step_ms_repeats": step_ms, "step_ms_spread": max(step_ms) - min(step_ms),
          "frames_per_s": frames_per_batch / (median / 1e3),
          "flops_per_step": flops, "mfu": flops / (median / 1e3) / PEAK_BF16,
          "launches_per_step": {k: v / steps for k, v in launches.items()}, "peak_memory_gb": peak_gb,
          "loss_per_token_first": per_token[0], "loss_per_token_last": per_token[-1], "card": card})
    wall_s, busy_s, top, classes = profile_window(lambda: trainer.train_step([sample]))
    emit({"phase": "train_longcontext_profile", "step_s": wall_s, "device_busy_s": busy_s,
          "device_idle_share": 1.0 - busy_s / wall_s, "top_kernels_s": top, "busy_by_class_s": classes, "card": card})
    return launches


def check_long_steps(d, modules, attention):
    """Flash against dense route on one fp32 long-context step."""
    sample = staged(train_sample(d, np.random.RandomState(11), batch=LONG_BATCH, frames=LONG_FRAMES), torch.float32)
    attention.set_flash_attention(None)
    flash = one_step(d, modules, "cuda", sample, max_source_positions=LONG_FRAMES)
    attention.set_flash_attention(False)
    torch.cuda.reset_peak_memory_stats()
    dense = one_step(d, modules, "cuda", sample, max_source_positions=LONG_FRAMES)
    emit({"phase": "longcontext_dense_step", "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9})
    attention.set_flash_attention(None)
    compare_steps("longcontext_flash_vs_dense", flash, dense, "other_forward")


# ---------------------------------------------------------------------------

def find_row(rows, row_kernel, timed_at):
    return next(r for r in rows if r["kernel"] == row_kernel and r["shape"] == timed_at[0]
                and r["dtype"] == timed_at[1] and r.get("t_block") == (timed_at[2] if len(timed_at) > 2 else None))


def kernel_entry(name, row_kernel, source, replaces, launches, rows, worst_fp32, worst_bf16, timed_at, also_at=None):
    """The ``kernels`` line's entry of ``name``, timed at its row of
    ``row_kernel`` at ``timed_at`` = (shape, dtype[, t_block]), with the
    times of its row at ``also_at`` beside them when given. A kernel with
    no fp32 form reports its bf16 error as ``max_abs_err``."""
    head = find_row(rows, row_kernel, timed_at)
    where = (f"B{head['B']} T{head['T']} C{head['C']} H{head['H']} K{head['K']} padding_l {head['padding_l']}"
             if "K" in head else f"bh{head['bh']} T{head['T']} S{head['S']} D{head['D']} rate {head['rate']}")
    if "t_block" in head:
        where += f" t_block {head['t_block']}"
    entry = {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches, "max_abs_err": worst_fp32, "max_abs_err_bf16": worst_bf16,
        "ms": head["kernel_ms"], "device_ms": head["kernel_device_ms"],
        "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": head["library_ms"], "library_backend": head.get("library_backend"),
        "timed_at": f"{timed_at[0]} {where} {timed_at[1]}",
    }
    if worst_fp32 is None:
        entry["max_abs_err"] = worst_bf16
    for key in ("max_err_over_max_plain", "wrapper_device_ms", "split_route"):
        if key in head:
            entry[key] = head[key]
    if also_at is not None:
        r = find_row(rows, row_kernel, also_at)
        entry["at_" + also_at[0]] = {
            "bh": r["bh"], "T": r["T"], "S": r["S"], "D": r["D"], "dtype": also_at[1],
            **{k: r.get(k) for k in ("kernel_ms", "kernel_device_ms", "wrapper_device_ms", "plain_ms",
                                     "bound_ms", "bound_by", "library_ms", "library_backend",
                                     "max_abs_err", "max_err_over_max_plain")}}
    return entry


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    from fbk_fairseq_st_tpu_torch.criterions import CTCMultiLoss
    from fbk_fairseq_st_tpu_torch.data import Dictionary, LanguagePairDataset
    from fbk_fairseq_st_tpu_torch.generation import SequenceGenerator
    from fbk_fairseq_st_tpu_torch.models import build_model as build_any_model
    from fbk_fairseq_st_tpu_torch.models.conv_transformer import build_model
    from fbk_fairseq_st_tpu_torch.ops import attention
    from fbk_fairseq_st_tpu_torch.ops.ctc import ctc_greedy_decode
    from fbk_fairseq_st_tpu_torch.ops.edit_distance import levenshtein
    from fbk_fairseq_st_tpu_torch.ops.kernels import build as kernel_build
    from fbk_fairseq_st_tpu_torch.ops.kernels import dynamic_conv as dconv
    from fbk_fairseq_st_tpu_torch.ops.kernels import flash_attention as fa
    from fbk_fairseq_st_tpu_torch.ops.kernels import flash_fwd_single as single
    from fbk_fairseq_st_tpu_torch.ops.kernels import philox
    from fbk_fairseq_st_tpu_torch.scripts import bench_flash_sweep as sweep
    from fbk_fairseq_st_tpu_torch.tasks import SpeechRecognitionTask, SpeechTranslationCTCTask, TranslationTask
    from fbk_fairseq_st_tpu_torch.train import Trainer

    modules = {"Trainer": Trainer, "SpeechRecognitionTask": SpeechRecognitionTask,
               "TranslationTask": TranslationTask, "LanguagePairDataset": LanguagePairDataset,
               "SequenceGenerator": SequenceGenerator, "build_model": build_any_model,
               "SpeechTranslationCTCTask": SpeechTranslationCTCTask, "CTCMultiLoss": CTCMultiLoss,
               "ctc_greedy_decode": ctc_greedy_decode, "levenshtein": levenshtein}
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. device
    card = card_line()
    CARD[0] = card
    print(card, flush=True)
    emit({"phase": "device", "nvidia_smi": card, "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__, "cuda": torch.version.cuda})

    # 2. build
    build_kernels(kernel_build)

    d = Dictionary()
    for i in range(VOCAB - 4):
        d.add_symbol(f"tok{i}")
    d.finalize(padding_factor=8)

    # 3.-5., 12. kernels against their plain versions
    _, serve_worst = check_serving_kernels(fa)
    rows, worst, worst_ratio = check_training_kernels(fa, philox)
    for dtype in (torch.float32, torch.bfloat16):
        worst[("fwd", dtype)] = max(worst[("fwd", dtype)], serve_worst[dtype])
    dconv_rows, dconv_worst = check_dconv_kernels(dconv)
    single_rows, single_worst = check_single_kernel(single)

    # the main paths, each with every count set to 0 just before it
    paths = {}

    def drive(name, fn, *args):
        """Run a path that resets the counts just before its main work and
        returns them just after it (before its cross-checks)."""
        paths[name] = fn(*args)
        torch.cuda.empty_cache()

    # 6.-11. conv_transformer and dynamicconv, serving and training
    drive("serve", serve, card, d, fa, dconv, single, attention, build_model, SequenceGenerator)
    drive("train", train, card, d, fa, dconv, single, modules)
    check_train_steps(d, fa, attention, modules)
    lc_dicts = (lc_dictionary(Dictionary), lc_dictionary(Dictionary))
    drive("serve_lightconv", serve_lightconv, card, lc_dicts, fa, dconv, single, modules)
    drive("train_lightconv", train_lightconv, card, lc_dicts, fa, dconv, single, modules)
    torch.cuda.empty_cache()
    check_lightconv_steps(lc_dicts, modules)
    torch.cuda.empty_cache()
    # 13. the flash sweep
    drive("flash_sweep", flash_sweep, card, sweep, fa, dconv, single)
    if paths["flash_sweep"]["flash_fwd_single"] == 0:
        raise AssertionError("the flash sweep launched no flash_fwd_single kernel")
    # 14.-16. the CTC flagship and the long-context step
    ctc_dicts = ctc_dictionaries(Dictionary, d)
    drive("train_ctc_flagship", train_ctc, card, ctc_dicts, fa, dconv, single, modules)
    check_ctc_steps(ctc_dicts, modules, attention)
    torch.cuda.empty_cache()
    drive("train_longcontext", train_long, card, d, fa, dconv, single, modules)
    check_long_steps(d, modules, attention)

    # 17. kernels line, card line, ok line
    launches = {k: sum(p[k] for p in paths.values()) for k in paths["serve"]}
    emit({"phase": "main_path_launches", **paths, "total": launches})
    for k, n in launches.items():
        if n == 0:
            raise AssertionError(f"the main paths launched no {k} kernel")
    csrc = "fbk_fairseq_st_tpu_torch/ops/kernels/csrc/"
    pallas = "fbk_fairseq_st_tpu/ops/pallas/attention_kernel.py:"
    timed_at = ("encoder_self_attention", "bfloat16")
    long_at = ("long_encoder_self_attention", "bfloat16")
    cuda_core_at = ("encoder_self_attention", "float32")  # in bf16 the pair runs on the tensor cores
    f32, b16 = torch.float32, torch.bfloat16
    kernels = [
        kernel_entry("flash_fwd", "flash_attention_fwd", csrc + "flash_fwd.cu", pallas + "117",
                     launches["flash_fwd"], rows, worst[("fwd", f32)], worst[("fwd", b16)], timed_at),
        kernel_entry("flash_bwd_fused", "flash_attention_bwd_fused", csrc + "flash_bwd.cu", pallas + "277",
                     launches["flash_bwd_fused"], rows, worst[("bwd_fused", f32)], worst[("bwd_fused", b16)],
                     timed_at, long_at),
        kernel_entry("flash_bwd_dq", "flash_attention_bwd_dq", csrc + "flash_bwd.cu", pallas + "218",
                     launches["flash_bwd_dq"], rows, worst[("bwd_cuda_core", f32)], worst[("bwd_cuda_core", b16)],
                     cuda_core_at),
        kernel_entry("flash_bwd_dkv", "flash_attention_bwd_dkv", csrc + "flash_bwd.cu", pallas + "386",
                     launches["flash_bwd_dkv"], rows, worst[("bwd_cuda_core", f32)], worst[("bwd_cuda_core", b16)],
                     cuda_core_at),
        kernel_entry("flash_bwd_dq_tc", "flash_attention_bwd_dq_tc", csrc + "flash_bwd_tc.cu", pallas + "218",
                     launches["flash_bwd_dq_tc"], rows, None, worst[("bwd_tc", b16)], timed_at, long_at),
        kernel_entry("flash_bwd_dkv_tc", "flash_attention_bwd_dkv_tc", csrc + "flash_bwd_tc.cu", pallas + "386",
                     launches["flash_bwd_dkv_tc"], rows, None, worst[("bwd_tc", b16)], timed_at, long_at),
    ]
    for entry, kind in zip(kernels[1:], ("bwd_fused", "bwd_cuda_core", "bwd_cuda_core", "bwd_tc", "bwd_tc")):
        entry["worst_bf16_err_over_max_plain"] = worst_ratio.get(kind)
    dconv_at = ("train_k31_centred", "bfloat16")
    conv_src, conv_tpu = csrc + "dynamic_conv.cu", "fbk_fairseq_st_tpu/ops/pallas/conv_kernels.py:24"
    kernels += [
        kernel_entry("dynamic_conv_fwd", "dynamic_conv_fwd", conv_src, conv_tpu, launches["dconv_fwd"], dconv_rows,
                     dconv_worst[("fwd", f32)], dconv_worst[("fwd", b16)], dconv_at),
        kernel_entry("dynamic_conv_bwd", "dynamic_conv_bwd", conv_src, conv_tpu, launches["dconv_bwd"], dconv_rows,
                     dconv_worst[("bwd", f32)], dconv_worst[("bwd", b16)], dconv_at),
        kernel_entry("flash_fwd_single", "flash_fwd_single", csrc + "flash_fwd_single.cu",
                     "fbk_fairseq_st_tpu/scripts/bench_flash_sweep.py:28", launches["flash_fwd_single"],
                     single_rows, single_worst[f32], single_worst[b16], SINGLE_TIMED_AT),
    ]
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    print(card, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
