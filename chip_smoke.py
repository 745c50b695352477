#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card, and only the port.

    python3 chip_smoke.py

Phases (each prints JSON lines; any failure raises, exit code != 0):

  1. device: the card's name and power limit (nvidia-smi) — raises without
     CUDA;
  2. build: compiles every kernel from the sources in this checkout (one
     nvcc per source, all started together, sm_90a) and reports the
     seconds and the ptxas registers and spills of each;
  3. kernels at the serving shapes: the flash forward against its plain
     PyTorch version in fp32 (TF32 off) and bf16, with kernel, plain and
     library (scaled_dot_product_attention, a yardstick the port never
     calls) times per call (CUDA events), the kernel's own device time
     (torch.profiler), and the card's bound for the same work;
  4. kernels at the training shapes (the train step's four attention
     calls at batch 128): the forward's dropout keep mask against
     ``philox.keep_mask`` (exactly), the forward at the training dropout
     rate, and the fused and split backwards, against the plain versions
     on the same inputs and seed, with the same times and bounds (the
     library time of a backward is SDPA's forward + backward at rate 0);
  5. serve (main path 1): the conv_transformer base preset at full width
     (256/768/4, 6+6 layers, 80 mels, vocabulary 8000, random weights from
     a seed) serves three requests with beam 5 through
     ``SequenceGenerator``; checks the hypotheses and the forward launches
     per request, times the encoder, profiles one request, and holds the
     flash route against the dense route and the card against the plain
     CPU path;
  6. train (main path 2): the ``bench.py::_measure_train`` configuration
     (label-smoothed CE 0.1, Adam (0.9, 0.98), lr 2e-3 inverse_sqrt over
     4000 warmup updates, clip-norm 10, --bf16) at full width on a fixed
     batch of 128 utterances of 409-512 frames and 48 target tokens:
     3 warm-up steps, then 20 timed steps 3 times; step ms, frames/s and
     MFU; exactly 20 flash forward and 20 fused backward launches a step
     (20 dq + 20 dkv with ``FUSED_BWD = False``, a shorter run); the loss
     finite and falling; one profiled step;
  7. train-step cross-checks in fp32 (TF32 off): flash against dense
     route and fused against split backward (training mode, every dropout
     rate 0 but the frontend's forced 0.1, drawn alike on both sides), and
     card against the plain CPU path on 2 utterances (eval-mode criterion),
     and the card's dense route against the CPU as the floor of the two;
  8. the ``kernels`` line, the card line, and the final ``ok`` line.

Tolerances (stated here, checked below):
  * kernels against their plain versions: atol 1e-4 in fp32 (the same
    sums in another order); in bf16 2e-2 for out (one bf16 rounding of
    |out| < 4) and 5e-2 for dq/dk/dv (one bf16 rounding of gradients up to
    |g| ~ 10, the dropout's 1/(1 - rate) included); lse 1e-4 (fp32 in both
    types); the keep mask exactly;
  * the serving model, flash vs dense and card vs CPU: atol 1e-3 in fp32
    (8 attention layers summed in another order);
  * train-step cross-checks: the loss rtol 1e-5 (the same forward in fp32);
    gnorm and the gradients' global relative difference 5e-3 where the two
    sides compute the forward differently (flash vs dense, card vs CPU) and
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
multiply-add) at the shapes the step computes (``train_flops``), against
the H100's 989 TFLOP/s of dense bf16.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM data sheet (dense): memory 3.35 TB/s; fp32 outside the tensor
# cores 67 TFLOP/s; bf16 tensor cores 989 TFLOP/s.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
PEAK_BF16 = 989e12

ATOL_KERNEL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
ATOL_GRAD = {torch.float32: 1e-4, torch.bfloat16: 5e-2}
ATOL_LSE = 1e-4
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
SPLIT_STEPS = 5
# 2 time attention + 6 encoder + 6 decoder causal self + 6 cross
FLASH_LAUNCHES_PER_STEP = 20

# (name, bh, T, S, D, causal, padded keys): the flash calls of the serving path
KERNEL_SHAPES = [
    ("encoder_self_attention", 128, 128, 128, 64, False, True),
    ("time_attention", 128, 128, 128, 20, False, True),
    ("decoder_causal_self_attention", 32, 100, 100, 64, True, True),
    ("cross_attention", 32, 37, 128, 64, False, True),
    ("long_encoder_self_attention", 32, 750, 750, 64, False, True),
]

# (name, bh, T, S, D, causal, dropout rate): the flash calls of the train
# step at batch 128 (4 heads, T' = 512 / 4 frames, 48 target tokens); all
# have padded keys
TRAIN_KERNEL_SHAPES = [
    ("encoder_self_attention", 512, 128, 128, 64, False, 0.1),
    ("time_attention", 512, 128, 128, 20, False, 0.3),
    ("decoder_causal_self_attention", 512, 48, 48, 64, True, 0.1),
    ("cross_attention", 512, 48, 128, 64, False, 0.1),
]

KERNEL_SOURCES = ("flash_fwd", "flash_bwd")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_events(prof):
    """The trace's device-side events (kernels, copies), not the host-side
    runtime calls that also report their kernels' durations."""
    from torch.autograd import DeviceType

    return [e for e in prof.events() if e.device_type == DeviceType.CUDA]


def device_ms(fn, match, iters: int = 20):
    """Mean device time per call of ``fn`` of the kernels whose name
    ``match`` accepts (a substring or a predicate), from a torch.profiler
    (CUPTI) trace; None if the trace holds none."""
    from torch.profiler import ProfilerActivity, profile

    accept = match if callable(match) else (lambda name: match in name)
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    times = [e.device_time_total for e in _device_events(prof) if accept(e.name)]
    return sum(times) / iters / 1e3 if times else None


def profile_window(fn):
    """Device busy time and the kernels that take it while ``fn`` runs
    (torch.profiler, device activity only), beside the host wall time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    by_name = {}
    for e in _device_events(prof):
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total / 1e6
    busy_s = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return wall_s, busy_s, [(name[:80], s) for name, s in top]


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


def random_attention_inputs(gen, bh, t, s, d, dtype, padded=True):
    q = torch.randn((bh, t, d), generator=gen, device="cuda").to(dtype)
    k = torch.randn((bh, s, d), generator=gen, device="cuda").to(dtype)
    v = torch.randn((bh, s, d), generator=gen, device="cuda").to(dtype)
    bias = torch.zeros((bh, s), device="cuda")
    if padded:  # ragged key lengths, as the batches give them
        lengths = torch.randint(s // 2, s + 1, (bh,), generator=gen, device="cuda")
        lengths[0] = s
        bias = torch.where(torch.arange(s, device="cuda")[None, :] >= lengths[:, None], -1e9, 0.0)
    return q, k, v, bias


def sdpa_mask(bias, t, s, causal, dtype):
    mask = bias[:, None, :]
    if causal:
        future = torch.ones((t, s), dtype=torch.bool, device="cuda").triu(1)
        mask = mask.masked_fill(future[None], -1e9)
    return mask.to(dtype)


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
    from torch.nn.functional import scaled_dot_product_attention

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
            mask = sdpa_mask(bias, t, s, causal, dtype)
            fwd = lambda: fa.flash_attention(q, k, v, bias, scale, causal=causal)  # noqa: E731
            row = {
                "phase": "kernel_check", "kernel": "flash_attention_fwd", "shape": name,
                "bh": bh, "T": t, "S": s, "D": d, "causal": causal, "rate": 0.0,
                "dtype": str(dtype).replace("torch.", ""),
                "max_abs_err": err, "lse_max_abs_err": lse_err, "atol": ATOL_KERNEL[dtype],
                "kernel_ms": time_ms(fwd), "kernel_device_ms": device_ms(fwd, "flash_fwd_kernel"),
                "plain_ms": time_ms(lambda: fa.flash_attention_reference(q, k, v, bias, scale, causal)),
                "library_ms": time_ms(lambda: scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=scale)),
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
    V the identity out[i, j] = keep(i, j) / (l_i (1 - rate)). Returns
    (mask, the entries it is defined on)."""
    d = fa.kernel_head_dim(s)
    q = torch.zeros((bh, t, d), device=device)
    k = torch.zeros((bh, s, d), device=device)
    v = torch.eye(s, d, device=device).expand(bh, s, d)
    out = fa.flash_attention(q, k, v, torch.zeros((bh, s), device=device), 1.0, causal=causal,
                             dropout_rate=rate, dropout_seed=seed)[..., :s]
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


def check_training_kernels(fa, philox):
    """Each training-shape call in fp32 and bf16: mask, forward, both
    backwards against the plain versions; times and bounds."""
    from torch.nn.functional import scaled_dot_product_attention

    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    worst = {(kind, dtype): 0.0 for kind in ("fwd", "bwd_fused", "bwd_split")
             for dtype in (torch.float32, torch.bfloat16)}
    for name, bh, t, s, d, causal, rate in TRAIN_KERNEL_SHAPES:
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

        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, bias = random_attention_inputs(gen, bh, t, s, d, dtype)
            g = torch.randn((bh, t, d), generator=gen, device="cuda").to(dtype)
            scale = d ** -0.5
            drop = dict(dropout_rate=rate, dropout_seed=seed)
            out_k, lse_k = fa.flash_attention(q, k, v, bias, scale, causal=causal, return_lse=True, **drop)
            out_p, lse_p = fa.flash_attention_reference(q, k, v, bias, scale, causal, rate, seed)
            # both backwards against the plain one, on the kernel's out and lse
            dk = fa.kernel_head_dim(d)
            qp, kp, vp, op, gp = (_pad_d(x, dk) for x in (q, k, v, out_k, g))
            bwd_args = (qp, kp, vp, bias, op, lse_k, gp, scale, causal, rate, seed)
            want_grads = fa.flash_attention_backward_reference(q, k, v, bias, out_k, lse_k, g, scale,
                                                               causal, rate, seed)

            def bwd(fused):
                def run():
                    fa.FUSED_BWD = fused
                    try:
                        return fa.flash_attention_backward(*bwd_args)
                    finally:
                        fa.FUSED_BWD = True
                return run

            grads = {kind: [x[..., :d] for x in bwd(fused)()]
                     for kind, fused in (("bwd_fused", True), ("bwd_split", False))}
            torch.cuda.synchronize()
            errs = {"fwd": (out_k.float() - out_p.float()).abs().max().item()}
            lse_err = (lse_k - lse_p).abs().max().item()
            for kind, gr in grads.items():
                errs[kind] = max((a.float() - b.float()).abs().max().item() for a, b in zip(gr, want_grads))
            ok = (errs["fwd"] <= ATOL_KERNEL[dtype] and lse_err <= ATOL_LSE
                  and max(errs["bwd_fused"], errs["bwd_split"]) <= ATOL_GRAD[dtype])
            for kind, err in errs.items():
                worst[(kind, dtype)] = max(worst[(kind, dtype)], err)

            mask = sdpa_mask(bias, t, s, causal, dtype)
            qr, kr, vr = (x.detach().clone().requires_grad_() for x in (q, k, v))

            def sdpa_fwd_bwd():
                scaled_dot_product_attention(qr, kr, vr, attn_mask=mask, scale=scale).backward(g)

            fwd = lambda: fa.flash_attention(q, k, v, bias, scale, causal=causal, **drop)  # noqa: E731
            base = {"phase": "train_kernel_check", "shape": name, "bh": bh, "T": t, "S": s, "D": d,
                    "causal": causal, "rate": rate, "dtype": str(dtype).replace("torch.", "")}
            timings = {
                "flash_attention_fwd": dict(
                    kernel_ms=time_ms(fwd), kernel_device_ms=device_ms(fwd, "flash_fwd_kernel"),
                    plain_ms=time_ms(lambda: fa.flash_attention_reference(q, k, v, bias, scale, causal, rate, seed)),
                    library_ms=time_ms(lambda: scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=scale)),
                    max_abs_err=errs["fwd"], lse_max_abs_err=lse_err, atol=ATOL_KERNEL[dtype],
                    bound=attention_bound_ms(bh, t, s, d, causal, dtype)),
                "flash_attention_bwd_fused": dict(
                    kernel_ms=time_ms(bwd(True)),
                    kernel_device_ms=device_ms(bwd(True), lambda n: "flash_bwd_kv_kernel" in n and "true>" in n),
                    max_abs_err=errs["bwd_fused"], atol=ATOL_GRAD[dtype],
                    bound=backward_bound_ms("fused", bh, t, s, d, causal, dtype)),
                "flash_attention_bwd_dq": dict(
                    kernel_device_ms=device_ms(bwd(False), "flash_bwd_q_kernel"),
                    max_abs_err=errs["bwd_split"], atol=ATOL_GRAD[dtype],
                    bound=backward_bound_ms("dq", bh, t, s, d, causal, dtype)),
                "flash_attention_bwd_dkv": dict(
                    kernel_device_ms=device_ms(bwd(False), lambda n: "flash_bwd_kv_kernel" in n and "false>" in n),
                    max_abs_err=errs["bwd_split"], atol=ATOL_GRAD[dtype],
                    bound=backward_bound_ms("dkv", bh, t, s, d, causal, dtype)),
            }
            split_ms = time_ms(bwd(False))
            plain_bwd_ms = time_ms(lambda: fa.flash_attention_backward_reference(
                q, k, v, bias, out_k, lse_k, g, scale, causal, rate, seed))
            library_bwd_ms = time_ms(sdpa_fwd_bwd)
            for kernel in ("flash_attention_bwd_fused", "flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
                timings[kernel].update(plain_ms=plain_bwd_ms, library_ms=library_bwd_ms,
                                       library="sdpa forward+backward, rate 0")
            # the split pair's wrapper call launches both kernels
            timings["flash_attention_bwd_dq"]["kernel_ms"] = split_ms
            timings["flash_attention_bwd_dkv"]["kernel_ms"] = split_ms
            for kernel, tm in timings.items():
                tm["bound_ms"], tm["bound_by"] = tm.pop("bound")
                row = {**base, "kernel": kernel, **tm}
                emit(row)
                rows.append(row)
            if not ok:
                raise AssertionError(f"training-shape check failed at {name} {dtype}: {errs}, lse {lse_err}")
    return rows, worst


# ---------------------------------------------------------------------------
# 5. serve
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


def serve(card, d, fa, attention, build_model, SequenceGenerator):
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

    fa.reset_launches()
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
    launches = {"fwd": fa.launches_fwd, "bwd_fused": fa.launches_bwd_fused,
                "bwd_dq": fa.launches_bwd_dq, "bwd_dkv": fa.launches_bwd_dkv}

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
    wall_s, busy_s, top = profile_window(lambda: gen.generate([model], sample))
    emit({"phase": "profile", "request": name, "encode_s": encode_s,
          "decode_s_profiled": wall_s, "device_busy_s": busy_s,
          "device_idle_share_profiled": 1.0 - busy_s / wall_s,
          "top_kernels_s": top, "card": card})

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
# 6. train
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


def train(card, d, fa, modules):
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

    fa.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    step_ms = []
    for _ in range(REPEATS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(TIMED_STEPS):
            outs.append(trainer.train_step([sample]))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) / TIMED_STEPS * 1e3)
    launches = {"fwd": fa.launches_fwd, "bwd_fused": fa.launches_bwd_fused,
                "bwd_dq": fa.launches_bwd_dq, "bwd_dkv": fa.launches_bwd_dkv}
    steps = REPEATS * TIMED_STEPS
    want = {"fwd": FLASH_LAUNCHES_PER_STEP * steps, "bwd_fused": FLASH_LAUNCHES_PER_STEP * steps,
            "bwd_dq": 0, "bwd_dkv": 0}
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
          "tgt_len": TGT_LEN, "dtype": "bfloat16", "backward": "fused",
          "step_ms_median": median, "step_ms_repeats": step_ms, "step_ms_spread": max(step_ms) - min(step_ms),
          "frames_per_s": frames_per_batch / (median / 1e3), "flops_per_step": flops,
          "mfu": flops / (median / 1e3) / PEAK_BF16, "flash_launches_per_step":
          {k: v / steps for k, v in launches.items()}, "peak_memory_gb": peak_gb,
          "loss_per_token_first": per_token[0], "loss_per_token_steps_1_5": first,
          "loss_per_token_last5": last, "gnorm_last": gnorms[-1], "lr_last": float(outs[-1]["lr"]),
          "card": card})

    wall_s, busy_s, top = profile_window(lambda: trainer.train_step([sample]))
    emit({"phase": "train_profile", "step_s": wall_s, "device_busy_s": busy_s,
          "device_idle_share": 1.0 - busy_s / wall_s, "top_kernels_s": top, "card": card})

    # the split backward: the same path with FUSED_BWD = False
    fa.FUSED_BWD = False
    trainer.train_step([sample])
    torch.cuda.synchronize()
    fa.reset_launches()
    t0 = time.perf_counter()
    for _ in range(SPLIT_STEPS):
        trainer.train_step([sample])
    torch.cuda.synchronize()
    split_ms = (time.perf_counter() - t0) / SPLIT_STEPS * 1e3
    fa.FUSED_BWD = True
    split = {"fwd": fa.launches_fwd, "bwd_fused": fa.launches_bwd_fused,
             "bwd_dq": fa.launches_bwd_dq, "bwd_dkv": fa.launches_bwd_dkv}
    want = {"fwd": FLASH_LAUNCHES_PER_STEP * SPLIT_STEPS, "bwd_fused": 0,
            "bwd_dq": FLASH_LAUNCHES_PER_STEP * SPLIT_STEPS, "bwd_dkv": FLASH_LAUNCHES_PER_STEP * SPLIT_STEPS}
    if split != want:
        raise AssertionError(f"split-backward launches {split}, expected {want}")
    emit({"phase": "train", "backward": "split", "steps": SPLIT_STEPS, "step_ms": split_ms,
          "flash_launches_per_step": {k: v / SPLIT_STEPS for k, v in split.items()}, "card": card})
    return {k: launches[k] + split[k] for k in launches}


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
    moved_apart = 0
    for name, p in model_b.named_parameters():
        q = pa[name]
        ga, gb = q.grad.detach().double().cpu(), p.grad.detach().double().cpu()
        num += float((ga - gb).square().sum())
        den += float(ga.square().sum())
        dp = (q.detach().cpu() - p.detach().cpu()).abs()
        max_dp = max(max_dp, float(dp.max()))
        moved_apart += int((dp > lr).sum())
    grad_rel = (num / max(den, 1e-30)) ** 0.5
    rtol = RTOL_STEP_GRAD[forward]
    row = {"phase": "train_step_check", "check": label, "loss": [loss_a, loss_b], "gnorm": [gn_a, gn_b],
           "loss_rel_err": abs(loss_a - loss_b) / abs(loss_b), "gnorm_rel_err": abs(gn_a - gn_b) / abs(gn_b),
           "grad_global_rel_diff": grad_rel, "max_param_abs_diff": max_dp,
           "param_elements_apart_by_more_than_lr": moved_apart,
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

    fa.FUSED_BWD = False
    split = one_step(d, modules, "cuda", sample)
    fa.FUSED_BWD = True
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

def kernel_entry(name, source, replaces, launches, rows, worst_fp32, worst_bf16, timed_at):
    head = next(r for r in rows if r["kernel"] == name and r["shape"] == timed_at[0]
                and r["dtype"] == timed_at[1])
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches, "max_abs_err": worst_fp32, "max_abs_err_bf16": worst_bf16,
        "ms": head["kernel_ms"], "device_ms": head["kernel_device_ms"],
        "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
        "timed_at": f"{timed_at[0]} bh{head['bh']} T{head['T']} S{head['S']} D{head['D']} "
                    f"rate {head['rate']} {timed_at[1]}",
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from fbk_fairseq_st_tpu_torch.data import Dictionary
    from fbk_fairseq_st_tpu_torch.generation import SequenceGenerator
    from fbk_fairseq_st_tpu_torch.models.conv_transformer import build_model
    from fbk_fairseq_st_tpu_torch.ops import attention
    from fbk_fairseq_st_tpu_torch.ops.kernels import build as kernel_build
    from fbk_fairseq_st_tpu_torch.ops.kernels import flash_attention as fa
    from fbk_fairseq_st_tpu_torch.ops.kernels import philox
    from fbk_fairseq_st_tpu_torch.tasks import SpeechRecognitionTask
    from fbk_fairseq_st_tpu_torch.train import Trainer

    modules = {"Trainer": Trainer, "SpeechRecognitionTask": SpeechRecognitionTask}
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. device
    card = card_line()
    print(card, flush=True)
    emit({"phase": "device", "nvidia_smi": card, "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__, "cuda": torch.version.cuda})

    # 2. build
    build_kernels(kernel_build)

    d = Dictionary()
    for i in range(VOCAB - 4):
        d.add_symbol(f"tok{i}")
    d.finalize(padding_factor=8)

    # 3. and 4. kernels against their plain versions
    _, serve_worst = check_serving_kernels(fa)
    rows, worst = check_training_kernels(fa, philox)
    for dtype in (torch.float32, torch.bfloat16):
        worst[("fwd", dtype)] = max(worst[("fwd", dtype)], serve_worst[dtype])
    # 5.-7. the two main paths and the train-step cross-checks
    serve_launches = serve(card, d, fa, attention, build_model, SequenceGenerator)
    train_launches = train(card, d, fa, modules)
    check_train_steps(d, fa, attention, modules)

    # 8. kernels line, card line, ok line
    launches = {k: serve_launches[k] + train_launches[k] for k in serve_launches}
    emit({"phase": "main_path_launches", "serve": serve_launches, "train": train_launches})
    for k, n in launches.items():
        if n == 0:
            raise AssertionError(f"the main path launched no {k} kernel")
    csrc = "fbk_fairseq_st_tpu_torch/ops/kernels/csrc/"
    pallas = "fbk_fairseq_st_tpu/ops/pallas/attention_kernel.py:"
    timed_at = ("encoder_self_attention", "bfloat16")
    f32, b16 = torch.float32, torch.bfloat16
    kernels = [
        kernel_entry("flash_attention_fwd", csrc + "flash_fwd.cu", pallas + "117", launches["fwd"],
                     rows, worst[("fwd", f32)], worst[("fwd", b16)], timed_at),
        kernel_entry("flash_attention_bwd_fused", csrc + "flash_bwd.cu", pallas + "277", launches["bwd_fused"],
                     rows, worst[("bwd_fused", f32)], worst[("bwd_fused", b16)], timed_at),
        kernel_entry("flash_attention_bwd_dq", csrc + "flash_bwd.cu", pallas + "218", launches["bwd_dq"],
                     rows, worst[("bwd_split", f32)], worst[("bwd_split", b16)], timed_at),
        kernel_entry("flash_attention_bwd_dkv", csrc + "flash_bwd.cu", pallas + "386", launches["bwd_dkv"],
                     rows, worst[("bwd_split", f32)], worst[("bwd_split", b16)], timed_at),
    ]
    print(card, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
