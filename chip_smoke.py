#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card, and only the port.

    python3 chip_smoke.py

Phases (each prints one JSON line; any failure raises, exit code != 0):

  1. device: the card's name and power limit (nvidia-smi) — raises without
     CUDA;
  2. build: compiles every kernel of the serving path from the sources in
     this checkout (nvcc, sm_90a) and reports the seconds it took;
  3. kernels: each kernel against its plain PyTorch version at the shapes
     the serving path gives it, in fp32 (TF32 off) and bf16, with kernel,
     plain and library (scaled_dot_product_attention, a yardstick the port
     never calls) times per call (CUDA events), the kernel's own device
     time (torch.profiler), and the card's bound for the same work;
  4. main path: the conv_transformer base preset at full width (256/768/4,
     6+6 layers, 80 mels, vocabulary 8000, random weights from a seed)
     serves three requests with beam 5 through ``SequenceGenerator``;
     checks the hypotheses and the kernel launch counts per request,
     times the encoder and profiles one request (device busy time, top
     kernels), and holds the flash route against the dense route and the
     card against the plain CPU path on a small input;
  5. the ``kernels`` line, the card line, and the final ``ok`` line.

Tolerances (stated here, checked below): kernel vs plain version atol 1e-4
in fp32 and 2e-2 in bf16 (one bf16 rounding of |out| < 4); the model's
encoder output and teacher-forced logits, flash vs dense route and card vs
CPU, atol 1e-3 in fp32 with TF32 off (8 attention layers summed in another
order).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM data sheet (dense): memory 3.35 TB/s; fp32 outside the tensor
# cores 67 TFLOP/s; bf16 tensor cores 989 TFLOP/s.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}

ATOL_KERNEL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
ATOL_MODEL = 1e-3

N_MELS = 80
VOCAB = 8000
BEAM = 5
MAX_LEN_B = 100
FRAME_SECONDS = 0.01  # 10 ms fbank hop
FLASH_LAUNCHES_PER_REQUEST = 8  # 2 ConvAttention2D blocks + 6 encoder layers

# (name, bh, T, S, D, causal, padded keys): the flash calls of the path
KERNEL_SHAPES = [
    ("encoder_self_attention", 128, 128, 128, 64, False, True),
    ("time_attention", 128, 128, 128, 20, False, True),
    ("decoder_causal_self_attention", 32, 100, 100, 64, True, True),
    ("cross_attention", 32, 37, 128, 64, False, True),
    ("long_encoder_self_attention", 32, 750, 750, 64, False, True),
]


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


def device_ms(fn, kernel_name: str, iters: int = 20):
    """Mean device time of the kernels named ``kernel_name`` per call of
    ``fn``, from a torch.profiler (CUPTI) trace; None if the trace holds
    none (the profiler then saw no device activity)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    times = [e.device_time_total for e in _device_events(prof) if kernel_name in e.name]
    return sum(times) / iters / 1e3 if times else None


def profile_request(gen, model, sample):
    """Device busy time and the kernels that take it during one request
    (torch.profiler, device activity only), beside the host wall time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        gen.generate([model], sample)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    by_name = {}
    for e in _device_events(prof):
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total / 1e6
    busy_s = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return wall_s, busy_s, [(name[:80], s) for name, s in top]


def attention_bound_ms(bh, t, s, d, causal, dtype):
    """Least time for the function on this card: each input read once and
    each output written once over the memory rate, against the products
    this causal pattern needs over the peak rate of the type."""
    item = torch.tensor([], dtype=dtype).element_size()
    nbytes = item * bh * d * (2 * t + 2 * s) + 4 * bh * s + 4 * bh * t
    pairs = sum(min(r + 1, s) for r in range(t)) if causal else t * s
    flops = 4.0 * bh * pairs * d
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = flops / PEAK_FLOPS[dtype] * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations")


def check_kernels(fa):
    from torch.nn.functional import scaled_dot_product_attention

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows, worst = [], {torch.float32: 0.0, torch.bfloat16: 0.0}
    for name, bh, t, s, d, causal, padded in KERNEL_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            q = torch.randn((bh, t, d), generator=gen, device="cuda").to(dtype)
            k = torch.randn((bh, s, d), generator=gen, device="cuda").to(dtype)
            v = torch.randn((bh, s, d), generator=gen, device="cuda").to(dtype)
            bias = torch.zeros((bh, s), device="cuda")
            if padded:  # ragged key lengths, as the batches give them
                lengths = torch.randint(s // 2, s + 1, (bh,), generator=gen, device="cuda")
                lengths[0] = s
                bias = torch.where(torch.arange(s, device="cuda")[None, :] >= lengths[:, None], -1e9, 0.0)
            scale = d ** -0.5

            out_k, lse_k = fa.flash_attention(q, k, v, bias, scale, causal=causal, return_lse=True)
            out_p, lse_p = fa.flash_attention_reference(q, k, v, bias, scale, causal)
            torch.cuda.synchronize()
            err = (out_k.float() - out_p.float()).abs().max().item()
            lse_err = (lse_k - lse_p).abs().max().item()
            if not (err <= ATOL_KERNEL[dtype] and lse_err <= 1e-4):
                raise AssertionError(
                    f"flash_fwd disagrees with its plain version at {name} {dtype}: "
                    f"max|out| err {err}, max|lse| err {lse_err}"
                )
            worst[dtype] = max(worst[dtype], err)

            mask = bias[:, None, :]
            if causal:
                future = torch.ones((t, s), dtype=torch.bool, device="cuda").triu(1)
                mask = mask.masked_fill(future[None], -1e9)
            mask = mask.to(dtype)
            kernel_ms = time_ms(lambda: fa.flash_attention(q, k, v, bias, scale, causal=causal))
            kernel_device_ms = device_ms(
                lambda: fa.flash_attention(q, k, v, bias, scale, causal=causal), "flash_fwd_kernel"
            )
            plain_ms = time_ms(lambda: fa.flash_attention_reference(q, k, v, bias, scale, causal))
            library_ms = time_ms(lambda: scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=scale))
            bound_ms, bound_by = attention_bound_ms(bh, t, s, d, causal, dtype)
            row = {
                "phase": "kernel_check", "kernel": "flash_attention_fwd", "shape": name,
                "bh": bh, "T": t, "S": s, "D": d, "causal": causal,
                "dtype": str(dtype).replace("torch.", ""),
                "max_abs_err": err, "lse_max_abs_err": lse_err, "atol": ATOL_KERNEL[dtype],
                "kernel_ms": kernel_ms, "kernel_device_ms": kernel_device_ms,
                "plain_ms": plain_ms, "library_ms": library_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
            }
            emit(row)
            rows.append(row)
    return rows, worst


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

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. device
    card = card_line()
    print(card, flush=True)
    emit({"phase": "device", "nvidia_smi": card, "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__, "cuda": torch.version.cuda})

    # 2. build
    t0 = time.perf_counter()
    lib_path = kernel_build.build("flash_fwd")
    build_s = time.perf_counter() - t0
    ptxas = [line.strip() for line in lib_path.with_suffix(".log").read_text().splitlines()
             if "registers" in line or "spill" in line]
    emit({"phase": "build", "kernel": "flash_fwd", "seconds": build_s, "ptxas": ptxas})

    # 3. kernel against its plain version
    rows, worst = check_kernels(fa)

    # 4. main path at full width
    d = Dictionary()
    for i in range(VOCAB - 4):
        d.add_symbol(f"tok{i}")
    d.finalize(padding_factor=8)
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
    main_launches = fa.launches

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
    wall_s, busy_s, top = profile_request(gen, model, sample)
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

    # 5. kernels line, card line, ok line
    head = next(r for r in rows if r["shape"] == "encoder_self_attention" and r["dtype"] == "float32")
    kernels = [{
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "fbk_fairseq_st_tpu_torch/ops/kernels/csrc/flash_fwd.cu",
        "replaces": "fbk_fairseq_st_tpu/ops/pallas/attention_kernel.py:117",
        "launches": main_launches,
        "max_abs_err": worst[torch.float32],
        "max_abs_err_bf16": worst[torch.bfloat16],
        "ms": head["kernel_ms"],
        "kernel_ms": head["kernel_ms"],
        "device_ms": head["kernel_device_ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
        "timed_at": "bh128 T128 S128 D64 float32 (encoder self-attention)",
    }]
    if main_launches == 0:
        raise AssertionError("the main path launched no flash kernel")
    print(card, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
