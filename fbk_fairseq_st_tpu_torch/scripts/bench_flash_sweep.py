"""Flash-kernel sweep on the CUDA card, at the long-context train shapes.

Counterpart of ``fbk_fairseq_st_tpu/scripts/bench_flash_sweep.py``
(:150-183). It measures, on the card, what the port's flash dispatch is
chosen from:

  * the single-pass forward (``ops/kernels/flash_fwd_single.py``) at each
    ``t_block`` the kernel takes (8 and 16: a larger tile's scores over
    S = 2048 do not fit a block's shared memory), each first checked
    against the port's flash forward (max |out difference| < 2e-2,
    asserted, as the JAX sweep's ``measure_fwd_single`` does);
  * the flash forward and the fused and the split backward;
  * ``scaled_dot_product_attention`` with the same mask, forward and
    forward + backward, as a yardstick (the port never calls it);
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
``time_ms``, ``device_busy`` and ``sdpa_mask`` too.

Run on a machine with the card:

    python -m fbk_fairseq_st_tpu_torch.scripts.bench_flash_sweep

It prints the card's ``nvidia-smi`` name and power limit, a table, and one
JSON line per measurement.
"""

from __future__ import annotations

import json
import subprocess
from typing import Callable, Dict, List, Tuple

import torch

from ..ops import attention
from ..ops.conv_frontend import ConvAttention2D
from ..ops.core import make_generators
from ..ops.kernels import flash_attention as fa
from ..ops.kernels import flash_fwd_single as single

D = 64
KERNEL_SHAPES = ((32, 2048, False), (64, 2048, True))  # (bh, S, causal)
ROUTE_KEY_LENGTHS = (128, 512, 2048)
ROUTE_ROWS = 16384  # batch x key length of the train steps' encoder
SINGLE_ATOL = 2e-2


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


def sdpa_mask(bias, t: int, s: int, causal: bool, dtype):
    """The (BH, T, S) additive mask of ``scaled_dot_product_attention``
    for a (BH, S) key bias, causal above the diagonal."""
    mask = bias[:, None, :]
    if causal:
        future = torch.ones((t, s), dtype=torch.bool, device=bias.device).triu(1)
        mask = mask.masked_fill(future[None], -1e9)
    return mask.to(dtype)


def measure_single(bh: int, s: int, causal: bool, t_block: int) -> Dict:
    """The single-pass forward at ``t_block``: checked against the port's
    flash forward first, then timed."""
    row = {"kind": "single_pass_fwd", "bh": bh, "S": s, "D": D, "causal": causal, "t_block": t_block,
           "smem_bytes": single.smem_bytes(t_block, s)}
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
    from torch.nn.functional import scaled_dot_product_attention

    q, k, v, bias = inputs(bh, s)
    scale = D ** -0.5
    out, lse = fa.flash_attention(q, k, v, bias, scale, causal=causal, return_lse=True)
    g = torch.randn(out.shape, generator=torch.Generator(device="cuda").manual_seed(1), device="cuda").to(out.dtype)

    def bwd(fused: bool):
        def run():
            fa.FUSED_BWD = fused
            try:
                return fa.flash_attention_backward(q, k, v, bias, out, lse, g, scale, causal)
            finally:
                fa.FUSED_BWD = True
        return run

    mask = sdpa_mask(bias, s, s, causal, q.dtype)
    qr, kr, vr = (x.detach().clone().requires_grad_() for x in (q, k, v))

    def sdpa_fwd_bwd():
        scaled_dot_product_attention(qr, kr, vr, attn_mask=mask, scale=scale).backward(g)

    base = {"bh": bh, "S": s, "D": D, "causal": causal}
    fwd_ms = time_ms(lambda: fa.flash_attention(q, k, v, bias, scale, causal=causal))
    fused_ms, split_ms = time_ms(bwd(True)), time_ms(bwd(False))
    sdpa_fwd_ms = time_ms(lambda: scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=scale))
    sdpa_ms = time_ms(sdpa_fwd_bwd)
    return [
        {**base, "kind": "flash_fwd", "fwd_ms": fwd_ms},
        {**base, "kind": "flash_bwd_fused", "bwd_ms": fused_ms, "fwd_bwd_ms": fwd_ms + fused_ms},
        {**base, "kind": "flash_bwd_split", "bwd_ms": split_ms, "fwd_bwd_ms": fwd_ms + split_ms},
        {**base, "kind": "sdpa", "fwd_ms": sdpa_fwd_ms, "fwd_bwd_ms": sdpa_ms,
         "note": "yardstick with the same mask; the port never calls it"},
    ]


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
        rows += [measure_single(bh, s, causal, tb) for tb in single.T_BLOCKS]
        rows += measure_flash(bh, s, causal)
    for kind in ("mha", "time_attention"):
        rows += [measure_routes(kind, s) for s in ROUTE_KEY_LENGTHS]
    return rows


def gate_from(rows: List[Dict]) -> Dict:
    """Per caller, the largest measured key length up to which the dense
    route's device time beats the flash route's by more than 10 % at every
    measured length (None when it does not at the shortest), and the
    faster backward at S = 2048."""
    gates = {}
    for kind in sorted({r["kind"] for r in rows if r["kind"].startswith("route_")}):
        ratios = sorted((r["S"], r["dense_over_flash"]) for r in rows if r["kind"] == kind)
        below = None
        for s, ratio in ratios:
            if ratio >= 1 / 1.1:
                break
            below = s
        gates[kind[len("route_"):]] = below
    bwd = {r["kind"]: r["bwd_ms"] for r in rows if r["kind"].startswith("flash_bwd") and r["S"] == 2048
           and not r["causal"]}
    return {"dense_faster_by_10pct_up_to_key_len": gates,
            "fused_bwd_faster_at_2048": bwd.get("flash_bwd_fused", 0.0) <= bwd.get("flash_bwd_split", 0.0),
            "bwd_ms_at_2048_non_causal": bwd}


def print_table(rows: List[Dict]) -> None:
    for r in rows:
        shape = (f"bh={r['bh']} S={r['S']} causal={int(r['causal'])}" if "bh" in r
                 else f"B={r['batch']} S={r['S']}")
        if r["kind"] == "single_pass_fwd":
            print(f"{shape:<26} single-pass fwd t_block={r['t_block']:>3}: {r['fwd_ms']:8.3f} ms "
                  f"(max|d| vs flash {r['max_abs_err_vs_flash']:.2e})")
        elif r["kind"].startswith("route_"):
            print(f"{shape:<26} {r['kind']:<22} fwd+bwd device ms: dense {r['dense_device_ms']:8.3f}  "
                  f"flash {r['flash_device_ms']:8.3f}; wall ms: dense {r['dense_wall_ms']:8.3f}  "
                  f"flash {r['flash_wall_ms']:8.3f}; kernels: dense {r['dense_kernels_per_call']:.0f}  "
                  f"flash {r['flash_kernels_per_call']:.0f}")
        else:
            times = "  ".join(f"{k} {r[k]:8.3f}" for k in ("fwd_ms", "bwd_ms", "fwd_bwd_ms") if k in r)
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
