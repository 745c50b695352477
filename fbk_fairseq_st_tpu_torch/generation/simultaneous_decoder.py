"""The greedy simultaneous decoding agent of the monotonic-attention models.

Counterpart of ``fbk_fairseq_st_tpu/generation/simultaneous_decoder.py``
(the reference's read/write policy, transformer_monotonic_attention.py
decision_from_states / predict_from_states :92-135, and utils/latency.py
LatencyInference :244-280), run as a host loop over one sentence:

  * READ while the monotonic attention's p_choose at the source pointer is
    below 0.5 (the model wants more source), until the source is read;
  * WRITE the argmax token otherwise; stop at eos or ``max_len``.

Each READ or WRITE runs a forward over the source read so far and the
tokens written; a step after a WRITE reuses the encoder states of the
prefix, which the WRITE left as they were (the same states a full forward
computes, as JAX's agent does at every step). The pointer is the fastest
layer's: each layer's p_choose (heads averaged) at its last target row, at
index ``min(len(pc) - 1, len(tokens) - 1, n_read - 1)``, the largest of
them decides (JAX :94-104).
Wait-k starts with k source tokens read and reads one more after each
write. The delays (source tokens read when each token was written) and
AP / AL / DAL (``ops/latency.py``, start_from_zero False) come back with
the tokens.

One forward brings its decision to the host in one copy: the layers'
p_choose rows and the last position's argmax. The output projection runs
on the last position only, the one whose argmax is read.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from ..ops.latency import average_lagging, average_proportion, differentiable_average_lagging


def latency_metrics(delays, src_len: int) -> Dict[str, float]:
    """delays: (T,) 1-based read counts a written token (those past the
    source count as ``src_len``) -> AP, AL and DAL."""
    d = torch.from_numpy(np.minimum(np.asarray(delays, np.float32), src_len)[None, :])
    src = torch.tensor([[float(src_len)]])
    return {
        "average_proportion": float(average_proportion(d, src, start_from_zero=False)[0, 0]),
        "average_lagging": float(average_lagging(d, src, start_from_zero=False)[0, 0]),
        "differentiable_average_lagging": float(differentiable_average_lagging(d, src, start_from_zero=False)[0, 0]),
    }


@torch.no_grad()
def forward_decision(model, src: torch.Tensor, tokens: List[int], encoder_out=None):
    """One forward on the prefix read and the tokens written (on
    ``encoder_out``, the prefix's encoder states, when given): (each layer's
    head-averaged p_choose row at the last target position (L, S_read),
    the last position's argmax) on the host, and the encoder states."""
    device = src.device
    if encoder_out is None:
        encoder_out = model.encode(src[None, :], torch.tensor([src.shape[0]], device=device))
    dec = model.decoder
    x, extra = dec(torch.tensor([tokens], dtype=torch.int64, device=device), encoder_out.encoder_out,
                   encoder_out.encoder_padding_mask, features_only=True)
    next_tok = dec.output_layer(x[:, -1:])[0, -1].argmax()
    rows = torch.stack([item["p_choose"][0].mean(dim=0)[-1] for item in extra["attn_list"]])
    flat = torch.cat([rows.reshape(-1).float(), next_tok.float()[None]]).cpu().numpy()
    return flat[:-1].reshape(rows.shape), int(flat[-1]), encoder_out


def greedy_simul_decode(model, src_tokens, eos: int, max_len: int = 200, read_threshold: float = 0.5,
                        device=None) -> Dict[str, object]:
    """Decode ONE sentence simultaneously. ``src_tokens`` (S,) ids without
    padding; ``model`` in eval mode on ``device`` (its own when None).
    Returns {"tokens", "delays", "latency": {AP, AL, DAL}} (latency {} when
    nothing was written)."""
    if device is None:
        device = next(model.parameters()).device
    src = torch.as_tensor(np.asarray(src_tokens), dtype=torch.int64, device=device)
    s_total = int(src.shape[0])
    mono_cfg = model.mono_cfg
    waitk = mono_cfg.waitk_lagging if mono_cfg.simul_type == "waitk" else None
    tokens: List[int] = [eos]
    delays: List[int] = []
    n_read = 1 if waitk is None else min(waitk, s_total)
    encoded = (None, None)  # (n_read, the prefix's encoder states)
    while len(tokens) - 1 < max_len:
        pcs, next_tok, encoder_out = forward_decision(model, src[:n_read], tokens,
                                                      encoded[1] if encoded[0] == n_read else None)
        encoded = (n_read, encoder_out)
        if waitk is None:
            # the fastest pointer across layers, heads averaged within a layer
            p_write = max(pc[min(len(pc) - 1, len(tokens) - 1, n_read - 1)] for pc in pcs)
            if p_write < read_threshold and n_read < s_total:
                n_read += 1
                continue
        tokens.append(next_tok)
        delays.append(n_read)
        if next_tok == eos:
            break
        if waitk is not None and n_read < s_total:
            n_read = min(n_read + 1, s_total)
    return {"tokens": tokens[1:], "delays": delays,
            "latency": latency_metrics(np.asarray(delays, np.float32), s_total) if delays else {}}
