"""Batched Levenshtein distance on the device.

Counterpart of ``fbk_fairseq_st_tpu/ops/edit_distance.py::levenshtein``
(:26), which serves the UER logging of the CTC criterions. The DP runs a
row at a time over the prediction, all rows of the batch at once; the
insertion chain inside a row is resolved with the prefix-min trick,
``new[j] = j + cummin_k<=j(m[k] - k)`` (``torch.cummin`` for the JAX
``_cummin`` :22), so a row is O(T2) vector work. The loop runs T1 times on
tensors that stay on the device: nothing is brought to the host.
"""

from __future__ import annotations

import torch


def levenshtein(pred, pred_len, tgt, tgt_len):
    """Edit distance between each padded row pair.

    pred: (B, T1) ints; tgt: (B, T2) ints; the lengths clip the valid
    regions. Returns (B,) int64 distances."""
    b, t1 = pred.shape
    t2 = tgt.shape[1]
    pred, tgt = pred.long(), tgt.long()
    pred_len, tgt_len = pred_len.long(), tgt_len.long()
    j = torch.arange(t2 + 1, device=pred.device)
    row = j.expand(b, t2 + 1)  # dist[0, j] = j
    for i in range(1, t1 + 1):
        cost = (pred[:, i - 1:i] != tgt).long()  # (B, T2)
        # deletion row[j] + 1, substitution row[j-1] + cost[j-1]; j = 0 is i
        sub = torch.cat([torch.full((b, 1), i, device=pred.device, dtype=torch.long), row[:, :-1] + cost], dim=1)
        m = torch.minimum(row + 1, sub)
        m[:, 0] = i
        new_row = torch.cummin(m - j, dim=1).values + j
        row = torch.where((i <= pred_len)[:, None], new_row, row)
    return row.gather(1, torch.clamp(tgt_len, max=t2)[:, None])[:, 0]
