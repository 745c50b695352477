"""Optimizers.

Counterpart of ``fbk_fairseq_st_tpu/optim/optimizers.py``, for Adam
(:50), the optimizer of every FBK ST recipe. The JAX package builds
``optax.scale_by_adam`` (bias-corrected, ``eps_root = 0``) behind the
coupled weight decay of ``_with_weight_decay`` (:42, ``grad += wd * param``
before the statistics): an lr-free, unsigned update ``u`` that the step
applies as ``p -= lr * u`` with the scheduler's lr. ``torch.optim.Adam``
with its lr set before every step computes the same update and applies it
the same way, so it serves here: the JAX package wrote no kernel for the
optimizer either, it left it to XLA.
"""

from __future__ import annotations

import ast

import torch


def _parse_betas(s) -> tuple:
    if isinstance(s, (tuple, list)):
        return tuple(s)
    return tuple(ast.literal_eval(s))


def build_adam(args, params) -> torch.optim.Adam:
    b1, b2 = _parse_betas(getattr(args, "adam_betas", "(0.9, 0.999)"))
    return torch.optim.Adam(
        params, lr=0.0, betas=(b1, b2), eps=getattr(args, "adam_eps", 1e-8),
        weight_decay=getattr(args, "weight_decay", 0.0) or 0.0,
    )


OPTIMIZERS = {"adam": build_adam}


def build_optimizer(args, params) -> torch.optim.Optimizer:
    name = getattr(args, "optimizer", "adam")
    if name not in OPTIMIZERS:
        raise NotImplementedError(f"--optimizer {name}: only adam is ported (ROADMAP Queue A7)")
    return OPTIMIZERS[name](args, params)


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr
