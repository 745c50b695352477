"""Trainer: the single-device train step.

Counterpart of ``fbk_fairseq_st_tpu/train/trainer.py`` (``train_step``
:555-627 and the jitted bodies :294-399), on one device:

  * ``--bf16``: the float features (``src_tokens``) are cast to bf16
    (``_cast_batch`` :281) and the model computes in their type, each op
    casting its fp32 weight at use; master params, grads and Adam state
    stay fp32. No ``torch.autocast``, which keeps another set of ops in
    fp32 than the JAX step does. A text model (token ids in, no float
    feature to cast) reads the step's type from the batch's
    ``compute_dtype``, so its embeddings start in bf16 within the step and
    the model itself keeps no type: the JAX step leaves such a model in
    fp32 (ROADMAP Queue C), the reference fairseq casts it to bf16;
  * the update (``_apply_grads`` :341): grads / max(sample_size, 1), the
    global norm, the clip scale min(1, clip / (gnorm + 1e-6)), Adam, with
    the scheduler's lr at ``num_updates`` taken before the step;
  * ``update_freq``: a list of samples accumulates grads, sample sizes and
    logging outputs (:592-610). Every microbatch starts from the update's
    BatchNorm running stats and the last one's update is kept, as the JAX
    step threads its model state;
  * no host sync inside the step: ``train_step`` returns loss, nll_loss,
    ntokens, nsentences, sample_size, gnorm and lr as tensors on the
    device and the caller syncs when it reads them (the counterpart of
    ``log_sync_interval``).

Dropout draws from the trainer's ``Generators`` (``ops/core.py``), seeded
from ``args.seed``. The mesh features of the JAX trainer (TP, FSDP,
sequence parallelism, ring attention, BMUF, ``steps_per_execution``) and
models with frozen parameters raise here (ROADMAP Queue A10).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..device import module_device
from ..ops.core import make_generators
from ..optim import build_lr_scheduler, build_optimizer, set_lr

# JAX trainer options off this slice's path: (value that means "off", what).
_NOT_YET = {
    "model_parallel_size": (1, "tensor parallelism"),
    "fsdp": (False, "FSDP"),
    "sequence_parallel": (False, "sequence parallelism"),
    "ring_attention": (False, "ring attention"),
    "use_bmuf": (False, "BMUF"),
    "steps_per_execution": (1, "steps_per_execution"),
    "quant_noise_scalar": (0, "scalar quant-noise"),
}


class Trainer:
    def __init__(self, args, task, model, criterion):
        for name, (off, what) in _NOT_YET.items():
            value = getattr(args, name, None)
            if value is not None and value != off:
                raise NotImplementedError(f"--{name.replace('_', '-')}: {what} is not ported (ROADMAP Queue A10)")
        if getattr(model, "frozen_param_filter", None) is not None:
            raise NotImplementedError("models with frozen parameters are not ported (ROADMAP Queue A10)")
        self.args = args
        self.task = task
        self.model = model
        self.criterion = criterion
        self.device = module_device(model)
        half = any(getattr(args, f, False) for f in ("bf16", "fp16", "memory_efficient_fp16"))
        self.compute_dtype = torch.bfloat16 if half else torch.float32
        self.params = [p for p in model.parameters() if p.requires_grad]
        self.optimizer = build_optimizer(args, self.params)
        self.lr_scheduler = build_lr_scheduler(args)
        self.generators = make_generators(getattr(args, "seed", 1), self.device)
        self.clip_norm = getattr(args, "clip_norm", 0.0) or 0.0
        self._num_updates = 0

    def _device_batch(self, sample) -> Optional[Dict[str, torch.Tensor]]:
        """A collated sample (``net_input`` + ``target``, numpy arrays or
        tensors) -> a flat dict of tensors on the device; integer arrays
        become int64 and the float features take the compute type, which
        ``compute_dtype`` names for a model that has no float input."""
        if not sample:
            return None
        batch = dict(sample["net_input"])
        batch["target"] = sample["target"]
        out = {}
        for key, value in batch.items():
            if value is None or not hasattr(value, "shape"):
                continue
            t = torch.as_tensor(np.asarray(value) if not isinstance(value, torch.Tensor) else value)
            if t.is_floating_point():
                t = t.to(self.compute_dtype) if key in ("src_tokens", "source") else t
            else:
                t = t.long()
            out[key] = t.to(self.device, non_blocking=True)
        out["compute_dtype"] = self.compute_dtype
        return out

    def train_step(self, samples: List[dict]) -> Optional[Dict[str, torch.Tensor]]:
        """One optimizer update over the ``samples`` (update_freq
        microbatches). Returns the summed logging outputs with ``gnorm``
        and ``lr``, as device tensors, or None when no sample had data."""
        lr = self.lr_scheduler.step_update(self._num_updates)
        batches = [b for b in map(self._device_batch, samples) if b is not None]
        if not batches:
            return None
        self.optimizer.zero_grad(set_to_none=True)
        start_buffers = None
        if len(batches) > 1:
            start_buffers = [b.detach().clone() for b in self.model.buffers()]

        logs: Dict[str, Any] = {}
        for i, batch in enumerate(batches):
            if i:
                with torch.no_grad():
                    for buf, start in zip(self.model.buffers(), start_buffers):
                        buf.copy_(start)
            batch = self.task.augment_batch(batch, self.generators)
            loss, _, logging_output = self.criterion(self.model, batch, self.generators, training=True)
            loss.backward()
            for k, v in logging_output.items():
                logs[k] = logs[k] + v if k in logs else v

        # the optax update touches every param; a param that took no part
        # in the loss gets a zero gradient, as jax.grad gives it
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params]
        denom = torch.clamp(logs["sample_size"].float(), min=1.0)
        torch._foreach_div_(grads, denom)
        gnorm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        if self.clip_norm > 0:
            torch._foreach_mul_(grads, torch.clamp(self.clip_norm / (gnorm + 1e-6), max=1.0))
        set_lr(self.optimizer, lr)
        self.optimizer.step()
        self.set_num_updates(self._num_updates + 1)

        logs["gnorm"] = gnorm
        logs["lr"] = torch.full((), lr, dtype=torch.float32, device=self.device)
        return logs

    def get_num_updates(self) -> int:
        return self._num_updates

    def set_num_updates(self, num_updates: int) -> None:
        self._num_updates = num_updates
        self.lr_scheduler.step_update(num_updates)
