"""Trainer: the single-device train step, validation and the training state.

Counterpart of ``fbk_fairseq_st_tpu/train/trainer.py`` (``train_step``
:555-627, the jitted bodies :294-399, ``flush_logs`` :709, ``valid_step``
:768, the checkpoint state :823-877), on one device:

  * ``--bf16``: the float features (``src_tokens``) are cast to bf16
    (``_cast_batch`` :281) and the model computes in their type, each op
    casting its fp32 weight at use; master params, grads and optimiser
    state stay fp32. No ``torch.autocast``, which keeps another set of ops
    in fp32 than the JAX step does. A text model (token ids in, no float
    feature to cast) reads the step's type from the batch's
    ``compute_dtype``, so its embeddings start in bf16 within the step and
    the model itself keeps no type: the JAX step leaves such a model in
    fp32 (ROADMAP Queue C), the reference fairseq casts it to bf16;
  * the update (``_apply_grads`` :341): grads / max(sample_size, 1), the
    global norm, the clip scale min(1, clip / (gnorm + 1e-6)), then the
    optimiser of ``--optimizer`` with the scheduler's lr at
    ``num_updates`` taken before the step. The sample size is the one the
    criterion *returns* (:307-310), summed over the microbatches as
    ``ss_acc`` (:392-396); ``ctc_multi_loss`` returns the transcript token
    count and logs the target token count;
  * ``update_freq``: a list of samples accumulates grads, sample sizes and
    logging outputs (:592-610). Every microbatch starts from the update's
    BatchNorm running stats and the last one's update is kept, as the JAX
    step threads its model state;
  * dropout is seeded per update: before an update's first microbatch the
    trainer's ``Generators`` (``ops/core.py``) are re-seeded from
    (``args.seed``, ``num_updates + 1``), as JAX folds ``num_updates + 1``
    into its root key (:551-553) and the reference calls
    ``set_torch_seed(seed + num_updates)``. A run resumed at update N
    draws what the run that never stopped drew there. The bits differ
    from JAX's;
  * no host sync inside the step: ``train_step`` returns loss, nll_loss,
    ntokens, nsentences, sample_size, gnorm and lr as tensors on the
    device and keeps them, with the host's lr after the update, until
    ``flush_logs`` brings every pending update's scalars over in one copy,
    checks each gradient norm (a NaN or an Inf re-runs the last batch's
    forward under the NaN detector and raises ``FloatingPointError``) and
    logs them into the metrics stack as JAX's ``_log_training`` does.
    ``cli/train`` flushes at ``--log-interval``, before validating and
    before saving (the counterpart of JAX's ``log_sync_interval``);
  * ``stage_sample`` copies a collated batch to the card ahead of its step
    (pinned memory, ``non_blocking`` on a side stream); the step waits on
    the copy's event;
  * frozen parameters (a model's ``frozen_param_filter``, JAX :223-254,
    :341-360): the parameters it names get ``requires_grad=False`` and stay
    out of the optimiser, so they have no gradient in the norm and the
    clip, and no update, weight decay included. A frozen module keeps its
    mode: the frozen front end of the context-aware model still
    normalises with batch statistics and updates its BatchNorm buffers in
    a train step, as JAX's does;
  * a multilingual batch is a dict of per-pair sub-batches (JAX :281-292,
    :456-480, :565-580): each is staged and moved as a flat batch, the
    ``ntokens`` and ``nsentences`` logged are their sums, and the
    criterion sums its loss over the pairs, so an update is one loss and
    one backward, the gradients of JAX's single step over all pairs.

The mesh features of the JAX trainer (TP, FSDP, sequence parallelism,
ring attention, BMUF) raise here (ROADMAP Queue A item 6),
``steps_per_execution`` > 1 too (item 8) and scalar quant-noise (item 9).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..device import module_device
from ..ops.core import make_generators
from ..optim import build_lr_scheduler, build_optimizer, set_lr
from . import metrics

# JAX trainer options off this slice's path: (value that means "off", what).
_NOT_YET = {
    "model_parallel_size": (1, "tensor parallelism (ROADMAP Queue A item 6)"),
    "fsdp": (False, "FSDP (ROADMAP Queue A item 6)"),
    "sequence_parallel": (False, "sequence parallelism (ROADMAP Queue A item 6)"),
    "ring_attention": (False, "ring attention (ROADMAP Queue A item 6)"),
    "use_bmuf": (False, "BMUF (ROADMAP Queue A item 6)"),
    "steps_per_execution": (1, "steps_per_execution (ROADMAP Queue A item 8)"),
    "quant_noise_scalar": (0, "scalar quant-noise (ROADMAP Queue A item 9)"),
}
_META = ("net_input", "id", "ntokens", "nsentences", "_staged")


def is_nested(sample) -> bool:
    """A multilingual sample, collated or on the device: a dict of per-pair
    sub-batches."""
    return bool(sample) and "net_input" not in sample and all(isinstance(v, dict) for v in sample.values())


def update_seed(seed: int, num_updates: int) -> int:
    """The generators' seed of update ``num_updates`` (0-based) of a run
    seeded ``seed``: one 63-bit draw of numpy's SeedSequence over the
    pair, so neighbouring updates and seeds share no stream."""
    return int(np.random.SeedSequence([int(seed), int(num_updates) + 1]).generate_state(2, np.uint64)[0] >> 1)


class Trainer:
    def __init__(self, args, task, model, criterion):
        for name, (off, what) in _NOT_YET.items():
            value = getattr(args, name, None)
            if value is not None and value != off:
                raise NotImplementedError(f"--{name.replace('_', '-')}: {what} is not ported")
        frozen = getattr(model, "frozen_param_filter", None)
        if frozen is not None:
            for name, p in model.named_parameters():
                if frozen(name):
                    p.requires_grad_(False)
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
        self.seed = getattr(args, "seed", 1)
        self.generators = make_generators(self.seed, self.device)
        fvs = getattr(args, "fixed_validation_seed", None)
        self._valid_seed = self.seed if fvs is None else int(fvs)
        self.clip_norm = getattr(args, "clip_norm", 0.0) or 0.0
        self._num_updates = 0
        self._pending_logs: List[tuple] = []
        self._last_batch = None
        self._copy_stream = None
        self.lr_scheduler.step_update(0)
        metrics.log_start_time("wall", priority=790, round=0)

    # ------------------------------------------------------------------
    # batches
    # ------------------------------------------------------------------

    def stage_sample(self, sample):
        """A collated sample with its arrays copied to the card ahead of its
        step: pinned host memory, ``non_blocking`` copies on a side stream,
        the float features cast to the compute type on the host first (as
        the step casts them: half the bytes under ``--bf16``). The step
        waits on the copy's event (``_device_batch``). On the CPU the sample
        is given back as it is, and so it is under a criterion that prepares
        its samples on the host at their step (ASG's packing reads the
        update count)."""
        if not sample or self.device is None or self.device.type != "cuda":
            return sample
        if hasattr(self.criterion, "prepare_sample"):
            return sample
        if is_nested(sample):
            return {pair: self.stage_sample(sub) for pair, sub in sample.items()}
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(self.device)

        def put(key, value):
            if value is None or not hasattr(value, "shape") or isinstance(value, torch.Tensor):
                return value
            t = torch.from_numpy(np.ascontiguousarray(value))
            if t.is_floating_point() and key in ("src_tokens", "source"):
                t = t.to(self.compute_dtype)
            return t.pin_memory().to(self.device, non_blocking=True)

        staged = dict(sample)
        with torch.cuda.stream(self._copy_stream):
            staged["net_input"] = {k: put(k, v) for k, v in sample["net_input"].items()}
            for k, v in sample.items():
                if k not in _META:
                    staged[k] = put(k, v)
            event = torch.cuda.Event()
            event.record(self._copy_stream)
        staged["_staged"] = event
        return staged

    def _device_batch(self, sample) -> Optional[Dict[str, torch.Tensor]]:
        """A collated sample (numpy arrays or tensors) -> a flat dict of
        tensors on the device: the ``net_input`` fields and every
        array-valued top-level key but ``id`` (``target``,
        ``transcript_target``, ``transcript_target_lengths``, ...), as the
        JAX ``_device_batch`` (:456) keeps them. Integer arrays become int64
        and the float features take the compute type, which
        ``compute_dtype`` names for a model that has no float input. A
        staged sample's copies are waited for on the current stream. A
        nested sample gives a dict of such batches, one a pair with data."""
        if not sample:
            return None
        if is_nested(sample):
            nested = {pair: self._device_batch(sub) for pair, sub in sample.items()}
            return {pair: b for pair, b in nested.items() if b is not None} or None
        event = sample.get("_staged")
        if event is not None:
            torch.cuda.current_stream(self.device).wait_event(event)
        batch = dict(sample["net_input"])
        batch.update((k, v) for k, v in sample.items() if k not in _META)
        out = {}
        for key, value in batch.items():
            if value is None or not hasattr(value, "shape"):
                continue
            t = value if isinstance(value, torch.Tensor) else torch.as_tensor(np.asarray(value))
            if event is not None:
                t.record_stream(torch.cuda.current_stream(self.device))
            if t.is_floating_point():
                t = t.to(self.compute_dtype) if key in ("src_tokens", "source") else t
            else:
                t = t.long()
            out[key] = t.to(self.device, non_blocking=True)
        out["compute_dtype"] = self.compute_dtype
        return out

    @staticmethod
    def _sample_meta(sample) -> Dict[str, int]:
        subs = sample.values() if is_nested(sample) else (sample,)
        return {key: sum(int(sub.get(key, 0) or 0) for sub in subs) for key in ("ntokens", "nsentences")}

    # ------------------------------------------------------------------
    # the update
    # ------------------------------------------------------------------

    def _seed_update(self) -> None:
        seed = update_seed(self.seed, self._num_updates)
        for g in {id(g): g for g in self.generators}.values():
            g.manual_seed(seed)

    def train_step(self, samples: List[dict]) -> Optional[Dict[str, torch.Tensor]]:
        """One optimizer update over the ``samples`` (update_freq
        microbatches). Returns the summed logging outputs with ``gnorm``
        and ``lr``, as device tensors, or None when no sample had data; the
        update's outputs also wait, on the device, for ``flush_logs``."""
        metrics.log_start_time("train_wall", priority=800, round=0)
        lr = self.lr_scheduler.step_update(self._num_updates)
        meta = {"ntokens": 0, "nsentences": 0}
        batches = []
        prepare = getattr(self.task, "prepare_sample", None)
        crit_prepare = getattr(self.criterion, "prepare_sample", None)
        for sample in samples:
            if prepare is not None:
                sample = prepare(sample, self._num_updates)
            if crit_prepare is not None:
                # the criterion's host-side batch work (ASG's replabel packing)
                sample = crit_prepare(sample, self._num_updates)
            b = self._device_batch(sample)
            if b is None:
                continue
            for k, v in self._sample_meta(sample).items():
                meta[k] += v
            batches.append(b)
        if not batches:
            metrics.log_stop_time("train_wall")
            return None
        self._seed_update()
        self.optimizer.zero_grad(set_to_none=True)
        start_buffers = None
        if len(batches) > 1:
            start_buffers = [b.detach().clone() for b in self.model.buffers()]

        logs: Dict[str, Any] = {}
        sample_size = 0
        for i, batch in enumerate(batches):
            if i:
                with torch.no_grad():
                    for buf, start in zip(self.model.buffers(), start_buffers):
                        buf.copy_(start)
            batch = self.task.augment_batch(batch, self.generators)
            loss, size, logging_output = self.criterion(self.model, batch, self.generators, training=True)
            loss.backward()
            sample_size = sample_size + size
            for k, v in logging_output.items():
                logs[k] = logs[k] + v if k in logs else v

        # the optax update touches every param; a param that took no part
        # in the loss gets a zero gradient, as jax.grad gives it
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params]
        denom = torch.clamp(torch.as_tensor(sample_size, device=self.device).float(), min=1.0)
        torch._foreach_div_(grads, denom)
        gnorm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        if self.clip_norm > 0:
            torch._foreach_mul_(grads, torch.clamp(self.clip_norm / (gnorm + 1e-6), max=1.0))
        set_lr(self.optimizer, lr)
        self.optimizer.step()
        self.set_num_updates(self._num_updates + 1)

        logs["gnorm"] = gnorm
        logs["lr"] = torch.full((), lr, dtype=torch.float32, device=self.device)
        # JAX logs the lr of the next update (_log_training :760)
        self._pending_logs.append((logs, meta, self.lr_scheduler.step_update(self._num_updates)))
        self._last_batch = batches[-1]
        metrics.log_stop_time("train_wall")
        return logs

    def flush_logs(self) -> Optional[Dict[str, float]]:
        """Bring every pending update's logging outputs to the host in one
        copy, check each gradient norm, and log them into the metrics
        stack. Returns the last update's outputs as floats (None when
        nothing was pending)."""
        if not self._pending_logs:
            return None
        keys = [sorted(logs) for logs, _, _ in self._pending_logs]
        flat = torch.stack([logs[k].detach().to(torch.float64).reshape(())
                            for (logs, _, _), ks in zip(self._pending_logs, keys) for k in ks])
        values = iter(flat.cpu().tolist())
        pending, self._pending_logs = self._pending_logs, []
        out = None
        for (_, meta, lr_after), ks in zip(pending, keys):
            logging_output = {k: next(values) for k in ks}
            gnorm = logging_output.pop("gnorm")
            logging_output.pop("lr")
            if not np.isfinite(gnorm):
                from .nan_detector import analyze_failing_step

                findings = analyze_failing_step(self, self._last_batch)
                raise FloatingPointError("gradient norm is {}; NaN/Inf detected in gradients. "
                                         "First findings: {}".format(gnorm, findings[:3]))
            self._log_training(logging_output, gnorm, meta, lr_after)
            out = logging_output
        return out

    def _log_training(self, logging_output, gnorm, meta, lr) -> None:
        """JAX ``_log_training`` (:754): speed, gnorm, lr, bsz and the
        criterion's metrics."""
        ntokens = meta.get("ntokens", logging_output.get("ntokens", 0))
        metrics.log_speed("ups", 1.0, priority=100, round=2)
        metrics.log_scalar("gnorm", gnorm, priority=400, round=3)
        metrics.log_scalar("lr", lr, weight=0, priority=300)
        if ntokens:
            metrics.log_speed("wps", ntokens, priority=90, round=1)
        metrics.log_scalar("bsz", meta.get("nsentences", 0), priority=190, round=1)
        self.task.reduce_metrics([logging_output], self.criterion, metrics)

    # ------------------------------------------------------------------
    # validation
    # ------------------------------------------------------------------

    def valid_step(self, sample) -> Optional[Dict[str, float]]:
        """The criterion in eval mode on one batch, in the step's compute
        type, with dropout off; its outputs come to the host in one copy,
        the task's host-side extras join them and the metrics stack takes
        them (JAX :768-787)."""
        prepare = getattr(self.task, "prepare_sample", None)
        if prepare is not None:
            sample = prepare(sample, self._num_updates, training=False)
        crit_prepare = getattr(self.criterion, "prepare_sample", None)
        if crit_prepare is not None:
            sample = crit_prepare(sample, self._num_updates, training=False)
        batch = self._device_batch(sample)
        if batch is None:
            return None
        gens = make_generators(self._valid_seed, self.device)
        with torch.no_grad():
            _, _, logging_output = self.criterion(self.model, batch, gens, training=False)
        keys = sorted(logging_output)
        flat = torch.stack([logging_output[k].detach().to(torch.float64).reshape(()) for k in keys])
        logging_output = dict(zip(keys, flat.cpu().tolist()))
        logging_output.update(self.task.valid_step_extra(sample, self))
        self.task.reduce_metrics([logging_output], self.criterion, metrics)
        return logging_output

    # ------------------------------------------------------------------
    # bookkeeping
    # ------------------------------------------------------------------

    def get_num_updates(self) -> int:
        return self._num_updates

    def set_num_updates(self, num_updates: int) -> None:
        self._num_updates = num_updates
        self.lr_scheduler.step_update(num_updates)
        metrics.log_scalar("num_updates", num_updates, weight=0, priority=200)

    def get_lr(self) -> float:
        return self.lr_scheduler.step_update(self._num_updates)

    def lr_step(self, epoch: int, val_loss: Optional[float] = None) -> float:
        return self.lr_scheduler.step(epoch, val_loss)

    def state_for_checkpoint(self) -> Dict[str, Any]:
        """The training state on the host: the model's state dict (fork
        names, CPU tensors), the optimiser's and the scheduler's state
        dicts and the update count."""
        return {
            "model": {k: v.detach().cpu() for k, v in self.model.state_dict().items()},
            "optimizer": _to_cpu(self.optimizer.state_dict()),
            "lr_scheduler": self.lr_scheduler.state_dict(),
            "num_updates": self._num_updates,
        }

    def load_trainer_state(self, state: Dict[str, Any], reset_optimizer: bool = False,
                           reset_lr_scheduler: bool = False) -> None:
        """Restore ``state_for_checkpoint``'s fields: the model strictly
        (in place, so the optimiser keeps its parameters), the optimiser's
        state unless ``reset_optimizer`` or it is None, the scheduler's
        unless ``reset_lr_scheduler``, and the update count."""
        self.model.load_state_dict(state["model"], strict=True)
        if not reset_optimizer and state.get("optimizer") is not None:
            self.optimizer.load_state_dict(state["optimizer"])
        if not reset_lr_scheduler and state.get("lr_scheduler") is not None:
            self.lr_scheduler.load_state_dict(state["lr_scheduler"])
        self.set_num_updates(state.get("num_updates", 0))


def _to_cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_cpu(v) for v in tree]
    return tree
