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

Multi-GPU (JAX's mesh, :45-160; ``parallel/``): once ``torch.distributed``
is initialised (``cli/train.py``) the trainer lays the ranks out on a mesh
(``parallel.mesh.make_mesh``: ``--model-parallel-size``,
``--dcn-data-parallel``, the rest ``data``) and computes what JAX's sharded
step computes, the unsharded step on the global batch:

  * every rank collates the same global batch and takes its own rows
    (``local_row_range``); the BatchNorm statistics are all-reduced over
    the data-parallel ranks (``ops/core.py::batch_norm``'s ``group``);
  * after the update's last microbatch the gradients are summed over the
    data-parallel ranks in one all-reduce of their flat concatenation (one
    a process group: the ``batch`` group, and ``dcn`` for FSDP's chunks,
    whose gather already reduce-scattered them over ``data``), and the
    sample size and the logging sums in another, before the division, the
    norm, ``--clip-norm`` and the step, so every rank holds the same
    parameters and optimiser state;
  * ``--model-parallel-size``: Megatron's tensor parallelism
    (``parallel/tensor_parallel.py``), with ``--sequence-parallel`` and
    ``--ring-attention``; ``--fsdp``: ZeRO-3 chunks (``parallel/fsdp.py``);
    the gradient norm sums each chunked leaf's squares over its groups. An
    optimiser whose update is not elementwise (Adafactor's factored
    moments, LAMB's trust ratio) would see a chunk, and raises there;
  * ``--use-bmuf``: local SGD (``optim/local_sgd.py``), no gradient or
    BatchNorm all-reduce between the block syncs;
  * dropout: each data-parallel rank draws its own stream (its rank folded
    into ``update_seed``); the ranks of one model group draw alike;
  * checkpoints hold the whole tensors under the fork's names
    (``state_for_checkpoint`` gathers them, the mesh's first rank writes
    them), and ``load_trainer_state`` takes each rank's chunk, so a run
    resumes at another world size or layout.

Quantisation (JAX :256-305, :797-800): ``--quant-noise-scalar p`` puts
each large parameter's int8 noise in place for a microbatch's forward and
backward and the stored values back after it (``quantization/scalar.py``:
the straight-through gradient at the noised weights reaches the stored
ones); an iPQ ``Quantizer`` (``--quantization-config-path``) steps at the
update boundaries of its schedule from ``set_num_updates``, and after a
stage's module swaps ``reinitialize`` takes a fresh optimiser over the new
parameters, the update count and the scheduler kept; a checkpoint whose
layers are quantised swaps the same modules in before it is restored
(``adopt_quantized_layout``). Neither runs on a split layout (FSDP or
tensor parallelism: a rank holds a chunk of a weight) or under BMUF.

``steps_per_execution`` > 1 raises (ROADMAP Queue A item 8).
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, List, Optional

import numpy as np
import torch

import torch.distributed as dist

from ..device import module_device
from ..ops.core import BatchNorm, make_generators
from ..optim import build_lr_scheduler, build_optimizer, set_lr
from ..optim.local_sgd import LocalSGDBMUF
from ..parallel.collectives import all_gather_tensor, all_reduce_, broadcast_, chunk_of, group_size
from ..parallel.fsdp import apply_fsdp, canonical_name
from ..parallel.mesh import local_row_range, make_mesh, param_sharding
from ..parallel.tensor_parallel import apply_tensor_parallel
from . import metrics

# JAX trainer options off this slice's path: (value that means "off", what).
_NOT_YET = {
    "steps_per_execution": (1, "steps_per_execution (ROADMAP Queue A item 8)"),
}
# the optimisers whose update reads more than one element of a leaf
_NOT_ELEMENTWISE = ("adafactor", "lamb")
_META = ("net_input", "id", "ntokens", "nsentences", "_staged", "_local")


def is_nested(sample) -> bool:
    """A multilingual sample, collated or on the device: a dict of per-pair
    sub-batches."""
    return bool(sample) and "net_input" not in sample and all(isinstance(v, dict) for v in sample.values())


def update_seed(seed: int, num_updates: int, rank: int = 0) -> int:
    """The generators' seed of update ``num_updates`` (0-based) of a run
    seeded ``seed`` on data-parallel rank ``rank``: one 63-bit draw of
    numpy's SeedSequence over the pair (the triple off rank 0), so
    neighbouring updates, seeds and ranks share no stream."""
    entropy = [int(seed), int(num_updates) + 1] + ([int(rank)] if rank else [])
    return int(np.random.SeedSequence(entropy).generate_state(2, np.uint64)[0] >> 1)


class Trainer:
    def __init__(self, args, task, model, criterion, mesh=None, quantizer=None):
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
        if mesh is None and dist.is_available() and dist.is_initialized():
            mesh = make_mesh(model=getattr(args, "model_parallel_size", 1) or 1,
                             dcn=getattr(args, "dcn_data_parallel", 1) or 1)
        if mesh is None and (getattr(args, "model_parallel_size", 1) or 1) > 1:
            raise ValueError("--model-parallel-size > 1 needs several ranks: launch with --distributed-world-size")
        self.mesh = mesh
        self.layout: Dict[str, tuple] = {}
        self.bmuf = None
        if getattr(args, "use_bmuf", False):
            self.bmuf = LocalSGDBMUF(args, None if mesh is None else mesh.group("batch"))
        if mesh is not None:
            self._distribute()
        self.device = module_device(model)
        half = any(getattr(args, f, False) for f in ("bf16", "fp16", "memory_efficient_fp16"))
        self.compute_dtype = torch.bfloat16 if half else torch.float32
        self.quantizer = quantizer
        self.quant_noise_scalar = float(getattr(args, "quant_noise_scalar", 0) or 0)
        if (self.quant_noise_scalar > 0 or quantizer is not None) and (self.layout or self.bmuf is not None):
            raise NotImplementedError("--quant-noise-scalar and --quantization-config-path need whole weights on "
                                      "every rank: not with --fsdp, --model-parallel-size or --use-bmuf")
        self._collect_params()
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

    def _collect_params(self) -> None:
        """The trainable parameters, their fork names and a fresh optimiser over them."""
        self.params = [p for p in self.model.parameters() if p.requires_grad]
        names = {id(p): canonical_name(n) for n, p in self.model.named_parameters()}
        self._param_names = [names[id(p)] for p in self.params]
        self.optimizer = build_optimizer(self.args, self.params)

    def reinitialize(self) -> None:
        """After the model's parameters changed (iPQ's module swaps; JAX
        ``reinitialize`` :256-280): a fresh optimiser over the trainable
        parameters, the model's frozen filter applied again; the update
        count and the scheduler's state carry over."""
        frozen = getattr(self.model, "frozen_param_filter", None)
        if frozen is not None:
            for name, p in self.model.named_parameters():
                if frozen(name):
                    p.requires_grad_(False)
        self._collect_params()

    def adopt_quantized_layout(self, model_state: Dict[str, torch.Tensor]) -> bool:
        """Swap in the iPQ modules a checkpoint's model state holds where
        the model has plain ones (JAX restores into the checkpoint's tree
        and reinitialises, :851-860); True when any was swapped."""
        from ..quantization.pq import adopt_pq_layout

        if not adopt_pq_layout(self.model, model_state):
            return False
        self.reinitialize()
        return True

    # ------------------------------------------------------------------
    # the mesh
    # ------------------------------------------------------------------

    def _distribute(self) -> None:
        """Split the model over the mesh: tensor parallelism, then FSDP's
        chunks, then the BatchNorm statistics' group."""
        args, mesh = self.args, self.mesh
        fsdp = bool(getattr(args, "fsdp", False)) and mesh.size("data") > 1
        use_tp = mesh.size("model") > 1
        if fsdp and self.bmuf is not None:
            raise NotImplementedError("--fsdp with --use-bmuf: local SGD keeps whole replicas, FSDP splits them")
        if (use_tp or fsdp) and getattr(args, "optimizer", "adam") in _NOT_ELEMENTWISE:
            raise NotImplementedError(f"--optimizer {args.optimizer} with --fsdp or --model-parallel-size: its update "
                                      "reads a whole leaf, and a rank holds a chunk")
        # every rank starts from the first rank's weights: the ranks build the
        # model from one seed, and this keeps one that drew otherwise in step
        with torch.no_grad():
            for t in list(self.model.parameters()) + list(self.model.buffers()):
                for axis in ("batch", "model"):
                    broadcast_(t.data, mesh.group(axis))
        shapes = {n: tuple(p.shape) for n, p in self.model.named_parameters()}
        split = apply_tensor_parallel(self.model, mesh, bool(getattr(args, "sequence_parallel", False)),
                                      bool(getattr(args, "ring_attention", False)),
                                      keep_logits_sharded=getattr(self.criterion, "takes_split_logits", False))
        layout = param_sharding(shapes, mesh, use_tp, fsdp, getattr(args, "fsdp_min_shard_size", None),
                                tp_names=split)
        self.layout = {name: spec for name, spec in layout.items() if any(spec)}
        if fsdp:
            apply_fsdp(self.model, self.layout, mesh)
        if self.bmuf is None:
            for m in self.model.modules():
                if isinstance(m, BatchNorm):
                    m.sync_group = mesh.group("batch")

    @property
    def is_first_rank(self) -> bool:
        """Whether this rank writes the checkpoints and the logs."""
        return self.mesh is None or self.mesh.is_first

    def param_names(self) -> List[str]:
        """The fork's names of the optimiser's parameters, in its order."""
        return list(self._param_names)

    def _local_sample(self, sample):
        """This rank's rows of a collated global batch (every array of
        ``net_input`` and the top level, on its leading dim)."""
        if self.mesh is None or self.mesh.batch_size == 1 or not sample:
            return sample
        if is_nested(sample):
            return {pair: self._local_sample(sub) for pair, sub in sample.items()}
        if sample.get("_local"):
            return sample
        rows = next(v.shape[0] for v in sample["net_input"].values() if hasattr(v, "shape") and len(v.shape))
        lo, hi = local_row_range(self.mesh, rows)

        def rows_of(v):
            return v[lo:hi] if hasattr(v, "shape") and len(v.shape) else v

        local = {k: (v if k in ("ntokens", "nsentences", "_staged") else rows_of(v)) for k, v in sample.items()}
        local["net_input"] = {k: rows_of(v) for k, v in sample["net_input"].items()}
        local["_local"] = True
        return local

    def _sync_grads(self, grads: List[torch.Tensor]) -> None:
        """Sum the gradients over the data-parallel ranks: one all-reduce
        of the flat gradients per group (FSDP's chunks over ``dcn`` only)."""
        buckets: Dict[int, tuple] = {}
        for name, g in zip(self._param_names, grads):
            group = self.mesh.group("dcn" if "data" in self.layout.get(name, ()) else "batch")
            if group_size(group) > 1:
                buckets.setdefault(id(group), (group, []))[1].append(g)
        for group, gs in buckets.values():
            flat = torch.cat([g.reshape(-1) for g in gs])
            all_reduce_(flat, group)
            for g, part in zip(gs, torch.split(flat, [g.numel() for g in gs])):
                g.copy_(part.view_as(g))

    def _grad_norm(self, grads: List[torch.Tensor]) -> torch.Tensor:
        """The global norm of the gradients: a chunked leaf's squares are
        summed over the groups it is split over."""
        if not self.layout:
            return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        norms = torch._foreach_norm(grads)
        by_axes: Dict[tuple, List[torch.Tensor]] = {}
        for name, n in zip(self._param_names, norms):
            axes = tuple(a for a in ("data", "model") if a in self.layout.get(name, ()))
            by_axes.setdefault(axes, []).append(n.float())
        total = torch.zeros((), dtype=torch.float32, device=norms[0].device)
        for axes, ns in by_axes.items():
            sq = torch.stack(ns).square().sum()
            for axis in axes:
                all_reduce_(sq, self.mesh.group(axis))
            total = total + sq
        return total.sqrt()

    def _whole(self, name: str, t: torch.Tensor) -> torch.Tensor:
        spec = self.layout.get(name, ())
        for axis in ("data", "model"):
            if axis in spec:
                t = all_gather_tensor(t, spec.index(axis), self.mesh.group(axis))
        return t

    def _chunk(self, name: str, t: torch.Tensor) -> torch.Tensor:
        spec = self.layout.get(name, ())
        for axis in ("model", "data"):
            if axis in spec:
                t = chunk_of(t, spec.index(axis), self.mesh.group(axis))
        return t

    def _named_tensors(self) -> Dict[str, torch.Tensor]:
        return {canonical_name(k): v for k, v in self.model.state_dict(keep_vars=True).items()}

    def full_model_state(self) -> Dict[str, torch.Tensor]:
        """The model's state dict, whole tensors under the fork's names, on
        the CPU (a collective under a split layout)."""
        return {k: self._whole(k, v.detach()).cpu() for k, v in self._named_tensors().items()}

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
        sample = self._local_sample(sample)
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
        seed = update_seed(self.seed, self._num_updates, 0 if self.mesh is None else self.mesh.batch_rank)
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
            b = self._device_batch(self._local_sample(sample))
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
            with self._scalar_quant_noise():
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
        sample_size = torch.as_tensor(sample_size, device=self.device)
        if self.mesh is not None:
            local_size = sample_size
            sample_size, logs = self._reduce_logs(sample_size, logs)
            if self.bmuf is None:
                self._sync_grads(grads)
            else:
                sample_size = local_size  # local SGD: each rank's own rows
        denom = torch.clamp(sample_size.float(), min=1.0)
        torch._foreach_div_(grads, denom)
        gnorm = self._grad_norm(grads)
        if self.clip_norm > 0:
            torch._foreach_mul_(grads, torch.clamp(self.clip_norm / (gnorm + 1e-6), max=1.0))
        set_lr(self.optimizer, lr)
        self.optimizer.step()
        self.set_num_updates(self._num_updates + 1)
        if self.bmuf is not None:
            self.bmuf.after_update(self.params, self.optimizer, self._num_updates)
            if self.mesh is not None:
                # the ranks' root mean square, so that every rank logs and
                # checks the same value
                gnorm = all_reduce_(gnorm.square(), self.mesh.group("batch")).div(self.mesh.batch_size).sqrt()

        logs["gnorm"] = gnorm
        logs["lr"] = torch.full((), lr, dtype=torch.float32, device=self.device)
        # JAX logs the lr of the next update (_log_training :760)
        self._pending_logs.append((logs, meta, self.lr_scheduler.step_update(self._num_updates)))
        self._last_batch = batches[-1]
        metrics.log_stop_time("train_wall")
        return logs

    def _scalar_quant_noise(self):
        """``--quant-noise-scalar``'s noised weights in place for one
        microbatch (JAX ``_loss_fn`` :298-305), or nothing."""
        if self.quant_noise_scalar <= 0:
            return contextlib.nullcontext()
        from ..quantization.scalar import scalar_quant_noise_

        return scalar_quant_noise_(self.model, self.quant_noise_scalar, self.generators)

    def _reduce_logs(self, sample_size, logs):
        """The sample size and the logging sums over the data-parallel
        ranks, in one all-reduce (fp64: exact counts)."""
        keys = sorted(logs)
        flat = torch.stack([sample_size.double().reshape(())] + [logs[k].detach().double().reshape(()) for k in keys])
        all_reduce_(flat, self.mesh.group("batch"))
        return flat[0], dict(zip(keys, flat[1:]))

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
        batch = self._device_batch(self._local_sample(sample))
        if batch is None:
            return None
        gens = make_generators(self._valid_seed, self.device)
        with torch.no_grad():
            _, _, logging_output = self.criterion(self.model, batch, gens, training=False)
        if self.mesh is not None:
            _, logging_output = self._reduce_logs(torch.zeros((), device=self.device), logging_output)
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
        if self.quantizer is not None:
            # the update-scheduled iPQ stage boundaries (reference trainer.py:624-625)
            self.quantizer.step_update(num_updates)
        metrics.log_scalar("num_updates", num_updates, weight=0, priority=200)

    def get_lr(self) -> float:
        return self.lr_scheduler.step_update(self._num_updates)

    def lr_step(self, epoch: int, val_loss: Optional[float] = None) -> float:
        return self.lr_scheduler.step(epoch, val_loss)

    def state_for_checkpoint(self) -> Dict[str, Any]:
        """The training state on the host: the model's state dict (fork
        names, CPU tensors), the optimiser's and the scheduler's state
        dicts, the update count, and BMUF's block state under
        ``--use-bmuf``. Under a split layout every tensor is whole (all the
        ranks take part)."""
        optimizer = self.optimizer.state_dict()
        if self.layout:
            optimizer["state"] = {i: {key: self._whole(self._param_names[i], v.detach())
                                      if self._of_param(i, v) else v for key, v in st.items()}
                                  for i, st in optimizer["state"].items()}
        state = {
            "model": self.full_model_state(),
            "optimizer": _to_cpu(optimizer),
            "lr_scheduler": self.lr_scheduler.state_dict(),
            "num_updates": self._num_updates,
        }
        if self.bmuf is not None:
            state["bmuf"] = {key: None if v is None else [self._whole(n, t).cpu() for n, t in zip(self._param_names, v)]
                             for key, v in self.bmuf.state_dict().items()}
        return state

    def _of_param(self, i: int, v) -> bool:
        return isinstance(v, torch.Tensor) and v.dim() > 0 and v.shape == self.params[i].shape

    def load_trainer_state(self, state: Dict[str, Any], reset_optimizer: bool = False,
                           reset_lr_scheduler: bool = False) -> None:
        """Restore ``state_for_checkpoint``'s fields: the model strictly
        (in place, so the optimiser keeps its parameters), the optimiser's
        state unless ``reset_optimizer`` or it is None, the scheduler's
        unless ``reset_lr_scheduler``, and the update count. Under a split
        layout each rank takes its chunk of every whole tensor."""
        if not self.layout:
            self.model.load_state_dict(state["model"], strict=True)
        else:
            own = self._named_tensors()
            if sorted(own) != sorted(state["model"]):
                raise KeyError("the checkpoint's model state has other keys than this model's: "
                               f"missing {sorted(set(own) - set(state['model']))[:8]}, "
                               f"unexpected {sorted(set(state['model']) - set(own))[:8]}")
            with torch.no_grad():
                for k, t in own.items():
                    t.copy_(self._chunk(k, state["model"][k].to(t.device)))
        if not reset_optimizer and state.get("optimizer") is not None:
            optimizer = state["optimizer"]
            if self.layout:
                optimizer = dict(optimizer)
                optimizer["state"] = {i: {key: self._chunk(self._param_names[i], v)
                                          if isinstance(v, torch.Tensor) and v.dim() > 0 and
                                          v.shape == self._whole_shape(i) else v for key, v in st.items()}
                                      for i, st in optimizer["state"].items()}
            self.optimizer.load_state_dict(optimizer)
        if not reset_lr_scheduler and state.get("lr_scheduler") is not None:
            self.lr_scheduler.load_state_dict(state["lr_scheduler"])
        if self.bmuf is not None and state.get("bmuf") is not None:
            self.bmuf.load_state_dict({key: None if v is None else [self._chunk(n, t).to(self.device)
                                                                   for n, t in zip(self._param_names, v)]
                                       for key, v in state["bmuf"].items()})
        self.set_num_updates(state.get("num_updates", 0))

    def _whole_shape(self, i: int) -> tuple:
        shape = list(self.params[i].shape)
        spec = self.layout.get(self._param_names[i], ())
        for axis in ("data", "model"):
            if axis in spec:
                shape[spec.index(axis)] *= self.mesh.size(axis)
        return tuple(shape)


def _to_cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_cpu(v) for v in tree]
    return tree
