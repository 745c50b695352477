"""Checkpoints: reading a model ensemble, and saving and resuming training.

Counterpart of ``fbk_fairseq_st_tpu/train/checkpoint.py``
(``save_checkpoint`` :86, ``checkpoint_paths`` :261, ``load_checkpoint``
:313, ``get_train_iterator`` :402, ``verify_checkpoint_directory`` :417,
``load_checkpoint_to_cpu`` :53, ``load_model_ensemble_and_task``
:458-495, ``average_checkpoints`` :497-518). It reads two formats:

  (a) a fork-layout ``.pt`` (``torch.save`` of {args, model, ...},
      reference checkpoint_utils.py:166-214): the model's ``state_dict``
      under the fork's names, which the port's modules carry, so it loads
      strictly once the fork's bookkeeping entries are dropped and the
      renames of ``upgrade_fork_state`` are applied (the port's copy of
      ``utils/fairseq_interop.py::upgrade_fork_state`` :63);
  (b) the JAX package's pickled checkpoint (``save_state`` :46): {args
      (a dict), model (the params tree), model_state, opt_state, ...},
      through ``utils.weights.state_dict_from_jax``. Its ``opt_state``
      pickles optax classes by reference, so it is read with an
      unpickler that lets numpy, builtins, ``collections``, ``copyreg``
      and ``argparse`` through and turns every other class into a stub
      that keeps the values it was built with: reading it imports neither
      ``jax`` nor ``optax``, and ``utils.weights.optimizer_state_from_jax``
      turns the stubs into the port optimiser's state.

It writes format (a), the fork's layout, so that ``cli/generate``, this
reader and JAX's ``cli/import_fairseq_checkpoint`` all read it: ``args``
(the namespace), ``model`` (the state dict on the CPU),
``optimizer_history`` (the fork's list of {criterion_name, optimizer_name,
lr_scheduler_state, num_updates}), ``last_optimizer_state`` (the torch
optimiser's state dict), ``last_optimizer_param_names`` (the parameters in
the optimiser's order) and ``extra_state`` (the iterator position, the
val loss, the metrics and ``best``), under JAX's file names and retention
rules. ``load_checkpoint`` resumes from each kind of file: the port's own,
a JAX pickle (with its optimiser state), and a fork ``.pt`` (model only:
its optimiser state raises unless ``--reset-optimizer``, since the port
cannot show that its parameter order is the fork's). JAX's sharded
checkpoint (a directory, ``train/sharded_checkpoint.py``) reads as its
pickle does, optimiser state included; ``--checkpoint-format sharded``
writes the port's state in that layout, on a background thread with
``--async-checkpoint`` (``wait_for_async_writes`` before the next save, a
resume and the end of training, as JAX :73). ``load_checkpoint`` with
``--allow-partial-restore`` restores what the checkpoint and the model
share (``merge_partial_state``, JAX :274-311), and
``load_model_ensemble_and_task`` keeps the layers of
``--encoder-layers-to-keep`` / ``--decoder-layers-to-keep``
(``prune_layers``, JAX :428-456).
"""

from __future__ import annotations

import argparse
import collections
import logging
import os
import pickle
import re
import shutil
import tempfile
from typing import Any, Dict, List, Optional

import torch

from ..ops.core import weights_from_state_dict
from ..quantization.pq import adopt_pq_layout
from ..utils.weights import optimizer_state_from_jax, state_dict_from_jax
from . import metrics
from . import sharded_checkpoint as sharded

logger = logging.getLogger(__name__)

_SAFE_MODULES = ("numpy", "builtins", "collections", "copyreg", "argparse", "_codecs")
# entries of a fork state dict that no module of the port holds
_FORK_BOOKKEEPING = (".version", "._float_tensor", ".num_batches_tracked")


class _Stub:
    """A class the reader does not import. It keeps what it was built with:
    the positional arguments (a NamedTuple such as optax's
    ``ScaleByAdamState(count, mu, nu)`` pickles its fields as the arguments
    of ``copyreg.__newobj__``) in ``args``, the keyword ones in ``kwargs``,
    and the state a plain class pickles (``__setstate__``) in ``state``."""

    def __new__(cls, *args, **kwargs):
        obj = object.__new__(cls)
        obj.__dict__.update(args=args, kwargs=kwargs, state=None)
        return obj

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        self.__dict__["state"] = state


class _SafeUnpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        if module.split(".")[0] in _SAFE_MODULES:
            return super().find_class(module, name)
        return type(name, (_Stub,), {"__module__": "stub." + module})


def _is_torch_file(path: str) -> bool:
    with open(path, "rb") as f:
        head = f.read(4)
    return head == b"PK\x03\x04"  # torch.save's zip container


def load_checkpoint_to_cpu(path: str) -> Dict[str, Any]:
    """The checkpoint's dict with ``args`` as a namespace and ``model`` a
    state dict of CPU tensors under the port's (the fork's) names, from
    either format."""
    if os.path.isdir(path):
        if not sharded.is_sharded_checkpoint(path):
            raise FileNotFoundError(f"{path}: a directory without {sharded._MANIFEST}")
        state = sharded.load_sharded(path, _SafeUnpickler)
        if "last_optimizer_param_names" in state:
            return _port_state_from_sharded(state)
    elif _is_torch_file(path):
        state = torch.load(path, map_location="cpu", weights_only=False)
        state["format"] = "port" if "last_optimizer_param_names" in state else "fork"
        return upgrade_fork_state(state)
    else:
        with open(path, "rb") as f:
            state = _SafeUnpickler(f).load()
    args = state.get("args") or {}
    state["args"] = argparse.Namespace(**args) if isinstance(args, dict) else args
    state["params_tree"] = state["model"]
    state["model"] = state_dict_from_jax({"params": state["model"], "state": state.get("model_state") or {}})
    state["format"] = "jax"
    return state


def _port_state_from_sharded(state: Dict[str, Any]) -> Dict[str, Any]:
    """The port's own sharded state as its ``.pt`` holds it: the state
    dict and the optimiser's state dict of tensors."""
    state["model"] = {k: torch.from_numpy(v) for k, v in state["model"].items()}
    per_param = (state.pop("opt_state") or {}).get("state") or []
    rest = state.pop("optimizer_state_rest", {})
    groups = state.pop("optimizer_param_groups", None)
    if groups is not None:
        tensors = {i: {k: torch.from_numpy(v) for k, v in entry.items()} for i, entry in enumerate(per_param)
                   if entry is not None}
        index = sorted(set(tensors) | set(rest))
        state["last_optimizer_state"] = {"state": {i: {**rest.get(i, {}), **tensors.get(i, {})} for i in index},
                                         "param_groups": groups}
    state["format"] = "port"
    return upgrade_fork_state(state)


def _sharded_state(state: Dict[str, Any]) -> Dict[str, Any]:
    """The port's checkpoint dict as ``sharded_checkpoint.save_sharded``
    takes it: the state dict as the ``model`` tree, the optimiser's
    per-parameter tensors as ``opt_state`` and everything else as meta."""
    out = {k: v for k, v in state.items() if k != "last_optimizer_state"}
    opt = state.get("last_optimizer_state")
    if opt is not None:
        tensors, rest = {}, {}
        for i, entry in opt["state"].items():
            tensors[str(i)] = {k: v for k, v in entry.items() if isinstance(v, torch.Tensor)}
            rest[i] = {k: v for k, v in entry.items() if not isinstance(v, torch.Tensor)}
        out["opt_state"] = {"state": tensors}
        out["optimizer_state_rest"] = rest
        out["optimizer_param_groups"] = opt["param_groups"]
    return out


def upgrade_fork_state(state: Dict[str, Any]) -> Dict[str, Any]:
    """The renames of the fork's ``_upgrade_state_dict``
    (checkpoint_utils.py:288-364) and ``raw_state_dict_upgrade``
    (conv_transformer.py:105-112) that rebuild a ported model: legacy arg
    names (``max_positions``, the task, ``raw_text`` / ``lazy_load``), a
    CTC head kept under the pre-refactor criterion moved into
    ``encoder.ctc_fc``, and the fork's bookkeeping entries dropped."""
    args = state.get("args")
    if args is None:
        raise ValueError("checkpoint has no args; cannot rebuild the model")
    if isinstance(args, dict):
        args = state["args"] = argparse.Namespace(**args)
    if hasattr(args, "max_positions") and not hasattr(args, "max_source_positions"):
        args.max_source_positions = args.max_target_positions = args.max_positions
    if not hasattr(args, "task"):
        args.task = "translation"
    if getattr(args, "raw_text", False):
        args.dataset_impl = "raw"
    elif getattr(args, "lazy_load", False):
        args.dataset_impl = "lazy"
    model_sd = {k: v for k, v in state["model"].items() if not k.endswith(_FORK_BOOKKEEPING)}
    crit_sd = state.get("criterion") or {}
    if (getattr(args, "ctc_compress_out", False) and "encoder.ctc_fc.weight" not in model_sd
            and "ctc_aware_model.fc_out.weight" in crit_sd):
        model_sd["encoder.ctc_fc.weight"] = crit_sd["ctc_aware_model.fc_out.weight"]
        model_sd["encoder.ctc_fc.bias"] = crit_sd["ctc_aware_model.fc_out.bias"]
    state["model"] = model_sd
    return state


def load_model_ensemble_and_task(filenames: List[str], arg_overrides: Optional[Dict[str, Any]] = None, task=None,
                                 device=None):
    """Rebuild each checkpoint's model from its args (reference
    checkpoint_utils.py:181-215) on ``device`` (the CUDA card when None),
    without the seeded init draws that the strict load of its weights
    would overwrite, and with the checkpoint's iPQ layers, in eval mode.
    Returns (models, the last args, task); the task is set up from the
    first checkpoint's args when None is given."""
    from ..registry import TASKS

    models, args = [], None
    for filename in filenames:
        state = load_checkpoint_to_cpu(filename)
        args = state["args"]
        for k, v in (arg_overrides or {}).items():
            setattr(args, k, v)
        model_sd = state["model"]
        if getattr(args, "encoder_layers_to_keep", None) or getattr(args, "decoder_layers_to_keep", None):
            model_sd = prune_layers(model_sd, args)
        if task is None:
            task = TASKS[args.task].setup_task(args)
        with weights_from_state_dict():  # every weight comes from the strict load below
            model = task.build_model(args, device=device)
        adopt_pq_layout(model, model_sd)  # iPQ layers (--quantization-config-path) as the checkpoint holds them
        model.load_state_dict(model_sd, strict=True)
        models.append(model.eval())
    return models, args, task


def prune_layers(model_sd: Dict[str, torch.Tensor], args) -> Dict[str, torch.Tensor]:
    """Keep the layers ``--encoder-layers-to-keep`` / ``--decoder-layers-to-keep``
    list (comma-separated indices) of the state dict, renumbered from 0,
    and set ``args.<side>_layers`` to their count (JAX's ``prune_layers``,
    reference checkpoint_utils.prune_state_dict). The layers are the
    entries ``<side>.layers.<i>.*``."""
    for side in ("encoder", "decoder"):
        spec = getattr(args, f"{side}_layers_to_keep", None)
        if not spec:
            continue
        keep = sorted(int(x) for x in str(spec).split(","))
        renumber = {old: new for new, old in enumerate(keep)}
        layer = re.compile(re.escape(side) + r"\.layers\.(\d+)\.(.*)")
        pruned = {}
        for name, value in model_sd.items():
            m = layer.fullmatch(name)
            if m is None:
                pruned[name] = value
            elif int(m.group(1)) in renumber:
                pruned[f"{side}.layers.{renumber[int(m.group(1))]}.{m.group(2)}"] = value
        model_sd = pruned
        setattr(args, f"{side}_layers", len(keep))
        setattr(args, f"{side}_layers_to_keep", None)
    return model_sd


def merge_partial_state(model_sd: Dict[str, torch.Tensor], ckpt_sd: Dict[str, torch.Tensor]):
    """``--allow-partial-restore`` (JAX :274-311, the fork's
    checkpoint_utils.py:138): the checkpoint's entries the model has, the
    model's own where the checkpoint lacks them; a shape that differs
    raises. Returns (merged, missing names, unexpected names)."""
    merged, missing = {}, []
    for name, value in model_sd.items():
        if name in ckpt_sd:
            got, want = tuple(ckpt_sd[name].shape), tuple(value.shape)
            if got != want:
                raise ValueError(f"partial restore: param '{name}' has shape {got} in the checkpoint but {want} "
                                 "in the model")
            merged[name] = ckpt_sd[name]
        else:
            merged[name] = value
            missing.append(name)
    unexpected = [name for name in ckpt_sd if name not in model_sd]
    return merged, missing, unexpected


def load_model_ensemble(filenames: List[str], arg_overrides=None, task=None, device=None):
    models, args, _ = load_model_ensemble_and_task(filenames, arg_overrides, task, device)
    return models, args


def save_model_checkpoint(path: str, args: argparse.Namespace, model: torch.nn.Module) -> None:
    """A fork-layout ``.pt`` of the model alone: {args, model (its state
    dict on the CPU), optimizer_history [], extra_state {}}."""
    save_state(path, {"args": args, "model": {k: v.detach().cpu() for k, v in model.state_dict().items()},
                      "optimizer_history": [], "extra_state": {}})


def average_checkpoints(inputs: List[str]) -> Dict[str, Any]:
    """Offline checkpoint averaging (JAX :497-518, reference
    scripts/average_checkpoints.py:15-64): the mean of every entry of the
    model's state dict over ``inputs``, any files ``load_checkpoint_to_cpu``
    reads (the port's, JAX pickles, fork ``.pt`` files; all with the same
    entries). A float entry is summed in float64 and written in float32, as
    JAX does. An integer entry is summed and floor-divided by the count, as
    the reference divides ``num_batches_tracked``: JAX's tree has no such
    leaf, and neither do the port's models, whose reader drops the fork's.
    The BatchNorm running statistics are averaged as the reference averages
    them; JAX averages its params tree only and keeps the last file's
    ``model_state``. Every other entry is the last file's; from a JAX pickle
    the result is the fork layout of the averaged model alone (its optax
    state has no torch form)."""
    sums, state = None, None
    for path in inputs:
        state = load_checkpoint_to_cpu(path)
        model = state["model"]
        if sums is None:
            sums = {k: v.to(torch.float64 if v.is_floating_point() else torch.int64) for k, v in model.items()}
            dtypes = {k: v.dtype for k, v in model.items()}
        elif sorted(model) != sorted(sums):
            raise KeyError(f"For checkpoint {path}, expected list of params: {sorted(sums)}, but found: "
                           f"{sorted(model)}")
        else:
            for k, v in model.items():
                sums[k] += v.to(sums[k].dtype)
    n = len(inputs)
    averaged = {k: (v / n).to(torch.float32) if v.is_floating_point() else (v // n).to(dtypes[k])
                for k, v in sums.items()}
    if state.pop("format") == "jax":
        return {"args": state["args"], "model": averaged, "optimizer_history": [], "extra_state": {}}
    state["model"] = averaged
    return state


# ---------------------------------------------------------------------------
# saving and resuming training
# ---------------------------------------------------------------------------

class CheckpointManager:
    """The best validation metric so far (reference ``save_checkpoint.best``)."""

    def __init__(self):
        self.best: Optional[float] = None


_manager = CheckpointManager()


_async_writer: Optional[sharded.AsyncCheckpointWriter] = None


def wait_for_async_writes() -> None:
    """Wait for the checkpoint write in flight, if any; its error raises here."""
    if _async_writer is not None:
        _async_writer.wait()


def save_state(path: str, state: Dict[str, Any]) -> None:
    """``torch.save`` of ``state`` to ``path`` through a temporary file."""
    tmp = path + ".tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)


def save_checkpoint(args, trainer, epoch_itr, val_loss) -> None:
    """Write the checkpoints JAX :86-258 writes, under its names: ``checkpoint{epoch}.pt``
    at the end of an epoch (every ``--save-interval``), ``checkpoint_{epoch}_{updates}.pt``
    inside one (every ``--save-interval-updates``), ``checkpoint_best.pt`` and
    ``checkpoint.best_{metric}_{val:.2f}.pt`` (``--keep-best-checkpoints``) when the val
    loss is the best so far, and ``checkpoint_last.pt``, each with ``--checkpoint-suffix``
    before ``.pt``; then drop the oldest past ``--keep-interval-updates`` /
    ``--keep-last-epochs`` / ``--keep-best-checkpoints``. With
    ``--checkpoint-format sharded`` each is a directory
    (``sharded_checkpoint``), written on a background thread under
    ``--async-checkpoint``, which then drops the old ones once its files
    are there."""
    if getattr(args, "no_save", False):
        return
    best_function = max if getattr(args, "maximize_best_checkpoint_metric", False) else min
    prev_best = _manager.best if _manager.best is not None else val_loss
    if val_loss is not None:
        _manager.best = best_function(val_loss, prev_best)

    save_dir = args.save_dir
    os.makedirs(save_dir, exist_ok=True)
    end_of_epoch = epoch_itr.end_of_epoch()
    epoch = epoch_itr.epoch
    updates = trainer.get_num_updates()
    save_interval_updates = getattr(args, "save_interval_updates", 0)
    conds = collections.OrderedDict()
    conds[f"checkpoint{epoch}.pt"] = (end_of_epoch and not getattr(args, "no_epoch_checkpoints", False)
                                      and epoch % getattr(args, "save_interval", 1) == 0)
    conds[f"checkpoint_{epoch}_{updates}.pt"] = (not end_of_epoch and save_interval_updates > 0
                                                 and updates % save_interval_updates == 0)
    conds["checkpoint_best.pt"] = val_loss is not None and (_manager.best is None or val_loss == _manager.best)
    if val_loss is not None and getattr(args, "keep_best_checkpoints", -1) > 0:
        name = "checkpoint.best_{}_{:.2f}.pt".format(getattr(args, "best_checkpoint_metric", "loss"), val_loss)
        conds[name] = _manager.best is None or val_loss == _manager.best
    conds["checkpoint_last.pt"] = not getattr(args, "no_last_checkpoints", False)
    suffix = getattr(args, "checkpoint_suffix", "") or ""
    if suffix:
        conds = collections.OrderedDict((fn[: -len(".pt")] + suffix + ".pt", c) for fn, c in conds.items())

    extra_state = {"train_iterator": epoch_itr.state_dict(), "val_loss": val_loss, "metrics": metrics.state_dict()}
    if _manager.best is not None:
        extra_state["best"] = _manager.best
    checkpoints = [os.path.join(save_dir, fn) for fn, cond in conds.items() if cond]
    if checkpoints:
        # every rank takes part in gathering a split layout; the first writes
        fetched = trainer.state_for_checkpoint()
        if not trainer.is_first_rank:
            return
        if "bmuf" in fetched:
            extra_state["bmuf"] = fetched["bmuf"]
        state = {
            "args": args,
            "model": fetched["model"],
            "optimizer_history": [{
                "criterion_name": type(trainer.criterion).__name__,
                "optimizer_name": type(trainer.optimizer).__name__,
                "lr_scheduler_state": fetched["lr_scheduler"],
                "num_updates": fetched["num_updates"],
            }],
            "last_optimizer_state": fetched["optimizer"],
            "last_optimizer_param_names": trainer.param_names(),
            "extra_state": extra_state,
        }
        if getattr(args, "checkpoint_format", "pickle") == "sharded":
            if getattr(args, "async_checkpoint", False):
                global _async_writer
                if _async_writer is None:
                    _async_writer = sharded.AsyncCheckpointWriter()
                _async_writer.save(checkpoints, _sharded_state(state),
                                   on_complete=lambda: _collect_garbage(args, save_dir))
                logger.info("async checkpoint save started: {} (epoch {} @ {} updates)".format(
                    checkpoints[0], epoch, updates))
                return
            sharded.save_sharded(checkpoints, _sharded_state(state))
        else:
            save_state(checkpoints[0], state)
            for cp in checkpoints[1:]:
                shutil.copyfile(checkpoints[0], cp + ".tmp")
                os.replace(cp + ".tmp", cp)
        logger.info("saved checkpoint {} (epoch {} @ {} updates)".format(checkpoints[0], epoch, updates))
    if trainer.is_first_rank and not (getattr(args, "checkpoint_format", "pickle") == "sharded"
                                      and getattr(args, "async_checkpoint", False)):
        _collect_garbage(args, save_dir)


def _collect_garbage(args, save_dir: str) -> None:
    sfx = re.escape(getattr(args, "checkpoint_suffix", "") or "")
    keep = getattr(args, "keep_interval_updates", -1)
    if keep > 0:
        for old in checkpoint_paths(save_dir, pattern=r"checkpoint_\d+_(\d+)" + sfx + r"\.pt")[keep:]:
            sharded.clear_path(old)
    keep = getattr(args, "keep_last_epochs", -1)
    if keep > 0:
        for old in checkpoint_paths(save_dir, pattern=r"checkpoint(\d+)" + sfx + r"\.pt")[keep:]:
            sharded.clear_path(old)
    keep = getattr(args, "keep_best_checkpoints", -1)
    if keep > 0:
        found = checkpoint_paths(save_dir, pattern=r"checkpoint\.best_{}_(\d+\.?\d*){}\.pt".format(
            getattr(args, "best_checkpoint_metric", "loss"), sfx))
        if not getattr(args, "maximize_best_checkpoint_metric", False):
            found = found[::-1]
        for old in found[keep:]:
            sharded.clear_path(old)


def checkpoint_paths(path: str, pattern: str = r"checkpoint(\d+)\.pt") -> List[str]:
    """The files of ``path`` matching ``pattern``, by its first group,
    largest first (reference checkpoint_utils.py checkpoint_paths)."""
    pt_regexp = re.compile(pattern)
    entries = []
    for f in os.listdir(path):
        m = pt_regexp.fullmatch(f)
        if m is not None:
            idx = float(m.group(1)) if len(m.groups()) > 0 else 0
            entries.append((idx, m.group(0)))
    return [os.path.join(path, x[1]) for x in sorted(entries, reverse=True)]


def training_state(state: Dict[str, Any], trainer, reset_optimizer: bool) -> Dict[str, Any]:
    """What ``Trainer.load_trainer_state`` restores, from a checkpoint of
    any of the three kinds ``load_checkpoint_to_cpu`` reads."""
    kind = state.get("format")
    if kind == "jax":
        optimizer = None
        if not reset_optimizer and state.get("opt_state") is not None:
            optimizer = optimizer_state_from_jax(state["opt_state"], state["params_tree"], trainer.model,
                                                 trainer.optimizer)
        return {"model": state["model"], "optimizer": optimizer, "lr_scheduler": state.get("lr_scheduler"),
                "num_updates": 0 if reset_optimizer else state.get("num_updates", 0)}
    history = (state.get("optimizer_history") or [{}])[-1]
    optimizer = None
    if not reset_optimizer and state.get("last_optimizer_state") is not None:
        if kind != "port":
            raise NotImplementedError(
                "restoring the optimiser state of a fork checkpoint: the port cannot show that its parameter "
                "order is the fork's; pass --reset-optimizer to restore the model alone")
        if trainer.param_names() != state["last_optimizer_param_names"]:
            raise ValueError("the checkpoint's optimiser holds other parameters than this model's; "
                             "pass --reset-optimizer to restore the model alone")
        optimizer = state["last_optimizer_state"]
    return {"model": state["model"], "optimizer": optimizer, "lr_scheduler": history.get("lr_scheduler_state"),
            "num_updates": 0 if reset_optimizer else history.get("num_updates", 0),
            "bmuf": None if reset_optimizer else (state.get("extra_state") or {}).get("bmuf")}


def load_checkpoint(args, trainer, task):
    """Load ``checkpoint_last`` (or ``--restore-file``) into the trainer and
    build the train iterator at its position: JAX :313-399 with the four
    ``--reset-*`` flags and ``--allow-partial-restore``. Returns
    (extra_state, epoch_itr)."""
    wait_for_async_writes()
    reset_optimizer = getattr(args, "reset_optimizer", False)
    reset_lr_scheduler = getattr(args, "reset_lr_scheduler", False)
    reset_meters = getattr(args, "reset_meters", False)
    reset_dataloader = getattr(args, "reset_dataloader", False)
    restore_file = getattr(args, "restore_file", "checkpoint_last.pt")
    suffix = getattr(args, "checkpoint_suffix", "") or ""
    if suffix and restore_file == "checkpoint_last.pt":
        restore_file = "checkpoint_last" + suffix + ".pt"
    path = restore_file if os.path.isabs(restore_file) else os.path.join(args.save_dir, restore_file)

    extra_state = None
    if os.path.exists(path):
        state = load_checkpoint_to_cpu(path)
        if trainer.adopt_quantized_layout(state["model"]):
            logger.info("the checkpoint's iPQ layers swapped in; a fresh optimizer over their parameters")
        if getattr(args, "allow_partial_restore", False):
            own = trainer.full_model_state()
            state["model"], missing, unexpected = merge_partial_state(own, state["model"])
            if missing:
                logger.warning("partial restore: %d params missing from the checkpoint keep their fresh "
                               "initialization: %s", len(missing), ", ".join(missing[:8]))
            if unexpected:
                logger.warning("partial restore: %d checkpoint params have no counterpart in the model and "
                               "were dropped: %s", len(unexpected), ", ".join(unexpected[:8]))
            if (missing or unexpected) and not reset_optimizer:
                # the saved moments belong to the checkpoint's parameters
                logger.warning("partial restore changed the param tree; resetting the optimizer state")
                reset_optimizer = True
        trainer.load_trainer_state(training_state(state, trainer, reset_optimizer),
                                   reset_optimizer=reset_optimizer, reset_lr_scheduler=reset_lr_scheduler)
        extra_state = state.get("extra_state")
        if extra_state is not None and not reset_meters:
            if "best" in extra_state:
                _manager.best = extra_state["best"]
            if extra_state.get("metrics"):
                metrics.load_state_dict(extra_state["metrics"])
        logger.info("loaded checkpoint {} ({} updates)".format(path, trainer.get_num_updates()))
    else:
        logger.info("no existing checkpoint found {}".format(path))

    epoch = 0
    if extra_state is not None and not reset_dataloader and "train_iterator" in extra_state:
        epoch = extra_state["train_iterator"]["epoch"]
    epoch_itr = get_train_iterator(args, trainer, task, epoch=epoch)
    if extra_state is not None and not reset_dataloader and "train_iterator" in extra_state:
        epoch_itr.load_state_dict(extra_state["train_iterator"])
    return extra_state, epoch_itr


def get_train_iterator(args, trainer, task, epoch: int = 0):
    """The training split's epoch iterator, batches padded to the shape
    buckets as JAX's are."""
    return task.get_batch_iterator(
        dataset=task.dataset(getattr(args, "train_subset", "train")), max_tokens=getattr(args, "max_tokens", None),
        max_sentences=getattr(args, "max_sentences", None), max_positions=task.max_positions(),
        ignore_invalid_inputs=True, required_batch_size_multiple=getattr(args, "required_batch_size_multiple", 8),
        seed=getattr(args, "seed", 1), num_shards=1, shard_id=0, epoch=epoch, bucket_shapes=True)


def verify_checkpoint_directory(save_dir: str) -> None:
    """Write-probe the save directory (reference checkpoint_utils.py:488-499)."""
    os.makedirs(save_dir, exist_ok=True)
    try:
        with tempfile.NamedTemporaryFile(dir=save_dir, prefix="dummy", delete=True):
            pass
    except OSError as e:
        logger.error(f"Unable to access checkpoint save directory: {save_dir}")
        raise e
