"""Checkpoints: reading a model ensemble, and a model-only writer.

Counterpart of ``fbk_fairseq_st_tpu/train/checkpoint.py``
(``load_checkpoint_to_cpu`` :53, ``load_model_ensemble_and_task``
:458-495) for two formats:

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
      and ``argparse`` through and turns every other class into an inert
      stub: reading it imports neither ``jax`` nor ``optax``.

JAX's sharded checkpoint (a directory) raises ``NotImplementedError``.
``save_model_checkpoint`` writes format (a) with the model alone; the
training state's saving comes with ``cli/train`` (ROADMAP Queue A item 3).
"""

from __future__ import annotations

import argparse
import os
import pickle
from typing import Any, Dict, List, Optional

import torch

from ..utils.weights import state_dict_from_jax

_SAFE_MODULES = ("numpy", "builtins", "collections", "copyreg", "argparse", "_codecs")
# entries of a fork state dict that no module of the port holds
_FORK_BOOKKEEPING = (".version", "._float_tensor", ".num_batches_tracked")


class _Stub:
    """A class the reader does not import: takes any arguments and state."""

    def __new__(cls, *args, **kwargs):
        return object.__new__(cls)

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        self.__dict__["_state"] = state


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
        raise NotImplementedError(f"{path}: the sharded checkpoint format is not ported (ROADMAP Queue A item 3)")
    if _is_torch_file(path):
        state = torch.load(path, map_location="cpu", weights_only=False)
        return upgrade_fork_state(state)
    with open(path, "rb") as f:
        state = _SafeUnpickler(f).load()
    args = state.get("args") or {}
    state["args"] = argparse.Namespace(**args) if isinstance(args, dict) else args
    state["model"] = state_dict_from_jax({"params": state["model"], "state": state.get("model_state") or {}})
    return state


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
    its weights loaded strictly, in eval mode. Returns (models, the last
    args, task); the task is set up from the first checkpoint's args when
    None is given."""
    from ..registry import TASKS

    models, args = [], None
    for filename in filenames:
        state = load_checkpoint_to_cpu(filename)
        args = state["args"]
        for k, v in (arg_overrides or {}).items():
            setattr(args, k, v)
        if task is None:
            task = TASKS[args.task].setup_task(args)
        model = task.build_model(args, device=device)
        model.load_state_dict(state["model"], strict=True)
        models.append(model.eval())
    return models, args, task


def load_model_ensemble(filenames: List[str], arg_overrides=None, task=None, device=None):
    models, args, _ = load_model_ensemble_and_task(filenames, arg_overrides, task, device)
    return models, args


def save_model_checkpoint(path: str, args: argparse.Namespace, model: torch.nn.Module) -> None:
    """A fork-layout ``.pt`` of the model alone: {args, model (its state
    dict on the CPU), optimizer_history [], extra_state {}}."""
    state = {"args": args, "model": {k: v.detach().cpu() for k, v in model.state_dict().items()},
             "optimizer_history": [], "extra_state": {}}
    tmp = path + ".tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)
