"""Import a fork (fairseq-style) ``.pt`` into the port's own checkpoint.

The port's counterpart of ``fbk_fairseq_st_tpu/cli/import_fairseq_checkpoint.py``
(``utils/fairseq_interop.py::import_fairseq_checkpoint`` :324-377): the
fork's state is upgraded as the reader upgrades it
(``train/checkpoint.py::upgrade_fork_state``: legacy arg names, the CTC
head kept under the criterion), the model is rebuilt from the checkpoint's
args (``--model-overrides`` first) on the CPU, with dictionaries from the
task's data directory or, where it cannot be read, stand-ins sized by the
checkpoint's embedding tables, and the weights are loaded into it
strictly (``--non-strict``: the model's entries the file lacks keep their
initialisation). The report lists those (``missing``) and the file's
entries the model does not take (``unused``; the fork's bookkeeping
buffers aside). The output is the port's checkpoint of the model alone,
which ``cli/generate``, ``cli/train --restore-file`` and this package's
other readers take.

    python -m fbk_fairseq_st_tpu_torch.cli.import_fairseq_checkpoint fork_checkpoint.pt checkpoint.pt \\
        [--model-overrides '{"arch": "..."}'] [--non-strict]
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
from typing import Any, Dict, List, Optional

import torch

from .. import registry
from ..data.dictionary import Dictionary
from ..models import arch_defaults, build_model
from ..train.checkpoint import _FORK_BOOKKEEPING, save_state, upgrade_fork_state

logger = logging.getLogger(__name__)


def _dummy_dictionary(vocab_size: int) -> Dictionary:
    d = Dictionary()
    for i in range(vocab_size - d.nspecial):
        d.add_symbol(f"w{i}")
    return d


def _dictionaries(args, model_sd):
    """(target, source) dictionaries: the task's, or stand-ins of the
    checkpoint's embedding sizes (JAX ``_setup_task``)."""
    try:
        task = registry.TASKS[args.task].setup_task(args)
        return task.target_dictionary, task.source_dictionary
    except (OSError, KeyError, ValueError, AttributeError) as e:
        logger.info("task setup from args.data failed (%s); synthesizing dictionaries from checkpoint shapes", e)
    tgt_vocab = next((model_sd[k].shape[0] for k in ("decoder.embed_tokens.weight", "decoder.embed_out",
                                                      "decoder.output_projection.weight") if k in model_sd), None)
    if tgt_vocab is None:
        raise ValueError("cannot infer target vocab from checkpoint")
    src_dict = None
    if "encoder.ctc_fc.weight" in model_sd:
        src_dict = _dummy_dictionary(model_sd["encoder.ctc_fc.weight"].shape[0])
    elif "auxiliary_decoder.embed_tokens.weight" in model_sd:
        src_dict = _dummy_dictionary(model_sd["auxiliary_decoder.embed_tokens.weight"].shape[0])
    return _dummy_dictionary(tgt_vocab), src_dict


def import_fairseq_checkpoint(input_path: str, output_path: str, arg_overrides: Optional[Dict[str, Any]] = None,
                              strict: bool = True) -> Dict[str, List[str]]:
    """Write the port's checkpoint of the fork ``.pt`` at ``input_path``;
    returns the report {"missing", "unused"}."""
    state = upgrade_fork_state(torch.load(input_path, map_location="cpu", weights_only=False))
    args = state["args"]
    for k, v in (arg_overrides or {}).items():
        setattr(args, k, v)
    registry.apply_architecture(args)
    tgt_dict, src_dict = _dictionaries(args, state["model"])
    options = {k: getattr(args, k) for k in arch_defaults(args.arch) if hasattr(args, k)}
    model = build_model(args.arch, tgt_dict, src_dict, device="cpu", seed=getattr(args, "seed", 1), **options)
    own = model.state_dict()
    fork_sd = state["model"]
    missing = [k for k in own if k not in fork_sd]
    unused = [k for k in fork_sd if k not in own and not k.endswith(_FORK_BOOKKEEPING)]
    if strict and missing:
        raise ValueError("unported parameters (pass strict=False to keep their random init): "
                         + "; ".join(missing[:10]))
    if unused:
        logger.warning("fork tensors not consumed: %s", unused[:10])
    model.load_state_dict({k: v for k, v in fork_sd.items() if k in own}, strict=strict)
    extra = state.get("extra_state") or {}
    save_state(output_path, {
        "args": args, "model": {k: v.detach().cpu() for k, v in model.state_dict().items()},
        "optimizer_history": [], "last_optimizer_state": None, "last_optimizer_param_names": [],
        "extra_state": {"imported_from": input_path, "val_loss": extra.get("val_loss")}})
    logger.info("imported %s -> %s (%d fork tensors, %d unused, %d missing)", input_path, output_path,
                len(fork_sd), len(unused), len(missing))
    return {"missing": missing, "unused": unused}


def get_parser():
    parser = argparse.ArgumentParser(description="Convert a fork .pt checkpoint to this framework's format")
    parser.add_argument("input", help="fork checkpoint (.pt, torch.save)")
    parser.add_argument("output", help="output framework checkpoint path")
    parser.add_argument("--model-overrides", default="{}",
                        help="JSON dict of args to override before rebuilding the model "
                             "(reference --model-overrides semantics)")
    parser.add_argument("--non-strict", action="store_true",
                        help="keep random init for parameters with no fork counterpart instead of erroring")
    return parser


def main(args) -> Dict[str, List[str]]:
    report = import_fairseq_checkpoint(args.input, args.output, arg_overrides=json.loads(args.model_overrides),
                                       strict=not args.non_strict)
    if report["missing"]:
        print(f"| WARNING: {len(report['missing'])} parameters kept their random initialization:", file=sys.stderr)
        for name in report["missing"]:
            print(f"|   {name}", file=sys.stderr)
    print(f"| imported {args.input} -> {args.output}")
    return report


def cli_main(argv=None):
    logging.basicConfig(level=logging.INFO)
    return main(get_parser().parse_args(argv))


if __name__ == "__main__":
    cli_main()
