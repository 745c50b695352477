"""Export any checkpoint the port reads to the fork's ``torch.save``
layout: {args, model, optimizer_history, extra_state}.

The port's counterpart of ``fbk_fairseq_st_tpu/cli/export_fairseq_checkpoint.py``
(``utils/fairseq_interop.py::export_fairseq_checkpoint`` :417-452): the
input is read by ``train/checkpoint.py::load_checkpoint_to_cpu`` (the
port's own file, a fork ``.pt``, a JAX pickle or a sharded directory),
whose model is already the state dict under the fork's names, and written
with its args and extra state, without optimiser history. The fork's
bookkeeping buffers are not written, as JAX writes none: the fork loads
such a file with ``strict=False``.

    python -m fbk_fairseq_st_tpu_torch.cli.export_fairseq_checkpoint checkpoint.pt fork_checkpoint.pt
"""

from __future__ import annotations

import argparse
import logging

import torch

from ..train.checkpoint import load_checkpoint_to_cpu

logger = logging.getLogger(__name__)


def export_fairseq_checkpoint(input_path: str, output_path: str) -> int:
    """Write the fork ``.pt`` of ``input_path``; returns its tensor count."""
    state = load_checkpoint_to_cpu(input_path)
    model_sd = {k: v.contiguous() for k, v in state["model"].items()}
    torch.save({"args": state["args"], "model": model_sd, "optimizer_history": [],
                "extra_state": dict(state.get("extra_state") or {})}, output_path)
    logger.info("exported %s -> %s (%d tensors)", input_path, output_path, len(model_sd))
    return len(model_sd)


def cli_main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser(description="Convert a framework checkpoint to the fork's format")
    parser.add_argument("input", help="checkpoint (the port's, a fork .pt, a JAX pickle or sharded directory)")
    parser.add_argument("output", help="output torch .pt path")
    args = parser.parse_args(argv)
    n = export_fairseq_checkpoint(args.input, args.output)
    print(f"| exported {args.input} -> {args.output} ({n} tensors)")


if __name__ == "__main__":
    cli_main()
