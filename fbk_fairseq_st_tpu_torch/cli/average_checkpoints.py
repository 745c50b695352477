"""Average the model parameters of several checkpoints into a new one.

The port's copy of ``fbk_fairseq_st_tpu/cli/average_checkpoints.py``
(reference scripts/average_checkpoints.py): ``--inputs`` names the files,
or one directory from which ``--num-epoch-checkpoints N`` takes the last N
``checkpoint<epoch>.pt`` and ``--num-update-checkpoints N`` the last N
``checkpoint_<epoch>_<update>.pt`` (at most ``--checkpoint-upper-bound``).
The mean is ``train/checkpoint.py::average_checkpoints``'s, written in the
fork's ``.pt`` layout that ``cli/generate`` reads. No device is used:

    python -m fbk_fairseq_st_tpu_torch.cli.average_checkpoints --inputs checkpoints \\
        --num-epoch-checkpoints 5 --output checkpoints/avg5.pt
"""

from __future__ import annotations

import argparse
import logging
import os
import re
import sys

from ..train.checkpoint import average_checkpoints, save_state

logger = logging.getLogger("fbk_fairseq_st_tpu_torch.cli.average_checkpoints")


def last_n_checkpoints(paths, n, update_based=False, upper_bound=None):
    """The last ``n`` epoch (or update) checkpoints of the one directory in
    ``paths``, newest first (reference average_checkpoints.py:68-95)."""
    assert len(paths) == 1
    path = paths[0]
    pt_regexp = re.compile(r"checkpoint_\d+_(\d+)\.pt" if update_based else r"checkpoint(\d+)\.pt")
    entries = []
    for f in os.listdir(path):
        m = pt_regexp.fullmatch(f)
        if m is not None:
            sort_key = int(m.group(1))
            if upper_bound is None or sort_key <= upper_bound:
                entries.append((sort_key, m.group(0)))
    if len(entries) < n:
        raise Exception(f"Found {len(entries)} checkpoint files but need at least {n}")
    return [os.path.join(path, x[1]) for x in sorted(entries, reverse=True)[:n]]


def cli_main(input_args=None):
    logging.basicConfig(format="%(asctime)s | %(levelname)s | %(name)s | %(message)s",
                        datefmt="%Y-%m-%d %H:%M:%S", level=logging.INFO, stream=sys.stdout)
    parser = argparse.ArgumentParser(description="Average the params of input checkpoints to produce a new checkpoint")
    parser.add_argument("--inputs", required=True, nargs="+",
                        help="Input checkpoint file paths, or a directory with "
                             "--num-epoch-checkpoints/--num-update-checkpoints")
    parser.add_argument("--output", required=True, metavar="FILE", help="Write the new checkpoint to this path.")
    parser.add_argument("--num-epoch-checkpoints", type=int, default=None, metavar="N")
    parser.add_argument("--num-update-checkpoints", type=int, default=None, metavar="N")
    parser.add_argument("--checkpoint-upper-bound", type=int, default=None)
    args = parser.parse_args(input_args)

    update_based = args.num_update_checkpoints is not None
    num = args.num_update_checkpoints if update_based else args.num_epoch_checkpoints
    assert args.checkpoint_upper_bound is None or num is not None, \
        "--checkpoint-upper-bound requires --num-epoch/update-checkpoints"
    assert args.num_epoch_checkpoints is None or args.num_update_checkpoints is None, \
        "Cannot combine --num-epoch-checkpoints and --num-update-checkpoints"

    inputs = list(args.inputs)
    if num is not None:
        inputs = last_n_checkpoints(inputs, num, update_based, upper_bound=args.checkpoint_upper_bound)
        logger.info(f"averaging checkpoints: {inputs}")
    save_state(args.output, average_checkpoints(inputs))
    logger.info(f"Finished writing averaged checkpoint to {args.output}")


if __name__ == "__main__":
    cli_main()
