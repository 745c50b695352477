"""Validate CLI: the criterion over the validation subsets of a checkpoint.

Counterpart of ``fbk_fairseq_st_tpu/cli/validate.py`` (reference
fairseq_cli/validate.py): rebuilds the model of ``--path`` (any file the
port's reader takes) from its args, runs ``Trainer.valid_step`` over each
subset of ``--valid-subset`` (batches padded to the shape buckets, as
JAX's are) and prints the aggregated stats. It runs on the card, and on
the CPU with ``--cpu`` only:

    python -m fbk_fairseq_st_tpu_torch.cli.validate DATA --task speech_translation_with_transcription \\
        -s en -t de --path checkpoint_best.pt --max-tokens 25000
"""

from __future__ import annotations

import logging
import sys

from .. import options
from ..device import resolve_device
from ..registry import TASKS
from ..train import checkpoint as checkpoint_utils
from ..utils.user_dir import import_user_module
from ..train import metrics
from ..train.progress import progress_bar
from ..train.trainer import Trainer

logger = logging.getLogger("fbk_fairseq_st_tpu_torch.cli.validate")


def main(args):
    """Returns {subset: the aggregated stats}."""
    if args.path is None:
        raise ValueError("--path required for validation")
    import_user_module(args)
    device = resolve_device("cpu" if args.cpu else None)
    state = checkpoint_utils.load_checkpoint_to_cpu(args.path)
    model_args = state["args"]
    # the validation parser has no optimisation group; the trainer still
    # builds an optimiser, which no validation step touches
    if not hasattr(args, "lr"):
        args.lr = [0.0]
    task = TASKS[args.task].setup_task(args)
    model = task.build_model(model_args, device=device)
    model.load_state_dict(state["model"], strict=True)
    criterion = task.build_criterion(model_args)
    trainer = Trainer(args, task, model, criterion)

    results = {}
    for subset in args.valid_subset.split(","):
        task.load_dataset(subset, combine=False)
        itr = task.get_batch_iterator(
            dataset=task.dataset(subset), max_tokens=args.max_tokens, max_sentences=args.max_sentences,
            max_positions=task.max_positions(), ignore_invalid_inputs=True,
            required_batch_size_multiple=args.required_batch_size_multiple, seed=args.seed,
            bucket_shapes=True).next_epoch_itr(shuffle=False)
        progress = progress_bar(itr, log_format=args.log_format, log_interval=args.log_interval,
                                prefix=f"valid on '{subset}' subset", default_log_format="simple")
        with metrics.aggregate(new_root=True) as agg:
            for sample in progress:
                trainer.valid_step(sample)
        results[subset] = agg.get_smoothed_values()
        progress.print(results[subset], tag=subset, step=0)
    return results


def cli_main(input_args=None):
    logging.basicConfig(format="%(asctime)s | %(levelname)s | %(name)s | %(message)s",
                        datefmt="%Y-%m-%d %H:%M:%S", level=logging.INFO, stream=sys.stdout)
    parser = options.get_validation_parser()
    args = options.parse_args_and_arch(parser, input_args)
    return main(args)


if __name__ == "__main__":
    cli_main()
