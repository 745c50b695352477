"""Classify each utterance of a split with a multitask model's classifier.

Counterpart of ``fbk_fairseq_st_tpu/cli/generate_multitask_classifier.py``
(reference examples/speech_recognition/generate_multitask_classifier.py
:21-148): sets the task up from the command line, loads the split and the
model of ``--path`` (a ``multitask_conv_transformer`` checkpoint of the
port, the fork or the JAX package), runs its encoder and classifier in
fp32 over the split's batches, padded to their longest utterance as JAX's
(``bucket_shapes=False``: the conv front end is padding-sensitive), and
prints for each utterance, in id order,

    CLASS-<id>\\t<predicted class>\\t<probabilities, 4 decimals>

(with one output the class is 1 where its probability is above 0.5).
Returns {id: probabilities}. It runs on the CUDA card, and on the CPU with
``--cpu`` only:

    python -m fbk_fairseq_st_tpu_torch.cli.generate_multitask_classifier DATA --task speech_recognition \\
        -t de --path checkpoint_last.pt --gen-subset test
"""

from __future__ import annotations

import ast
import logging
import sys

import numpy as np
import torch

from .. import options
from ..device import resolve_device
from ..registry import TASKS
from ..train import checkpoint as checkpoint_utils
from ..utils.user_dir import import_user_module

logger = logging.getLogger("fbk_fairseq_st_tpu_torch.cli.generate_multitask_classifier")


def main(args):
    if args.path is None:
        raise ValueError("--path required!")
    import_user_module(args)
    device = resolve_device("cpu" if args.cpu else None)
    if args.max_tokens is None and args.max_sentences is None:
        args.max_tokens = 12000
    task = TASKS[args.task].setup_task(args)
    task.load_dataset(args.gen_subset)
    models, _ = checkpoint_utils.load_model_ensemble(args.path.split(":"),
                                                     arg_overrides=ast.literal_eval(args.model_overrides),
                                                     task=task, device=device)
    model = models[0]
    itr = task.get_batch_iterator(
        dataset=task.dataset(args.gen_subset), max_tokens=args.max_tokens, max_sentences=args.max_sentences,
        max_positions=task.max_positions(), ignore_invalid_inputs=args.skip_invalid_size_inputs_valid_test,
        required_batch_size_multiple=args.required_batch_size_multiple,
        bucket_shapes=False).next_epoch_itr(shuffle=False)
    results = {}
    with torch.no_grad():
        for sample in itr:
            if len(sample) == 0:
                continue
            net_input = sample["net_input"]
            probs = model.classify(torch.as_tensor(net_input["src_tokens"]).to(device),
                                   torch.as_tensor(net_input["src_lengths"]).to(device)).cpu().numpy()
            for i, sample_id in enumerate(np.asarray(sample["id"])):
                if int(sample_id) >= 0:  # fixed-shape padding rows have id -1
                    results[int(sample_id)] = probs[i]
    for sample_id in sorted(results):
        p = results[sample_id]
        pred = int(np.argmax(p)) if p.shape[-1] > 1 else int(p[0] > 0.5)
        print("CLASS-{}\t{}\t{}".format(sample_id, pred, " ".join(f"{x:.4f}" for x in np.atleast_1d(p))))
    return results


def cli_main(input_args=None):
    logging.basicConfig(format="%(asctime)s | %(levelname)s | %(name)s | %(message)s",
                        datefmt="%Y-%m-%d %H:%M:%S", level=logging.INFO, stream=sys.stdout)
    parser = options.get_generation_parser(default_task="speech_recognition")
    args = options.parse_args_and_arch(parser, input_args)
    return main(args)


if __name__ == "__main__":
    cli_main()
