"""Write a teacher's top-k outputs for knowledge distillation.

Counterpart of ``fbk_fairseq_st_tpu/cli/generate_topk.py`` (reference
scripts/generate_topk.py:14-92): the teacher of ``--path`` runs
teacher-forced over ``--gen-subset`` in eval mode, in fp32, on batches
padded to their longest utterance as JAX's (``bucket_shapes=False``);
at each target position that is not a pad it keeps the ``--distill-topk``
largest logits and their indices (``torch.topk``, sorted, largest first;
JAX takes ``lax.top_k``), and writes them beside the data as
``<split>.<tgt>.top{K}_idx`` (int32) and ``<split>.<tgt>.top{K}_out``
(float32), one (T, K) item an utterance in id order
(``TeacherOutputDataset``): the inputs of
``speech_translation_with_transcription_kd``. It runs on the CUDA card,
and on the CPU with ``--cpu`` only:

    python -m fbk_fairseq_st_tpu_torch.cli.generate_topk DATA --task speech_translation_with_transcription \\
        -s en -t de --path teacher/checkpoint_best.pt --gen-subset train --distill-topk 8
"""

from __future__ import annotations

import ast
import logging
import os
import sys

import numpy as np
import torch

from .. import options
from ..data.knowledge_distillation import TeacherOutputDataset
from ..device import resolve_device
from ..registry import TASKS
from ..train import checkpoint as checkpoint_utils
from ..utils.user_dir import import_user_module

logger = logging.getLogger("fbk_fairseq_st_tpu_torch.cli.generate_topk")


def gen_outputs(args, task, model, device):
    """[idxs (T, K), logits (T, K)] of each utterance of the split, by id
    (None for one that no batch held)."""
    dataset = task.dataset(args.gen_subset)
    logger.info("{} {} {} examples".format(args.data, args.gen_subset, len(dataset)))
    itr = task.get_batch_iterator(
        dataset=dataset, max_tokens=args.max_tokens, max_sentences=args.max_sentences,
        max_positions=task.max_positions(), ignore_invalid_inputs=args.skip_invalid_size_inputs_valid_test,
        required_batch_size_multiple=8, bucket_shapes=False).next_epoch_itr(shuffle=False)
    outputs = [None] * len(dataset)
    pad = task.target_dictionary.pad()
    with torch.no_grad():
        for sample in itr:
            if "net_input" not in sample:
                continue
            if sample["target"] is None:
                raise ValueError(f"{args.gen_subset} has no targets to force the teacher with")
            batch = {k: torch.as_tensor(sample["net_input"][k]).to(device)
                     for k in ("src_tokens", "src_lengths", "prev_output_tokens")}
            logits, _ = model(batch)
            topk_outs, topk_idx = torch.topk(logits.float(), args.distill_topk, dim=-1)
            topk_outs, topk_idx = topk_outs.cpu().numpy(), topk_idx.cpu().numpy()
            non_padding = np.asarray(sample["target"]) != pad
            for i, sample_id in enumerate(np.asarray(sample["id"])):
                if int(sample_id) >= 0:  # fixed-shape padding rows have id -1
                    outputs[int(sample_id)] = [topk_idx[i, non_padding[i]], topk_outs[i, non_padding[i]]]
    return outputs


def save_expert_outputs(args, expert_outputs) -> None:
    logger.info("Start saving expert outputs..")
    prefix = os.path.join(args.data, "{}.{}.top{}".format(args.gen_subset, args.target_lang, args.distill_topk))
    for part, dtype, suffix in ((0, np.int32, "_idx"), (1, np.float32, "_out")):
        TeacherOutputDataset.save_bin(prefix + suffix, [o[part] for o in expert_outputs if o is not None], dtype)
        logger.info("Written {}".format(prefix + suffix))


def main(args):
    if args.path is None:
        raise ValueError("--path required for generation!")
    import_user_module(args)
    device = resolve_device("cpu" if args.cpu else None)
    if args.max_tokens is None and args.max_sentences is None:
        args.max_tokens = 12000
    task = TASKS[args.task].setup_task(args)
    task.load_dataset(args.gen_subset)
    models, _ = checkpoint_utils.load_model_ensemble(args.path.split(":"),
                                                     arg_overrides=ast.literal_eval(args.model_overrides),
                                                     task=task, device=device)
    if len(models) != 1:
        raise ValueError("generate_topk takes one teacher")
    outputs = gen_outputs(args, task, models[0], device)
    save_expert_outputs(args, outputs)
    return outputs


def cli_main(input_args=None):
    logging.basicConfig(format="%(asctime)s | %(levelname)s | %(name)s | %(message)s",
                        datefmt="%Y-%m-%d %H:%M:%S", level=logging.INFO, stream=sys.stdout)
    parser = options.get_generation_parser()
    parser.add_argument("--distill-topk", default=8, type=int)
    args = options.parse_args_and_arch(parser, input_args)
    return main(args)


if __name__ == "__main__":
    cli_main()
