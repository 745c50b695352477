"""Generate CLI for the multi-decoder models: the translation and the
transcript it descends from.

Counterpart of ``fbk_fairseq_st_tpu/cli/generate_dualdecoder.py``
(reference examples/speech_recognition/generate_dualdecoder.py): sets the
task up from the command line (``speech_translation_dualdecoding`` by
default), loads the split and the model ensemble of ``--path``, decodes
the split in its fixed order with the task's ``TwoPhaseSequenceGenerator``
(batches padded to their longest utterance, ``bucket_shapes=False``, as
JAX's: the conv front end is padding-sensitive) and prints, for each
utterance, ``T-`` and for each of the ``--nbest`` hypotheses ``H-``,
``D-``, ``P-`` (scores in base 2), then ``AUX-`` and ``AUXD-`` with the
transcript (``hypo["transcript_tokens"]``, in the source dictionary)
under the translation's score, as JAX prints them (ROADMAP Queue C). Then
the timing and the ``Generate ... BLEU`` lines over the first hypotheses.
``--results-path`` writes the records to ``generate-<subset>.txt``.

It runs on the CUDA card, and on the CPU with ``--cpu`` only:

    python -m fbk_fairseq_st_tpu_torch.cli.generate_dualdecoder DATA -s en -t de --path checkpoint.pt --beam 5
"""

from __future__ import annotations

import ast
import logging
import math
import os
import sys
import time

import numpy as np
import torch

from .. import options
from ..device import resolve_device
from ..registry import TASKS
from ..scoring import bleu
from ..train import checkpoint as checkpoint_utils
from ..utils.user_dir import import_user_module

logger = logging.getLogger("fbk_fairseq_st_tpu_torch.cli.generate_dualdecoder")


def main(args):
    """Decode ``args.gen_subset``; returns the BLEU scorer."""
    if args.path is None:
        raise ValueError("--path required for generation!")
    if args.results_path is not None:
        os.makedirs(args.results_path, exist_ok=True)
        output_path = os.path.join(args.results_path, "generate-{}.txt".format(args.gen_subset))
        with open(output_path, "w", buffering=1, encoding="utf-8") as h:
            return _main(args, h)
    return _main(args, sys.stdout)


def _main(args, output_file):
    handler = logging.StreamHandler(output_file)
    handler.setFormatter(logging.Formatter("%(asctime)s | %(levelname)s | %(name)s | %(message)s",
                                           datefmt="%Y-%m-%d %H:%M:%S"))
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    try:
        return _generate(args, output_file)
    finally:
        logger.removeHandler(handler)


def _generate(args, output_file):
    import_user_module(args)
    device = resolve_device("cpu" if args.cpu else None)
    if args.max_tokens is None and args.max_sentences is None:
        args.max_tokens = 12000

    logger.info("loading model(s) from {}".format(args.path))
    task = TASKS[args.task].setup_task(args)
    task.load_dataset(args.gen_subset)
    models, _ = checkpoint_utils.load_model_ensemble(args.path.split(":"),
                                                     arg_overrides=ast.literal_eval(args.model_overrides),
                                                     task=task, device=device)
    src_dict, tgt_dict = task.source_dictionary, task.target_dictionary

    itr = task.get_batch_iterator(
        dataset=task.dataset(args.gen_subset), max_tokens=args.max_tokens, max_sentences=args.max_sentences,
        max_positions=task.max_positions(), ignore_invalid_inputs=args.skip_invalid_size_inputs_valid_test,
        required_batch_size_multiple=args.required_batch_size_multiple,
        bucket_shapes=False).next_epoch_itr(shuffle=False)
    generator = task.build_generator(models, args)
    scorer = bleu.Scorer(tgt_dict.pad(), tgt_dict.eos(), tgt_dict.unk())

    num_sentences, gen_seconds = 0, 0.0
    for sample in itr:
        if len(sample) == 0:
            continue
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        hypos = task.inference_step(generator, models, sample)
        gen_seconds += time.perf_counter() - t0

        for i, sample_id in enumerate(np.asarray(sample["id"])):
            sample_id = int(sample_id)
            if sample_id < 0:  # fixed-shape padding rows
                continue
            has_target = sample["target"] is not None
            target_tokens = None
            if has_target:
                target_tokens = np.asarray(sample["target"][i])
                target_tokens = target_tokens[target_tokens != tgt_dict.pad()]
                if not args.quiet:
                    print(f"T-{sample_id}\t{tgt_dict.string(target_tokens, args.remove_bpe, escape_unk=True)}",
                          file=output_file)
            for j, hypo in enumerate(hypos[i][: args.nbest]):
                hypo_str = tgt_dict.string(hypo["tokens"], args.remove_bpe)
                aux_str = src_dict.string(hypo.get("transcript_tokens", []), args.remove_bpe)
                score = hypo["score"] / math.log(2)  # base 2
                if not args.quiet:
                    print(f"H-{sample_id}\t{score}\t{hypo_str}", file=output_file)
                    print(f"D-{sample_id}\t{score}\t{hypo_str}", file=output_file)
                    print("P-{}\t{}".format(sample_id, " ".join(
                        f"{x:.4f}" for x in (hypo["positional_scores"] / math.log(2)).tolist())), file=output_file)
                    # the transcript under the translation's score, as JAX prints it
                    print(f"AUX-{sample_id}\t{score}\t{aux_str}", file=output_file)
                    print(f"AUXD-{sample_id}\t{score}\t{aux_str}", file=output_file)
                if has_target and j == 0:
                    scorer.add(target_tokens.astype(np.int32), np.asarray(hypo["tokens"]).astype(np.int32))
            num_sentences += 1

    logger.info("Translated {} sentences in {:.1f}s ({:.2f} sentences/s)".format(
        num_sentences, gen_seconds, num_sentences / max(gen_seconds, 1e-6)))
    if num_sentences > 0:
        logger.info("Generate {} with beam={}: {}".format(args.gen_subset, args.beam, scorer.result_string()))
    return scorer


def cli_main(input_args=None):
    parser = options.get_generation_parser(default_task="speech_translation_dualdecoding")
    args = options.parse_args_and_arch(parser, input_args)
    return main(args)


if __name__ == "__main__":
    cli_main()
