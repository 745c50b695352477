"""Generate CLI: batched beam decoding of a corpus from files, the record
lines and corpus BLEU.

Counterpart of ``fbk_fairseq_st_tpu/cli/generate.py`` (reference
fairseq_cli/generate.py:23-269): sets the task up from the command line,
loads the split and the model ensemble from the checkpoint(s) of
``--path`` (a fork-layout ``.pt`` or a JAX pickle, ``train/checkpoint.py``),
decodes the split in its fixed order with the task's generator and prints
the fork's records in the same order: ``S-`` (a source with a dictionary;
audio has none), ``T-``, and for each of the ``--nbest`` hypotheses
``H-``, ``D-`` (the hypothesis back through ``--bpe`` then
``--tokenizer``), ``P-`` (scores in base 2) and, with ``--print-alignment``,
``A-`` (``generation/alignment_utils.py``: one teacher-forced forward of
the first model a batch); then the timing and the ``Generate ... BLEU``
lines, over token ids or, with ``--sacrebleu``, over the detokenised
strings. ``--replace-unk`` replaces each unknown word of a hypothesis by
the source word it is aligned to (or that word's entry in the dictionary
file it names; ``utils/align_utils.py``). ``--num-shards`` /
``--shard-id`` decode every ``num_shards``-th batch of the split. With ``--score-reference`` the task's
generator is the ``SequenceScorer``: one teacher-forced forward a batch,
and the H-/P- lines give the reference's tokens, their log-probabilities
and their mean, as JAX's. Batches are padded to their longest item,
as JAX's (``bucket_shapes=False``): the conv front end is
padding-sensitive, so the batches match JAX's one for one.

It runs on the CUDA card, and on the CPU with ``--cpu`` only:

    python -m fbk_fairseq_st_tpu_torch.cli.generate DATA --task speech_translation_with_transcription \\
        -s en -t de --path checkpoint.pt --beam 5
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
from ..data.encoders import codec_chain
from ..generation.alignment_utils import attach_alignments
from ..quantization.weight_only import maybe_quantize_ensemble
from ..registry import TASKS
from ..scoring import bleu
from ..train import checkpoint as checkpoint_utils
from ..utils.align_utils import load_align_dict, post_process_prediction
from ..utils.user_dir import import_user_module

logger = logging.getLogger("fbk_fairseq_st_tpu_torch.cli.generate")


def main(args):
    """Decode ``args.gen_subset``; returns the BLEU scorer."""
    if args.path is None:
        raise ValueError("--path required for generation!")
    if args.sampling and args.nbest != args.beam:
        raise ValueError("--sampling requires --nbest to be equal to --beam")
    if args.results_path is not None:
        os.makedirs(args.results_path, exist_ok=True)
        output_path = os.path.join(args.results_path, "generate-{}.txt".format(args.gen_subset))
        with open(output_path, "w", buffering=1, encoding="utf-8") as h:
            return _main(args, h)
    return _main(args, sys.stdout)


def _main(args, output_file):
    # the log lines go to the records' stream, through a handler of this
    # call's own (the root logger is left as the caller set it)
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

    # --sacrebleu needs its package: without it, raise before loading anything
    sacrebleu_scorer = bleu.SacrebleuScorer() if args.sacrebleu else None
    logger.info("loading model(s) from {}".format(args.path))
    task = TASKS[args.task].setup_task(args)
    task.load_dataset(args.gen_subset)
    models, _ = checkpoint_utils.load_model_ensemble(args.path.split(":"),
                                                     arg_overrides=ast.literal_eval(args.model_overrides),
                                                     task=task, device=device)
    models = maybe_quantize_ensemble(models, args, logger)
    src_dict = getattr(task, "source_dictionary", None)
    tgt_dict = task.target_dictionary

    itr = task.get_batch_iterator(
        dataset=task.dataset(args.gen_subset), max_tokens=args.max_tokens, max_sentences=args.max_sentences,
        max_positions=task.max_positions(), ignore_invalid_inputs=args.skip_invalid_size_inputs_valid_test,
        required_batch_size_multiple=args.required_batch_size_multiple, num_shards=args.num_shards,
        shard_id=args.shard_id).next_epoch_itr(shuffle=False)
    generator = task.build_generator(models, args)
    scorer = sacrebleu_scorer or bleu.Scorer(tgt_dict.pad(), tgt_dict.eos(), tgt_dict.unk())
    align_dict = load_align_dict(args.replace_unk)
    _, decode_fn = codec_chain(args)

    num_sentences = 0
    gen_seconds, gen_tokens = 0.0, 0
    for sample in itr:
        if len(sample) == 0:
            continue
        prefix_tokens = sample["target"][:, : args.prefix_size] if args.prefix_size > 0 else None
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        hypos = task.inference_step(generator, models, sample, prefix_tokens)
        gen_seconds += time.perf_counter() - t0
        num_generated_tokens = sum(len(h[0]["tokens"]) for h in hypos if h)
        gen_tokens += num_generated_tokens
        if args.print_alignment or align_dict is not None:
            hypos = attach_alignments(models[0], sample, hypos, tgt_dict.pad(), tgt_dict.eos())

        for i, sample_id in enumerate(np.asarray(sample["id"])):
            sample_id = int(sample_id)
            if sample_id < 0:  # fixed-shape padding rows
                continue
            has_target = sample["target"] is not None
            target_tokens = None
            if has_target:
                target_tokens = np.asarray(sample["target"][i])
                target_tokens = target_tokens[target_tokens != tgt_dict.pad()]
            src_str = ""
            if src_dict is not None:
                src = np.asarray(sample["net_input"]["src_tokens"][i])
                if src.ndim == 1:
                    src_str = src_dict.string(src, args.remove_bpe)
            target_str = tgt_dict.string(target_tokens, args.remove_bpe, escape_unk=True) if has_target else None
            if not args.quiet:
                if src_str:
                    print(f"S-{sample_id}\t{src_str}", file=output_file)
                if has_target:
                    print(f"T-{sample_id}\t{target_str}", file=output_file)

            for j, hypo in enumerate(hypos[i][: args.nbest]):
                # the post-processed words are scored (reference utils.py:142-160)
                hypo_tokens, hypo_str, alignment = post_process_prediction(
                    hypo["tokens"], src_str, hypo.get("alignment"), align_dict, tgt_dict, args.remove_bpe)
                detok_hypo_str = decode_fn(hypo_str)
                if not args.quiet:
                    score = hypo["score"] / math.log(2)  # base 2
                    print(f"H-{sample_id}\t{score}\t{hypo_str}", file=output_file)
                    print(f"D-{sample_id}\t{score}\t{detok_hypo_str}", file=output_file)
                    print("P-{}\t{}".format(sample_id, " ".join(
                        f"{x:.4f}" for x in (hypo["positional_scores"] / math.log(2)).tolist())), file=output_file)
                    if args.print_alignment and alignment is not None:
                        print("A-{}\t{}".format(sample_id, " ".join(alignment)), file=output_file)
                if has_target and j == 0:
                    score_target = target_tokens
                    if align_dict is not None or args.remove_bpe is not None:
                        score_target = np.asarray(tgt_dict.encode_line(target_str, add_if_not_exist=True))
                    if args.sacrebleu:
                        scorer.add_string(target_str, detok_hypo_str)
                    else:
                        scorer.add(np.asarray(score_target).astype(np.int32),
                                   np.asarray(hypo_tokens).astype(np.int32))
            num_sentences += 1

    logger.info("NOTE: hypothesis and token scores are output in base 2")
    avg = gen_seconds / gen_tokens if gen_tokens > 0 else gen_seconds
    logger.info("Translated {} sentences ({} tokens) in {:.1f}s ({:.2f} sentences/s, {:.2f} tokens/s)".format(
        num_sentences, gen_tokens, gen_seconds, num_sentences / max(gen_seconds, 1e-6), 1.0 / max(avg, 1e-9)))
    if num_sentences > 0:
        logger.info("Generate {} with beam={}: {}".format(args.gen_subset, args.beam, scorer.result_string()))
    return scorer


def cli_main(input_args=None):
    parser = options.get_generation_parser()
    args = options.parse_args_and_arch(parser, input_args)
    return main(args)


if __name__ == "__main__":
    cli_main()
