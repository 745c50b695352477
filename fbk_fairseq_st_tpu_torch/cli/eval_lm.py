"""Evaluate a language model: teacher-forced NLL over a split, the loss in
base 2 and the perplexity.

Counterpart of ``fbk_fairseq_st_tpu/cli/eval_lm.py`` (reference
fairseq_cli/eval_lm.py): sets the language-modeling task up, loads
``--gen-subset`` (with ``--context-window N`` the scored windows shrink by
N and each row is prefixed with up to N tokens of the rows before,
``data/monolingual.py::LMContextWindowDataset``, whose positions score
nothing), loads the model from ``--path`` (a fork-layout ``.pt`` or a JAX
pickle) and scores every batch with ``generation/sequence_scorer.py`` (the
log-softmax in fp32, gathered at the targets); ``--max-tokens`` defaults to
36,000. ``--output-word-probs`` prints each row's words (BPE pieces glued
back, ``--remove-bpe``'s marker) with their log-probabilities;
``--output-word-stats`` logs each word's count and mean. Batches are
padded to their longest item, as JAX's (``bucket_shapes=False``).

It runs on the CUDA card, and on the CPU with ``--cpu`` only:

    python -m fbk_fairseq_st_tpu_torch.cli.eval_lm DATA --path checkpoint.pt \\
        --tokens-per-sample 3072 --context-window 2560 --max-sentences 1
"""

from __future__ import annotations

import ast
import logging
import math
import sys

import numpy as np

from .. import options
from ..data.monolingual import LMContextWindowDataset
from ..device import resolve_device
from ..generation.sequence_scorer import SequenceScorer
from ..registry import TASKS
from ..train import checkpoint as checkpoint_utils
from ..utils.user_dir import import_user_module

logger = logging.getLogger("fbk_fairseq_st_tpu_torch.cli.eval_lm")


def main(args):
    """Score ``args.gen_subset``; returns (loss in base 2, tokens scored)."""
    handler = None
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stdout)
        handler.setFormatter(logging.Formatter("%(asctime)s | %(levelname)s | %(name)s | %(message)s",
                                               datefmt="%Y-%m-%d %H:%M:%S"))
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
    try:
        return _eval(args)
    finally:
        if handler is not None:
            logger.removeHandler(handler)


def _eval(args):
    import_user_module(args)
    if args.path is None:
        raise ValueError("--path required for evaluation")
    device = resolve_device("cpu" if args.cpu else None)
    if args.max_tokens is None and args.max_sentences is None:
        args.max_tokens = 36000
    context_window = getattr(args, "context_window", 0) or 0
    if context_window > 0:
        # the scored window shrinks so window + context fits the model
        args.tokens_per_sample -= context_window
    task = TASKS[args.task].setup_task(args)
    task.load_dataset(args.gen_subset)
    if context_window > 0:
        task.datasets[args.gen_subset] = LMContextWindowDataset(
            task.dataset(args.gen_subset), tokens_per_sample=args.tokens_per_sample,
            context_window=context_window, pad_idx=task.target_dictionary.pad())
    models, _ = checkpoint_utils.load_model_ensemble(args.path.split(":"),
                                                     arg_overrides=ast.literal_eval(args.model_overrides),
                                                     task=task, device=device)
    d = task.target_dictionary
    itr = task.get_batch_iterator(
        dataset=task.dataset(args.gen_subset), max_tokens=args.max_tokens, max_sentences=args.max_sentences,
        max_positions=task.max_positions(), ignore_invalid_inputs=True,
        required_batch_size_multiple=args.required_batch_size_multiple).next_epoch_itr(shuffle=False)
    scorer = SequenceScorer(d)
    word_stats: dict = {}
    bpe_cont = (args.remove_bpe or "@@ ").rstrip()

    def emit_words(sample_id, tokens, scores):
        """The row's words (pieces ending in the continuation marker glued
        to the next) and their summed log-probabilities (JAX :107-140)."""
        words, w, lp, is_bpe = [], "", 0.0, False
        for tok, score in zip(tokens, scores):
            sym = d[int(tok)]
            w += sym
            lp += float(score)
            if sym.endswith(bpe_cont):
                w = w[:-len(bpe_cont)]
                is_bpe = True
            else:
                words.append((w, lp, is_bpe))
                w, lp, is_bpe = "", 0.0, False
        if w:
            words.append((w, lp, is_bpe))
        if args.output_word_probs:
            print(str(int(sample_id)) + " " + "\t".join(f"{w} [{lp:2f}]" for w, lp, _ in words))
        if args.output_word_stats:
            for w, lp, wb in words:
                st = word_stats.setdefault(w, [0, 0.0, wb])
                st[0] += 1
                st[1] += lp

    total_nll, total_tokens = 0.0, 0
    for sample in itr:
        if len(sample) == 0:
            continue
        hypos = scorer.generate(models, sample)
        for sample_id, hypo in zip(np.asarray(sample["id"]), hypos):
            scores = hypo[0]["positional_scores"]
            total_nll -= float(np.sum(scores, dtype=np.float64))
            total_tokens += len(scores)
            if args.output_word_probs or args.output_word_stats:
                emit_words(sample_id, hypo[0]["tokens"], scores)

    if args.output_word_stats:
        for w, (count, log_prob, wb) in sorted(word_stats.items(), key=lambda x: x[1][0], reverse=True):
            logger.info(f"{w}{' (is_bpe)' if wb else ''}: count={count} avg_log_prob={log_prob / count:.4f}")
    avg_nll = total_nll / max(total_tokens, 1) / math.log(2)
    logger.info("Evaluated {} tokens".format(total_tokens))
    logger.info("Loss (base 2): {:.4f}, Perplexity: {:.2f}".format(avg_nll, 2 ** avg_nll))
    return avg_nll, total_tokens


def cli_main(input_args=None):
    parser = options.get_eval_lm_parser(default_task="language_modeling")
    args = options.parse_args_and_arch(parser, input_args)
    return main(args)


if __name__ == "__main__":
    cli_main()
