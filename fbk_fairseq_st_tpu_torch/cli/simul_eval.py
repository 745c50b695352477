"""Corpus-level simultaneous translation evaluation.

Counterpart of ``fbk_fairseq_st_tpu/cli/simul_eval.py`` (the role of the
reference's external SimulEval harness, eval/evaluate.py + eval/agents/):
the greedy READ/WRITE agent of ``generation/simultaneous_decoder.py``
decodes every sentence of the gen subset incrementally (each step
re-encodes the prefix read, so no future source leaks), and the corpus
BLEU comes with AP, AL and DAL averaged over the corpus.

Each sentence prints ``H-<id>\\t<hypothesis>``, ``DEL-<id>\\t<delays>`` and
``LAT-<id>\\tAP=... AL=... DAL=...``, then the log line ``Simultaneous eval
on <subset> (<n> sentences): <BLEU> | AP=... AL=... DAL=...``, as JAX's.
Decoding stops at ``--max-len-b`` tokens (200 when 0). It runs on the CUDA
card, and on the CPU with ``--cpu`` only:

    python -m fbk_fairseq_st_tpu_torch.cli.simul_eval DATA --task translation -s en -t de \\
        --path checkpoint_last.pt --gen-subset test
"""

from __future__ import annotations

import logging
import sys

import numpy as np

from .. import options
from ..device import resolve_device
from ..generation.simultaneous_decoder import greedy_simul_decode
from ..registry import TASKS
from ..scoring import bleu
from ..train import checkpoint as checkpoint_utils
from ..utils.user_dir import import_user_module

logger = logging.getLogger("fbk_fairseq_st_tpu_torch.cli.simul_eval")


def main(args):
    """Evaluate ``args.gen_subset``; returns (the BLEU scorer, the corpus's
    mean {AP, AL, DAL}). The log line goes to stdout with the records."""
    handler = None
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stdout)
        handler.setFormatter(logging.Formatter("%(asctime)s | %(levelname)s | %(name)s | %(message)s",
                                               datefmt="%Y-%m-%d %H:%M:%S"))
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
    try:
        return _evaluate(args)
    finally:
        if handler is not None:
            logger.removeHandler(handler)


def _evaluate(args):
    import_user_module(args)
    if args.path is None:
        raise ValueError("--path required for evaluation")
    device = resolve_device("cpu" if args.cpu else None)
    if args.max_tokens is None and args.max_sentences is None:
        args.max_sentences = 1
    task = TASKS[args.task].setup_task(args)
    task.load_dataset(args.gen_subset)
    models, _ = checkpoint_utils.load_model_ensemble(args.path.split(":"), task=task, device=device)
    model = models[0]
    if not hasattr(model, "mono_cfg"):
        raise ValueError("simul_eval requires a monotonic-attention model (--arch transformer_monotonic*)")
    src_dict, tgt_dict = task.source_dictionary, task.target_dictionary
    itr = task.get_batch_iterator(
        dataset=task.dataset(args.gen_subset), max_tokens=args.max_tokens, max_sentences=args.max_sentences,
        max_positions=task.max_positions(), ignore_invalid_inputs=args.skip_invalid_size_inputs_valid_test,
        bucket_shapes=False).next_epoch_itr(shuffle=False)

    scorer = bleu.Scorer(tgt_dict.pad(), tgt_dict.eos(), tgt_dict.unk())
    lat_sums = {"average_proportion": 0.0, "average_lagging": 0.0, "differentiable_average_lagging": 0.0}
    n_scored = 0
    max_len = int(getattr(args, "max_len_b", 200) or 200)
    for sample in itr:
        if len(sample) == 0:
            continue
        src_batch = np.asarray(sample["net_input"]["src_tokens"])
        src_lens = np.asarray(sample["net_input"]["src_lengths"])
        for i, sample_id in enumerate(np.asarray(sample["id"])):
            sample_id = int(sample_id)
            if sample_id < 0:
                continue
            src = src_batch[i]
            src = src[src != src_dict.pad()][: int(src_lens[i])]
            out = greedy_simul_decode(model, src, eos=tgt_dict.eos(), max_len=max_len, device=device)
            hypo_tokens = np.asarray(out["tokens"], np.int64)
            hypo_str = tgt_dict.string(hypo_tokens, args.remove_bpe)
            target_tokens = None
            if sample.get("target") is not None:
                target_tokens = np.asarray(sample["target"][i])
                target_tokens = target_tokens[target_tokens != tgt_dict.pad()]
            if not args.quiet:
                print(f"H-{sample_id}\t{hypo_str}")
                print("DEL-{}\t{}".format(sample_id, " ".join(str(d) for d in out["delays"])))
                if out["latency"]:
                    print("LAT-{}\tAP={:.4f} AL={:.4f} DAL={:.4f}".format(
                        sample_id, out["latency"]["average_proportion"], out["latency"]["average_lagging"],
                        out["latency"]["differentiable_average_lagging"]))
            if target_tokens is not None and len(hypo_tokens):
                scorer.add(target_tokens.astype(np.int32), hypo_tokens.astype(np.int32))
            if out["latency"]:
                for k in lat_sums:
                    lat_sums[k] += out["latency"][k]
                n_scored += 1
    if n_scored:
        logger.info("Simultaneous eval on {} ({} sentences): {} | AP={:.4f} AL={:.4f} DAL={:.4f}".format(
            args.gen_subset, n_scored, scorer.result_string(), lat_sums["average_proportion"] / n_scored,
            lat_sums["average_lagging"] / n_scored, lat_sums["differentiable_average_lagging"] / n_scored))
    return scorer, {k: v / max(n_scored, 1) for k, v in lat_sums.items()}


def cli_main(input_args=None):
    parser = options.get_generation_parser(default_task="translation")
    args = options.parse_args_and_arch(parser, input_args)
    return main(args)


if __name__ == "__main__":
    cli_main()
