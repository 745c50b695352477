"""Interactive translation of raw text lines from a file or stdin.

The port's copy of ``fbk_fairseq_st_tpu/cli/interactive.py`` (reference
fairseq_cli/interactive.py): sets the task up from the command line, loads
the ensemble of ``--path``, reads ``--buffer-size`` lines at a time from
``--input`` (a file, or ``-`` for stdin), encodes each buffer with the
task's source dictionary into one batch (sources padded as the task pads
them: on the left for ``translation``), decodes it with the task's
generator and prints, in input order, ``S-`` and for each of the
``--nbest`` hypotheses ``H-`` (score in nats, as JAX's), ``D-`` and ``P-``.
``--max-sentences`` may not exceed ``--buffer-size``, as in JAX. A line
goes through ``--tokenizer`` then ``--bpe`` before the dictionary, and the
D- line is the hypothesis back through the BPE then the tokenizer
(``data/encoders.py::codec_chain``); without them a line is taken as the
tokens it holds.

It runs on the CUDA card, and on the CPU with ``--cpu`` only:

    python -m fbk_fairseq_st_tpu_torch.cli.interactive DATA --task translation -s en -t de \\
        --path checkpoint.pt --beam 5 --buffer-size 8 --input sentences.txt
"""

from __future__ import annotations

import ast
import logging
import sys
from collections import namedtuple

import numpy as np

from .. import options
from ..data.encoders import codec_chain
from ..data.language_pair_dataset import collate_tokens
from ..device import resolve_device
from ..registry import TASKS
from ..train import checkpoint as checkpoint_utils
from ..utils.user_dir import import_user_module

logger = logging.getLogger("fbk_fairseq_st_tpu_torch.cli.interactive")

Batch = namedtuple("Batch", "ids src_tokens src_lengths")


def buffered_read(input, buffer_size):
    buffer = []
    with (sys.stdin if input == "-" else open(input)) as h:
        for src_str in h:
            buffer.append(src_str.strip())
            if len(buffer) >= buffer_size:
                yield buffer
                buffer = []
    if buffer:
        yield buffer


def make_batches(lines, task, encode_fn=None):
    """One batch of the buffered ``lines``, each through ``encode_fn`` and
    then the source dictionary (eos appended), padded as the task pads its
    sources."""
    if encode_fn is not None:
        lines = [encode_fn(line) for line in lines]
    src_dict = task.source_dictionary
    tokens = [np.asarray(src_dict.encode_line(line, add_if_not_exist=False)) for line in lines]
    lengths = np.array([t.shape[0] for t in tokens], np.int64)
    src_tokens = collate_tokens(tokens, src_dict.pad(), src_dict.eos(),
                                left_pad=getattr(task.args, "left_pad_source", True))
    yield Batch(ids=np.arange(len(lines)), src_tokens=src_tokens, src_lengths=lengths)


def main(args):
    import_user_module(args)
    device = resolve_device("cpu" if args.cpu else None)
    if args.buffer_size < 1:
        args.buffer_size = 1
    assert not args.max_sentences or args.max_sentences <= args.buffer_size, \
        "--max-sentences/--batch-size cannot be larger than --buffer-size"

    task = TASKS[args.task].setup_task(args)
    models, _ = checkpoint_utils.load_model_ensemble(args.path.split(":"),
                                                     arg_overrides=ast.literal_eval(args.model_overrides),
                                                     task=task, device=device)
    generator = task.build_generator(models, args)
    src_dict, tgt_dict = task.source_dictionary, task.target_dictionary
    encode_fn, decode_fn = codec_chain(args)

    start_id = 0
    if args.input == "-":
        logger.info("Type the input sentence and press return:")
    for inputs in buffered_read(args.input, args.buffer_size):
        results = []
        for batch in make_batches(inputs, task, encode_fn):
            sample = {"net_input": {"src_tokens": batch.src_tokens, "src_lengths": batch.src_lengths},
                      "target": None, "id": batch.ids}
            translations = task.inference_step(generator, models, sample)
            for i, (idx, hypos) in enumerate(zip(batch.ids, translations)):
                results.append((start_id + int(idx), batch.src_tokens[i], hypos))

        for id_, src_tokens, hypos in sorted(results, key=lambda x: x[0]):
            print(f"S-{id_}\t{src_dict.string(src_tokens, args.remove_bpe)}")
            for hypo in hypos[: args.nbest]:
                hypo_str = tgt_dict.string(hypo["tokens"], args.remove_bpe)
                print(f"H-{id_}\t{hypo['score']}\t{hypo_str}")
                print(f"D-{id_}\t{hypo['score']}\t{decode_fn(hypo_str)}")
                print("P-{}\t{}".format(id_, " ".join(f"{x:.4f}" for x in hypo["positional_scores"])))
        start_id += len(inputs)


def cli_main(input_args=None):
    logging.basicConfig(format="%(asctime)s | %(levelname)s | %(name)s | %(message)s",
                        datefmt="%Y-%m-%d %H:%M:%S", level=logging.INFO, stream=sys.stdout)
    parser = options.get_interactive_generation_parser(default_task="translation")
    args = options.parse_args_and_arch(parser, input_args)
    main(args)


if __name__ == "__main__":
    cli_main()
