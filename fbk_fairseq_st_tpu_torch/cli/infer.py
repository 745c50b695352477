"""ASR inference CLI with sclite-format outputs.

Counterpart of ``fbk_fairseq_st_tpu/cli/infer.py`` (reference
examples/speech_recognition/infer.py:26-273): decodes the ``--gen-subset``
split and writes ``hypo.word-<ckpt>-<subset>.txt``, ``hypo.units-...``,
``ref.word-...`` and ``ref.units-...`` in sclite trn format
("<sentence> (<utt_id>-<utt_id>)"), the .word files de-segmented as
sentencepiece; ``main`` returns the corpus WER and UER of the best
hypotheses, which it also logs.

The routes:

  * seq2seq (``asr_vggtransformer``): the task's generator
    (``--beam``, ``--nbest``, ...);
  * ``--ctc-decoding greedy``: the best CTC path of the emissions
    (``ops/ctc.py``), or under ASG (a model with ``asg_transitions``) the
    Viterbi path (``ops/asg.py``), repeats collapsed and replabels
    unpacked;
  * ``--ctc-decoding beam``: the prefix beam search, or the ASG beam
    (``generation/ctc_decoder.py``), optionally constrained by
    ``--lexicon`` and scored by the word LM of ``--kenlm-model`` (an
    ``.arpa`` / ``.arpa.gz`` loads natively, ``generation/arpa_lm.py``; a
    KenLM binary needs ``kenlm``).

``--w2l-decoder viterbi`` means greedy, ``--w2l-decoder kenlm`` the beam
with a lexicon and an LM (JAX :164-178). The emissions are computed on the
model's device and searched on the host. Batches are padded to their
longest item (``bucket_shapes=False``), as JAX's are.

It runs on the CUDA card, and on the CPU with ``--cpu`` only:

    python -m fbk_fairseq_st_tpu_torch.cli.infer DATA --task speech_recognition \\
        --path checkpoint.pt --results-path OUT --ctc-decoding greedy
"""

from __future__ import annotations

import ast
import logging
import math
import os
import time

import numpy as np
import torch

from .. import options
from ..data.dictionary import post_process
from ..data.replabels import unpack_replabels
from ..device import resolve_device
from ..generation.arpa_lm import load_word_lm
from ..generation.ctc_decoder import ASGBeamDecoder, CTCPrefixBeamDecoder, LexiconTrie, ctc_beam_decode_batch
from ..ops.asg import asg_viterbi_decode
from ..ops.ctc import ctc_greedy_decode
from ..registry import TASKS
from ..train import checkpoint as checkpoint_utils
from ..utils.user_dir import import_user_module

logger = logging.getLogger("fbk_fairseq_st_tpu_torch.cli.infer")


def add_asr_eval_argument(parser):
    """JAX :36-75."""
    parser.add_argument("--ctc-decoding", nargs="?", const="greedy", choices=["greedy", "beam"], default=None,
                        help="CTC decoding for encoder-only models: greedy (best path) or beam (prefix beam search, "
                        "optional lexicon/LM)")
    parser.add_argument("--ctc-beam-size", type=int, default=32, help="beam width for --ctc-decoding beam")
    parser.add_argument("--lexicon", help="wav2letter-format lexicon (word<TAB>unit unit ...) constraining beam "
                        "decodes")
    parser.add_argument("--kenlm-model", default=None,
                        help="word-level n-gram model scored at word boundaries: ARPA text (.arpa[.gz]) loads "
                        "natively; KenLM binary files need the optional kenlm binding")
    parser.add_argument("--lm-weight", type=float, default=2.0)
    parser.add_argument("--word-score", type=float, default=-1.0)
    parser.add_argument("--beam-threshold", type=float, default=25.0,
                        help="prune beams scoring below best minus this")
    parser.add_argument("--unk-weight", type=float, default=-math.inf,
                        help="score for emitting <unk> at an out-of-lexicon word boundary (-inf forbids)")
    parser.add_argument("--sil-weight", type=float, default=0.0,
                        help="score added per silence/word-boundary transition")
    parser.add_argument("--word-boundary-unit", default="|",
                        help="dictionary unit delimiting words for the lexicon decoder (wav2letter convention)")
    parser.add_argument("--kspmodel", default=None, help="sentence piece model")
    parser.add_argument("--wfstlm", default=None, help="wfstlm on dictonary output units")
    parser.add_argument("--rnnt_decoding_type", default="greedy")
    parser.add_argument("--rnnt_len_penalty", default=-0.5)
    parser.add_argument("--w2l-decoder", choices=["viterbi", "kenlm"],
                        help="w2l-style decoders, implemented natively: viterbi = CTC best path; kenlm = "
                        "lexicon-constrained prefix beam search with a KenLM word LM (reference "
                        "w2l_decoder.py:84,:112)")
    return parser


def _sclite_line(sentence: str, utt_id) -> str:
    return f"{sentence} ({utt_id}-{utt_id})\n"


def process_predictions(args, hypos, tgt_dict, sample_id, res_files):
    best_words = best_pieces = None
    for hypo in hypos[: min(len(hypos), args.nbest)]:
        hyp_pieces = tgt_dict.string(hypo["tokens"])
        # a lexicon decode's words come from the lexicon itself
        hyp_words = " ".join(hypo["words"]) if hypo.get("words") else post_process(hyp_pieces, "sentencepiece")
        res_files["hypo.units"].write(_sclite_line(hyp_pieces, sample_id))
        res_files["hypo.word"].write(_sclite_line(hyp_words, sample_id))
        if best_words is None:
            best_words, best_pieces = hyp_words, hyp_pieces
    return best_words, best_pieces


def process_references(args, target_tokens, tgt_dict, sample_id, res_files):
    tgt_pieces = tgt_dict.string(target_tokens, escape_unk=True)
    tgt_words = post_process(tgt_pieces, "sentencepiece")
    res_files["ref.units"].write(_sclite_line(tgt_pieces, sample_id))
    res_files["ref.word"].write(_sclite_line(tgt_words, sample_id))
    return tgt_words, tgt_pieces


def edit_distance(ref, hyp) -> int:
    """Levenshtein over token lists (the WER / UER numerator)."""
    if not ref or not hyp:
        return max(len(ref), len(hyp))
    prev = list(range(len(hyp) + 1))
    for i, r in enumerate(ref, 1):
        cur = [i] + [0] * len(hyp)
        for j, h in enumerate(hyp, 1):
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (r != h))
        prev = cur
    return prev[-1]


def prepare_result_files(args):
    os.makedirs(args.results_path, exist_ok=True)
    return {
        prefix: open(os.path.join(args.results_path, "{}-{}-{}.txt".format(
            prefix, os.path.basename(args.path), args.gen_subset)), "w", buffering=1, encoding="utf-8")
        for prefix in ("hypo.word", "hypo.units", "ref.word", "ref.units")
    }


def _hypo(tokens, score=0.0, words=None) -> dict:
    return {"tokens": np.asarray(tokens, np.int64), "score": score,
            "positional_scores": np.zeros(len(tokens), np.float32), "words": words, "alignment": None,
            "attention": None}


class EmissionDecoder:
    """The CTC / ASG routes of one model: ``generate(models, sample)`` ->
    one hypothesis list per row, as the task's generator gives them."""

    def __init__(self, args, model, tgt_dict, mode: str):
        self.args = args
        self.model = model
        self.tgt_dict = tgt_dict
        self.mode = mode
        # an ASG-trained model has no blank: it decodes under ASG scoring
        # (the learned transitions and replabels)
        self.transitions = getattr(model, "asg_transitions", None)
        self.blank = tgt_dict.index("<ctc_blank>") if "<ctc_blank>" in tgt_dict.indices else None
        if self.blank is None and self.transitions is None:
            raise ValueError("--ctc-decoding needs either a <ctc_blank> symbol in the dictionary (CTC) or a "
                             "model with asg_transitions (ASG)")
        self.max_replabel = getattr(args, "max_replabel", 2)
        self.beam_decoder = self._beam_decoder() if mode == "beam" else None

    def _beam_decoder(self):
        args = self.args
        trie = boundary = None
        if args.lexicon:
            trie = LexiconTrie.from_lexicon_file(args.lexicon, self.tgt_dict)
            boundary = self.tgt_dict.index(args.word_boundary_unit)
        lm = load_word_lm(args.kenlm_model) if args.kenlm_model else None
        if self.transitions is not None:
            return ASGBeamDecoder(self.transitions.detach().float().cpu().numpy(), beam_size=args.ctc_beam_size,
                                  trie=trie, lm=lm, lm_weight=args.lm_weight, word_score=args.word_score,
                                  word_boundary=boundary)
        return CTCPrefixBeamDecoder(blank=self.blank, beam_size=args.ctc_beam_size, trie=trie, lm=lm,
                                    lm_weight=args.lm_weight, word_score=args.word_score, word_boundary=boundary,
                                    beam_threshold=args.beam_threshold, unk_weight=args.unk_weight,
                                    sil_weight=args.sil_weight)

    def _emissions(self, sample):
        device = next(self.model.parameters()).device
        net_input = sample["net_input"]
        src = torch.as_tensor(np.asarray(net_input["src_tokens"]), device=device)
        src_lengths = torch.as_tensor(np.asarray(net_input["src_lengths"]), device=device)
        with torch.no_grad():
            enc = self.model.encode(src, src_lengths)
        logits = enc.ctc_out if enc.ctc_out is not None else enc.encoder_out
        lengths = enc.ctc_lengths if enc.ctc_lengths is not None else enc.src_lengths
        return logits, lengths

    def _unpack(self, tokens):
        return unpack_replabels(list(tokens), self.tgt_dict, self.max_replabel)

    def generate(self, models, sample, prefix_tokens=None, **kwargs):
        logits, lengths = self._emissions(sample)
        if self.mode == "beam":
            with torch.no_grad():
                # ASG scores are unnormalised: no softmax
                scores = logits.float() if self.transitions is not None else torch.log_softmax(logits.float(), -1)
            out = []
            for hyps in ctc_beam_decode_batch(scores.cpu().numpy(), lengths.cpu().numpy(), self.beam_decoder,
                                              n_best=self.args.nbest):
                out.append([_hypo(self._unpack(h["tokens"].tolist()) if self.transitions is not None
                                  else h["tokens"], h["score"], h.get("words")) for h in hyps])
            return out
        if self.transitions is not None:
            with torch.no_grad():
                paths, scores = asg_viterbi_decode(logits, self.transitions, lengths)
            paths, scores, lengths = paths.cpu().numpy(), scores.cpu().numpy(), lengths.cpu().numpy()
            out = []
            for i in range(paths.shape[0]):
                path = paths[i, : lengths[i]].tolist()
                # no blank: collapse the repeats, then expand the replabels
                collapsed = [tok for j, tok in enumerate(path) if j == 0 or tok != path[j - 1]]
                out.append([_hypo(self._unpack(collapsed), float(scores[i]))])
            return out
        with torch.no_grad():
            toks, counts = ctc_greedy_decode(logits, lengths, self.blank)
        toks, counts = toks.cpu().numpy(), counts.cpu().numpy()
        return [[_hypo(toks[i, : counts[i]])] for i in range(toks.shape[0])]


def main(args):
    """Decode ``args.gen_subset`` into the sclite files; returns (WER, UER)
    in percent, (None, None) without references."""
    if args.path is None:
        raise ValueError("--path required for generation!")
    if args.results_path is None:
        raise ValueError("--results-path required!")
    import_user_module(args)
    device = resolve_device("cpu" if args.cpu else None)
    if args.max_tokens is None and args.max_sentences is None:
        args.max_tokens = 30000
    logger.info(args)

    task = TASKS[args.task].setup_task(args)
    task.load_dataset(args.gen_subset)
    logger.info("| {} {} {} examples".format(args.data, args.gen_subset, len(task.dataset(args.gen_subset))))
    models, _ = checkpoint_utils.load_model_ensemble(args.path.split(":"),
                                                     arg_overrides=ast.literal_eval(args.model_overrides),
                                                     task=task, device=device)
    tgt_dict = task.target_dictionary

    # the w2l decoders map onto the native ones: Viterbi over CTC emissions
    # IS the best path; kenlm is the lexicon-constrained beam with an LM
    w2l = getattr(args, "w2l_decoder", None)
    if w2l == "viterbi" and not args.ctc_decoding:
        args.ctc_decoding = "greedy"
    elif w2l == "kenlm":
        args.ctc_decoding = "beam"
        if not args.lexicon:
            raise ValueError("--w2l-decoder kenlm requires --lexicon")
        if not args.kenlm_model:
            raise ValueError("--w2l-decoder kenlm requires --kenlm-model (for a lexicon-only beam use "
                             "--ctc-decoding beam --lexicon ...)")

    itr = task.get_batch_iterator(
        dataset=task.dataset(args.gen_subset), max_tokens=args.max_tokens, max_sentences=args.max_sentences,
        max_positions=task.max_positions(), ignore_invalid_inputs=args.skip_invalid_size_inputs_valid_test,
        required_batch_size_multiple=args.required_batch_size_multiple,
        # exact batch-max padding: the batches are JAX's one for one
        bucket_shapes=False).next_epoch_itr(shuffle=False)
    if getattr(args, "ctc_decoding", None):
        generator = EmissionDecoder(args, models[0], tgt_dict, args.ctc_decoding)
    else:
        generator = task.build_generator(models, args)
    res_files = prepare_result_files(args)

    num_sentences = gen_tokens = 0
    gen_seconds = 0.0
    wer_errs = wer_total = uer_errs = uer_total = 0
    try:
        for sample in itr:
            if len(sample) == 0:
                continue
            prefix_tokens = sample["target"][:, : args.prefix_size] if args.prefix_size > 0 else None
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            hypos = task.inference_step(generator, models, sample, prefix_tokens)
            gen_seconds += time.perf_counter() - t0
            gen_tokens += sum(len(h[0]["tokens"]) for h in hypos if h)
            for i, sample_id in enumerate(np.asarray(sample["id"])):
                sample_id = int(sample_id)
                if sample_id < 0:
                    continue
                ref_words = ref_pieces = None
                if sample["target"] is not None:
                    target_tokens = np.asarray(sample["target"][i])
                    target_tokens = target_tokens[target_tokens != tgt_dict.pad()]
                    ref_words, ref_pieces = process_references(args, target_tokens, tgt_dict, sample_id, res_files)
                hyp_words, hyp_pieces = process_predictions(args, hypos[i], tgt_dict, sample_id, res_files)
                if ref_words is not None and hyp_words is not None:
                    wer_errs += edit_distance(ref_words.split(), hyp_words.split())
                    wer_total += len(ref_words.split())
                    uer_errs += edit_distance(ref_pieces.split(), hyp_pieces.split())
                    uer_total += len(ref_pieces.split())
                num_sentences += 1
    finally:
        for f in res_files.values():
            f.close()

    logger.info("| Processed {} sentences ({} tokens) in {:.1f}s ({:.2f} sentences/s, {:.2f} tokens/s)".format(
        num_sentences, gen_tokens, gen_seconds, num_sentences / max(gen_seconds, 1e-6),
        gen_tokens / max(gen_seconds, 1e-9)))
    wer = uer = None
    if wer_total > 0:
        wer = 100.0 * wer_errs / wer_total
        uer = 100.0 * uer_errs / max(uer_total, 1)
        logger.info("| WER: {:.2f}% ({}/{} word errors), UER: {:.2f}% ({}/{} unit errors)".format(
            wer, wer_errs, wer_total, uer, uer_errs, uer_total))
    return wer, uer


def cli_main(input_args=None):
    parser = options.get_generation_parser(default_task="speech_recognition")
    parser = add_asr_eval_argument(parser)
    args = options.parse_args_and_arch(parser, input_args)
    return main(args)


if __name__ == "__main__":
    cli_main()
