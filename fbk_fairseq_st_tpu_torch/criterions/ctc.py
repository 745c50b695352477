"""CTC criterions: ``ctc_loss`` and the joint ``ctc_multi_loss``.

Counterpart of ``fbk_fairseq_st_tpu/criterions/ctc.py``:

  * ``CTCCriterion`` (``ctc_loss``, :41): the summed CTC NLL (zero_infinity)
    over the encoder's CTC logits, with the unit error rate logged from a
    greedy decode and ``ops/edit_distance.levenshtein``, both on the device;
  * ``CTCMultiLoss`` (``ctc_multi_loss``, :126): one forward pass; the CTC
    logits are the encoder's ``ctc_out`` (layer ``ctc_encoder_layer``), and
    ``loss = ctc_weight * ctc + underlying`` where the underlying criterion
    (``underlying_criterion``) computes on the decoder output of the same
    pass. The returned sample size is the CTC one, the transcript token
    count (:196, :208), while ``logging_output["sample_size"]`` is the
    target token count: the trainer divides the gradients by the returned
    one, as the JAX trainer does.

``reduce_metrics`` gives the values the JAX ``reduce_metrics`` logs
(base 2, unrounded) as a dict of floats; it reads the logging outputs on
the host.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

from ..ops.ctc import ctc_greedy_decode, ctc_loss
from ..ops.edit_distance import levenshtein
from .base import Criterion, get_perplexity, log_scalars, sum_logs


def _ctc_uer(ctc_logits, input_lengths, targets, target_lengths, blank_idx: int):
    """(errors, total) of compute_ctc_uer, on the device."""
    with torch.no_grad():
        pred, pred_counts = ctc_greedy_decode(ctc_logits, input_lengths, blank_idx)
        errors = levenshtein(pred, pred_counts, targets, target_lengths)
        return errors.sum(), target_lengths.sum()


class CTCCriterion(Criterion):
    """Encoder-only CTC training; the blank is the target dictionary's
    ``<ctc_blank>``."""

    def __init__(self, task, args):
        super().__init__(task, args)
        self.blank_idx = task.target_dictionary.index("<ctc_blank>")
        self.use_source_side_sample_size = getattr(args, "use_source_side_sample_size", False)

    @classmethod
    def add_args(cls, parser):
        parser.add_argument("--use-source-side-sample-size", action="store_true", default=False,
                            help="when compute average loss, using number of source tokens as denominator. "
                            "This argument will be no-op if sentence-avg is used.")

    def __call__(self, model, batch, generator=None, training: bool = False):
        model.train(training)
        encoder_out = model.encode(batch["src_tokens"], batch["src_lengths"], generator)
        logits = encoder_out.encoder_out if encoder_out.ctc_out is None else encoder_out.ctc_out
        input_lengths = encoder_out.src_lengths if encoder_out.ctc_lengths is None else encoder_out.ctc_lengths
        targets, target_lengths = batch["target"], batch["target_lengths"]
        loss = ctc_loss(logits, input_lengths, targets, target_lengths, blank_id=self.blank_idx)
        errors, total = _ctc_uer(logits, input_lengths, targets, target_lengths, self.blank_idx)
        ntokens = target_lengths.sum()
        nsentences = torch.full((), targets.shape[0], dtype=torch.int64, device=targets.device)
        if self.sentence_avg:
            sample_size = nsentences
        elif self.use_source_side_sample_size:
            sample_size = input_lengths.sum()
        else:
            sample_size = ntokens
        logging_output = {
            "loss": loss.detach(),
            "ntokens": ntokens,
            "nsentences": nsentences,
            "sample_size": sample_size,
            "errors": errors,
            "total": total,
            "nframes": batch["src_lengths"].sum(),
        }
        return loss, sample_size, logging_output

    @staticmethod
    def reduce_metrics(logging_outputs: List[dict], metrics=None) -> Dict[str, float]:
        loss_sum = sum_logs(logging_outputs, "loss")
        ntokens = sum_logs(logging_outputs, "ntokens")
        sample_size = sum_logs(logging_outputs, "sample_size")
        errors, total = sum_logs(logging_outputs, "errors"), sum_logs(logging_outputs, "total")
        out = {"loss": loss_sum / sample_size / math.log(2)}
        entries = [("loss", out["loss"], sample_size, 3)]
        if total > 0:
            out["acc"] = 100.0 - min(errors * 100.0 / total, 100.0)
            entries.append(("acc", out["acc"], 1, 3))
        if sample_size != ntokens:
            out["nll_loss"] = loss_sum / ntokens / math.log(2)
            entries.append(("nll_loss", out["nll_loss"], ntokens, 3))
        log_scalars(metrics, entries)
        return out


class CTCMultiLoss(Criterion):
    """CTC on the encoder's layer-k logits plus the underlying criterion on
    the decoder output of the same forward pass; the blank and the
    transcript pad come from the source dictionary."""

    def __init__(self, task, args):
        super().__init__(task, args)
        if task.source_dictionary is None:
            raise ValueError("ctc_multi_loss needs a task with a source dictionary "
                             "(speech_translation_with_transcription)")
        self.blank_idx = task.source_dictionary.index("<ctc_blank>")
        self.src_pad_idx = task.source_dictionary.pad()
        self.ctc_weight = getattr(args, "ctc_weight", 1.0)
        self.real_criterion = self.build_real_criterion(args, task)

    @classmethod
    def add_args(cls, parser):
        CTCCriterion.add_args(parser)
        parser.add_argument("--ctc-encoder-layer", default=6, type=int, metavar="LAYER_NUM",
                            help="The encoder layer whose feature are used to compute the CTC loss")
        parser.add_argument("--ctc-weight", default=1.0, type=float, metavar="W",
                            help="The relative weight to assign to the CTC loss")
        parser.add_argument("--underlying-criterion", type=str, metavar="VAL", required=True,
                            help="underlying criterion to use for the model output loss")

    @staticmethod
    def build_real_criterion(args, task):
        from . import CRITERIONS, roadmap_item

        name = args.underlying_criterion
        if name in ("ctc_multi_loss", "ctc_loss"):
            raise NotImplementedError(f"--underlying-criterion {name}: a CTC criterion cannot be the underlying one")
        if name not in CRITERIONS:
            raise NotImplementedError(f"--underlying-criterion {name} is not ported ({roadmap_item(name)})")
        return CRITERIONS[name].build_criterion(args, task)

    def __call__(self, model, batch, generator=None, training: bool = False):
        model.train(training)
        net_output = model(batch, generator)
        encoder_out = net_output[1]["encoder_out"]
        if encoder_out.ctc_out is None:
            raise ValueError("ctc_multi_loss needs a model emitting ctc_out (conv_transformer builds "
                             "ctc_fc when criterion == ctc_multi_loss)")
        ctc_logits = encoder_out.ctc_out
        ctc_lengths = encoder_out.src_lengths if encoder_out.ctc_lengths is None else encoder_out.ctc_lengths
        transcripts, transcript_lengths = batch["transcript_target"], batch["transcript_target_lengths"]
        ctc = ctc_loss(ctc_logits, ctc_lengths, transcripts, transcript_lengths, blank_id=self.blank_idx)
        errors, total = _ctc_uer(ctc_logits, ctc_lengths, transcripts, transcript_lengths, self.blank_idx)
        real_loss, real_nll = self.real_criterion.compute_loss(model, net_output, batch)
        loss = self.ctc_weight * ctc + real_loss

        target = batch["target"]
        ntokens = (target != self.padding_idx).sum()
        nsentences = torch.full((), target.shape[0], dtype=torch.int64, device=target.device)
        logging_output = {
            "loss": loss.detach(),
            "nll_loss": real_nll.detach(),
            "ctc_loss": ctc.detach(),
            "ntokens": ntokens,
            "nsentences": nsentences,
            "sample_size": nsentences if self.sentence_avg else ntokens,
            "ctc_errors": errors,
            "ctc_total": total,
            "nframes": batch["src_lengths"].sum(),
        }
        return loss, transcript_lengths.sum(), logging_output

    @staticmethod
    def reduce_metrics(logging_outputs: List[dict], metrics=None) -> Dict[str, float]:
        loss_sum = sum_logs(logging_outputs, "loss")
        ctc_loss_sum = sum_logs(logging_outputs, "ctc_loss")
        if logging_outputs and "nll_loss" in logging_outputs[0]:
            nll_loss_sum = sum_logs(logging_outputs, "nll_loss")
        else:
            nll_loss_sum = loss_sum - ctc_loss_sum
        ntokens = sum_logs(logging_outputs, "ntokens")
        sample_size = sum_logs(logging_outputs, "sample_size")
        ctc_errors, ctc_total = sum_logs(logging_outputs, "ctc_errors"), sum_logs(logging_outputs, "ctc_total")
        out = {
            "loss": loss_sum / sample_size / math.log(2),
            "nll_loss": nll_loss_sum / ntokens / math.log(2),
            "ctc_loss": ctc_loss_sum / sample_size / math.log(2),
        }
        out["ppl"] = get_perplexity(out["nll_loss"])
        entries = [("loss", out["loss"], sample_size, 3), ("nll_loss", out["nll_loss"], ntokens, 3)]
        log_scalars(metrics, entries)
        if metrics is not None:
            metrics.log_derived("ppl", lambda meters: get_perplexity(meters["nll_loss"].avg))
        entries = [("ctc_loss", out["ctc_loss"], sample_size, 3)]
        if ctc_total > 0:
            out["ctc_acc"] = 100.0 - min(ctc_errors * 100.0 / ctc_total, 100.0)
            entries.append(("ctc_acc", out["ctc_acc"], 1, None))
        out["nframes"] = sum_logs(logging_outputs, "nframes")
        entries.append(("nframes", out["nframes"], 1, None))
        log_scalars(metrics, entries)
        return out
