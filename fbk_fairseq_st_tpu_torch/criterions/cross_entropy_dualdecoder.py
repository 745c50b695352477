"""cross_entropy_dualdecoder: label-smoothed CE on both decoders, weighted.

Counterpart of ``fbk_fairseq_st_tpu/criterions/cross_entropy_dualdecoder.py``
(reference criterions/cross_entropy_dualdecoder.py:9-97): ``loss =
primary_weight * LS-CE(target) + auxiliary_weight * LS-CE(transcript)``
over the model's ``((logits, extra), (aux_logits, aux_extra))``, with the
target dictionary's pad ignored on both sides, as JAX ignores it. The
sample size is the target token count (nsentences with ``sentence_avg``);
each part is logged, and ``reduce_metrics`` gives both perplexities.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

from .base import Criterion, get_perplexity, log_scalars, sum_logs
from .label_smoothed_cross_entropy import label_smoothed_nll_from_logits


class CrossEntropyDualDecoder(Criterion):
    def __init__(self, task, args):
        super().__init__(task, args)
        self.eps = getattr(args, "label_smoothing", 0.0)
        self.primary_loss_weight = getattr(args, "primary_loss_weight", 0.5)
        self.auxiliary_loss_weight = getattr(args, "auxiliary_loss_weight", 0.5)

    def compute_loss(self, model, net_output, batch):
        """(loss, the primary nll) of ``net_output``, summed."""
        loss, parts = self._losses(model, net_output, batch)
        return loss, parts["primary_nll_loss"]

    def _losses(self, model, net_output, batch):
        decoder_out, aux_out = net_output
        primary_loss, primary_nll = label_smoothed_nll_from_logits(
            decoder_out[0], batch["target"], self.eps, self.padding_idx)
        aux_loss, aux_nll = label_smoothed_nll_from_logits(
            aux_out[0], model.get_auxiliary_target(batch, aux_out), self.eps, self.padding_idx)
        loss = self.primary_loss_weight * primary_loss + self.auxiliary_loss_weight * aux_loss
        return loss, {"primary_loss": primary_loss, "primary_nll_loss": primary_nll,
                      "auxiliary_loss": aux_loss, "auxiliary_nll_loss": aux_nll}

    @classmethod
    def add_args(cls, parser):
        parser.add_argument("--primary-loss-weight", default=0.5, type=float, metavar="W",
                            help="The weight to apply to the primary loss function when summing losses")
        parser.add_argument("--auxiliary-loss-weight", default=0.5, type=float, metavar="W",
                            help="The weight to apply to the auxiliary loss function when summing losses")
        parser.add_argument("--label-smoothing", default=0.0, type=float, metavar="D",
                            help="epsilon for label smoothing, 0 means no label smoothing")

    def __call__(self, model, batch, generator=None, training: bool = False):
        model.train(training)
        net_output = model(batch, generator)
        loss, parts = self._losses(model, net_output, batch)
        target = batch["target"]
        ntokens = (target != self.padding_idx).sum()
        nsentences = torch.full((), target.shape[0], dtype=torch.int64, device=target.device)
        sample_size = nsentences if self.sentence_avg else ntokens
        logging_output = {
            "loss": loss.detach(),
            **{k: v.detach() for k, v in parts.items()},
            "ntokens": ntokens,
            "auxiliary_ntokens": model.get_auxiliary_token_lens(batch).sum(),
            "nsentences": nsentences,
            "sample_size": sample_size,
        }
        return loss, sample_size, logging_output

    @staticmethod
    def reduce_metrics(logging_outputs: List[dict], metrics=None) -> Dict[str, float]:
        """The values the JAX ``reduce_metrics`` logs (base 2), with the
        perplexities of the two nll losses; logged as JAX logs them when
        ``metrics`` is given."""
        total = {k: sum_logs(logging_outputs, k) for k in (
            "loss", "primary_loss", "auxiliary_loss", "primary_nll_loss", "auxiliary_nll_loss", "ntokens",
            "auxiliary_ntokens", "sample_size")}
        sample_size, ln2 = total["sample_size"], math.log(2)
        out = {k: total[k] / sample_size / ln2 for k in ("loss", "primary_loss", "auxiliary_loss")}
        out["primary_nll_loss"] = total["primary_nll_loss"] / total["ntokens"] / ln2
        entries = [(k, out[k], sample_size, 3) for k in ("loss", "primary_loss", "auxiliary_loss")]
        entries.append(("primary_nll_loss", out["primary_nll_loss"], total["ntokens"], 3))
        out["primary_ppl"] = get_perplexity(out["primary_nll_loss"])
        if total["auxiliary_ntokens"] > 0:
            out["auxiliary_nll_loss"] = total["auxiliary_nll_loss"] / total["auxiliary_ntokens"] / ln2
            out["auxiliary_ppl"] = get_perplexity(out["auxiliary_nll_loss"])
            entries.append(("auxiliary_nll_loss", out["auxiliary_nll_loss"], total["auxiliary_ntokens"], 3))
        log_scalars(metrics, entries)
        if metrics is not None:
            metrics.log_derived("primary_ppl", lambda meters: get_perplexity(meters["primary_nll_loss"].avg))
            metrics.log_derived("auxiliary_ppl", lambda meters: get_perplexity(
                meters["auxiliary_nll_loss"].avg if "auxiliary_nll_loss" in meters else None))
        return out
