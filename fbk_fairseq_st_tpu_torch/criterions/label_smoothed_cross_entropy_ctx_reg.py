"""label_smoothed_cross_entropy_ctxreg: label-smoothed CE plus a penalty on
the context gates.

Counterpart of ``fbk_fairseq_st_tpu/criterions/label_smoothed_cross_entropy_ctx_reg.py``
(reference examples/speech_recognition/criterions/
label_smoothed_cross_entropy_ctx_reg.py:33-100): over the context-aware
model's ``(logits, extra)``,

    loss = LS-CE(target) + ctx_reg_alpha * sum over the gates of sum(gate)

where the gates are ``extra["ctx_gates"]``, one (B, T, D) ``1 - lam`` a
decoder layer in parallel mode, summed over every position, pads included,
as JAX sums them (ROADMAP Queue C, JAX side). The penalty is added only
when there are gates and alpha is not 0; it is summed in fp32. The logging
outputs and their reduction are label_smoothed_cross_entropy's.
"""

from __future__ import annotations

from .label_smoothed_cross_entropy import LabelSmoothedCrossEntropyCriterion


class LabelSmoothedCrossEntropyCtxRegCriterion(LabelSmoothedCrossEntropyCriterion):
    def __init__(self, task, args):
        super().__init__(task, args)
        self.alpha = getattr(args, "ctx_reg_alpha", 0.0)

    @classmethod
    def add_args(cls, parser):
        LabelSmoothedCrossEntropyCriterion.add_args(parser)
        parser.add_argument("--ctx-reg-alpha", default=0.0, type=float, metavar="D",
                            help="weight of the context-gate regularization penalty")

    def compute_loss(self, model, net_output, batch):
        loss, nll_loss = super().compute_loss(model, net_output, batch)
        gates = net_output[1].get("ctx_gates") or []
        if gates and self.alpha != 0.0:
            loss = loss + self.alpha * gate_penalty(gates)
        return loss, nll_loss


def gate_penalty(gates):
    """The sum of every gate's elements, in fp32."""
    return sum(g.float().sum() for g in gates)
