"""ASG criterion (``asg_loss``).

Counterpart of ``fbk_fairseq_st_tpu/criterions/asg.py`` (reference
criterions/ASG_loss.py:14, where it needs the external wav2letter
bindings; here the loss is native, ``ops/asg.py``).

The learned (V, V) transition matrix is the model's parameter
``asg_transitions`` (``models/w2l_conv_glu.py`` builds it under this
criterion), so the trainer's optimiser updates it with the rest. Replabel
packing, the eos -> silence replacement and the LinSeg targets are
data-dependent work on the host, done in ``prepare_sample`` (the trainer
calls it after the task's, and ``valid_step`` with ``training=False``);
``__call__`` reads the packed arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from ..data.replabels import pack_replabels
from ..ops.asg import SCALE_MODES, asg_loss
from .base import Criterion

# the packed targets and the sample's token count, which the model does not read
_ASG_KEYS = ("asg_target", "asg_target_lengths", "asg_ntokens")


class ASGCriterion(Criterion):
    @classmethod
    def add_args(cls, parser):
        group = parser.add_argument_group("ASG Loss")
        group.add_argument("--asg-transitions-init", type=float, default=0.0,
                           help="initial diagonal value of the transition matrix")
        group.add_argument("--max-replabel", type=int, default=2, help="maximum # of replabels")
        group.add_argument("--linseg-updates", type=int, default=0,
                           help="# of training updates using LinSeg initialization")
        group.add_argument("--hide-linseg-messages", action="store_true")
        group.add_argument("--asg-scale-mode", default="target_sz_sqrt", choices=list(SCALE_MODES),
                           help="loss scaling (wav2letter CriterionScaleMode; reference uses TARGET_SZ_SQRT)")

    def __init__(self, task, args):
        super().__init__(task, args)
        self.tgt_dict = task.target_dictionary
        self.eos = self.tgt_dict.eos()
        silence_token = getattr(args, "silence_token", "|")
        self.silence = self.tgt_dict.index(silence_token) if silence_token in self.tgt_dict.indices else None
        self.max_replabel = getattr(args, "max_replabel", 2)
        self.linseg_updates = getattr(args, "linseg_updates", 0)
        self.scale_mode = getattr(args, "asg_scale_mode", "target_sz_sqrt")
        self._linseg_announced = getattr(args, "hide_linseg_messages", False)

    def _replace_eos_with_silence(self, tgt):
        if not tgt or tgt[-1] != self.eos:
            return tgt
        if self.silence is None or (len(tgt) > 1 and tgt[-2] == self.silence):
            return tgt[:-1]
        return tgt[:-1] + [self.silence]

    def prepare_sample(self, sample, num_updates: int, training: bool = True):
        """The sample with ``asg_target`` (B, L) / ``asg_target_lengths``
        (the replabel-packed targets, cut to each utterance's frames,
        stretched over them by LinSeg in the first ``--linseg-updates``
        training updates) and ``asg_ntokens`` (the sample's token count
        before packing, which the reference divides by)."""
        if not sample or "net_input" not in sample:
            return sample
        target = np.asarray(sample["target"])
        lengths = np.asarray(sample.get("target_lengths", (target != self.padding_idx).sum(axis=1)))
        src_lengths = np.asarray(sample["net_input"]["src_lengths"])
        # reference linseg_step() is False out of training: validation
        # targets are never stretched
        use_linseg = training and num_updates < self.linseg_updates
        if use_linseg and not self._linseg_announced:
            print("| using LinSeg to initialize ASG")
            self._linseg_announced = True
        packed = []
        for b in range(target.shape[0]):
            n = int(lengths[b])
            if n == 0:
                # a shape bucket's padding row: a placeholder target, out
                # of the loss through its length 0
                packed.append([0])
                continue
            tgt = self._replace_eos_with_silence(target[b, :n].tolist())
            tgt = pack_replabels(tgt, self.tgt_dict, self.max_replabel)
            frames = int(src_lengths[b])
            tgt = tgt[:frames]
            if use_linseg:
                tgt = [tgt[t * len(tgt) // frames] for t in range(frames)]
            packed.append(tgt)
        asg_target = np.zeros((target.shape[0], max(len(t) for t in packed)), np.int32)
        asg_lengths = np.zeros((target.shape[0],), np.int32)
        for b, t in enumerate(packed):
            asg_target[b, : len(t)] = t
            asg_lengths[b] = len(t) if int(lengths[b]) > 0 else 0
        out = dict(sample)
        out["asg_target"] = asg_target
        out["asg_target_lengths"] = asg_lengths
        out["asg_ntokens"] = np.asarray(sample.get("ntokens", int(lengths.sum())), np.int64)
        return out

    def __call__(self, model, batch, generator=None, training: bool = False):
        model.train(training)
        logits, _ = model({k: v for k, v in batch.items() if k not in _ASG_KEYS}, generator)
        transitions = getattr(model, "asg_transitions", None)
        if transitions is None:
            transitions = torch.zeros((logits.shape[-1], logits.shape[-1]), device=logits.device)
        tgt_lengths = batch["asg_target_lengths"]
        losses = asg_loss(logits, transitions, batch["asg_target"], batch["src_lengths"],
                          torch.clamp(tgt_lengths, min=1), scale_mode=self.scale_mode)
        valid = (tgt_lengths > 0).to(losses.dtype)
        loss = torch.sum(losses * valid)
        ntokens = batch["asg_ntokens"] if "asg_ntokens" in batch else tgt_lengths.sum()
        nsentences = valid.sum()
        sample_size = nsentences.float() if self.sentence_avg else ntokens.float()
        logging_output = {
            "loss": loss.detach(),
            "ntokens": ntokens,
            "nsentences": nsentences,
            "sample_size": sample_size,
        }
        return loss, sample_size, logging_output
