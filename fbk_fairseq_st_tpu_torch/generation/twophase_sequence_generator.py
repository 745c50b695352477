"""Two-phase (hierarchical) beam decoding for the multi-decoder models.

Counterpart of ``fbk_fairseq_st_tpu/generation/twophase_sequence_generator.py``
(reference twophase_sequence_generator.py):

  * the encoder runs once; its beam-replicated output serves both phases;
  * phase 1: a beam search with the auxiliary (transcript) decoder gives K
    transcript hypotheses a sentence (fewer are padded with the last one,
    none with a bare eos at score -1e9);
  * phase 2's preparation: one teacher-forced pass of the auxiliary decoder
    over all B*K transcripts (pads kept as pads) gives each its states;
  * phase 2: one target beam search whose K initial beams each carry one
    transcript, seeded at step 0 with the transcript's score
    (HierarchicalBeamSearch), so a final score is the joint one. The
    transcripts' pad mask follows the beams (``beam_ctx``), and so does any
    cache built over their states (the model's ``reorder_cache``);
  * each hypothesis carries ``transcript_tokens`` and ``transcript_score``
    of the transcript it descends from (its ``origin``).

The dual-decoder ignores the transcripts in phase 2, the triangle attends
them beside the encoder, the 2-stage decoder attends only them.
"""

from __future__ import annotations

from typing import Any, List, NamedTuple

import numpy as np
import torch

from ..device import module_device
from ..models.base import reorder_encoder_out
from .postprocess import collect_hypotheses
from .sequence_generator import EnsembleModel, SequenceGenerator


class _Adapter:
    """A view of a multi-decoder model as a one-decoder model for
    ``SequenceGenerator``."""

    def __init__(self, model, max_target_positions: int):
        self.model = model
        self.max_target_positions = max_target_positions

    @property
    def training(self) -> bool:
        return self.model.training

    def parameters(self):
        return self.model.parameters()


class _AuxAdapter(_Adapter):
    """The auxiliary decoder, for phase 1."""

    def __init__(self, model):
        super().__init__(model, model.aux_decoder_cfg.max_positions)

    def init_cache(self, batch, max_len, encoder_out, dtype=torch.float32):
        return self.model.init_aux_cache(batch, max_len, encoder_out, dtype)

    def decode_step(self, tokens, cache, step, encoder_out):
        return self.model.decode_aux_step(tokens, cache, step, encoder_out)

    def reorder_cache(self, cache, order) -> None:
        self.model.reorder_aux_cache(cache, order)


class _PackedEncOut(NamedTuple):
    """The encoder output beside the transcripts' auxiliary states, as the
    one encoder output phase 2's loop passes around."""

    enc: Any
    aux: Any

    @property
    def encoder_out(self):  # the loop reads the type from it
        return self.enc.encoder_out


class _TgtAdapter(_Adapter):
    """The target decoder with the per-beam transcripts, for phase 2."""

    def __init__(self, model):
        super().__init__(model, model.decoder_cfg.max_positions)

    def init_cache(self, batch, max_len, enc_pack: _PackedEncOut, dtype=torch.float32):
        return self.model.init_cache(batch, max_len, enc_pack.enc, dtype, aux_out=enc_pack.aux)

    def decode_step(self, tokens, cache, step, enc_pack: _PackedEncOut, aux_padding_mask=None):
        return self.model.decode_step(tokens, cache, step, enc_pack.enc, aux_padding_mask=aux_padding_mask)

    def reorder_cache(self, cache, order) -> None:
        self.model.reorder_cache(cache, order)


class TwoPhaseSequenceGenerator(SequenceGenerator):
    def __init__(self, src_dict, tgt_dict, **kwargs):
        super().__init__(tgt_dict, **kwargs)
        self.src_dict = src_dict
        self.aux_gen = SequenceGenerator(
            src_dict,
            beam_size=self.beam_size,
            max_len_a=self.max_len_a,
            max_len_b=self.max_len_b,
            min_len=self.min_len,
            normalize_scores=self.normalize_scores,
            len_penalty=self.len_penalty,
            unk_penalty=self.unk_penalty,
            temperature=self.temperature,
            match_source_len=self.match_source_len,
            no_repeat_ngram_size=self.no_repeat_ngram_size,
            seed=self.seed,
        )
        if self.aux_gen.beam_size < self.beam_size:
            # the shared encoder output is replicated for the target beam;
            # JAX fails here too, on the mismatched rows (ROADMAP Queue C)
            raise ValueError(f"beam {self.beam_size} needs a source dictionary of at least {self.beam_size + 1} "
                             f"symbols (it has {len(src_dict)})")

    @torch.no_grad()
    def generate(self, models, sample, prefix_tokens=None) -> List[List[dict]]:
        """models: one multi-decoder model in eval mode (a list of one);
        sample and prefix_tokens as ``SequenceGenerator.generate``'s (the
        prefix constrains both phases, as in JAX). Returns, per sentence,
        up to ``beam`` hypo dicts sorted by joint score, each with
        ``transcript_tokens`` and ``transcript_score``."""
        model = models[0]
        if model.training:
            raise ValueError("TwoPhaseSequenceGenerator needs the model in eval mode (call model.eval())")
        device = module_device(model)
        net_input = sample["net_input"]
        src_tokens = torch.as_tensor(net_input["src_tokens"], device=device)
        src_lengths = torch.as_tensor(net_input["src_lengths"], device=device)
        bsz, K = src_tokens.shape[0], self.beam_size
        max_len = self.max_len(src_tokens, src_lengths, model.max_target_positions)
        if prefix_tokens is not None:
            prefix_tokens = torch.as_tensor(prefix_tokens, device=device)

        # encode once, beam-replicate, share across both phases
        enc_rep = reorder_encoder_out(model.encode(src_tokens, src_lengths),
                                      torch.arange(bsz, device=device).repeat_interleave(K))

        # phase 1: transcripts with the auxiliary decoder
        aux_hypos = self.aux_gen.generate([_AuxAdapter(model)], sample, prefix_tokens=prefix_tokens,
                                          encoder_outs=[enc_rep])

        # the padded transcripts (B, K, S_aux) and their scores (B, K)
        src_pad, src_eos = self.src_dict.pad(), self.src_dict.eos()
        aux_len = max(2, max(max((len(h["tokens"]) for h in sent), default=1) for sent in aux_hypos))
        transcripts = np.full((bsz, K, aux_len), src_pad, np.int64)
        aux_scores = np.full((bsz, K), -1e9, np.float32)
        host_transcripts: List[List[np.ndarray]] = []
        for b, sent in enumerate(aux_hypos):
            row = []
            for k in range(K):
                if not sent:
                    row.append(np.array([src_eos], np.int64))
                    continue
                h = sent[min(k, len(sent) - 1)]
                toks = np.asarray(h["tokens"])
                transcripts[b, k, :len(toks)] = toks
                aux_scores[b, k] = h["score"]
                row.append(toks)
            host_transcripts.append(row)

        # phase 2's preparation: the auxiliary states of each transcript,
        # teacher-forced; positions past a transcript stay pad
        flat = torch.as_tensor(transcripts.reshape(bsz * K, aux_len), device=device)
        prev_aux = torch.cat([torch.full((bsz * K, 1), src_eos, dtype=flat.dtype, device=device), flat[:, :-1]],
                             dim=1)
        aux_padding_mask = flat == src_pad
        prev_aux = torch.where(aux_padding_mask, src_pad, prev_aux)
        aux_feats = model.aux_features(prev_aux, enc_rep)

        # phase 2: one target beam search seeded with the transcript scores
        fin = self._generate_impl(
            EnsembleModel([_TgtAdapter(model)]), src_tokens, src_lengths, max_len, prefix_tokens,
            encoder_outs=[_PackedEncOut(enc_rep, aux_feats)],
            init_scores=torch.as_tensor(aux_scores, device=device),
            beam_ctx={"aux_padding_mask": aux_padding_mask},
        )
        results = collect_hypotheses(fin, bsz, K)
        for b, sent in enumerate(results):
            for h in sent:
                origin = h["origin"]
                h["transcript_tokens"] = host_transcripts[b][min(origin, len(host_transcripts[b]) - 1)]
                h["transcript_score"] = float(aux_scores[b, min(origin, K - 1)])
        return results
