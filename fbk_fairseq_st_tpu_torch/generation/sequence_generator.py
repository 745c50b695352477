"""Batched beam search over a fixed-shape state.

Counterpart of ``fbk_fairseq_st_tpu/generation/sequence_generator.py``
(reference fairseq/sequence_generator.py:18-651). The JAX ``while_loop``
body (:288-497) becomes a Python loop over the same fixed-shape state and
the same decision procedure:

  * max_len = min(a*src_len + b, model_max - 1);
  * the encoder runs once and is beam-replicated by a batch gather;
  * per step: pad masked, unk penalized, min_len masks eos, step == max_len
    forces eos, prefix-token constraints, no-repeat-ngram banning;
  * ``search.step`` over (B, K, V) cumulative scores returns 2K candidates;
  * eos candidates within the top K finalize into K slots with the score
    normalized by (step+1)**len_penalty; the remaining top K non-eos
    candidates continue (the active-mask / blacklist mechanics);
  * finished sentences keep their rows frozen; every model's incremental
    caches follow the surviving beams by one flat (B*K) order, which the
    model applies in its ``reorder_cache(cache, order)`` (fairseq's
    ``reorder_incremental_state``; the JAX loop gathers every cache leaf).

The source is whatever the models' ``encode`` takes: (B, T, F) fbank frames
for conv_transformer, (B, T) token ids for lightconv. The loop stops when
every sentence is finished or step > max_len, which costs one host sync per
step. A model may leave caches that hold only encoder rows (the
cross-attention K/V) as they are: the flat order only permutes rows within
a sentence, whose encoder rows are identical, so the gather would return
the same tensor.

For the two-phase generator (``twophase_sequence_generator.py``), as JAX
:222-246: ``generate(..., encoder_outs=)`` takes already beam-replicated
encoder outputs and skips the encoder; ``_generate_impl(...,
init_scores=)`` starts every beam active at step 0 with its (B, K) score,
and ``beam_ctx``, a dict of (B*K, ...) tensors, follows the beams and goes
to ``decode_step`` as keyword arguments. Each hypothesis carries the
``origin``, the initial beam it descends from. ``temperature`` divides the
logits; ``match_source_len`` sets max_len to the longest source.

The options of JAX's generator (:100-102, :130): ``search_strategy`` (any
of ``search.py``'s; ``Sampling`` draws from a ``torch.Generator`` on the
device seeded from ``seed`` at each call), the ``eos`` override and
``generate(bos_token=)``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch

from ..device import module_device
from ..models.base import reorder_encoder_out
from ..ops.core import NEG_INF
from .postprocess import collect_hypotheses
from .search import BeamSearch, top_k


class EnsembleModel:
    """Log-prob averaging over models, each with its own caches
    (reference sequence_generator.py:653-800)."""

    def __init__(self, models):
        self.models = list(models)

    def max_decoder_positions(self) -> int:
        return min(m.max_target_positions for m in self.models)

    def forward_encoder(self, src_tokens, src_lengths):
        return [m.encode(src_tokens, src_lengths) for m in self.models]

    def init_caches(self, encoder_outs, batch: int, max_len: int, dtype):
        return [
            m.init_cache(batch, max_len, enc, dtype)
            for m, enc in zip(self.models, encoder_outs)
        ]

    def reorder_caches(self, caches, order) -> None:
        for m, cache in zip(self.models, caches):
            m.reorder_cache(cache, order)

    def forward_decoder(self, tokens, encoder_outs, caches, step: int, temperature: float = 1.0,
                        **decode_kwargs):
        """tokens (BK, 1) -> averaged log-probs (BK, V); caches are written
        in place."""
        lprobs_all = []
        for m, enc, cache in zip(self.models, encoder_outs, caches):
            logits = m.decode_step(tokens, cache, step, enc, **decode_kwargs).float()
            if temperature != 1.0:
                logits = logits / temperature
            lprobs_all.append(torch.log_softmax(logits, dim=-1))
        if len(lprobs_all) == 1:
            return lprobs_all[0]
        return torch.logsumexp(torch.stack(lprobs_all), dim=0) - math.log(len(lprobs_all))


def _scatter_drop(buf, slots, values):
    """``buf[b, slots[b, j]] = values[b, j]`` for slots < K; slot K is
    dropped (the JAX ``.at[s].set(mode="drop")``)."""
    k = buf.shape[1]
    ext = torch.cat([buf, buf[:, :1]], dim=1)
    index = slots.reshape(slots.shape + (1,) * (buf.dim() - 2)).expand(values.shape)
    ext.scatter_(1, index, values)
    return ext[:, :k]


def _gather_rows(buf, index):
    """``buf[b, index[b, j]]`` over the beam axis of a (B, K, T) buffer."""
    return buf.gather(1, index[:, :, None].expand(-1, -1, buf.shape[2]))


class SequenceGenerator:
    def __init__(
        self,
        tgt_dict,
        beam_size: int = 1,
        max_len_a: float = 0,
        max_len_b: int = 200,
        min_len: int = 1,
        normalize_scores: bool = True,
        len_penalty: float = 1.0,
        unk_penalty: float = 0.0,
        temperature: float = 1.0,
        match_source_len: bool = False,
        no_repeat_ngram_size: int = 0,
        search_strategy=None,
        seed: int = 1,
        eos: Optional[int] = None,
    ):
        self.tgt_dict = tgt_dict
        self.pad = tgt_dict.pad()
        self.unk = tgt_dict.unk()
        # the eos override: generation may end on another token than </s>
        # (mBART-style language tokens, reference
        # translation_from_pretrained_bart.py:92-104)
        self.eos = eos if eos is not None else tgt_dict.eos()
        self.vocab_size = len(tgt_dict)
        self.beam_size = min(beam_size, self.vocab_size - 1)
        self.max_len_a = max_len_a
        self.max_len_b = max_len_b
        self.min_len = min_len
        self.normalize_scores = normalize_scores
        self.len_penalty = len_penalty
        self.unk_penalty = unk_penalty
        self.temperature = temperature
        self.match_source_len = match_source_len
        self.no_repeat_ngram_size = no_repeat_ngram_size
        self.search = search_strategy or BeamSearch(tgt_dict)
        self.seed = seed

    @torch.no_grad()
    def generate(self, models, sample, prefix_tokens=None, bos_token=None,
                 encoder_outs=None) -> List[List[dict]]:
        """models: a list of models (or an EnsembleModel), in eval mode, all
        on one device; sample: {"net_input": {"src_tokens", "src_lengths":
        (B,)}} as tensors or numpy arrays, src_tokens (B, T, F) fbank frames
        or (B, T) token ids as the models take them. ``bos_token``: the
        first decoder input instead of eos. ``encoder_outs``: one per
        model, already beam-replicated ([s0 x K, s1 x K, ...]); the
        encoders are not run then.

        Returns, per sentence, up to ``beam`` hypo dicts sorted by score
        descending: {tokens, score, positional_scores, alignment, origin}."""
        ensemble = models if isinstance(models, EnsembleModel) else EnsembleModel(models)
        if any(m.training for m in ensemble.models):
            raise ValueError("SequenceGenerator needs models in eval mode (call model.eval())")
        device = module_device(ensemble.models[0])
        net_input = sample["net_input"]
        src_tokens = torch.as_tensor(net_input["src_tokens"], device=device)
        src_lengths = torch.as_tensor(net_input["src_lengths"], device=device)
        bsz = src_tokens.shape[0]
        max_len = self.max_len(src_tokens, src_lengths, ensemble.max_decoder_positions())
        if prefix_tokens is not None:
            prefix_tokens = torch.as_tensor(prefix_tokens, device=device)
        fin = self._generate_impl(ensemble, src_tokens, src_lengths, max_len, prefix_tokens,
                                  encoder_outs=encoder_outs, bos_token=bos_token)
        return collect_hypotheses(fin, bsz, self.beam_size)

    def max_len(self, src_tokens, src_lengths, max_positions: int) -> int:
        """The step limit: the longest source with ``match_source_len``,
        else min(a * src_len + b, max_positions - 1); at least min_len."""
        if self.match_source_len:
            max_len = int(src_lengths.max())
        else:
            max_len = min(int(self.max_len_a * int(src_tokens.shape[1]) + self.max_len_b), max_positions - 1)
        return max(max_len, self.min_len)

    def _generate_impl(self, ensemble, src_tokens, src_lengths, max_len: int, prefix_tokens,
                       encoder_outs=None, init_scores=None, beam_ctx=None,
                       bos_token=None) -> Dict[str, np.ndarray]:
        device = src_tokens.device
        if hasattr(self.search, "src_lengths"):
            self.search.src_lengths = src_lengths  # the length-constrained search's bounds
        # Sampling's draws: one generator a call, seeded from ``seed``
        rng = torch.Generator(device=device).manual_seed(self.seed) if self.search.needs_rng else None
        bsz = src_tokens.shape[0]
        K = self.beam_size
        T = max_len + 2
        V = self.vocab_size
        CAND = 2 * K

        if encoder_outs is None:
            encoder_outs = ensemble.forward_encoder(src_tokens, src_lengths)
            # replicate each sentence K times: order [s0 x K, s1 x K, ...]
            new_order = torch.arange(bsz, device=device).repeat_interleave(K)
            encoder_outs = [reorder_encoder_out(e, new_order) for e in encoder_outs]
        beam_ctx = dict(beam_ctx or {})
        dtype = encoder_outs[0].encoder_out.dtype
        caches = ensemble.init_caches(encoder_outs, bsz * K, T, dtype)

        def full(shape, value, dt):
            return torch.full(shape, value, dtype=dt, device=device)

        tokens = full((bsz, K, T), self.pad, torch.long)
        tokens[:, :, 0] = self.eos if bos_token is None else bos_token
        scores = full((bsz, K, T), 0.0, torch.float32)
        blacklist = full((bsz, K), False, torch.bool)
        fin_tokens = full((bsz, K, T), self.pad, torch.long)
        fin_cum = full((bsz, K, T), 0.0, torch.float32)
        fin_score = full((bsz, K), -math.inf, torch.float32)
        fin_len = full((bsz, K), 0, torch.long)
        fin_origin = full((bsz, K), 0, torch.long)
        fin_count = full((bsz,), 0, torch.long)
        finished = full((bsz,), False, torch.bool)
        origin = torch.arange(K, device=device)[None, :].repeat(bsz, 1)

        vocab = torch.arange(V, device=device)
        is_eos_tok = (vocab == self.eos)[None, None, :]
        step_pos = torch.arange(T, device=device)[None, None, :]
        cand_range = torch.arange(CAND, device=device)[None, :]
        flat_base = torch.arange(bsz, device=device)[:, None] * K
        identity_order = torch.arange(bsz * K, device=device)

        step = 0
        while step <= max_len and not bool(finished.all()):
            cur = tokens.reshape(bsz * K, T)[:, step:step + 1]
            lprobs = ensemble.forward_decoder(cur, encoder_outs, caches, step, self.temperature,
                                              **beam_ctx).reshape(bsz, K, V)

            # pad never generated; unk penalized
            lprobs = torch.where((vocab == self.pad)[None, None, :], NEG_INF, lprobs)
            if self.unk_penalty != 0:
                lprobs = torch.where(
                    (vocab == self.unk)[None, None, :], lprobs - self.unk_penalty, lprobs
                )
            # min/max length
            if step < self.min_len:
                lprobs = torch.where(is_eos_tok, NEG_INF, lprobs)
            if step >= max_len:
                lprobs = torch.where(~is_eos_tok, NEG_INF, lprobs)

            if prefix_tokens is not None:
                plen = prefix_tokens.shape[1]
                ptok = prefix_tokens[:, min(step, plen - 1)].long()
                valid_prefix = (ptok != self.pad) & (step < plen)
                keep = vocab[None, None, :] == ptok[:, None, None]
                plp = lprobs.gather(2, ptok[:, None, None].expand(bsz, K, 1))
                constrained = torch.where(keep, plp, NEG_INF)
                lprobs = torch.where(valid_prefix[:, None, None], constrained, lprobs)

            if self.no_repeat_ngram_size > 0:
                lprobs = _ban_repeated_ngrams(tokens, lprobs, step, self.no_repeat_ngram_size)

            # blacklisted beams must not produce candidates
            lprobs = torch.where(blacklist[:, :, None], NEG_INF, lprobs)
            search_step = step
            if step > 0:
                prev_cum = scores[:, :, step - 1]
            elif init_scores is None:
                prev_cum = torch.zeros((bsz, K), dtype=torch.float32, device=device)
            else:
                # hierarchical step 0: every beam active, seeded with its score
                prev_cum, search_step = init_scores, 1

            cand_scores, cand_tokens, cand_beams = self.search.step(search_step, lprobs, prev_cum, rng)

            # ---- finalization ----
            eos_mask = (cand_tokens == self.eos) & (cand_scores > NEG_INF / 2)
            eos_topk = eos_mask.clone()
            eos_topk[:, K:] = False  # only the top K finalize
            norm = torch.tensor(step + 1.0, dtype=torch.float32) ** self.len_penalty
            cand_norm = cand_scores / norm.item() if self.normalize_scores else cand_scores

            can_fin = eos_topk & ~finished[:, None]
            rank = torch.cumsum(can_fin.long(), dim=1) - 1
            slot = fin_count[:, None] + rank
            valid_fin = can_fin & (slot < K)
            slot_safe = torch.where(valid_fin, slot, K)

            fin_rows = _gather_rows(tokens, cand_beams)
            fin_rows = torch.where(step_pos == step + 1, self.eos, fin_rows)
            fin_rows = torch.where(step_pos > step + 1, self.pad, fin_rows)
            cum_rows = _gather_rows(scores, cand_beams)
            cum_rows = torch.where(step_pos == step, cand_scores[:, :, None], cum_rows)
            cum_rows = torch.where(step_pos > step, 0.0, cum_rows)

            fin_tokens = _scatter_drop(fin_tokens, slot_safe, fin_rows)
            fin_cum = _scatter_drop(fin_cum, slot_safe, cum_rows)
            fin_score = _scatter_drop(
                fin_score, slot_safe, torch.where(valid_fin, cand_norm, -math.inf)
            )
            fin_len = _scatter_drop(fin_len, slot_safe, torch.full_like(slot_safe, step + 2))
            fin_origin = _scatter_drop(fin_origin, slot_safe, origin.gather(1, cand_beams))
            fin_count = fin_count + valid_fin.long().sum(dim=1)
            new_finished = finished | (fin_count >= K) | (step >= max_len)

            # ---- active selection: eos candidates go behind all non-eos
            # ones, the K smallest ranks continue; a selected eos/dead
            # candidate blacklists its beam ----
            active_mask = cand_range + eos_mask.long() * CAND
            _, active_hypos = top_k(-active_mask, K)
            active_hypos = torch.sort(active_hypos, dim=1).values
            new_blacklist = active_mask.gather(1, active_hypos) >= CAND

            sel_beams = cand_beams.gather(1, active_hypos)
            sel_tokens = cand_tokens.gather(1, active_hypos)
            sel_scores = cand_scores.gather(1, active_hypos)
            new_blacklist = new_blacklist | (sel_scores < NEG_INF / 2)

            new_tokens = _gather_rows(tokens, sel_beams)
            new_tokens = torch.where(step_pos == step + 1, sel_tokens[:, :, None], new_tokens)
            new_scores = _gather_rows(scores, sel_beams)
            new_scores = torch.where(step_pos == step, sel_scores[:, :, None], new_scores)
            new_origin = origin.gather(1, sel_beams)

            # frozen rows for finished sentences
            frozen = finished[:, None]
            tokens = torch.where(frozen[:, :, None], tokens, new_tokens)
            scores = torch.where(frozen[:, :, None], scores, new_scores)
            blacklist = torch.where(frozen, blacklist, new_blacklist)
            origin = torch.where(frozen, origin, new_origin)

            # reorder the incremental caches: one flat (B*K) order
            flat_order = (flat_base + sel_beams).reshape(-1)
            flat_order = torch.where(finished.repeat_interleave(K), identity_order, flat_order)
            ensemble.reorder_caches(caches, flat_order)
            beam_ctx = {k: v.index_select(0, flat_order) for k, v in beam_ctx.items()}

            finished = new_finished
            step += 1

        fin = {
            "fin_tokens": fin_tokens, "fin_cum": fin_cum, "fin_score": fin_score,
            "fin_len": fin_len, "fin_origin": fin_origin, "fin_count": fin_count,
        }
        return {k: v.cpu().numpy() for k, v in fin.items()}


def _ban_repeated_ngrams(tokens, lprobs, step: int, n: int):
    """no-repeat-ngram (reference sequence_generator.py:617-651): ban token v
    if the (n-1)-gram ending at the current position followed by v occurred
    before. tokens: (B, K, T) incl. the leading eos; bans apply from step
    n-1."""
    b, k, t = tokens.shape
    v = lprobs.shape[-1]
    pos = torch.arange(t, device=tokens.device)
    if n <= 1:
        # ban any previously generated token
        prev = ((pos >= 1) & (pos <= step))[None, None, :]
        index = torch.where(prev, tokens, v)
    else:
        if step < n - 1:
            return lprobs
        # context: the last n-1 generated tokens (positions step-n+2 .. step)
        ctx_idx = torch.clamp(torch.arange(n - 1, device=tokens.device) + (step - (n - 2)), 0, t - 1)
        context = tokens[:, :, ctx_idx]
        # prior (n-1)-grams starting at p in [1, step-n+2], next token at p+n-1
        gram_idx = torch.clamp(pos[:, None] + torch.arange(n - 1, device=tokens.device)[None, :], 0, t - 1)
        grams = tokens[:, :, gram_idx]  # (B, K, T, n-1)
        next_tok = tokens[:, :, torch.clamp(pos + (n - 1), 0, t - 1)]
        valid = (pos >= 1) & (pos + (n - 1) <= step)
        match = (grams == context[:, :, None, :]).all(dim=-1) & valid[None, None, :]
        index = torch.where(match, next_tok, v)
    banned = torch.zeros((b, k, v + 1), dtype=torch.bool, device=tokens.device)
    banned.scatter_(2, index, True)
    return torch.where(banned[..., :v], NEG_INF, lprobs)
