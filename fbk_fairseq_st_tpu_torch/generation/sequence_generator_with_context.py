"""Context-chained beam search for the context-aware model (INTERSPEECH 2020).

Counterpart of ``fbk_fairseq_st_tpu/generation/sequence_generator_with_context.py``
(reference examples/speech_recognition/sequence_generator_with_context.py):
the generator keeps a ``buffer`` across ``generate`` calls, so each
utterance's context is what came before it in corpus order (the task's
unshuffled batches):

  * Target: the buffer starts as ``[[eos]]``; every row of a batch gets it
    tiled as its context; after the call it becomes the best hypothesis
    of the batch's last row, eos included. Real chaining needs batches of
    one utterance (``--max-sentences 1``); a larger batch gives every row
    the previous batch's last hypothesis, as JAX does (ROADMAP Queue C,
    JAX side);
  * Audio: the buffer starts empty, read as zeros of the batch's (T, F);
    in a batch of one the context is the previous utterance's padded
    frames; in a larger batch row i's context is row i-1's audio, row 0's
    the buffer, each padded to the longer of the two; after the call the
    buffer is the batch's last ``src_tokens`` row.

Each call is one beam search (``SequenceGenerator._generate_impl``) over the
first model, whose encoder takes the context and whose EncoderOut carries
the encoded context, replicated over the beams with the rest. As JAX's,
the generator ignores ``prefix_tokens`` and runs plain beam search whatever
the search-strategy options say.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..device import module_device
from .postprocess import collect_hypotheses
from .sequence_generator import EnsembleModel, SequenceGenerator


class _ContextEnsemble(EnsembleModel):
    """One model whose encoder takes the batch's context."""

    def __init__(self, model, context_tokens, context_lengths):
        super().__init__([model])
        self.context = (context_tokens, context_lengths)

    def forward_encoder(self, src_tokens, src_lengths):
        tokens, lengths = self.context
        return [self.models[0].encode(src_tokens, src_lengths, context_tokens=tokens, context_lengths=lengths)]


class ContextAwareSequenceGenerator(SequenceGenerator):
    def __init__(self, tgt_dict, **kwargs):
        kwargs.pop("match_source_len", None)
        super().__init__(tgt_dict, **kwargs)
        self.buffer = self.default_buffer

    @property
    def default_buffer(self):
        raise NotImplementedError

    def next_batch_context(self, src_tokens: np.ndarray, buffer):
        """(context (B, ...), lengths (B,)) as numpy arrays."""
        raise NotImplementedError

    def new_prev_buffer(self, src_tokens: np.ndarray, hypos: List[List[dict]]):
        raise NotImplementedError

    @torch.no_grad()
    def generate(self, models, sample, prefix_tokens=None, **kwargs) -> List[List[dict]]:
        """models: the context-aware model first (only it runs), in eval
        mode; sample: {"net_input": {"src_tokens", "src_lengths"}} as
        tensors or numpy arrays. Returns the hypotheses as
        ``SequenceGenerator.generate`` does and moves the buffer on."""
        model = models[0]
        if model.training:
            raise ValueError("ContextAwareSequenceGenerator needs the model in eval mode (call model.eval())")
        device = module_device(model)
        net_input = sample["net_input"]
        src_np = _numpy(net_input["src_tokens"])
        context, lengths = self.next_batch_context(src_np, self.buffer)
        if context.shape[0] != src_np.shape[0]:
            raise AssertionError(f"Batch size ({src_np.shape[0]}) is different from context batch size "
                                 f"({context.shape[0]})")
        ensemble = _ContextEnsemble(model, torch.as_tensor(context, device=device),
                                    torch.as_tensor(lengths, device=device))
        src_tokens = torch.as_tensor(net_input["src_tokens"], device=device)
        src_lengths = torch.as_tensor(net_input["src_lengths"], device=device)
        max_len = self.max_len(src_tokens, src_lengths, ensemble.max_decoder_positions())
        fin = self._generate_impl(ensemble, src_tokens, src_lengths, max_len, None)
        hypos = collect_hypotheses(fin, src_np.shape[0], self.beam_size)
        self.buffer = self.new_prev_buffer(src_np, hypos)
        return hypos


class TargetContextAwareSequenceGenerator(ContextAwareSequenceGenerator):
    """The previous generated target text is the next context (reference :104-121)."""

    @property
    def default_buffer(self):
        return np.array([[self.eos]], dtype=np.int64)

    def next_batch_context(self, src_tokens, buffer):
        bsz = src_tokens.shape[0]
        ctx = np.tile(buffer, (bsz, 1))
        return ctx, np.full((bsz,), ctx.shape[1], dtype=np.int64)

    def new_prev_buffer(self, src_tokens, hypos):
        return np.asarray(hypos[-1][0]["tokens"], dtype=np.int64).reshape(1, -1)


class AudioContextAwareSequenceGenerator(ContextAwareSequenceGenerator):
    """The previous utterance's audio is the next context (reference :124-157)."""

    @property
    def default_buffer(self) -> Optional[np.ndarray]:
        return None

    def next_batch_context(self, src_tokens, buffer):
        bsz, t, f = src_tokens.shape
        prev = buffer if buffer is not None else np.zeros((t, f), dtype=src_tokens.dtype)
        if bsz == 1:
            ctx = prev[None]
            return ctx, np.full((1,), ctx.shape[1], dtype=np.int64)
        # within the batch, row i's context is row i-1's audio
        context = src_tokens[:-1]
        if context.shape[1] > prev.shape[0]:
            prev = np.pad(prev, ((0, context.shape[1] - prev.shape[0]), (0, 0)))
        elif context.shape[1] < prev.shape[0]:
            context = np.pad(context, ((0, 0), (0, prev.shape[0] - context.shape[1]), (0, 0)))
        ctx = np.concatenate([prev[None], context], axis=0)
        return ctx, np.full((bsz,), ctx.shape[1], dtype=np.int64)

    def new_prev_buffer(self, src_tokens, hypos):
        return src_tokens[-1]


def _numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
