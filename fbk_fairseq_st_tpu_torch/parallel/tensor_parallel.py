"""Tensor and sequence parallelism: the model's modules split over the
``model`` dim of the mesh.

JAX declares ``TP_RULES`` (``parallel/mesh.py``) and its compiler places
the collectives; here ``apply_tensor_parallel`` replaces the modules the
rules name by Megatron's (Shoeybi et al. 2019) with explicit ones:

  * an attention module whose heads divide: q/k/v column-parallel (this
    rank's heads), ``out_proj`` row-parallel, the module's config set to
    its local heads; a module with a distance penalty (per-head
    parameters), or under ring attention, stays whole;
  * a module with ``fc1`` and ``fc2``: fc1 column-parallel, fc2
    row-parallel;
  * the transformer decoder's ``embed_tokens`` and ``output_projection``
    over the vocabulary: the embedding masks the ids outside its rows and
    all-reduces, the logits are this rank's columns, gathered for every
    criterion but ``vocab_parallel_cross_entropy``
    (``parallel/vocab_parallel.py``); the text transformer encoder's
    ``embed_tokens`` too (one table under ``--share-all-embeddings``,
    split once). An adaptive input or softmax and the character embedder
    stay whole (JAX's rules name ``embed_tokens/w`` and ``embed_out``
    only).

A column-parallel linear's input enters through ``copy_to`` (all-reduce in
the backward) and a row-parallel linear's output leaves through
``reduce_from`` (all-reduce in the forward), its bias added after.

Sequence parallelism (Korthikanti et al. 2022; JAX constrains the same
segments at ``ops/transformer_layer.py:139, :153, :372, :433, :469``)
splits a layer's LayerNorm, dropout and residual segments over time: the
layer takes its rank's time chunk on entry, the attention's query and
fc1's input are all-gathered over time (reduce-scattered in the backward)
in place of ``copy_to``, the row-parallel outputs are reduce-scattered over
time in place of the all-reduce, and the layer's output is gathered again.
The LayerNorms and the row-parallel biases, which then see one chunk, take
their parameters through ``copy_to``, so their gradients sum the chunks.
It applies to a layer all of whose attention and FFN are split, and to a
call whose input is eligible (``mesh.seq_parallel_eligible``); elsewhere
the layer runs whole, with the same result.
"""

from __future__ import annotations

from typing import Optional, Set

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import MultiheadAttention
from ..ops.core import LayerNorm, layer_norm
from ..ops.transformer_layer import TransformerDecoderLayer, TransformerEncoderLayer
from .collectives import (
    chunk_of,
    copy_to,
    gather_along,
    group_rank,
    group_size,
    reduce_from,
    reduce_scatter_along,
    scatter_along,
)
from .mesh import Mesh, seq_parallel_eligible, tp_dim


class LayerState:
    """Whether the layer's call in flight runs sequence-parallel."""

    def __init__(self, group):
        self.group = group
        self.active = False


def _sp_on(sp: Optional[LayerState]) -> bool:
    return sp is not None and sp.active


class ColumnParallelLinear(nn.Module):
    """This rank's rows of ``linear`` (its output features). ``source`` is
    "query" for an input that sequence parallelism has already gathered
    (the attention's query and self-attention keys and values), "ffn" for
    fc1's, which it gathers itself, or "memory" for cross-attention keys
    and values, which are whole on every rank."""

    def __init__(self, linear: nn.Linear, group, source: str, sp: Optional[LayerState] = None):
        super().__init__()
        self.group, self.source, self.sp = group, source, sp
        self.weight = nn.Parameter(chunk_of(linear.weight, 0, group), requires_grad=linear.weight.requires_grad)
        self.bias = None if linear.bias is None else nn.Parameter(
            chunk_of(linear.bias, 0, group), requires_grad=linear.bias.requires_grad)

    def forward(self, x):
        if self.source != "memory" and _sp_on(self.sp):
            if self.source == "ffn":
                x = gather_along(x, 1, self.group, backward="reduce_scatter")
        else:
            x = copy_to(x, self.group)
        return F.linear(x, self.weight.to(x.dtype), None if self.bias is None else self.bias.to(x.dtype))


class RowParallelLinear(nn.Module):
    """This rank's columns of ``linear`` (its input features); the partial
    products are summed over the group, then the bias is added."""

    def __init__(self, linear: nn.Linear, group, sp: Optional[LayerState] = None):
        super().__init__()
        self.group, self.sp = group, sp
        self.weight = nn.Parameter(chunk_of(linear.weight, 1, group), requires_grad=linear.weight.requires_grad)
        self.bias = linear.bias

    def forward(self, x):
        y = F.linear(x, self.weight.to(x.dtype))
        if _sp_on(self.sp):
            y = reduce_scatter_along(y, 1, self.group)
            bias = None if self.bias is None else copy_to(self.bias, self.group)
        else:
            y = reduce_from(y, self.group)
            bias = self.bias
        return y if bias is None else y + bias.to(y.dtype)


class SequenceParallelLayerNorm(LayerNorm):
    """A LayerNorm of a sequence-parallel layer: over one time chunk, its
    parameters enter through ``copy_to``."""

    def __init__(self, ln: LayerNorm, sp: LayerState):
        super().__init__(ln.weight.shape[0], ln.eps)
        self.weight, self.bias, self.sp = ln.weight, ln.bias, sp

    def forward(self, x):
        if self.sp.active:
            return layer_norm(x, copy_to(self.weight, self.sp.group), copy_to(self.bias, self.sp.group), self.eps)
        return layer_norm(x, self.weight, self.bias, self.eps)


class VocabParallel:
    """The transformer decoder's embedding and logits over this rank's
    rows of the vocabulary (``TransformerDecoder.vocab_parallel``)."""

    def __init__(self, group, keep_logits_sharded: bool = False):
        self.group = group
        self.keep_logits_sharded = keep_logits_sharded

    def offset(self, local_vocab: int) -> int:
        return group_rank(self.group) * local_vocab

    def embed(self, weight, ids, dtype=None):
        lo = self.offset(weight.shape[0])
        local = ids - lo
        outside = (local < 0) | (local >= weight.shape[0])
        w = weight if dtype is None else weight.to(dtype)
        x = F.embedding(torch.where(outside, 0, local), w)
        x = x.masked_fill(outside[..., None], 0.0)
        return reduce_from(x, self.group)

    def logits(self, x, weight):
        logits = torch.matmul(copy_to(x, self.group), weight.t().to(x.dtype))
        if self.keep_logits_sharded:
            return logits
        return gather_along(logits, -1, self.group)


def _split_attention(attn: MultiheadAttention, group, sp: Optional[LayerState], cross: bool) -> None:
    n = group_size(group)
    attn.q_proj = ColumnParallelLinear(attn.q_proj, group, "query", sp)
    attn.k_proj = ColumnParallelLinear(attn.k_proj, group, "memory" if cross else "query", sp)
    attn.v_proj = ColumnParallelLinear(attn.v_proj, group, "memory" if cross else "query", sp)
    attn.out_proj = RowParallelLinear(attn.out_proj, group, sp)
    attn.cfg = attn.cfg._replace(embed_dim=attn.cfg.embed_dim // n, num_heads=attn.cfg.num_heads // n)
    if sp is not None:
        def gather_query(module, args, kwargs):
            if not sp.active:
                return None
            return (gather_along(args[0], 1, group, backward="reduce_scatter"),) + tuple(args[1:]), kwargs

        attn.register_forward_pre_hook(gather_query, with_kwargs=True)


def _attention_splits(attn: MultiheadAttention, name: str, n: int, ring: bool) -> bool:
    shapes = {p: getattr(attn, p).weight.shape for p in ("q_proj", "k_proj", "v_proj", "out_proj")}
    return (not ring and attn.cfg.penalty is None and attn.cfg.num_heads % n == 0
            and all(tp_dim(f"{name}.{p}.weight", s, n) is not None for p, s in shapes.items()))


def _ffn_splits(module: nn.Module, name: str, n: int) -> bool:
    return (isinstance(getattr(module, "fc1", None), nn.Linear) and isinstance(getattr(module, "fc2", None), nn.Linear)
            and tp_dim(f"{name}.fc1.weight", module.fc1.weight.shape, n) is not None
            and tp_dim(f"{name}.fc2.weight", module.fc2.weight.shape, n) is not None)


def _prefix(name: str) -> str:
    return name + "." if name else ""


def apply_tensor_parallel(model: nn.Module, mesh: Mesh, sequence_parallel: bool = False,
                          ring_attention: bool = False, keep_logits_sharded: bool = False) -> Set[str]:
    """Split ``model``'s modules over ``mesh``'s model dim in place (its
    weights must already be the same on every rank of the group); returns
    the names of the parameters that now hold a chunk."""
    group = mesh.group("model")
    n = group_size(group)
    split: Set[str] = set()
    if n == 1:
        return split
    from ..models.transformer import TransformerEncoder
    from ..models.transformer_decoder import TransformerDecoder

    chunks = {}  # a table's id -> its chunk, so a shared table stays one Parameter

    def chunk_table(w):
        if id(w) not in chunks:
            chunks[id(w)] = nn.Parameter(chunk_of(w, 0, group), requires_grad=w.requires_grad)
        return chunks[id(w)]

    modules = list(model.named_modules())
    for name, module in modules:
        if isinstance(module, TransformerEncoder):
            w = module.embed_tokens.weight
            if tp_dim(f"{_prefix(name)}embed_tokens.weight", w.shape, n) is not None:
                module.embed_tokens.weight = chunk_table(w)
                split.add(f"{_prefix(name)}embed_tokens.weight")
                module.vocab_parallel = VocabParallel(group, keep_logits_sharded)
        if isinstance(module, TransformerDecoder) and isinstance(module.embed_tokens, nn.Embedding) \
                and module.adaptive_softmax is None:
            w = module.embed_tokens.weight
            out = module.output_projection
            if (tp_dim(f"{_prefix(name)}embed_tokens.weight", w.shape, n) is not None
                    and (out is None or tp_dim(f"{_prefix(name)}output_projection.weight", out.weight.shape, n)
                         is not None)):
                module.embed_tokens.weight = chunk_table(w)
                split.add(f"{_prefix(name)}embed_tokens.weight")
                if out is not None:
                    out.weight = nn.Parameter(chunk_of(out.weight, 0, group), requires_grad=out.weight.requires_grad)
                    split.add(f"{_prefix(name)}output_projection.weight")
                module.vocab_parallel = VocabParallel(group, keep_logits_sharded)

    for name, module in modules:
        attns = {a: getattr(module, a) for a in ("self_attn", "encoder_attn")
                 if isinstance(getattr(module, a, None), MultiheadAttention)}
        ok = {a: _attention_splits(m, f"{_prefix(name)}{a}", n, ring_attention) for a, m in attns.items()}
        ffn = _ffn_splits(module, name, n)
        sp = None
        if (sequence_parallel and type(module) in (TransformerEncoderLayer, TransformerDecoderLayer)
                and ffn and attns and all(ok.values())):
            sp = LayerState(group)
            _make_sequence_parallel(module, sp, mesh.size("model"))
        for a, m in attns.items():
            if ok[a]:
                _split_attention(m, group, sp, cross=a == "encoder_attn")
                split.update(f"{_prefix(name)}{a}.{p}" for p in ("q_proj.weight", "q_proj.bias", "k_proj.weight",
                                                                  "k_proj.bias", "v_proj.weight", "v_proj.bias",
                                                                  "out_proj.weight"))
        if ffn:
            module.fc1 = ColumnParallelLinear(module.fc1, group, "ffn", sp)
            module.fc2 = RowParallelLinear(module.fc2, group, sp)
            split.update(f"{_prefix(name)}{p}" for p in ("fc1.weight", "fc1.bias", "fc2.weight"))
    if ring_attention:
        from ..ops.ring_attention import RingGroup

        ring = RingGroup(group)
        for module in model.modules():
            if isinstance(module, MultiheadAttention):
                module.ring = ring
    return {s for s in split if s in dict(model.named_parameters())}


def _make_sequence_parallel(layer: nn.Module, sp: LayerState, model_size: int) -> None:
    for attr in ("self_attn_layer_norm", "encoder_attn_layer_norm", "final_layer_norm"):
        ln = getattr(layer, attr, None)
        if isinstance(ln, LayerNorm):
            setattr(layer, attr, SequenceParallelLayerNorm(ln, sp))

    def enter(module, args, kwargs):
        x = args[0]
        sp.active = seq_parallel_eligible(x, model_size)
        if not sp.active:
            return None
        return (scatter_along(x, 1, sp.group),) + tuple(args[1:]), kwargs

    def leave(module, args, kwargs, out):
        if not sp.active:
            return None
        sp.active = False
        if isinstance(out, tuple):
            return (gather_along(out[0], 1, sp.group),) + tuple(out[1:])
        return gather_along(out, 1, sp.group)

    layer.register_forward_pre_hook(enter, with_kwargs=True)
    layer.register_forward_hook(leave, with_kwargs=True)
