"""Weights from the JAX package's variable trees, under the fork's names.

The JAX models keep ``{"params": ..., "state": ...}`` trees of nested dicts
and lists; the port's modules use the fork's ``state_dict`` names. This is
the port's own version of the JAX package's ``translate_path`` /
``export_parameters`` (utils/fairseq_interop.py:136, :391): it walks the
tree, turns each leaf's path into the fork's dotted name and converts the
layout:

  * linear weights (in, out) -> (out, in);
  * conv kernels HWIO -> OIHW;
  * BatchNorm ``mean``/``var`` -> ``running_mean``/``running_var``;
  * ``embed_out`` -> ``output_projection.weight``;
  * (V, D) tables (embeddings, output projections) are copied as they are;
  * 3-D conv kernels (K, C_in, C_out), the VGG-Transformer decoder's and
    the w2l model's, are copied as they are: JAX's ``WIO`` layout is the
    fork's ``ConvTBC`` / ``LinearizedConvolution`` one, and
    ``export_parameters`` transposes only 2-D and 4-D leaves too; ASG's
    (V, V) ``asg_transitions`` (not a ``weight``) stays as it is.

Three kinds of 2-D ``weight`` leaf of the lightconv family are not linear
weights and are copied as they are too: a lightweight convolution's (H, K)
kernel (``...conv.weight``) and the (V, D) tables ``encoder_embed.weight``
and ``decoder_embed.weight``. ``export_parameters`` transposes all three (a
fault of the JAX package, ROADMAP Queue C); everywhere else the bridge and
the export agree name for name and value for value. A dynamic conv's
``conv.weight_linear`` is a linear and is transposed. The exceptions are
by name among 2-D leaves only: a 4-D leaf always takes the conv layout.

The triangle layer's second cross-attention and its LayerNorm are named
as the fork names every attention block and its LayerNorm:
``aux_decoder_attn.{q,k,v,out}_proj`` and ``aux_decoder_attn_layer_norm``.
``export_parameters`` knows neither block and writes
``aux_decoder_attn.q.weight`` and ``aux_decoder_attn_ln.weight`` (ROADMAP
Queue C); the values agree. ``fc_concat`` is a linear and agrees.

The context-aware model's context block is named as the fork names it:
``context_attn.{q,k,v,out}_proj``, ``context_gating_wi``,
``context_gating_ws``, and its LayerNorm ``context_ln`` becomes
``context_layer_norm`` in an encoder layer and ``context_attn_layer_norm``
in a decoder layer; ``export_parameters`` writes ``context_ln.*`` for both,
and ``audio_encoder_state.*`` for the audio context encoder's BatchNorm
statistics, which the bridge puts in that encoder as its buffers
(``context_encoder.audio_encoder.bn.{i}.running_mean``; ROADMAP Queue C);
the values agree.

The text transformer family's embeddings and outputs take the fork's
module names (fairseq/modules/adaptive_input.py, adaptive_softmax.py,
character_token_embedder.py), where ``export_parameters`` flattens JAX's
tree by path (ROADMAP Queue C, JAX side; the fork's names were not
checked against a reference checkout):

  * ``shared_embed_tokens`` (``--share-all-embeddings``) is
    ``encoder.embed_tokens.weight`` and ``decoder.embed_tokens.weight``,
    one tensor;
  * ``adaptive_input.clusters.{i}.embed`` / ``.proj`` are
    ``embed_tokens.embeddings.{i}.0`` (a table, as it is) / ``.1``;
  * ``adaptive_softmax.tails.{i}.proj`` / ``.out`` are
    ``adaptive_softmax.tail.{i}.0`` / ``.2``; tied to the adaptive input,
    ``class_proj`` is ``head.class_proj``, ``projs.{i}`` is
    ``tail.{i}.0``, and the shared tables appear again as
    ``head.word_proj.weight`` (band 0), ``tail.{i}.2.weight`` (band i+1)
    and, with ``--tie-adaptive-proj``, ``tail.{i}.0.weight`` (band i+1's
    input projection);
  * ``char_embedder`` is ``embed_tokens`` (``char_embeddings.weight``, a
    table; ``symbol_embeddings``; ``convolutions.{i}``, whose (W, C_in,
    C_out) kernels become ``Conv1d``'s (C_out, C_in, W);
    ``highway.layers.{i}``; ``projection``).

The tree's leaves are numpy arrays (or anything ``np.asarray`` accepts).
"""

from __future__ import annotations

import re
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..optim.optimizers import factored_dims

_COMPONENT_MAP = {
    "convs": "convolutions",
    "bns": "bn",
    "self_attn_ln": "self_attn_layer_norm",
    "encoder_attn_ln": "encoder_attn_layer_norm",
    "aux_attn_ln": "aux_attn_layer_norm",
    "context_attn_ln": "context_attn_layer_norm",
    "aux_decoder_attn_ln": "aux_decoder_attn_layer_norm",
}
_TRANSPARENT = {"frontend"}
_ATTN_PROJ = {"q": "q_proj", "k": "k_proj", "v": "v_proj", "out": "out_proj"}
_ATTN_BLOCKS = {"self_attn", "encoder_attn", "aux_attn", "aux_decoder_attn", "context_attn", "attn"}
_LEAF_NAMES = {
    "w": "weight",
    "b": "bias",
    "scale": "weight",
    "mean": "running_mean",
    "var": "running_var",
    "in_proj_w": "in_proj_weight",
    "in_proj_b": "in_proj_bias",
    "out_proj_w": "out_proj.weight",
    "out_proj_b": "out_proj.bias",
    "embed_out": "output_projection.weight",
}
# 2-D weights that are no linear's: copied as they are
_NO_TRANSPOSE_SUFFIX = (
    "embed_tokens.weight",
    "embed_positions.weight",
    "output_projection.weight",
    # lightconv: (V, D) tables and the lightweight conv's (H, K) kernel
    "encoder_embed.weight",
    "decoder_embed.weight",
    ".conv.weight",
    "char_embeddings.weight",
)
_ADAPTIVE_TABLE = re.compile(r".*embed_tokens\.embeddings\.\d+\.0\.weight$")
# the text family's subtrees, renamed component by component
_TEXT_COMPONENTS = {"adaptive_input": "embed_tokens", "clusters": "embeddings", "char_embedder": "embed_tokens",
                    "tails": "tail", "projs": "tail", "class_proj": "head.class_proj", "highway": "highway.layers"}


def fork_name(parts: List[str]) -> str:
    """JAX tree path components -> the fork's dotted parameter name."""
    out: List[str] = []
    for i, part in enumerate(parts):
        prev = parts[i - 1] if i > 0 else ""
        if part in _TRANSPARENT:
            continue
        if i == 0 and part == "shared_embed_tokens":
            out.append("encoder.embed_tokens")
        elif part in _TEXT_COMPONENTS and ("adaptive_softmax" in parts or "adaptive_input" in parts
                                           or "char_embedder" in parts):
            out.append(_TEXT_COMPONENTS[part])
            if part == "projs":  # tail i's free projection: the tail's first module
                out.append(parts[i + 1])
                out.append("0")
        elif prev == "projs" and "adaptive_softmax" in parts:
            continue  # the index, written with "projs"
        elif part in ("embed", "proj", "out") and i >= 2 and parts[i - 2] in ("clusters", "tails"):
            out.append({"embed": "0", "proj": "1" if parts[i - 2] == "clusters" else "0", "out": "2"}[part])
        elif part == "char_embeddings" and i == len(parts) - 1:
            out.append("char_embeddings.weight")
        elif part == "context_ln":
            out.append("context_attn_layer_norm" if parts[0] == "decoder" else "context_layer_norm")
        elif part == "audio_encoder_state":  # the audio context encoder's BatchNorm statistics
            out.append("audio_encoder")
        elif part in _COMPONENT_MAP:
            out.append(_COMPONENT_MAP[part])
        elif part in _ATTN_PROJ and prev in _ATTN_BLOCKS:
            out.append(_ATTN_PROJ[part])
        elif part == "final_ln":
            # per-layer -> final_layer_norm; top of a stack -> layer_norm
            out.append("final_layer_norm" if prev.isdigit() else "layer_norm")
        elif i == len(parts) - 1:
            out.append(_LEAF_NAMES.get(part, part))
        else:
            out.append(part)
    return ".".join(out)


def fork_axes(name: str, ndim: int) -> Tuple[int, ...]:
    """The permutation ``fork_layout`` applies: axis i of the fork's array
    is axis ``fork_axes(name, ndim)[i]`` of the JAX array."""
    if (ndim == 2 and name.endswith("weight") and not name.endswith(_NO_TRANSPOSE_SUFFIX)
            and not _ADAPTIVE_TABLE.match(name)):
        return (1, 0)  # (in, out) -> nn.Linear (out, in)
    if ndim == 3 and "embed_tokens.convolutions." in name:
        return (2, 1, 0)  # the char embedder's (W, C_in, C_out) -> Conv1d (C_out, C_in, W)
    if ndim == 4:
        return (3, 2, 0, 1)  # HWIO -> OIHW
    return tuple(range(ndim))


def fork_layout(name: str, arr: np.ndarray) -> np.ndarray:
    """JAX array layout -> the fork's."""
    return arr.transpose(fork_axes(name, arr.ndim))


def _leaves(tree: Any, path: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    if isinstance(tree, dict):
        for key in tree:
            yield from _leaves(tree[key], path + (str(key),))
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            yield from _leaves(sub, path + (str(i),))
    elif tree is not None:
        yield path, tree


def state_dict_from_jax(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A JAX ``{"params", "state"}`` tree -> the port's state dict."""
    out: Dict[str, torch.Tensor] = {}
    for tree in (variables.get("params"), variables.get("state")):
        for path, leaf in _leaves(tree or {}):
            name = fork_name(list(path))
            arr = np.asarray(leaf)
            out[name] = torch.tensor(np.ascontiguousarray(fork_layout(name, arr)))
    if "shared_embed_tokens" in (variables.get("params") or {}):
        out["decoder.embed_tokens.weight"] = out["encoder.embed_tokens.weight"]
    return _with_tied_names(out)


def _with_tied_names(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The tables a tied adaptive softmax shares with the adaptive input
    under each of their fork names, as the fork's state dict lists a shared
    tensor under every module that holds it."""
    for name in [k for k in sd if k.endswith("adaptive_softmax.head.class_proj.weight")]:
        prefix = name[:-len("adaptive_softmax.head.class_proj.weight")]
        table = prefix + "embed_tokens.embeddings.{}.{}.weight"
        sd[prefix + "adaptive_softmax.head.word_proj.weight"] = sd[table.format(0, 0)]
        for i in range(sd[name].shape[0]):
            sd[f"{prefix}adaptive_softmax.tail.{i}.2.weight"] = sd[table.format(i + 1, 0)]
            proj = f"{prefix}adaptive_softmax.tail.{i}.0.weight"
            if proj not in sd:  # --tie-adaptive-proj
                sd[proj] = sd[table.format(i + 1, 1)]
    return sd


# optax's state classes and their fields, in the order they pickle: the
# checkpoint reader rebuilds them as stubs that keep only the values
_OPTAX_FIELDS = {
    "ScaleByAdamState": ("count", "mu", "nu"),
    "ScaleByAdaDeltaState": ("e_g", "e_x"),
    "ScaleByRssState": ("sum_of_squares",),
    "FactoredState": ("count", "v_row", "v_col", "v"),
    "TraceState": ("trace",),
}
# port optimiser -> {its state key: optax field}
_STATE_FIELDS = {
    "Adam": {"step": "count", "exp_avg": "mu", "exp_avg_sq": "nu"},
    "Lamb": {"step": "count", "exp_avg": "mu", "exp_avg_sq": "nu"},
    "Adamax": {"step": "count", "exp_avg": "mu", "exp_inf": "nu"},
    "Adadelta": {"square_avg": "e_g", "acc_delta": "e_x"},
    "Adagrad": {"sum": "sum_of_squares"},
    "Adafactor": {"step": "count", "v_row": "v_row", "v_col": "v_col", "v": "v", "momentum_buffer": "trace"},
    "SGD": {"momentum_buffer": "trace"},
}


def _state_fields(node: Any, out: Dict[str, Any]) -> Dict[str, Any]:
    """optax's field name -> value over a (chained) optimiser state: a
    NamedTuple of optax, or the reader's stub of one (its class name and
    the values it was built with); a tuple is a chain."""
    if hasattr(node, "_fields"):
        items = zip(node._fields, node)
    elif hasattr(node, "args") and type(node).__name__ in _OPTAX_FIELDS:
        items = zip(_OPTAX_FIELDS[type(node).__name__], node.args)
    elif isinstance(node, (tuple, list)):
        for sub in node:
            _state_fields(sub, out)
        return out
    else:
        return out  # EmptyState and the like: no per-parameter state
    for field, value in items:
        out.setdefault(field, value)
    return out


def _factored_stat(stat: np.ndarray, jax_removed: int, perm: Tuple[int, ...]) -> np.ndarray:
    """A statistic reduced over JAX axis ``jax_removed``, its remaining
    axes put in the fork's order."""
    jax_axes = [a for a in range(len(perm)) if a != jax_removed]
    port_axes = [q for q in range(len(perm)) if perm[q] != jax_removed]
    return stat.transpose([jax_axes.index(perm[q]) for q in port_axes])


def optimizer_state_from_jax(opt_state: Any, params_tree: Any, model: torch.nn.Module,
                             optimizer: torch.optim.Optimizer) -> Dict[str, Any]:
    """The JAX package's optax state -> ``optimizer.state_dict()`` of the
    port's optimiser over ``model``'s parameters, with the leaf names and
    layouts of ``state_dict_from_jax``: Adam's ``count`` / ``mu`` / ``nu``
    become ``step`` / ``exp_avg`` / ``exp_avg_sq``, and each other
    optimiser's fields its own (``_STATE_FIELDS``). ``params_tree`` is the
    JAX params tree, whose shapes decide Adafactor's factored axes: a
    factored statistic is reduced over the same logical axis on both sides,
    so ``v_row`` and ``v_col`` trade places where a transpose makes the
    other axis the larger one (a square weight). A state the optimiser does
    not hold (the coupled decay's ``EmptyState``) is skipped; Adadelta,
    which counts no steps in optax, restarts torch's ``step`` at 0."""
    kind = type(optimizer).__name__
    if kind not in _STATE_FIELDS:
        raise NotImplementedError(f"no optax state mapping for {kind}")
    fields = _state_fields(opt_state, {})
    wanted = {key: field for key, field in _STATE_FIELDS[kind].items() if field in fields}
    jax_shapes = {fork_name(list(path)): np.shape(leaf) for path, leaf in _leaves(params_tree)}
    index = {id(p): i for i, p in enumerate(p for g in optimizer.param_groups for p in g["params"])}
    names = {name: p for name, p in model.named_parameters() if id(p) in index}
    per_field = {field: dict((fork_name(list(path)), np.asarray(leaf)) for path, leaf in _leaves(fields[field]))
                 for field in wanted.values() if field != "count"}
    count = np.asarray(fields["count"]) if "count" in fields else np.zeros(())
    state: Dict[int, Dict[str, torch.Tensor]] = {}
    for name, param in names.items():
        if name not in jax_shapes:
            raise KeyError(f"{name}: no such leaf in the JAX params tree")
        perm = fork_axes(name, len(jax_shapes[name]))
        entry: Dict[str, torch.Tensor] = {}
        factored = _factored_axes(kind, jax_shapes[name])
        for key, field in wanted.items():
            if field == "count":
                dtype = torch.int32 if kind == "Adafactor" else torch.float32
                entry[key] = torch.tensor(count, dtype=dtype)
                continue
            arr = per_field[field].get(name)
            if arr is None:
                continue
            if field in ("v_row", "v_col"):
                if factored is None:
                    continue
                entry[key] = torch.tensor(np.ascontiguousarray(
                    _factored_port_stat(key, per_field, name, jax_shapes[name], factored, perm)))
            elif field == "v" and factored is not None:
                continue
            else:
                entry[key] = torch.tensor(np.ascontiguousarray(arr.transpose(perm)))
        if kind == "Adadelta":
            entry["step"] = torch.tensor(0.0)
        state[index[id(param)]] = entry
    groups = optimizer.state_dict()["param_groups"]
    return {"state": state, "param_groups": groups}


def _factored_axes(kind: str, shape) -> Optional[Tuple[int, int]]:
    return factored_dims(tuple(shape)) if kind == "Adafactor" else None


def _factored_port_stat(key, per_field, name, jax_shape, jax_dims, perm) -> np.ndarray:
    """The port's ``v_row`` (mean over its largest axis) or ``v_col`` (over
    its second largest) from JAX's pair, by the logical axis each reduces."""
    jd1, jd0 = jax_dims
    pd1, pd0 = factored_dims(tuple(jax_shape[a] for a in perm))
    logical = perm[pd0] if key == "v_row" else perm[pd1]
    if logical == jd0:
        return _factored_stat(per_field["v_row"][name], jd0, perm)
    if logical == jd1:
        return _factored_stat(per_field["v_col"][name], jd1, perm)
    raise ValueError(f"{name}: the factored axes of {jax_shape} differ between the layouts")
