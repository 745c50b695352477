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
  * (V, D) tables (embeddings, output projections) are copied as they are.

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

The tree's leaves are numpy arrays (or anything ``np.asarray`` accepts).
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Tuple

import numpy as np
import torch

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
)


def fork_name(parts: List[str]) -> str:
    """JAX tree path components -> the fork's dotted parameter name."""
    out: List[str] = []
    for i, part in enumerate(parts):
        prev = parts[i - 1] if i > 0 else ""
        if part in _TRANSPARENT:
            continue
        if part in _COMPONENT_MAP:
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


def fork_layout(name: str, arr: np.ndarray) -> np.ndarray:
    """JAX array layout -> the fork's."""
    if arr.ndim == 2 and name.endswith("weight") and not name.endswith(_NO_TRANSPOSE_SUFFIX):
        return arr.T  # (in, out) -> nn.Linear (out, in)
    if arr.ndim == 4:
        return arr.transpose(3, 2, 0, 1)  # HWIO -> OIHW
    return arr


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
    return out
