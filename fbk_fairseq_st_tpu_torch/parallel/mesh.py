"""The device mesh, the batch's row slice and the sharding rules.

Counterpart of ``fbk_fairseq_st_tpu/parallel/mesh.py``. JAX builds one
``jax.sharding.Mesh`` over every device and declares placements; its
compiler places the collectives. Here a rank is a process that drives one
GPU, and ``make_mesh`` lays the world's ranks out on JAX's dims, ``("data",
"model")``, or ``("dcn", "data", "model")`` with ``dcn > 1``, ``model``
fastest: rank = (dcn_i * data + data_i) * model + model_i, as JAX reshapes
its device list (so a tensor-parallel group is neighbouring GPUs). It makes
one process group for each line of the grid along each dim, and one for
``batch``, the joint (dcn, data) dims the batch is split over; these are the
groups ``init_device_mesh`` would make, made with ``new_group`` so that
every process makes them in one order.

The batch contract is JAX's (``local_row_range``, ``place_global_array``
:104-155): every rank runs the same epoch iterator and collates the same
global batch, and takes its own contiguous rows; the ranks of one model
group take the same rows. The shape buckets pad a batch's rows to 8 times a
power of two (``tasks/base.py``, ``pad_to_bsz``), so they split evenly over
a batch size that is a power of two up to 8; ``local_row_range`` raises
where they do not, as JAX's placement of an uneven batch does.

``TP_RULES`` (JAX :230-240) name the tensor-parallel leaves by the fork's
state-dict names, in torch's (out, in) layout: q/k/v and fc1 column-parallel
(their output dim), ``out_proj`` and fc2 row-parallel (their input dim), the
embeddings and the output projection over the vocabulary. A leaf whose
dim does not divide stays replicated. ``param_sharding`` adds FSDP's
``data`` dim to the leaves of at least ``fsdp_min_size`` elements
(``FSDP_MIN_SIZE``, JAX :256-316): the largest dim that is free and divides
(the first of equal ones, where JAX takes the last, so that a shard is a
contiguous block of torch's row-major storage).
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

import torch.distributed as dist

from .collectives import group_size, new_groups

AXES = ("dcn", "data", "model")


@dataclass
class Mesh:
    """This rank's place on the grid and its groups (None for a dim of 1)."""
    shape: Dict[str, int]
    coords: Dict[str, int]
    groups: Dict[str, object] = field(default_factory=dict)

    def size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def group(self, axis: str):
        return self.groups.get(axis)

    @property
    def batch_size(self) -> int:
        return math.prod(self.size(axis) for axis in batch_axes(self))

    @property
    def batch_rank(self) -> int:
        return self.coords.get("dcn", 0) * self.size("data") + self.coords.get("data", 0)

    @property
    def is_first(self) -> bool:
        return all(c == 0 for c in self.coords.values())


def make_mesh(data: Optional[int] = None, model: int = 1, dcn: int = 1,
              ranks: Optional[Iterable[int]] = None) -> Optional[Mesh]:
    """The mesh over ``ranks`` (default: the whole world) of the initialised
    default process group. Every process of the world calls it with the
    same arguments; those outside ``ranks`` get None."""
    world = list(range(dist.get_world_size())) if ranks is None else list(ranks)
    n, model, dcn = len(world), int(model or 1), int(dcn or 1)
    if n % (model * dcn):
        raise ValueError(f"{n} ranks do not divide by model={model} x dcn={dcn}")
    if data is None:
        data = n // (model * dcn)
    if dcn * data * model != n:
        raise ValueError(f"dcn*data*model = {dcn}*{data}*{model} must equal the {n} ranks")
    shape = {"dcn": dcn, "data": data, "model": model} if dcn > 1 else {"data": data, "model": model}

    def at(dc, da, mo):
        return world[(dc * data + da) * model + mo]

    lines = {
        "model": [[at(dc, da, mo) for mo in range(model)] for dc in range(dcn) for da in range(data)],
        "data": [[at(dc, da, mo) for da in range(data)] for dc in range(dcn) for mo in range(model)],
        "dcn": [[at(dc, da, mo) for dc in range(dcn)] for da in range(data) for mo in range(model)],
        "batch": [[at(dc, da, mo) for dc in range(dcn) for da in range(data)] for mo in range(model)],
    }
    groups = {axis: new_groups(rank_lists) for axis, rank_lists in lines.items()}
    me = dist.get_rank()
    if me not in world:
        return None
    i = world.index(me)
    coords = {"dcn": i // (data * model), "data": (i // model) % data, "model": i % model}
    if dcn == 1:
        del coords["dcn"]
    return Mesh(shape, coords, {a: g for a, g in groups.items() if group_size(g) > 1})


def batch_axes(mesh: Mesh) -> Tuple[str, ...]:
    """The dims the batch is split over (JAX :80)."""
    return ("dcn", "data") if "dcn" in mesh.shape else ("data",)


def local_row_range(mesh: Optional[Mesh], rows: int) -> Tuple[int, int]:
    """[lo, hi) rows of a global batch of ``rows`` that this rank takes."""
    if mesh is None or mesh.batch_size == 1:
        return 0, rows
    if rows % mesh.batch_size:
        raise ValueError(f"a batch of {rows} rows does not split over {mesh.batch_size} data-parallel ranks: "
                         "the shape buckets pad a batch to 8 times a power of two, so use a power of two up to 8, "
                         "or a --required-batch-size-multiple of the data-parallel size")
    per = rows // mesh.batch_size
    return mesh.batch_rank * per, (mesh.batch_rank + 1) * per


def seq_parallel_eligible(x, model_size: int) -> bool:
    """Whether sequence parallelism splits this (B, T, ...) activation over
    the model dim (JAX :201-227: not for a rank < 3 tensor, a decode step's
    T < 2 or a model dim of 1; here also not where T does not divide, which
    GSPMD pads and the port leaves whole: the result is the same)."""
    return model_size > 1 and x.dim() >= 3 and x.shape[1] >= 2 and x.shape[1] % model_size == 0


# (state-dict name pattern, the dim that goes to "model")
TP_RULES: Tuple[Tuple[str, int], ...] = (
    (r".*(self_attn|encoder_attn)\.(q|k|v)_proj\.weight$", 0),
    (r".*(self_attn|encoder_attn)\.(q|k|v)_proj\.bias$", 0),
    (r".*(self_attn|encoder_attn)\.out_proj\.weight$", 1),
    (r".*fc1\.weight$", 0),
    (r".*fc1\.bias$", 0),
    (r".*fc2\.weight$", 1),
    (r".*embed_tokens\.weight$", 0),
    (r".*output_projection\.weight$", 0),
)

# Below this many elements a parameter is cheaper to replicate than to
# gather at every step (biases, LayerNorm scales, BatchNorm's).
FSDP_MIN_SIZE = 4096


def tp_dim(name: str, shape, model_size: int) -> Optional[int]:
    """The dim a leaf splits over ``model`` by ``TP_RULES``, or None (no
    rule, or its dim does not divide)."""
    if model_size <= 1:
        return None
    for pattern, dim in TP_RULES:
        if re.match(pattern, name):
            return dim if shape[dim] % model_size == 0 else None
    return None


def _fsdp_spec(spec_dims: List[Optional[str]], shape, data_size: int) -> Optional[Tuple[Optional[str], ...]]:
    dims = list(spec_dims) + [None] * (len(shape) - len(spec_dims))
    free = [(shape[i], -i) for i, d in enumerate(dims) if d is None and shape[i] % data_size == 0]
    if not free:
        return None
    dims[-max(free)[1]] = "data"
    return tuple(dims)


def param_sharding(named_shapes: Dict[str, Tuple[int, ...]], mesh: Mesh, use_tp: bool = False,
                   use_fsdp: bool = False, fsdp_min_size: Optional[int] = None,
                   tp_names: Optional[Iterable[str]] = None) -> Dict[str, Tuple[Optional[str], ...]]:
    """{name: one mesh dim name or None per dim of the leaf's global shape}:
    replicated by default, ``TP_RULES`` on ``model`` with ``use_tp`` (only
    for ``tp_names``, the leaves the model's modules split, when given),
    and FSDP's ``data`` on what is left of the large leaves with
    ``use_fsdp`` (JAX ``param_sharding``)."""
    tp_names = None if tp_names is None else set(tp_names)
    data_size = mesh.size("data")
    min_size = FSDP_MIN_SIZE if fsdp_min_size is None else fsdp_min_size
    out = {}
    for name, shape in named_shapes.items():
        dims: List[Optional[str]] = [None] * len(shape)
        d = tp_dim(name, shape, mesh.size("model")) if use_tp else None
        if d is not None and (tp_names is None or name in tp_names):
            dims[d] = "model"
        numel = 1
        for s in shape:
            numel *= s
        if use_fsdp and data_size > 1 and numel >= min_size:
            fs = _fsdp_spec(dims, shape, data_size)
            if fs is not None:
                dims = list(fs)
        out[name] = tuple(dims)
    return out
