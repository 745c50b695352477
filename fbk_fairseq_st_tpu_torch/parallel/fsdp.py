"""FSDP (ZeRO-3): parameters held in chunks over the ``data`` dim.

Counterpart of JAX's ``--fsdp`` (``train/trainer.py:109-143``,
``parallel/mesh.py:256-316``), where the leaves of at least
``FSDP_MIN_SIZE`` elements are sharded over ``data`` and the compiler
all-gathers them at use and reduce-scatters their gradients. Here each such
leaf (``mesh.param_sharding``'s ``data`` dim) becomes a parametrization:
the module keeps this rank's chunk as its parameter (the optimiser, and so
its state, hold the chunk alone), and every read of the module's attribute
all-gathers the chunks, whose backward reduce-scatters the gradient, so the
chunk's gradient is the sum over the data ranks. Under ``--dcn-data-parallel``
the chunks stay inside a slice (the ``data`` dim), replicated over ``dcn``,
as in JAX (``parallel/mesh.py:35-45``).

The state dict of a parametrized module names the chunk
``<module>.parametrizations.<name>.original``; ``canonical_name`` gives the
fork's name back, which checkpoints use.
"""

from __future__ import annotations

import re

from torch import nn
from torch.nn.utils import parametrize

from .collectives import chunk_of, gather_along
from .mesh import Mesh

_PARAMETRIZED = re.compile(r"\.parametrizations\.(\w+)\.original$")


def canonical_name(name: str) -> str:
    return _PARAMETRIZED.sub(r".\1", name)


class _Gathered(nn.Module):
    """The whole leaf from this rank's chunk along ``dim``."""

    def __init__(self, dim: int, group):
        super().__init__()
        self.dim, self.group = dim, group

    def forward(self, chunk):
        return gather_along(chunk, self.dim, self.group, backward="reduce_scatter")

    def right_inverse(self, whole):
        return chunk_of(whole, self.dim, self.group)


def apply_fsdp(model: nn.Module, layout, mesh: Mesh) -> None:
    """Keep this rank's chunk of every leaf whose ``layout`` spec names
    ``data``."""
    group = mesh.group("data")
    for name, spec in layout.items():
        if "data" not in spec:
            continue
        owner, _, attr = name.rpartition(".")
        parametrize.register_parametrization(model.get_submodule(owner), attr, _Gathered(spec.index("data"), group),
                                             unsafe=True)
