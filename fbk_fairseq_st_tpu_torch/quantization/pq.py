"""Iterative product quantisation (iPQ), and the modules that hold it.

Counterpart of ``fbk_fairseq_st_tpu/quantization/pq.py`` (reference
fairseq/modules/quantization/pq/{em.py,pq.py}; "And the Bit Goes Down",
Stock et al. 2020): a weight's rows are cut into ``block_size`` subvectors
that k-means clusters into a codebook. As in JAX the centroids are drawn
with ``np.random.RandomState(seed)``, the distances are ``c^2 - 2 c w +
w^2`` in fp32 (on the weight's device), the assignment is the first
minimum, an empty cluster takes a split of the most populated one on the
host (em.py:94-127), and the M-step is the exact per-cluster mean.

``PQLinear`` / ``PQEmbedding`` are the fork's modules for a quantised
layer: ``centroids`` (n_centroids, block_size), a Parameter, and
``assignments``, an int64 buffer of n_blocks x rows codes, block-major
(JAX's ``w_codes`` (n_blocks, out), flattened). The weight is rebuilt at
its use site (JAX ``ops/core.py::pq_reconstruct`` :76-88, ``weight_of``,
``embedding_table`` :151-166), so in training only the centroids move;
the codes are frozen.
"""

from __future__ import annotations

import logging
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

logger = logging.getLogger(__name__)


class EmptyClusterResolveError(Exception):
    pass


class PQ:
    """Quantise one (rows, columns) matrix, the columns cut into blocks: a
    linear's (out, in) weight, an embedding's (num, dim) table."""

    def __init__(self, W, block_size: int, n_centroids: int = 256, n_iter: int = 20, eps: float = 1e-6,
                 max_tentatives: int = 30, seed: int = 0):
        W = torch.as_tensor(W).detach().float()
        if W.dim() != 2:
            raise ValueError("reshape conv kernels to 2D before PQ")
        self.out_features, self.in_features = W.shape
        if self.in_features % block_size != 0:
            raise ValueError("in_features must be a multiple of block_size")
        self.block_size = block_size
        self.n_centroids = n_centroids
        self.n_iter = n_iter
        self.eps = eps
        self.max_tentatives = max_tentatives
        self.rng = np.random.RandomState(seed)
        # (block_size, n_blocks * out_features), reference pq.py:61-74
        self.W_r = W.reshape(self.out_features, -1, block_size).permute(2, 1, 0).reshape(block_size, -1).contiguous()
        self.centroids = None
        self.assignments = None
        self.objective = []

    def _distances(self):
        c, w = self.centroids, self.W_r
        return (c ** 2).sum(1)[:, None] - 2.0 * (c @ w) + (w ** 2).sum(0)[None, :]

    def _assign(self):
        self.assignments = torch.argmin(self._distances(), dim=0)

    def _counts(self) -> np.ndarray:
        return np.bincount(self.assignments.cpu().numpy(), minlength=self.n_centroids)

    def initialize_centroids(self):
        idx = self.rng.randint(0, self.W_r.shape[1], size=self.n_centroids)
        self.centroids = self.W_r[:, torch.as_tensor(idx, device=self.W_r.device)].t().contiguous()

    def _resolve_empty_clusters(self) -> int:
        counts = self._counts()
        empty = np.flatnonzero(counts == 0)
        n_empty = len(empty)
        tentatives = 0
        while len(empty) > 0:
            k = self.rng.choice(empty)
            m = int(np.argmax(counts))
            e = torch.from_numpy(self.rng.randn(self.block_size).astype(np.float32) * self.eps).to(self.W_r.device)
            self.centroids[k] = self.centroids[m] + e
            self.centroids[m] -= e
            self._assign()
            counts = self._counts()
            empty = np.flatnonzero(counts == 0)
            tentatives += 1
            if tentatives >= self.max_tentatives:
                logger.info("Could not resolve all empty clusters, %d remaining", len(empty))
                raise EmptyClusterResolveError
        return n_empty

    def step(self, i: int):
        self._assign()
        n_empty = self._resolve_empty_clusters()
        counts = torch.bincount(self.assignments, minlength=self.n_centroids).float()
        sums = torch.zeros((self.n_centroids, self.block_size), device=self.W_r.device)
        sums.index_add_(0, self.assignments, self.W_r.t())
        self.centroids = sums / torch.clamp(counts[:, None], min=1.0)
        obj = float(torch.linalg.vector_norm(self.centroids[self.assignments].t() - self.W_r))
        self.objective.append(obj)
        logger.info("Iteration: %d, objective: %.6f, resolved empty clusters: %d", i, obj, n_empty)

    def encode(self):
        self.initialize_centroids()
        for i in range(self.n_iter):
            try:
                self.step(i)
            except EmptyClusterResolveError:
                break

    def decode(self) -> torch.Tensor:
        """The reconstructed (rows, columns) matrix."""
        return reconstruct(self.centroids, self.assignments, self.out_features, self.in_features)


def reconstruct(centroids, assignments, rows: int, columns: int, dtype=None):
    """The (rows, columns) matrix of a codebook and its block-major codes
    (JAX ``pq_reconstruct``: the centroids cast first, then gathered)."""
    c = centroids if dtype is None else centroids.to(dtype)
    block = c.shape[1]
    return c[assignments].reshape(-1, rows, block).permute(1, 0, 2).reshape(rows, columns)


class PQLinear(nn.Module):
    """A product-quantised linear: ``centroids`` train, ``assignments`` are
    frozen; the (out, in) weight is rebuilt in the compute type at each use."""

    def __init__(self, centroids: torch.Tensor, assignments: torch.Tensor, out_features: int, in_features: int,
                 bias=None):
        super().__init__()
        self.out_features, self.in_features = out_features, in_features
        self.centroids = nn.Parameter(centroids)
        self.register_buffer("assignments", assignments)
        self.bias = bias

    def weight_as(self, dtype: torch.dtype) -> torch.Tensor:
        return reconstruct(self.centroids, self.assignments, self.out_features, self.in_features, dtype)

    @property
    def weight(self) -> torch.Tensor:
        return self.weight_as(self.centroids.dtype)

    def forward(self, x):
        return F.linear(x, self.weight_as(x.dtype), None if self.bias is None else self.bias.to(x.dtype))

    def extra_repr(self) -> str:
        return (f"in_features={self.in_features}, out_features={self.out_features}, "
                f"n_centroids={self.centroids.shape[0]}, block_size={self.centroids.shape[1]}")


class PQEmbedding(nn.Module):
    """A product-quantised embedding table (num_embeddings, embedding_dim),
    its blocks over the embedding dim (reference qemb.py)."""

    def __init__(self, centroids: torch.Tensor, assignments: torch.Tensor, num_embeddings: int, embedding_dim: int,
                 padding_idx=None):
        super().__init__()
        self.num_embeddings, self.embedding_dim, self.padding_idx = num_embeddings, embedding_dim, padding_idx
        self.centroids = nn.Parameter(centroids)
        self.register_buffer("assignments", assignments)

    def weight_as(self, dtype: torch.dtype) -> torch.Tensor:
        return reconstruct(self.centroids, self.assignments, self.num_embeddings, self.embedding_dim, dtype)

    @property
    def weight(self) -> torch.Tensor:
        return self.weight_as(self.centroids.dtype)

    def forward(self, ids):
        return F.embedding(ids, self.weight)

    def extra_repr(self) -> str:
        return (f"{self.num_embeddings}, {self.embedding_dim}, n_centroids={self.centroids.shape[0]}, "
                f"block_size={self.centroids.shape[1]}")


def pq_module(module: nn.Module, centroids: torch.Tensor, assignments: torch.Tensor) -> nn.Module:
    """The PQ counterpart of a linear or an embedding, holding the codebook."""
    centroids, assignments = centroids.float().contiguous(), assignments.to(torch.int64)
    if isinstance(module, nn.Embedding):
        return PQEmbedding(centroids, assignments, module.num_embeddings, module.embedding_dim, module.padding_idx)
    return PQLinear(centroids, assignments, module.out_features, module.in_features, module.bias)


def adopt_pq_layout(model: nn.Module, state: Dict[str, torch.Tensor]) -> bool:
    """Swap in a PQ module for each linear or embedding of ``model`` that a
    state dict holds product-quantised (``<name>.centroids`` and
    ``.assignments``), so that the state loads strictly; True when any was
    swapped."""
    from .weight_only import swap_module

    swapped = False
    for key, centroids in state.items():
        if not key.endswith(".centroids"):
            continue
        name = key[:-len(".centroids")]
        try:
            module = model.get_submodule(name)
        except AttributeError:
            continue
        if isinstance(module, (nn.Linear, nn.Embedding)):
            device = module.weight.device
            swap_module(model, name, pq_module(module, torch.zeros(centroids.shape, device=device),
                                               torch.zeros(state[name + ".assignments"].numel(), device=device)))
            swapped = True
    return swapped
