"""In-training iterative product quantisation (``--quantization-config-path``).

Counterpart of ``fbk_fairseq_st_tpu/quantization/quantizer.py`` (reference
fairseq/quantization_utils.py:22-142): training runs in stages, one per
entry of the config's ``layers_to_quantize`` (a regex over layer names);
at each stage boundary the next group of layers is product-quantised: each
matching linear or embedding becomes a ``PQLinear`` / ``PQEmbedding``
(``quantization/pq.py``) whose centroids train under frozen codes, and the
trainer takes a fresh optimiser over the new parameters, its update count
and scheduler kept (``Trainer.reinitialize``; JAX ``trainer.reinitialize``
:256-280). Stages advance at epoch boundaries (``--max-epoch`` evenly
divided) or update boundaries (``--max-update``), exactly one of them.

The config schema is the reference YAML's
(tests/transformer_quantization_config.yaml): ``n_centroids`` and
``block_sizes`` by layer kind with (key, value-dict) selectors, and the
stages' regexes. A regex is matched against the port's (the fork's) layer
name and against JAX's (``q``, ``k``, ``v``, ``out`` for the attention
projections), so a config of either package selects the same layers; the
layer kind is the module's (an embedding blocks its dim, a linear its
in-features).
"""

from __future__ import annotations

import logging
import re
from typing import List, Optional

from torch import nn

from .pq import PQ, PQEmbedding, PQLinear, pq_module
from .weight_only import swap_module

logger = logging.getLogger(__name__)

_DEFAULT_CONFIG = {
    "n_centroids": {
        "Linear": ("in_features", {"*": 256}),
        "Embedding": ("embedding_dim", {"*": 256}),
    },
    "block_sizes": {
        "Linear": ("fuzzy_name", {"fc": 8, "attn": 4, "emb": 4}),
        "Embedding": ("fuzzy_name", {"emb": 8}),
    },
    "layers_to_quantize": [
        r"decoder\.layers\.\d+\.fc[12]",
        r"decoder\.embed_tokens",
        r"decoder\.layers\.\d+\.self_attn\.(k|v|q|out)",
    ],
}
N_ITER = 15


def parse_config_yaml(data: Optional[dict]) -> dict:
    """Reference quantization_options.parse_config_yaml: the defaults for a
    missing section; {key, value} dicts become (key, value)."""
    data = data or {}
    config = dict(_DEFAULT_CONFIG)
    for section in ("n_centroids", "block_sizes"):
        if section in data:
            config[section] = {kind: (spec["key"], spec["value"]) for kind, spec in data[section].items()}
    if "layers_to_quantize" in data:
        # the shipped configs escape dots as '\\.' (YAML plain scalars keep
        # backslashes): both that and '\.' work
        config["layers_to_quantize"] = [r.replace("\\\\", "\\") for r in data["layers_to_quantize"]]
    return config


def load_config(path: Optional[str]) -> dict:
    if not path:
        return parse_config_yaml({})
    import yaml

    with open(path) as f:
        return parse_config_yaml(yaml.safe_load(f))


# JAX's names of the fork's attention projections
_JAX_NAMES = {"q_proj": "q", "k_proj": "k", "v_proj": "v", "out_proj": "out"}


def jax_name(name: str) -> str:
    return ".".join(_JAX_NAMES.get(c, c) for c in name.split("."))


def matches(regex, name: str) -> bool:
    return bool(regex.search(jax_name(name)) or regex.search(name))


def _select(spec, path: str, size: int, what: str) -> int:
    """A (key, value-dict) selector: ``fuzzy_name`` matches a substring of
    the layer's name, a size key the layer's dim; ``*`` is the wildcard
    (reference pq/utils.py get_param)."""
    key, values = spec
    if key == "fuzzy_name":
        for name, v in values.items():
            if name != "*" and name in path:
                return int(v)
        if "*" in values:
            return int(values["*"])
        raise ValueError(f"no {what} rule matches layer '{path}' (rules: {list(values)})")
    for k, v in values.items():
        if k != "*" and int(k) == size:
            return int(v)
    return int(values.get("*", 256))


def quantize_layers(model: nn.Module, regex, block_sizes_config, n_centroids_config) -> List[str]:
    """Swap every linear and embedding of ``model`` whose name matches
    ``regex`` for its PQ module (JAX ``quantize_param_tree``); returns the
    names."""
    quantized = []
    for name, module in list(model.named_modules()):
        if not name or not isinstance(module, (nn.Linear, nn.Embedding)) or not matches(regex, name):
            continue
        swap_module(model, name, _quantize_layer(module, jax_name(name), block_sizes_config, n_centroids_config))
        quantized.append(name)
    return quantized


def _quantize_layer(module: nn.Module, path: str, block_sizes_config, n_centroids_config) -> nn.Module:
    kind = "Embedding" if isinstance(module, nn.Embedding) else "Linear"
    W2 = module.weight.detach()  # (out, in) / (num, dim): the blocks along dim 1
    size = W2.shape[1]
    block_size = _select(block_sizes_config[kind], path, size, "block size")
    n_centroids = _select(n_centroids_config[kind], path, size, "n_centroids")
    if size % block_size != 0:
        raise ValueError(f"layer '{path}': dim {size} not divisible by block size {block_size}")
    n_cols = W2.shape[0] * (size // block_size)
    if n_centroids > n_cols // 2:
        # a tiny layer cannot fill the codebook: shrink it (the reference
        # asserts inside EM instead)
        logger.info("layer '%s': shrinking n_centroids %d -> %d (only %d blocks)", path, n_centroids,
                    max(n_cols // 2, 1), n_cols)
        n_centroids = max(n_cols // 2, 1)
    pq = PQ(W2, block_size, n_centroids=n_centroids, n_iter=N_ITER)
    pq.encode()
    return pq_module(module, pq.centroids, pq.assignments)


def quantized_layers(model: nn.Module) -> List[str]:
    return [name for name, m in model.named_modules() if isinstance(m, (PQLinear, PQEmbedding))]


class Quantizer:
    """The stage schedule (reference quantization_utils.Quantizer)."""

    def __init__(self, config_path: Optional[str], max_epoch: int, max_update: int):
        config = load_config(config_path)
        self.n_centroids_config = config["n_centroids"]
        self.block_sizes_config = config["block_sizes"]
        self.layers_to_quantize: List[str] = config["layers_to_quantize"]
        num_iterations = len(self.layers_to_quantize)
        self.epoch_schedule = self.update_schedule = None
        if max_epoch > 0:
            if max_epoch % num_iterations:
                raise ValueError(f"for iterative PQ, --max-epoch (={max_epoch}) must be evenly divisible by "
                                 f"len(layers_to_quantize) (={num_iterations})")
            self.epoch_schedule = max_epoch // num_iterations
        if max_update > 0:
            if max_update % num_iterations:
                raise ValueError(f"for iterative PQ, --max-update (={max_update}) must be evenly divisible by "
                                 f"len(layers_to_quantize) (={num_iterations})")
            self.update_schedule = max_update // num_iterations
        if (self.epoch_schedule is not None) == (self.update_schedule is not None):
            raise ValueError("for iterative PQ, specify exactly one of --max-epoch/--max-update")
        self.quantization_step = 0
        self.trainer = None

    def set_trainer(self, trainer) -> None:
        """Attach; the stages whose layers the model already holds quantised
        (a resumed checkpoint) count as done."""
        self.trainer = trainer
        done = quantized_layers(trainer.model)
        while self.quantization_step < len(self.layers_to_quantize):
            regex = re.compile(self.layers_to_quantize[self.quantization_step])
            if not any(matches(regex, name) for name in done):
                break
            self.quantization_step += 1

    def begin_epoch(self, epoch: int) -> None:
        if (self.epoch_schedule is not None and epoch > 0 and (epoch - 1) % self.epoch_schedule == 0) \
                or self.quantization_step == 0:
            self.step()

    def step_update(self, num_updates: int) -> None:
        if self.update_schedule is not None and num_updates > 0 and num_updates % self.update_schedule == 0:
            self.step()

    def step(self) -> List[str]:
        if self.quantization_step >= len(self.layers_to_quantize):
            return []
        regex = re.compile(self.layers_to_quantize[self.quantization_step])
        logger.info("quantizing model (step=%d; layers_to_quantize[step]=%s)", self.quantization_step,
                    self.layers_to_quantize[self.quantization_step])
        quantized = quantize_layers(self.trainer.model, regex, self.block_sizes_config, self.n_centroids_config)
        logger.info("quantized layers: %s", quantized)
        self.quantization_step += 1
        if quantized:
            self.trainer.reinitialize()
        return quantized
