"""Model quantisation: scalar int8 emulation and ``--quant-noise-scalar``,
iterative product quantisation and ``--quantization-config-path``,
``--quant-noise-pq``, and weight-only int8 serving (``--quantize-weights
int8``). Counterpart of ``fbk_fairseq_st_tpu/quantization/`` (reference
fairseq/modules/quantization + modules/quant_noise.py)."""

from .pq import PQ, PQEmbedding, PQLinear  # noqa: F401
from .quant_noise import quant_noise_linear  # noqa: F401
from .scalar import emulate_int, fake_quantize, quantize  # noqa: F401
from .weight_only import (  # noqa: F401
    Int8Linear,
    maybe_quantize_ensemble,
    quantize_linear_weights,
    weight_of,
)
