"""The Megatron-style model-parallel arch names.

Counterpart of ``fbk_fairseq_st_tpu/models/model_parallel.py``: in JAX,
as in the port, tensor parallelism is the mesh's ``model`` dim
(``--model-parallel-size``; ``parallel/tensor_parallel.py`` splits any
model), so ``model_parallel_transformer`` is the text transformer and
``model_parallel_transformer_lm``, ``transformer_lm_megatron`` (8.3 B:
3072 wide, 72 layers, 32 heads, gelu) and ``transformer_lm_megatron_11b``
(its FFN 3072 x 6) are the language model under these presets. The
names join the two families' tables on import.
"""

from __future__ import annotations

from . import transformer, transformer_lm


def model_parallel_transformer_architecture(args):
    transformer.base_architecture(args)


def model_parallel_lm_architecture(args):
    transformer_lm.base_lm_architecture(args)


def _megatron(ffn_factor: int):
    def preset(args):
        """Reference model_parallel/models/transformer_lm.py:71-91."""
        args.decoder_embed_dim = getattr(args, "decoder_embed_dim", 3072)
        args.decoder_ffn_embed_dim = getattr(args, "decoder_ffn_embed_dim", 3072 * ffn_factor)
        args.decoder_layers = getattr(args, "decoder_layers", 72)
        args.decoder_attention_heads = getattr(args, "decoder_attention_heads", 32)
        args.dropout = getattr(args, "dropout", 0.1)
        args.attention_dropout = getattr(args, "attention_dropout", 0.1)
        args.activation_fn = getattr(args, "activation_fn", "gelu")
        transformer_lm.base_lm_architecture(args)
    return preset


TRANSFORMER_ARCHS = {"model_parallel_transformer": model_parallel_transformer_architecture}
LM_ARCHS = {
    "model_parallel_transformer_lm": model_parallel_lm_architecture,
    "transformer_lm_megatron": _megatron(4),
    "transformer_lm_megatron_11b": _megatron(6),
}
transformer.ARCHITECTURES.update(TRANSFORMER_ARCHS)
transformer_lm.ARCHITECTURES.update(LM_ARCHS)
