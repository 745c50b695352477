from .base import EncoderOut, reorder_encoder_out
from .conv_transformer import ARCHITECTURES, ConvolutionalTransformerModel, build_model

__all__ = [
    "ARCHITECTURES",
    "ConvolutionalTransformerModel",
    "EncoderOut",
    "build_model",
    "reorder_encoder_out",
]
