from . import bleu

__all__ = ["bleu"]
