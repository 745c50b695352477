from .dictionary import Dictionary
from .language_pair_dataset import LanguagePairDataset, collate_tokens

__all__ = ["Dictionary", "LanguagePairDataset", "collate_tokens"]
