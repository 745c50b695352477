from .search import BeamSearch
from .sequence_generator import EnsembleModel, SequenceGenerator

__all__ = ["BeamSearch", "EnsembleModel", "SequenceGenerator"]
