from .search import BeamSearch
from .sequence_generator import EnsembleModel, SequenceGenerator
from .twophase_sequence_generator import TwoPhaseSequenceGenerator

__all__ = ["BeamSearch", "EnsembleModel", "SequenceGenerator", "TwoPhaseSequenceGenerator"]
