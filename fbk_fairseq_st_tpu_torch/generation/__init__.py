from .search import (BeamSearch, DiverseBeamSearch, DiverseSiblingsSearch, LengthConstrainedBeamSearch,
                     Sampling)
from .sequence_generator import EnsembleModel, SequenceGenerator
from .sequence_scorer import SequenceScorer
from .sequence_generator_with_context import (AudioContextAwareSequenceGenerator, ContextAwareSequenceGenerator,
                                              TargetContextAwareSequenceGenerator)
from .twophase_sequence_generator import TwoPhaseSequenceGenerator

__all__ = ["AudioContextAwareSequenceGenerator", "BeamSearch", "ContextAwareSequenceGenerator", "DiverseBeamSearch",
           "DiverseSiblingsSearch", "EnsembleModel", "LengthConstrainedBeamSearch", "Sampling", "SequenceGenerator",
           "SequenceScorer", "TargetContextAwareSequenceGenerator", "TwoPhaseSequenceGenerator"]
