from .search import (BeamSearch, DiverseBeamSearch, DiverseSiblingsSearch, LengthConstrainedBeamSearch,
                     Sampling)
from .sequence_generator import EnsembleModel, SequenceGenerator
from .twophase_sequence_generator import TwoPhaseSequenceGenerator

__all__ = ["BeamSearch", "DiverseBeamSearch", "DiverseSiblingsSearch", "EnsembleModel", "LengthConstrainedBeamSearch",
           "Sampling", "SequenceGenerator", "TwoPhaseSequenceGenerator"]
