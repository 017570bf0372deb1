"""The paper's baseline tuners (§7.1) and space-compression variants
(§7.4.2, Fig. 6), ported: the names of ``repro.baselines``. Every tuner and
``DecreaseCompressor`` take ``device=None``, the CUDA card."""

from .common import BaselineTuner, RandomSearch, VanillaBO
from .locat import LOCAT
from .toptune import TopTune
from .tuneful import Tuneful
from .rover import Rover
from .loftune import LOFTune
from .sc_variants import BoxCompressor, DecreaseCompressor, ProjectCompressor, VoteCompressor

__all__ = [
    "BaselineTuner", "RandomSearch", "VanillaBO",
    "LOCAT", "TopTune", "Tuneful", "Rover", "LOFTune",
    "BoxCompressor", "DecreaseCompressor", "ProjectCompressor", "VoteCompressor",
]
