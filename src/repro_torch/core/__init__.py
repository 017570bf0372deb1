"""MFTune core, ported: the paper's contribution as a composable library.

Public API (names as in ``repro.core``):
  ConfigSpace & knobs       — search-space definition with range unions
  ProbabilisticRandomForest — BO surrogate (paper §3.3), device inference
  GaussianProcess           — the Tuneful baseline's GP, host numpy
  SimilarityEngine          — §4.2 transfer weights + transition mechanism
  SpaceCompressor           — §5 SHAP+KDE density-based compression
  greedy_query_subset       — §6.1 Alg. 2 fidelity partitioning
  CandidateGenerator        — §6.2 combined-rank BO + two-phase warm start
  ProposeEngine             — the fused propose step (one CUDA graph a pool bucket)
  HyperbandRunner           — §3.4 HB/SHA scheduling with median early stop
  MFTune                    — §4.1/§6.3 end-to-end controller
"""

from .space import (
    BoolKnob,
    CatKnob,
    ConfigBatch,
    ConfigSpace,
    FloatKnob,
    IntKnob,
    Intervals,
    SpacePlane,
)
from .surrogate import (
    ForestPlane,
    GaussianProcess,
    PackedForest,
    ProbabilisticRandomForest,
    make_forest,
)
from .acquisition import (
    EI_VAR_FLOOR,
    acquisition_backend,
    acquisition_pool,
    aggregate_ranks,
    expected_improvement,
    get_acquisition_backend,
    get_acquisition_pool,
    normal_cdf,
    plane_cache_stats,
    score_sources,
    set_acquisition_backend,
    set_acquisition_pool,
    set_plane_cache_size,
)
from .propose import ProposeEngine
from .gbm import GradientBoostedTrees
from .kde import WeightedKDE, alpha_mass_categories, alpha_mass_region, silverman_bandwidth
from .shapley import draw_permutations, shapley_values_batch
from .knowledge import KnowledgeBase, Observation, TaskRecord
from .similarity import SimilarityEngine, TaskWeights, kendall_tau, surrogate_for_task
from .compression import SpaceCompressor, compress_space, extract_promising_regions
from .fidelity import (
    FidelityPartition,
    collect_query_stats,
    early_stop_subset,
    greedy_query_subset,
    partition_fidelities,
    subset_correlation,
)
from .generator import (
    CandidateColumns,
    CandidateGenerator,
    SurrogateStore,
    WarmStartQueue,
    phase1_config,
)
from .hyperband import (
    Bracket,
    CostColumns,
    HyperbandRunner,
    Rung,
    RungTable,
    hb_schedule,
    sh_schedule,
)
from .mftune import MFTune, MFTuneOptions, TuningResult

__all__ = [
    "BoolKnob", "CatKnob", "ConfigSpace", "FloatKnob", "IntKnob", "Intervals",
    "ConfigBatch", "SpacePlane",
    "GaussianProcess", "ProbabilisticRandomForest", "PackedForest", "ForestPlane",
    "make_forest",
    "expected_improvement", "aggregate_ranks", "normal_cdf", "score_sources",
    "EI_VAR_FLOOR", "set_plane_cache_size", "plane_cache_stats",
    "set_acquisition_backend", "get_acquisition_backend", "acquisition_backend",
    "set_acquisition_pool", "get_acquisition_pool", "acquisition_pool", "ProposeEngine",
    "GradientBoostedTrees",
    "WeightedKDE", "alpha_mass_categories", "alpha_mass_region", "silverman_bandwidth",
    "draw_permutations", "shapley_values_batch",
    "KnowledgeBase", "Observation", "TaskRecord",
    "SimilarityEngine", "TaskWeights", "kendall_tau", "surrogate_for_task",
    "SpaceCompressor", "compress_space", "extract_promising_regions",
    "FidelityPartition", "collect_query_stats", "early_stop_subset",
    "greedy_query_subset", "partition_fidelities", "subset_correlation",
    "CandidateColumns", "CandidateGenerator", "SurrogateStore", "WarmStartQueue",
    "phase1_config",
    "Bracket", "HyperbandRunner", "Rung", "RungTable", "CostColumns",
    "hb_schedule", "sh_schedule",
    "MFTune", "MFTuneOptions", "TuningResult",
]
