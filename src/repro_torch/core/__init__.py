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

Every name of ``repro.core`` is here but the two JAX-named ones:
``expected_improvement_jax``'s counterpart is :func:`expected_improvement`
on a tensor on the card (the device EI), and ``aggregate_ranks_jax``'s is
:func:`aggregate_ranks`, whose ranks are kernel K2's on the card.
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
    get_space_backend,
    log_sampling,
    set_log_sampling,
    set_space_backend,
    space_backend,
)
from .surrogate import (
    ForestPlane,
    GaussianProcess,
    PackedForest,
    ProbabilisticRandomForest,
    forest_backend,
    get_forest_backend,
    make_forest,
    packed_descend,
    set_forest_backend,
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
    rank_aggregate,
    score_sources,
    set_acquisition_backend,
    set_acquisition_pool,
    set_plane_cache_size,
)
from .propose import ProposeEngine
from .gbm import GradientBoostedTrees
from .kde import WeightedKDE, alpha_mass_categories, alpha_mass_region, silverman_bandwidth
from .shapley import (
    draw_permutations,
    shapley_values,
    shapley_values_batch,
    shapley_values_exact,
)
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
    get_hyperband_backend,
    hb_schedule,
    hyperband_backend,
    set_hyperband_backend,
    sh_schedule,
)
from .mftune import MFTune, MFTuneOptions, TuningResult

__all__ = [
    "BoolKnob", "CatKnob", "ConfigSpace", "FloatKnob", "IntKnob", "Intervals",
    "ConfigBatch", "SpacePlane", "get_space_backend", "set_space_backend",
    "space_backend", "set_log_sampling", "log_sampling",
    "GaussianProcess", "ProbabilisticRandomForest", "PackedForest", "ForestPlane",
    "make_forest", "set_forest_backend", "get_forest_backend", "forest_backend",
    "packed_descend",
    "expected_improvement", "aggregate_ranks", "rank_aggregate", "normal_cdf", "score_sources",
    "EI_VAR_FLOOR", "set_plane_cache_size", "plane_cache_stats",
    "set_acquisition_backend", "get_acquisition_backend", "acquisition_backend",
    "set_acquisition_pool", "get_acquisition_pool", "acquisition_pool", "ProposeEngine",
    "GradientBoostedTrees",
    "WeightedKDE", "alpha_mass_categories", "alpha_mass_region", "silverman_bandwidth",
    "draw_permutations", "shapley_values", "shapley_values_batch", "shapley_values_exact",
    "KnowledgeBase", "Observation", "TaskRecord",
    "SimilarityEngine", "TaskWeights", "kendall_tau", "surrogate_for_task",
    "SpaceCompressor", "compress_space", "extract_promising_regions",
    "FidelityPartition", "collect_query_stats", "early_stop_subset",
    "greedy_query_subset", "partition_fidelities", "subset_correlation",
    "CandidateColumns", "CandidateGenerator", "SurrogateStore", "WarmStartQueue",
    "phase1_config",
    "Bracket", "HyperbandRunner", "Rung", "RungTable", "CostColumns",
    "hb_schedule", "sh_schedule",
    "get_hyperband_backend", "set_hyperband_backend", "hyperband_backend",
    "MFTune", "MFTuneOptions", "TuningResult",
]
