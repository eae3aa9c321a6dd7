"""repro_torch.core — Multi-Slice Clustering on torch tensors.

Counterpart of `repro.core` for the ported slice: types, statistics,
metrics, extraction, synthetic data (whole and chunked), the
matrix-free and explicit-gram eigensolvers, the sequential entry point,
the one-device flat schedule with its request-batched and
chunk-resumable forms (`parallel.MSCChunkPlan`, the continuous engine's
two programs), the DBSCAN multi-cluster extension and MSC over activation
and MoE routing tensors.
"""
from .types import MSCConfig, MSCResult, ModeResult, PlantedSpec, resolve_device
from .synthetic import (
    make_planted_tensor,
    make_planted_tensor_chunked,
    planted_factors,
    planted_masks,
)
from .msc import (
    cluster_mode_slices,
    marginal_sums,
    mode_slices,
    msc_sequential,
    msc_similarity_matrices,
    normalized_eigrows,
    similarity_matrix,
)
from .parallel import (
    MSCChunkPlan,
    build_msc_batched,
    build_msc_parallel,
    build_msc_parallel_flat,
    build_msc_parallel_grouped,
)
from repro_torch.launch.mesh import make_msc_mesh
from .schedule import ModeSchedule, epilogue_rowsum
from .extraction import extract_cluster, max_gap_init, trim_to_theorem
from .metrics import recovery_rate, similarity_index, similarity_index_mode
from .stats import (
    epsilon_ok,
    standardize_top_eig,
    theorem_threshold,
    tw_threshold,
    wishart_mu_sigma,
)
from .power_iter import (
    power_iteration_gram,
    power_iteration_matrix_free,
    power_iteration_on_gram,
    rayleigh_residual,
    top_eigenpairs,
)
from .integration import (
    cluster_activations,
    cluster_experts,
    collect_activation_tensor,
    routing_tensor,
)
from .dbscan import dbscan_from_similarity, msc_dbscan, msc_dbscan_mode

__all__ = [k for k in dir() if not k.startswith("_")]
