from repro_torch.kernels.knn.gains import (gains_cuda, placement_gains,
                                           placement_gains_matrix,
                                           sharded_placement_gains)
from repro_torch.kernels.knn.knn import fused_lookup_cuda, knn_cuda
from repro_torch.kernels.knn.lsh import (CandidatePolicy, CandidateTables,
                                         KMeansPolicy, SimHashPolicy,
                                         default_policy, stack_shard_tables)
from repro_torch.kernels.knn.ops import (DEFAULT_TOP_T, fused_lookup,
                                         mesh_axes_size,
                                         nearest_approximizer, pad_for_knn,
                                         pruned_fused_lookup,
                                         quantized_fused_lookup, shard_meta,
                                         sharded_fused_lookup,
                                         sharded_pruned_fused_lookup,
                                         sharded_quantized_fused_lookup)
from repro_torch.kernels.knn.ref import (fused_lookup_ref, knn_ref,
                                         pad_to_shards, placement_gains_ref,
                                         pruned_fused_lookup_ref,
                                         quantized_fused_lookup_ref,
                                         reduce_shard_minima,
                                         sharded_fused_lookup_ref,
                                         sharded_pruned_fused_lookup_ref,
                                         sharded_quantized_fused_lookup_ref)

__all__ = ["nearest_approximizer", "pad_for_knn", "knn_ref", "fused_lookup",
           "fused_lookup_ref", "placement_gains", "placement_gains_matrix",
           "placement_gains_ref", "fused_lookup_cuda", "knn_cuda",
           "gains_cuda", "CandidatePolicy", "CandidateTables",
           "SimHashPolicy", "KMeansPolicy", "default_policy",
           "stack_shard_tables", "DEFAULT_TOP_T", "quantized_fused_lookup",
           "pruned_fused_lookup", "quantized_fused_lookup_ref",
           "pruned_fused_lookup_ref", "mesh_axes_size", "pad_to_shards",
           "reduce_shard_minima", "shard_meta", "sharded_fused_lookup",
           "sharded_quantized_fused_lookup", "sharded_pruned_fused_lookup",
           "sharded_placement_gains", "sharded_fused_lookup_ref",
           "sharded_pruned_fused_lookup_ref",
           "sharded_quantized_fused_lookup_ref"]
