from repro_torch.kernels.knn.gains import (gains_cuda, placement_gains,
                                           placement_gains_matrix)
from repro_torch.kernels.knn.knn import fused_lookup_cuda, knn_cuda
from repro_torch.kernels.knn.ops import (fused_lookup, nearest_approximizer,
                                         pad_for_knn)
from repro_torch.kernels.knn.ref import (fused_lookup_ref, knn_ref,
                                         placement_gains_ref)

__all__ = ["nearest_approximizer", "pad_for_knn", "knn_ref", "fused_lookup",
           "fused_lookup_ref", "placement_gains", "placement_gains_matrix",
           "placement_gains_ref", "fused_lookup_cuda", "knn_cuda",
           "gains_cuda"]
