// Distance tile arithmetic shared by the lookup kernels (knn.cu) and the
// placement gain kernel (gains.cu).
//
// The l2 forms use the |q|^2 + |k|^2 - 2 q.k identity of the JAX
// reference's `_distance_block` (src/repro/kernels/knn/knn.py), clamped at
// 0 before the square root; l1 accumulates |q - k| over the feature axis.
// Every kernel accumulates the feature axis in ascending order, one pair
// per thread, so a pair's value never depends on how the tile was cut.
#pragma once

#include <cuda_runtime.h>

namespace simcache {

constexpr int kMetricL1 = 0;
constexpr int kMetricL2 = 1;
constexpr int kMetricL2Sq = 2;

// Running sum over the feature axis: |a - b| for l1, a * b (the dot
// product of the l2 identity) otherwise.
template <int METRIC>
__device__ __forceinline__ float accumulate(float acc, float a, float b) {
  if (METRIC == kMetricL1) return acc + fabsf(a - b);
  return fmaf(a, b, acc);
}

// Distance from the accumulated parts: acc itself for l1, else
// max(|q|^2 + |k|^2 - 2 q.k, 0), square-rooted for l2.
template <int METRIC>
__device__ __forceinline__ float finish_distance(float acc, float qn, float kn) {
  if (METRIC == kMetricL1) return acc;
  const float d2 = fmaxf(qn + kn - 2.0f * acc, 0.0f);
  return METRIC == kMetricL2 ? sqrtf(d2) : d2;
}

// The paper's power law C_a = d^gamma.
__device__ __forceinline__ float apply_gamma(float d, float gamma) {
  return gamma == 1.0f ? d : powf(fmaxf(d, 0.0f), gamma);
}

}  // namespace simcache
