// Nearest-approximizer lookups for Hopper (sm_90a): kernel A, the fused
// segmented 1-NN over every cache level, and kernel B, the plain blocked
// 1-NN.
//
// Replaces the Pallas TPU kernels `_fused_kernel` and `_knn_kernel` of
// src/repro/kernels/knn/knn.py. The TPU walked key tiles along a
// sequential minor grid axis and carried the running minimum in its output
// block; here the blocks run in parallel, so one block owns a tile of QT
// queries and walks *all* key tiles itself, in key order.
//
// What bounds it: the distance tile, 2*Q*K*D flops of fp32 work on the
// CUDA cores (bytes are Q*D + K*D floats, tiny next to that at K >= 448).
// Design: keys are staged through shared memory in (KT x DC) chunks with a
// padded row stride (conflict-free column reads); query chunks are read as
// float4 broadcasts, so one shared load feeds four fused multiply-adds.
// Each thread owns one key lane and QPT queries and keeps a running
// (cost, C_a, index) per query with a strict `<` over ascending key
// indices; the per-query lanes are then reduced lexicographically
// (cost, then index), so ties always break to the lowest concatenated
// index. `meta` is gathered once, at the winning index. No wgmma, TMA or
// tuning yet: fp32 on the CUDA cores, simple and right first.
#include <climits>
#include <cuda_runtime.h>

#include "distance.cuh"

namespace simcache {
namespace {

constexpr int kThreads = 256;
constexpr int kQT = 8;                    // queries per block
constexpr int kKT = 128;                  // keys per tile
constexpr int kDC = 32;                   // feature chunk staged at a time
constexpr int kQG = kThreads / kKT;       // query groups per block
constexpr int kQPT = kQT / kQG;           // queries per thread
constexpr float kInf = 3.0e38f;           // the reference's masked cost

template <int METRIC, bool FUSED>
__global__ void __launch_bounds__(kThreads)
nn_kernel(const float* __restrict__ q, const float* __restrict__ keys,
          const float* __restrict__ h_key, const int* __restrict__ meta,
          int Q, int K, int D, float gamma, float h_repo, int repo_level,
          int fold_repo, float* __restrict__ out_cost,
          float* __restrict__ out_ca, int* __restrict__ out_idx,
          int* __restrict__ out_slot, int* __restrict__ out_pay) {
  __shared__ __align__(16) float qs[kQT][kDC];
  __shared__ float ks[kKT][kDC + 1];
  __shared__ float qn_s[kQT];
  __shared__ float red_cost[kQT][kKT];
  __shared__ float red_ca[kQT][kKT];
  __shared__ int red_idx[kQT][kKT];

  const int tid = threadIdx.x;
  const int lane = tid % kKT;             // key lane within a tile
  const int grp = tid / kKT;              // this thread's query group
  const int q0 = blockIdx.x * kQT;

  float qn = 0.0f;                        // |q|^2, summed on the first tile
  float best_cost[kQPT], best_ca[kQPT];
  int best_idx[kQPT];
#pragma unroll
  for (int i = 0; i < kQPT; ++i) {
    best_cost[i] = kInf;
    best_ca[i] = 0.0f;
    best_idx[i] = -1;
  }

  for (int k0 = 0; k0 < K; k0 += kKT) {
    float acc[kQPT];
#pragma unroll
    for (int i = 0; i < kQPT; ++i) acc[i] = 0.0f;
    float kn = 0.0f;
    for (int d0 = 0; d0 < D; d0 += kDC) {
      __syncthreads();                    // previous chunk fully consumed
      for (int e = tid; e < kKT * kDC; e += kThreads) {
        const int r = e / kDC, c = e % kDC;
        const int kr = k0 + r, dc = d0 + c;
        ks[r][c] = (kr < K && dc < D) ? keys[(size_t)kr * D + dc] : 0.0f;
      }
      for (int e = tid; e < kQT * kDC; e += kThreads) {
        const int r = e / kDC, c = e % kDC;
        const int qr = q0 + r, dc = d0 + c;
        qs[r][c] = (qr < Q && dc < D) ? q[(size_t)qr * D + dc] : 0.0f;
      }
      __syncthreads();
      // zero-staged columns past D add exactly nothing to any sum
      const int dn = (min(kDC, D - d0) + 3) & ~3;
      for (int c = 0; c < dn; c += 4) {
        const float k0v = ks[lane][c], k1v = ks[lane][c + 1];
        const float k2v = ks[lane][c + 2], k3v = ks[lane][c + 3];
        if (METRIC != kMetricL1 && k0 == 0 && tid < kQT) {
          const float4 qv = *reinterpret_cast<const float4*>(&qs[tid][c]);
          qn = fmaf(qv.x, qv.x, qn);
          qn = fmaf(qv.y, qv.y, qn);
          qn = fmaf(qv.z, qv.z, qn);
          qn = fmaf(qv.w, qv.w, qn);
        }
        if (METRIC != kMetricL1) {
          kn = fmaf(k0v, k0v, kn);
          kn = fmaf(k1v, k1v, kn);
          kn = fmaf(k2v, k2v, kn);
          kn = fmaf(k3v, k3v, kn);
        }
#pragma unroll
        for (int i = 0; i < kQPT; ++i) {
          const float4 qv =
              *reinterpret_cast<const float4*>(&qs[grp + kQG * i][c]);
          float a = acc[i];
          a = accumulate<METRIC>(a, qv.x, k0v);
          a = accumulate<METRIC>(a, qv.y, k1v);
          a = accumulate<METRIC>(a, qv.z, k2v);
          a = accumulate<METRIC>(a, qv.w, k3v);
          acc[i] = a;
        }
      }
    }
    if (k0 == 0) {                        // publish |q|^2 once
      if (tid < kQT) qn_s[tid] = qn;
      __syncthreads();
    }
    const int kidx = k0 + lane;
    if (kidx < K) {
      // invalid (sentinel / padding) keys are masked before any compare:
      // their distance may be huge or NaN
      const bool valid = FUSED ? meta[3 * (size_t)K + kidx] > 0 : true;
      const float h = FUSED ? h_key[kidx] : 0.0f;
      if (valid) {
#pragma unroll
        for (int i = 0; i < kQPT; ++i) {
          const float ca = apply_gamma(
              finish_distance<METRIC>(acc[i], qn_s[grp + kQG * i], kn),
              gamma);
          const float cost = FUSED ? ca + h : ca;
          if (cost < best_cost[i]) {       // strict: lowest index wins ties
            best_cost[i] = cost;
            best_ca[i] = ca;
            best_idx[i] = kidx;
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kQPT; ++i) {
    red_cost[grp + kQG * i][lane] = best_cost[i];
    red_ca[grp + kQG * i][lane] = best_ca[i];
    red_idx[grp + kQG * i][lane] = best_idx[i];
  }
  __syncthreads();
  if (tid >= kQT) return;
  const int qi = q0 + tid;
  if (qi >= Q) return;
  float bc = kInf, bca = 0.0f;
  int bi = INT_MAX;
  for (int l = 0; l < kKT; ++l) {          // lexicographic (cost, index)
    const int ix = red_idx[tid][l];
    const float c = red_cost[tid][l];
    if (ix >= 0 && (c < bc || (c == bc && ix < bi))) {
      bc = c;
      bca = red_ca[tid][l];
      bi = ix;
    }
  }
  const bool found = bi != INT_MAX;
  if (!FUSED) {
    out_cost[qi] = found ? bc : kInf;
    out_idx[qi] = found ? bi : 0;
    return;
  }
  float cost = kInf, ca = 0.0f;
  int lvl = repo_level, slot = 0, pay = -1;
  if (found) {
    cost = bc;
    ca = bca;
    lvl = meta[bi];
    slot = meta[(size_t)K + bi];
    pay = meta[2 * (size_t)K + bi];
  }
  if (fold_repo && h_repo < cost) {        // repository: strict < only
    cost = h_repo;
    ca = 0.0f;
    lvl = repo_level;
    slot = 0;
    pay = -1;
  }
  out_cost[qi] = cost;
  out_ca[qi] = ca;
  out_idx[qi] = lvl;
  out_slot[qi] = slot;
  out_pay[qi] = pay;
}

template <bool FUSED>
int launch(const float* q, const float* keys, const float* h_key,
           const int* meta, int Q, int K, int D, int metric, float gamma,
           float h_repo, int repo_level, int fold_repo, float* cost,
           float* ca, int* idx, int* slot, int* pay, cudaStream_t stream) {
  const dim3 grid((Q + kQT - 1) / kQT);
  switch (metric) {
    case kMetricL1:
      nn_kernel<kMetricL1, FUSED><<<grid, kThreads, 0, stream>>>(
          q, keys, h_key, meta, Q, K, D, gamma, h_repo, repo_level,
          fold_repo, cost, ca, idx, slot, pay);
      break;
    case kMetricL2:
      nn_kernel<kMetricL2, FUSED><<<grid, kThreads, 0, stream>>>(
          q, keys, h_key, meta, Q, K, D, gamma, h_repo, repo_level,
          fold_repo, cost, ca, idx, slot, pay);
      break;
    case kMetricL2Sq:
      nn_kernel<kMetricL2Sq, FUSED><<<grid, kThreads, 0, stream>>>(
          q, keys, h_key, meta, Q, K, D, gamma, h_repo, repo_level,
          fold_repo, cost, ca, idx, slot, pay);
      break;
    default:
      return -1;
  }
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace simcache

// Kernel B: per query, min_k C_a(q, k)^gamma and its lowest argmin.
extern "C" int simcache_knn(const float* q, const float* keys, int Q, int K,
                            int D, int metric, float gamma, float* out_cost,
                            int* out_idx, void* stream) {
  return simcache::launch<false>(q, keys, nullptr, nullptr, Q, K, D, metric,
                                 gamma, 0.0f, 0, 0, out_cost, nullptr,
                                 out_idx, nullptr, nullptr,
                                 (cudaStream_t)stream);
}

// Kernel A: per query, min over valid keys of C_a(q, k)^gamma + h(k), the
// repository folded in last on a strict `<` when fold_repo != 0.
extern "C" int simcache_fused_lookup(const float* q, const float* keys,
                                     const float* h_key, const int* meta,
                                     int Q, int K, int D, int metric,
                                     float gamma, float h_repo,
                                     int repo_level, int fold_repo,
                                     float* cost, float* ca, int* level,
                                     int* slot, int* payload, void* stream) {
  return simcache::launch<true>(q, keys, h_key, meta, Q, K, D, metric, gamma,
                                h_repo, repo_level, fold_repo, cost, ca,
                                level, slot, payload, (cudaStream_t)stream);
}
