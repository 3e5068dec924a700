// Nearest-approximizer lookups for Hopper (sm_90a): kernel A, the fused
// segmented 1-NN over every cache level, and kernel B, the plain blocked
// 1-NN. One template, nn_kernel<METRIC, FUSED, QT, R, C, QSTREAM>, serves
// both.
//
// Replaces the Pallas TPU kernels `_fused_kernel` and `_knn_kernel` of
// src/repro/kernels/knn/knn.py. The TPU walked key tiles along a
// sequential minor grid axis and carried the running minimum in its output
// block; here blocks run in parallel and in no order.
//
// What bounds it: the distance tile, 2*Q*K*D fp32 operations on the CUDA
// cores (the bytes, Q*D + K*D floats, are small next to that at K >= 448).
// fp32 stays IEEE fp32: TF32 on the tensor cores would break the lookup's
// tolerances, so this is a SIMT design.
//
// The invariant that keeps it exact: a pair's value never depends on the
// tiling. Every dot product (or l1 sum) is one chain of fmaf (or add) over
// d = 0, 1, ..., D-1 from 0.0f in one register of one thread, and |q|^2,
// |k|^2 are the same ascending chains; finish_distance, apply_gamma and
// `+ h` follow as in distance.cuh. Features are multiplied up to D rounded
// up to 4; those past D are staged as zeros and add nothing (at most one
// turns a -0 dot into +0, which finish_distance maps to the same value).
// So the outputs are bitwise those of the one-block-per-query-tile kernel
// this design replaced, at every shape and split, and kernel C (gains.cu)
// prices the same pairs to the bit.
//
// Design, one point for each cause of that kernel's slowness:
// * The key axis is split across blocks. The grid is (query tiles) x
//   (key splits); split s walks key tiles [s*n_kt/S, (s+1)*n_kt/S) in
//   ascending order. The wrapper's _split_plan (kernels/knn/knn.py) picks
//   the query tile QT and S so that about two blocks per SM run when K is
//   large, and S = 1 when K is small (the engine's K = 448).
// * The distance tile is register-tiled. A block owns QT queries x 128
//   keys; each of its 256 threads owns an R x C micro-tile of
//   accumulators (QT 64: 4 x 8; QT 8, for small batches: 1 x 4). Per four
//   features a thread makes R + C float4 shared loads and 4*R*C fused
//   multiply-adds. The query tile stays resident in shared memory for the
//   whole split (row-major, so one float4 is one query at four features);
//   thread kg of a query group owns keys kg + KG*j, so a warp's float4
//   key loads hit consecutive rows of stride 36 floats: conflict-free.
//   Rows too wide for a resident tile (D above about 5,500 at QT 8: the
//   wrapper's plan says when) take the QSTREAM instantiation instead (QT 8
//   only): the query tile's 32-feature chunk rides in the ring beside the
//   key chunk, so any D fits, at the price of restaging the queries for
//   every key tile. A template parameter, so the resident path's code is
//   the same as without it.
// * Keys are staged asynchronously: a ring of three (128 x 32)-float
//   chunks filled by cp.async, so chunk i+1 and i+2 are in flight while
//   chunk i is multiplied. One __syncthreads per chunk. The 16-byte path
//   (cp.async.cg) takes rows that are 16-byte aligned with D % 4 == 0
//   (the engine's D = 100); otherwise (D 3, 19 or 37, or a key view whose
//   address is 4 bytes off) the wrapper asks for the 4-byte path
//   (cp.async.ca, one float a copy) inside the same kernel. Both zero-fill
//   past K and past D.
// * The epilogue stays in registers: per pair finish, gamma, h and the
//   valid mask, then a running (cost, C_a, index) per query with a strict
//   `<` over ascending keys; the threads sharing a query reduce
//   lexicographically (cost, then index) by warp shuffles.
// * One launch per call. With S = 1 a block writes the final outputs.
//   With S > 1 each block writes its split's (cost, C_a, index) per query
//   to a workspace the wrapper allocates; the last block of a query tile
//   to arrive (__threadfence, then an atomic counter per query tile,
//   zeroed on the call's stream by cudaMemsetAsync in the launcher)
//   merges the splits lexicographically, which is the reference's
//   reduce_shard_minima: the result does not depend on arrival order.
// `meta` is gathered at the winner and the repository folded in on a
// strict `<`, once, at the end.
#include <climits>
#include <cstddef>
#include <cuda_runtime.h>

#include "distance.cuh"

namespace simcache {
namespace {

constexpr int kThreads = 256;
constexpr int kKT = 128;                  // keys per tile
constexpr int kDC = 32;                   // features per staged chunk
constexpr int kKS = kDC + 4;              // key row stride in shared memory
constexpr int kStages = 3;                // key chunks in the ring
constexpr float kInf = 3.0e38f;           // the reference's masked cost
constexpr int kSmemLimit = 232448;        // a block's dynamic smem (H100)

// Width of the resident query tile's rows: D rounded up to whole chunks.
__host__ __device__ inline int query_stride(int D) {
  return (D > kDC ? (D + kDC - 1) / kDC : 1) * kDC;
}

// Dynamic shared memory of one block (kept equal to knn.py's _smem_bytes):
// the query tile (resident, or one (QT x 32) chunk per ring stage when
// qstream), the key ring, |q|^2 and |k|^2.
__host__ __device__ inline size_t smem_bytes(int QT, int D, bool qstream) {
  const size_t q = qstream ? (size_t)kStages * QT * kDC
                           : (size_t)QT * query_stride(D);
  return sizeof(float) * (q + (size_t)kStages * kKT * kKS + QT + kKT);
}

struct Lookup {
  const float* q;
  const float* keys;
  const float* h_key;
  const int* meta;
  int Q, K, D;
  float gamma, h_repo;
  int repo_level, fold_repo, vec16, qstream;
  float* cost;
  float* ca;
  int* idx;                               // level for kernel A
  int* slot;
  int* pay;
  int* ws;                                // S > 1: partials, then counters
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool in) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(in ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool in) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(in ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Stage rows [r0, r0 + ROWS) x features [c0, c0 + cols) of a row-major
// (n_rows, D) array into dst (row stride ld), zero past n_rows and D. The
// 16-byte path needs D % 4 == 0 and a 16-byte aligned base: then a group
// of four features is wholly inside D or wholly past it.
template <int ROWS>
__device__ __forceinline__ void stage(float* dst, int ld, const float* src,
                                      int n_rows, int D, int r0, int c0,
                                      int cols, bool vec16) {
  if (vec16) {
    const int groups = cols / 4;
    for (int e = threadIdx.x; e < ROWS * groups; e += kThreads) {
      const int r = e / groups, c = (e % groups) * 4;
      const int gr = r0 + r, gc = c0 + c;
      const bool in = gr < n_rows && gc < D;
      cp_async16(dst + r * ld + c, in ? src + (size_t)gr * D + gc : src, in);
    }
  } else {
    for (int e = threadIdx.x; e < ROWS * cols; e += kThreads) {
      const int r = e / cols, c = e % cols;
      const int gr = r0 + r, gc = c0 + c;
      const bool in = gr < n_rows && gc < D;
      cp_async4(dst + r * ld + c, in ? src + (size_t)gr * D + gc : src, in);
    }
  }
}

// The lexicographic (cost, index) order; an empty slot is (kInf, INT_MAX)
// and every recorded key has cost < kInf, so it loses to any of them.
__device__ __forceinline__ void take_min(float& c, float& a, int& x,
                                         float oc, float oa, int ox) {
  if (oc < c || (oc == c && ox < x)) {
    c = oc;
    a = oa;
    x = ox;
  }
}

// One query's outputs from its winner (index INT_MAX: no key qualified).
template <bool FUSED>
__device__ __forceinline__ void write_query(const Lookup& p, int qi, float c,
                                            float a, int x) {
  const bool found = x != INT_MAX;
  if (!FUSED) {
    p.cost[qi] = found ? c : kInf;
    p.idx[qi] = found ? x : 0;
    return;
  }
  float cost = kInf, ca = 0.0f;
  int lvl = p.repo_level, slot = 0, pay = -1;
  if (found) {
    const size_t K = p.K;
    cost = c;
    ca = a;
    lvl = p.meta[x];
    slot = p.meta[K + x];
    pay = p.meta[2 * K + x];
  }
  if (p.fold_repo && p.h_repo < cost) {    // repository: strict < only
    cost = p.h_repo;
    ca = 0.0f;
    lvl = p.repo_level;
    slot = 0;
    pay = -1;
  }
  p.cost[qi] = cost;
  p.ca[qi] = ca;
  p.idx[qi] = lvl;
  p.slot[qi] = slot;
  p.pay[qi] = pay;
}

template <int METRIC, bool FUSED, int QT, int R, int C, bool QSTREAM>
__global__ void __launch_bounds__(kThreads, 2) nn_kernel(const Lookup p) {
  constexpr int QG = QT / R;              // query groups
  constexpr int KG = kThreads / QG;       // threads of one query group
  static_assert(QG * KG == kThreads && KG * C == kKT, "tile shape");
  static_assert(KG <= 32 && (KG & (KG - 1)) == 0, "shuffle width");
  constexpr bool kNorms = METRIC != kMetricL1;

  extern __shared__ __align__(16) float smem[];
  __shared__ int last_s;
  const int QS = query_stride(p.D);       // features multiplied: n_dc chunks
  const int qld = QSTREAM ? kDC : QS;    // row stride of the query tile
  float* qs = smem;                       // [QT][QS], or [kStages][QT][kDC]
  float* ks = qs + (QSTREAM ? kStages * QT * kDC : QT * QS);
  float* qn_s = ks + kStages * kKT * kKS; // [QT]
  float* kn_s = qn_s + QT;                // [kKT]

  const int tid = threadIdx.x, qg = tid / KG, kg = tid % KG;
  const int q0 = blockIdx.x * QT;
  const int split = blockIdx.y, n_splits = gridDim.y;
  const int n_kt = (p.K + kKT - 1) / kKT;
  const int t_begin = (int)((long long)split * n_kt / n_splits);
  const int t_end = (int)((long long)(split + 1) * n_kt / n_splits);
  const int n_dc = QS / kDC;
  const int n_chunks = (t_end - t_begin) * n_dc;
  const bool vec16 = p.vec16 != 0;

  auto issue = [&](int u) {               // chunk u of this split
    if (u < n_chunks) {
      const int t = t_begin + u / n_dc, dc = u % n_dc;
      stage<kKT>(ks + (u % kStages) * kKT * kKS, kKS, p.keys, p.K, p.D,
                 t * kKT, dc * kDC, kDC, vec16);
      if (QSTREAM)                      // the queries' chunk beside it
        stage<QT>(qs + (u % kStages) * QT * kDC, kDC, p.q, p.Q, p.D, q0,
                  dc * kDC, kDC, vec16);
    }
    cp_async_commit();                    // empty groups keep the count
  };
  if (!QSTREAM)                         // resident, in chunk 0's group
    stage<QT>(qs, QS, p.q, p.Q, p.D, q0, 0, QS, vec16);
#pragma unroll
  for (int u = 0; u < kStages - 1; ++u) issue(u);

  float acc[R][C];
  float best_cost[R], best_ca[R];
  int best_idx[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    best_cost[i] = kInf;
    best_ca[i] = 0.0f;
    best_idx[i] = INT_MAX;
#pragma unroll
    for (int j = 0; j < C; ++j) acc[i][j] = 0.0f;
  }
  float kn = 0.0f;                        // |k|^2 of key row tid (tid < kKT)

  for (int u = 0; u < n_chunks; ++u) {
    cp_async_wait<kStages - 2>();         // chunk u (and the queries) landed
    __syncthreads();                      // ... and chunk u - 1 is consumed
    issue(u + kStages - 1);
    const int dc = u % n_dc;
    const float* kc = ks + (u % kStages) * kKT * kKS;
    const float* qc =
        QSTREAM ? qs + (u % kStages) * QT * kDC : qs + dc * kDC;
    // |q|^2, ascending d: from the resident tile at chunk 0, or chunk by
    // chunk over the first key tile when the queries stream (the same
    // chain either way)
    if (kNorms && tid < QT && (QSTREAM ? u < n_dc : u == 0)) {
      const float* row = QSTREAM ? qc + tid * kDC : qs + tid * QS;
      float s = QSTREAM && u > 0 ? qn_s[tid] : 0.0f;
      for (int c = 0; c < (QSTREAM ? kDC : QS); c += 4) {
        const float4 v = *reinterpret_cast<const float4*>(row + c);
        s = fmaf(v.x, v.x, s);
        s = fmaf(v.y, v.y, s);
        s = fmaf(v.z, v.z, s);
        s = fmaf(v.w, v.w, s);
      }
      qn_s[tid] = s;
    }
    // four features of the R x C tile: R + C float4 loads, 4RC FMAs
    auto step = [&](int c) {
      float4 qv[R];
#pragma unroll
      for (int i = 0; i < R; ++i)
        qv[i] = *reinterpret_cast<const float4*>(qc + (qg * R + i) * qld + c);
#pragma unroll
      for (int j = 0; j < C; ++j) {
        const float4 kv =
            *reinterpret_cast<const float4*>(kc + (kg + KG * j) * kKS + c);
#pragma unroll
        for (int i = 0; i < R; ++i) {
          float a = acc[i][j];
          a = accumulate<METRIC>(a, qv[i].x, kv.x);
          a = accumulate<METRIC>(a, qv[i].y, kv.y);
          a = accumulate<METRIC>(a, qv[i].z, kv.z);
          a = accumulate<METRIC>(a, qv[i].w, kv.w);
          acc[i][j] = a;
        }
      }
      if (kNorms && tid < kKT) {
        const float4 v = *reinterpret_cast<const float4*>(kc + tid * kKS + c);
        kn = fmaf(v.x, v.x, kn);
        kn = fmaf(v.y, v.y, kn);
        kn = fmaf(v.z, v.z, kn);
        kn = fmaf(v.w, v.w, kn);
      }
    };
    // a chunk past D's last group of four holds only zeros: the ragged
    // chunk stops there (at D = 100, 4 of its 32 features)
    const int c_end = min(kDC, (p.D - dc * kDC + 3) & ~3);
    if (c_end == kDC) {
#pragma unroll
      for (int c = 0; c < kDC; c += 4) step(c);
    } else {
#pragma unroll 1
      for (int c = 0; c < c_end; c += 4) step(c);
    }
    if (dc != n_dc - 1) continue;
    // the tile's last chunk: finish its pairs
    const int k0 = (t_begin + u / n_dc) * kKT;
    if (kNorms && tid < kKT) {
      kn_s[tid] = kn;                     // read after this barrier; next
      kn = 0.0f;                          // written past the next one
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < C; ++j) {
      const int r = kg + KG * j, kidx = k0 + r;
      // invalid (sentinel / padding) keys are masked before any compare:
      // their distance may be huge or NaN
      const bool use = kidx < p.K &&
                       (FUSED ? __ldg(p.meta + 3 * (size_t)p.K + kidx) > 0
                              : true);
      const float h = FUSED && kidx < p.K ? __ldg(p.h_key + kidx) : 0.0f;
      const float knj = kNorms ? kn_s[r] : 0.0f;
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float qn = kNorms ? qn_s[qg * R + i] : 0.0f;
        const float ca =
            apply_gamma(finish_distance<METRIC>(acc[i][j], qn, knj), p.gamma);
        const float cost = FUSED ? ca + h : ca;
        if (use && cost < best_cost[i]) {  // strict: lowest index wins ties
          best_cost[i] = cost;
          best_ca[i] = ca;
          best_idx[i] = kidx;
        }
        acc[i][j] = 0.0f;
      }
    }
  }

  // the KG threads of a query group hold disjoint keys: reduce them
#pragma unroll
  for (int i = 0; i < R; ++i) {
#pragma unroll
    for (int off = KG / 2; off > 0; off /= 2) {
      const float oc = __shfl_xor_sync(0xffffffffu, best_cost[i], off);
      const float oa = __shfl_xor_sync(0xffffffffu, best_ca[i], off);
      const int ox = __shfl_xor_sync(0xffffffffu, best_idx[i], off);
      take_min(best_cost[i], best_ca[i], best_idx[i], oc, oa, ox);
    }
  }

  if (n_splits == 1) {
    if (kg == 0) {
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int qi = q0 + qg * R + i;
        if (qi < p.Q)
          write_query<FUSED>(p, qi, best_cost[i], best_ca[i], best_idx[i]);
      }
    }
    return;
  }

  // several splits: publish this split's minima, and the last block of
  // the query tile to arrive merges them in split order
  const size_t SQ = (size_t)n_splits * p.Q;
  float* ws_cost = reinterpret_cast<float*>(p.ws);
  float* ws_ca = ws_cost + SQ;
  int* ws_idx = p.ws + 2 * SQ;
  int* arrived = p.ws + 3 * SQ;
  if (kg == 0) {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int qi = q0 + qg * R + i;
      if (qi < p.Q) {
        const size_t w = (size_t)split * p.Q + qi;
        ws_cost[w] = best_cost[i];
        ws_ca[w] = best_ca[i];
        ws_idx[w] = best_idx[i];
      }
    }
  }
  __threadfence();                        // partials visible before arrival
  __syncthreads();
  if (tid == 0)
    last_s = atomicAdd(arrived + blockIdx.x, 1) == n_splits - 1;
  __syncthreads();
  if (!last_s) return;
  __threadfence();
  if (tid < QT && q0 + tid < p.Q) {
    const int qi = q0 + tid;
    float c = kInf, a = 0.0f;
    int x = INT_MAX;
    for (int s = 0; s < n_splits; ++s) {  // lower split = lower indices
      const size_t w = (size_t)s * p.Q + qi;
      take_min(c, a, x, __ldcg(ws_cost + w), __ldcg(ws_ca + w),
               __ldcg(ws_idx + w));
    }
    write_query<FUSED>(p, qi, c, a, x);
  }
}

template <int METRIC, bool FUSED, int QT, int R, int C, bool QSTREAM>
int launch_tile(const Lookup& p, int n_splits, cudaStream_t stream) {
  const auto kernel = nn_kernel<METRIC, FUSED, QT, R, C, QSTREAM>;
  const size_t smem = smem_bytes(QT, p.D, QSTREAM);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_qt = (p.Q + QT - 1) / QT;
  if (n_splits > 1) {                     // the arrival counters
    err = cudaMemsetAsync(p.ws + 3 * (size_t)n_splits * p.Q, 0,
                          sizeof(int) * n_qt, stream);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<dim3(n_qt, n_splits), kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int METRIC, bool FUSED>
int launch_metric(const Lookup& p, int q_tile, int n_splits,
                  cudaStream_t stream) {
  if (p.qstream)                          // wide rows: the 8-query tile only
    return q_tile == 8 ? launch_tile<METRIC, FUSED, 8, 1, 4, true>(
                             p, n_splits, stream)
                       : (int)cudaErrorInvalidValue;
  if (q_tile == 64)
    return launch_tile<METRIC, FUSED, 64, 4, 8, false>(p, n_splits, stream);
  if (q_tile == 8)
    return launch_tile<METRIC, FUSED, 8, 1, 4, false>(p, n_splits, stream);
  return (int)cudaErrorInvalidValue;
}

template <bool FUSED>
int launch(const Lookup& p, int metric, int q_tile, int n_splits,
           cudaStream_t stream) {
  const int n_kt = (p.K + kKT - 1) / kKT;
  if (p.Q <= 0 || p.K <= 0 || p.D < 0 || n_splits < 1 || n_splits > n_kt ||
      (n_splits > 1 && p.ws == nullptr) ||
      smem_bytes(q_tile, p.D, p.qstream != 0) > (size_t)kSmemLimit)
    return (int)cudaErrorInvalidValue;
  switch (metric) {
    case kMetricL1:
      return launch_metric<kMetricL1, FUSED>(p, q_tile, n_splits, stream);
    case kMetricL2:
      return launch_metric<kMetricL2, FUSED>(p, q_tile, n_splits, stream);
    case kMetricL2Sq:
      return launch_metric<kMetricL2Sq, FUSED>(p, q_tile, n_splits, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace simcache

// Kernel B: per query, min_k C_a(q, k)^gamma and its lowest argmin.
// q_tile (64 or 8), n_splits and qstream come from the wrapper's split
// plan (qstream != 0: the query tile is staged chunk by chunk beside the
// keys, for rows too wide to keep resident); vec16 != 0 selects the
// 16-byte staging path; workspace holds 3 * n_splits * Q +
// ceil(Q / q_tile) ints when n_splits > 1.
extern "C" int simcache_knn(const float* q, const float* keys, int Q, int K,
                            int D, int metric, float gamma, float* out_cost,
                            int* out_idx, int q_tile, int n_splits,
                            int qstream, int vec16, int* workspace,
                            void* stream) {
  simcache::Lookup p{q,        keys,    nullptr, nullptr, Q,       K,
                     D,        gamma,   0.0f,    0,       0,       vec16,
                     qstream,  out_cost, nullptr, out_idx, nullptr, nullptr,
                     workspace};
  return simcache::launch<false>(p, metric, q_tile, n_splits,
                                 (cudaStream_t)stream);
}

// Kernel A: per query, min over valid keys of C_a(q, k)^gamma + h(k), the
// repository folded in last on a strict `<` when fold_repo != 0. The plan
// arguments are kernel B's.
extern "C" int simcache_fused_lookup(const float* q, const float* keys,
                                     const float* h_key, const int* meta,
                                     int Q, int K, int D, int metric,
                                     float gamma, float h_repo,
                                     int repo_level, int fold_repo,
                                     float* cost, float* ca, int* level,
                                     int* slot, int* payload, int q_tile,
                                     int n_splits, int qstream, int vec16,
                                     int* workspace, void* stream) {
  simcache::Lookup p{q,       keys,  h_key,  meta,       Q,         K,
                     D,       gamma, h_repo, repo_level, fold_repo, vec16,
                     qstream, cost,  ca,     level,      slot,      payload,
                     workspace};
  return simcache::launch<true>(p, metric, q_tile, n_splits,
                                (cudaStream_t)stream);
}
