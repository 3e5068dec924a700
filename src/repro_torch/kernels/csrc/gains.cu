// Placement gain oracles for Hopper (sm_90a): kernels C and D.
//
//   C: gain[j, o'] = sum_i sum_r lam[i, r] * relu(cur[i, r] - C_a(x_r, y_o') - H[i, j])
//   D: gain[j, o'] = sum_r lam[r] * relu(cur[r] - C_a(x_r, y_o') - H[r, j])
//
// Kernel C replaces the Pallas TPU kernel `_gains_kernel` of
// src/repro/kernels/knn/gains.py; kernel D, its single-ingress precursor
// with one H row per request, replaces `_gain_kernel` of
// src/repro/kernels/gain/gain.py. Both TPU grids walked request tiles
// along a sequential minor axis, accumulating into the (J, BO) output
// block. Here one thread block owns a tile of BO candidates and walks
// *all* request tiles itself, in order, accumulating its J sums per
// candidate in registers: no atomics, so every candidate's sum has one
// fixed order that does not depend on launch order or on how candidates
// are split across blocks (the property a candidate-sharded oracle relies
// on). D is the same kernel with I = 1 and H read per request
// (PER_REQUEST_H); padding is not needed: the ragged request and
// candidate edges are masked, where the TPU path padded with zeros.
//
// What bounds them: the C_a tile, 2*R*O*D flops of fp32 work on the CUDA
// cores; the fold adds about 3*I*J flops per pair and the bytes (R*D +
// O*D + 2*I*R floats in, plus R*J of H for D, J*O out) are negligible.
// Design: candidate chunks are staged in shared memory with a padded
// stride, request chunks are read as float4 broadcasts (one shared load
// feeds four fused multiply-adds), and each thread keeps RPT request dot
// products for its one candidate. The C_a value of each pair is computed
// once and folded into every (ingress, cache) pair. fp32 on the CUDA
// cores, no tuning yet.
#include <cuda_runtime.h>

#include "distance.cuh"

namespace simcache {
namespace {

constexpr int kThreads = 256;
constexpr int kBO = 64;                   // candidates per block
constexpr int kBR = 64;                   // requests per tile
constexpr int kDC = 32;                   // feature chunk staged at a time
constexpr int kRG = kThreads / kBO;       // request groups per block
constexpr int kRPT = kBR / kRG;           // requests per thread per tile
constexpr int kMaxJ = 8;                  // caches held in registers

// PER_REQUEST_H: H is (R, J), one row per request (kernel D, I = 1);
// otherwise H is (I, J), one row per ingress (kernel C).
template <int METRIC, bool PER_REQUEST_H>
__global__ void __launch_bounds__(kThreads)
gains_kernel(const float* __restrict__ x, const float* __restrict__ y,
             const float* __restrict__ lam, const float* __restrict__ cur,
             const float* __restrict__ H, int R, int O, int D, int I, int J,
             float gamma, float* __restrict__ out) {
  __shared__ __align__(16) float xs[kBR][kDC];
  __shared__ float ys[kBO][kDC + 1];
  __shared__ float xn_s[kBR];
  __shared__ float part[kRG][kMaxJ][kBO];

  const int tid = threadIdx.x;
  const int lane = tid % kBO;             // candidate lane
  const int grp = tid / kBO;              // request group
  const int o = blockIdx.x * kBO + lane;

  float yn = 0.0f;                        // |y_o|^2, once per block
  if (METRIC != kMetricL1 && o < O)
    for (int d = 0; d < D; ++d) {
      const float v = y[(size_t)o * D + d];
      yn = fmaf(v, v, yn);
    }

  float acc[kMaxJ];
#pragma unroll
  for (int j = 0; j < kMaxJ; ++j) acc[j] = 0.0f;

  for (int r0 = 0; r0 < R; r0 += kBR) {
    float dot[kRPT];
#pragma unroll
    for (int i = 0; i < kRPT; ++i) dot[i] = 0.0f;
    float xn = 0.0f;
    for (int d0 = 0; d0 < D; d0 += kDC) {
      __syncthreads();                    // previous chunk fully consumed
      for (int e = tid; e < kBR * kDC; e += kThreads) {
        const int r = e / kDC, c = e % kDC;
        const int rr = r0 + r, dc = d0 + c;
        xs[r][c] = (rr < R && dc < D) ? x[(size_t)rr * D + dc] : 0.0f;
      }
      for (int e = tid; e < kBO * kDC; e += kThreads) {
        const int r = e / kDC, c = e % kDC;
        const int oo = blockIdx.x * kBO + r, dc = d0 + c;
        ys[r][c] = (oo < O && dc < D) ? y[(size_t)oo * D + dc] : 0.0f;
      }
      __syncthreads();
      // zero-staged columns past D add exactly nothing to any sum
      const int dn = (min(kDC, D - d0) + 3) & ~3;
      for (int c = 0; c < dn; c += 4) {
        const float y0 = ys[lane][c], y1 = ys[lane][c + 1];
        const float y2 = ys[lane][c + 2], y3 = ys[lane][c + 3];
        if (METRIC != kMetricL1 && tid < kBR) {
          const float4 xv = *reinterpret_cast<const float4*>(&xs[tid][c]);
          xn = fmaf(xv.x, xv.x, xn);
          xn = fmaf(xv.y, xv.y, xn);
          xn = fmaf(xv.z, xv.z, xn);
          xn = fmaf(xv.w, xv.w, xn);
        }
#pragma unroll
        for (int i = 0; i < kRPT; ++i) {
          const float4 xv =
              *reinterpret_cast<const float4*>(&xs[grp + kRG * i][c]);
          float a = dot[i];
          a = accumulate<METRIC>(a, xv.x, y0);
          a = accumulate<METRIC>(a, xv.y, y1);
          a = accumulate<METRIC>(a, xv.z, y2);
          a = accumulate<METRIC>(a, xv.w, y3);
          dot[i] = a;
        }
      }
    }
    if (tid < kBR) xn_s[tid] = xn;
    __syncthreads();
    if (o < O) {
#pragma unroll
      for (int i = 0; i < kRPT; ++i) {
        const int rl = grp + kRG * i;
        const int r = r0 + rl;
        if (r >= R) continue;
        const float ca = apply_gamma(
            finish_distance<METRIC>(dot[i], xn_s[rl], yn), gamma);
        for (int ii = 0; ii < I; ++ii) {
          const float l = __ldg(&lam[(size_t)ii * R + r]);
          const float slack = __ldg(&cur[(size_t)ii * R + r]) - ca;
          const float* hrow =
              PER_REQUEST_H ? H + (size_t)r * J : H + (size_t)ii * J;
#pragma unroll
          for (int j = 0; j < kMaxJ; ++j)
            if (j < J) acc[j] += l * fmaxf(slack - __ldg(&hrow[j]), 0.0f);
        }
      }
    }
  }

#pragma unroll
  for (int j = 0; j < kMaxJ; ++j) part[grp][j][lane] = acc[j];
  __syncthreads();
  if (grp != 0 || o >= O) return;
#pragma unroll
  for (int j = 0; j < kMaxJ; ++j) {
    if (j >= J) break;
    float s = part[0][j][lane];           // fixed combine order
    for (int g = 1; g < kRG; ++g) s += part[g][j][lane];
    out[(size_t)j * O + o] = s;
  }
}

template <bool PER_REQUEST_H>
int launch_gains(const float* x, const float* y, const float* lam,
                 const float* cur, const float* H, int R, int O, int D,
                 int I, int J, int metric, float gamma, float* out,
                 void* stream) {
  if (J < 1 || J > kMaxJ) return -1;
  const dim3 grid((O + kBO - 1) / kBO);
  cudaStream_t s = (cudaStream_t)stream;
  switch (metric) {
    case kMetricL1:
      gains_kernel<kMetricL1, PER_REQUEST_H><<<grid, kThreads, 0, s>>>(
          x, y, lam, cur, H, R, O, D, I, J, gamma, out);
      break;
    case kMetricL2:
      gains_kernel<kMetricL2, PER_REQUEST_H><<<grid, kThreads, 0, s>>>(
          x, y, lam, cur, H, R, O, D, I, J, gamma, out);
      break;
    case kMetricL2Sq:
      gains_kernel<kMetricL2Sq, PER_REQUEST_H><<<grid, kThreads, 0, s>>>(
          x, y, lam, cur, H, R, O, D, I, J, gamma, out);
      break;
    default:
      return -1;
  }
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace simcache

// Kernel C: the (J, O) gain table. x (R, D), y (O, D), lam and cur (I, R),
// H (I, J) with off-path entries already mapped to a finite sentinel;
// J <= 8.
extern "C" int simcache_gains(const float* x, const float* y,
                              const float* lam, const float* cur,
                              const float* H, int R, int O, int D, int I,
                              int J, int metric, float gamma, float* out,
                              void* stream) {
  return simcache::launch_gains<false>(x, y, lam, cur, H, R, O, D, I, J,
                                       metric, gamma, out, stream);
}

// Kernel D: the (J, O) gain table. x (R, D), y (O, D), lam and cur (R,),
// H (R, J) with off-path entries already mapped to a finite sentinel;
// J <= 8.
extern "C" int simcache_greedy_gain(const float* x, const float* y,
                                    const float* lam, const float* cur,
                                    const float* H, int R, int O, int D,
                                    int J, int metric, float gamma,
                                    float* out, void* stream) {
  return simcache::launch_gains<true>(x, y, lam, cur, H, R, O, D, 1, J,
                                      metric, gamma, out, stream);
}
