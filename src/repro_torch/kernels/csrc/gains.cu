// Placement gain oracles for Hopper (sm_90a): kernels C and D. One
// template, gains_kernel<METRIC, PER_REQUEST_H, JW, YSTREAM>, serves both.
//
//   C: gain[j, o'] = sum_i sum_r lam[i, r] * relu(cur[i, r] - C_a(x_r, y_o') - H[i, j])
//   D: gain[j, o'] = sum_r lam[r] * relu(cur[r] - C_a(x_r, y_o') - H[r, j])
//
// Kernel C replaces the Pallas TPU kernel `_gains_kernel` of
// src/repro/kernels/knn/gains.py; kernel D, its single-ingress precursor
// with one H row per request, replaces `_gain_kernel` of
// src/repro/kernels/gain/gain.py. Both TPU grids walked request tiles
// along a sequential minor axis, accumulating into the (J, BO) output
// block. Here one thread block owns a tile of candidates and walks *all*
// request tiles itself, in order: no atomics, and the request axis is
// never split across blocks. D is the same kernel with I = 1 and H read
// per request (PER_REQUEST_H). The ragged request and candidate edges are
// masked, where the TPU path padded with zeros.
//
// What bounds it on an H100: the C_a tile, 2*R*O*D fp32 operations on the
// CUDA cores (29.9 ms at R = O = 1e5, D = 100), plus an epilogue of about
// 20 instructions per pair (the IEEE sqrtf, then cur - C_a and one
// (sub, max, fma) per cache). The bytes (R*D + O*D + 2*I*R floats in, R*J
// more of H for D, J*O out) are small next to that.
//
// The fixed sum order (the contract; every output is bitwise that of the
// one-candidate-per-thread kernel this design replaced, at every tiling):
// * One pair's C_a: its dot product (or l1 sum) is one ascending-d chain
//   of fmaf (or acc + |a - b|) from 0.0f in one register of one thread;
//   features are multiplied up to each 32-feature chunk's width rounded up
//   to 4, and zero-staged features add nothing. |x_r|^2 and |y_o|^2 are
//   ascending fmaf chains. finish_distance (IEEE sqrtf) and apply_gamma
//   (distance.cuh) follow.
// * One candidate's gain: four chains per candidate. Chain g (0..3) holds
//   the requests r = g (mod 4), in ascending r; each request adds its
//   ingresses ii in ascending order as acc[j] += lam * max(slack - H, 0)
//   with slack = cur - C_a. Each (chain, candidate) accumulator lives in
//   one thread's register for the whole request axis. The chains combine
//   as ((c0 + c1) + c2) + c3.
// The order depends neither on O, nor on how candidates are tiled, nor on
// launch order, so any slice of candidates gets the columns of the full
// call bit for bit (what a candidate-sharded oracle needs).
//
// Design, one point for each cause of the old kernel's slowness:
// * A wider register tile. A block is 4 warps, one per chain, over 128
//   candidates. The chain is uniform across a warp, so the request loads
//   are shared-memory broadcasts, and each thread holds its chain's 8
//   requests of a 32-request tile x 4 candidates (lane, lane + 32,
//   lane + 64, lane + 96): 32 fp32 accumulators. Every 4 features cost
//   8 broadcast float4 loads of x and 4 float4 loads of y for 128 fused
//   multiply-adds (the old kernel: 16 + 4 loads for 64). Measured on an
//   H100: 16 x 4 (64 accumulators, 8 warps an SM) ran at half this
//   tile's speed, and 4 x 8, 16 x 2, 8 x 2 and 8 x 3 or 8 x 5 were no
//   faster, nor were two warps a chain (256 candidates a block); at 168
//   registers and a 66 KB block, three blocks (12 warps) share an SM.
// * The candidate tile is resident in shared memory for the whole kernel
//   (dynamic shared memory, row stride D rounded up to 4 and made an odd
//   number of float4s, so a quarter-warp's float4 reads of consecutive
//   rows fall on distinct banks), staged once, its norms computed once.
//   Rows too wide for it (the plan says when: above D 420 at 128
//   candidates) take the YSTREAM instantiation, which stages the
//   candidates' 32-feature chunk beside the requests' for every tile.
// * Request tiles are staged asynchronously: a ring of three (32 x 32)
//   chunks filled by cp.async, so chunks u+1 and u+2 are in flight while
//   chunk u is multiplied; one __syncthreads per chunk, and one more per
//   tile before its epilogue (|x_r|^2 is shared there). 16-byte copies
//   when D % 4 == 0 and x and y are 16-byte aligned (the engine's
//   D = 100), 4-byte copies otherwise, in the same kernel.
// * The fold reads lam, cur and H from shared memory (staged with the
//   tile's first chunk, a slot per ring stage), not from global memory
//   per pair, and is unrolled to a J width of 1, 3 or 8 (J = 3 is the
//   engine's): columns past J are computed on zeros and never written.
// * The |x_r|^2 chains run in the first warp, interleaved with its
//   products (the staged rows' stride, 36 floats, is conflict-free); the
//   |y_o|^2 chains once, from the resident tile.
// What holds it at ~38 % of the fp32 bound (R = O = 1e5: 84 ms against
// 31.6): the shared-memory loads (12 float4 loads per 128 FMAs), the
// per-pair epilogue (about a fifth of the issued instructions), and
// latency that 12 warps an SM do not hide; the candidate tile's shared
// memory caps the warps.
#include <cstddef>
#include <cuda_runtime.h>

#include "distance.cuh"

namespace simcache {
namespace {

constexpr int kChains = 4;                // request chains r mod 4
constexpr int kRPT = 8;                   // requests of one chain per thread
constexpr int kCPT = 4;                   // candidates per thread
constexpr int kBR = kChains * kRPT;       // requests per tile
constexpr int kBO = 32 * kCPT;            // candidates per block
constexpr int kThreads = kChains * 32;    // one warp per chain
constexpr int kBlocksPerSM = 3;
constexpr int kDC = 32;                   // features per staged chunk
constexpr int kXS = kDC + 4;              // request chunk row stride
constexpr int kYS = kDC + 4;              // streamed candidate chunk stride
constexpr int kStages = 3;                // chunks in the ring
constexpr int kSmemLimit = 232448;        // a block's dynamic smem (H100)

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

// Row stride of the resident candidate tile: D rounded up to 4, then an
// odd number of float4s.
__host__ __device__ inline int cand_stride(int D) {
  const int d4 = round4(D);
  return (d4 / 4) % 2 == 0 ? d4 + 4 : d4;
}

// Dynamic shared memory of one block, in floats from its base (kept equal
// to gains.py's _smem_bytes): the candidate tile (resident, or one chunk
// per ring stage; reused for the chain combine at the end), the request
// ring, lam and cur per stage, H (per stage for D; once, I x JW, for C),
// and |x|^2 of the current tile.
struct Layout {
  int x, lam, cur, h, xn, total;
};

__host__ __device__ inline Layout layout(int D, int I, int JW,
                                         bool per_request_h, bool ystream) {
  const int ys = ystream ? kStages * kBO * kYS : kBO * cand_stride(D);
  const int part = (kChains - 1) * JW * kBO;
  Layout L;
  L.x = ys > part ? ys : part;
  L.lam = L.x + kStages * kBR * kXS;
  L.cur = L.lam + kStages * I * kBR;
  L.h = L.cur + kStages * I * kBR;
  L.xn = L.h + round4(per_request_h ? kStages * kBR * JW : I * JW);
  L.total = L.xn + kBR;
  return L;
}

struct Gains {
  const float* x;
  const float* y;
  const float* lam;
  const float* cur;
  const float* H;
  int R, O, D, I, J;
  float gamma;
  int vec16;
  float* out;
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

// Stage rows [r0, r0 + rows) x features [c0, c0 + cols) of a row-major
// (n_rows, D) array into dst (row stride ld), zero past n_rows and D. The
// 16-byte path needs D % 4 == 0 and a 16-byte aligned base: then a group
// of four features is wholly inside D or wholly past it. COLS > 0 fixes
// cols at compile time (a ring chunk: no runtime division). The staging
// loops here and in the kernel stride by blockDim.x, not by the constant
// kThreads: with the constant, nvcc unrolls them and the kernel ran 4-5 %
// slower on an H100 (83.2 against 86.9 ms at R = O = 1e5), same bits.
template <int COLS = 0>
__device__ __forceinline__ void stage(float* dst, int ld, const float* src,
                                      int n_rows, int D, int rows, int r0,
                                      int c0, int cols, bool vec16) {
  if (COLS > 0) cols = COLS;
  if (vec16) {
    const int groups = cols / 4;
    for (int e = threadIdx.x; e < rows * groups; e += blockDim.x) {
      const int r = e / groups, c = (e % groups) * 4;
      const int gr = r0 + r, gc = c0 + c;
      const bool in = gr < n_rows && gc < D;
      cp_async16(dst + r * ld + c, in ? src + (size_t)gr * D + gc : src, in);
    }
  } else {
    for (int e = threadIdx.x; e < rows * cols; e += blockDim.x) {
      const int r = e / cols, c = e % cols;
      const int gr = r0 + r, gc = c0 + c;
      const bool in = gr < n_rows && gc < D;
      cp_async4(dst + r * ld + c, in ? src + (size_t)gr * D + gc : src, in);
    }
  }
}

template <int METRIC, bool PER_REQUEST_H, int JW, bool YSTREAM>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
    gains_kernel(const Gains p) {
  constexpr bool kNorms = METRIC != kMetricL1;
  extern __shared__ __align__(16) float smem[];
  const Layout L = layout(p.D, p.I, JW, PER_REQUEST_H, YSTREAM);
  float* ys = smem;                       // [kBO][yld], or [kStages][kBO][kYS]
  float* xs = smem + L.x;                 // [kStages][kBR][kXS]
  float* lam_s = smem + L.lam;            // [kStages][I][kBR]
  float* cur_s = smem + L.cur;            // [kStages][I][kBR]
  float* h_s = smem + L.h;                // [kStages][kBR][JW], or [I][JW]
  float* xn_s = smem + L.xn;              // [kBR]

  const int tid = threadIdx.x, lane = tid % 32;
  const int g = tid / 32;                 // this thread's chain
  const int o0 = blockIdx.x * kBO;
  const int d4 = round4(p.D);
  const int yld = YSTREAM ? kYS : cand_stride(p.D);
  const int n_dc = p.D > kDC ? (p.D + kDC - 1) / kDC : 1;
  const int n_chunks = (p.R + kBR - 1) / kBR * n_dc;
  const bool vec16 = p.vec16 != 0;

  // H's columns past J stay zero: their sums are computed, never written
  if (PER_REQUEST_H) {
    for (int e = tid; e < kStages * kBR * JW; e += blockDim.x)
      if (e % JW >= p.J) h_s[e] = 0.0f;
  } else {
    for (int e = tid; e < p.I * JW; e += blockDim.x) {
      const int ii = e / JW, j = e % JW;
      h_s[e] = j < p.J ? p.H[(size_t)ii * p.J + j] : 0.0f;
    }
  }

  auto issue = [&](int u) {               // chunk u: tile u / n_dc
    if (u < n_chunks) {
      const int t = u / n_dc, dc = u % n_dc, s = u % kStages;
      stage<kDC>(xs + s * kBR * kXS, kXS, p.x, p.R, p.D, kBR, t * kBR,
                 dc * kDC, kDC, vec16);
      if (YSTREAM)                        // the candidates' chunk beside it
        stage<kDC>(ys + s * kBO * kYS, kYS, p.y, p.O, p.D, kBO, o0,
                   dc * kDC, kDC, vec16);
      if (dc == 0) {                      // the tile's lam, cur (and H rows)
        const int slot = t % kStages, r0 = t * kBR;
        for (int e = tid; e < p.I * kBR; e += blockDim.x) {
          const int ii = e / kBR, rl = e % kBR, r = r0 + rl;
          const bool in = r < p.R;
          const size_t off = in ? (size_t)ii * p.R + r : 0;
          cp_async4(lam_s + (slot * p.I + ii) * kBR + rl, p.lam + off, in);
          cp_async4(cur_s + (slot * p.I + ii) * kBR + rl, p.cur + off, in);
        }
        if (PER_REQUEST_H)
          for (int e = tid; e < kBR * p.J; e += blockDim.x) {
            const int rl = e / p.J, j = e % p.J, r = r0 + rl;
            const bool in = r < p.R;
            cp_async4(h_s + (slot * kBR + rl) * JW + j,
                      p.H + (in ? (size_t)r * p.J + j : 0), in);
          }
      }
    }
    cp_async_commit();                    // empty groups keep the count
  };
  if (!YSTREAM)                           // resident, in chunk 0's group
    stage(ys, yld, p.y, p.O, p.D, kBO, o0, 0, d4, vec16);
#pragma unroll
  for (int u = 0; u < kStages - 1; ++u) issue(u);

  float acc[kRPT][kCPT];
  float fold[kCPT][JW];
  float yn[kCPT];                         // |y|^2 of this thread's candidates
#pragma unroll
  for (int c = 0; c < kCPT; ++c) {
    yn[c] = 0.0f;
#pragma unroll
    for (int j = 0; j < JW; ++j) fold[c][j] = 0.0f;
#pragma unroll
    for (int i = 0; i < kRPT; ++i) acc[i][c] = 0.0f;
  }
  float xn = 0.0f;                        // |x|^2 of tile row tid (tid < kBR)

  for (int u = 0; u < n_chunks; ++u) {
    cp_async_wait<kStages - 2>();         // chunk u (and the tile data) landed
    __syncthreads();                      // ... and chunk u - 1 is consumed
    issue(u + kStages - 1);
    const int t = u / n_dc, dc = u % n_dc, s = u % kStages;
    const float* xc = xs + s * kBR * kXS;
    const float* yc = YSTREAM ? ys + s * kBO * kYS : ys + dc * kDC;
    // a chunk past D's last group of four holds only zeros: the ragged
    // chunk stops there (at D = 100, 4 of its 32 features)
    const int c_end = min(kDC, round4(p.D - dc * kDC));
    if (kNorms) {
      // |y|^2, ascending d: from the resident tile at chunk 0, or chunk by
      // chunk over the first request tile when the candidates stream
      if (YSTREAM ? t == 0 : u == 0) {
#pragma unroll
        for (int c = 0; c < kCPT; ++c) {
          const float* row = yc + (lane + 32 * c) * yld;
          float sum = yn[c];
          for (int f = 0; f < (YSTREAM ? c_end : d4); f += 4) {
            const float4 v = *reinterpret_cast<const float4*>(row + f);
            sum = fmaf(v.x, v.x, sum);
            sum = fmaf(v.y, v.y, sum);
            sum = fmaf(v.z, v.z, sum);
            sum = fmaf(v.w, v.w, sum);
          }
          yn[c] = sum;
        }
      }
    }
    // four features of the 8 x 4 tile: 8 broadcast float4 loads of x,
    // 4 float4 loads of y, 128 FMAs; the first kBR threads also carry
    // |x|^2 of tile row tid, ascending d, between them
    auto step = [&](int f) {
      if (kNorms && tid < kBR) {
        const float4 v = *reinterpret_cast<const float4*>(xc + tid * kXS + f);
        xn = fmaf(v.x, v.x, xn);
        xn = fmaf(v.y, v.y, xn);
        xn = fmaf(v.z, v.z, xn);
        xn = fmaf(v.w, v.w, xn);
      }
      float4 yv[kCPT];
#pragma unroll
      for (int c = 0; c < kCPT; ++c)
        yv[c] = *reinterpret_cast<const float4*>(yc + (lane + 32 * c) * yld + f);
#pragma unroll
      for (int i = 0; i < kRPT; ++i) {
        const float4 xv =
            *reinterpret_cast<const float4*>(xc + (g + kChains * i) * kXS + f);
#pragma unroll
        for (int c = 0; c < kCPT; ++c) {
          float a = acc[i][c];
          a = accumulate<METRIC>(a, xv.x, yv[c].x);
          a = accumulate<METRIC>(a, xv.y, yv[c].y);
          a = accumulate<METRIC>(a, xv.z, yv[c].z);
          a = accumulate<METRIC>(a, xv.w, yv[c].w);
          acc[i][c] = a;
        }
      }
    };
    if (c_end == kDC) {
#pragma unroll
      for (int f = 0; f < kDC; f += 4) step(f);
    } else {
#pragma unroll 1
      for (int f = 0; f < c_end; f += 4) step(f);
    }
    if (dc != n_dc - 1) continue;
    // the tile's last chunk: fold its pairs, chain by chain in request order
    if (kNorms && tid < kBR) {
      xn_s[tid] = xn;                     // read after this barrier; next
      xn = 0.0f;                          // written past the next one
    }
    __syncthreads();
    const int r0 = t * kBR, slot = t % kStages;
    const float* lt = lam_s + slot * p.I * kBR;
    const float* ct = cur_s + slot * p.I * kBR;
#pragma unroll
    for (int i = 0; i < kRPT; ++i) {
      const int rl = g + kChains * i;
      if (r0 + rl < p.R) {                // uniform across the warp
        const float qn = kNorms ? xn_s[rl] : 0.0f;
        float ca[kCPT];
#pragma unroll
        for (int c = 0; c < kCPT; ++c)
          ca[c] = apply_gamma(finish_distance<METRIC>(acc[i][c], qn, yn[c]),
                              p.gamma);
        for (int ii = 0; ii < p.I; ++ii) {
          const float l = lt[ii * kBR + rl];
          const float cu = ct[ii * kBR + rl];
          const float* hrow =
              PER_REQUEST_H ? h_s + (slot * kBR + rl) * JW : h_s + ii * JW;
          float h[JW];
#pragma unroll
          for (int j = 0; j < JW; ++j) h[j] = hrow[j];
#pragma unroll
          for (int c = 0; c < kCPT; ++c) {
            const float slack = cu - ca[c];
#pragma unroll
            for (int j = 0; j < JW; ++j)
              fold[c][j] += l * fmaxf(slack - h[j], 0.0f);
          }
        }
      }
#pragma unroll
      for (int c = 0; c < kCPT; ++c) acc[i][c] = 0.0f;
    }
  }

  // combine the chains in their fixed order, through the candidate tile's
  // space: ((c0 + c1) + c2) + c3
  cp_async_wait<0>();
  __syncthreads();
  float* part = smem;                     // [kChains - 1][JW][kBO]
  if (g != 0) {
#pragma unroll
    for (int c = 0; c < kCPT; ++c)
#pragma unroll
      for (int j = 0; j < JW; ++j)
        part[((g - 1) * JW + j) * kBO + lane + 32 * c] = fold[c][j];
  }
  __syncthreads();
  if (g != 0) return;
#pragma unroll
  for (int c = 0; c < kCPT; ++c) {
    const int ol = lane + 32 * c, o = o0 + ol;
    if (o >= p.O) continue;
#pragma unroll
    for (int j = 0; j < JW; ++j) {
      if (j >= p.J) break;
      float s = fold[c][j];
#pragma unroll
      for (int k = 0; k < kChains - 1; ++k) s += part[(k * JW + j) * kBO + ol];
      p.out[(size_t)j * p.O + o] = s;
    }
  }
}

template <int METRIC, bool PER_REQUEST_H, int JW, bool YSTREAM>
int launch_tile(const Gains& p, cudaStream_t stream) {
  const auto kernel = gains_kernel<METRIC, PER_REQUEST_H, JW, YSTREAM>;
  const size_t smem = sizeof(float) *
                      (size_t)layout(p.D, p.I, JW, PER_REQUEST_H, YSTREAM).total;
  if (smem > (size_t)kSmemLimit) return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(p.O + kBO - 1) / kBO, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// J widths 1, 3 and 8 (J = 2 runs at 3, J = 4..8 at 8); the streamed
// candidate tile only at 8
template <int METRIC, bool PER_REQUEST_H>
int launch_width(const Gains& p, int ystream, cudaStream_t s) {
  if (ystream) return launch_tile<METRIC, PER_REQUEST_H, 8, true>(p, s);
  if (p.J == 1) return launch_tile<METRIC, PER_REQUEST_H, 1, false>(p, s);
  if (p.J <= 3) return launch_tile<METRIC, PER_REQUEST_H, 3, false>(p, s);
  return launch_tile<METRIC, PER_REQUEST_H, 8, false>(p, s);
}

template <bool PER_REQUEST_H>
int launch(const Gains& p, int metric, int ystream, void* stream) {
  if (p.O <= 0 || p.R < 0 || p.D < 0 || p.I < 1 || p.J < 1 || p.J > 8)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (metric) {
    case kMetricL1:
      return launch_width<kMetricL1, PER_REQUEST_H>(p, ystream, s);
    case kMetricL2:
      return launch_width<kMetricL2, PER_REQUEST_H>(p, ystream, s);
    case kMetricL2Sq:
      return launch_width<kMetricL2Sq, PER_REQUEST_H>(p, ystream, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace simcache

// Kernel C: the (J, O) gain table. x (R, D), y (O, D), lam and cur (I, R),
// H (I, J) with off-path entries already mapped to a finite sentinel;
// J <= 8. ystream != 0 (from the wrapper's plan) streams the candidate
// tile beside the requests, for rows too wide to keep it resident;
// vec16 != 0 selects the 16-byte staging path.
extern "C" int simcache_gains(const float* x, const float* y,
                              const float* lam, const float* cur,
                              const float* H, int R, int O, int D, int I,
                              int J, int metric, float gamma, float* out,
                              int ystream, int vec16, void* stream) {
  const simcache::Gains p{x, y, lam, cur, H, R, O, D, I, J, gamma, vec16,
                          out};
  return simcache::launch<false>(p, metric, ystream, stream);
}

// Kernel D: the (J, O) gain table. x (R, D), y (O, D), lam and cur (R,),
// H (R, J) with off-path entries already mapped to a finite sentinel;
// J <= 8. The plan arguments are kernel C's.
extern "C" int simcache_greedy_gain(const float* x, const float* y,
                                    const float* lam, const float* cur,
                                    const float* H, int R, int O, int D,
                                    int J, int metric, float gamma,
                                    float* out, int ystream, int vec16,
                                    void* stream) {
  const simcache::Gains p{x, y, lam, cur, H, R, O, D, 1, J, gamma, vec16,
                          out};
  return simcache::launch<true>(p, metric, ystream, stream);
}
