// Flash-attention forward for Hopper (sm_90a): kernel E.
//
//   o[b, s, h, :] = softmax_t(q[b, s, h, :] . k[b, t, h / G, :] * scale) v[b, t, h / G, :]
//
// with G = H / KH query heads per KV head, keys at t >= kv_len and (when
// causal) t > s masked at -1e30, and o divided by max(l, 1e-30), rounded
// once to the input type.
//
// Replaces the Pallas TPU kernel `_flash_kernel` of
// src/repro/kernels/flash_attention/flash.py, whose grid walked KV tiles
// along a sequential minor axis and kept the online-softmax state (m, l,
// o) in its output blocks. Here one thread block owns one query tile of
// one (batch, head) and walks the KV tiles itself, in order, keeping the
// state on chip in f32. Both kernels read the strided (B, S, H, Dh) layout
// directly (unit stride on Dh), mask the ragged edges themselves, and skip
// causal KV tiles wholly above the diagonal: key 0 is unmasked for every
// row, so a skipped tile would add exp(-1e30 - m) = 0 exactly.
//
// What bounds it: the two products, 4 * Sq * Skv * Dh flops per head
// (half that when causal), against (Sq + 2 * Skv) * Dh elements read per
// head: far above the card's ops-per-byte line, so operations; at Dh 64
// the Sq * Skv / 2 exponentials (16 per clock per SM) come close behind.
//
// Two kernels, chosen by the input type:
// - bf16 (tc::flash_tc_kernel, below): both products on the tensor cores
//   (wgmma, bf16 in, f32 sums), K and V staged by TMA, the softmax in
//   registers. Its one new rounding is p to bf16 before the PV product.
// - f32 (flash_fwd_kernel): the tensor cores would run f32 as TF32, which
//   the port forbids, so f32 runs on the CUDA cores in IEEE f32. Each
//   thread computes a 4 x 4 tile of the score block (four shared loads
//   feed sixteen fused multiply-adds) and a 4 x (Dh / 16) tile of the
//   output, with padded shared strides so a warp's loads hit distinct
//   banks; expf (not __expf) keeps the softmax within a few f32 ulps of
//   the plain version.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <initializer_list>

namespace simcache {
namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;                   // query rows per block
constexpr int kBK = 64;                   // keys per tile
constexpr float kNeg = -1.0e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }

template <int DH>
constexpr int smem_floats() {
  return kBQ * (DH + 1) + kBK * (DH + 1) + kBK * DH + kBQ * (kBK + 1) +
         3 * kBQ;
}

// Stage `rows` rows of one head (row stride `rs`, starting at row0) as f32
// into dst with row pitch `pitch`; rows at or past n are zero.
template <typename T, int DH>
__device__ __forceinline__ void stage(float* dst, int pitch, const T* src,
                                      long long rs, int row0, int n,
                                      int rows) {
  for (int e = threadIdx.x; e < rows * DH; e += kThreads) {
    const int r = e / DH, d = e % DH;
    const int row = row0 + r;
    dst[r * pitch + d] = row < n ? to_f32(src[(long long)row * rs + d]) : 0.0f;
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int Sq, int Skv,
                 int H, int KH, long long q_sb, long long q_ss, long long q_sh,
                 long long k_sb, long long k_ss, long long k_sh,
                 long long v_sb, long long v_ss, long long v_sh,
                 long long o_sb, long long o_ss, long long o_sh, float scale,
                 int causal, int kv_len) {
  constexpr int kC = DH / 16;             // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                       // kBQ x (DH + 1)
  float* Ks = Qs + kBQ * (DH + 1);        // kBK x (DH + 1)
  float* Vs = Ks + kBK * (DH + 1);        // kBK x DH
  float* Ps = Vs + kBK * DH;              // kBQ x (kBK + 1): scores, then p
  float* m_s = Ps + kBQ * (kBK + 1);      // running max per row
  float* l_s = m_s + kBQ;                 // running normalizer per row
  float* c_s = l_s + kBQ;                 // this tile's correction per row

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;  // rows ty*4+i, cols tx+16*j
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KH);
  const int q0 = blockIdx.y * kBQ;

  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + kvh * k_sh;
  const T* vb = v + b * v_sb + kvh * v_sh;

  stage<T, DH>(Qs, DH + 1, qb, q_ss, q0, Sq, kBQ);
  if (tid < kBQ) {
    m_s[tid] = kNeg;
    l_s[tid] = 0.0f;
  }

  float acc_o[4][kC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kC; ++c) acc_o[i][c] = 0.0f;

  const int n_valid = min(kv_len, Skv);
  int n_tiles = (n_valid + kBK - 1) / kBK;
  if (causal) n_tiles = min(n_tiles, (q0 + kBQ - 1) / kBK + 1);

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();                      // previous tile fully consumed
    stage<T, DH>(Ks, DH + 1, kb, k_ss, k0, Skv, kBK);
    stage<T, DH>(Vs, DH, vb, v_ss, k0, Skv, kBK);
    __syncthreads();

    // scores: a 4 x 4 tile per thread, scaled after the dot product as
    // the reference does, masked at -1e30
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      float a[4], bk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(ty * 4 + i) * (DH + 1) + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) bk[j] = Ks[(tx + 16 * j) * (DH + 1) + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx + 16 * j;
        const bool keep = kj < kv_len && (!causal || kj <= qi);
        Ps[(ty * 4 + i) * (kBK + 1) + tx + 16 * j] =
            keep ? s[i][j] * scale : kNeg;
      }
    }
    __syncthreads();

    // online softmax: four threads per row, 16 columns each
    {
      const int r = tid / 4, part = tid % 4;
      float* prow = Ps + r * (kBK + 1) + part * 16;
      const float m_prev = m_s[r];
      float mx = kNeg;
#pragma unroll
      for (int c = 0; c < 16; ++c) mx = fmaxf(mx, prow[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.0f;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const float p = expf(prow[c] - m_new);
        prow[c] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) {
        const float corr = expf(m_prev - m_new);
        m_s[r] = m_new;
        l_s[r] = l_s[r] * corr + sum;
        c_s[r] = corr;
      }
    }
    __syncthreads();

    // o = o * corr + p v
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float corr = c_s[ty * 4 + i];
#pragma unroll
      for (int c = 0; c < kC; ++c) acc_o[i][c] *= corr;
    }
#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(ty * 4 + i) * (kBK + 1) + kk];
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        const float vv = Vs[kk * DH + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc_o[i][c] = fmaf(p[i], vv, acc_o[i][c]);
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = ty * 4 + i;
    const int qi = q0 + row;
    if (qi >= Sq) continue;
    const float l = fmaxf(l_s[row], 1e-30f);
    T* orow = o + b * o_sb + (long long)qi * o_ss + h * o_sh;
#pragma unroll
    for (int c = 0; c < kC; ++c) store_out(orow + tx + 16 * c, acc_o[i][c] / l);
  }
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Sq, int Skv, int H, int KH, const long long* st, float scale,
           int causal, int kv_len, cudaStream_t s) {
  const int bytes = smem_floats<DH>() * (int)sizeof(float);
  auto kern = flash_fwd_kernel<T, DH>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, (Sq + kBQ - 1) / kBQ);
  kern<<<grid, kThreads, bytes, s>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, Sq, Skv, H, KH, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10],
      st[11], scale, causal, kv_len);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The bf16 kernel: both products on the tensor cores.
//
// One block owns one (batch, query head, 128-row query tile); blocks are
// numbered with the query tile slowest and reversed, so the longest causal
// rows start first and the triangle's work is spread over the card. It runs
// 288 threads: two consumer warpgroups of 64 query rows each (the M of one
// wgmma) and one producer warp. The producer's first lane loads the Q tile
// once and then streams the K and V tiles (128 keys each) through a ring of
// kStages stages with TMA (cp.async.bulk.tensor on 4-d tensor maps of the
// strided (B, S, heads, Dh) views, encoded on the host), each tile
// completing on its own mbarrier; the consumers release a stage on an
// "empty" mbarrier once their PV product has read it. Rows past S, and
// keys past Skv, are zero-filled by TMA and masked.
//
// Per KV tile a consumer warpgroup computes S = Q K^T with one wgmma chain
// (m64 n128 k16, both operands K-major in shared memory, f32 sums), scales
// it by scale * log2(e) after the dot product, masks only on tiles that
// cross kv_len or the diagonal, and runs the online softmax in registers:
// each row lives in four lanes, so its max and sum take two shuffles, and
// p = ex2.approx(t - m) (hardware base-2 exponential, about 2 ulp). l sums
// the f32 p; p is then rounded once to bf16, in registers, and O (f32,
// registers, rescaled by ex2(m_prev - m_new) first) += P V as a wgmma chain
// with A = P from registers and B = the V tile through the transposed-B
// (MN-major) descriptor. The epilogue divides by max(l, 1e-30), rounds once
// to bf16 and stores rows below Sq straight into the strided output.
//
// Shared memory is Q plus kStages x (K + V), each 128 x Dh bf16, laid out
// as TMA writes it with the swizzle the wgmma descriptors name: rows of
// min(Dh, 64) columns (32, 64 or 128 bytes, swizzled by 32, 64 or 128 B),
// Dh 128 split into two 64-column halves. Per Dh: 16 -> 20 KB, 32 -> 40 KB,
// 64 -> 80 KB, 128 -> 160 KB (plus 1 KB of alignment and the barriers).
namespace tc {

constexpr int kBM = 128;                  // query rows per block
constexpr int kBN = 128;                  // keys per KV tile
constexpr int kStages = 2;                // K/V ring depth
constexpr int kConsumers = 256;           // two warpgroups
constexpr int kThreads = kConsumers + 32; // and the producer warp
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kBM == kBN, "a Q tile and a K/V tile share one layout");

template <int DH>
struct Geo {
  static constexpr int kCols = DH < 64 ? DH : 64;    // columns per half
  static constexpr int kPitch = kCols * 2;           // bytes per row = swizzle
  static constexpr int kLayout =                     // wgmma layout type
      kPitch == 128 ? 1 : (kPitch == 64 ? 2 : 3);
  static constexpr int kHalf = kBN * kPitch;         // one half of a tile
  static constexpr int kTile = kBN * DH * 2;         // one Q, K or V tile
  static constexpr int kBarriers = (1 + 3 * kStages) * 8;
  static constexpr int kSmem = (1 + 2 * kStages) * kTile + kBarriers + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile(
      "{\n.reg .b64 state;\n"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(bar)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// one box of a 4-d tensor map (coordinates innermost first) into shared
// memory, completing on the barrier
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving reads of an accumulator above the wait
// that completes it
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (all >> 4) and the swizzle layout type
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint32_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) |
         (static_cast<uint64_t>(layout) << 62);
}

// a K-major operand (Q or K: rows, then Dh contiguous): 8-row groups
// kPitch * 8 bytes apart; the leading offset is unused under a swizzle
template <int DH>
__device__ __forceinline__ uint64_t desc_k_major(uint32_t addr) {
  using G = Geo<DH>;
  return make_desc(addr, 16, 8 * G::kPitch, G::kLayout);
}

// the MN-major V operand (keys, then Dh contiguous): 8-key groups kPitch * 8
// bytes apart, 64-column halves of Dh kHalf bytes apart
template <int DH>
__device__ __forceinline__ uint64_t desc_mn_major(uint32_t addr) {
  using G = Geo<DH>;
  return make_desc(addr, G::kHalf, 8 * G::kPitch, G::kLayout);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d (64 x 128, f32) (+)= A (64 x 16) * B (16 x 128), bf16, A and B
// K-major in shared memory; d is overwritten when scale_d is 0
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 16, f32) (+)= A (64 x 16, bf16 in registers) * B (16 x 16),
// B MN-major in shared memory (the transposed-B form)
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// d (64 x 32, f32) (+)= A (64 x 16, bf16 in registers) * B (16 x 32),
// B MN-major in shared memory (the transposed-B form)
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// d (64 x 64, f32) (+)= A (64 x 16, bf16 in registers) * B (16 x 64),
// B MN-major in shared memory (the transposed-B form)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// d (64 x 128, f32) (+)= A (64 x 16, bf16 in registers) * B (16 x 128),
// B MN-major in shared memory (the transposed-B form)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <int DH>
__device__ __forceinline__ void wgmma_pv(float (&d)[DH / 2],
                                         const uint32_t (&a)[4], uint64_t db) {
  if constexpr (DH == 16) wgmma_rs_n16(d, a, db, 1);
  if constexpr (DH == 32) wgmma_rs_n32(d, a, db, 1);
  if constexpr (DH == 64) wgmma_rs_n64(d, a, db, 1);
  if constexpr (DH == 128) wgmma_rs_n128(d, a, db, 1);
}

template <int DH>
__global__ void __launch_bounds__(kThreads, 1)
flash_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v,
                __nv_bfloat16* __restrict__ o, int Sq, int Skv, int H, int KH,
                int BH, int n_qt, long long o_sb, long long o_ss,
                long long o_sh, float scale_log2, int causal, int kv_len) {
  using G = Geo<DH>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t s_q = (smem_u32(smem_raw) + 1023) & ~1023u;  // swizzle unit
  const uint32_t s_kv = s_q + G::kTile;   // stage st: K, then V
  const uint32_t bars = s_q + (1 + 2 * kStages) * G::kTile;
  const uint32_t q_full = bars;
  auto k_full = [&](int st) { return bars + 8 * (1 + st); };
  auto v_full = [&](int st) { return bars + 8 * (1 + kStages + st); };
  auto empty = [&](int st) { return bars + 8 * (1 + 2 * kStages + st); };

  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x) / BH;
  const int bh = static_cast<int>(blockIdx.x) % BH;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KH);
  const int q0 = qt * kBM;
  int n_tiles = (min(kv_len, Skv) + kBN - 1) / kBN;
  if (causal) n_tiles = min(n_tiles, (q0 + kBM - 1) / kBN + 1);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(k_full(st), 1);
      mbar_init(v_full(st), 1);
      mbar_init(empty(st), kConsumers / 32);   // one arrival per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {        // the producer warp
    if (threadIdx.x == kConsumers) {
      mbar_expect_tx(q_full, G::kTile);
      for (int c = 0; c < DH / G::kCols; ++c)
        tma_load(s_q + c * G::kHalf, &tm_q, q_full, c * G::kCols, q0, h, b);
      for (int kt = 0; kt < n_tiles; ++kt) {
        const int st = kt % kStages;
        const uint32_t k_s = s_kv + 2 * st * G::kTile, v_s = k_s + G::kTile;
        mbar_wait(empty(st), ((kt / kStages) & 1) ^ 1);
        mbar_expect_tx(k_full(st), G::kTile);
        for (int c = 0; c < DH / G::kCols; ++c)
          tma_load(k_s + c * G::kHalf, &tm_k, k_full(st), c * G::kCols,
                   kt * kBN, kvh, b);
        mbar_expect_tx(v_full(st), G::kTile);
        for (int c = 0; c < DH / G::kCols; ++c)
          tma_load(v_s + c * G::kHalf, &tm_v, v_full(st), c * G::kCols,
                   kt * kBN, kvh, b);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows q0 + 64 wg ..; a lane holds rows r0
  // and r0 + 8 and, in each 8-column group j, columns 8 j + cl, + 1
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int r0 = q0 + wg * 64 + warp * 16 + lane / 4;
  const int cl = 2 * (lane % 4);
  const int wg_row0 = q0 + wg * 64;
  const uint32_t q_wg = s_q + wg * 64 * G::kPitch;

  float acc[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) acc[i] = 0.0f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.0f, 0.0f};
  mbar_wait(q_full, 0);
  __syncwarp();

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int st = kt % kStages;
    const uint32_t ph = (kt / kStages) & 1;
    const uint32_t k_s = s_kv + 2 * st * G::kTile, v_s = k_s + G::kTile;
    const int k0 = kt * kBN;

    float s[64];                          // this warpgroup's 64 x 128 scores
    mbar_wait(k_full(st), ph);
    __syncwarp();
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < DH / 16; ++ks) {
      const uint32_t off = (ks / (G::kCols / 16)) * G::kHalf +
                           (ks % (G::kCols / 16)) * 32;
      wgmma_ss_n128(s, desc_k_major<DH>(q_wg + off),
                    desc_k_major<DH>(k_s + off), ks);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // scale (log2 units), mask on edge tiles, row max over the 4 lanes
    const bool edge = k0 + kBN > kv_len || (causal && k0 + kBN - 1 > wg_row0);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      float t = s[i] * scale_log2;
      if (edge) {
        const int col = k0 + 8 * (i / 4) + cl + (i & 1);
        const int row = r0 + 8 * ((i >> 1) & 1);
        if (col >= kv_len || (causal && col > row)) t = kNeg;
      }
      s[i] = t;
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], t);
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      corr[r] = ex2(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= corr[r];
    }
    // p in f32 for l, in bf16 (as wgmma A fragments) for P V: the score
    // fragment of keys 16 kk .. 16 kk + 15 is the A fragment of k-step kk
    uint32_t pa[8][4];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float p0 = ex2(s[4 * j] - m[0]), p1 = ex2(s[4 * j + 1] - m[0]);
      const float p2 = ex2(s[4 * j + 2] - m[1]), p3 = ex2(s[4 * j + 3] - m[1]);
      l[0] += p0 + p1;
      l[1] += p2 + p3;
      pa[j / 2][2 * (j & 1)] = pack_bf16(p0, p1);
      pa[j / 2][2 * (j & 1) + 1] = pack_bf16(p2, p3);
    }
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) acc[i] *= corr[(i >> 1) & 1];

    mbar_wait(v_full(st), ph);
    __syncwarp();
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk)
      wgmma_pv<DH>(acc, pa[kk], desc_mn_major<DH>(v_s + kk * 16 * G::kPitch));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    if (lane == 0) mbar_arrive(empty(st));
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = fmaxf(l[r], 1e-30f);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    if (row >= Sq) continue;
    __nv_bfloat16* orow = o + b * o_sb + row * o_ss + h * o_sh + cl;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j + 2 * r] / l[r],
                                acc[4 * j + 2 * r + 1] / l[r]);
  }
}

// cuTensorMapEncodeTiled, looked up through the runtime's entry-point
// query (so the library needs no -lcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// the tensor map of a strided (B, S, heads, DH) bf16 view, dimensions
// innermost first; one box is kBN rows of one head by one half of DH
template <int DH>
bool encode_map(CUtensorMap* map, const void* ptr, int B, int S, int heads,
                long long sb, long long ss, long long sh) {
  using G = Geo<DH>;
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)DH, (cuuint64_t)S,
                              (cuuint64_t)heads, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)ss * 2, (cuuint64_t)sh * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {(cuuint32_t)G::kCols, (cuuint32_t)kBN, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle sw =
      G::kPitch == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                       : (G::kPitch == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                          : CU_TENSOR_MAP_SWIZZLE_32B);
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

constexpr int kErrTensorMap = -2;         // TMA refused a view

template <int DH>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Sq, int Skv, int H, int KH, const long long* st, float scale,
           int causal, int kv_len, cudaStream_t s) {
  using G = Geo<DH>;
  for (const void* p : {q, k, v})
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return kErrTensorMap;
  for (int i = 0; i < 9; ++i)
    if (st[i] % 8 != 0) return kErrTensorMap;   // 16-byte strides
  CUtensorMap mq, mk, mv;
  if (!encode_map<DH>(&mq, q, B, Sq, H, st[0], st[1], st[2]) ||
      !encode_map<DH>(&mk, k, B, Skv, KH, st[3], st[4], st[5]) ||
      !encode_map<DH>(&mv, v, B, Skv, KH, st[6], st[7], st[8]))
    return kErrTensorMap;
  auto kern = flash_tc_kernel<DH>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, G::kSmem);
  if (err != cudaSuccess) return (int)err;
  const int n_qt = (Sq + kBM - 1) / kBM;
  kern<<<n_qt * B * H, kThreads, G::kSmem, s>>>(
      mq, mk, mv, (__nv_bfloat16*)o, Sq, Skv, H, KH, B * H, n_qt, st[9],
      st[10], st[11], scale * kLog2e, causal, kv_len);
  return (int)cudaGetLastError();
}

}  // namespace tc

template <typename T>
int dispatch_dh(int Dh, const void* q, const void* k, const void* v, void* o,
                int B, int Sq, int Skv, int H, int KH, const long long* st,
                float scale, int causal, int kv_len, cudaStream_t s) {
  switch (Dh) {
    case 16:
      return launch<T, 16>(q, k, v, o, B, Sq, Skv, H, KH, st, scale, causal,
                           kv_len, s);
    case 32:
      return launch<T, 32>(q, k, v, o, B, Sq, Skv, H, KH, st, scale, causal,
                           kv_len, s);
    case 64:
      return launch<T, 64>(q, k, v, o, B, Sq, Skv, H, KH, st, scale, causal,
                           kv_len, s);
    case 128:
      return launch<T, 128>(q, k, v, o, B, Sq, Skv, H, KH, st, scale, causal,
                            kv_len, s);
    default:
      return -1;
  }
}

int dispatch_tc(int Dh, const void* q, const void* k, const void* v, void* o,
                int B, int Sq, int Skv, int H, int KH, const long long* st,
                float scale, int causal, int kv_len, cudaStream_t s) {
  switch (Dh) {
    case 16:
      return tc::launch<16>(q, k, v, o, B, Sq, Skv, H, KH, st, scale, causal,
                            kv_len, s);
    case 32:
      return tc::launch<32>(q, k, v, o, B, Sq, Skv, H, KH, st, scale, causal,
                            kv_len, s);
    case 64:
      return tc::launch<64>(q, k, v, o, B, Sq, Skv, H, KH, st, scale, causal,
                            kv_len, s);
    case 128:
      return tc::launch<128>(q, k, v, o, B, Sq, Skv, H, KH, st, scale,
                             causal, kv_len, s);
    default:
      return -1;
  }
}

}  // namespace
}  // namespace simcache

// Kernel E: o (B, Sq, H, Dh) from q (B, Sq, H, Dh) and k, v (B, Skv, KH,
// Dh), all of one type (dtype 0: f32 on the CUDA cores, 1: bf16 on the
// tensor cores). The strides are in elements, three per tensor (batch,
// sequence, head) in the order q, k, v, o; the Dh axis has unit stride.
// Dh is 16, 32, 64 or 128. For bf16, TMA reads q, k and v: their addresses
// and strides must be multiples of 16 bytes (-2 is returned otherwise, or
// when cuTensorMapEncodeTiled refuses a tensor map).
extern "C" int simcache_flash_fwd(
    const void* q, const void* k, const void* v, void* o, int dtype, int B,
    int Sq, int Skv, int H, int KH, int Dh, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, long long o_sb,
    long long o_ss, long long o_sh, float scale, int causal, int kv_len,
    void* stream) {
  using namespace simcache;
  if (B < 1 || Sq < 1 || Skv < 1 || KH < 1 || H % KH != 0 || kv_len < 1)
    return -1;
  const long long st[12] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                            v_sb, v_ss, v_sh, o_sb, o_ss, o_sh};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return dispatch_dh<float>(Dh, q, k, v, o, B, Sq, Skv, H, KH, st, scale,
                              causal, kv_len, s);
  if (dtype == 1)
    return dispatch_tc(Dh, q, k, v, o, B, Sq, Skv, H, KH, st, scale, causal,
                       kv_len, s);
  return -1;
}

// Dynamic shared memory of the bf16 kernel at head width Dh, in bytes (-1
// for a width it is not built for).
extern "C" int simcache_flash_tc_smem(int Dh) {
  using namespace simcache::tc;
  switch (Dh) {
    case 16:
      return Geo<16>::kSmem;
    case 32:
      return Geo<32>::kSmem;
    case 64:
      return Geo<64>::kSmem;
    case 128:
      return Geo<128>::kSmem;
    default:
      return -1;
  }
}
