// Flash-attention forward for Hopper (sm_90a): kernel E.
//
//   o[b, s, h, :] = softmax_t(q[b, s, h, :] . k[b, t, h / G, :] * scale) v[b, t, h / G, :]
//
// with G = H / KH query heads per KV head, keys at t >= kv_len and (when
// causal) t > s masked at -1e30, and o divided by max(l, 1e-30).
//
// Replaces the Pallas TPU kernel `_flash_kernel` of
// src/repro/kernels/flash_attention/flash.py, whose grid walked KV tiles
// along a sequential minor axis and kept the online-softmax state (m, l,
// o) in its output blocks. Here one thread block owns one (batch * head,
// query tile) pair and walks the KV tiles itself, in order, keeping m and
// l in shared memory and o in registers, all in f32. Inputs are f32 or
// bf16, converted to f32 as they are staged; the output is rounded once
// to the input type (__float2bfloat16_rn for bf16). The kernel reads the
// strided (B, S, H, Dh) layout directly (unit stride on Dh), masks the
// ragged edges itself, and skips causal KV tiles wholly above the
// diagonal: key 0 is unmasked for every row, so a skipped tile would add
// exp(-1e30 - m) = 0 exactly.
//
// What bounds it: the two products, 4 * Sq * Skv * Dh flops per head
// (half that when causal), against (Sq + 2 * Skv) * Dh elements read per
// head: far above the card's ops-per-byte line, so operations. This
// simple kernel runs them in f32 on the CUDA cores (a 67 TFLOP/s peak,
// not the tensor cores' 989 in bf16): each thread computes a 4 x 4 tile
// of the score block (four shared loads feed sixteen fused multiply-adds)
// and a 4 x (Dh / 16) tile of the output, with padded shared strides so
// a warp's loads hit distinct banks. expf (not __expf) keeps the softmax
// within a few f32 ulps of the plain version. Tensor cores (wgmma) and
// TMA staging are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace simcache {
namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;                   // query rows per block
constexpr int kBK = 64;                   // keys per tile
constexpr float kNeg = -1.0e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

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

}  // namespace
}  // namespace simcache

// Kernel E: o (B, Sq, H, Dh) from q (B, Sq, H, Dh) and k, v (B, Skv, KH,
// Dh), all of one type (dtype 0: f32, 1: bf16). The strides are in
// elements, three per tensor (batch, sequence, head) in the order q, k,
// v, o; the head axis has unit stride. Dh is 16, 32, 64 or 128.
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
    return dispatch_dh<__nv_bfloat16>(Dh, q, k, v, o, B, Sq, Skv, H, KH, st,
                                      scale, causal, kv_len, s);
  return -1;
}
