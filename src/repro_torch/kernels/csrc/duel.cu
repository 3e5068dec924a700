// The NETDUEL duel scan between promotions, for Hopper (sm_90a): kernel F.
//
// It replaces `_duel_scan` of src/repro/core/placement/netduel.py, an XLA
// lax.scan over the request window (the reference has no Pallas kernel
// for it). One thread block walks the steps t_begin, t_begin + 1, ... in
// order. The duel carry (slots, virt, real and virtual savings,
// deadlines, the promotion count) lives in device memory; a thread owns
// a run of consecutive slots (one slot a thread at the engine's K = 448)
// and is the only one to touch their carry. Per step:
//
// * the request's served cost b1 (the fused lookup's, b1_ext, or
//   best1[i, o]), arg1 and best2 from the current serving tables;
// * real saving: the owner of slot max(a1, 0) adds best2 - b1 there, or
//   0.0 on a repository hit or a masked step, as the reference's scatter
//   does;
// * virtual saving: each armed slot's C_a(x_o, y_virt), the gather
//   ca[o, virt] or, streamed, one ascending-d chain in the IEEE
//   operations of the shape-stable form (core/costs.py:
//   diff = x - y, |diff| or diff * diff, acc + term, sqrt for l2, each
//   rounded on its own: no FMA contraction), d^gamma as torch's pow
//   computes it, plus h_slots[i, k]; vs += max(b1 - vcost, 0) where the
//   step is valid and the slot armed;
// * settle: expired = valid & armed & deadline <= t, promote = expired
//   & vs > f32(one_delta * rs) & vs > 0;
// * arm: a block-wide count and exclusive scan of the free slots
//   (unarmed after the clear, on the path of i) in ascending slot order,
//   m = min(int(f32(u) * f32(n_free)), n_free - 1), the m-th free slot.
// A step that promotes does its whole settle (the slot writes, the
// clears, the arm), writes its event (each slot's promote flag, virt,
// rs and vs before the clear), and the kernel returns that step's index:
// the host re-arms the serving tables and launches again from the next
// step. So nothing of step t + 1 runs before the re-arm, and the re-arm
// reads nothing (slots, pre-fold tables) that step t's clear or arm
// writes: the reference's order. A window without a promotion is one
// launch.
//
// What bounds it: the chain of dependent steps. Each step needs the
// block-wide scan (two barriers) and, streamed, one dependent chain of D
// rounded adds per armed slot; the K*D products and K*D*4 bytes of rows
// a step reads when streamed are small next to that chain's latency on
// one SM. The bound the card's rates give (chip_smoke.py reckons it
// from a run's data) is far below what the chain allows. Faster designs
// (the virtual rows kept in shared memory, fewer barriers a step, a
// persistent block that also re-arms) are later work.
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

#include "distance.cuh"

namespace simcache {
namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

struct DuelArgs {
  const float* coords;            // (O, D) f32, the streamed C_a's rows
  const float* ca;                // (O, O) f32 materialized C_a, or null
  int O, D, metric;
  float gamma;
  const float* best1;             // (I, O) serving tables
  const long long* arg1;
  const float* best2;
  const float* h_slots;           // (I, K), +inf off the path
  int K;
  long long* slots;               // the carry, (K,) each
  long long* virt;
  float* rs;
  float* vs;
  long long* deadline;
  long long* n_prom;              // (1,)
  const long long* objs;          // the window, (T,) each
  const long long* ings;
  const long long* ts;
  const unsigned char* armf;
  const float* slotu;
  const float* b1_ext;            // or null: read best1
  const unsigned char* valid;     // or null: every step valid
  int t_begin, T;
  float one_delta;
  long long window;
  float* out;                     // (T,) served cost per step
  unsigned char* ev_promote;      // (K,) the promoting step's event
  long long* ev_virt;
  float* ev_rs;
  float* ev_vs;
  int* stop;                      // the promoting step, or T
};

// d^gamma as torch's CUDA pow computes it for a scalar exponent: the
// exponents it special-cases (0.5 sqrt, 2 and 3 products), else powf.
__device__ __forceinline__ float torch_pow(float d, float gamma) {
  if (gamma == 0.5f) return __fsqrt_rn(d);
  if (gamma == 2.0f) return __fmul_rn(d, d);
  if (gamma == 3.0f) return __fmul_rn(__fmul_rn(d, d), d);
  return powf(d, gamma);
}

// C_a(x, y) in the shape-stable form: one ascending-d chain, every
// operation rounded on its own.
template <int METRIC>
__device__ float stable_ca(const float* __restrict__ x,
                           const float* __restrict__ y, int D, float gamma) {
  float acc = 0.0f;
  for (int d = 0; d < D; ++d) {
    const float diff = __fsub_rn(x[d], y[d]);
    acc = __fadd_rn(acc, METRIC == kMetricL1 ? fabsf(diff)
                                             : __fmul_rn(diff, diff));
  }
  if (METRIC == kMetricL2) acc = __fsqrt_rn(acc);
  return gamma == 1.0f ? acc : torch_pow(fmaxf(acc, 0.0f), gamma);
}

// Block-wide: the exclusive prefix of x in thread order, the total of x
// and the total of y. Two barriers; the warp totals alternate between
// two buffers by step parity, so a warp that runs ahead into the next
// step never overwrites totals another warp has still to read.
__device__ __forceinline__ void block_scan2(int x, int y, int parity,
                                            int (*sx)[kMaxWarps],
                                            int (*sy)[kMaxWarps],
                                            int* x_before, int* x_total,
                                            int* y_total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  int xi = x, yi = y;
  for (int d = 1; d < 32; d <<= 1) {
    const int tx = __shfl_up_sync(kFull, xi, d);
    const int ty = __shfl_up_sync(kFull, yi, d);
    if (lane >= d) {
      xi += tx;
      yi += ty;
    }
  }
  if (lane == 31) {
    sx[parity][warp] = xi;
    sy[parity][warp] = yi;
  }
  __syncthreads();
  if (warp == 0) {
    int wx = lane < n_warps ? sx[parity][lane] : 0;
    int wy = lane < n_warps ? sy[parity][lane] : 0;
    for (int d = 1; d < 32; d <<= 1) {
      const int tx = __shfl_up_sync(kFull, wx, d);
      const int ty = __shfl_up_sync(kFull, wy, d);
      if (lane >= d) {
        wx += tx;
        wy += ty;
      }
    }
    if (lane < n_warps) {
      sx[parity][lane] = wx;
      sy[parity][lane] = wy;
    }
  }
  __syncthreads();
  *x_before = (warp > 0 ? sx[parity][warp - 1] : 0) + xi - x;
  *x_total = sx[parity][n_warps - 1];
  *y_total = sy[parity][n_warps - 1];
}

template <bool HAS_CA, int METRIC>
__global__ void __launch_bounds__(kMaxThreads)
duel_scan_kernel(const DuelArgs a) {
  __shared__ int sx[2][kMaxWarps], sy[2][kMaxWarps];
  const int per = (a.K + blockDim.x - 1) / blockDim.x;
  const int k0 = min(a.K, static_cast<int>(threadIdx.x) * per);
  const int k1 = min(a.K, k0 + per);
  for (int s = a.t_begin; s < a.T; ++s) {
    const bool valid = a.valid == nullptr || a.valid[s] != 0;
    const long long o = a.objs[s], i = a.ings[s], t = a.ts[s];
    const long long io = i * a.O + o;
    const float b1 = a.b1_ext != nullptr ? a.b1_ext[s] : a.best1[io];
    const long long a1 = a.arg1[io];
    const float* hrow = a.h_slots + i * a.K;

    // real saving, at slot max(a1, 0), by its owner
    const long long ya = a1 > 0 ? a1 : 0;
    if (ya >= k0 && ya < k1) {
      const float add = valid && a1 >= 0 ? __fsub_rn(a.best2[io], b1) : 0.0f;
      a.rs[ya] = __fadd_rn(a.rs[ya], add);
    }

    // virtual savings; count the promotions and the free slots
    int n_promote = 0, n_free = 0;
    for (int k = k0; k < k1; ++k) {
      const long long v = a.virt[k];
      const bool armed = v >= 0;
      float vsk = a.vs[k];
      if (valid && armed) {
        const float cac = HAS_CA
            ? a.ca[o * a.O + v]
            : stable_ca<METRIC>(a.coords + o * a.D, a.coords + v * a.D, a.D,
                                a.gamma);
        const float vcost = __fadd_rn(cac, hrow[k]);
        vsk = __fadd_rn(vsk, fmaxf(__fsub_rn(b1, vcost), 0.0f));
        a.vs[k] = vsk;
      }
      const bool expired = valid && armed && a.deadline[k] <= t;
      n_promote += expired && vsk > __fmul_rn(a.one_delta, a.rs[k]) &&
                   vsk > 0.0f;
      n_free += (expired || !armed) && isfinite(hrow[k]);
    }
    int free_before, free_total, promote_total;
    block_scan2(n_free, n_promote, s & 1, sx, sy, &free_before, &free_total,
                &promote_total);

    // settle and arm
    const bool any_p = promote_total > 0;
    const bool arm = valid && a.armf[s] != 0 && free_total > 0;
    const int m = arm ? min(static_cast<int>(__fmul_rn(
                                a.slotu[s], static_cast<float>(free_total))),
                            free_total - 1)
                      : -1;
    int rank = free_before;
    for (int k = k0; k < k1; ++k) {
      long long v = a.virt[k];
      float rsk = a.rs[k], vsk = a.vs[k];
      const bool armed = v >= 0;
      const bool expired = valid && armed && a.deadline[k] <= t;
      const bool promote = expired && vsk > __fmul_rn(a.one_delta, rsk) &&
                           vsk > 0.0f;
      if (any_p) {
        a.ev_promote[k] = promote;
        a.ev_virt[k] = v;
        a.ev_rs[k] = rsk;
        a.ev_vs[k] = vsk;
      }
      if (promote) a.slots[k] = v;
      if (expired) {
        v = -1;
        rsk = 0.0f;
        vsk = 0.0f;
      }
      if (v < 0 && isfinite(hrow[k])) {
        if (rank == m) {
          v = o;
          a.deadline[k] = t + a.window;
          rsk = 0.0f;
          vsk = 0.0f;
        }
        ++rank;
      }
      a.virt[k] = v;
      a.rs[k] = rsk;
      a.vs[k] = vsk;
    }
    if (threadIdx.x == 0) {
      a.out[s] = valid ? b1 : 0.0f;
      if (any_p) {
        *a.n_prom += promote_total;
        *a.stop = s;
      }
    }
    if (any_p) return;
  }
  if (threadIdx.x == 0) *a.stop = a.T;
}

template <bool HAS_CA, int METRIC>
cudaError_t launch_metric(const DuelArgs& a, int threads, cudaStream_t st) {
  duel_scan_kernel<HAS_CA, METRIC><<<1, threads, 0, st>>>(a);
  return cudaGetLastError();
}

}  // namespace
}  // namespace simcache

// Kernel F: the NETDUEL steps [t_begin, T) up to and including the first
// that promotes (its index, or T, goes to *stop). Tensors as
// kernels/duel/duel.py documents them; ca, b1_ext and valid may be null.
extern "C" int simcache_duel_scan(
    const float* coords, const float* ca, int O, int D, int metric,
    float gamma, const float* best1, const long long* arg1,
    const float* best2, const float* h_slots, int K, long long* slots,
    long long* virt, float* rs, float* vs, long long* deadline,
    long long* n_prom, const long long* objs, const long long* ings,
    const long long* ts, const unsigned char* armf, const float* slotu,
    const float* b1_ext, const unsigned char* valid, int t_begin, int T,
    float one_delta, long long window, float* out,
    unsigned char* ev_promote, long long* ev_virt, float* ev_rs,
    float* ev_vs, int* stop, void* stream) {
  using namespace simcache;
  const DuelArgs a{coords, ca,    O,       D,        metric, gamma,
                   best1,  arg1,  best2,   h_slots,  K,      slots,
                   virt,   rs,    vs,      deadline, n_prom, objs,
                   ings,   ts,    armf,    slotu,    b1_ext, valid,
                   t_begin, T,    one_delta, window, out,    ev_promote,
                   ev_virt, ev_rs, ev_vs,  stop};
  const int threads =
      K >= kMaxThreads ? kMaxThreads : ((K > 32 ? K : 32) + 31) / 32 * 32;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ca != nullptr) return launch_metric<true, kMetricL1>(a, threads, st);
  switch (metric) {
    case kMetricL1:
      return launch_metric<false, kMetricL1>(a, threads, st);
    case kMetricL2:
      return launch_metric<false, kMetricL2>(a, threads, st);
    case kMetricL2Sq:
      return launch_metric<false, kMetricL2Sq>(a, threads, st);
    default:
      return cudaErrorInvalidValue;
  }
}
