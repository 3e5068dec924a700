// The NETDUEL duel scan between promotions and its re-arm, for Hopper
// (sm_90a): kernel F, two entries.
//
// It replaces `_duel_scan` of src/repro/core/placement/netduel.py, an XLA
// lax.scan over the request window (the reference has no Pallas kernel
// for it): the scan's step (`simcache_duel_scan`) and its `rearm`
// closure (`simcache_duel_rearm`, netduel.py:254).
//
// ---- The steps (`duel_scan_kernel`). One thread block walks the steps
// t_begin, t_begin + 1, ... in order. Per step:
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
// * arm: the free slots (unarmed after the clear, on the path of i)
//   counted in ascending slot order, m = min(int(f32(u) * f32(n_free)),
//   n_free - 1), the m-th free slot.
// A step that promotes does its whole settle (the slot writes, the
// clears, the arm), writes its event (each slot's promote flag, virt,
// rs and vs before the clear), and the launch returns that step's index.
// The re-arm entry then rebuilds the tables on the same stream, and the
// steps launch again from the next step. So nothing of step t + 1 runs
// before the re-arm, and the re-arm reads nothing (slots, promote flags,
// pre-fold tables) that step t's clear or arm writes: the reference's
// order. A window without a promotion is one launch.
//
// What bounds the steps is their chain: each step depends on the last,
// and an armed slot's pricing is one chain of D dependent rounded adds
// (D may not be split across threads: the sum order is the contract).
// The design keeps everything else off that chain:
//
// * The carry lives on chip for the whole launch: up to 992 slots each
//   thread holds its slot's (virt, deadline, rs, vs) in registers
//   (PER1); above, a thread holds a run of slots in shared memory (or,
//   where that does not fit, in device memory). It is read once at the
//   launch and written back once at its return.
// * The armed slots' virtual rows stay resident in shared memory (K rows
//   at a stride of 4 * odd floats, so a quarter-warp's float4 loads hit
//   eight distinct bank groups; 179,200 B at K 448, D 100), loaded with
//   cp.async at the launch. Arming copies the step's staged x_o row
//   within shared memory (the arming lane's warp copies it): the armed
//   object is the arming step's own. Where the rows and the ring do not
//   fit in the 227 KB a block may hold, the chain reads y_virt from
//   device memory.
// * The requests are prefetched: within a launch the serving tables do
//   not change (it returns at a promotion), so step s + kAhead's x_o row,
//   its best1 / arg1 / best2 entries and its window values are staged
//   with cp.async into a ring of kRing entries while step s computes.
//   The ring is filled anew at every launch, from t_begin (the note above
//   `fetch` says why kAhead <= kRing - 2 keeps an entry from being
//   overwritten while a thread still reads it). The whole h_slots table
//   is resident in shared memory where it fits beside the rows and a run
//   carry (I * K * 4 bytes: over 20 ingresses at K 448, D 100), else it
//   is read from device memory.
// * The slot warps only price and settle: a producer warp, the block's
//   last, stages the ring and writes the served costs (each one a step
//   late, from the ring) and the stop.
// * One barrier a step: the free and promote flags go through
//   __ballot_sync / __popc (a warp scan for runs) into per-warp totals,
//   double-buffered by step parity, behind a single __syncthreads; each
//   warp then scans the totals with shuffles to its prefix and the sums.
// * The materialized-C_a instantiation gathers ca[o, virt] at the step.
//
// The floor of this design is the chain: 100 dependent adds a step at
// D 100 (0.2 us at 4 clocks an add and 1,980 MHz). What holds it above
// that (PERF.md): every slot warp with an armed lane runs the whole
// chain, and its 50 float4 loads of a step take 200 shared-memory
// wavefronts (2,800 a step over the 14 slot warps of K 448), beside the
// staging, barrier and scan latency every step pays (the `duel` phase of
// chip_smoke.py times the window with arming off, which prices no duel).
//
// ---- The re-arm (`rearm_rows_kernel`, `rearm_dirty_kernel`). The
// pre-fold tables (b1, a1, b2, a2) after a settle wrote the promoted
// slots, and the serving tables folded from them, bitwise the full
// rebuild (`_best_two_rows_pre` then `fold_best_two`,
// core/objective.py) for any number of promoted slots. A row is dirty
// when its a1 or a2, at any ingress, is a promoted slot. The first pass,
// one thread an object row, stages the block's rows and the promoted
// slots' key rows in shared memory, computes each clean row's new
// columns once (shared over the ingresses) and inserts them in
// ascending slot order with the index tie rule of `best_two_delta`,
// the fold fused in; a dirty row is appended to a list. The second pass
// (a persistent grid that reads the list's length on the card: no host
// sync) rescans each dirty row over all K slots, one chain a slot, the
// slots' key rows staged in shared memory, and reduces to the two
// lexicographically least (cost, slot) pairs: torch.argmin's first
// minimum, with a2 = 0 where b2 = +inf, as argmin over a masked row of
// +inf gives. Bound: bytes, the tables read and written and the object
// rows read once (about 46 MB at I 1, O 10^5, D 100).
#include <climits>
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

#include "distance.cuh"

namespace simcache {
namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kRing = 8;    // staged steps in shared memory
constexpr int kAhead = 6;   // steps staged ahead; at most kRing - 2

struct DuelArgs {
  const float* coords;            // (O, D) f32, the streamed C_a's rows
  const float* ca;                // (O, O) f32 materialized C_a, or null
  int O, D, metric;
  float gamma;
  const float* best1;             // (I, O) serving tables
  const long long* arg1;
  const float* best2;
  const float* h_slots;           // (I, K), +inf off the path
  int I, K;
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

// One staged step of the ring.
struct Staged {
  long long o, i, t, a1;
  float b1, b2, u;
  int flags;                      // 1: valid, 2: the arming flag
};

// The steps' dynamic shared memory, in bytes from its base: the ring
// (steps, x_o rows), then the resident rows, a run carry and the h_slots
// table, each where it fits.
struct ScanPlan {
  int rs;          // row stride in floats: a multiple of 4, rs / 4 odd
  int x_off, rows_off, carry_off, h_off, ring_end, total;
  int x16;         // x_o rows staged in 16-byte copies (D % 4 == 0)
  int resident, carry_smem, h_tab;
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// d^gamma as torch's CUDA pow computes it for a scalar exponent: the
// exponents it special-cases (0.5 sqrt, 2 and 3 products), else powf.
__device__ __forceinline__ float torch_pow(float d, float gamma) {
  if (gamma == 0.5f) return __fsqrt_rn(d);
  if (gamma == 2.0f) return __fmul_rn(d, d);
  if (gamma == 3.0f) return __fmul_rn(__fmul_rn(d, d), d);
  return powf(d, gamma);
}

template <int METRIC>
__device__ __forceinline__ float chain_add(float acc, float x, float y) {
  const float diff = __fsub_rn(x, y);
  return __fadd_rn(acc, METRIC == kMetricL1 ? fabsf(diff)
                                            : __fmul_rn(diff, diff));
}

template <int METRIC>
__device__ __forceinline__ float chain_finish(float acc, float gamma) {
  if (METRIC == kMetricL2) acc = __fsqrt_rn(acc);
  return gamma == 1.0f ? acc : torch_pow(fmaxf(acc, 0.0f), gamma);
}

// C_a(x, y) in the shape-stable form: one ascending-d chain, every
// operation rounded on its own. Any address space, any alignment.
template <int METRIC>
__device__ float stable_ca(const float* x, const float* y, int D,
                           float gamma) {
  float acc = 0.0f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) acc = chain_add<METRIC>(acc, x[d], y[d]);
  return chain_finish<METRIC>(acc, gamma);
}

// The same chain over two 16-byte aligned rows in shared memory: the
// loads four floats at a time, the adds one by one in ascending d.
template <int METRIC>
__device__ float stable_ca_v4(const float* x, const float* y, int D,
                              float gamma) {
  const float4* x4 = reinterpret_cast<const float4*>(x);
  const float4* y4 = reinterpret_cast<const float4*>(y);
  const int n4 = D >> 2;
  float acc = 0.0f;
#pragma unroll 5
  for (int c = 0; c < n4; ++c) {
    const float4 xv = x4[c], yv = y4[c];
    acc = chain_add<METRIC>(acc, xv.x, yv.x);
    acc = chain_add<METRIC>(acc, xv.y, yv.y);
    acc = chain_add<METRIC>(acc, xv.z, yv.z);
    acc = chain_add<METRIC>(acc, xv.w, yv.w);
  }
  for (int d = n4 << 2; d < D; ++d) acc = chain_add<METRIC>(acc, x[d], y[d]);
  return chain_finish<METRIC>(acc, gamma);
}

template <bool HAS_CA, int METRIC, bool PER1>
__global__ void __launch_bounds__(kMaxThreads)
duel_scan_kernel(const DuelArgs a, const ScanPlan p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_free[2][kMaxWarps], s_prom[2][kMaxWarps];
  Staged* ring = reinterpret_cast<Staged*>(smem);
  float* ring_x = reinterpret_cast<float*>(smem + p.x_off);
  float* h_tab = reinterpret_cast<float*>(smem + p.h_off);
  float* rows = reinterpret_cast<float*>(smem + p.rows_off);

  // the fields every step reads, in registers
  const int K = a.K, D = a.D, T = a.T;
  const long long O = a.O;
  const float gamma = a.gamma, one_delta = a.one_delta;
  const float* __restrict__ coords = a.coords;
  const int rs = p.rs;
  const bool x16 = p.x16 != 0, h_res = p.h_tab != 0;
  const bool resident = !HAS_CA && p.resident != 0;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthr = blockDim.x, n_warps = nthr >> 5;
  const unsigned lt_mask = (1u << lane) - 1u;
  // the last warp stages the ring; the others own the slots, one (or
  // none) a thread with PER1, else a run
  const int n_own = nthr - 32;
  const bool producer = tid >= n_own;
  const int plane = tid - n_own;
  const int per = PER1 ? 1 : (K + n_own - 1) / n_own;
  const int k0 = producer ? K : min(K, tid * per);
  const int k1 = producer ? K : min(K, k0 + per);

  // ---- the carry, on chip
  long long v1 = -1, dl1 = 0;          // PER1: the slot's carry
  float rs1 = 0.0f, vs1 = 0.0f;
  long long* cv = a.virt;              // runs: shared or device memory
  long long* cdl = a.deadline;
  float* crs = a.rs;
  float* cvs = a.vs;
  if (PER1) {
    if (k0 < k1) {
      v1 = a.virt[k0];
      dl1 = a.deadline[k0];
      rs1 = a.rs[k0];
      vs1 = a.vs[k0];
    }
  } else if (p.carry_smem) {
    cv = reinterpret_cast<long long*>(smem + p.carry_off);
    cdl = cv + K;
    crs = reinterpret_cast<float*>(cdl + K);
    cvs = crs + K;
    for (int k = k0; k < k1; ++k) {
      cv[k] = a.virt[k];
      cdl[k] = a.deadline[k];
      crs[k] = a.rs[k];
      cvs[k] = a.vs[k];
    }
  }
  if (h_res)                           // the h_slots table, async
    for (int idx = tid; idx < a.I * K; idx += nthr)
      cp_async4(h_tab + idx, a.h_slots + idx);
  if (resident) {                      // the armed slots' rows, async
    for (int k = k0; k < k1; ++k) {
      const long long v = PER1 ? v1 : cv[k];
      if (v < 0) continue;
      const float* src = coords + v * D;
      float* dst = rows + static_cast<long long>(k) * rs;
      if (x16) {
        for (int c = 0; c < (D >> 2); ++c)
          cp_async16(dst + 4 * c, src + 4 * c);
      } else {
        for (int d = 0; d < D; ++d) cp_async4(dst + d, src + d);
      }
    }
  }

  // ---- the ring, filled by the producer warp. Step q's entry is issued
  // at step q - kAhead (before that step's barrier), waited for at step
  // q - 1 (before its barrier) and read at step q; it was last read at
  // step q - kRing, which every thread has finished once it has passed
  // the barrier of step q - kRing + 1 <= q - kAhead - 1. The window
  // values of step q are loaded into registers one step before the entry
  // is issued.
  long long o_nx = 0, i_nx = 0, t_nx = 0;
  float u_nx = 0.0f, b1e_nx = 0.0f;
  int fl_nx = 0;
  auto fetch = [&](int q, bool scalars) {
    if (q >= T) return;
    o_nx = a.objs[q];
    i_nx = a.ings[q];
    if (scalars) {
      t_nx = a.ts[q];
      u_nx = a.slotu[q];
      fl_nx = (a.valid == nullptr || a.valid[q] != 0 ? 1 : 0) |
              (a.armf[q] != 0 ? 2 : 0);
      if (a.b1_ext != nullptr) b1e_nx = a.b1_ext[q];
    }
  };
  // the step's values and table entries, by one lane
  auto stage_step = [&](int q) {
    Staged& st = ring[q % kRing];
    const long long io = i_nx * O + o_nx;
    st.o = o_nx;
    st.i = i_nx;
    st.t = t_nx;
    st.u = u_nx;
    st.flags = fl_nx;
    if (a.b1_ext != nullptr)
      st.b1 = b1e_nx;
    else
      cp_async4(&st.b1, a.best1 + io);
    cp_async8(&st.a1, a.arg1 + io);
    cp_async4(&st.b2, a.best2 + io);
  };
  // the step's x_o row, by the producer's lanes
  auto stage_row = [&](int q, long long o) {
    if (HAS_CA) return;
    float* dst = ring_x + (q % kRing) * rs;
    const float* src = coords + o * D;
    if (x16) {
      for (int c = plane; c < (D >> 2); c += 32)
        cp_async16(dst + 4 * c, src + 4 * c);
    } else {
      for (int d = plane; d < D; d += 32) cp_async4(dst + d, src + d);
    }
  };
  // the first kAhead steps: lane j stages step t_begin + j's values,
  // then every lane its share of each step's rows
  if (producer && plane < kAhead && a.t_begin + plane < T) {
    fetch(a.t_begin + plane, true);
    stage_step(a.t_begin + plane);
  }
  __syncthreads();
  if (producer) {
    for (int q = a.t_begin; q < min(T, a.t_begin + kAhead); ++q)
      stage_row(q, ring[q % kRing].o);
  }
  cp_async_commit();
  cp_async_wait<0>();
  if (producer) fetch(a.t_begin + kAhead, plane == 0);
  __syncthreads();

  bool stopped = false;
  int last = a.t_begin - 1;           // the last step run
  for (int s = a.t_begin; s < T; ++s) {
    const int e = s % kRing, par = s & 1;
    if (producer) {
      if (plane == 1 && s > a.t_begin) {  // the last step's served cost
        const Staged& prev = ring[(s - 1) % kRing];
        a.out[s - 1] = (prev.flags & 1) != 0 ? prev.b1 : 0.0f;
      }
      if (s + kAhead < T) {
        if (plane == 0) stage_step(s + kAhead);
        stage_row(s + kAhead, o_nx);
      }
      cp_async_commit();
      fetch(s + kAhead + 1, plane == 0);
    }

    const Staged& st = ring[e];
    const long long o = st.o, t = st.t, a1 = st.a1;
    const bool valid = (st.flags & 1) != 0;
    const float b1 = st.b1;
    const float* hrow = (h_res ? h_tab : a.h_slots) + st.i * K;
    const float* xrow = ring_x + e * rs;
    const long long ya = a1 > 0 ? a1 : 0;
    const float add = valid && a1 >= 0 ? __fsub_rn(st.b2, b1) : 0.0f;

    // pricing of one armed slot (streamed: resident row or device row)
    auto price = [&](int k, long long v) -> float {
      if (HAS_CA) return a.ca[o * O + v];
      if (resident)
        return stable_ca_v4<METRIC>(
            xrow, rows + static_cast<long long>(k) * rs, D, gamma);
      return stable_ca<METRIC>(xrow, coords + v * D, D, gamma);
    };

    // savings, settle flags, and the warp's counts
    bool ex1 = false, pr1 = false, fr1 = false;
    int n_free = 0, n_prom = 0;
    if (PER1) {
      if (k0 < k1) {
        const float h = hrow[k0];
        if (ya == k0) rs1 = __fadd_rn(rs1, add);
        const bool armed = v1 >= 0;
        if (valid && armed)
          vs1 = __fadd_rn(vs1, fmaxf(__fsub_rn(b1, __fadd_rn(price(k0, v1), h)),
                                     0.0f));
        ex1 = valid && armed && dl1 <= t;
        pr1 = ex1 && vs1 > __fmul_rn(one_delta, rs1) && vs1 > 0.0f;
        fr1 = (ex1 || !armed) && isfinite(h);
      }
    } else {
      if (ya >= k0 && ya < k1) crs[ya] = __fadd_rn(crs[ya], add);
      for (int k = k0; k < k1; ++k) {
        const float h = hrow[k];
        const long long v = cv[k];
        const bool armed = v >= 0;
        float vsk = cvs[k];
        if (valid && armed) {
          vsk = __fadd_rn(vsk, fmaxf(__fsub_rn(b1, __fadd_rn(price(k, v), h)),
                                     0.0f));
          cvs[k] = vsk;
        }
        const bool ex = valid && armed && cdl[k] <= t;
        n_prom += ex && vsk > __fmul_rn(one_delta, crs[k]) && vsk > 0.0f;
        n_free += (ex || !armed) && isfinite(h);
      }
    }
    unsigned ballot_free = 0;
    int incl = 0;                      // runs: inclusive count in the warp
    if (PER1) {
      ballot_free = __ballot_sync(kFull, fr1);
      const unsigned ballot_prom = __ballot_sync(kFull, pr1);
      if (lane == 0) {
        s_free[par][warp] = __popc(ballot_free);
        s_prom[par][warp] = __popc(ballot_prom);
      }
    } else {
      incl = n_free;
      for (int d = 1; d < 32; d <<= 1) {
        const int x = __shfl_up_sync(kFull, incl, d);
        if (lane >= d) incl += x;
      }
      int prom_warp = n_prom;
      for (int d = 16; d > 0; d >>= 1)
        prom_warp += __shfl_xor_sync(kFull, prom_warp, d);
      if (lane == 31) s_free[par][warp] = incl;
      if (lane == 0) s_prom[par][warp] = prom_warp;
    }
    if (producer) cp_async_wait<kAhead - 1>();  // step s + 1's entry
    __syncthreads();
    // every warp scans the warps' counts alike (shuffles: a REDUX goes
    // through the uniform datapath at a much longer latency)
    int scan_f = lane < n_warps ? s_free[par][lane] : 0;
    int scan_p = lane < n_warps ? s_prom[par][lane] : 0;
    for (int d = 1; d < 32; d <<= 1) {
      const int xf = __shfl_up_sync(kFull, scan_f, d);
      const int xp = __shfl_up_sync(kFull, scan_p, d);
      if (lane >= d) {
        scan_f += xf;
        scan_p += xp;
      }
    }
    const int free_total = __shfl_sync(kFull, scan_f, n_warps - 1);
    const int promote_total = __shfl_sync(kFull, scan_p, n_warps - 1);
    const int before = __shfl_sync(kFull, scan_f, warp > 0 ? warp - 1 : 0);
    const int free_before = warp > 0 ? before : 0;

    // settle and arm
    const bool any_p = promote_total > 0;
    const bool arm = valid && (st.flags & 2) != 0 && free_total > 0;
    const int m = arm ? min(static_cast<int>(__fmul_rn(
                                st.u, static_cast<float>(free_total))),
                            free_total - 1)
                      : -1;
    const float4* x4 = reinterpret_cast<const float4*>(xrow);
    if (PER1) {
      bool arming = false;
      if (k0 < k1) {
        if (any_p) {
          a.ev_promote[k0] = pr1;
          a.ev_virt[k0] = v1;
          a.ev_rs[k0] = rs1;
          a.ev_vs[k0] = vs1;
        }
        if (pr1) a.slots[k0] = v1;
        if (ex1) {
          v1 = -1;
          rs1 = 0.0f;
          vs1 = 0.0f;
        }
        arming = fr1 && free_before + __popc(ballot_free & lt_mask) == m;
        if (arming) {
          v1 = o;
          dl1 = t + a.window;
          rs1 = 0.0f;
          vs1 = 0.0f;
        }
      }
      if (resident) {                  // the arming lane's warp copies
        const unsigned armers = __ballot_sync(kFull, arming);
        if (armers != 0) {
          const int k = warp * 32 + __ffs(armers) - 1;
          float4* dst = reinterpret_cast<float4*>(
              rows + static_cast<long long>(k) * rs);
          for (int c = lane; c < (rs >> 2); c += 32) dst[c] = x4[c];
          __syncwarp();
        }
      }
    } else {
      int rank = free_before + incl - n_free;
      for (int k = k0; k < k1; ++k) {
        long long v = cv[k];
        float rsk = crs[k], vsk = cvs[k];
        const float h = hrow[k];
        const bool armed = v >= 0;
        const bool ex = valid && armed && cdl[k] <= t;
        const bool pr = ex && vsk > __fmul_rn(one_delta, rsk) &&
                        vsk > 0.0f;
        if (any_p) {
          a.ev_promote[k] = pr;
          a.ev_virt[k] = v;
          a.ev_rs[k] = rsk;
          a.ev_vs[k] = vsk;
        }
        if (pr) a.slots[k] = v;
        if (ex) {
          v = -1;
          rsk = 0.0f;
          vsk = 0.0f;
        }
        if (v < 0 && isfinite(h)) {
          if (rank == m) {
            v = o;
            cdl[k] = t + a.window;
            rsk = 0.0f;
            vsk = 0.0f;
            if (resident) {
              float4* dst = reinterpret_cast<float4*>(
                  rows + static_cast<long long>(k) * rs);
#pragma unroll 4
              for (int c = 0; c < (rs >> 2); ++c) dst[c] = x4[c];
            }
          }
          ++rank;
        }
        cv[k] = v;
        crs[k] = rsk;
        cvs[k] = vsk;
      }
    }
    if (any_p) {
      if (producer && plane == 0) {
        *a.n_prom += promote_total;
        *a.stop = s;
      }
      stopped = true;
      last = s;
      break;
    }
    last = s;
  }
  if (producer && plane == 1 && last >= a.t_begin) {
    const Staged& st = ring[last % kRing];
    a.out[last] = (st.flags & 1) != 0 ? st.b1 : 0.0f;
  }

  // ---- write the carry back
  cp_async_wait<0>();
  if (PER1) {
    if (k0 < k1) {
      a.virt[k0] = v1;
      a.deadline[k0] = dl1;
      a.rs[k0] = rs1;
      a.vs[k0] = vs1;
    }
  } else if (p.carry_smem) {
    for (int k = k0; k < k1; ++k) {
      a.virt[k] = cv[k];
      a.deadline[k] = cdl[k];
      a.rs[k] = crs[k];
      a.vs[k] = cvs[k];
    }
  }
  if (!stopped && producer && plane == 0) *a.stop = T;
}

int align16(long long bytes) { return static_cast<int>((bytes + 15) / 16 * 16); }

// The dynamic shared memory a block of `kern` may opt into on this card:
// the opt-in limit less the kernel's own static shared arrays.
cudaError_t smem_avail(const void* kern, int* avail) {
  int dev = 0, bytes = 0;
  cudaFuncAttributes fa{};
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, kern);
  *avail = bytes - static_cast<int>(fa.sharedSizeBytes);
  return err;
}

// The rows first (they feed the chain), then a run carry, then h_slots.
ScanPlan plan_scan(bool has_ca, bool per1, int I, int K, int D, bool x16,
                   int avail) {
  ScanPlan p{};
  p.rs = has_ca ? 0 : (D + 3) / 4 * 4;
  if (!has_ca && (p.rs / 4) % 2 == 0) p.rs += 4;
  p.x16 = x16 ? 1 : 0;
  p.x_off = align16(kRing * sizeof(Staged));
  p.ring_end = p.x_off + kRing * p.rs * 4;
  long long cur = p.ring_end;
  p.rows_off = static_cast<int>(cur);
  const long long row_bytes = static_cast<long long>(K) * p.rs * 4;
  p.resident = !has_ca && cur + row_bytes <= avail;
  if (p.resident) cur += row_bytes;
  p.carry_off = static_cast<int>(cur);
  p.carry_smem = !per1 && cur + 24LL * K <= avail;
  if (p.carry_smem) cur += 24LL * K;
  p.h_off = static_cast<int>(cur);
  const long long h_bytes = 4LL * I * K;
  p.h_tab = cur + h_bytes <= avail;
  if (p.h_tab) cur += h_bytes;
  p.total = static_cast<int>(cur);
  return p;
}

template <bool HAS_CA, int METRIC, bool PER1>
cudaError_t launch_scan(const DuelArgs& a, int threads, cudaStream_t st) {
  auto kern = duel_scan_kernel<HAS_CA, METRIC, PER1>;
  int avail = 0;
  cudaError_t err = smem_avail(reinterpret_cast<const void*>(kern), &avail);
  if (err != cudaSuccess) return err;
  const bool x16 = a.D % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(a.coords) % 16 == 0;
  const ScanPlan p = plan_scan(HAS_CA, PER1, a.I, a.K, a.D, x16, avail);
  if (p.ring_end > avail)
    return cudaErrorInvalidValue;      // the ring alone does not fit
  err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, p.total);
  if (err != cudaSuccess) return err;
  kern<<<1, threads, p.total, st>>>(a, p);
  return cudaGetLastError();
}

// One thread a slot (PER1) while the slot warps and the producer warp fit
// in one block, else runs of slots over 31 warps.
template <bool HAS_CA, int METRIC>
cudaError_t launch_metric(const DuelArgs& a, cudaStream_t st) {
  if (a.K <= kMaxThreads - 32) {
    const int threads = ((a.K > 32 ? a.K : 32) + 31) / 32 * 32 + 32;
    return launch_scan<HAS_CA, METRIC, true>(a, threads, st);
  }
  return launch_scan<HAS_CA, METRIC, false>(a, kMaxThreads, st);
}

// ---------------------------------------------------------------- re-arm
constexpr int kRowThreads = 128;    // object rows a block of the first pass
constexpr int kKeysStaged = 16;     // promoted slots whose keys it stages
constexpr int kCols = 16;           // new columns held in registers at once
constexpr int kDirtyBlocksPerSm = 1;

struct RearmArgs {
  const float* coords;              // (O, D) f32
  const float* ca;                  // (O, O) f32, or null
  int O, D;
  float gamma;
  const float* b1p;                 // (I, O) pre-fold tables in
  const long long* a1p;
  const float* b2p;
  const long long* a2p;
  const long long* slots;           // (K,) the new layout
  const unsigned char* promote;     // (K,) the written slots
  const long long* slot_cache;      // (K,)
  const float* H;                   // (I, J)
  const float* h_repo;              // (I,)
  int I, K, J;
  float* nb1;                       // (I, O) pre-fold tables out
  long long* na1;
  float* nb2;
  long long* na2;
  float* best1;                     // (I, O) serving tables out
  long long* arg1;
  float* best2;
  int* n_dirty;                     // (1,) then (O,) the dirty rows
  int* dirty;
};

struct RowPlan {
  int mask_off, keys_off, tile_off, total;
  int nks;         // promoted slots whose key rows are staged
  int xs;          // stride of the staged object rows (odd), 0: not staged
};

struct DirtyPlan {
  int x_off, keys_off, total;
  int ks;          // stride of the staged slot keys (odd), 0: not staged
};

// The pre-fold entry and its fold into the serving tables (the fold's
// torch.minimum keeps its first operand on a tie).
__device__ __forceinline__ void store_row(const RearmArgs& a, long long idx,
                                          int i, float b1, long long a1,
                                          float b2, long long a2) {
  a.nb1[idx] = b1;
  a.na1[idx] = a1;
  a.nb2[idx] = b2;
  a.na2[idx] = a2;
  const float repo = a.h_repo[i];
  const bool repo_wins = repo < b1;
  a.best1[idx] = repo_wins ? repo : b1;
  a.arg1[idx] = repo_wins ? -1 : a1;
  const float second = repo_wins ? b1 : b2;
  a.best2[idx] = repo < second ? repo : second;
}

__device__ __forceinline__ bool promoted(const unsigned* mask, long long y,
                                         int K) {
  return y >= 0 && y < K && ((mask[y >> 5] >> (y & 31)) & 1u) != 0;
}

template <bool HAS_CA, int METRIC>
__global__ void __launch_bounds__(kRowThreads)
rearm_rows_kernel(const RearmArgs a, const RowPlan p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_np;
  int* ys = reinterpret_cast<int*>(smem);
  unsigned* mask = reinterpret_cast<unsigned*>(smem + p.mask_off);
  float* keys = reinterpret_cast<float*>(smem + p.keys_off);
  float* tile = reinterpret_cast<float*>(smem + p.tile_off);
  const int tid = threadIdx.x;

  // the promoted slots in ascending order, and their bit mask
  if (tid < 32) {
    int count = 0;
    for (int base = 0; base < a.K; base += 32) {
      const int k = base + tid;
      const bool f = k < a.K && a.promote[k] != 0;
      const unsigned b = __ballot_sync(kFull, f);
      if (f) ys[count + __popc(b & ((1u << tid) - 1u))] = k;
      if (tid == 0) mask[base >> 5] = b;
      count += __popc(b);
    }
    if (tid == 0) s_np = count;
  }
  __syncthreads();
  const int P = s_np;
  const int r0 = blockIdx.x * kRowThreads;
  if (!HAS_CA) {                     // stage the keys and the block's rows
    const int nk = min(P, p.nks);
    for (int idx = tid; idx < nk * a.D; idx += kRowThreads) {
      const int q = idx / a.D, d = idx - q * a.D;
      const long long obj = a.slots[ys[q]];
      keys[idx] = a.coords[(obj > 0 ? obj : 0) * a.D + d];
    }
    if (p.xs) {                      // contiguous in device memory: walk
      const int nr = min(kRowThreads, a.O - r0);  // (row, d) along it
      const float* src = a.coords + static_cast<long long>(r0) * a.D;
      const int n = nr * a.D;
      // four floats a load where rows are whole float4s, else one
      const int w = a.D % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(a.coords) % 16 == 0 ? 4 : 1;
      int rr = tid * w / a.D, d = tid * w - rr * a.D;
#pragma unroll 4
      for (int e = tid * w; e < n; e += kRowThreads * w) {
        float* dst = tile + rr * p.xs + d;
        if (w == 4) {
          const float4 v = *reinterpret_cast<const float4*>(src + e);
          dst[0] = v.x;
          dst[1] = v.y;
          dst[2] = v.z;
          dst[3] = v.w;
        } else {
          dst[0] = src[e];
        }
        d += kRowThreads * w;
        while (d >= a.D) {
          d -= a.D;
          ++rr;
        }
      }
    }
  }
  __syncthreads();
  const int r = r0 + tid;
  if (r >= a.O) return;

  // dirty: a witness on a promoted slot, at any ingress
  bool dirty = false;
  for (int i = 0; i < a.I && !dirty; ++i) {
    const long long idx = static_cast<long long>(i) * a.O + r;
    dirty = promoted(mask, a.a1p[idx], a.K) || promoted(mask, a.a2p[idx], a.K);
  }
  if (dirty) {
    a.dirty[atomicAdd(a.n_dirty, 1)] = r;
    return;
  }

  // a clean row: each new column once, inserted at every ingress in
  // ascending slot order, kCols columns at a time
  const float* xr = HAS_CA ? nullptr
                    : p.xs ? tile + tid * p.xs
                           : a.coords + static_cast<long long>(r) * a.D;
  const int n_chunks = P > 0 ? (P + kCols - 1) / kCols : 1;
  for (int c = 0; c < n_chunks; ++c) {
    const int q0 = c * kCols;
    float col[kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int q = q0 + j;
      col[j] = INFINITY;
      if (q < P) {
        const long long obj = a.slots[ys[q]];
        if (obj >= 0) {
          if (HAS_CA) {
            col[j] = a.ca[static_cast<long long>(r) * a.O + obj];
          } else {
            const float* key = q < p.nks ? keys + q * a.D
                                         : a.coords + obj * a.D;
            col[j] = stable_ca<METRIC>(xr, key, a.D, a.gamma);
          }
        }
      }
    }
    for (int i = 0; i < a.I; ++i) {
      const long long idx = static_cast<long long>(i) * a.O + r;
      const bool first = c == 0;
      float b1 = first ? a.b1p[idx] : a.nb1[idx];
      long long a1 = first ? a.a1p[idx] : a.na1[idx];
      float b2 = first ? a.b2p[idx] : a.nb2[idx];
      long long a2 = first ? a.a2p[idx] : a.na2[idx];
      const float* hi = a.H + static_cast<long long>(i) * a.J;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int q = q0 + j;
        if (q < P) {
          const long long y = ys[q];
          const float cn = __fadd_rn(col[j], hi[a.slot_cache[y]]);
          if (cn < b1 || (cn == b1 && y < a1)) {
            b2 = b1;
            a2 = a1;
            b1 = cn;
            a1 = y;
          } else if (cn < b2 || (cn == b2 && y < a2)) {
            b2 = cn;
            a2 = y;
          }
        }
      }
      if (c == n_chunks - 1) {
        store_row(a, idx, i, b1, a1, b2, a2);
      } else {
        a.nb1[idx] = b1;
        a.na1[idx] = a1;
        a.nb2[idx] = b2;
        a.na2[idx] = a2;
      }
    }
  }
}

// (b1, a1) <- the lexicographically least (cost, slot) pair of the two
// lists, (b2, a2) the next; each list sorted, slots distinct.
__device__ __forceinline__ bool lex_less(float c, int k, float b, int a) {
  return c < b || (c == b && k < a);
}
__device__ __forceinline__ void merge_two(float& b1, int& a1, float& b2,
                                          int& a2, float c1, int d1,
                                          float c2, int d2) {
  if (lex_less(c1, d1, b1, a1)) {
    if (lex_less(b1, a1, c2, d2)) {
      b2 = b1;
      a2 = a1;
    } else {
      b2 = c2;
      a2 = d2;
    }
    b1 = c1;
    a1 = d1;
  } else if (lex_less(c1, d1, b2, a2)) {
    b2 = c1;
    a2 = d1;
  }
}
__device__ __forceinline__ void warp_merge(float& b1, int& a1, float& b2,
                                           int& a2) {
  for (int off = 16; off > 0; off >>= 1) {
    const float c1 = __shfl_xor_sync(kFull, b1, off);
    const int d1 = __shfl_xor_sync(kFull, a1, off);
    const float c2 = __shfl_xor_sync(kFull, b2, off);
    const int d2 = __shfl_xor_sync(kFull, a2, off);
    merge_two(b1, a1, b2, a2, c1, d1, c2, d2);
  }
}

template <bool HAS_CA, int METRIC>
__global__ void __launch_bounds__(kMaxThreads)
rearm_dirty_kernel(const RearmArgs a, const DirtyPlan p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float r_b1[kMaxWarps], r_b2[kMaxWarps];
  __shared__ int r_a1[kMaxWarps], r_a2[kMaxWarps];
  const int n = *a.n_dirty;
  if (static_cast<int>(blockIdx.x) >= n) return;
  float* sca = reinterpret_cast<float*>(smem);
  float* xrow = reinterpret_cast<float*>(smem + p.x_off);
  float* keys = reinterpret_cast<float*>(smem + p.keys_off);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthr = blockDim.x, n_warps = nthr >> 5;
  if (!HAS_CA && p.ks) {             // every slot's key row
    for (int idx = tid; idx < a.K * a.D; idx += nthr) {
      const int k = idx / a.D, d = idx - k * a.D;
      const long long obj = a.slots[k];
      keys[k * p.ks + d] = obj >= 0 ? a.coords[obj * a.D + d] : 0.0f;
    }
  }
  for (int w = blockIdx.x; w < n; w += gridDim.x) {
    const int r = a.dirty[w];
    __syncthreads();                 // the last row's readers are done
    if (!HAS_CA)
      for (int d = tid; d < a.D; d += nthr)
        xrow[d] = a.coords[static_cast<long long>(r) * a.D + d];
    __syncthreads();
    for (int k = tid; k < a.K; k += nthr) {
      const long long obj = a.slots[k];
      float c = INFINITY;
      if (obj >= 0) {
        if (HAS_CA)
          c = a.ca[static_cast<long long>(r) * a.O + obj];
        else
          c = stable_ca<METRIC>(
              xrow, p.ks ? keys + k * p.ks : a.coords + obj * a.D, a.D,
              a.gamma);
      }
      sca[k] = c;                    // read back by this thread only
    }
    for (int i = 0; i < a.I; ++i) {
      const float* hi = a.H + static_cast<long long>(i) * a.J;
      float b1 = INFINITY, b2 = INFINITY;
      int a1 = INT_MAX, a2 = INT_MAX;
      for (int k = tid; k < a.K; k += nthr) {
        const float c = __fadd_rn(sca[k], hi[a.slot_cache[k]]);
        if (lex_less(c, k, b1, a1)) {
          b2 = b1;
          a2 = a1;
          b1 = c;
          a1 = k;
        } else if (lex_less(c, k, b2, a2)) {
          b2 = c;
          a2 = k;
        }
      }
      warp_merge(b1, a1, b2, a2);
      if (lane == 0) {
        r_b1[warp] = b1;
        r_a1[warp] = a1;
        r_b2[warp] = b2;
        r_a2[warp] = a2;
      }
      __syncthreads();
      if (warp == 0) {
        b1 = lane < n_warps ? r_b1[lane] : INFINITY;
        a1 = lane < n_warps ? r_a1[lane] : INT_MAX;
        b2 = lane < n_warps ? r_b2[lane] : INFINITY;
        a2 = lane < n_warps ? r_a2[lane] : INT_MAX;
        warp_merge(b1, a1, b2, a2);
        if (lane == 0)               // argmin over a row of +inf: slot 0
          store_row(a, static_cast<long long>(i) * a.O + r, i, b1, a1, b2,
                    b2 == INFINITY ? 0 : a2);
      }
      __syncthreads();
    }
  }
}

template <bool HAS_CA, int METRIC>
cudaError_t launch_rearm(const RearmArgs& a, cudaStream_t st) {
  auto rows = rearm_rows_kernel<HAS_CA, METRIC>;
  auto dirty = rearm_dirty_kernel<HAS_CA, METRIC>;
  int avail = 0;
  cudaError_t err = smem_avail(reinterpret_cast<const void*>(rows), &avail);
  if (err != cudaSuccess) return err;
  // first pass: ys, mask, promoted keys, the block's object rows
  RowPlan rp{};
  rp.mask_off = align16(4LL * a.K);
  rp.keys_off = rp.mask_off + align16(4LL * ((a.K + 31) / 32));
  rp.nks = HAS_CA ? 0 : (a.K < kKeysStaged ? a.K : kKeysStaged);
  rp.tile_off = rp.keys_off + align16(4LL * rp.nks * a.D);
  if (rp.tile_off > avail) {         // keys from device memory
    rp.nks = 0;
    rp.tile_off = rp.keys_off;
  }
  rp.xs = HAS_CA ? 0 : (a.D | 1);
  rp.total = rp.tile_off + 4 * kRowThreads * rp.xs;
  if (rp.total > avail) {            // object rows from device memory
    rp.xs = 0;
    rp.total = rp.tile_off;
  }
  if (rp.total > avail) return cudaErrorInvalidValue;
  err = smem_avail(reinterpret_cast<const void*>(dirty), &avail);
  if (err != cudaSuccess) return err;
  // second pass: C_a of every slot, the object row, the slots' keys
  DirtyPlan dp{};
  dp.x_off = align16(4LL * a.K);
  dp.keys_off = dp.x_off + align16(4LL * a.D);
  dp.ks = HAS_CA ? 0 : (a.D | 1);
  dp.total = dp.keys_off + static_cast<int>(
      (4LL * a.K * dp.ks + 15) / 16 * 16);
  if (4LL * a.K * dp.ks + dp.keys_off > avail) {
    dp.ks = 0;
    dp.total = dp.keys_off;
  }
  if (dp.total > avail) return cudaErrorInvalidValue;

  err = cudaMemsetAsync(a.n_dirty, 0, sizeof(int), st);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(rows, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             rp.total);
  if (err != cudaSuccess) return err;
  rows<<<(a.O + kRowThreads - 1) / kRowThreads, kRowThreads, rp.total, st>>>(
      a, rp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  int dev = 0, n_sm = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      dirty, cudaFuncAttributeMaxDynamicSharedMemorySize, dp.total);
  if (err != cudaSuccess) return err;
  const int threads = a.K >= kMaxThreads ? kMaxThreads
                                         : ((a.K > 32 ? a.K : 32) + 31) / 32 *
                                               32;
  const int blocks = a.O < n_sm * kDirtyBlocksPerSm ? a.O
                                                    : n_sm * kDirtyBlocksPerSm;
  dirty<<<blocks, threads, dp.total, st>>>(a, dp);
  return cudaGetLastError();
}

}  // namespace
}  // namespace simcache

// Kernel F: the NETDUEL steps [t_begin, T) up to and including the first
// that promotes (its index, or T, goes to *stop). Tensors as
// kernels/duel/duel.py documents them; ca, b1_ext and valid may be null.
// Refused (cudaErrorInvalidValue) where the ring of x_o rows does not fit
// in a block's shared memory (D past about 7,000).
extern "C" int simcache_duel_scan(
    const float* coords, const float* ca, int O, int D, int metric,
    float gamma, const float* best1, const long long* arg1,
    const float* best2, const float* h_slots, int I, int K,
    long long* slots,
    long long* virt, float* rs, float* vs, long long* deadline,
    long long* n_prom, const long long* objs, const long long* ings,
    const long long* ts, const unsigned char* armf, const float* slotu,
    const float* b1_ext, const unsigned char* valid, int t_begin, int T,
    float one_delta, long long window, float* out,
    unsigned char* ev_promote, long long* ev_virt, float* ev_rs,
    float* ev_vs, int* stop, void* stream) {
  using namespace simcache;
  const DuelArgs a{coords, ca,    O,       D,        metric, gamma,
                   best1,  arg1,  best2,   h_slots,  I,      K,
                   slots,
                   virt,   rs,    vs,      deadline, n_prom, objs,
                   ings,   ts,    armf,    slotu,    b1_ext, valid,
                   t_begin, T,    one_delta, window, out,    ev_promote,
                   ev_virt, ev_rs, ev_vs,  stop};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ca != nullptr) return launch_metric<true, kMetricL1>(a, st);
  switch (metric) {
    case kMetricL1:
      return launch_metric<false, kMetricL1>(a, st);
    case kMetricL2:
      return launch_metric<false, kMetricL2>(a, st);
    case kMetricL2Sq:
      return launch_metric<false, kMetricL2Sq>(a, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// Kernel F's second entry: the re-arm after a promoting step. Reads the
// pre-fold tables (b1p, a1p, b2p, a2p), the new layout and the promote
// flags; writes the new pre-fold tables (nb1, na1, nb2, na2) and the
// serving tables (best1, arg1, best2), each (I, O). `scratch` holds
// O + 1 ints (the dirty rows' count and list). No host sync.
extern "C" int simcache_duel_rearm(
    const float* coords, const float* ca, int O, int D, int metric,
    float gamma, const float* b1p, const long long* a1p, const float* b2p,
    const long long* a2p, const long long* slots,
    const unsigned char* promote, const long long* slot_cache,
    const float* H, const float* h_repo, int I, int K, int J, float* nb1,
    long long* na1, float* nb2, long long* na2, float* best1,
    long long* arg1, float* best2, int* scratch, void* stream) {
  using namespace simcache;
  if (O == 0 || I == 0) return cudaSuccess;
  const RearmArgs a{coords, ca,    O,     D,     gamma, b1p,  a1p,
                    b2p,    a2p,   slots, promote, slot_cache, H, h_repo,
                    I,      K,     J,     nb1,   na1,   nb2,  na2,
                    best1,  arg1,  best2, scratch, scratch + 1};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ca != nullptr) return launch_rearm<true, kMetricL1>(a, st);
  switch (metric) {
    case kMetricL1:
      return launch_rearm<false, kMetricL1>(a, st);
    case kMetricL2:
      return launch_rearm<false, kMetricL2>(a, st);
    case kMetricL2Sq:
      return launch_rearm<false, kMetricL2Sq>(a, st);
    default:
      return cudaErrorInvalidValue;
  }
}
