// The whole campaign sweep in one launch (sm_90a): campaign_sweep_kernel.
//
// Replaces the compiled scan of the JAX package's sweep engine,
// `_scan_campaigns` (repro/core/sweep_jax.py:236), whose step calls the
// four TPU kernels campaign_preempt_kernel (twice), campaign_match_kernel,
// campaign_advance_kernel and campaign_bill_kernel
// (repro/kernels/campaign_sweep.py:69, 76, 93, 117).  XLA runs that scan
// as one program; the eager engine on the card instead launches ~294
// small kernels a tick from a Python loop, so the card sat idle most of a
// sweep.  This kernel runs every tick of every lane of one engine batch
// and writes the final state once.  The final settle (one more dt at the
// last segment's rates) stays in PyTorch, shared by every route.
//
// Layout: one warp per lane, four lanes per 128-thread block (255 blocks
// at B = 1,020).  A lane's state stays in shared memory for all N ticks:
// per group its occupancy cells [idle | pilot-dead | busy at step
// 0..X-1] (C = X + 2 ints, the allocator's row as it is), its target,
// and the data plane's virgin, hit_acc and egress; per lane the
// checkpoint-level queue lv [L], the fresh queue, the flags, the counters
// and the f32 accumulators.  That is 4 * (G * (X + 2) + 10 G + 3 L + T
// + 3 P + 16) bytes a lane: 1.3 KB at the main grid's G = 10, X = 16,
// L = 5, T = 5, P = 3.  Where four lanes' cells would not fit in a
// block's 227 KB (a data plane whose stage-in widens X past ~1,400), the
// cells live in a global scratch instead (L2-resident at these sizes) and
// the rest stays in shared memory.
//
// Per tick, in the eager engine's order (core/sweep_torch.py `_tick`):
//   lane    events: the deferred budget cap, the segment's scale target
//           (greedy over cap_g);
//   group   (thread g, striding for G > 32) kill to target, spawn, the
//           Poisson draw, preemption (each split by the allocator over the
//           group's C cells), the matcher's input;
//   lane    queue top-up, the match allocator over G, the queue drain over
//           L + 1;
//   group   the joint (group x queue-slice) partition, the data plane's
//           hit/miss split, NAT drops, the advance;
//   lane    billing, overhead, the ledger thresholds, the cap flags, the
//           GPU-time totals.
// Counts are scattered by the planner's index planes (lvl_of_w, w0_of_j,
// pos_hit, pos_miss) instead of the eager route's one-hot products: the
// same integers.
//
// Rounding: every f32 operation is an explicit round-to-nearest intrinsic
// in the eager code's order (campaign_ops.cuh holds the shared row
// bodies, the draw and its ndtri).  Integer sums and f32 sums of whole
// numbers below 2**24 are exact in any order.  One f32 sum has an order
// of its own: the data plane's egress over G, added to spent, is summed
// left to right here (torch.sum picks its own association), so `spent`
// may differ from the eager routes' in its last bits.
//
// Randomness: with no uniforms buffer each (tick, group) draw is
// Philox-4x32-10 at key (seed low, seed high), counter (tick, group, 0, 0),
// top 24 bits: the eager engine's `philox_uniforms`, bit for bit.  With a
// buffer ([N, B, G] f32) the kernel reads it instead.
//
// Bound on an H100: latency.  The bytes that must move (planes, index
// planes, uniforms if given, the final state) take about a microsecond at
// 3.35 TB/s, and the f32 work per (lane, tick, group) is tens of
// operations; the time is the length of one tick's dependency chain
// (a few microseconds: the allocator rows, the draw, ~4 warp barriers, the
// lane-serial matcher and bill) times N, with all lanes in flight at once.
// The design spends nothing on launches, host round trips or device
// memory traffic between ticks, which is all the eager route spends.

#include <cuda_runtime.h>

#include "campaign_ops.cuh"

namespace {

using namespace campaign;

constexpr int kLanes = 4;  // lanes (warps) per block
constexpr int kThreads = 32 * kLanes;
constexpr int kMaxSmem = 232448;  // a block's shared memory on an H100
constexpr unsigned kAll = 0xffffffffu;

// flags
constexpr int kNatAny = 1, kDpActive = 2, kDpStaging = 4, kOwnDraws = 8;

// The arguments, in the order of ops.SWEEP_INPUTS, then ops.SWEEP_STATE
// (the final state), then the cells scratch.
enum Arg {
  // per tick [N]
  kSegOfTick, kIsSegStart,
  // per segment: [S, B, G], [S, B] or [S, B, G, J]
  kCap, kRate, kOutage, kFloor, kDownscale, kMinq, kNUnc, kNCap,
  kOriginUp, kDpFlush, kSMiss, kPosMiss,
  // per group [G], per lane [B, ...]
  kPreRateG, kPreScaleG, kNatG, kFinmask, kLvlOfW, kW0OfJ, kPosHit, kProvOnehot,
  kOverheadTick, kBudget, kThresholds, kDpRG, kDpLossG, kDpHasG, kDpUsdMissG,
  kSHitG, kSeeds, kUniforms,
  // the final state
  kIdle, kPdead, kTargetG, kBusy, kLv, kFreshQ, kSpent, kByProv, kInfra,
  kFired, kCapped, kCapPending, kCapTick, kPreCt, kNatCt, kFinCt, kAccel,
  kBusyH, kBusyProv, kHitAcc, kVirgin, kHits, kMisses, kStageT, kEgressG,
  // [B, G, X + 2] ints: the cells where shared memory cannot hold them
  kCellsScratch,
  kNumArgs
};
enum Dim { kB = 0, kG, kX, kL, kP, kT, kS, kN, kNumDims };

struct Params {
  const void* p[kNumArgs];
  int B, G, X, L, P, T, S, N;
  float dt;
  int flags;
  int cells_in_smem;
};

template <class T>
__device__ __forceinline__ const T* in(const Params& a, int i) {
  return static_cast<const T*>(a.p[i]);
}
template <class T>
__device__ __forceinline__ T* out(const Params& a, int i) {
  return static_cast<T*>(const_cast<void*>(a.p[i]));
}

// Shared words of one lane (ints and floats alike 4 bytes), in order.
struct LaneLayout {
  int cells, tgt, live0, take, cA, busy_g, lv, take_j, cB, fired, ints;
  int virgin, hit_acc, egress, eg, rate_dt, by_prov, busy_prov, prov_d,
      floats;
  int words;
};
enum IntScalar {
  kIFreshQ = 0, kICapped, kICapPending, kICapTick, kIPreCt, kINatCt,
  kIFinCt, kNumIntScalars
};
enum FloatScalar {
  kFSpent = 0, kFInfra, kFAccel, kFBusyH, kFHits, kFMisses, kFStageT,
  kNumFloatScalars
};

__host__ __device__ inline LaneLayout lane_layout(int G, int X, int L, int P,
                                                  int T, bool cells) {
  LaneLayout o;
  int n = 0;
  o.cells = n;   n += cells ? G * (X + 2) : 0;
  o.tgt = n;     n += G;
  o.live0 = n;   n += G;
  o.take = n;    n += G;
  o.cA = n;      n += G;
  o.busy_g = n;  n += G;
  o.lv = n;      n += L;
  o.take_j = n;  n += L + 1;
  o.cB = n;      n += L + 1;
  o.fired = n;   n += T;
  o.ints = n;    n += kNumIntScalars;
  o.virgin = n;  n += G;
  o.hit_acc = n; n += G;
  o.egress = n;  n += G;
  o.eg = n;      n += G;
  o.rate_dt = n; n += G;
  o.by_prov = n; n += P;
  o.busy_prov = n; n += P;
  o.prov_d = n;  n += P;
  o.floats = n;  n += kNumFloatScalars;
  o.words = n;
  return o;
}

// Split k removals of a group's row over its cells by the allocator and
// take them out; busy cells requeue at their checkpoint level.  Returns
// the instances removed; `busy_out` gains the busy ones.
__device__ __forceinline__ int remove_cells(int* row, int k, int C,
                                            const int* lvl_of_w, int* lv,
                                            int* busy_out) {
  if (k <= 0) return 0;  // s = 0: every share is floor(1e-3) - floor(1e-3)
  int removed = 0;
  alloc_row(row, k, C, [&](int c, int n) {
    row[c] -= n;
    removed += n;
    if (c >= 2 && n != 0) {
      *busy_out += n;
      atomicAdd(&lv[lvl_of_w[c - 2]], n);
    }
  });
  return removed;
}

__global__ void __launch_bounds__(kThreads)
    campaign_sweep_kernel(const Params a) {
  extern __shared__ int smem[];
  const int t = threadIdx.x & 31;
  const int b = blockIdx.x * kLanes + (threadIdx.x >> 5);
  if (b >= a.B) return;  // a whole warp leaves; no block barrier follows
  const int G = a.G, X = a.X, L = a.L, P = a.P, T = a.T, B = a.B;
  const int C = X + 2, J = L + 1;
  const float dt = a.dt;
  const bool nat_any = a.flags & kNatAny;
  const bool dp_active = a.flags & kDpActive;
  const bool dp_staging = a.flags & kDpStaging;
  const bool own_draws = a.flags & kOwnDraws;

  const LaneLayout o = lane_layout(G, X, L, P, T, a.cells_in_smem);
  int* base = smem + (threadIdx.x >> 5) * o.words;
  float* fbase = reinterpret_cast<float*>(base);
  int* cells = a.cells_in_smem
                   ? base + o.cells
                   : out<int>(a, kCellsScratch) +
                         static_cast<long long>(b) * G * C;
  int* tgt = base + o.tgt;
  int* live0_s = base + o.live0;
  int* take = base + o.take;
  int* cA = base + o.cA;
  int* busy_g = base + o.busy_g;
  int* lv = base + o.lv;
  int* take_j = base + o.take_j;
  int* cB = base + o.cB;
  int* fired = base + o.fired;
  int* is = base + o.ints;
  float* virgin = fbase + o.virgin;
  float* hit_acc = fbase + o.hit_acc;
  float* egress = fbase + o.egress;
  float* eg = fbase + o.eg;
  float* rate_dt = fbase + o.rate_dt;
  float* by_prov = fbase + o.by_prov;
  float* busy_prov = fbase + o.busy_prov;
  float* prov_d = fbase + o.prov_d;
  float* fs = fbase + o.floats;

  for (int w = t; w < o.words; w += 32) base[w] = 0;  // 0 and 0.0f alike
  if (!a.cells_in_smem)
    for (int w = t; w < G * C; w += 32) cells[w] = 0;
  __syncwarp();
  if (t == 0) is[kICapTick] = -1;

  const int* seg_of_tick = in<int>(a, kSegOfTick);
  const unsigned char* is_seg_start = in<unsigned char>(a, kIsSegStart);
  const int* lvl_of_w = in<int>(a, kLvlOfW) + static_cast<long long>(b) * X;
  const int* finmask = in<int>(a, kFinmask) + static_cast<long long>(b) * X;
  const float* onehot = in<float>(a, kProvOnehot);
  const float* pre_rate = in<float>(a, kPreRateG);
  const float* pre_scale = in<float>(a, kPreScaleG);
  const long long seed = own_draws ? in<long long>(a, kSeeds)[b] : 0;
  const unsigned k0 = static_cast<unsigned>(seed & 0xffffffffLL);
  const unsigned k1 = static_cast<unsigned>((seed >> 32) & 0xffffffffLL);

  for (int i = 0; i < a.N; ++i) {
    const int seg = seg_of_tick[i];
    const bool start = is_seg_start[i] != 0;
    const long long sb = static_cast<long long>(seg) * B + b;  // [S, B]
    const int* cap = in<int>(a, kCap) + sb * G;
    const float* rate = in<float>(a, kRate) + sb * G;

    // 1. events: the deferred budget cap first, then this segment's net
    // scale target (uncapped / capped pair), each spread greedily over
    // the groups' capacities
    if (t == 0) {
      const bool apply = is[kICapPending] != 0;
      if (apply) is[kICapTick] = i;
      bool spread = apply;
      int n = apply ? in<int>(a, kDownscale)[sb] : 0;
      if (start) {
        const int n_eff = is[kICapped] ? in<int>(a, kNCap)[sb]
                                       : in<int>(a, kNUnc)[sb];
        if (n_eff >= 0) {
          spread = true;
          n = n_eff;
        }
      }
      if (spread) {
        int cume = 0;
        for (int g = 0; g < G; ++g) {
          tgt[g] = min(max(n - cume, 0), cap[g]);
          cume += cap[g];
        }
      }
    }
    __syncwarp();

    // 2-4. per group: kill down to target (busy kills requeue), spawn to
    // min(target, capacity), then the Poisson preemption total fanned out
    // over the cells; the matcher's input (origin outages gate it)
    int removed_busy = 0;
    for (int g = t; g < G; g += 32) {
      int* row = cells + g * C;
      int live0 = row[0] + row[1];
      for (int w = 0; w < X; ++w) live0 += row[2 + w];
      live0_s[g] = live0;
      float vg = virgin[g];
      if (dp_staging && start && in<unsigned char>(a, kDpFlush)[sb * G + g])
        vg = __int2float_rn(live0);
      const int capg = cap[g];
      int live = live0;
      live -= remove_cells(row, max(live - tgt[g], 0), C, lvl_of_w, lv,
                           &removed_busy);
      if (dp_staging)  // kills hit virgins pro rata
        vg = __fdiv_rn(__fmul_rn(vg, __int2float_rn(live)),
                       fmaxf(__int2float_rn(live0), 1.0f));
      const int deficit = max(min(tgt[g], capg) - live, 0);
      row[0] += deficit;
      live += deficit;
      if (dp_staging) vg = __fadd_rn(vg, __int2float_rn(deficit));
      const int live_sp = live;
      const float util = __fdiv_rn(__int2float_rn(live),
                                   __int2float_rn(max(capg, 1)));
      const float hazard = __fmul_rn(
          __fmul_rn(pre_rate[g],
                    __fadd_rn(1.0f, __fmul_rn(__fsub_rn(pre_scale[g], 1.0f),
                                              util))),
          dt);
      const float lam = __fmul_rn(__int2float_rn(live), hazard);
      const float u =
          own_draws ? philox_uniform(k0, k1, static_cast<unsigned>(i),
                                     static_cast<unsigned>(g))
                    : in<float>(a, kUniforms)[(static_cast<long long>(i) * B +
                                               b) * G + g];
      live -= remove_cells(row, poisson_draw(u, lam), C, lvl_of_w, lv,
                           &removed_busy);
      if (dp_staging)
        vg = __fdiv_rn(__fmul_rn(vg, __int2float_rn(live)),
                       fmaxf(__int2float_rn(live_sp), 1.0f));
      virgin[g] = vg;
      take[g] = dp_active
                    ? row[0] * in<unsigned char>(a, kOriginUp)[sb * G + g]
                    : row[0];
    }
    __syncwarp();

    // 5-7. top the queue up to the workload level; match k = min(idle,
    // queued) jobs, split over the groups by the allocator and drained
    // from the queue highest checkpoint level first, then fresh jobs
    if (t == 0) {
      int ring = 0;
      for (int l = 0; l < L; ++l) ring += lv[l];
      const int fresh = is[kIFreshQ];
      const int fq = fresh + max(in<int>(a, kMinq)[sb] - (ring + fresh), 0);
      int idle_tot = 0;
      for (int g = 0; g < G; ++g) idle_tot += take[g];
      int k = min(idle_tot, ring + fq);
      if (in<unsigned char>(a, kOutage)[sb]) k = 0;
      alloc_row(take, k, G, [&](int c, int n) { take[c] = n; });
      int run = 0;
      for (int g = 0; g < G; ++g) {
        run += take[g];
        cA[g] = run;
      }
      int cum = 0;
      run = 0;
      for (int j = 0; j < J; ++j) {
        const int avail = j < L ? lv[L - 1 - j] : fq;
        const int tj = min(max(k - cum, 0), avail);
        cum += avail;
        run += tj;
        take_j[j] = tj;
        cB[j] = run;
        if (j < L) lv[L - 1 - j] -= tj;
      }
      is[kIFreshQ] = fq - take_j[L];
    }
    __syncwarp();

    // 7-8. per group: the matched jobs enter at their queue slice's step
    // (the overlap of the two cumulative partitions of [0, k)), through
    // stage-in where the data plane has one; NAT drops; the advance
    int fin = 0, nat = 0, hits_i = 0, misses_i = 0, stage_i = 0;
    int live_end = 0, busy_sum = 0;
    for (int g = t; g < G; g += 32) {
      int* row = cells + g * C;
      const int tg = take[g];
      const int hi_a = cA[g], lo_a = hi_a - tg;
      if (!dp_staging) {
        const int* w0 = in<int>(a, kW0OfJ) + static_cast<long long>(b) * J;
        for (int j = 0; j < J; ++j)
          row[2 + w0[j]] +=
              max(min(hi_a, cB[j]) - max(lo_a, cB[j] - take_j[j]), 0);
      } else {
        // the hit/miss split is the fractional accumulator; a virgin
        // pilot's first match forfeits the expected hit credit
        const float take_f = __int2float_rn(tg);
        const float first_f = fminf(take_f, virgin[g]);
        virgin[g] = __fsub_rn(virgin[g], first_f);
        const float acc = __fsub_rn(
            __fadd_rn(hit_acc[g], __fmul_rn(take_f, in<float>(a, kDpRG)[g])),
            __fmul_rn(first_f, in<float>(a, kDpLossG)[g]));
        const float th_f = fminf(fmaxf(floorf(acc), 0.0f), take_f);
        hit_acc[g] = __fsub_rn(acc, th_f);
        const int th = static_cast<int>(th_f);
        const long long bgj = (static_cast<long long>(b) * G + g) * J;
        const int* pos_hit = in<int>(a, kPosHit) + bgj;
        const int* pos_miss = in<int>(a, kPosMiss) + sb * G * J +
                              static_cast<long long>(g) * J;
        int before = 0;  // matched jobs of this group in earlier slices
        for (int j = 0; j < J; ++j) {
          const int jt =
              max(min(hi_a, cB[j]) - max(lo_a, cB[j] - take_j[j]), 0);
          const int hit = min(max(th - before, 0), jt);
          before += jt;
          row[2 + pos_hit[j]] += hit;
          row[2 + pos_miss[j]] += jt - hit;
        }
        const int s_miss = in<int>(a, kSMiss)[sb * G + g];
        if (in<float>(a, kDpHasG)[g] != 0.0f) {
          hits_i += th;
          misses_i += tg - th;
        }
        stage_i += th * static_cast<int>(in<float>(a, kSHitG)[g]) +
                   (tg - th) * s_miss;
        eg[g] = __fmul_rn(__fsub_rn(take_f, th_f),
                          in<float>(a, kDpUsdMissG)[g]);
        egress[g] = __fadd_rn(egress[g], eg[g]);
      }
      row[0] -= tg;
      // NAT drops: every busy pilot of a disconnected group requeues its
      // job (the instance stays alive and billed, its pilot dead)
      if (nat_any && in<int>(a, kNatG)[static_cast<long long>(b) * G + g]) {
        int cnt = 0;
        for (int w = 0; w < X; ++w) {
          const int d = row[2 + w];
          if (d != 0) {
            atomicAdd(&lv[lvl_of_w[w]], d);
            cnt += d;
            row[2 + w] = 0;
          }
        }
        row[1] += cnt;
        nat += cnt;
      }
      const int f = advance_row(row + 2, finmask, row + 2, X);
      fin += f;
      row[0] += f;
      int bg = 0;
      for (int w = 0; w < X; ++w) bg += row[2 + w];
      busy_g[g] = bg;
      busy_sum += bg;
      live_end += row[0] + row[1] + bg;
      rate_dt[g] = __fmul_rn(rate[g], i > 0 ? dt : 0.0f);
    }
    removed_busy = __reduce_add_sync(kAll, removed_busy + nat);
    nat = __reduce_add_sync(kAll, nat);
    fin = __reduce_add_sync(kAll, fin);
    live_end = __reduce_add_sync(kAll, live_end);
    busy_sum = __reduce_add_sync(kAll, busy_sum);
    if (dp_staging) {
      hits_i = __reduce_add_sync(kAll, hits_i);
      misses_i = __reduce_add_sync(kAll, misses_i);
      stage_i = __reduce_add_sync(kAll, stage_i);
    }
    __syncwarp();

    // 9-12. bill the interval ending at this tick against its starting
    // live set; egress; flat overhead; the ledger thresholds and the
    // budget-floor tripwire (the cap applies at the next tick's events);
    // GPU-time totals at end-of-tick occupancy
    if (t == 0) {
      float spent_d;
      bill_lane(live0_s, rate_dt, onehot, G, P, &spent_d, prov_d);
      float spent = __fadd_rn(fs[kFSpent], spent_d);
      if (dp_staging) {
        float eg_sum = eg[0];
        for (int g = 1; g < G; ++g) eg_sum = __fadd_rn(eg_sum, eg[g]);
        spent = __fadd_rn(spent, eg_sum);
      }
      for (int p = 0; p < P; ++p) by_prov[p] = __fadd_rn(by_prov[p], prov_d[p]);
      const float oh = in<float>(a, kOverheadTick)[b];
      spent = __fadd_rn(spent, oh);
      fs[kFSpent] = spent;
      fs[kFInfra] = __fadd_rn(fs[kFInfra], oh);
      const float budget = in<float>(a, kBudget)[b];
      const float frac =
          __fdiv_rn(fmaxf(__fsub_rn(budget, spent), 0.0f), budget);
      bool newly = false;
      for (int k = 0; k < T; ++k) {
        if (frac <= in<float>(a, kThresholds)[k] && !fired[k]) {
          fired[k] = 1;
          newly = true;
        }
      }
      const bool trigger =
          newly && frac <= in<float>(a, kFloor)[sb] && !is[kICapped];
      if (trigger) is[kICapped] = 1;
      is[kICapPending] = trigger;
      fs[kFAccel] = __fadd_rn(fs[kFAccel],
                              __fmul_rn(__int2float_rn(live_end), dt));
      fs[kFBusyH] = __fadd_rn(fs[kFBusyH],
                              __fmul_rn(__int2float_rn(busy_sum), dt));
      for (int p = 0; p < P; ++p) {
        float s = 0.0f;  // whole numbers: exact in any order
        for (int g = 0; g < G; ++g)
          s = __fadd_rn(s, __fmul_rn(__int2float_rn(busy_g[g]),
                                     onehot[g * P + p]));
        busy_prov[p] = __fadd_rn(busy_prov[p], __fmul_rn(s, dt));
      }
      is[kIPreCt] += removed_busy;
      is[kINatCt] += nat;
      is[kIFinCt] += fin;
      if (dp_staging) {
        fs[kFHits] = __fadd_rn(fs[kFHits], __int2float_rn(hits_i));
        fs[kFMisses] = __fadd_rn(fs[kFMisses], __int2float_rn(misses_i));
        fs[kFStageT] = __fadd_rn(fs[kFStageT], __int2float_rn(stage_i));
      }
    }
    __syncwarp();
  }

  // the final state, written once
  const long long bG = static_cast<long long>(b) * G;
  for (int g = t; g < G; g += 32) {
    const int* row = cells + g * C;
    out<int>(a, kIdle)[bG + g] = row[0];
    out<int>(a, kPdead)[bG + g] = row[1];
    out<int>(a, kTargetG)[bG + g] = tgt[g];
    int* busy = out<int>(a, kBusy) + (bG + g) * X;
    for (int w = 0; w < X; ++w) busy[w] = row[2 + w];
    out<float>(a, kHitAcc)[bG + g] = hit_acc[g];
    out<float>(a, kVirgin)[bG + g] = virgin[g];
    out<float>(a, kEgressG)[bG + g] = egress[g];
  }
  for (int l = t; l < L; l += 32)
    out<int>(a, kLv)[static_cast<long long>(b) * L + l] = lv[l];
  for (int k = t; k < T; k += 32)
    out<unsigned char>(a, kFired)[static_cast<long long>(b) * T + k] =
        fired[k] != 0;
  for (int p = t; p < P; p += 32) {
    out<float>(a, kByProv)[static_cast<long long>(b) * P + p] = by_prov[p];
    out<float>(a, kBusyProv)[static_cast<long long>(b) * P + p] =
        busy_prov[p];
  }
  if (t == 0) {
    out<int>(a, kFreshQ)[b] = is[kIFreshQ];
    out<unsigned char>(a, kCapped)[b] = is[kICapped] != 0;
    out<unsigned char>(a, kCapPending)[b] = is[kICapPending] != 0;
    out<int>(a, kCapTick)[b] = is[kICapTick];
    out<int>(a, kPreCt)[b] = is[kIPreCt];
    out<int>(a, kNatCt)[b] = is[kINatCt];
    out<int>(a, kFinCt)[b] = is[kIFinCt];
    out<float>(a, kSpent)[b] = fs[kFSpent];
    out<float>(a, kInfra)[b] = fs[kFInfra];
    out<float>(a, kAccel)[b] = fs[kFAccel];
    out<float>(a, kBusyH)[b] = fs[kFBusyH];
    out<float>(a, kHits)[b] = fs[kFHits];
    out<float>(a, kMisses)[b] = fs[kFMisses];
    out<float>(a, kStageT)[b] = fs[kFStageT];
  }
}

}  // namespace

// -- C entry point (bound with ctypes) ---------------------------------------

namespace {

// Shared memory bytes of one block, with or without the cells.
long long block_smem(const Params& a, bool cells) {
  return 4LL * kLanes * lane_layout(a.G, a.X, a.L, a.P, a.T, cells).words;
}

}  // namespace

// ptrs: kNumArgs device pointers in the order of ops.SWEEP_INPUTS, then
// ops.SWEEP_STATE, then the cells scratch (0 for an input the flags
// leave unused); dims: B, G, X, L, P, T, S, N.
extern "C" int campaign_sweep_fused(const void* const* ptrs, int n_ptrs,
                                    const int* dims, int n_dims, float dt,
                                    int flags, void* stream) {
  if (n_ptrs != kNumArgs || n_dims != kNumDims)
    return static_cast<int>(cudaErrorInvalidValue);
  Params a;
  for (int i = 0; i < kNumArgs; ++i) a.p[i] = ptrs[i];
  a.B = dims[kB];
  a.G = dims[kG];
  a.X = dims[kX];
  a.L = dims[kL];
  a.P = dims[kP];
  a.T = dims[kT];
  a.S = dims[kS];
  a.N = dims[kN];
  a.dt = dt;
  a.flags = flags;
  long long smem = block_smem(a, true);
  a.cells_in_smem = smem <= kMaxSmem;
  if (!a.cells_in_smem) smem = block_smem(a, false);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        campaign_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (a.B > 0)
    campaign_sweep_kernel<<<(a.B + kLanes - 1) / kLanes, kThreads,
                            static_cast<size_t>(smem),
                            static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
