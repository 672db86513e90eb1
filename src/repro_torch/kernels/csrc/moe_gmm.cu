// Grouped (per-expert) matrix product for the MoE expert FFN (sm_90a).
//
// Replaces the TPU kernel `moe_gmm_kernel` / `_gmm_kernel`
// (repro/kernels/moe_gmm.py:22-59).  It computes what the Pallas kernel
// computes:
//
//   o[e] = x[e] @ w[e],  x (E,C,D), w (E,D,F) -> o (E,C,F),
//
// every product and the sum over D in f32, the output cast to x's type
// (bf16 by round to nearest even, as torch's cast).  The model calls it
// three times per MoE layer on the capacity buffer (gate, up: D -> F;
// down: F -> D), always with w cast to x's type.
//
// Bound on an H100: operations.  At the jamba-v0.1-52b shape (E=16,
// C=1280, D=4096, F=14336) one product is 2*E*C*D*F = 2.4 TFLOP against
// 2.0 GB of bf16 operands: 2.4 ms at the 989 TFLOP/s bf16 tensor-core
// rate.  In f32 at C=640 (the f32 forward's capacity) 1.2 TFLOP: 17.9 ms
// at the 67 TFLOP/s of the CUDA cores; at the decode capacity (C=8) the
// 3.8 GB of f32 w: 1.12 ms at 3.35 TB/s.
//
// Two routes, chosen by the wrapper (kernels/ops.py `gmm_route`):
//
// * `moe_gmm_kernel_wgmma` (x and w bf16, D and F multiples of 8, bases
//   16-byte aligned): wgmma on the tensor cores fed by a TMA ring, below.
// * `moe_gmm_kernel` (everything else: f32, mixed types, unaligned
//   widths): f32 FMAs on the CUDA cores, whose floor is the 67 TFLOP/s
//   f32 rate (the 1e-5 gate rules out TF32 and bf16 tensor cores).
//
// The CUDA-core design, a register- and shared-memory-tiled SGEMM: one
// block of 256 threads per (row tile, 128-column tile, expert) of the
// output.  The TPU kernel carried an f32 accumulator in VMEM scratch
// across a sequential K grid axis; here the block loops over K (= D)
// itself, a stage of 16 (32 for the smallest tile) at a time.  Each
// stage's x tile is stored transposed (k-major) and its w tile as
// stored, both f32, in two shared-memory buffers: the next stage's global
// loads go into registers as loaded (zeros past ragged edges) while the
// FMAs of the current one run, and land in the other buffer after them,
// widened to f32 only then (so nothing waits on a bf16 load before the
// FMAs), with one __syncthreads a stage.  The row tile is 128 (8 rows x
// 8 columns of the output a thread: each float4 shared load feeds 16
// FMAs), or 16 for small capacities such as decoding's (1 row a
// thread), where a 128-row tile would spend up to 16x the FMAs while the
// bytes of w bound the call; the wrapper's rule `gmm_row_tile` picks it.  The grid's fastest axis is the row tile, so the blocks that share
// a w tile run together and read it from L2.  The types are template
// parameters; the loads take 4 elements at a time where D and F are
// multiples of 4 and the bases aligned (`vec`, uniform per launch), one
// at a time otherwise.  Each thread's global pointers are set once and
// advanced a stage at a time, so no per-element index needs 64 bits
// (one jamba expert tensor holds 939.5 M elements).
//
// Ragged C, D and F are masked in the kernels (zeros in shared memory
// add nothing), so nothing is padded in device memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr int kBN = 128;  // output columns (F) per block
constexpr int kThreads = 256;
constexpr int kAPad = 4;  // keeps float4 rows aligned

// per row tile: the reduction depth of a stage and the blocks an SM
// should hold (the launch bounds' register budget).  The 128-row tile
// takes a depth of 16 at one block an SM (165 registers): at two blocks
// the 128-register budget spills at that depth, and a depth of 8 at two
// blocks ran slower at jamba's f32 shapes; the 16-row tile, bound by
// the bytes of w in flight, a depth of 32.
template <int BM> struct GmmTile;
template <> struct GmmTile<128> {
  static constexpr int kBK = 16;
  static constexpr int kMinBlocks = 1;
};
template <> struct GmmTile<16> {
  static constexpr int kBK = 32;
  static constexpr int kMinBlocks = 2;
};

using hopper::fetch_raw4;
using hopper::store4;
using hopper::widen4;

// o[e] = x[e] @ w[e] for a BM x 128 output tile.  The 256 threads form a
// 16 x 16 grid (ty over rows, tx over columns); a warp is 4 x 8 of them,
// so each of its shared loads is one 128-byte wavefront.  A thread owns
// columns tx*4 .. +3 and 64 + tx*4 .. +3, and rows ty*4 .. +3 and
// BM/2 + ty*4 .. +3 (BM = 128) or row ty (BM = 16).
template <typename TX, typename TW, int BM>
__global__ void __launch_bounds__(kThreads, GmmTile<BM>::kMinBlocks)
    moe_gmm_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                   TX* __restrict__ o, int C, int D, int F, bool vec) {
  constexpr int kBK = GmmTile<BM>::kBK;
  constexpr int TM = BM / 16;              // rows per thread
  constexpr int kAS = BM + kAPad;          // row pitch of the transposed x tile
  constexpr int kAPieces = BM * kBK / 4;   // float4 pieces of an x tile
  constexpr int kAIters = (kAPieces + kThreads - 1) / kThreads;
  constexpr int kBIters = kBK * kBN / 4 / kThreads;
  static_assert(kBK % 8 == 0 && (kAPieces % kThreads == 0 ||
                                 kAPieces < kThreads), "tile loads");
  __shared__ __align__(16) float xs[2][kBK][kAS];
  __shared__ __align__(16) float ws[2][kBK][kBN];

  const int c0 = blockIdx.x * BM;
  const int f0 = blockIdx.y * kBN;
  const int e = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int tx = (warp % 2) * 8 + lane % 8;
  const int ty = (warp / 2) * 4 + lane / 8;

  // this thread's pieces of each x tile (row ar, k ak .. ak + 3) and of
  // each w tile (k br, columns bc .. bc + 3), a step's pointers to them
  // advanced a step at a time
  const TX* xp[kAIters];
  int ar[kAIters], ak[kAIters];
  bool a_live[kAIters];
#pragma unroll
  for (int it = 0; it < kAIters; ++it) {
    const int p = tid + it * kThreads;
    ar[it] = p / (kBK / 4);
    ak[it] = (p % (kBK / 4)) * 4;
    a_live[it] = p < kAPieces && c0 + ar[it] < C;
    xp[it] = x + (static_cast<long long>(e) * C + min(c0 + ar[it], C - 1)) *
                     D + ak[it];
  }
  const int bc = (tid % 32) * 4;
  const bool b_live = f0 + bc < F;
  const TW* wp = w + (static_cast<long long>(e) * D + tid / 32) * F + f0 + bc;
  const long long w_row = 8LL * F;               // 8 rows of w a piece apart
  const long long w_step = static_cast<long long>(kBK) * F;

  float acc[TM][8];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  // step k0's pieces into registers as loaded (zeros past C, D and F),
  // so that nothing waits on them until they are stored ...
  typename hopper::Raw4<TX>::type ra[kAIters];
  typename hopper::Raw4<TW>::type rb[kBIters];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int it = 0; it < kAIters; ++it)
      ra[it] = a_live[it] ? fetch_raw4(xp[it], k0 + ak[it], D, vec)
                          : typename hopper::Raw4<TX>::type{};
#pragma unroll
    for (int it = 0; it < kBIters; ++it) {
      const int kr = k0 + tid / 32 + 8 * it;
      rb[it] = b_live && kr < D
                   ? fetch_raw4(wp + it * w_row, f0 + bc, F, vec)
                   : typename hopper::Raw4<TW>::type{};
    }
  };
  // ... and into stage s as f32 (x transposed)
  auto store = [&](int s) {
#pragma unroll
    for (int it = 0; it < kAIters; ++it) {
      if (tid + it * kThreads < kAPieces) {
        const float4 a = widen4(ra[it]);
        xs[s][ak[it]][ar[it]] = a.x;
        xs[s][ak[it] + 1][ar[it]] = a.y;
        xs[s][ak[it] + 2][ar[it]] = a.z;
        xs[s][ak[it] + 3][ar[it]] = a.w;
      }
    }
#pragma unroll
    for (int it = 0; it < kBIters; ++it)
      *reinterpret_cast<float4*>(&ws[s][tid / 32 + 8 * it][bc]) =
          widen4(rb[it]);
  };

  const int n_k = (D + kBK - 1) / kBK;
  if (n_k > 0) {
    fetch(0);
    store(0);
  }
  __syncthreads();

  for (int kt = 0; kt < n_k; ++kt) {
    const int s = kt % 2;
    const bool more = kt + 1 < n_k;
    if (more) {                          // step kt + 1 into registers
#pragma unroll
      for (int it = 0; it < kAIters; ++it) xp[it] += kBK;
      wp += w_step;
      fetch((kt + 1) * kBK);
    }
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[TM];
      if constexpr (TM == 8) {
        const float4 a0 = *reinterpret_cast<const float4*>(&xs[s][kk][ty * 4]);
        const float4 a1 =
            *reinterpret_cast<const float4*>(&xs[s][kk][BM / 2 + ty * 4]);
        a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
        a[4] = a1.x; a[5] = a1.y; a[6] = a1.z; a[7] = a1.w;
      } else {
        a[0] = xs[s][kk][ty];
      }
      const float4 b0 = *reinterpret_cast<const float4*>(&ws[s][kk][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&ws[s][kk][kBN / 2 + tx * 4]);
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (more) store(s ^ 1);              // ... and into the other stage
    __syncthreads();
  }

  TX* oe = o + static_cast<long long>(e) * C * F;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = TM == 8 ? (i / 4) * (BM / 2) + ty * 4 + i % 4 : ty;
    const int c = c0 + r;
    if (c >= C) continue;
    TX* orow = oe + static_cast<long long>(c) * F;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int f = f0 + h * (kBN / 2) + tx * 4;
      const float v[4] = {acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                          acc[i][4 * h + 3]};
      if (f < F) store4(orow + f, v, F - f, vec);
    }
  }
}

template <typename TX, typename TW, int BM>
void launch_tile(const void* x, const void* w, void* o, int E, int C, int D,
                 int F, bool vec, cudaStream_t stream) {
  const dim3 grid((C + BM - 1) / BM, (F + kBN - 1) / kBN, E);
  moe_gmm_kernel<TX, TW, BM><<<grid, kThreads, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const TW*>(w),
      static_cast<TX*>(o), C, D, F, vec);
}

template <typename TX, typename TW>
int launch_gmm(const void* x, const void* w, void* o, int E, int C, int D,
               int F, int row_tile, bool vec, cudaStream_t stream) {
  if (row_tile == 16)
    launch_tile<TX, TW, 16>(x, w, o, E, C, D, F, vec, stream);
  else
    launch_tile<TX, TW, 128>(x, w, o, E, C, D, F, vec, stream);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// -- the tensor-core route ----------------------------------------------------
//
// One block of 384 threads per (128-row x 256-column output tile, expert):
// warpgroup 0 is the producer, of which one thread issues the TMA loads
// of a 4-stage ring, each stage an x tile (128 rows x 64 of D, K-major)
// and a w tile (64 of D x 256 columns, read in its stored row-major
// layout, i.e. MN-major: the wgmma's transpose bit, no transposed copy of
// the 1.9 GB of weights); warpgroups 1 and 2 are consumers, each running
// wgmma m64n256k16 (bf16 in, f32 accumulators in 128 registers a thread)
// on 64 of the rows.  A consumer keeps one k-tile's products in flight:
// it releases a stage when the next tile's products are issued and the
// previous ones have completed.  The epilogue rounds to bf16 (nearest
// even) and stores from registers, masked to C and F.  The grid's
// fastest axis is the row tile, so the blocks that run together share
// their w tiles in L2 (one expert's x, 10 MB at C=1280, stays there).
// TMA fills rows past C, D and columns past F with zeros, and the 3-d
// maps keep one expert's ragged edge from reading the next expert's rows.

namespace {

constexpr int kTcBM = 128;
constexpr int kTcBN = 256;
constexpr int kTcBK = 64;
constexpr int kTcStages = 4;
constexpr int kTcThreads = 384;
constexpr int kTcConsumers = 256;
constexpr int kXBytes = kTcBM * 128;                  // 128 rows x 128 B
constexpr int kWBox = kTcBK * 128;                    // 64 rows x 128 B
constexpr int kWBytes = (kTcBN / hopper::kBoxElems) * kWBox;
constexpr int kStageBytes = kXBytes + kWBytes;        // 48 KB
constexpr int kBarOffset = kTcStages * kStageBytes;
constexpr int kTcSmem =
    kBarOffset + 2 * kTcStages * 8 + static_cast<int>(hopper::kAtomBytes);

__global__ void __launch_bounds__(kTcThreads, 1)
    moe_gmm_kernel_wgmma(const __grid_constant__ CUtensorMap tx,
                         const __grid_constant__ CUtensorMap tw,
                         __nv_bfloat16* __restrict__ o, int C, int D, int F) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hopper::atom_aligned(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kBarOffset);
  uint64_t* empty = full + kTcStages;

  const int m0 = blockIdx.x * kTcBM;
  const int n0 = blockIdx.y * kTcBN;
  const int e = blockIdx.z;
  const int n_k = (D + kTcBK - 1) / kTcBK;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < kTcStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], kTcConsumers);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (tid < 128) {
    // -- producer ------------------------------------------------------------
    hopper::setmaxnreg_dec<24>();
    if (tid == 0) {
      for (int kt = 0; kt < n_k; ++kt) {
        const int s = kt % kTcStages;
        hopper::mbar_wait(&empty[s], ((kt / kTcStages) & 1) ^ 1);
        hopper::mbar_expect_tx(&full[s], kStageBytes);
        uint8_t* xs = smem + s * kStageBytes;
        hopper::tma_load_3d(xs, &tx, &full[s], kt * kTcBK, m0, e);
#pragma unroll
        for (int c = 0; c < kTcBN / hopper::kBoxElems; ++c)
          hopper::tma_load_3d(xs + kXBytes + c * kWBox, &tw, &full[s],
                              n0 + c * hopper::kBoxElems, kt * kTcBK, e);
      }
    }
  } else {
    // -- consumers -----------------------------------------------------------
    hopper::setmaxnreg_inc<240>();
    const int w = tid / 128 - 1;
    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.0f;
    hopper::fence_regs(acc);
    for (int kt = 0; kt < n_k; ++kt) {
      const int s = kt % kTcStages;
      hopper::mbar_wait(&full[s], (kt / kTcStages) & 1);
      const uint32_t xs =
          hopper::smem_u32(smem + s * kStageBytes) + w * 64 * 128;
      const uint32_t ws = hopper::smem_u32(smem + s * kStageBytes + kXBytes);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kTcBK / 16; ++kk)
        hopper::wgmma_ss_m64n256<1>(
            acc, hopper::smem_desc(xs + kk * 32, 16, hopper::kAtomBytes),
            hopper::smem_desc(ws + kk * 16 * 128, kWBox, hopper::kAtomBytes),
            1);
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();          // the previous tile's products are done
      if (kt > 0) hopper::mbar_arrive(&empty[(kt - 1) % kTcStages]);
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);

    const int lane = tid % 32;
    const int row = m0 + w * 64 + ((tid % 128) / 32) * 16 + lane / 4;
    const int col = n0 + 2 * (lane % 4);
    __nv_bfloat16* oe = o + static_cast<long long>(e) * C * F;
#pragma unroll
    for (int j = 0; j < kTcBN / 8; ++j) {
      const int n = col + 8 * j;
      if (n >= F) continue;   // F is even, so n + 1 < F too
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = row + 8 * half;
        if (r < C) {
          __nv_bfloat162 v = __floats2bfloat162_rn(acc[4 * j + 2 * half],
                                                   acc[4 * j + 2 * half + 1]);
          *reinterpret_cast<__nv_bfloat162*>(
              oe + static_cast<long long>(r) * F + n) = v;
        }
      }
    }
  }
}

}  // namespace

// -- C entry point (bound with ctypes) ----------------------------------------
//
// x (E,C,D), w (E,D,F), o (E,C,F), all contiguous.  `x_bf16` / `w_bf16`
// select each input's type (0: f32, 1: bf16); o has x's type.
// `row_tile` (16 or 128) is the output rows of a block, the wrapper's
// `gmm_row_tile(C)`.  Returns the launch's cudaError_t.
extern "C" int moe_gmm(const void* x, const void* w, void* o, int x_bf16,
                       int w_bf16, int E, int C, int D, int F, int row_tile,
                       void* stream) {
  if (E < 0 || C < 0 || D < 0 || F < 0 || E > 65535 ||
      (F + kBN - 1) / kBN > 65535 ||
      (row_tile != 16 && row_tile != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  if (E == 0 || C == 0 || F == 0) return static_cast<int>(cudaGetLastError());
  // 4 elements a load: rows of D and F whole multiples of 4, every base
  // aligned to 4 elements
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x) % (x_bf16 ? 8 : 16);
  const uintptr_t wa = reinterpret_cast<uintptr_t>(w) % (w_bf16 ? 8 : 16);
  const uintptr_t oa = reinterpret_cast<uintptr_t>(o) % (x_bf16 ? 8 : 16);
  const bool vec = D % 4 == 0 && F % 4 == 0 && xa == 0 && wa == 0 && oa == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16 && w_bf16)
    return launch_gmm<__nv_bfloat16, __nv_bfloat16>(x, w, o, E, C, D, F,
                                                    row_tile, vec, s);
  if (x_bf16)
    return launch_gmm<__nv_bfloat16, float>(x, w, o, E, C, D, F, row_tile,
                                            vec, s);
  if (w_bf16)
    return launch_gmm<float, __nv_bfloat16>(x, w, o, E, C, D, F, row_tile,
                                            vec, s);
  return launch_gmm<float, float>(x, w, o, E, C, D, F, row_tile, vec, s);
}

// The tensor-core route: x (E,C,D), w (E,D,F), o (E,C,F), all bf16 and
// contiguous, D and F multiples of 8 and bases 16-byte aligned (the
// wrapper's `gmm_route` checks this first).  Returns the launch's
// cudaError_t.
extern "C" int moe_gmm_wgmma(const void* x, const void* w, void* o, int E,
                             int C, int D, int F, void* stream) {
  if (E < 0 || C < 0 || D < 0 || F < 0 || E > 65535 || D % 8 || F % 8 ||
      (F + kTcBN - 1) / kTcBN > 65535 ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
       reinterpret_cast<uintptr_t>(o)) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  if (E == 0 || C == 0 || F == 0) return static_cast<int>(cudaGetLastError());
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        moe_gmm_kernel_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kTcSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  CUtensorMap tx, tw;
  const uint64_t xd[3] = {static_cast<uint64_t>(D), static_cast<uint64_t>(C),
                          static_cast<uint64_t>(E)};
  const int64_t xs[2] = {2LL * D, 2LL * C * D};
  const uint32_t xbox[3] = {hopper::kBoxElems, kTcBM, 1};
  const uint64_t wd[3] = {static_cast<uint64_t>(F), static_cast<uint64_t>(D),
                          static_cast<uint64_t>(E)};
  const int64_t ws[2] = {2LL * F, 2LL * D * F};
  const uint32_t wbox[3] = {hopper::kBoxElems, kTcBK, 1};
  int err = hopper::make_tensor_map(&tx, x, 3, xd, xs, xbox);
  if (!err) err = hopper::make_tensor_map(&tw, w, 3, wd, ws, wbox);
  if (err) return err;
  const dim3 grid((C + kTcBM - 1) / kTcBM, (F + kTcBN - 1) / kTcBN, E);
  moe_gmm_kernel_wgmma<<<grid, kTcThreads, kTcSmem,
                         static_cast<cudaStream_t>(stream)>>>(
      tx, tw, static_cast<__nv_bfloat16*>(o), C, D, F);
  return static_cast<int>(cudaGetLastError());
}
