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
// rate.
//
// Two routes, chosen by the wrapper (kernels/ops.py `gmm_route`):
//
// * `moe_gmm_kernel_wgmma` (x and w bf16, D and F multiples of 8, bases
//   16-byte aligned): wgmma on the tensor cores fed by a TMA ring, below.
// * `moe_gmm_kernel` (everything else: f32, mixed types, unaligned
//   widths): f32 FMAs on the CUDA cores, whose floor is the 67 TFLOP/s
//   f32 rate.  One block of 256 threads per (expert, 64-row x 64-column
//   tile of the C x F output).  The TPU kernel carried an f32 accumulator
//   in VMEM scratch across a sequential K grid axis; here the block loops
//   over K (= D) in tiles of 16 itself, staging the x tile (transposed,
//   f32) and the w tile (f32) in shared memory, and each thread keeps a
//   4 x 4 f32 micro-tile of the output in registers.  Per K step a thread
//   reads one float4 of x and one of w from shared memory for 16 FMAs.
//
// Ragged C, D and F are masked in the kernels (zeros in shared memory
// add nothing), so nothing is padded in device memory.  Offsets are
// 64-bit: one jamba expert tensor holds 939.5 M elements.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr int kBM = 64;   // output rows (C) per block
constexpr int kBN = 64;   // output columns (F) per block
constexpr int kBK = 16;   // reduction depth (D) per shared-memory tile
constexpr int kThreads = 256;
constexpr int kTM = 4;    // rows per thread
constexpr int kTN = 4;    // columns per thread
constexpr int kAPad = 4;  // keeps float4 rows aligned, spreads the banks

static_assert((kBM / kTM) * (kBN / kTN) == kThreads, "thread tiling");
static_assert(kBM * kBK % kThreads == 0 && kBK * kBN % kThreads == 0,
              "tile loads");

__device__ __forceinline__ float load(const void* p, int bf16,
                                      long long i) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ void store(void* p, int bf16, long long i,
                                      float v) {
  if (bf16)
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16(v);
  else
    static_cast<float*>(p)[i] = v;
}

__global__ void __launch_bounds__(kThreads)
    moe_gmm_kernel(const void* __restrict__ x, const void* __restrict__ w,
                   void* __restrict__ o, int x_bf16, int w_bf16, int C,
                   int D, int F) {
  __shared__ __align__(16) float xs[kBK][kBM + kAPad];  // x tile, transposed
  __shared__ __align__(16) float ws[kBK][kBN];

  const int e = blockIdx.z;
  const int c0 = blockIdx.y * kBM;
  const int f0 = blockIdx.x * kBN;
  const int tid = threadIdx.x;
  const int tr = (tid / (kBN / kTN)) * kTM;  // first row of the micro-tile
  const int tc = (tid % (kBN / kTN)) * kTN;  // first column

  const long long x_base = static_cast<long long>(e) * C * D;
  const long long w_base = static_cast<long long>(e) * D * F;

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < D; k0 += kBK) {
    __syncthreads();  // the last tile's readers are done
    // x tile: 64 rows x 16 columns of D; a warp reads two rows of 16
#pragma unroll
    for (int r = 0; r < kBM * kBK / kThreads; ++r) {
      const int i = tid + r * kThreads;
      const int m = i / kBK;
      const int kk = i % kBK;
      float v = 0.0f;
      if (c0 + m < C && k0 + kk < D)
        v = load(x, x_bf16, x_base + static_cast<long long>(c0 + m) * D +
                                k0 + kk);
      xs[kk][m] = v;
    }
    // w tile: 16 rows of D x 64 columns; a warp reads 32 neighbours
#pragma unroll
    for (int r = 0; r < kBK * kBN / kThreads; ++r) {
      const int i = tid + r * kThreads;
      const int kk = i / kBN;
      const int n = i % kBN;
      float v = 0.0f;
      if (k0 + kk < D && f0 + n < F)
        v = load(w, w_bf16, w_base + static_cast<long long>(k0 + kk) * F +
                                f0 + n);
      ws[kk][n] = v;
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&xs[kk][tr]);
      const float4 b = *reinterpret_cast<const float4*>(&ws[kk][tc]);
      const float av[kTM] = {a.x, a.y, a.z, a.w};
      const float bv[kTN] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }

  const long long o_base = static_cast<long long>(e) * C * F;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int c = c0 + tr + i;
    if (c >= C) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int f = f0 + tc + j;
      if (f < F)
        store(o, x_bf16, o_base + static_cast<long long>(c) * F + f,
              acc[i][j]);
    }
  }
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
// select each input's type (0: f32, 1: bf16); o has x's type.  Returns
// the launch's cudaError_t.
extern "C" int moe_gmm(const void* x, const void* w, void* o, int x_bf16,
                       int w_bf16, int E, int C, int D, int F,
                       void* stream) {
  if (E < 0 || C < 0 || D < 0 || F < 0 || E > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (E == 0 || C == 0 || F == 0) return static_cast<int>(cudaGetLastError());
  const dim3 grid((F + kBN - 1) / kBN, (C + kBM - 1) / kBM, E);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  moe_gmm_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, w, o, x_bf16, w_bf16, C, D, F);
  return static_cast<int>(cudaGetLastError());
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
