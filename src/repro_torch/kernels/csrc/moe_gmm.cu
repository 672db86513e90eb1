// Grouped (per-expert) matrix product for the MoE expert FFN (sm_90a).
//
// Replaces the TPU kernel `moe_gmm_kernel` / `_gmm_kernel`
// (repro/kernels/moe_gmm.py:22-59).  It computes what the Pallas kernel
// computes:
//
//   o[e] = x[e] @ w[e],  x (E,C,D), w (E,D,F) -> o (E,C,F),
//
// every product and the sum over D in f32, the output cast to x's type.
// x and w are each f32 or bf16, read in their own type and converted in
// registers; o has x's type (bf16 by round to nearest even, as torch's
// cast).  The model calls it three times per MoE layer on the capacity
// buffer (gate, up: D -> F; down: F -> D).
//
// Bound on an H100: operations.  At the jamba-v0.1-52b shape (E=16,
// C=1280, D=4096, F=14336) one product is 2*E*C*D*F = 2.4 TFLOP against
// 2.0 GB of bf16 operands: 2.4 ms at the 989 TFLOP/s bf16 tensor-core
// rate.  This first version runs the products on the CUDA cores in f32
// (no tensor cores), so its own floor is the 67 TFLOP/s f32 rate, ~36 ms.
// wgmma, TMA and a pipelined ring of tiles are the lever for a later
// change.
//
// Design: one block of 256 threads per (expert, 64-row x 64-column tile
// of the C x F output).  The TPU kernel carried an f32 accumulator in
// VMEM scratch across a sequential K grid axis; here the block loops over
// K (= D) in tiles of 16 itself, staging the x tile (transposed, f32) and
// the w tile (f32) in shared memory, and each thread keeps a 4 x 4 f32
// micro-tile of the output in registers.  Per K step a thread reads one
// float4 of x and one of w from shared memory for 16 FMAs.  Ragged C, D
// and F are masked in the kernel (zeros in shared memory add nothing), so
// nothing is padded in device memory.  Offsets are 64-bit: one jamba
// expert tensor holds 939.5 M elements.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

// -- C entry point (bound with ctypes) ---------------------------------------
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
