// Mamba selective scan (S6) for the hybrid models (sm_90a).
//
// Replaces the TPU kernel `mamba_scan_kernel` / `_mamba_kernel`
// (repro/kernels/mamba_scan.py:25-76).  It computes what the Pallas
// kernel computes, from a zero state:
//
//   h_t = exp(dt_t * A) (.) h_{t-1} + (dt_t * x_t) B_t    (di x N state)
//   y_t = sum_N h_t (.) C_t
//
// over xc/dt (B,S,di), bm/cm (B,S,N) and A (di,N); y (B,S,di) is taken
// before the gate and the D skip.  All arithmetic is f32; each of the
// four streams is f32 or bf16, read in its own type (in the model dt and
// Cm are f32 while xc and Bm are in the compute type); y has xc's type.
// exp is `expf`, not the fast `__expf`.
//
// Bound on an H100: bytes.  At the jamba-v0.1-52b shape (B=2, S=4096,
// di=8192, N=16) the kernel must read xc and dt and write y, 3 x 268 MB
// in f32: 0.24 ms at 3.35 TB/s, against 1.1 G state updates (~8 FLOP
// and one exp each).  The (S, di, N) expansion never touches device
// memory, which is the point of the kernel.
//
// Design: the TPU kernel kept a (block_d, N) state in VMEM scratch across
// a sequential grid axis over chunks of S.  Here blocks run in parallel
// over (channel group, batch) only and each thread walks all of S
// itself: one thread per (b, channel, n) holds its state h in a
// register, so at jamba's B=2 there are 262 k threads (one per channel
// would give 16 k, too few for 132 SMs).  The N states of a channel sit
// in P = next power of two >= N (at least 8) neighbouring lanes of one
// warp, and y_t is a shuffle-xor sum over those lanes.  Each pass stages
// 32 steps of Bm and Cm (shared by every channel of the block) and of xc
// and dt (for the block's channels) in shared memory with coalesced
// loads, and stages y for one coalesced write per pass.  Non-power-of-two
// di is masked in the kernel; lanes n >= N carry a zero state.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSteps = 32;       // time steps staged per pass
constexpr int kMinLanes = 8;     // lanes per channel, at least
constexpr int kMaxState = 32;    // N fits one warp
constexpr int kMaxChannels = kThreads / kMinLanes;

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

// `types` bit i is 1 where stream i (xc, dt, bm, cm) is bf16; y has xc's
// type.  `lanes` = P, the lanes per channel (a power of two, 8..32).
__global__ void __launch_bounds__(kThreads)
    mamba_scan_kernel(const void* __restrict__ xc,
                      const void* __restrict__ dt,
                      const void* __restrict__ bm,
                      const void* __restrict__ cm,
                      const float* __restrict__ a, void* __restrict__ y,
                      int types, int S, int di, int N, int lanes) {
  __shared__ float bs[kSteps][kMaxState];
  __shared__ float cs[kSteps][kMaxState];
  __shared__ float xs[kSteps][kMaxChannels];
  __shared__ float ds[kSteps][kMaxChannels];
  __shared__ float ys[kSteps][kMaxChannels];

  const int x_bf16 = types & 1, dt_bf16 = (types >> 1) & 1;
  const int b_bf16 = (types >> 2) & 1, c_bf16 = (types >> 3) & 1;
  const int channels = kThreads / lanes;   // channels per block
  const int tid = threadIdx.x;
  const int n = tid % lanes;
  const int cl = tid / lanes;              // the block's channel
  const int ch0 = blockIdx.x * channels;
  const int ch = ch0 + cl;
  const int b = blockIdx.y;
  const bool live = ch < di && n < N;
  const float an = live ? a[static_cast<long long>(ch) * N + n] : 0.0f;
  const long long row0 = static_cast<long long>(b) * S;  // (b, t=0) row

  float h = 0.0f;
  for (int t0 = 0; t0 < S; t0 += kSteps) {
    const int steps = min(kSteps, S - t0);
    __syncthreads();  // the last pass's readers and writers are done
    for (int i = tid; i < steps * N; i += kThreads) {
      const int t = i / N;
      const long long at = (row0 + t0 + t) * N + i % N;
      bs[t][i % N] = load(bm, b_bf16, at);
      cs[t][i % N] = load(cm, c_bf16, at);
    }
    for (int i = tid; i < steps * channels; i += kThreads) {
      const int t = i / channels;
      const int c = i % channels;
      float xv = 0.0f, dv = 0.0f;
      if (ch0 + c < di) {
        const long long at = (row0 + t0 + t) * di + ch0 + c;
        xv = load(xc, x_bf16, at);
        dv = load(dt, dt_bf16, at);
      }
      xs[t][c] = xv;
      ds[t][c] = dv;
    }
    __syncthreads();

    for (int t = 0; t < steps; ++t) {
      const float d = ds[t][cl];
      const float bn = n < N ? bs[t][n] : 0.0f;
      const float cn = n < N ? cs[t][n] : 0.0f;
      h = expf(d * an) * h + (d * xs[t][cl]) * bn;
      float yv = h * cn;
      for (int off = lanes / 2; off > 0; off >>= 1)
        yv += __shfl_xor_sync(0xffffffffu, yv, off);
      if (n == 0) ys[t][cl] = yv;
    }
    __syncthreads();

    for (int i = tid; i < steps * channels; i += kThreads) {
      const int t = i / channels;
      const int c = i % channels;
      if (ch0 + c < di)
        store(y, x_bf16, (row0 + t0 + t) * di + ch0 + c, ys[t][c]);
    }
  }
}

}  // namespace

// -- C entry point (bound with ctypes) ---------------------------------------
//
// xc/dt (B,S,di), bm/cm (B,S,N), a (di,N) f32, y (B,S,di), all contiguous;
// `types` as the kernel's.  Requires 1 <= N <= 32.  Returns the launch's
// cudaError_t.
extern "C" int mamba_scan(const void* xc, const void* dt, const void* bm,
                          const void* cm, const float* a, void* y,
                          int types, int B, int S, int di, int N,
                          void* stream) {
  if (N < 1 || N > kMaxState || B < 0 || S < 0 || di < 0 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || S == 0 || di == 0) return static_cast<int>(cudaGetLastError());
  int lanes = kMinLanes;
  while (lanes < N) lanes *= 2;
  const int channels = kThreads / lanes;
  const dim3 grid((di + channels - 1) / channels, B);
  mamba_scan_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      xc, dt, bm, cm, a, y, types, S, di, N, lanes);
  return static_cast<int>(cudaGetLastError());
}
