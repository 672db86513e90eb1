// CUDA kernels for the campaign sweep's per-tick ops (sm_90a).
//
// The sweep engine (repro_torch/core/sweep_torch.py) keeps B campaigns
// as count planes: how many instances sit in each (lane, group,
// progress-step) cell.  Its hot per-tick phases are the three kernels
// below.  Each is bound through a plain C entry point that launches on
// the caller's stream, allocates nothing, and returns
// cudaGetLastError() so the Python wrapper can raise on a refused
// launch.
//
// Rounding: the allocator is exact only if `inc*s + 1e-3` is rounded as
// two IEEE operations, as the JAX reference computes it.  nvcc would
// contract the pair into one FMA, so every float operation here is an
// explicit round-to-nearest intrinsic (__fmul_rn, __fadd_rn, __fsub_rn,
// __fdiv_rn), which nvcc never contracts.  Never build with
// --use_fast_math.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

inline int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

// ---------------------------------------------------------------------------
// campaign_alloc: the proportional integer allocator.
//
// Replaces the TPU kernel body `_alloc_body` behind both
// `campaign_preempt_kernel` and `campaign_match_kernel`
// (repro/kernels/campaign_sweep.py:45-79).
//
// Bound on an H100: bytes.  A row of C <= 18 int32 cells plus its k is
// read once and C cells are written once (about 1.5 MB per call on the
// main path, R = 10,200 rows), a fraction of a microsecond at
// 3.35 TB/s; the work per cell is a handful of flops.  At this size the
// launch itself costs more than either bound.
//
// Design: one thread per row, so the running sum along the row is a
// serial loop in registers and no cross-thread scan or shared memory is
// needed (on the TPU a program saw whole rows for the same reason).  The
// row is read twice, once for its total and once for the split; the
// second read hits L1/L2.  Neighbouring threads read rows C ints apart,
// so loads are not coalesced; at 1.5 MB that costs little next to the
// launch, and a later change can stage rows through shared memory.
__global__ void campaign_alloc_kernel(const int* __restrict__ counts,
                                      const int* __restrict__ k,
                                      int* __restrict__ out, int R, int C) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const int* row = counts + static_cast<long long>(r) * C;
  int* orow = out + static_cast<long long>(r) * C;
  int tot = 0;
  for (int c = 0; c < C; ++c) tot += row[c];
  const int kk = min(k[r], tot);
  const float s = __fdiv_rn(__int2float_rn(kk), __int2float_rn(max(tot, 1)));
  int run = 0;
  for (int c = 0; c < C; ++c) {
    const int x = row[c];
    run += x;
    const float inc = __int2float_rn(run);
    const float exc = __fsub_rn(inc, __int2float_rn(x));
    const float hi = floorf(__fadd_rn(__fmul_rn(inc, s), 1e-3f));
    const float lo = floorf(__fadd_rn(__fmul_rn(exc, s), 1e-3f));
    orow[c] = static_cast<int>(__fsub_rn(hi, lo));
  }
}

// ---------------------------------------------------------------------------
// campaign_advance: pilot progress sync.
//
// Replaces `campaign_advance_kernel` / `_advance_body`
// (repro/kernels/campaign_sweep.py:82-106).
//
// Bound on an H100: bytes.  busy and the finish mask (R x W int32) are
// read once, advanced (R x W) and finished (R) written once: about
// 1.3 MB per call on the main path (R = 10,200, W = 16); integer adds
// only.
//
// Design: one thread per row walks the W steps once, carrying the
// previous step's survivors in a register, so the shift needs neither a
// roll nor a mask (the TPU kernel's gather-free roll + iota mask) and
// the row sum of finishes falls out of the same pass.
__global__ void campaign_advance_kernel(const int* __restrict__ busy,
                                        const int* __restrict__ fin_mask,
                                        int* __restrict__ advanced,
                                        int* __restrict__ finished, int R,
                                        int W) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const long long base = static_cast<long long>(r) * W;
  int done = 0;
  int carry = 0;  // survivors of step w-1, moving into step w
  for (int w = 0; w < W; ++w) {
    const int b = busy[base + w];
    const int f = b * fin_mask[base + w];
    done += f;
    advanced[base + w] = carry;
    carry = b - f;
  }
  finished[r] = done;
}

// ---------------------------------------------------------------------------
// campaign_bill: the billing / ledger reduction.
//
// Replaces `campaign_bill_kernel` / `_bill_body`
// (repro/kernels/campaign_sweep.py:109-133).
//
// Bound on an H100: bytes, and far below launch latency: live and rate
// (B x G) are read once, the (G x P) one-hot once per thread from cache,
// spent (B) and by_provider (B x P) written once, about 80 KB per call
// on the main path (B = 1,020, G = 10, P = 3).
//
// Design: one thread per lane.  amt = float(live) * rate, its row sum
// and the G x P product with the one-hot are computed in f32 in the
// kernel body, summing the groups left to right (the plain version's
// order), with no tensor cores and so no TF32 rounding.  The TPU
// kernel's matrix-unit dot is pointless at P = 3.
__global__ void campaign_bill_kernel(const int* __restrict__ live,
                                     const float* __restrict__ rate,
                                     const float* __restrict__ onehot,
                                     float* __restrict__ spent,
                                     float* __restrict__ by_prov, int B,
                                     int G, int P) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const long long base = static_cast<long long>(b) * G;
  float total = 0.0f;
  for (int g = 0; g < G; ++g)
    total = __fadd_rn(total, __fmul_rn(__int2float_rn(live[base + g]),
                                       rate[base + g]));
  spent[b] = total;
  for (int p = 0; p < P; ++p) {
    float acc = 0.0f;
    for (int g = 0; g < G; ++g) {
      const float amt = __fmul_rn(__int2float_rn(live[base + g]),
                                  rate[base + g]);
      acc = __fadd_rn(acc, __fmul_rn(amt, onehot[g * P + p]));
    }
    by_prov[static_cast<long long>(b) * P + p] = acc;
  }
}

}  // namespace

// -- C entry points (bound with ctypes) --------------------------------------

extern "C" int campaign_alloc(const int* counts, const int* k, int* out,
                              int R, int C, void* stream) {
  if (R > 0)
    campaign_alloc_kernel<<<blocks_for(R), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        counts, k, out, R, C);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int campaign_advance(const int* busy, const int* fin_mask,
                                int* advanced, int* finished, int R, int W,
                                void* stream) {
  if (R > 0)
    campaign_advance_kernel<<<blocks_for(R), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        busy, fin_mask, advanced, finished, R, W);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int campaign_bill(const int* live, const float* rate,
                             const float* onehot, float* spent,
                             float* by_prov, int B, int G, int P,
                             void* stream) {
  if (B > 0)
    campaign_bill_kernel<<<blocks_for(B), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        live, rate, onehot, spent, by_prov, B, G, P);
  return static_cast<int>(cudaGetLastError());
}
