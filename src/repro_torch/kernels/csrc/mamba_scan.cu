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
// Bounds on an H100 SXM at the jamba-v0.1-52b shape (B=2, S=4096,
// di=8192, N=16, the model's stream mix): bytes, 0.161 ms at 3.35 TB/s
// for reading xc, dt, Bm, Cm and A and writing y; but the scan needs one
// exp per state update, 2 x 4096 x 8192 x 16 = 1.07 G of them, and the
// special-function unit takes 16 a clock per SM: 0.26-0.29 ms on 132 SMs
// at 1.98-1.755 GHz.  That floor, not the bytes, bounds the kernel.  The
// (S, di, N) expansion never touches device memory, which is the point of
// the kernel.
//
// Design: the TPU kernel kept a (block_d, N) state in VMEM scratch across
// a sequential grid axis over chunks of S.  Here one thread owns one
// (batch, channel) and all its N states, in registers; the kernel is
// templated on the padded state size P (8, 16 or 32), and states n >= N
// carry A = B = C = 0, so they stay 0.  A step's P updates are
// independent, so their P exps pipeline through the special-function
// unit while the h chain is one multiply-add a step; y_t is a sum inside
// the thread (no shuffles, no lane-0 store), and A's row stays in
// registers.  A block of 64 channels stages 32 steps of xc and dt (its
// channels) and of Bm and Cm (shared by every channel) in shared memory in
// their own types, double-buffered with cp.async so the next tile loads
// while this one is scanned, widens the tile to f32 once (the step loop
// has no type branches), and writes y back from it with 16-byte stores.
// Where a row is not 16-byte aligned (di or N off the vector width) the
// tile is staged element by element instead.  Non-multiple di and a last
// tile past S are masked in the kernel.
//
// Segments.  With few (batch, channel) pairs one thread each leaves the
// card waiting on the step chain, so the wrapper may cut S into segments
// (`seg_len` steps each, its rule in ops.scan_segment_len): each is
// scanned from a zero state (FIXUP = 0), keeping h and sum(dt) at its end;
// a second launch (FIXUP = 1) carries h over the segments before each one
// and adds C_t . exp(A cumdt_t) h_in to y.  The fix-up costs one exp per
// state and step, as the scan does, so it pays only where the scan alone
// is latency-bound (B=1 at jamba's width: 1.01 ms in 9 segments against
// 1.35 ms whole; at B=2 whole is faster, 1.22-1.36 ms against 1.72-2.03;
// NVIDIA H100 80GB HBM3, 700 W).  That more threads buy nothing at B=2
// points to instruction issue as what bounds the step loop (`expf` costs
// a dozen or more instructions beside its one special-function op), above
// both floors; no profiler that counts instructions runs on that machine.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 64;     // channels per block, one per thread
constexpr int kSteps = 32;       // time steps per tile
constexpr int kMaxState = 32;
constexpr int kXBytes = kSteps * kThreads * 4;  // an xc or dt tile, f32

// shared memory: two raw tiles in flight (each stream in its own type,
// sized for f32) and one f32 working tile, each xc | dt | Bm | Cm
template <int P>
struct Tile {
  static constexpr int kBytes = 2 * kXBytes + 2 * kSteps * P * 4;
  static constexpr int kSmem = 3 * kBytes;
};

struct ScanArgs {
  const void* xc;        // the scan reads xc; the fix-up reads y here
  const void* dt;
  const void* bm;
  const void* cm;
  const float* a;
  void* y;
  float* carry;          // [B][segments][P + 1][di]: h at a segment's end,
                         // then its sum of dt
  int types;             // bit i: stream i (xc, dt, bm, cm) is bf16
  int vec;               // bit i: stream i is staged with 16-byte copies
  int S, di, N, seg_len, segments;
};

__device__ __forceinline__ float load(const void* p, int bf16, long long i) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

using hopper::cp16;
using hopper::cp_commit;
using hopper::cp_wait;

// steps [t0, t0 + steps) of a (B, S, width) stream, columns [c0, c0 + cols)
// of each row, into dst[t][0..cols) in the stream's type (row pitch
// `cols`); rows past `steps` and columns past `width` are zeros.  16-byte
// cp.async copies where `vec` (width * esize a multiple of 16, base
// aligned), element loads otherwise.
__device__ __forceinline__ void stage(uint8_t* dst, const void* src, int bf16,
                                      bool vec, long long row0, int steps,
                                      int width, int c0, int cols) {
  const int es = bf16 ? 2 : 4;
  if (vec) {
    const int per_row = cols * es / 16;
    for (int i = threadIdx.x; i < kSteps * per_row; i += kThreads) {
      const int t = i / per_row, q = i % per_row;
      const int c = c0 + q * 16 / es;           // first column of the chunk
      const bool live = t < steps && c < width;
      const char* g = static_cast<const char*>(src) +
                      ((row0 + (live ? t : 0)) * width + (live ? c : 0)) * es;
      cp16(dst + (t * cols) * es + q * 16, g, live ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < kSteps * cols; i += kThreads) {
      const int t = i / cols, c = c0 + i % cols;
      float v = 0.0f;
      if (t < steps && c < width) v = load(src, bf16, (row0 + t) * width + c);
      if (bf16)
        reinterpret_cast<__nv_bfloat16*>(dst)[i] = __float2bfloat16(v);
      else
        reinterpret_cast<float*>(dst)[i] = v;
    }
  }
}

// a raw staged tile of n values to f32
__device__ __forceinline__ void widen(float* dst, const uint8_t* src, int bf16,
                                      int n) {
  if (bf16) {
    for (int i = threadIdx.x; i < n / 2; i += kThreads) {
      const __nv_bfloat162 v =
          reinterpret_cast<const __nv_bfloat162*>(src)[i];
      reinterpret_cast<float2*>(dst)[i] = __bfloat1622float2(v);
    }
  } else {
    for (int i = threadIdx.x; i < n / 4; i += kThreads)
      reinterpret_cast<float4*>(dst)[i] =
          reinterpret_cast<const float4*>(src)[i];
  }
}

// y (f32 working tile, [t][channel]) to (B, S, di) in xc's type: 16-byte
// stores of 8 (bf16) or 4 (f32) channels where `vec`, elements otherwise
__device__ __forceinline__ void unstage(void* y, const float* src, int bf16,
                                        bool vec, long long row0, int steps,
                                        int di, int c0) {
  if (vec) {
    const int per = bf16 ? 8 : 4;                 // channels a store
    const int per_row = kThreads / per;
    for (int i = threadIdx.x; i < steps * per_row; i += kThreads) {
      const int t = i / per_row, q = i % per_row;
      const int c = c0 + q * per;
      if (c >= di) continue;
      const float* v = src + t * kThreads + q * per;
      uint4 out;
      if (bf16) {
        uint32_t* w = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          __nv_bfloat162 pr = __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
          w[e] = *reinterpret_cast<uint32_t*>(&pr);
        }
        *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(y) +
                                  (row0 + t) * di + c) = out;
      } else {
        *reinterpret_cast<float4*>(static_cast<float*>(y) + (row0 + t) * di +
                                   c) = *reinterpret_cast<const float4*>(v);
      }
    }
  } else {
    for (int i = threadIdx.x; i < steps * kThreads; i += kThreads) {
      const int t = i / kThreads, c = c0 + i % kThreads;
      if (c >= di) continue;
      if (bf16)
        static_cast<__nv_bfloat16*>(y)[(row0 + t) * di + c] =
            __float2bfloat16(src[i]);
      else
        static_cast<float*>(y)[(row0 + t) * di + c] = src[i];
    }
  }
}

// FIXUP = 0: the scan of one segment of S from a zero state, y' into y,
// and (before the last segment) h and sum(dt) at its end into `carry`.
// FIXUP = 1 (segments 1..): h entering the segment from the carries of the
// segments before it, then y_t += sum_n C_t,n exp(A_n cumdt_t) h_in,n,
// cumdt_t the sum of dt from the segment's start through t.
template <int P, int FIXUP>
__global__ void __launch_bounds__(kThreads)
    mamba_scan_kernel(const ScanArgs p) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int xb = p.types & 1, db = (p.types >> 1) & 1;
  const int bb = (p.types >> 2) & 1, cb = (p.types >> 3) & 1;
  const bool vx = p.vec & 1, vd = (p.vec >> 1) & 1;
  const bool vb = (p.vec >> 2) & 1, vc = (p.vec >> 3) & 1;
  const int tid = threadIdx.x;
  const int c0 = blockIdx.x * kThreads;
  const int ch = c0 + tid;
  const int b = blockIdx.y;
  const int g = blockIdx.z + FIXUP;            // this block's segment
  const int s0 = g * p.seg_len;
  const int s1 = min(p.S, s0 + p.seg_len);
  const long long row0 = static_cast<long long>(b) * p.S + s0;
  const int n_tiles = (s1 - s0 + kSteps - 1) / kSteps;
  const long long carry_stride = static_cast<long long>(P + 1) * p.di;
  float* carry = p.carry + static_cast<long long>(b) * p.segments *
                               carry_stride + ch;

  float an[P], h[P];
#pragma unroll
  for (int n = 0; n < P; ++n) {
    an[n] = ch < p.di && n < p.N ? p.a[static_cast<long long>(ch) * p.N + n]
                                 : 0.0f;
    h[n] = 0.0f;
  }
  if (FIXUP && ch < p.di) {
    // h entering segment g: carry h over the segments before it
    for (int q = 0; q < g; ++q) {
      const float* cq = carry + q * carry_stride;
      const float sd = cq[P * static_cast<long long>(p.di)];
#pragma unroll
      for (int n = 0; n < P; ++n)
        h[n] = expf(an[n] * sd) * h[n] + cq[n * static_cast<long long>(p.di)];
    }
  }

  uint8_t* work = smem + 2 * Tile<P>::kBytes;
  float* xf = reinterpret_cast<float*>(work);
  const float* df = xf + kSteps * kThreads;
  const float* bf = df + kSteps * kThreads;
  const float* cf = bf + kSteps * P;
  auto issue = [&](int i) {
    uint8_t* s = smem + (i % 2) * Tile<P>::kBytes;
    const int t0 = i * kSteps;
    const int steps = min(kSteps, s1 - s0 - t0);
    stage(s, FIXUP ? p.y : p.xc, xb, vx, row0 + t0, steps, p.di, c0,
          kThreads);
    stage(s + kXBytes, p.dt, db, vd, row0 + t0, steps, p.di, c0, kThreads);
    if (!FIXUP)
      stage(s + 2 * kXBytes, p.bm, bb, vb, row0 + t0, steps, p.N, 0, P);
    stage(s + 2 * kXBytes + kSteps * P * 4, p.cm, cb, vc, row0 + t0, steps,
          p.N, 0, P);
    cp_commit();
  };

  float sd = 0.0f;                             // sum of dt so far
  issue(0);
  for (int i = 0; i < n_tiles; ++i) {
    if (i + 1 < n_tiles) {
      issue(i + 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const uint8_t* s = smem + (i % 2) * Tile<P>::kBytes;
    widen(xf, s, xb, kSteps * kThreads);
    widen(xf + kSteps * kThreads, s + kXBytes, db, kSteps * kThreads);
    if (!FIXUP)
      widen(xf + 2 * kSteps * kThreads, s + 2 * kXBytes, bb, kSteps * P);
    widen(xf + 2 * kSteps * kThreads + kSteps * P,
          s + 2 * kXBytes + kSteps * P * 4, cb, kSteps * P);
    __syncthreads();
    const int steps = min(kSteps, s1 - s0 - i * kSteps);
#pragma unroll 2
    for (int t = 0; t < steps; ++t) {
      const float d = df[t * kThreads + tid];
      const float4* c4 = reinterpret_cast<const float4*>(cf + t * P);
      float yv = 0.0f;
      if (FIXUP) {
        sd += d;
#pragma unroll
        for (int q = 0; q < P / 4; ++q) {
          const float4 cv = c4[q];
          yv += cv.x * (expf(an[4 * q] * sd) * h[4 * q]);
          yv += cv.y * (expf(an[4 * q + 1] * sd) * h[4 * q + 1]);
          yv += cv.z * (expf(an[4 * q + 2] * sd) * h[4 * q + 2]);
          yv += cv.w * (expf(an[4 * q + 3] * sd) * h[4 * q + 3]);
        }
        xf[t * kThreads + tid] += yv;          // y' + the entering state's
      } else {
        sd += d;
        const float dx = d * xf[t * kThreads + tid];
        const float4* b4 = reinterpret_cast<const float4*>(bf + t * P);
#pragma unroll
        for (int q = 0; q < P / 4; ++q) {
          const float4 bv = b4[q], cv = c4[q];
          h[4 * q] = expf(d * an[4 * q]) * h[4 * q] + dx * bv.x;
          h[4 * q + 1] = expf(d * an[4 * q + 1]) * h[4 * q + 1] + dx * bv.y;
          h[4 * q + 2] = expf(d * an[4 * q + 2]) * h[4 * q + 2] + dx * bv.z;
          h[4 * q + 3] = expf(d * an[4 * q + 3]) * h[4 * q + 3] + dx * bv.w;
          yv += h[4 * q] * cv.x + h[4 * q + 1] * cv.y + h[4 * q + 2] * cv.z +
                h[4 * q + 3] * cv.w;
        }
        xf[t * kThreads + tid] = yv;           // y_t in x_t's slot
      }
    }
    __syncthreads();
    unstage(p.y, xf, xb, vx, row0 + i * kSteps, steps, p.di, c0);
  }
  if (!FIXUP && g + 1 < p.segments && ch < p.di) {
#pragma unroll
    for (int n = 0; n < P; ++n)
      carry[g * carry_stride + n * static_cast<long long>(p.di)] = h[n];
    carry[g * carry_stride + P * static_cast<long long>(p.di)] = sd;
  }
}

template <int P, int FIXUP>
int launch(const ScanArgs& args, int B, int blocks_z, cudaStream_t stream) {
  constexpr int bytes = Tile<P>::kSmem;
  static bool configured = false;             // one flag per instantiation
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        mamba_scan_kernel<P, FIXUP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid((args.di + kThreads - 1) / kThreads, B, blocks_z);
  mamba_scan_kernel<P, FIXUP><<<grid, kThreads, bytes, stream>>>(args);
  return static_cast<int>(cudaGetLastError());
}

template <int P>
int launch_all(const ScanArgs& args, int B, cudaStream_t stream) {
  int err = launch<P, 0>(args, B, args.segments, stream);
  if (!err && args.segments > 1)
    err = launch<P, 1>(args, B, args.segments - 1, stream);
  return err;
}

bool aligned(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// -- C entry point (bound with ctypes) ---------------------------------------
//
// xc/dt (B,S,di), bm/cm (B,S,N), a (di,N) f32, y (B,S,di), all contiguous;
// `types` as the kernel's.  The sequence is scanned in `segments` pieces
// of `seg_len` steps (a multiple of 32; segments = ceil(S / seg_len)):
// with more than one, `carry` holds B * segments * (P + 1) * di floats,
// P = 8, 16 or 32 the padded N, and a second launch adds each segment's
// entering state.  Requires 1 <= N <= 32.  Returns the first launch error.
extern "C" int mamba_scan(const void* xc, const void* dt, const void* bm,
                          const void* cm, const float* a, void* y,
                          float* carry, int types, int B, int S, int di,
                          int N, int seg_len, void* stream) {
  if (N < 1 || N > kMaxState || B < 0 || S < 0 || di < 0 || B > 65535 ||
      seg_len < kSteps || seg_len % kSteps)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || S == 0 || di == 0) return static_cast<int>(cudaGetLastError());
  const int segments = (S + seg_len - 1) / seg_len;
  if (segments > 1 && carry == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const int P = N <= 8 ? 8 : N <= 16 ? 16 : 32;
  auto es = [&](int i) { return (types >> i) & 1 ? 2 : 4; };
  ScanArgs args;
  args.xc = xc;
  args.dt = dt;
  args.bm = bm;
  args.cm = cm;
  args.a = a;
  args.y = y;
  args.carry = carry;
  args.types = types;
  // 16-byte staging where every row starts on a 16-byte boundary (y shares
  // xc's type and staging); Bm and Cm also need N == P
  args.vec = (di * es(0) % 16 == 0 && aligned(xc) && aligned(y)) |
             (di * es(1) % 16 == 0 && aligned(dt)) << 1 |
             (N == P && N * es(2) % 16 == 0 && aligned(bm)) << 2 |
             (N == P && N * es(3) % 16 == 0 && aligned(cm)) << 3;
  args.S = S;
  args.di = di;
  args.N = N;
  args.seg_len = seg_len;
  args.segments = segments;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (P == 8) return launch_all<8>(args, B, s);
  if (P == 16) return launch_all<16>(args, B, s);
  return launch_all<32>(args, B, s);
}
