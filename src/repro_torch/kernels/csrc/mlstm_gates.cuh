// The gate pass and the scratch of the two-phase chunkwise mLSTM, shared
// by both of its routes (mlstm_chunk.cu on the CUDA cores,
// mlstm_chunk_wgmma.cu on the tensor cores).  Each route instantiates
// `gate_pass` as a kernel of its own name, so a profiler trace tells the
// routes apart; the code is this one.
//
// Per (batch, head), over chunks of `chunk` steps, with F = cumsum(logf)
// inside a chunk, a = logi - F, M = max(m0, cummax a), m_new = F + M, m0
// the stabilizer entering the chunk (0 before the first) and Mc = M at the
// chunk's last row:
//   planes (each (B*H, n_chunks * kL) f32, row c * kL + r of chunk c):
//     kA      a
//     kM      M
//     kWState exp(m0 - M)          (the weight of the entering state)
//     kFloor  exp(-m_new)          (the denominator's floor)
//     kWEnd   exp(a - Mc)          (row j's weight in the state update)
//   per chunk (4 floats): kM0 = m0, kMc = Mc, kDecay = exp(m0 - Mc).
// Rows past a chunk's end get neutral values (a, M, the weights 0, the
// floor 1).  All f32, `expf`, no fast math.
//
// The scratch, one buffer the wrapper allocates (1024-byte aligned): the
// planes, the per-chunk values, n entering every chunk (f32,
// (B*H, n_chunks, dqk_pad)) and C entering every chunk ((B*H, n_chunks,
// dqk_pad, dv_pad) in the route's element: bf16 on the tensor cores, f32
// on the CUDA cores).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace mlstm {

constexpr int kL = 128;            // rows of a chunk tile: the largest chunk
constexpr int kDqkTile = 64;       // dqk_pad is a multiple of this
constexpr int kDvTile = 128;       // dv_pad is a multiple of this
constexpr int kGateThreads = 256;

enum Stream { kQ = 0, kK, kV, kLi, kLf, kO, kStreams };
enum Plane { kA = 0, kM, kWState, kFloor, kWEnd, kPlanes };
enum ChunkVal { kM0 = 0, kMc, kDecay, kChunkVals = 4 };

struct Dims {
  int B, H, S, dqk, dv, chunk, n_chunks, dqk_pad, dv_pad;
};

__host__ __device__ __forceinline__ long long round_up(long long x, int m) {
  return (x + m - 1) / m * m;
}

inline Dims make_dims(int B, int H, int S, int dqk, int dv, int chunk) {
  Dims d;
  d.B = B;
  d.H = H;
  d.S = S;
  d.dqk = dqk;
  d.dv = dv;
  d.chunk = chunk;
  d.n_chunks = (S + chunk - 1) / chunk;
  d.dqk_pad = static_cast<int>(round_up(dqk, kDqkTile));
  d.dv_pad = static_cast<int>(round_up(dv, kDvTile));
  return d;
}

struct Scratch {
  float* planes;          // [kPlanes][B*H][n_chunks * kL]
  float* chunks;          // [B*H][n_chunks][kChunkVals]
  float* n_in;            // [B*H][n_chunks][dqk_pad]
  void* c_in;             // [B*H][n_chunks][dqk_pad][dv_pad], c_bytes each
};

struct ScratchLayout {
  long long planes, chunks, n_in, c_in, total;
};

// byte offsets of the parts, C entering each chunk in `c_bytes` elements
inline ScratchLayout scratch_layout(const Dims& d, int c_bytes) {
  const long long bh = static_cast<long long>(d.B) * d.H;
  ScratchLayout s;
  s.planes = 0;
  s.chunks = round_up(s.planes + 4LL * kPlanes * bh * d.n_chunks * kL, 1024);
  s.n_in = round_up(s.chunks + 4LL * kChunkVals * bh * d.n_chunks, 1024);
  s.c_in = round_up(s.n_in + 4LL * bh * d.n_chunks * d.dqk_pad, 1024);
  s.total = s.c_in + static_cast<long long>(c_bytes) * bh * d.n_chunks *
                         d.dqk_pad * d.dv_pad;
  return s;
}

inline Scratch carve(void* base, const Dims& d, int c_bytes) {
  const ScratchLayout l = scratch_layout(d, c_bytes);
  char* p = static_cast<char*>(base);
  Scratch s;
  s.planes = reinterpret_cast<float*>(p + l.planes);
  s.chunks = reinterpret_cast<float*>(p + l.chunks);
  s.n_in = reinterpret_cast<float*>(p + l.n_in);
  s.c_in = p + l.c_in;
  return s;
}

__device__ __forceinline__ float load(const void* p, int bf16, long long i) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

struct GateParams {
  const void* li;
  const void* lf;
  long long st_li[3], st_lf[3];     // (batch, head, step) strides
  int li16, lf16;
  Dims d;
  Scratch s;
};

// `strides`: the C entries' 18 (batch, head, step) strides of q, k, v,
// logi, logf, o; `types` bits 3 and 4 mark bf16 logi / logf
inline GateParams gate_params(const void* li, const void* lf,
                              const long long* strides, int types,
                              const Dims& d, const Scratch& s) {
  GateParams g;
  g.li = li;
  g.lf = lf;
  for (int a = 0; a < 3; ++a) {
    g.st_li[a] = strides[3 * kLi + a];
    g.st_lf[a] = strides[3 * kLf + a];
  }
  g.li16 = (types >> kLi) & 1;
  g.lf16 = (types >> kLf) & 1;
  g.d = d;
  g.s = s;
  return g;
}

// the body of a route's gate kernel: one block of kGateThreads per
// (batch, head), blockIdx.x = b * H + h
__device__ __forceinline__ void gate_pass(const GateParams& p) {
  const Dims& d = p.d;
  const int bh = blockIdx.x;
  const int b = bh / d.H, h = bh % d.H;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const long long rows = static_cast<long long>(d.n_chunks) * kL;
  float* plane[kPlanes];
  for (int q = 0; q < kPlanes; ++q)
    plane[q] = p.s.planes + (q * static_cast<long long>(d.B) * d.H + bh) * rows;
  float* cv = p.s.chunks + static_cast<long long>(bh) * d.n_chunks * kChunkVals;
  const long long li0 = b * p.st_li[0] + h * p.st_li[1];
  const long long lf0 = b * p.st_lf[0] + h * p.st_lf[1];

  // (a) chunk-local scans, one warp per chunk: a = logi - F into kA, F into
  // kFloor and the prefix max of a into kM (both rewritten in (c)); the
  // chunk's F_end and max a into its kM0 / kMc slots
  constexpr int kPer = kL / 32;
  for (int c = warp; c < d.n_chunks; c += kGateThreads / 32) {
    const int t0 = c * d.chunk;
    const int len = min(d.chunk, d.S - t0);
    float f[kPer], a[kPer];
    float run = 0.0f;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int r = lane * kPer + i;
      float lfv = 0.0f, liv = 0.0f;
      if (r < len) {
        const long long at = static_cast<long long>(t0 + r);
        lfv = load(p.lf, p.lf16, lf0 + at * p.st_lf[2]);
        liv = load(p.li, p.li16, li0 + at * p.st_li[2]);
      }
      run += lfv;
      f[i] = run;
      a[i] = liv;
    }
    float incl = run;
#pragma unroll
    for (int off = 1; off < 32; off *= 2) {
      const float y = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += y;
    }
    float excl = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) excl = 0.0f;
    float mx = -CUDART_INF_F;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      f[i] += excl;
      a[i] -= f[i];
      mx = fmaxf(mx, a[i]);
    }
    float mincl = mx;
#pragma unroll
    for (int off = 1; off < 32; off *= 2) {
      const float y = __shfl_up_sync(0xffffffffu, mincl, off);
      if (lane >= off) mincl = fmaxf(mincl, y);
    }
    float run_max = __shfl_up_sync(0xffffffffu, mincl, 1);
    if (lane == 0) run_max = -CUDART_INF_F;
    const long long row0 = static_cast<long long>(c) * kL;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int r = lane * kPer + i;
      run_max = fmaxf(run_max, a[i]);
      plane[kA][row0 + r] = a[i];
      plane[kFloor][row0 + r] = f[i];
      plane[kM][row0 + r] = run_max;
      if (r == len - 1) {
        cv[c * kChunkVals + kM0] = f[i];        // F at the chunk's end
        cv[c * kChunkVals + kMc] = run_max;     // max of a over the chunk
      }
    }
  }
  __syncthreads();

  // (b) the scalar chain over the chunks: m0 entering each, Mc, exp(m0 - Mc)
  if (tid == 0) {
    float m0 = 0.0f;
    for (int c = 0; c < d.n_chunks; ++c) {
      float* v = cv + c * kChunkVals;
      const float f_end = v[kM0];
      const float mc = fmaxf(m0, v[kMc]);
      v[kM0] = m0;
      v[kMc] = mc;
      v[kDecay] = expf(m0 - mc);
      m0 = f_end + mc;                          // m_new at the chunk's end
    }
  }
  __syncthreads();

  // (c) every row's factors; rows past a chunk's end get neutral values
  for (long long i = tid; i < rows; i += kGateThreads) {
    const int c = static_cast<int>(i / kL), r = static_cast<int>(i % kL);
    const int len = min(d.chunk, d.S - c * d.chunk);
    const float m0 = cv[c * kChunkVals + kM0];
    const float mc = cv[c * kChunkVals + kMc];
    if (r < len) {
      const float a = plane[kA][i];
      const float M = fmaxf(m0, plane[kM][i]);
      const float m_new = plane[kFloor][i] + M;
      plane[kM][i] = M;
      plane[kWState][i] = expf(m0 - M);
      plane[kFloor][i] = expf(-m_new);
      plane[kWEnd][i] = expf(a - mc);
    } else {
      plane[kA][i] = 0.0f;
      plane[kM][i] = 0.0f;
      plane[kWState][i] = 0.0f;
      plane[kFloor][i] = 1.0f;
      plane[kWEnd][i] = 0.0f;
    }
  }
}

}  // namespace mlstm
