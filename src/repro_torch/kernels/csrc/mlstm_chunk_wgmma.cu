// Chunkwise stabilized mLSTM on Hopper's tensor cores (sm_90a), bf16 q/k/v.
//
// Replaces the TPU kernel `mlstm_chunk_kernel` / `_mlstm_kernel`
// (repro/kernels/mlstm_chunk.py:22-99) for bf16 q, k and v; mlstm_chunk.cu
// (the CUDA-core kernel) serves f32 and the shapes this one refuses.  The
// math is the TPU kernel's, from a zero state (C = 0, n = 0, m0 = 0, not
// -inf): within a chunk of c steps, F = cumsum(logf), a = logi - F,
// M = max(m0, cummax a), m_new = F + M,
//
//   Dmask[t,j] = exp(a_j - M_t) for j <= t, else 0
//   h_t = (sum_j Dmask[t,j] (q_t . k_j) v_j + exp(m0 - M_t) q_t C0)
//         / max(|sum_j Dmask[t,j] (q_t . k_j) + exp(m0 - M_t) q_t . n0|,
//               exp(-m_new_t))
//
// and at the chunk's end, with Mc = M_{c-1} and w_j = exp(a_j - Mc),
// C1 = exp(m0 - Mc) C0 + sum_j w_j k_j v_j^T, n1 = exp(m0 - Mc) n0 +
// sum_j w_j k_j, m1 = m_new_{c-1}; k is scaled by dqk^-0.5.  `expf`, no
// fast math.
//
// Design.  Only the state (C, n, m) at chunk boundaries depends on earlier
// chunks; a chunk's outputs depend on nothing else once its entering state
// is known.  So one wrapper call launches three kernels on one stream:
//
//   1. mlstm_chunk_wgmma_gates, one block per (batch, head): the chunk-local
//      scans of the gates in parallel over chunks, then the scalar chain of
//      m0 and Mc over the chunks, then every row's factors (a, M,
//      exp(m0 - M), exp(-m_new), exp(a - Mc)) and every chunk's
//      exp(m0 - Mc), into a small f32 scratch;
//   2. mlstm_chunk_wgmma_states, one block (one warpgroup) per (batch*head,
//      64 dqk, 64 dv) tile: walks the chunks in order with its C tile in
//      f32 registers, C <- exp(m0 - Mc) C + (k (.) w)^T v as wgmma m64n64k16
//      (both operands MN-major from shared memory, k (.) w rounded to bf16
//      in place), fed by a 3-stage TMA ring of the chunks' k and v tiles;
//      before each chunk it writes the state entering it to a scratch of
//      (B*H, chunks, dqk, dv) in bf16, the type phase 3 feeds to the tensor
//      cores.  The blocks of the first dv tile also carry n (f32, from the
//      unrounded k (.) w) and write it per chunk;
//   3. mlstm_chunk_wgmma_outputs, one block per (batch*head, chunk, 128 dv)
//      tile, two consumer warpgroups of 64 rows: over 64-wide dqk tiles
//      (2-stage TMA ring of q, k and the entering state) S = q k^T
//      (m64n128k16) and O = q C_in (m64n128k16, C_in MN-major) on the
//      tensor cores, q . n0 in f32 on the CUDA cores; then the mask and the
//      decay in registers, the row sums and the denominator in f32, S~
//      rounded to bf16 as the register A operand of O = exp(m0 - M) O +
//      S~ v (m64n128k16), and h = O / den stored in bf16.
//
// q k^T is computed once per 128 dv columns (dv / 128 times per chunk),
// not once per 32 as in the CUDA-core kernel.  The new roundings are the
// bf16 operands k (.) w, S~ and C_in; the gates, their scans, n, the
// denominator and every accumulator are f32.
//
// Bound on an H100 SXM (data-sheet rates): bytes, for the function.  At
// xlstm-350m's shape (B*H = 8, S = 4096, dqk = dv = 512, c = 128) the
// work needed is 37.6 GFLOP (0.038 ms at 989 TFLOP/s) against 0.040 ms for
// reading q, k, v and the gates and writing h in bf16.  The design itself
// computes ~55 GFLOP (q k^T 4 times a chunk, q C_in over all of dqk, the
// full 128 x 128 tiles) and also writes and reads the state scratch: 134
// MB of bf16 each way at that shape, 0.080 ms more at 3.35 TB/s.
//
// Layouts: q, k, v, o and the gates are read through (batch, head, step)
// strides (the model's (B, S, H, d) or the kernel's (B*H, S, d)); q, k, v
// go through 4-D TMA maps (d, S, H, B), so the caller's views need no copy.
// Requires bf16 q, k, v, o with 16-byte-aligned bases and element strides
// that are multiples of 8; dqk, dv >= 1; 1 <= chunk <= 128.  Ragged edges
// (a last chunk past S, dqk or dv off the tiles) load as zeros through the
// TMA maps and are masked.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "hopper.cuh"

namespace {

constexpr int kL = 128;                   // rows of a chunk tile
constexpr int kBox = hopper::kBoxElems;   // 64 columns: one 128-byte row
constexpr int kRowTile = kL * 128;        // bytes of a 128-row x 64 box
constexpr int kGateThreads = 256;

enum Stream { kQ = 0, kK, kV, kLi, kLf, kO, kStreams };
// per-row factors, each a (B*H, chunks * kL) f32 plane
enum Plane { kA = 0, kM, kWState, kFloor, kWEnd, kPlanes };
// per-chunk values, 4 floats per (b*h, chunk)
enum ChunkVal { kM0 = 0, kMc, kDecay, kChunkVals = 4 };

struct Dims {
  int B, H, S, dqk, dv, chunk, n_chunks, dqk_pad, dv_pad;
};

__host__ __device__ __forceinline__ long long round_up(long long x, int m) {
  return (x + m - 1) / m * m;
}

Dims make_dims(int B, int H, int S, int dqk, int dv, int chunk) {
  Dims d;
  d.B = B;
  d.H = H;
  d.S = S;
  d.dqk = dqk;
  d.dv = dv;
  d.chunk = chunk;
  d.n_chunks = (S + chunk - 1) / chunk;
  d.dqk_pad = static_cast<int>(round_up(dqk, kBox));
  d.dv_pad = static_cast<int>(round_up(dv, 2 * kBox));
  return d;
}

// the scratch, carved from one buffer the wrapper allocates
struct Scratch {
  float* planes;          // [kPlanes][B*H][n_chunks * kL]
  float* chunks;          // [B*H][n_chunks][kChunkVals]
  float* n_in;            // [B*H][n_chunks][dqk_pad], n entering each chunk
  __nv_bfloat16* c_in;    // [B*H][n_chunks][dqk_pad][dv_pad], C entering
};

struct ScratchLayout {
  long long planes, chunks, n_in, c_in, total;
};

ScratchLayout scratch_layout(const Dims& d) {
  const long long bh = static_cast<long long>(d.B) * d.H;
  ScratchLayout s;
  s.planes = 0;
  s.chunks = round_up(s.planes + 4LL * kPlanes * bh * d.n_chunks * kL, 1024);
  s.n_in = round_up(s.chunks + 4LL * kChunkVals * bh * d.n_chunks, 1024);
  s.c_in = round_up(s.n_in + 4LL * bh * d.n_chunks * d.dqk_pad, 1024);
  s.total = s.c_in + 2LL * bh * d.n_chunks * d.dqk_pad * d.dv_pad;
  return s;
}

Scratch carve(void* base, const Dims& d) {
  const ScratchLayout l = scratch_layout(d);
  char* p = static_cast<char*>(base);
  Scratch s;
  s.planes = reinterpret_cast<float*>(p + l.planes);
  s.chunks = reinterpret_cast<float*>(p + l.chunks);
  s.n_in = reinterpret_cast<float*>(p + l.n_in);
  s.c_in = reinterpret_cast<__nv_bfloat16*>(p + l.c_in);
  return s;
}

__device__ __forceinline__ float load(const void* p, int bf16,
                                      long long i) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// byte offset of 16-byte chunk `ch` (0..7) of row `r` in a 128-byte-swizzled
// box (the TMA layout of every tile here)
__device__ __forceinline__ uint32_t swz(int r, int ch) {
  return static_cast<uint32_t>(r * 128 + ((ch ^ (r & 7)) << 4));
}

// -- 1. the gate pass ----------------------------------------------------------

struct GateParams {
  const void* li;
  const void* lf;
  long long st_li[3], st_lf[3];     // (batch, head, step) strides
  int li16, lf16;
  Dims d;
  Scratch s;
};

__global__ void __launch_bounds__(kGateThreads)
    mlstm_chunk_wgmma_gates(const GateParams p) {
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

// -- 2. the states entering every chunk ---------------------------------------

constexpr int kStStages = 3;
constexpr int kStThreads = 128;
constexpr int kStStage = 2 * kRowTile;    // k box, then v box
constexpr int kStBars = kStStages * kStStage;
constexpr int kStSmem = kStBars + kStStages * 8 + 4 * 64 * 4 +
                        static_cast<int>(hopper::kAtomBytes);

struct StateParams {
  Dims d;
  Scratch s;
  float scale;
};

// chunk c's k and v tiles (dqk columns d0.., dv columns v0..) into its stage
__device__ __forceinline__ void issue_state_tiles(
    uint8_t* smem, uint64_t* full, const CUtensorMap* tk,
    const CUtensorMap* tv, int c, int chunk, int d0, int v0, int h, int b) {
  const int s = c % kStStages;
  uint8_t* st = smem + s * kStStage;
  hopper::mbar_expect_tx(&full[s], kStStage);
  hopper::tma_load_4d(st, tk, &full[s], d0, c * chunk, h, b);
  hopper::tma_load_4d(st + kRowTile, tv, &full[s], v0, c * chunk, h, b);
}

__global__ void __launch_bounds__(kStThreads)
    mlstm_chunk_wgmma_states(const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             const StateParams p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hopper::atom_aligned(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStBars);
  float* red = reinterpret_cast<float*>(full + kStStages);  // [4][64]
  const Dims& d = p.d;
  const int vt = blockIdx.x, dt = blockIdx.y, bh = blockIdx.z;
  const int b = bh / d.H, h = bh % d.H;
  const int d0 = dt * kBox, v0 = vt * kBox;
  const int nc = d.n_chunks;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const bool carry_n = vt == 0;             // these blocks carry n too
  const long long rows = static_cast<long long>(nc) * kL;
  const float* wend = p.s.planes +
      (kWEnd * static_cast<long long>(d.B) * d.H + bh) * rows;
  const float* cv = p.s.chunks + static_cast<long long>(bh) * nc * kChunkVals;
  __nv_bfloat16* cin = p.s.c_in +
      static_cast<long long>(bh) * nc * d.dqk_pad * d.dv_pad;
  float* nin = p.s.n_in + static_cast<long long>(bh) * nc * d.dqk_pad;

  if (tid == 0) {
    for (int s = 0; s < kStStages; ++s) hopper::mbar_init(&full[s], 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0)
    for (int c = 0; c < min(kStStages, nc - 1); ++c)
      issue_state_tiles(smem, full, &tk, &tv, c, d.chunk, d0, v0, h, b);

  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
  float n_reg = 0.0f;                       // n[d0 + tid], tid < 64
  const int row_a = warp * 16 + lane / 4;   // accumulator rows (dqk)
  const int col = 2 * (lane % 4);           // and columns (dv)
  const int ch = tid & 7;                   // the scale pass's 16-byte chunk

  for (int c = 0; c < nc; ++c) {
    // -- the state entering chunk c -----------------------------------------
    __nv_bfloat16* cc = cin + static_cast<long long>(c) * d.dqk_pad * d.dv_pad;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int e = v0 + 8 * j + col;
      *reinterpret_cast<uint32_t*>(cc + (d0 + row_a) * static_cast<long long>(
          d.dv_pad) + e) = pack_bf16(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<uint32_t*>(cc + (d0 + row_a + 8) *
          static_cast<long long>(d.dv_pad) + e) =
          pack_bf16(acc[4 * j + 2], acc[4 * j + 3]);
    }
    if (carry_n && tid < kBox)
      nin[static_cast<long long>(c) * d.dqk_pad + d0 + tid] = n_reg;
    if (c == nc - 1) break;                 // no state leaves the last chunk

    // -- k <- bf16(k * scale * w_j) in place, n's column sums ---------------
    const int s = c % kStStages;
    uint8_t* kb = smem + s * kStStage;
    const uint32_t kaddr = hopper::smem_u32(kb);
    float w[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      w[i] = wend[static_cast<long long>(c) * kL + (tid >> 3) + 16 * i] *
             p.scale;
    const float decay = cv[c * kChunkVals + kDecay];
    hopper::mbar_wait(&full[s], (c / kStStages) & 1);
    float part[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) part[e] = 0.0f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = (tid >> 3) + 16 * i;
      uint4* cell = reinterpret_cast<uint4*>(kb + swz(r, ch));
      uint4 raw = *cell;
      uint32_t* wd = reinterpret_cast<uint32_t*>(&raw);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const __nv_bfloat162 kv = *reinterpret_cast<__nv_bfloat162*>(&wd[e]);
        const float lo = __low2float(kv) * w[i];
        const float hi = __high2float(kv) * w[i];
        part[2 * e] += lo;
        part[2 * e + 1] += hi;
        wd[e] = pack_bf16(lo, hi);
      }
      *cell = raw;
    }
    hopper::fence_proxy_async();
    if (carry_n) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        part[e] += __shfl_xor_sync(0xffffffffu, part[e], 8);
        part[e] += __shfl_xor_sync(0xffffffffu, part[e], 16);
      }
      if (lane < 8)
#pragma unroll
        for (int e = 0; e < 8; ++e) red[warp * 64 + ch * 8 + e] = part[e];
    }
    __syncthreads();
    if (carry_n && tid < kBox)
      n_reg = decay * n_reg +
              (red[tid] + red[64 + tid] + red[128 + tid] + red[192 + tid]);

    // -- C <- decay * C + (k w)^T v ----------------------------------------
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] *= decay;
    hopper::fence_regs(acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kL / 16; ++kk)
      hopper::wgmma_ss_m64n64<1, 1>(
          acc,
          hopper::smem_desc(kaddr + kk * 16 * 128, kRowTile,
                            hopper::kAtomBytes),
          hopper::smem_desc(kaddr + kRowTile + kk * 16 * 128, kRowTile,
                            hopper::kAtomBytes),
          1);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    __syncthreads();                        // stage s and red are free
    if (tid == 0 && c + kStStages < nc - 1)
      issue_state_tiles(smem, full, &tk, &tv, c + kStStages, d.chunk, d0, v0,
                        h, b);
  }
}

// -- 3. every chunk's outputs --------------------------------------------------

constexpr int kOutStages = 2;
constexpr int kOutThreads = 256;                 // two consumer warpgroups
constexpr int kCinBox = kBox * 128;              // 64 dqk rows x 64 dv
constexpr int kOutStage = 2 * kRowTile + 2 * kCinBox;  // q, k, C_in (2 boxes)
constexpr int kOutV = kOutStages * kOutStage;    // v: 2 boxes of 128 rows
constexpr int kOutBars = kOutV + 2 * kRowTile;
// after the barriers: a[kL], qn[kL], n0[dqk_pad] floats
constexpr int kOutFixed = kOutBars + (kOutStages + 1) * 8 + 2 * kL * 4 +
                          static_cast<int>(hopper::kAtomBytes);

// dqk tile i of q, k (rows t0..) and C_in (its 128 dv columns) into its stage
__device__ __forceinline__ void issue_out_tiles(
    uint8_t* smem, uint64_t* full, const CUtensorMap* tq,
    const CUtensorMap* tk, const CUtensorMap* tc, int i, int t0, int v0,
    int c, int bh, int h, int b);

struct OutParams {
  __nv_bfloat16* o;
  long long st_o[3];
  Dims d;
  Scratch s;
  float scale;
};

__global__ void __launch_bounds__(kOutThreads, 1)
    mlstm_chunk_wgmma_outputs(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv,
                              const __grid_constant__ CUtensorMap tc,
                              const OutParams p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hopper::atom_aligned(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kOutBars);
  uint64_t* bar_v = full + kOutStages;
  float* a_s = reinterpret_cast<float*>(bar_v + 1);
  float* qn_s = a_s + kL;
  float* n0_s = qn_s + kL;
  const Dims& d = p.d;
  const int vt = blockIdx.x, c = blockIdx.y, bh = blockIdx.z;
  const int b = bh / d.H, h = bh % d.H;
  const int v0 = vt * 2 * kBox;
  const int t0 = c * d.chunk;
  const int len = min(d.chunk, d.S - t0);
  const int nd = d.dqk_pad / kBox;
  const int tid = threadIdx.x;
  const long long rows = static_cast<long long>(d.n_chunks) * kL;
  const long long plane_stride = static_cast<long long>(d.B) * d.H * rows;
  const float* gates = p.s.planes + bh * rows + static_cast<long long>(c) * kL;

  if (tid == 0) {
    for (int s = 0; s < kOutStages; ++s) hopper::mbar_init(&full[s], 1);
    hopper::mbar_init(bar_v, 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    hopper::mbar_expect_tx(bar_v, 2 * kRowTile);
    for (int half = 0; half < 2; ++half)
      hopper::tma_load_4d(smem + kOutV + half * kRowTile, &tv, bar_v,
                          v0 + half * kBox, t0, h, b);
    for (int i = 0; i < min(kOutStages, nd); ++i)
      issue_out_tiles(smem, full, &tq, &tk, &tc, i, t0, v0, c, bh, h, b);
  }
  if (tid < kL) a_s[tid] = gates[kA * plane_stride + tid];
  const float* n0 = p.s.n_in +
      (static_cast<long long>(bh) * d.n_chunks + c) * d.dqk_pad;
  for (int i = tid; i < d.dqk_pad; i += kOutThreads) n0_s[i] = n0[i];
  __syncthreads();

  const int w = tid / 128;                  // this warpgroup's 64 rows
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int row_a = w * 64 + warp * 16 + lane / 4;     // and row_a + 8
  const int col = 2 * (lane % 4);
  // q . n0: two threads per row, four 16-byte chunks each
  const int qrow = w * 64 + (tid % 128) / 2, qhalf = tid % 2;

  float sc[64], acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) sc[i] = acc[i] = 0.0f;
  float qn = 0.0f;
  for (int i = 0; i < nd; ++i) {
    const int s = i % kOutStages;
    hopper::mbar_wait(&full[s], (i / kOutStages) & 1);
    uint8_t* st = smem + s * kOutStage;
    const uint32_t q_base = hopper::smem_u32(st) + w * 64 * 128;
    const uint32_t k_base = hopper::smem_u32(st + kRowTile);
    const uint32_t c_base = hopper::smem_u32(st + 2 * kRowTile);
    hopper::fence_regs(sc);
    hopper::fence_regs(acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBox / 16; ++kk) {
      hopper::wgmma_ss_m64n128<0>(
          sc, hopper::smem_desc(q_base + kk * 32, 16, hopper::kAtomBytes),
          hopper::smem_desc(k_base + kk * 32, 16, hopper::kAtomBytes), 1);
      hopper::wgmma_ss_m64n128<1>(
          acc, hopper::smem_desc(q_base + kk * 32, 16, hopper::kAtomBytes),
          hopper::smem_desc(c_base + kk * 16 * 128, kCinBox,
                            hopper::kAtomBytes), 1);
    }
    hopper::wgmma_commit();
    // q . n0 over this tile on the CUDA cores while the products run
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int chq = 4 * qhalf + j;
      const uint4 raw = *reinterpret_cast<const uint4*>(st + swz(qrow, chq));
      const __nv_bfloat162* qv = reinterpret_cast<const __nv_bfloat162*>(&raw);
      const float* nn = n0_s + i * kBox + 8 * chq;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        qn = fmaf(__low2float(qv[e]), nn[2 * e], qn);
        qn = fmaf(__high2float(qv[e]), nn[2 * e + 1], qn);
      }
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sc);
    hopper::fence_regs(acc);
    __syncthreads();                        // stage s is free
    if (tid == 0 && i + kOutStages < nd)
      issue_out_tiles(smem, full, &tq, &tk, &tc, i + kOutStages, t0, v0, c,
                      bh, h, b);
  }
  qn += __shfl_xor_sync(0xffffffffu, qn, 1);
  if (qhalf == 0) qn_s[qrow] = qn;
  __syncthreads();

  // -- mask, decay, row sums and the denominator (f32) -----------------------
  const int ra = row_a, rb = row_a + 8;
  const float m_a = gates[kM * plane_stride + ra];
  const float m_b = gates[kM * plane_stride + rb];
  const float ws_a = gates[kWState * plane_stride + ra];
  const float ws_b = gates[kWState * plane_stride + rb];
  float rs_a = 0.0f, rs_b = 0.0f;
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int jc = 8 * j + col + e;
      const float aj = a_s[jc];
      const bool in_a = jc <= ra && ra < len;     // j < len follows
      const bool in_b = jc <= rb && rb < len;
      const float sa = in_a ? sc[4 * j + e] * p.scale * expf(aj - m_a) : 0.0f;
      const float sb =
          in_b ? sc[4 * j + 2 + e] * p.scale * expf(aj - m_b) : 0.0f;
      sc[4 * j + e] = sa;
      sc[4 * j + 2 + e] = sb;
      rs_a += sa;
      rs_b += sb;
    }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    rs_a += __shfl_xor_sync(0xffffffffu, rs_a, off);
    rs_b += __shfl_xor_sync(0xffffffffu, rs_b, off);
  }
  const float den_a = fmaxf(fabsf(rs_a + ws_a * qn_s[ra]),
                            gates[kFloor * plane_stride + ra]);
  const float den_b = fmaxf(fabsf(rs_b + ws_b * qn_s[rb]),
                            gates[kFloor * plane_stride + rb]);

  // -- O = exp(m0 - M) q C_in + S~ v ----------------------------------------
  uint32_t pa[8][4];
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    pa[kk][0] = pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
    pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
    pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
    pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
  }
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    acc[4 * j] *= ws_a;
    acc[4 * j + 1] *= ws_a;
    acc[4 * j + 2] *= ws_b;
    acc[4 * j + 3] *= ws_b;
  }
  hopper::mbar_wait(bar_v, 0);
  const uint32_t v_base = hopper::smem_u32(smem + kOutV);
  hopper::fence_regs(acc);
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    hopper::wgmma_rs_m64n128<1>(
        acc, pa[kk],
        hopper::smem_desc(v_base + kk * 16 * 128, kRowTile,
                          hopper::kAtomBytes), 1);
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
  hopper::fence_regs(acc);

  // -- h = O / den --------------------------------------------------------------
  __nv_bfloat16* ob = p.o + b * p.st_o[0] + h * p.st_o[1];
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int e = v0 + 8 * j + col;
    if (e >= d.dv) continue;                // dv is even: pairs never straddle
    if (ra < len)
      *reinterpret_cast<uint32_t*>(ob + (t0 + ra) * p.st_o[2] + e) =
          pack_bf16(acc[4 * j] / den_a, acc[4 * j + 1] / den_a);
    if (rb < len)
      *reinterpret_cast<uint32_t*>(ob + (t0 + rb) * p.st_o[2] + e) =
          pack_bf16(acc[4 * j + 2] / den_b, acc[4 * j + 3] / den_b);
  }
}

__device__ __forceinline__ void issue_out_tiles(
    uint8_t* smem, uint64_t* full, const CUtensorMap* tq,
    const CUtensorMap* tk, const CUtensorMap* tc, int i, int t0, int v0,
    int c, int bh, int h, int b) {
  const int s = i % kOutStages;
  uint8_t* st = smem + s * kOutStage;
  hopper::mbar_expect_tx(&full[s], kOutStage);
  hopper::tma_load_4d(st, tq, &full[s], i * kBox, t0, h, b);
  hopper::tma_load_4d(st + kRowTile, tk, &full[s], i * kBox, t0, h, b);
  for (int half = 0; half < 2; ++half)
    hopper::tma_load_4d(st + 2 * kRowTile + half * kCinBox, tc, &full[s],
                        v0 + half * kBox, i * kBox, c, bh);
}

// (d, S, H, B) map of a bf16 q, k or v with element strides `st` (batch,
// head, step); boxes of 64 columns x 128 rows
int stream_map(CUtensorMap* map, const void* base, const long long* st,
               int D, const Dims& d) {
  const uint64_t dims[4] = {static_cast<uint64_t>(D),
                            static_cast<uint64_t>(d.S),
                            static_cast<uint64_t>(d.H),
                            static_cast<uint64_t>(d.B)};
  const int64_t strides[3] = {2 * st[2], 2 * st[1], 2 * st[0]};
  const uint32_t box[4] = {kBox, kL, 1, 1};
  return hopper::make_tensor_map(map, base, 4, dims, strides, box);
}

int set_smem(const void* kernel, int bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

}  // namespace

// -- C entry points (bound with ctypes) ----------------------------------------
//
// Bytes of the scratch buffer one call needs (the wrapper allocates it
// with torch.empty): the gate planes, the per-chunk values, and n and C
// entering every chunk (the last in bf16).
extern "C" long long mlstm_chunk_wgmma_scratch(int B, int H, int S, int dqk,
                                               int dv, int chunk) {
  if (B < 1 || H < 1 || S < 1 || dqk < 1 || dv < 1 || chunk < 1 ||
      chunk > kL)
    return -1;
  return scratch_layout(make_dims(B, H, S, dqk, dv, chunk)).total;
}

// q/k (B*H, S, dqk) and v / o (B*H, S, dv) rows, logi / logf one value a
// row, addressed as mlstm_chunk's (`strides`: 18 values, (batch, head,
// step) of q, k, v, logi, logf, o).  q, k, v and o are bf16; `types` bits
// 3 and 4 mark bf16 logi / logf.  `scratch` holds
// mlstm_chunk_wgmma_scratch(...) bytes, 1024-byte aligned.  Launches the
// three kernels on `stream`; returns the first cudaError_t.
extern "C" int mlstm_chunk_wgmma(const void* q, const void* k, const void* v,
                                 const void* li, const void* lf, void* o,
                                 const long long* strides, int types, int B,
                                 int H, int S, int dqk, int dv, int chunk,
                                 float scale, void* scratch, void* stream) {
  if (B < 1 || H < 1 || S < 1 || dqk < 1 || dv < 1 || dv % 2 || chunk < 1 ||
      chunk > kL || static_cast<long long>(B) * H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) % 16 ||
      reinterpret_cast<uintptr_t>(scratch) % 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int s = 0; s < kStreams; ++s) {
    if (s == kLi || s == kLf) continue;
    for (int a = 0; a < 3; ++a)
      if (strides[3 * s + a] % 8) return static_cast<int>(cudaErrorInvalidValue);
  }
  const Dims d = make_dims(B, H, S, dqk, dv, chunk);
  if (d.n_chunks > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const Scratch sc = carve(scratch, d);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int out_smem = kOutFixed + 4 * d.dqk_pad;
  static int out_configured = 0;            // the largest size set so far
  static bool st_configured = false;
  if (!st_configured) {
    const int err = set_smem(reinterpret_cast<const void*>(
        mlstm_chunk_wgmma_states), kStSmem);
    if (err) return err;
    st_configured = true;
  }
  if (out_smem > out_configured) {
    const int err = set_smem(reinterpret_cast<const void*>(
        mlstm_chunk_wgmma_outputs), out_smem);
    if (err) return err;
    out_configured = out_smem;
  }
  CUtensorMap tq, tk, tv, tc;
  int err = stream_map(&tq, q, strides + 3 * kQ, dqk, d);
  if (!err) err = stream_map(&tk, k, strides + 3 * kK, dqk, d);
  if (!err) err = stream_map(&tv, v, strides + 3 * kV, dv, d);
  if (!err) {
    // C_in as (dv_pad, dqk_pad, chunk, b*h); boxes of 64 x 64
    const uint64_t dims[4] = {static_cast<uint64_t>(d.dv_pad),
                              static_cast<uint64_t>(d.dqk_pad),
                              static_cast<uint64_t>(d.n_chunks),
                              static_cast<uint64_t>(B) * H};
    const int64_t row = 2LL * d.dv_pad;
    const int64_t strides_c[3] = {row, row * d.dqk_pad,
                                  row * d.dqk_pad * d.n_chunks};
    const uint32_t box[4] = {kBox, kBox, 1, 1};
    err = hopper::make_tensor_map(&tc, sc.c_in, 4, dims, strides_c, box);
  }
  if (err) return err;

  GateParams gp;
  gp.li = li;
  gp.lf = lf;
  for (int a = 0; a < 3; ++a) {
    gp.st_li[a] = strides[3 * kLi + a];
    gp.st_lf[a] = strides[3 * kLf + a];
  }
  gp.li16 = (types >> 3) & 1;
  gp.lf16 = (types >> 4) & 1;
  gp.d = d;
  gp.s = sc;
  mlstm_chunk_wgmma_gates<<<B * H, kGateThreads, 0, st>>>(gp);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  StateParams sp;
  sp.d = d;
  sp.s = sc;
  sp.scale = scale;
  const dim3 sgrid(d.dv_pad / kBox, d.dqk_pad / kBox, B * H);
  mlstm_chunk_wgmma_states<<<sgrid, kStThreads, kStSmem, st>>>(tk, tv, sp);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  OutParams op;
  op.o = static_cast<__nv_bfloat16*>(o);
  for (int a = 0; a < 3; ++a) op.st_o[a] = strides[3 * kO + a];
  op.d = d;
  op.s = sc;
  op.scale = scale;
  const dim3 ogrid(d.dv_pad / (2 * kBox), d.n_chunks, B * H);
  mlstm_chunk_wgmma_outputs<<<ogrid, kOutThreads, out_smem, st>>>(tq, tk, tv,
                                                                 tc, op);
  return static_cast<int>(cudaGetLastError());
}
