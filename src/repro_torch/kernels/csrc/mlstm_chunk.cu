// Chunkwise stabilized mLSTM (xLSTM matrix memory) on the CUDA cores
// (sm_90a), all arithmetic in f32.
//
// Replaces the TPU kernel `mlstm_chunk_kernel` / `_mlstm_kernel`
// (repro/kernels/mlstm_chunk.py:22-99) for f32 and for every input the
// tensor-core route (mlstm_chunk_wgmma.cu) refuses.  It computes what the
// Pallas kernel computes, from a zero state (C = 0, n = 0, m = 0, not
// -inf): per (batch, head) a matrix memory C (dqk x dv), a normalizer n
// (dqk) and a scalar stabilizer m, carried over chunks of the sequence;
// within a chunk of c steps, with F = cumsum(logf), a = logi - F,
// M = max(m0, cummax(a)), m_new = F + M:
//
//   Dmask[t,j] = exp(a_j - M_t) for j <= t, else 0
//   num_t      = sum_j Dmask[t,j] (q_t . k_j) v_j + exp(m0 - M_t) q_t C0
//   den_t      = max(|sum_j Dmask[t,j] (q_t . k_j)
//                     + exp(m0 - M_t) (q_t . n0)|, exp(-m_new_t))
//   h_t        = num_t / den_t
//
// and at the chunk's end, with Mc = M_{c-1} and w_j = exp(a_j - Mc):
// C1 = exp(m0 - Mc) C0 + sum_j w_j k_j v_j^T, n1 = exp(m0 - Mc) n0 +
// sum_j w_j k_j, m1 = m_new_{c-1}.  k is scaled by dqk^-0.5.  `expf`, no
// fast math; each of q, k, v, logi and logf is f32 or bf16, read in its
// own type and widened, so no operand is rounded; h has q's type.
//
// Bound on an H100 SXM (data-sheet rates): operations.  At xlstm-350m's
// f32 shape (B*H = 4, S = 4096, dqk = dv = 512, c = 128) the function
// needs q k^T and S v over the causal pairs, q C from the second chunk on
// and k^T v up to the last chunk: 18.8 GFLOP, 0.281 ms at the 67 TFLOP/s
// of the CUDA cores, against 0.040 ms for reading q, k, v and the gates
// and writing h in f32.
//
// Design.  Only the state at chunk boundaries is sequential; a chunk's
// outputs need nothing else once the state entering it is known.  So one
// wrapper call launches three kernels on one stream, as the tensor-core
// route does, with the same gate pass:
//
//   1. mlstm_chunk_kernel_gates (mlstm_gates.cuh), one block per (batch,
//      head): every row's gate factors and every chunk's m0, Mc and
//      exp(m0 - Mc), into the scratch;
//   2. mlstm_chunk_kernel_states, one block of 128 threads per (64 dv, 64
//      dqk, batch * head) tile of C (256 blocks at that shape, two an SM):
//      the tile stays in f32 registers (4 x 8 a thread) while the block
//      walks the chunks in order, C <- exp(m0 - Mc) C + (k w)^T v, with
//      the chunks' k, v and w rows streamed through a 4-stage cp.async
//      ring of 32-row stages (k scaled by w_j dqk^-0.5 as it is read);
//      before each chunk it writes the state entering it to an f32 scratch
//      (B*H, chunks, dqk_pad, dv_pad).  The first dv tile's threads of
//      column group 0 also carry n (the sums of their rows of k w) and
//      write it per chunk;
//   3. mlstm_chunk_kernel_outputs, one block of 256 threads per (chunk,
//      batch * head), with a 3-stage cp.async ring: (a) over 32-wide dqk
//      stages of q and k, S = q k^T (128 x 128, 8 x 8 a thread) and q . n0;
//      then the mask and the decay in registers, the row sums and the
//      denominator, and S~ to shared memory; (b) for each 128-column dv
//      tile in turn, one stream of stages through the same ring: q and
//      C_in over dqk (O = q C_in, 8 x 8 a thread; skipped for the first
//      chunk, whose state is zero), then the chunk's v rows, 32 a stage
//      (O = exp(m0 - M) O + S~ v); h = O / den.
//
// Every product reads its shared tiles as float4s: along the reduction
// axis for q k^T (16 FMAs a load), along the output axes for q C_in, S~ v
// and the state update.  S is computed once a chunk, so the design does
// 20.9 GFLOP at that shape (the whole 128 x 128 S and q C_in over all of
// dqk), and writes and reads the state scratch: 134 MB of f32 each way,
// 0.080 ms at 3.35 TB/s.
//
// Layouts: q, k, v, o and the gates are read through (batch, head, step)
// strides (the model's (B, S, H, d) or the kernel's (B*H, S, d)), the last
// axis contiguous, so the caller's views need no copy.  A stream whose
// width, strides and base allow it is loaded 4 elements at a time (cp.async
// for f32), any other element by element.  Rows past the sequence's end (a
// ragged last chunk) and columns past dqk or dv load as zeros and are
// never written.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "hopper.cuh"
#include "mlstm_gates.cuh"

namespace {

using namespace mlstm;                    // dims, scratch, planes, gate pass

constexpr int kCBytes = 4;                // C entering each chunk: f32
constexpr int kMaxDqk = 512;

// (batch, head, step) strides and flags of the streams
struct Streams {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long st[kStreams][3];
  int bf16[kStreams];                     // o: q's type
  int vec[kStreams];                      // 4-element loads and stores
};

__device__ __forceinline__ float lane4(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// elements [d, d + 4) of a row of n into shared memory as f32; `at` is
// element d's offset from `base`; zeros where the row is not `live` or
// past n.  cp.async for f32 where `vec`; loads through registers (which
// widen bf16) otherwise.
__device__ __forceinline__ void stage4(float* dst, const void* base, int bf16,
                                       long long at, bool live, int d, int n,
                                       bool vec) {
  if (!bf16 && vec) {
    const bool any = live && d < n;
    hopper::cp16(dst, static_cast<const float*>(base) + (any ? at : 0),
                 any ? 16 : 0);
    return;
  }
  float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
  if (live)
    x = bf16 ? hopper::widen4(hopper::fetch_raw4(
                   static_cast<const __nv_bfloat16*>(base) + at, d, n, vec))
             : hopper::widen4(hopper::fetch_raw4(
                   static_cast<const float*>(base) + at, d, n, vec));
  *reinterpret_cast<float4*>(dst) = x;
}

// -- 1. the gate pass ------------------------------------------------------------

__global__ void __launch_bounds__(kGateThreads)
    mlstm_chunk_kernel_gates(const GateParams p) {
  gate_pass(p);
}

// -- 2. the states entering every chunk ---------------------------------------

constexpr int kStThreads = 128;
constexpr int kStD = 64;                  // dqk rows of C a block
constexpr int kStV = 64;                  // dv columns of C a block
constexpr int kStRows = 32;               // chunk rows a stage
constexpr int kStStages = 4;
// a stage: k [32][64], v [32][64], the rows' w [32]
constexpr int kStStageFloats = kStRows * (kStD + kStV + 1);
constexpr int kStSmem =
    static_cast<int>(sizeof(float)) * kStStages * kStStageFloats;
static_assert(kDqkTile % kStD == 0 && kDvTile % kStV == 0, "tiles");

struct StateParams {
  Streams io;
  Dims d;
  Scratch s;
  float scale;
};

__global__ void __launch_bounds__(kStThreads)
    mlstm_chunk_kernel_states(const StateParams p) {
  extern __shared__ __align__(16) float ring[];
  const Dims& d = p.d;
  const int vt = blockIdx.x, dt = blockIdx.y, bh = blockIdx.z;
  const int b = bh / d.H, h = bh % d.H;
  const int d0 = dt * kStD, v0 = vt * kStV;
  const int nc = d.n_chunks;
  const int nsub = (d.chunk + kStRows - 1) / kStRows;     // stages a chunk
  const int total = (nc - 1) * nsub;      // no state leaves the last chunk
  const int tid = threadIdx.x;
  // C rows d0 + 4 tdi .. + 3, columns v0 + 4 tei + 32 cg .. + 3 (cg < 2)
  const int tdi = tid / 8, tei = tid % 8;
  // the first dv tile's threads of column group 0 also carry n[d0 + 4 tdi
  // .. + 3]: they hold k w for those rows anyway
  const bool carry_n = vt == 0 && tei == 0;
  const long long rows = static_cast<long long>(nc) * kL;
  const float* wend = p.s.planes +
      (kWEnd * static_cast<long long>(d.B) * d.H + bh) * rows;
  const float* cv = p.s.chunks + static_cast<long long>(bh) * nc * kChunkVals;
  float* cin = static_cast<float*>(p.s.c_in) +
      static_cast<long long>(bh) * nc * d.dqk_pad * d.dv_pad;
  float* nin = p.s.n_in + static_cast<long long>(bh) * nc * d.dqk_pad;
  const long long kb = b * p.io.st[kK][0] + h * p.io.st[kK][1];
  const long long vb = b * p.io.st[kV][0] + h * p.io.st[kV][1];

  // stage g (chunk g / nsub, rows 32 (g % nsub) ..) into its slot, then one
  // commit (empty past the last stage, so the count stays one a stage)
  auto issue = [&](int g) {
    if (g < total) {
      const int c = g / nsub, r0 = (g % nsub) * kStRows;
      float* ks = ring + (g % kStStages) * kStStageFloats;
      float* vs = ks + kStRows * kStD;
      float* ws = vs + kStRows * kStV;
      const long long t0 = static_cast<long long>(c) * d.chunk;
      for (int i = tid; i < kStRows * kStD / 4; i += kStThreads) {
        const int r = i / (kStD / 4), f = i % (kStD / 4);
        const int rr = min(r0 + r, d.chunk - 1), dd = d0 + 4 * f;
        stage4(ks + r * kStD + 4 * f, p.io.k, p.io.bf16[kK],
               kb + (t0 + rr) * p.io.st[kK][2] + dd, r0 + r < d.chunk, dd,
               d.dqk, p.io.vec[kK]);
      }
      for (int i = tid; i < kStRows * kStV / 4; i += kStThreads) {
        const int r = i / (kStV / 4), f = i % (kStV / 4);
        const int rr = min(r0 + r, d.chunk - 1), e = v0 + 4 * f;
        stage4(vs + r * kStV + 4 * f, p.io.v, p.io.bf16[kV],
               vb + (t0 + rr) * p.io.st[kV][2] + e, r0 + r < d.chunk, e,
               d.dv, p.io.vec[kV]);
      }
      if (tid < kStRows / 4)              // w = 0 past the chunk's rows
        hopper::cp16(ws + 4 * tid,
                     wend + static_cast<long long>(c) * kL + r0 + 4 * tid, 16);
    }
    hopper::cp_commit();
  };

#pragma unroll 1
  for (int g = 0; g < kStStages - 1; ++g) issue(g);

  float acc[4][8];                        // [r][4 cg + e]
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[r][e] = 0.0f;
  float n_reg[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float decay = nc > 1 ? cv[kDecay] : 1.0f;
  int g = 0;

#pragma unroll 1
  for (int c = 0; c < nc; ++c) {
    // -- the state entering chunk c -----------------------------------------
    float* cc = cin + static_cast<long long>(c) * d.dqk_pad * d.dv_pad;
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int cg = 0; cg < 2; ++cg)
        *reinterpret_cast<float4*>(
            cc + static_cast<long long>(d0 + 4 * tdi + r) * d.dv_pad + v0 +
            4 * tei + 32 * cg) =
            make_float4(acc[r][4 * cg], acc[r][4 * cg + 1],
                        acc[r][4 * cg + 2], acc[r][4 * cg + 3]);
    if (carry_n)
      *reinterpret_cast<float4*>(
          nin + static_cast<long long>(c) * d.dqk_pad + d0 + 4 * tdi) =
          make_float4(n_reg[0], n_reg[1], n_reg[2], n_reg[3]);
    if (c == nc - 1) break;

    const float dc = decay;               // this chunk's exp(m0 - Mc)
    if (c + 2 < nc) decay = cv[(c + 1) * kChunkVals + kDecay];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[r][e] *= dc;
    float npart[4] = {0.0f, 0.0f, 0.0f, 0.0f};   // this chunk's sums of k w

#pragma unroll 1
    for (int s = 0; s < nsub; ++s, ++g) {
      hopper::cp_wait<kStStages - 2>();   // this thread's copies of stage g
      __syncthreads();                    // everyone's; stage g - 1 is free
      issue(g + kStStages - 1);
      const float* ks = ring + (g % kStStages) * kStStageFloats;
      const float* vs = ks + kStRows * kStD;
      const float* ws = vs + kStRows * kStV;
      // C += (k w)^T v over the stage's rows, k w = k * (w_j dqk^-0.5)
#pragma unroll 4
      for (int j = 0; j < kStRows; ++j) {
        const float wj = ws[j] * p.scale;
        const float4 kf =
            *reinterpret_cast<const float4*>(ks + j * kStD + 4 * tdi);
        const float4 va =
            *reinterpret_cast<const float4*>(vs + j * kStV + 4 * tei);
        const float4 vz =
            *reinterpret_cast<const float4*>(vs + j * kStV + 4 * tei + 32);
        const float kr[4] = {kf.x * wj, kf.y * wj, kf.z * wj, kf.w * wj};
        const float vr[8] = {va.x, va.y, va.z, va.w, vz.x, vz.y, vz.z, vz.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[r][e] = fmaf(kr[r], vr[e], acc[r][e]);
        if (carry_n)
#pragma unroll
          for (int r = 0; r < 4; ++r) npart[r] += kr[r];
      }
    }
    // n <- exp(m0 - Mc) n + this chunk's sums of k w over its rows
#pragma unroll
    for (int r = 0; r < 4; ++r) n_reg[r] = dc * n_reg[r] + npart[r];
  }
}

// -- 3. every chunk's outputs --------------------------------------------------

constexpr int kOutThreads = 256;
constexpr int kOD = 32;                   // dqk dims (or v rows) a stage
constexpr int kOP = kOD + 4;              // row pitch of the q and k stages
constexpr int kOV = kDvTile;              // dv columns an output tile
constexpr int kOStages = 3;
constexpr int kOStageFloats = 2 * kL * kOP;   // q, then k or C_in; or v
constexpr int kSP = kL + 16;              // row pitch of S~
constexpr int kOutGates = 6;              // a, M, exp(m0 - M), floor, q.n0, den
static_assert(kOD * kOV <= kL * kOP, "a C_in stage fits beside q");
static_assert(kOD * kOV <= kOStageFloats, "a v stage fits a slot");

int out_smem(const Dims& d) {
  return static_cast<int>(sizeof(float)) *
         (kOStages * kOStageFloats + kL * kSP + kOutGates * kL + d.dqk_pad);
}

struct OutParams {
  Streams io;
  Dims d;
  Scratch s;
  float scale;
};

__global__ void __launch_bounds__(kOutThreads, 1)
    mlstm_chunk_kernel_outputs(const OutParams p) {
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;                             // kOStages slots
  float* ss = ring + kOStages * kOStageFloats;    // [kL][kSP] S~
  float* a_s = ss + kL * kSP;
  float* m_s = a_s + kL;
  float* ws_s = m_s + kL;
  float* fl_s = ws_s + kL;
  float* qn_s = fl_s + kL;
  float* den_s = qn_s + kL;
  float* n0_s = den_s + kL;                       // [dqk_pad]
  const Dims& d = p.d;
  const int c = blockIdx.x, bh = blockIdx.z;
  const int b = bh / d.H, h = bh % d.H;
  const int t0 = c * d.chunk;
  const int len = min(d.chunk, d.S - t0);
  const int nd = (d.dqk + kOD - 1) / kOD;
  const int tid = threadIdx.x, lane = tid % 32;
  const int tq = 2 * (tid / 32) + lane / 16;      // rows tq + 16 i
  const int tk = lane % 16;    // keys tk + 16 l; dv columns 4 tk + 64 cg
  const long long rows = static_cast<long long>(d.n_chunks) * kL;
  const long long plane_stride = static_cast<long long>(d.B) * d.H * rows;
  const float* gates = p.s.planes + bh * rows + static_cast<long long>(c) * kL;
  const long long qb = b * p.io.st[kQ][0] + h * p.io.st[kQ][1];
  const long long kb = b * p.io.st[kK][0] + h * p.io.st[kK][1];
  const long long vb = b * p.io.st[kV][0] + h * p.io.st[kV][1];
  const float* cin = static_cast<const float*>(p.s.c_in) +
      (static_cast<long long>(bh) * d.n_chunks + c) * d.dqk_pad * d.dv_pad;

  // 4 elements of row r (of the chunk) of a stream, dims dd.., into dst
  auto row4 = [&](float* dst, int s, const void* base, long long rb, int r,
                  int dd, int n) {
    stage4(dst, base, p.io.bf16[s],
           rb + static_cast<long long>(t0 + min(r, len - 1)) * p.io.st[s][2] +
               dd,
           r < len, dd, n, p.io.vec[s]);
  };
  // the q rows of dims 32 g .. into a slot
  auto stage_q = [&](float* qs, int g) {
    for (int i = tid; i < kL * kOD / 4; i += kOutThreads) {
      const int r = i / (kOD / 4), f = i % (kOD / 4), dd = g * kOD + 4 * f;
      row4(qs + r * kOP + 4 * f, kQ, p.io.q, qb, r, dd, d.dqk);
    }
  };
  // pass (a)'s stage g: q and k, dims 32 g ..
  auto issue_a = [&](int g) {
    if (g < nd) {
      float* qs = ring + (g % kOStages) * kOStageFloats;
      float* ks = qs + kL * kOP;
      stage_q(qs, g);
      for (int i = tid; i < kL * kOD / 4; i += kOutThreads) {
        const int r = i / (kOD / 4), f = i % (kOD / 4), dd = g * kOD + 4 * f;
        row4(ks + r * kOP + 4 * f, kK, p.io.k, kb, r, dd, d.dqk);
      }
    }
    hopper::cp_commit();
  };
  // pass (b), every dv tile in turn: nc_b stages of q and C_in (dims 32 i
  // .., skipped for the first chunk, whose state is zero), then nv stages
  // of 32 v rows
  const int nc_b = c > 0 ? nd : 0;
  const int nv = (len + kOD - 1) / kOD;
  const int per_tile = nc_b + nv;
  const int total = d.dv_pad / kOV * per_tile;
  auto issue_b = [&](int g) {
    if (g < total) {
      const int v0 = g / per_tile * kOV, i = g % per_tile;
      float* st = ring + (g % kOStages) * kOStageFloats;
      if (i < nc_b) {
        float* cs = st + kL * kOP;
        stage_q(st, i);
        for (int x = tid; x < kOD * kOV / 4; x += kOutThreads) {
          const int r = x / (kOV / 4), f = x % (kOV / 4);
          hopper::cp16(cs + r * kOV + 4 * f,
                       cin + static_cast<long long>(i * kOD + r) * d.dv_pad +
                           v0 + 4 * f, 16);
        }
      } else {
        const int r0 = (i - nc_b) * kOD;
        for (int x = tid; x < kOD * kOV / 4; x += kOutThreads) {
          const int r = x / (kOV / 4), f = x % (kOV / 4);
          row4(st + r * kOV + 4 * f, kV, p.io.v, vb, r0 + r, v0 + 4 * f,
               d.dv);
        }
      }
    }
    hopper::cp_commit();
  };

#pragma unroll 1
  for (int g = 0; g < kOStages - 1; ++g) issue_a(g);
  if (tid < kL) {
    a_s[tid] = gates[kA * plane_stride + tid];
    m_s[tid] = gates[kM * plane_stride + tid];
    ws_s[tid] = gates[kWState * plane_stride + tid];
    fl_s[tid] = gates[kFloor * plane_stride + tid];
  }
  const float* n0 = p.s.n_in +
      (static_cast<long long>(bh) * d.n_chunks + c) * d.dqk_pad;
  for (int i = tid; i < d.dqk_pad; i += kOutThreads) n0_s[i] = n0[i];

  // -- (a) S = q k^T and q . n0 ------------------------------------------------
  float sc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int l = 0; l < 8; ++l) sc[i][l] = 0.0f;
  const int qrow = tid / 2, qhalf = tid % 2;      // q . n0: 16 dims a thread
  float qn = 0.0f;
#pragma unroll 1
  for (int g = 0; g < nd; ++g) {
    hopper::cp_wait<kOStages - 2>();
    __syncthreads();
    issue_a(g + kOStages - 1);
    const float* qs = ring + (g % kOStages) * kOStageFloats;
    const float* ks = qs + kL * kOP;
#pragma unroll
    for (int dd = 0; dd < kOD; dd += 4) {
      float4 kf[8];
#pragma unroll
      for (int l = 0; l < 8; ++l)
        kf[l] = *reinterpret_cast<const float4*>(ks + (tk + 16 * l) * kOP + dd);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 qf =
            *reinterpret_cast<const float4*>(qs + (tq + 16 * i) * kOP + dd);
#pragma unroll
        for (int l = 0; l < 8; ++l) {
          sc[i][l] = fmaf(qf.x, kf[l].x, sc[i][l]);
          sc[i][l] = fmaf(qf.y, kf[l].y, sc[i][l]);
          sc[i][l] = fmaf(qf.z, kf[l].z, sc[i][l]);
          sc[i][l] = fmaf(qf.w, kf[l].w, sc[i][l]);
        }
      }
    }
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const int dd = 16 * qhalf + 4 * f;
      const float4 x = *reinterpret_cast<const float4*>(qs + qrow * kOP + dd);
      const float4 n = *reinterpret_cast<const float4*>(n0_s + g * kOD + dd);
      qn = fmaf(x.x, n.x, qn);
      qn = fmaf(x.y, n.y, qn);
      qn = fmaf(x.z, n.z, qn);
      qn = fmaf(x.w, n.w, qn);
    }
  }
  qn += __shfl_xor_sync(0xffffffffu, qn, 1);
  if (qhalf == 0) qn_s[qrow] = qn;
  __syncthreads();                        // qn_s; pass (a)'s ring is free
#pragma unroll 1
  for (int g = 0; g < kOStages - 1; ++g) issue_b(g);

  // -- the mask, the decay, the row sums and the denominator ---------------------
  // (each warp writes, and later reads, only its own rows of S~ and den)
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int t = tq + 16 * i;
    const float mt = m_s[t];
    float rs = 0.0f;
#pragma unroll
    for (int l = 0; l < 8; ++l) {
      const int j = tk + 16 * l;
      const float s =
          j <= t && t < len ? sc[i][l] * p.scale * expf(a_s[j] - mt) : 0.0f;
      ss[t * kSP + j] = s;
      rs += s;
    }
#pragma unroll
    for (int off = 1; off < 16; off <<= 1)
      rs += __shfl_xor_sync(0xffffffffu, rs, off);
    if (tk == 0) den_s[t] = fmaxf(fabsf(rs + ws_s[t] * qn_s[t]), fl_s[t]);
  }

  // -- (b) per dv tile: O = exp(m0 - M) q C_in + S~ v, h = O / den ---------------
  const long long ob = b * p.io.st[kO][0] + h * p.io.st[kO][1];
  float acc[8][8];                        // [i][4 cg + e]
#pragma unroll 1
  for (int g = 0; g < total; ++g) {
    hopper::cp_wait<kOStages - 2>();
    __syncthreads();
    issue_b(g + kOStages - 1);
    const float* st = ring + (g % kOStages) * kOStageFloats;
    const int v0 = g / per_tile * kOV, i_st = g % per_tile;
    if (i_st == 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[i][e] = 0.0f;
    }
    if (i_st < nc_b) {
      // O += q C_in over this stage's 32 dims
      const float* cs = st + kL * kOP;
#pragma unroll
      for (int dd = 0; dd < kOD; dd += 4) {
        float4 qf[8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          qf[i] =
              *reinterpret_cast<const float4*>(st + (tq + 16 * i) * kOP + dd);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          float4 cf[2];
#pragma unroll
          for (int cg = 0; cg < 2; ++cg)
            cf[cg] = *reinterpret_cast<const float4*>(
                cs + (dd + r) * kOV + tk * 4 + 64 * cg);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float x = lane4(qf[i], r);
#pragma unroll
            for (int cg = 0; cg < 2; ++cg) {
              acc[i][4 * cg] = fmaf(x, cf[cg].x, acc[i][4 * cg]);
              acc[i][4 * cg + 1] = fmaf(x, cf[cg].y, acc[i][4 * cg + 1]);
              acc[i][4 * cg + 2] = fmaf(x, cf[cg].z, acc[i][4 * cg + 2]);
              acc[i][4 * cg + 3] = fmaf(x, cf[cg].w, acc[i][4 * cg + 3]);
            }
          }
        }
      }
      continue;
    }
    if (i_st == nc_b) {                   // the state's weight, exp(m0 - M)
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float w = ws_s[tq + 16 * i];
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[i][e] *= w;
      }
    }
    // O += S~ v over this stage's 32 v rows (S~ is 0 from len on)
    const int j0 = (i_st - nc_b) * kOD;
#pragma unroll 2
    for (int jj = 0; jj < kOD; jj += 4) {
      float4 pf[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        pf[i] = *reinterpret_cast<const float4*>(ss + (tq + 16 * i) * kSP +
                                                 j0 + jj);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float4 vf[2];
#pragma unroll
        for (int cg = 0; cg < 2; ++cg)
          vf[cg] = *reinterpret_cast<const float4*>(st + (jj + e) * kOV +
                                                    tk * 4 + 64 * cg);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float x = lane4(pf[i], e);
#pragma unroll
          for (int cg = 0; cg < 2; ++cg) {
            acc[i][4 * cg] = fmaf(x, vf[cg].x, acc[i][4 * cg]);
            acc[i][4 * cg + 1] = fmaf(x, vf[cg].y, acc[i][4 * cg + 1]);
            acc[i][4 * cg + 2] = fmaf(x, vf[cg].z, acc[i][4 * cg + 2]);
            acc[i][4 * cg + 3] = fmaf(x, vf[cg].w, acc[i][4 * cg + 3]);
          }
        }
      }
    }
    if (i_st < per_tile - 1) continue;
    // -- h = O / den for this dv tile ----------------------------------------
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int t = tq + 16 * i;
      if (t >= len) continue;
      const float den = den_s[t];
      const long long row =
          ob + static_cast<long long>(t0 + t) * p.io.st[kO][2];
#pragma unroll
      for (int cg = 0; cg < 2; ++cg) {
        const int e = v0 + tk * 4 + 64 * cg;
        if (e >= d.dv) continue;
        const float out[4] = {acc[i][4 * cg] / den, acc[i][4 * cg + 1] / den,
                              acc[i][4 * cg + 2] / den,
                              acc[i][4 * cg + 3] / den};
        if (p.io.bf16[kO])
          hopper::store4(static_cast<__nv_bfloat16*>(p.io.o) + row + e, out,
                         d.dv - e, p.io.vec[kO]);
        else
          hopper::store4(static_cast<float*>(p.io.o) + row + e, out,
                         d.dv - e, p.io.vec[kO]);
      }
    }
  }
}

int set_smem(const void* kernel, int bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

}  // namespace

// -- C entry points (bound with ctypes) ---------------------------------------
//
// Bytes of the scratch buffer one call needs (the wrapper allocates it
// with torch.empty): the gate planes, the per-chunk values, and n and C
// entering every chunk, both f32.  -1 for arguments the kernel refuses.
extern "C" long long mlstm_chunk_scratch(int B, int H, int S, int dqk, int dv,
                                         int chunk) {
  if (B < 0 || H < 1 || S < 0 || dqk < 1 || dqk > kMaxDqk || dv < 1 ||
      chunk < 1 || chunk > kL)
    return -1;
  return scratch_layout(make_dims(B, H, S, dqk, dv, chunk), kCBytes).total;
}

// q/k (B*H, S, dqk) and v / o (B*H, S, dv) rows, logi / logf one value a
// row, each addressed as base + b * st[s][0] + h * st[s][1] + t *
// st[s][2] (+ the feature index, unit stride); `strides` holds the 18
// values in the order q, k, v, logi, logf, o.  `types` bit s is 1 where
// stream s (q, k, v, logi, logf) is bf16; o has q's type.  `scratch` holds
// mlstm_chunk_scratch(...) bytes, 16-byte aligned.  Requires 1 <= dqk <=
// 512, 1 <= chunk <= 128, B*H <= 65535.  Launches the three kernels on
// `stream`; returns the first cudaError_t.
extern "C" int mlstm_chunk(const void* q, const void* k, const void* v,
                           const void* li, const void* lf, void* o,
                           const long long* strides, int types, int B,
                           int H, int S, int dqk, int dv, int chunk,
                           float scale, void* scratch, void* stream) {
  if (B < 0 || H < 1 || S < 0 || dqk < 1 || dqk > kMaxDqk || dv < 1 ||
      chunk < 1 || chunk > kL || static_cast<long long>(B) * H > 65535 ||
      reinterpret_cast<uintptr_t>(scratch) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || S == 0) return static_cast<int>(cudaGetLastError());
  const Dims d = make_dims(B, H, S, dqk, dv, chunk);
  const Scratch sc = carve(scratch, d, kCBytes);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);

  Streams io;
  io.q = q;
  io.k = k;
  io.v = v;
  io.o = o;
  const void* bases[kStreams] = {q, k, v, li, lf, o};
  const int widths[kStreams] = {dqk, dqk, dv, 1, 1, dv};
  for (int s = 0; s < kStreams; ++s) {
    io.bf16[s] = s == kO ? types & 1 : (types >> s) & 1;
    // 4 elements at a time: the width and every stride a multiple of 4,
    // the base aligned to 4 elements
    bool vec = widths[s] % 4 == 0 &&
               reinterpret_cast<uintptr_t>(bases[s]) %
                       (io.bf16[s] ? 8 : 16) == 0;
    for (int a = 0; a < 3; ++a) {
      io.st[s][a] = strides[3 * s + a];
      vec = vec && io.st[s][a] % 4 == 0;
    }
    io.vec[s] = vec;
  }

  static bool st_configured = false;
  static int out_configured = 0;          // the largest size set so far
  if (!st_configured) {
    const int err = set_smem(
        reinterpret_cast<const void*>(mlstm_chunk_kernel_states), kStSmem);
    if (err) return err;
    st_configured = true;
  }
  const int osmem = out_smem(d);
  if (osmem > out_configured) {
    const int err = set_smem(
        reinterpret_cast<const void*>(mlstm_chunk_kernel_outputs), osmem);
    if (err) return err;
    out_configured = osmem;
  }

  mlstm_chunk_kernel_gates<<<B * H, kGateThreads, 0, st>>>(
      gate_params(li, lf, strides, types, d, sc));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  StateParams sp;
  sp.io = io;
  sp.d = d;
  sp.s = sc;
  sp.scale = scale;
  const dim3 sgrid(d.dv_pad / kStV, d.dqk_pad / kStD, B * H);
  mlstm_chunk_kernel_states<<<sgrid, kStThreads, kStSmem, st>>>(sp);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  OutParams op;
  op.io = io;
  op.d = d;
  op.s = sc;
  op.scale = scale;
  const dim3 ogrid(d.n_chunks, 1, B * H);
  mlstm_chunk_kernel_outputs<<<ogrid, kOutThreads, osmem, st>>>(op);
  return static_cast<int>(cudaGetLastError());
}
