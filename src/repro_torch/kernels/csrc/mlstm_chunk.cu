// Chunkwise stabilized mLSTM (xLSTM matrix memory) for sm_90a.
//
// Replaces the TPU kernel `mlstm_chunk_kernel` / `_mlstm_kernel`
// (repro/kernels/mlstm_chunk.py:22-99).  It computes what the Pallas
// kernel computes, from a zero state (C = 0, n = 0, m = 0, not -inf):
// per (batch, head) a matrix memory C (dqk x dv), a normalizer n (dqk)
// and a scalar stabilizer m, carried over chunks of the sequence; within
// a chunk of c steps, with F = cumsum(logf), a = logi - F,
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
// sum_j w_j k_j, m1 = m_new_{c-1}.  k is scaled by dqk^-0.5.  All
// arithmetic is f32 with `expf` (no fast math); each of q, k, v, logi
// and logf is f32 or bf16, read in its own type; h has q's type.
//
// Bound on an H100 SXM (data-sheet rates): bytes.  At xlstm-350m's
// shape (B*H = 8, S = 4096, dqk = dv = 512, c = 128) the work needed is
// q k^T and S v over the causal pairs, q C from the second chunk on and
// k^T v up to the last chunk: 37.6 GFLOP a call, 0.038 ms at the bf16
// tensor-core rate, against 0.040 ms for reading q, k, v and the gates
// and writing h in bf16.  (The kernel itself computes the whole L x L
// of q k^T and S v, and q C in the first chunk too.)
//
// Design.  The TPU kernel kept C (1 MiB f32 at dqk = dv = 512) in VMEM
// across a sequential grid axis over chunks.  A block's shared memory
// holds at most 227 KB, so here the dv axis is split across blocks: a
// grid of (dv / 32, B*H), and each block owns C[:, tile] (dqk x 32 f32,
// 64 KB) and its own copy of n, walking all chunks in order itself.
// The denominator needs q . n over all of dqk; a block rebuilds it from
// the row sums of the masked q k^T (which every block of a head
// recomputes) and q . n0, so no block needs another's columns.  Per
// chunk:
//   1. warp 0 runs the gate scans (cumsum, cummax) by shuffles while the
//      other warps stage the chunk's v tile;
//   2. one loop over 32-wide dqk tiles of q and k (staged transposed in
//      shared memory) accumulates q k^T (128 x 128, an 8 x 8 register
//      tile a thread), q C[:, tile] (8 x 2 a thread) and q . n0;
//   3. the mask is applied, the row sums give the denominator, and the
//      masked scores go to shared memory for the product with v;
//   4. h is written, then a second pass over k updates C[:, tile] and n
//      (skipped after the last chunk: the kernel returns no state).
// Rows past the sequence's end (a ragged last chunk) are zero-padded
// and never written.  Offsets are 64-bit; q, k, v, the gates and h are
// read and written through (batch, head, step) strides, so the model's
// (B, S, H, d) layout goes in without a copy.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 128;      // largest chunk: rows of q k^T
constexpr int kTV = 32;          // dv columns a block owns
constexpr int kDK = 32;          // dqk dims staged per tile
constexpr int kPad = kChunk + 1; // row pitch of the transposed tiles
constexpr int kMaxDqk = 512;
constexpr int kGates = 7;        // per-row gate arrays in shared memory

enum Stream { kQ = 0, kK, kV, kLi, kLf, kO, kStreams };

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* li;
  const void* lf;
  void* o;
  long long st[kStreams][3];     // (batch, head, step) strides
  int types;                     // bit s set: stream s is bf16 (o: q's)
  int H, S, dqk, dv, chunk;
  float scale;
};

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

size_t shared_bytes(int dqk) {
  return sizeof(float) * (static_cast<size_t>(dqk) * kTV + dqk +
                          2 * kDK * kPad + kChunk * kPad + kChunk * kTV +
                          kGates * kChunk);
}

__global__ void __launch_bounds__(kThreads, 1)
    mlstm_chunk_kernel(const Params p) {
  extern __shared__ float smem[];
  __shared__ float chunk_end[2];          // Mc, m_new at the chunk's end
  const int dqk = p.dqk;
  float* cs = smem;                       // C[:, tile]   [dqk][kTV]
  float* ns = cs + dqk * kTV;             // n            [dqk]
  float* qt = ns + dqk;                   // q tile^T     [kDK][kPad]
  float* kt = qt + kDK * kPad;            // k tile^T     [kDK][kPad]
  float* ss = kt + kDK * kPad;            // masked S     [kChunk][kPad]
  float* vs = ss + kChunk * kPad;         // v tile       [kChunk][kTV]
  float* ga = vs + kChunk * kTV;          // a = logi - F
  float* gm = ga + kChunk;                // M
  float* gw = gm + kChunk;                // exp(m0 - M)
  float* gj = gw + kChunk;                // exp(a_j - Mc)
  float* gfl = gj + kChunk;               // exp(-m_new)
  float* gqn = gfl + kChunk;              // q . n0
  float* gden = gqn + kChunk;             // the denominator

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int lane = tid % 32, warp = tid / 32;
  const int e0 = blockIdx.x * kTV;
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  long long base[kStreams];
  for (int s = 0; s < kStreams; ++s)
    base[s] = b * p.st[s][0] + h * p.st[s][1];
  const int q16 = p.types & 1, k16 = (p.types >> 1) & 1;
  const int v16 = (p.types >> 2) & 1, li16 = (p.types >> 3) & 1;
  const int lf16 = (p.types >> 4) & 1;

  for (int i = tid; i < dqk * kTV; i += kThreads) cs[i] = 0.0f;
  for (int i = tid; i < dqk; i += kThreads) ns[i] = 0.0f;
  float m0 = 0.0f;

  for (int t0 = 0; t0 < p.S; t0 += p.chunk) {
    const int len = min(p.chunk, p.S - t0);
    __syncthreads();  // the last chunk's readers are done

    // -- 1. gate scans (warp 0) and the v tile (everyone) ----------------
    if (warp == 0) {
      constexpr int kPer = kChunk / 32;
      float f[kPer], a[kPer];
      float run = 0.0f;
      #pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int r = lane * kPer + i;
        float lfv = 0.0f, liv = 0.0f;
        if (r < len) {
          const long long at = static_cast<long long>(t0 + r);
          lfv = load(p.lf, lf16, base[kLf] + at * p.st[kLf][2]);
          liv = load(p.li, li16, base[kLi] + at * p.st[kLi][2]);
        }
        run += lfv;
        f[i] = run;
        a[i] = liv;
      }
      float incl = run;                   // inclusive scan of lane sums
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
        f[i] += excl;                     // F
        a[i] -= f[i];                     // a = logi - F
        mx = fmaxf(mx, a[i]);
      }
      float mincl = mx;                   // inclusive max scan
      #pragma unroll
      for (int off = 1; off < 32; off *= 2) {
        const float y = __shfl_up_sync(0xffffffffu, mincl, off);
        if (lane >= off) mincl = fmaxf(mincl, y);
      }
      float run_max = __shfl_up_sync(0xffffffffu, mincl, 1);
      if (lane == 0) run_max = -CUDART_INF_F;
      #pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int r = lane * kPer + i;
        run_max = fmaxf(run_max, a[i]);
        const float M = fmaxf(m0, run_max);
        const float m_new = f[i] + M;
        ga[r] = a[i];
        gm[r] = M;
        gw[r] = expf(m0 - M);
        gfl[r] = expf(-m_new);
        if (r == len - 1) {
          chunk_end[0] = M;
          chunk_end[1] = m_new;
        }
      }
    }
    for (int i = tid; i < kChunk * kTV; i += kThreads) {
      const int j = i / kTV, e = i % kTV;
      float val = 0.0f;
      if (j < len && e0 + e < p.dv)
        val = load(p.v, v16, base[kV] + (t0 + j) * p.st[kV][2] + e0 + e);
      vs[i] = val;
    }
    __syncthreads();
    if (tid < kChunk) gj[tid] = expf(ga[tid] - chunk_end[0]);

    // -- 2. q k^T, q C[:, tile] and q . n0 over dqk tiles ----------------
    float pk[8][8], qc[8][2], qn = 0.0f;
    #pragma unroll
    for (int i = 0; i < 8; ++i) {
      #pragma unroll
      for (int l = 0; l < 8; ++l) pk[i][l] = 0.0f;
      qc[i][0] = qc[i][1] = 0.0f;
    }
    for (int d0 = 0; d0 < dqk; d0 += kDK) {
      const int dn = min(kDK, dqk - d0);
      __syncthreads();  // the last tile's readers are done
      for (int i = tid; i < kChunk * kDK; i += kThreads) {
        const int t = i / kDK, d = i % kDK;
        float qv = 0.0f, kv = 0.0f;
        if (t < len && d < dn) {
          const long long row = static_cast<long long>(t0 + t);
          qv = load(p.q, q16, base[kQ] + row * p.st[kQ][2] + d0 + d);
          kv = load(p.k, k16, base[kK] + row * p.st[kK][2] + d0 + d) *
               p.scale;
        }
        qt[d * kPad + t] = qv;
        kt[d * kPad + t] = kv;
      }
      __syncthreads();
      if (tid < kChunk)
        for (int d = 0; d < dn; ++d) qn += qt[d * kPad + tid] * ns[d0 + d];
      for (int d = 0; d < dn; ++d) {
        float qv[8], kv[8];
        #pragma unroll
        for (int i = 0; i < 8; ++i) qv[i] = qt[d * kPad + ty + 16 * i];
        #pragma unroll
        for (int l = 0; l < 8; ++l) kv[l] = kt[d * kPad + tx + 16 * l];
        const float c0 = cs[(d0 + d) * kTV + tx];
        const float c1 = cs[(d0 + d) * kTV + tx + 16];
        #pragma unroll
        for (int i = 0; i < 8; ++i) {
          #pragma unroll
          for (int l = 0; l < 8; ++l) pk[i][l] = fmaf(qv[i], kv[l], pk[i][l]);
          qc[i][0] = fmaf(qv[i], c0, qc[i][0]);
          qc[i][1] = fmaf(qv[i], c1, qc[i][1]);
        }
      }
    }
    if (tid < kChunk) gqn[tid] = qn;
    __syncthreads();

    // -- 3. mask, row sums, denominator ---------------------------------
    #pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int t = ty + 16 * i;
      const float mt = gm[t];
      float rs = 0.0f;
      #pragma unroll
      for (int l = 0; l < 8; ++l) {
        const int j = tx + 16 * l;
        const float s = j <= t ? pk[i][l] * expf(ga[j] - mt) : 0.0f;
        ss[t * kPad + j] = s;
        rs += s;
      }
      #pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      if (tx == 0)
        gden[t] = fmaxf(fabsf(rs + gw[t] * gqn[t]), gfl[t]);
    }
    __syncthreads();

    // -- 4. numerator and h ---------------------------------------------
    {
      float acc[8][2];
      #pragma unroll
      for (int i = 0; i < 8; ++i) acc[i][0] = acc[i][1] = 0.0f;
      for (int j = 0; j < len; ++j) {
        const float v0 = vs[j * kTV + tx], v1 = vs[j * kTV + tx + 16];
        #pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float s = ss[(ty + 16 * i) * kPad + j];
          acc[i][0] = fmaf(s, v0, acc[i][0]);
          acc[i][1] = fmaf(s, v1, acc[i][1]);
        }
      }
      #pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int t = ty + 16 * i;
        if (t >= len) continue;
        const long long row =
            base[kO] + static_cast<long long>(t0 + t) * p.st[kO][2];
        #pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int e = e0 + tx + 16 * c;
          if (e < p.dv)
            store(p.o, q16, row + e,
                  (acc[i][c] + gw[t] * qc[i][c]) / gden[t]);
        }
      }
    }

    // -- 5. the state at the chunk's end --------------------------------
    if (t0 + len >= p.S) break;
    const float wc = expf(m0 - chunk_end[0]);
    for (int d0 = 0; d0 < dqk; d0 += kDK) {
      const int dn = min(kDK, dqk - d0);
      __syncthreads();  // readers of the k tile and of ss are done
      for (int i = tid; i < kChunk * kDK; i += kThreads) {
        const int j = i / kDK, d = i % kDK;
        float kv = 0.0f;
        if (j < len && d < dn)
          kv = load(p.k, k16, base[kK] + static_cast<long long>(t0 + j) *
                                             p.st[kK][2] + d0 + d) *
               p.scale * gj[j];
        kt[d * kPad + j] = kv;
      }
      __syncthreads();
      float acc[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
      for (int j = 0; j < len; ++j) {
        const float v0 = vs[j * kTV + tx], v1 = vs[j * kTV + tx + 16];
        #pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float kv = kt[(ty + 16 * i) * kPad + j];
          acc[i][0] = fmaf(kv, v0, acc[i][0]);
          acc[i][1] = fmaf(kv, v1, acc[i][1]);
        }
      }
      #pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int d = ty + 16 * i;
        if (d >= dn) continue;
        #pragma unroll
        for (int c = 0; c < 2; ++c) {
          float* cell = &cs[(d0 + d) * kTV + tx + 16 * c];
          *cell = wc * *cell + acc[i][c];
        }
      }
      if (tid < dn) {
        float sum = 0.0f;
        for (int j = 0; j < len; ++j) sum += kt[tid * kPad + j];
        ns[d0 + tid] = wc * ns[d0 + tid] + sum;
      }
    }
    m0 = chunk_end[1];
  }
}

}  // namespace

// -- C entry point (bound with ctypes) ---------------------------------------
//
// q/k (B*H, S, dqk) and v / o (B*H, S, dv) rows, logi / logf one value a
// row, each addressed as base + b * st[s][0] + h * st[s][1] + t *
// st[s][2] (+ the feature index, unit stride); `strides` holds the 18
// values in the order q, k, v, logi, logf, o.  `types` bit s is 1 where
// stream s (q, k, v, logi, logf) is bf16; o has q's type.  Requires
// 1 <= dqk <= 512, 1 <= chunk <= 128, B*H <= 65535.  Returns the
// launch's cudaError_t.
extern "C" int mlstm_chunk(const void* q, const void* k, const void* v,
                           const void* li, const void* lf, void* o,
                           const long long* strides, int types, int B,
                           int H, int S, int dqk, int dv, int chunk,
                           float scale, void* stream) {
  if (B < 0 || H < 1 || S < 0 || dqk < 1 || dqk > kMaxDqk || dv < 1 ||
      chunk < 1 || chunk > kChunk ||
      static_cast<long long>(B) * H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || S == 0) return static_cast<int>(cudaGetLastError());
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.li = li;
  p.lf = lf;
  p.o = o;
  for (int s = 0; s < kStreams; ++s)
    for (int a = 0; a < 3; ++a) p.st[s][a] = strides[3 * s + a];
  p.types = types;
  p.H = H;
  p.S = S;
  p.dqk = dqk;
  p.dv = dv;
  p.chunk = chunk;
  p.scale = scale;
  const size_t bytes = shared_bytes(dqk);
  cudaError_t err = cudaFuncSetAttribute(
      mlstm_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((dv + kTV - 1) / kTV, B * H);
  mlstm_chunk_kernel<<<grid, kThreads, bytes,
                       static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
