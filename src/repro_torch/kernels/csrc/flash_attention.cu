// Flash attention forward for the dense LM (sm_90a).
//
// Replaces the TPU kernel `flash_attention_kernel` / `_flash_kernel`
// (repro/kernels/flash_attention.py:28-111) behind the model's
// `flash_fn` hook.  It computes what the Pallas kernel computes:
//
//   o = softmax(mask(q * scale . k^T)) . v, per (batch, head),
//
// with masked scores set to -1e30, keys at or beyond `kv_len` masked,
// causal masking `q_offset + i >= j`, and the final division by
// max(l, 1e-30).  Inputs are f32 or bf16; the running max / sum and the
// accumulator are f32 (the reference casts q, k, p and v to f32); the
// output is cast to q's dtype.  GQA: head h reads kv head h / G, with
// h = hkv * G + g as in the model's `_sdpa` reshape.
//
// Layout: the kernels read (batch, seq, head, dim) tensors through
// element strides, so the model layout (B,S,H,D) needs no transpose and
// the kernel-level layout (B*H, S, D) is the same kernel with H = G and
// one kv head.  The last dim must be contiguous.  Ragged sequence tiles
// are masked in the kernel, so nothing is padded in device memory; the
// scale is the caller's (the true head dim's).
//
// Bound on an H100: operations.  At the yi-9b shape (B=2, H=32, S=4096,
// D=128, causal) the work is 2 * 2 * B*H*Sq*Skv*D / 2 = 0.27 TFLOP
// against 0.13 GB of q, k, v and o: 0.28 ms at the 989 TFLOP/s bf16
// tensor-core rate, 4.1 ms at the 67 TFLOP/s of the CUDA cores in f32.
//
// Two routes, chosen by the wrapper (kernels/ops.py `flash_route`):
//
// * `flash_attention_kernel_wgmma` (bf16, D = 64 or 128, 16-byte-aligned
//   bases and strides): the tensor-core design below the CUDA-core one.
//   q.k^T and p.v run as wgmma with f32 accumulators, the tiles arrive by
//   TMA into a ring guarded by mbarriers.
// * `flash_attention_kernel` (everything else: f32, whose 2e-5 gate is
//   beyond bf16 or TF32 tensor cores, other head dims, odd strides): the
//   products on the CUDA cores in f32.  Its floor is the 67 TFLOP/s f32
//   rate.
//
// The CUDA-core design: one block of 256 threads (8 warps, the SM's
// only block: the tiles take ~210 KB of shared memory) per (128-query
// tile, batch*head); 64 queries at D = 256, so that the accumulator still
// fits in registers.  The TPU kernel carried (acc, m, l) in VMEM scratch
// across a sequential KV grid axis; here the block loops over 128-key
// tiles itself and keeps the state in registers.  The threads form a
// 16 x 16 grid, (tq, tk), and a warp holds two tq rows of 16 tk lanes:
// a thread owns query rows tq + 16 i, keys tk + 16 j (j < 8) of the score
// tile and output columns tk * 4 + 64 c .. + 3 of the accumulator, so a
// row's max and sum are four xor-shuffles inside a warp.  Every tile in
// shared memory is f32 and row-major with padded rows, and every shared
// load is a float4 along the reduction axis: q.k^T takes 8 k and 8 q
// float4s for 256 FMAs (8 queries x 8 keys x 4 dims), p.v 8 p and 8 v
// float4s for 256 FMAs (8 queries x 8 columns x 4 keys), 16 FMAs a
// load; the paddings keep each load at the wavefronts its distinct bytes
// need.  q is loaded once, scaled in f32 as
// the reference scales it.  k and v stream through a ring of four 18 KB
// stages in chunks of 32 dims of k (128 keys each) and 4096 / D keys of
// v: a tile is ceil(D / 32) k chunks, then D / 32 v chunks, and three
// chunks are in flight under the current one's FMAs (cp.async for f32
// rows that are 16-byte aligned; loads through registers, which widen
// bf16, otherwise).  One __syncthreads a chunk orders the ring; the
// probability tile (each warp writes and reads only its own rows) needs
// no barrier of its own.  Only key tiles that cross kv_len, Skv or the
// diagonal pay for masks; tiles wholly above the diagonal or at or past
// kv_len are never loaded (their probabilities are exactly 0 for every
// row that has a valid key).  The grid runs as the tensor-core route's:
// the head is the fastest axis, so the G query heads of a kv head share
// its tiles in L2, and causal query tiles run heavy-first.  Numerics:
// masked scores -1e30 (keys past Skv -inf), expf of the score less the
// running max, f32 max, sum and accumulator, the output divided by
// max(l, 1e-30); `ref.flash_attention_tiled_ref` mirrors them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int kFlashThreads = 256;
constexpr int kBK = 128;            // keys per tile
constexpr int kKD = 32;             // dims of a k chunk
constexpr int kKP = kKD + 4;        // row pitch of a k chunk (128 keys)
constexpr int kPP = kBK + 16;       // row pitch of the probability tile
constexpr int kStages = 4;          // chunks in the ring
constexpr int kStageFloats = kBK * kKP;   // the larger of a k and a v chunk
constexpr float kMaskedScore = -1e30f;

// element strides of the (batch, seq, head) axes of q, k, v and o
struct FlashStrides {
  long long q[3], k[3], v[3], o[3];
};

template <int DMAX>
struct SimtTiles {
  static constexpr int kBQ = DMAX <= 128 ? 128 : 64;  // query rows a block
  static constexpr int kTQ = kBQ / 16;                 // rows a thread
  static constexpr int kTC = DMAX / 64;                // float4 columns a thread
  static constexpr int kQP = DMAX + 4;                 // row pitch of q and v
  static constexpr int kVRows = 4096 / DMAX;           // keys of a v chunk
  static constexpr int kVChunks = kBK / kVRows;
  static constexpr size_t kBytes =
      sizeof(float) * (kBQ * kQP + kBQ * kPP + kStages * kStageFloats);
  static_assert(kVRows * kQP <= kStageFloats, "a v chunk fits a stage");
};

__device__ __forceinline__ float lane4(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// 4 consecutive elements as f32 (16-byte aligned f32, 8-byte aligned bf16)
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// elements [k, k + 4) of a row of n as f32, zeros past n; one load where
// `vec` (n a multiple of 4 and p aligned).  (hopper.cuh's
// widen4(fetch_raw4(...)) computes the same; at this kernel's 255
// registers its bf16 route compiled slower through that form.)
template <typename T>
__device__ __forceinline__ float4 fetch4(const T* p, int k, int n, bool vec) {
  if (vec) return k < n ? load4(p) : make_float4(0.f, 0.f, 0.f, 0.f);
  float v[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = k + i < n ? to_f32(p[i]) : 0.0f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

// 4 elements of a row (of D) at dim d into shared memory as f32; zeros
// where the row is not `live` or past D.  cp.async where `vec` for f32;
// loads through registers (widening bf16) otherwise.
template <typename T>
__device__ __forceinline__ void stage4(float* dst, const T* src, bool live,
                                       int d, int D, bool vec) {
  if constexpr (std::is_same<T, float>::value) {
    if (vec) {
      hopper::cp16(dst, src, live && d < D ? 16 : 0);
      return;
    }
  }
  *reinterpret_cast<float4*>(dst) =
      live ? fetch4(src, d, D, vec) : make_float4(0.f, 0.f, 0.f, 0.f);
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(kFlashThreads, 1)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o,
                           FlashStrides st, int H, int G, int Sq, int Skv,
                           int D, int causal, int kv_len, int q_offset,
                           float scale, bool vec) {
  using L = SimtTiles<DMAX>;
  constexpr int kBQ = L::kBQ, kTQ = L::kTQ, kTC = L::kTC, kQP = L::kQP;
  constexpr int kVRows = L::kVRows;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                  // [kBQ][kQP], scaled
  float* ps = qs + kBQ * kQP;        // [kBQ][kPP], this tile's probabilities
  float* ring = ps + kBQ * kPP;      // kStages x [128][kKP] or [kVRows][kQP]

  const int h = blockIdx.x % H;
  const int b = blockIdx.x / H;
  const int hk = h / G;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;   // heavy first
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int tq = 2 * (tid / 32) + lane / 16;
  const int tk = lane % 16;

  const T* qb = q + b * st.q[0] + h * st.q[2];
  const T* kb = k + b * st.k[0] + hk * st.k[2];
  const T* vb = v + b * st.v[0] + hk * st.v[2];
  T* ob = o + b * st.o[0] + h * st.o[2];

  // the keys this tile can see: below kv_len and, causal, at or below the
  // last real query's position
  const int kv_lim = min(Skv, kv_len);
  int kv_end = kv_lim;
  if (causal) kv_end = min(kv_end, q_offset + min(q0 + kBQ, Sq));
  const int n_tiles = kv_end > 0 ? (kv_end + kBK - 1) / kBK : 0;
  const int n_k = (D + kKD - 1) / kKD;      // k chunks a tile: dims < D
  const int per_tile = n_k + L::kVChunks;
  const int total = n_tiles * per_tile;

  // chunk g of the stream into its stage, then one commit (empty past
  // the last tile, so the count of groups stays one a chunk)
  auto issue = [&](int g) {
    const int t = g / per_tile, c = g % per_tile;
    float* dst = ring + (g % kStages) * kStageFloats;
    if (t < n_tiles) {
      if (c < n_k) {       // keys t*128 .. +127, dims 32c .. 32c + 31
        for (int p = tid; p < kBK * kKD / 4; p += kFlashThreads) {
          const int r = p / (kKD / 4), d = c * kKD + (p % (kKD / 4)) * 4;
          const int key = t * kBK + r;
          stage4(dst + r * kKP + (p % (kKD / 4)) * 4,
                 kb + min(key, Skv - 1) * st.k[1] + d, key < Skv, d, D, vec);
        }
      } else {             // keys of v chunk c - n_k, every dim
        const int j0 = t * kBK + (c - n_k) * kVRows;
        for (int p = tid; p < kVRows * DMAX / 4; p += kFlashThreads) {
          const int r = p / (DMAX / 4), d = (p % (DMAX / 4)) * 4;
          const int key = j0 + r;
          stage4(dst + r * kQP + d, vb + min(key, Skv - 1) * st.v[1] + d,
                 key < Skv, d, D, vec);
        }
      }
    }
    hopper::cp_commit();
  };

#pragma unroll 1
  for (int g = 0; g < kStages - 1; ++g) issue(g);
  // the q tile under those copies, scaled in f32; zero past Sq and D
  for (int p = tid; p < kBQ * DMAX / 4; p += kFlashThreads) {
    const int r = p / (DMAX / 4), d = (p % (DMAX / 4)) * 4;
    const bool live = q0 + r < Sq;
    float4 x = live ? fetch4(qb + min(q0 + r, Sq - 1) * st.q[1] + d,
                                     d, D, vec)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
    x.x *= scale;
    x.y *= scale;
    x.z *= scale;
    x.w *= scale;
    *reinterpret_cast<float4*>(qs + r * kQP + d) = x;
  }

  float m[kTQ], l[kTQ], acc[kTQ][4 * kTC], sc[kTQ][8];
#pragma unroll
  for (int i = 0; i < kTQ; ++i) {
    m[i] = kMaskedScore;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < 4 * kTC; ++c) acc[i][c] = 0.0f;
  }

#pragma unroll 1
  for (int g = 0; g < total; ++g) {
    hopper::cp_wait<kStages - 2>();   // this thread's copies of chunk g
    __syncthreads();                  // everyone's; chunk g - 1 is free
    issue(g + kStages - 1);
    const float* cur = ring + (g % kStages) * kStageFloats;
    const int t = g / per_tile, c = g % per_tile;
    if (c < n_k) {
      // sc += q . k^T over dims 32c .. 32c + 31
      if (c == 0) {
#pragma unroll
        for (int i = 0; i < kTQ; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) sc[i][j] = 0.0f;
      }
#pragma unroll
      for (int dd = 0; dd < kKD; dd += 4) {
        float4 kf[8];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          kf[j] = *reinterpret_cast<const float4*>(cur + (tk + 16 * j) * kKP +
                                                   dd);
#pragma unroll
        for (int i = 0; i < kTQ; ++i) {
          const float4 qf = *reinterpret_cast<const float4*>(
              qs + (tq + 16 * i) * kQP + c * kKD + dd);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            sc[i][j] = fmaf(qf.x, kf[j].x, sc[i][j]);
            sc[i][j] = fmaf(qf.y, kf[j].y, sc[i][j]);
            sc[i][j] = fmaf(qf.z, kf[j].z, sc[i][j]);
            sc[i][j] = fmaf(qf.w, kf[j].w, sc[i][j]);
          }
        }
      }
      if (c == n_k - 1) {
        // mask (edge tiles only), then the online-softmax update of each
        // row; the probabilities go to this warp's rows of ps
        const int k0 = t * kBK;
        const bool edge =
            k0 + kBK > kv_lim || (causal && k0 + kBK - 1 > q_offset + q0);
#pragma unroll
        for (int i = 0; i < kTQ; ++i) {
          if (edge) {
            const int qpos = q_offset + q0 + tq + 16 * i;
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              const int kpos = k0 + tk + 16 * j;
              if (kpos >= Skv)
                sc[i][j] = -CUDART_INF_F;   // no such key: weight exactly 0
              else if (kpos >= kv_len || (causal && qpos < kpos))
                sc[i][j] = kMaskedScore;
            }
          }
          float mx = sc[i][0];
#pragma unroll
          for (int j = 1; j < 8; ++j) mx = fmaxf(mx, sc[i][j]);
#pragma unroll
          for (int off = 1; off < 16; off <<= 1)
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
          const float m_new = fmaxf(m[i], mx);
          const float alpha = expf(m[i] - m_new);
          float rs = 0.0f;
          float* prow = ps + (tq + 16 * i) * kPP + tk;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float pj = expf(sc[i][j] - m_new);
            prow[16 * j] = pj;
            rs += pj;
          }
#pragma unroll
          for (int off = 1; off < 16; off <<= 1)
            rs += __shfl_xor_sync(0xffffffffu, rs, off);
          l[i] = alpha * l[i] + rs;
          m[i] = m_new;
#pragma unroll
          for (int cc = 0; cc < 4 * kTC; ++cc) acc[i][cc] *= alpha;
        }
      }
    } else {
      // acc += p . v over the chunk's kVRows keys
      const int j0 = (c - n_k) * kVRows;
#pragma unroll 8
      for (int jj = 0; jj < kVRows; jj += 4) {
        float4 pf[kTQ];
#pragma unroll
        for (int i = 0; i < kTQ; ++i)
          pf[i] = *reinterpret_cast<const float4*>(ps + (tq + 16 * i) * kPP +
                                                   j0 + jj);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float4 vf[kTC];
#pragma unroll
          for (int cc = 0; cc < kTC; ++cc)
            vf[cc] = *reinterpret_cast<const float4*>(
                cur + (jj + e) * kQP + 64 * cc + tk * 4);
#pragma unroll
          for (int i = 0; i < kTQ; ++i) {
            const float pe = lane4(pf[i], e);
#pragma unroll
            for (int cc = 0; cc < kTC; ++cc) {
              acc[i][4 * cc] = fmaf(pe, vf[cc].x, acc[i][4 * cc]);
              acc[i][4 * cc + 1] = fmaf(pe, vf[cc].y, acc[i][4 * cc + 1]);
              acc[i][4 * cc + 2] = fmaf(pe, vf[cc].z, acc[i][4 * cc + 2]);
              acc[i][4 * cc + 3] = fmaf(pe, vf[cc].w, acc[i][4 * cc + 3]);
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kTQ; ++i) {
    const int r = q0 + tq + 16 * i;
    if (r >= Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* orow = ob + r * st.o[1];
#pragma unroll
    for (int cc = 0; cc < kTC; ++cc) {
      const int d = 64 * cc + tk * 4;
      const float out[4] = {acc[i][4 * cc] / den, acc[i][4 * cc + 1] / den,
                            acc[i][4 * cc + 2] / den,
                            acc[i][4 * cc + 3] / den};
      if (d < D) hopper::store4(orow + d, out, D - d, vec);
    }
  }
}

template <typename T, int DMAX>
int launch_flash(const void* q, const void* k, const void* v, void* o,
                 const FlashStrides& st, int B, int H, int G, int Sq,
                 int Skv, int D, int causal, int kv_len, int q_offset,
                 float scale, bool vec, cudaStream_t stream) {
  using L = SimtTiles<DMAX>;
  static bool configured = false;  // one flag per instantiation
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<T, DMAX>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(L::kBytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const long long n_q = (Sq + L::kBQ - 1) / L::kBQ;
  if (static_cast<long long>(B) * H > 0x7fffffffLL || n_q > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(B * H, static_cast<unsigned>(n_q));
  flash_attention_kernel<T, DMAX><<<grid, kFlashThreads, L::kBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), st, H, G, Sq, Skv, D,
      causal, kv_len, q_offset, scale, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_dim(const void* q, const void* k, const void* v, void* o,
                 const FlashStrides& st, int B, int H, int G, int Sq,
                 int Skv, int D, int causal, int kv_len, int q_offset,
                 float scale, cudaStream_t stream) {
  // 4 elements a load: D and every row stride multiples of 4, the bases
  // aligned to 4 elements
  constexpr int kAlign = 4 * sizeof(T);
  bool vec = D % 4 == 0 &&
             (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
              reinterpret_cast<uintptr_t>(v) |
              reinterpret_cast<uintptr_t>(o)) % kAlign == 0;
  for (int a = 0; a < 3; ++a)
    vec = vec && st.q[a] % 4 == 0 && st.k[a] % 4 == 0 && st.v[a] % 4 == 0 &&
          st.o[a] % 4 == 0;
  if (D <= 64)
    return launch_flash<T, 64>(q, k, v, o, st, B, H, G, Sq, Skv, D, causal,
                               kv_len, q_offset, scale, vec, stream);
  if (D <= 128)
    return launch_flash<T, 128>(q, k, v, o, st, B, H, G, Sq, Skv, D, causal,
                                kv_len, q_offset, scale, vec, stream);
  return launch_flash<T, 256>(q, k, v, o, st, B, H, G, Sq, Skv, D, causal,
                              kv_len, q_offset, scale, vec, stream);
}

}  // namespace

// -- the tensor-core route ----------------------------------------------------
//
// One block of 384 threads per (head, batch, 128-query tile): warpgroup 0
// is the producer, of which one thread issues every TMA load; warpgroups
// 1 and 2 are consumers, each owning 64 query rows.  The q tile (128 rows
// x D) is loaded once; the producer keeps a ring of kTcStages k and v
// tiles (128 keys x D each) in flight, each stage guarded by a `full`
// barrier (TMA bytes landed) and an `empty` one (all 256 consumer threads
// done with it).  The products are wgmma, bf16 in and f32 out:
//   S = q.k^T: 8 (D=128) or 4 (D=64) m64n128k16, both operands K-major as
//   stored;
//   acc += p.v: 8 m64nDk16, p packed to bf16 in registers (the score
//   accumulator's layout is the register A operand's), v read MN-major
//   (transpose bit set) from the swizzled tile.
// The online softmax runs in f32 registers: m, l and the accumulator stay
// f32, exp2 takes scale.log2(e) folded into one FMA, and only tiles that
// cross kv_len, Skv or the diagonal are masked.
//
// Two overlaps keep the tensor cores busy through the softmax (the
// FlashAttention-3 schedule):
// - inside a warpgroup, round t issues S_t = q.k_t^T and then
//   acc += p_{t-1}.v_{t-1}, and takes the softmax of S_t while the second
//   product runs, so p lives in two register sets;
// - between the warpgroups, two named barriers hand the right to issue
//   back and forth (ping-pong), so one warpgroup's products run while the
//   other takes its softmax; left alone the two would run in lockstep and
//   take their softmax at the same time.
// A warpgroup holds two stages (tile t's k, tile t-1's v), so the ring has
// three.  Both warpgroups take every key tile of the block, so their
// rounds pair up; a tile above all of a warpgroup's rows is masked whole
// and adds nothing.  Causal: the grid's last axis runs the query tiles in
// reverse, so the heaviest start first and the tail of the grid is short.
// GQA: the grid's fastest axis is the head, so the G heads that share a
// kv head run on neighbouring blocks and reuse its tiles from L2.  TMA fills rows past Sq / Skv with zeros and the
// kernel masks them; rows past Sq are not stored.  The output is written
// from registers, bf16 rounded to nearest even as torch's cast.

namespace {

constexpr int kTcBQ = 128;           // query rows per block
constexpr int kTcBK = 128;           // keys per tile
constexpr int kTcStages = 3;         // k/v tiles in flight
constexpr int kTcThreads = 384;      // producer + two consumer warpgroups
constexpr int kTcConsumers = 256;
constexpr int kTcBox = 128 * 128;    // bytes of a 128-row x 64-column box
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;

template <int D>
struct TcLayout {
  static constexpr int kChunks = D / hopper::kBoxElems;  // boxes across D
  static constexpr int kTileBytes = kChunks * kTcBox;    // q, k or v tile
  static constexpr int kQ = 0;
  static constexpr int kKV = kTileBytes;  // stage s: k, then v
  static constexpr int kBars = kKV + kTcStages * 2 * kTileBytes;
  static constexpr int kBytes =
      kBars + (1 + 2 * kTcStages) * 8 + static_cast<int>(hopper::kAtomBytes);
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 2^x on the special-function unit, flushing subnormal results to 0 (a
// probability below 2^-126 of the row's largest is 0 in bf16 anyway)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// the ping-pong between the consumer warpgroups: wait for this one's turn
// to issue products, and hand the turn to the other (named barriers 1, 2)
__device__ __forceinline__ void turn_wait(int w) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(1 + w) : "memory");
}
__device__ __forceinline__ void turn_pass(int w) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - w) : "memory");
}

template <int D>
__device__ __forceinline__ void wgmma_pv(float (&acc)[D / 2],
                                         const uint32_t (&a)[4], uint64_t b);
template <>
__device__ __forceinline__ void wgmma_pv<64>(float (&acc)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  hopper::wgmma_rs_m64n64<1>(acc, a, b, 1);
}
template <>
__device__ __forceinline__ void wgmma_pv<128>(float (&acc)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  hopper::wgmma_rs_m64n128<1>(acc, a, b, 1);
}

// the masks of one score tile (where it crosses kv_len, Skv or the
// diagonal), then the online softmax of its rows a and a + 8 in place:
// sc becomes p (f32), m and l are updated, and alpha is the factor that
// takes the accumulator from the old max to the new
__device__ __forceinline__ void tile_softmax(
    float (&sc)[64], float& m_a, float& m_b, float& l_a, float& l_b,
    float& alpha_a, float& alpha_b, bool edge, int k0, int col, int qpos_a,
    int Skv, int kv_len, int causal, float scale_log2) {
  if (edge) {
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kpos = k0 + 8 * j + col + e;
        if (kpos >= Skv) {
          sc[4 * j + e] = -CUDART_INF_F;   // no such key: weight 0
          sc[4 * j + 2 + e] = -CUDART_INF_F;
        } else {
          const bool out = kpos >= kv_len;
          if (out || (causal && qpos_a < kpos)) sc[4 * j + e] = kMaskedScore;
          if (out || (causal && qpos_a + 8 < kpos))
            sc[4 * j + 2 + e] = kMaskedScore;
        }
      }
  }
  float mx_a = -CUDART_INF_F, mx_b = -CUDART_INF_F;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    mx_a = fmaxf(mx_a, fmaxf(sc[4 * j], sc[4 * j + 1]));
    mx_b = fmaxf(mx_b, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {    // the 4 lanes of a row
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
  }
  const float mn_a = fmaxf(m_a, mx_a);
  const float mn_b = fmaxf(m_b, mx_b);
  alpha_a = ex2((m_a - mn_a) * scale_log2);
  alpha_b = ex2((m_b - mn_b) * scale_log2);
  const float ms_a = mn_a * scale_log2;
  const float ms_b = mn_b * scale_log2;
  m_a = mn_a;
  m_b = mn_b;
  float rs_a = 0.0f, rs_b = 0.0f;
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      sc[4 * j + e] = ex2(fmaf(sc[4 * j + e], scale_log2, -ms_a));
      sc[4 * j + 2 + e] = ex2(fmaf(sc[4 * j + 2 + e], scale_log2, -ms_b));
      rs_a += sc[4 * j + e];
      rs_b += sc[4 * j + 2 + e];
    }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    rs_a += __shfl_xor_sync(0xffffffffu, rs_a, off);
    rs_b += __shfl_xor_sync(0xffffffffu, rs_b, off);
  }
  l_a = alpha_a * l_a + rs_a;
  l_b = alpha_b * l_b + rs_b;
}

// p (f32, the score accumulator's layout) packed to bf16 as the register
// A operand of the p.v products: keys 16 kk .. 16 kk + 15 in p[kk]
__device__ __forceinline__ void pack_p(const float (&sc)[64],
                                       uint32_t (&p)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    p[kk][0] = pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
    p[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
    p[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
    p[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
  }
}

template <int N>
__device__ __forceinline__ void rescale(float (&acc)[N], float alpha_a,
                                        float alpha_b) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    acc[4 * j] *= alpha_a;
    acc[4 * j + 1] *= alpha_a;
    acc[4 * j + 2] *= alpha_b;
    acc[4 * j + 3] *= alpha_b;
  }
}

// S = q.k^T of one key tile, one commit group
template <int D>
__device__ __forceinline__ void issue_scores(float (&sc)[64], uint32_t q_base,
                                             uint32_t k_base) {
  hopper::fence_regs(sc);
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk / 4) * kTcBox + (kk % 4) * 32;
    hopper::wgmma_ss_m64n128<0>(
        sc, hopper::smem_desc(q_base + off, 16, hopper::kAtomBytes),
        hopper::smem_desc(k_base + off, 16, hopper::kAtomBytes), kk > 0);
  }
  hopper::wgmma_commit();
}

// acc += p.v over one key tile, one commit group
template <int D>
__device__ __forceinline__ void issue_pv(float (&acc)[D / 2],
                                         const uint32_t (&p)[8][4],
                                         uint32_t v_base) {
  hopper::fence_regs(acc);
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    wgmma_pv<D>(acc, p[kk],
                hopper::smem_desc(v_base + kk * 16 * 128, kTcBox,
                                  hopper::kAtomBytes));
  hopper::wgmma_commit();
}

template <int D>
__global__ void __launch_bounds__(kTcThreads, 1)
    flash_attention_kernel_wgmma(const __grid_constant__ CUtensorMap tq,
                                 const __grid_constant__ CUtensorMap tk,
                                 const __grid_constant__ CUtensorMap tv,
                                 __nv_bfloat16* __restrict__ o,
                                 long long os_b, long long os_s,
                                 long long os_h, int G, int Sq, int Skv,
                                 int causal, int kv_len, int q_offset,
                                 float scale_log2) {
  using L = TcLayout<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hopper::atom_aligned(smem_raw);
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* full = bar_q + 1;
  uint64_t* empty = full + kTcStages;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kTcBQ;
  const int hk = h / G;
  const int kv_lim = min(Skv, kv_len);
  int kv_end = kv_lim;
  if (causal) kv_end = min(kv_end, q_offset + min(q0 + kTcBQ, Sq));
  const int n_tiles = kv_end > 0 ? (kv_end + kTcBK - 1) / kTcBK : 0;

  const int tid = threadIdx.x;
  if (tid == 0) {
    hopper::mbar_init(bar_q, 1);
    for (int s = 0; s < kTcStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], kTcConsumers);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (tid < 128) {
    // -- producer: one thread drives the TMA ring --------------------------
    hopper::setmaxnreg_dec<kProducerRegs>();
    if (tid == 0) {
      hopper::mbar_expect_tx(bar_q, L::kTileBytes);
      for (int c = 0; c < L::kChunks; ++c)
        hopper::tma_load_4d(smem + L::kQ + c * kTcBox, &tq, bar_q,
                            c * hopper::kBoxElems, q0, h, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kTcStages;
        hopper::mbar_wait(&empty[s], ((t / kTcStages) & 1) ^ 1);
        hopper::mbar_expect_tx(&full[s], 2 * L::kTileBytes);
        uint8_t* ks = smem + L::kKV + s * 2 * L::kTileBytes;
        for (int c = 0; c < L::kChunks; ++c) {
          hopper::tma_load_4d(ks + c * kTcBox, &tk, &full[s],
                              c * hopper::kBoxElems, t * kTcBK, hk, b);
          hopper::tma_load_4d(ks + L::kTileBytes + c * kTcBox, &tv, &full[s],
                              c * hopper::kBoxElems, t * kTcBK, hk, b);
        }
      }
    }
  } else {
    // -- consumers: 64 query rows per warpgroup ----------------------------
    hopper::setmaxnreg_inc<kConsumerRegs>();
    const int w = tid / 128 - 1;
    const int warp = (tid % 128) / 32;
    const int lane = tid % 32;
    const int row_a = w * 64 + warp * 16 + lane / 4;  // and row_a + 8
    const int col = 2 * (lane % 4);
    const int qpos_a = q_offset + q0 + row_a;
    const int qpos_lo = q_offset + q0 + w * 64;       // this half's rows

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
    float sc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) sc[i] = 0.0f;
    uint32_t p[8][4];
    float m_a = kMaskedScore, m_b = kMaskedScore, l_a = 0.0f, l_b = 0.0f;
    const uint32_t q_base =
        hopper::smem_u32(smem + L::kQ) + w * 64 * 128;   // 64 rows of 128 B
    const uint32_t kv_base = hopper::smem_u32(smem + L::kKV);

    hopper::mbar_wait(bar_q, 0);
    // Rounds 0 .. n_tiles: round t issues S_t (t < n_tiles), rescales the
    // accumulator to the max of tiles up to t - 1 and issues
    // acc += p_{t-1}.v_{t-1} (t > 0), then takes the softmax of S_t while
    // that product runs, and packs p_t once it is done.  The first and
    // last rounds are peeled off the loop: a wgmma under a branch makes
    // ptxas serialize them all.
    if (n_tiles > 0) {
      if (w == 1) turn_pass(w);                  // warpgroup 0 issues first
      float alpha_a, alpha_b;
      hopper::mbar_wait(&full[0], 0);
      turn_wait(w);
      issue_scores<D>(sc, q_base, kv_base);
      turn_pass(w);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(sc);
      tile_softmax(sc, m_a, m_b, l_a, l_b, alpha_a, alpha_b,
                   kTcBK > kv_lim || (causal && kTcBK - 1 > qpos_lo), 0,
                   col, qpos_a, Skv, kv_len, causal, scale_log2);
      pack_p(sc, p);
      for (int t = 1; t < n_tiles; ++t) {
        const int s = t % kTcStages;
        const int sp = (t - 1) % kTcStages;
        hopper::mbar_wait(&full[s], (t / kTcStages) & 1);
        turn_wait(w);
        issue_scores<D>(sc, q_base, kv_base + s * 2 * L::kTileBytes);
        rescale(acc, alpha_a, alpha_b);
        issue_pv<D>(acc, p,
                    kv_base + sp * 2 * L::kTileBytes + L::kTileBytes);
        turn_pass(w);
        hopper::wgmma_wait<1>();         // S_t done, the p.v may still run
        hopper::fence_regs(sc);
        const int k0 = t * kTcBK;
        const bool edge =
            k0 + kTcBK > kv_lim || (causal && k0 + kTcBK - 1 > qpos_lo);
        tile_softmax(sc, m_a, m_b, l_a, l_b, alpha_a, alpha_b, edge, k0, col,
                     qpos_a, Skv, kv_len, causal, scale_log2);
        hopper::wgmma_wait<0>();
        hopper::fence_regs(acc);
        hopper::mbar_arrive(&empty[sp]);
        pack_p(sc, p);
      }
      const int sl = (n_tiles - 1) % kTcStages;
      turn_wait(w);
      rescale(acc, alpha_a, alpha_b);
      issue_pv<D>(acc, p, kv_base + sl * 2 * L::kTileBytes + L::kTileBytes);
      turn_pass(w);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      hopper::mbar_arrive(&empty[sl]);
      if (w == 0) turn_wait(w);    // warpgroup 1's last pass: the turns balance
    }

    const float den_a = fmaxf(l_a, 1e-30f);
    const float den_b = fmaxf(l_b, 1e-30f);
    const int r_a = q0 + row_a;
    __nv_bfloat16* ob = o + b * os_b + h * os_h;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int d = 8 * j + col;
      if (r_a < Sq)
        *reinterpret_cast<uint32_t*>(ob + r_a * os_s + d) =
            pack_bf16(acc[4 * j] / den_a, acc[4 * j + 1] / den_a);
      if (r_a + 8 < Sq)
        *reinterpret_cast<uint32_t*>(ob + (r_a + 8) * os_s + d) =
            pack_bf16(acc[4 * j + 2] / den_b, acc[4 * j + 3] / den_b);
    }
  }
}

// (D, S, head, batch) map of a bf16 q, k or v with element strides `st`
// (batch, seq, head); boxes of 64 dims x 128 rows
int flash_map(CUtensorMap* map, const void* base, const long long* st, int D,
              int S, int H, int B) {
  const uint64_t dims[4] = {static_cast<uint64_t>(D),
                            static_cast<uint64_t>(S),
                            static_cast<uint64_t>(H),
                            static_cast<uint64_t>(B)};
  const int64_t strides[3] = {2 * st[1], 2 * st[2], 2 * st[0]};
  const uint32_t box[4] = {hopper::kBoxElems, 128, 1, 1};
  return hopper::make_tensor_map(map, base, 4, dims, strides, box);
}

template <int D>
int launch_flash_wgmma(const void* q, const void* k, const void* v, void* o,
                       const FlashStrides& st, int B, int H, int Hkv, int Sq,
                       int Skv, int causal, int kv_len, int q_offset,
                       float scale, cudaStream_t stream) {
  using L = TcLayout<D>;
  static bool configured = false;  // one flag per instantiation
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel_wgmma<D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  CUtensorMap tq, tk, tv;
  int err = flash_map(&tq, q, st.q, D, Sq, H, B);
  if (!err) err = flash_map(&tk, k, st.k, D, Skv, Hkv, B);
  if (!err) err = flash_map(&tv, v, st.v, D, Skv, Hkv, B);
  if (err) return err;
  const dim3 grid(H, B, (Sq + kTcBQ - 1) / kTcBQ);
  flash_attention_kernel_wgmma<D><<<grid, kTcThreads, L::kBytes, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), st.o[0], st.o[1], st.o[2],
      H / Hkv, Sq, Skv, causal, kv_len, q_offset,
      scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// -- C entry point (bound with ctypes) ----------------------------------------
//
// q (B,Sq,H,D), k/v (B,Skv,Hkv,D), o (B,Sq,H,D), addressed through
// `strides`: 12 element strides, (batch, seq, head) of q, k, v, o in that
// order; the last dim is contiguous.  `bf16` selects the input type (0:
// f32, 1: bf16); o has q's type.  Requires 1 <= D <= 256, H % Hkv == 0.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, const long long* strides, int bf16,
                               int B, int H, int Hkv, int Sq, int Skv, int D,
                               int causal, int kv_len, int q_offset,
                               float scale, void* stream) {
  if (D < 1 || D > 256 || Hkv < 1 || H % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || H == 0 || Sq == 0) return static_cast<int>(cudaGetLastError());
  FlashStrides st;
  for (int a = 0; a < 3; ++a) {
    st.q[a] = strides[a];
    st.k[a] = strides[3 + a];
    st.v[a] = strides[6 + a];
    st.o[a] = strides[9 + a];
  }
  const int G = H / Hkv;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return dispatch_dim<__nv_bfloat16>(q, k, v, o, st, B, H, G, Sq, Skv, D,
                                       causal, kv_len, q_offset, scale, s);
  return dispatch_dim<float>(q, k, v, o, st, B, H, G, Sq, Skv, D, causal,
                             kv_len, q_offset, scale, s);
}

// The tensor-core route: the same arguments for bf16 q, k, v, o with
// D = 64 or 128, 16-byte-aligned bases and every stride a multiple of 8
// elements (the wrapper's `flash_route` checks this first).
extern "C" int flash_attention_wgmma(const void* q, const void* k,
                                     const void* v, void* o,
                                     const long long* strides, int B, int H,
                                     int Hkv, int Sq, int Skv, int D,
                                     int causal, int kv_len, int q_offset,
                                     float scale, void* stream) {
  if ((D != 64 && D != 128) || Hkv < 1 || H % Hkv != 0 || B > 65535 ||
      (Sq + kTcBQ - 1) / kTcBQ > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int a = 0; a < 12; ++a)
    if (strides[a] % 8) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || H == 0 || Sq == 0) return static_cast<int>(cudaGetLastError());
  FlashStrides st;
  for (int a = 0; a < 3; ++a) {
    st.q[a] = strides[a];
    st.k[a] = strides[3 + a];
    st.v[a] = strides[6 + a];
    st.o[a] = strides[9 + a];
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch_flash_wgmma<64>(q, k, v, o, st, B, H, Hkv, Sq, Skv, causal,
                                  kv_len, q_offset, scale, s);
  return launch_flash_wgmma<128>(q, k, v, o, st, B, H, Hkv, Sq, Skv, causal,
                                 kv_len, q_offset, scale, s);
}
