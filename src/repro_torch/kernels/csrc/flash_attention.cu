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
// max(l, 1e-30).  Inputs are f32 or bf16; every product, the running
// max / sum and the accumulator are f32 (the reference casts q, k, p and v
// to f32); the output is cast to q's dtype.  GQA: head h reads kv head
// h / G, with h = hkv * G + g as in the model's `_sdpa` reshape.
//
// Layout: the kernel reads (batch, seq, head, dim) tensors through
// element strides, so the model layout (B,S,H,D) needs no transpose and
// the kernel-level layout (B*H, S, D) is the same kernel with H = G and
// one kv head.  The last dim must be contiguous.  Head dims up to 256 are
// padded to 64 / 128 / 256 in shared memory with zeros (which add nothing
// to a dot product), and ragged sequence tiles are masked in the kernel,
// so nothing is padded in device memory; the scale is the caller's (the
// true head dim's).
//
// Bound on an H100: operations.  At the yi-9b shape (B=2, H=32, S=4096,
// D=128, causal) the work is 2 * 2 * B*H*Sq*Skv*D / 2 = 0.27 TFLOP
// against 0.13 GB of q, k, v and o.  This first version runs the
// products on the CUDA cores in f32 (no tensor cores): its floor is the
// 67 TFLOP/s f32 rate, not the 989 TFLOP/s bf16 tensor-core rate, and its
// inner loops are bound by shared-memory loads (12 per 32 FMAs).
// wgmma, TMA and warp specialisation are the lever for a later change.
//
// Design: one block of 128 threads per (batch*head, 64-query tile).  The
// TPU kernel carried (acc, m, l) in VMEM scratch across a sequential KV
// grid axis; here the block loops over 64-key tiles itself and keeps the
// state in registers.  A thread owns 4 query rows x 8 keys of the score
// tile and the same 4 rows x D/8 columns of the accumulator; the 8 lanes
// that share rows sit in one warp, so row max and row sum are three
// xor-shuffles, and the probability tile goes through shared memory with
// only a warp barrier between its writers and readers.  Key tiles wholly
// above the diagonal (causal) or at or past kv_len are never loaded:
// their probabilities are exactly 0 for every row that has a valid key.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kBQ = 64;             // query rows per block
constexpr int kBK = 64;             // keys per tile
constexpr int kFlashThreads = 128;
constexpr int kRows = 4;            // query rows per thread (16 row groups)
constexpr int kCols = 8;            // key / output-column lanes per row group
constexpr float kMaskedScore = -1e30f;

static_assert(kBQ == kRows * (kFlashThreads / kCols), "row tiling");
static_assert(kBK % kCols == 0, "key tiling");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's cast
}

// element strides of the (batch, seq, head) axes of q, k, v and o
struct FlashStrides {
  long long q[3], k[3], v[3], o[3];
};

template <int DMAX>
constexpr size_t flash_smem_bytes() {
  // q and k rows padded by one float against bank conflicts
  return sizeof(float) * (kBQ * (DMAX + 1) + kBK * (DMAX + 1) +
                          kBK * DMAX + kBQ * (kBK + 1));
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(kFlashThreads)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o,
                           FlashStrides st, int H, int G, int Sq, int Skv,
                           int D, int causal, int kv_len, int q_offset,
                           float scale) {
  constexpr int QS = DMAX + 1;
  constexpr int KS = DMAX + 1;
  constexpr int VS = DMAX;
  constexpr int PS = kBK + 1;
  constexpr int kDC = DMAX / kCols;  // accumulator columns per thread
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + kBQ * QS;
  float* vs = ks + kBK * KS;
  float* ps = vs + kBK * VS;

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int hk = h / G;
  const int q0 = blockIdx.y * kBQ;
  const int tid = threadIdx.x;
  const int tx = tid % kCols;
  const int row0 = (tid / kCols) * kRows;

  const T* qb = q + b * st.q[0] + h * st.q[2];
  const T* kb = k + b * st.k[0] + hk * st.k[2];
  const T* vb = v + b * st.v[0] + hk * st.v[2];
  T* ob = o + b * st.o[0] + h * st.o[2];

  // the q tile, scaled in f32 as the reference scales it; zero past Sq, D
  for (int i = tid; i < kBQ * DMAX; i += kFlashThreads) {
    const int r = i / DMAX;
    const int d = i % DMAX;
    float x = 0.0f;
    if (q0 + r < Sq && d < D) x = to_f32(qb[(q0 + r) * st.q[1] + d]) * scale;
    qs[r * QS + d] = x;
  }

  float m[kRows], l[kRows], acc[kRows][kDC];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kMaskedScore;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < kDC; ++c) acc[i][c] = 0.0f;
  }

  // the keys this tile can see: below kv_len and, causal, at or below the
  // last real query's position
  int kv_end = min(Skv, kv_len);
  if (causal) kv_end = min(kv_end, q_offset + min(q0 + kBQ, Sq));
  const int n_tiles = kv_end > 0 ? (kv_end + kBK - 1) / kBK : 0;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // the last tile's readers are done
    for (int i = tid; i < kBK * DMAX; i += kFlashThreads) {
      const int r = i / DMAX;
      const int d = i % DMAX;
      float kx = 0.0f, vx = 0.0f;
      if (k0 + r < Skv && d < D) {
        kx = to_f32(kb[(k0 + r) * st.k[1] + d]);
        vx = to_f32(vb[(k0 + r) * st.v[1] + d]);
      }
      ks[r * KS + d] = kx;
      vs[r * VS + d] = vx;
    }
    __syncthreads();

    // scores: rows row0.., keys tx + j * kCols
    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < DMAX; ++d) {
      float qv[kRows], kv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = qs[(row0 + i) * QS + d];
#pragma unroll
      for (int j = 0; j < kCols; ++j) kv[j] = ks[(tx + j * kCols) * KS + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // mask, then the online-softmax update of each row
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qpos = q_offset + q0 + row0 + i;
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kpos = k0 + tx + j * kCols;
        if (kpos >= Skv)
          s[i][j] = -CUDART_INF_F;  // no such key: weight exactly 0
        else if (kpos >= kv_len || (causal && qpos < kpos))
          s[i][j] = kMaskedScore;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 1; off < kCols; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = expf(s[i][j] - m_new);
        ps[(row0 + i) * PS + tx + j * kCols] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 1; off < kCols; off <<= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = alpha * l[i] + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kDC; ++c) acc[i][c] *= alpha;
    }
    __syncwarp();  // a row's probabilities come from lanes of this warp

    // acc += p . v over the tile's keys, in f32
#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float pv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = ps[(row0 + i) * PS + j];
#pragma unroll
      for (int c = 0; c < kDC; ++c) {
        const float vv = vs[j * VS + tx + c * kCols];
#pragma unroll
        for (int i = 0; i < kRows; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = q0 + row0 + i;
    if (r >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < kDC; ++c) {
      const int d = tx + c * kCols;
      if (d < D) ob[r * st.o[1] + d] = from_f32<T>(acc[i][c] / denom);
    }
  }
}

template <typename T, int DMAX>
int launch_flash(const void* q, const void* k, const void* v, void* o,
                 const FlashStrides& st, int B, int H, int G, int Sq,
                 int Skv, int D, int causal, int kv_len, int q_offset,
                 float scale, cudaStream_t stream) {
  constexpr size_t smem = flash_smem_bytes<DMAX>();
  static bool configured = false;  // one flag per instantiation
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<T, DMAX>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid(B * H, (Sq + kBQ - 1) / kBQ);
  flash_attention_kernel<T, DMAX><<<grid, kFlashThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), st, H, G, Sq, Skv, D,
      causal, kv_len, q_offset, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_dim(const void* q, const void* k, const void* v, void* o,
                 const FlashStrides& st, int B, int H, int G, int Sq,
                 int Skv, int D, int causal, int kv_len, int q_offset,
                 float scale, cudaStream_t stream) {
  if (D <= 64)
    return launch_flash<T, 64>(q, k, v, o, st, B, H, G, Sq, Skv, D, causal,
                               kv_len, q_offset, scale, stream);
  if (D <= 128)
    return launch_flash<T, 128>(q, k, v, o, st, B, H, G, Sq, Skv, D, causal,
                                kv_len, q_offset, scale, stream);
  return launch_flash<T, 256>(q, k, v, o, st, B, H, G, Sq, Skv, D, causal,
                              kv_len, q_offset, scale, stream);
}

}  // namespace

// -- C entry point (bound with ctypes) ---------------------------------------
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
