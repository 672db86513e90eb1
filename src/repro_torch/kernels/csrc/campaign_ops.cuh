// The campaign tick's per-row bodies, shared by the per-op kernels
// (campaign_sweep.cu) and the persistent sweep kernel
// (campaign_sweep_fused.cu), so both routes round the same way.
//
// Rounding: the allocator is exact only if `inc*s + 1e-3` is rounded as
// two IEEE operations, as the JAX reference computes it.  nvcc would
// contract the pair into one FMA, so every float operation here is an
// explicit round-to-nearest intrinsic (__fmul_rn, __fadd_rn, __fsub_rn,
// __fdiv_rn), which nvcc never contracts.  The one exception is `ndtri`,
// which mirrors PyTorch's CUDA `torch.special.ndtri` and takes the fused
// multiply-adds that PyTorch's compiled version of it takes.  Never build
// with --use_fast_math.

#pragma once

#include <cuda_runtime.h>

namespace campaign {

// -- the proportional integer allocator --------------------------------------
//
// A row of C counts and a total k: cell c takes
//   floor(inc_c * s + 1e-3) - floor(exc_c * s + 1e-3),  s = min(k, tot) / tot,
// with inc_c / exc_c the inclusive / exclusive running sums, so the row
// takes min(k, tot) in all (cumulative largest-remainder rounding).

__device__ __forceinline__ float alloc_scale(int k, int tot) {
  const int kk = min(k, tot);
  return __fdiv_rn(__int2float_rn(kk), __int2float_rn(max(tot, 1)));
}

// cell share from the inclusive running sum `run` and the cell's count x
__device__ __forceinline__ int alloc_share(int run, int x, float s) {
  const float inc = __int2float_rn(run);
  const float exc = __fsub_rn(inc, __int2float_rn(x));
  const float hi = floorf(__fadd_rn(__fmul_rn(inc, s), 1e-3f));
  const float lo = floorf(__fadd_rn(__fmul_rn(exc, s), 1e-3f));
  return static_cast<int>(__fsub_rn(hi, lo));
}

// One thread walks the row twice (total, then shares) and hands each
// cell's share to take(c, share) in order; take may overwrite row[c],
// which is read before its share is handed over.
template <class Take>
__device__ __forceinline__ void alloc_row(const int* row, int k, int C,
                                          Take&& take) {
  int tot = 0;
  for (int c = 0; c < C; ++c) tot += row[c];
  const float s = alloc_scale(k, tot);
  int run = 0;
  for (int c = 0; c < C; ++c) {
    const int x = row[c];
    run += x;
    take(c, alloc_share(run, x, s));
  }
}

// -- progress advance ---------------------------------------------------------
//
// Jobs at steps flagged by fin_mask finish; the rest move one step on.
// Returns the finished count.  `advanced` may be `busy` itself: step w is
// read before it is written.
__device__ __forceinline__ int advance_row(const int* busy,
                                           const int* fin_mask,
                                           int* advanced, int W) {
  int done = 0;
  int carry = 0;  // survivors of step w-1, moving into step w
  for (int w = 0; w < W; ++w) {
    const int b = busy[w];
    const int f = b * fin_mask[w];
    done += f;
    advanced[w] = carry;
    carry = b - f;
  }
  return done;
}

// -- billing ------------------------------------------------------------------
//
// One lane: amt_g = float(live_g) * rate_g; spent = sum_g amt_g and
// by_prov[p] = sum_g amt_g * onehot[g][p], each summed over the groups
// left to right in f32.
__device__ __forceinline__ void bill_lane(const int* live, const float* rate,
                                          const float* onehot, int G, int P,
                                          float* spent, float* by_prov) {
  float total = 0.0f;
  for (int g = 0; g < G; ++g)
    total = __fadd_rn(total, __fmul_rn(__int2float_rn(live[g]), rate[g]));
  *spent = total;
  for (int p = 0; p < P; ++p) {
    float acc = 0.0f;
    for (int g = 0; g < G; ++g) {
      const float amt = __fmul_rn(__int2float_rn(live[g]), rate[g]);
      acc = __fadd_rn(acc, __fmul_rn(amt, onehot[g * P + p]));
    }
    by_prov[p] = acc;
  }
}

// -- the preemption draw ------------------------------------------------------

// Word 0 of Philox-4x32-10 (Salmon et al., SC'11) at key (k0, k1) and
// counter (c0, c1, 0, 0), top 24 bits as a float in [0, 1): the engine's
// `philox_uniforms` at key (seed low, seed high), counter (tick, group).
__device__ __forceinline__ float philox_uniform(unsigned k0, unsigned k1,
                                                unsigned c0, unsigned c1) {
  unsigned c2 = 0u, c3 = 0u;
  for (int r = 0; r < 10; ++r) {
    const unsigned hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
    const unsigned hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return __fmul_rn(__uint2float_rn(c0 >> 8), 0x1p-24f);
}

// Cephes' ndtri as PyTorch's CUDA `torch.special.ndtri` computes it in
// f32 (the jiterator's `ndtri`, compiled with fused multiply-adds): the
// Horner steps and `y + y * r` are single roundings, every other
// operation its own.  Only y0 in [1e-7, 1 - 1e-7] reaches it, so
// sqrt(-2 log y) < 8 and the special cases of 0, 1 and the far tail do
// not arise.
__device__ __forceinline__ float ndtri_polevl(float x, const float* A,
                                              int len) {
  float r = 0.0f;
  for (int i = 0; i < len; ++i) r = fmaf(r, x, A[i]);
  return r;
}

__device__ __forceinline__ float ndtri(float y0) {
  // the coefficients are the double constants rounded to f32, as
  // PyTorch's `static const T P0[5] = {...}` with T = float rounds them
  const float P0[5] = {
      -5.99633501014107895267E1, 9.80010754185999661536E1,
      -5.66762857469070293439E1, 1.39312609387279679503E1,
      -1.23916583867381258016E0};
  const float Q0[9] = {
      1.00000000000000000000E0,  1.95448858338141759834E0,
      4.67627912898881538453E0,  8.63602421390890590575E1,
      -2.25462687854119370527E2, 2.00260212380060660359E2,
      -8.20372256168333339912E1, 1.59056225126211695515E1,
      -1.18331621121330003142E0};
  const float P1[9] = {
      4.05544892305962419923E0,   3.15251094599893866154E1,
      5.71628192246421288162E1,   4.40805073893200834700E1,
      1.46849561928858024014E1,   2.18663306850790267539E0,
      -1.40256079171354495875E-1, -3.50424626827848203418E-2,
      -8.57456785154685413611E-4};
  const float Q1[9] = {
      1.00000000000000000000E0,   1.57799883256466749731E1,
      4.53907635128879210584E1,   4.13172038254672030440E1,
      1.50425385692907503408E1,   2.50464946208309415979E0,
      -1.42182922854787788574E-1, -3.80806407691578277194E-2,
      -9.33259480895457427372E-4};
  const float kExpM2 = 0.13533528323661269189;   // exp(-2)
  const float kS2Pi = 2.50662827463100050242E0;  // sqrt(2 pi)
  bool code = true;
  float y = y0;
  if (y > __fsub_rn(1.0f, kExpM2)) {
    y = __fsub_rn(1.0f, y);
    code = false;
  }
  if (y > kExpM2) {
    y = __fsub_rn(y, 0.5f);
    const float y2 = __fmul_rn(y, y);
    const float r = __fdiv_rn(__fmul_rn(y2, ndtri_polevl(y2, P0, 5)),
                              ndtri_polevl(y2, Q0, 9));
    return __fmul_rn(fmaf(y, r, y), kS2Pi);
  }
  const float x = __fsqrt_rn(__fmul_rn(-2.0f, logf(y)));
  const float x0 = __fsub_rn(x, __fdiv_rn(logf(x), x));
  const float z = __fdiv_rn(1.0f, x);
  const float x1 = __fdiv_rn(__fmul_rn(z, ndtri_polevl(z, P1, 9)),
                             ndtri_polevl(z, Q1, 9));
  const float r = __fsub_rn(x0, x1);
  return code ? -r : r;
}

// The engine's draw (`ref.poisson`): the Poisson(lam) quantile of u, a
// truncated inverse CDF (24 terms) up to lam = 8 and a rounded normal
// above.  The term p * lam / j is two roundings, the division as
// PyTorch's CUDA division by a Python number computes it: a product with
// the rounded reciprocal 1/j.  The CDF never falls, so the walk stops at
// the first term it reaches (the later comparisons would all be false).
__device__ __forceinline__ int poisson_draw(float u, float lam) {
  if (lam > 8.0f) {
    const float uc = fminf(fmaxf(u, 0x1.ad7f2ap-24f), 0x1.fffffcp-1f);
    const float k = rintf(__fadd_rn(
        lam, __fmul_rn(__fsqrt_rn(fmaxf(lam, 0.0f)), ndtri(uc))));
    return static_cast<int>(fmaxf(k, 0.0f));
  }
  float p = expf(-fminf(lam, 30.0f));
  float cdf = p;
  int kk = u > cdf;
  for (int j = 1; j < 24 && u > cdf; ++j) {
    p = __fmul_rn(__fmul_rn(p, lam), __frcp_rn(__int2float_rn(j)));
    cdf = __fadd_rn(cdf, p);
    kk += u > cdf;
  }
  return kk;
}

}  // namespace campaign
