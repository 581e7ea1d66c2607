// K5: the large-j conditioned and marginalized trajectory likelihood, one
// thread block per parameter set, and K6, its analytic adjoint.
//
// K5 replaces lqg_tpu/ops/pallas/likelihood_blocked.py:_ll_blocked_kernel, K6
// replaces likelihood_blocked.py:_ll_blocked_bwd_kernel.  Wrappers, the
// torch.autograd.Function that joins them, the buffer plan and their plain
// PyTorch versions: lqg_tpu_torch/ops/kernels/likelihood_blocked.py.
//
// Inputs, row-major: F, Q (P, T, j, j), X (P, n, T+1, D).  Output ll (P, n).
// The stores variant (STORES, taken only when a gradient is needed) also
// writes the carries Sig_t (P, T+1, j, j) and MU_t (P, T+1, j, n) entering
// each step, and (Sig_T, MU_T) into slot T.  j and n are run-time arguments
// (12 < j <= 128, n <= 128), D is a template constant (1..4).
//
// The recursion is condition-then-propagate on whole matrices, with the
// trials in the trailing axis of the mean MU (j, n):
//
//   Sinv = inv(Sig[:D,:D]);  E = X_t - MU[:D];  SE = Sinv E
//   t >= 1: quad_i += sum_r E SE;  ld += log det        (Neumaier)
//   Kc = Sig[:, :D] Sinv;  Sc = sym(Sig - Kc Sig[:D, :])   (rank-D update)
//   MU <- F (MU + Kc E);   Sig <- (F Sc) F^T + Q
//
// What the TPU kernel did for its hardware and this one does not: padding to
// (128, 128) tiles, ones-matrix products to broadcast trace and determinant,
// time chunks with the carries parked in scratch.  Here both carries stay in
// shared memory for the whole T loop, the D x D inverse is closed form in
// every thread, and the two j^3 products and the j^2 n product of a step are
// register-tiled float32 FMA loops (4 x 4 outputs a thread, interleaved so
// that a warp reads consecutive shared-memory words).  No tensor cores, no
// TF32.
//
// Bound on an H100: operations by the count (three j^3-sized products a
// step), but one block walks each set's chain, so at 24 sets 24 of 132 SMs
// work, each step's products wait on the one before, and every step's F_t
// and Q_t come from device memory.
//
// Buffers: the wrapper places each large buffer in shared memory while the
// block's 227 KB last and in a per-set scratch in device memory after that
// (place[i] >= 0: offset in shared memory; < 0: offset -place[i] - 1 in the
// scratch); the staged F_t, when it has no room, is read where it lies.  The
// kernels address every buffer through generic pointers, so one code path
// serves j = 65 (all in shared memory) and j = n = 128.
#include <cuda_runtime.h>

#include "small_matrix.cuh"

namespace {

using namespace lqg;

constexpr int kMaxThreads = 512;
constexpr int TM = 4;  // outputs a thread, rows
constexpr int TN = 4;  // outputs a thread, columns

__host__ __device__ inline int round4(int k) { return (k + 3) / 4 * 4; }

__device__ __forceinline__ void neumaier_add(float& s, float& comp, float v) {
  const float t = s + v;
  comp = comp + (fabsf(s) >= fabsf(v) ? (s - t) + v : (v - t) + s);
  s = t;
}

__device__ __forceinline__ float* buffer(float* smem, float* scratch,
                                         int place) {
  return place >= 0 ? smem + place : scratch + (-place - 1);
}

// C(a, b) = alpha (add(a, b) + sum_k A1(a, k) B1(k, b)) + sum_k A2(a, k) B2(k, b)
// for a < M, b < N, by all threads of the block.  alpha scales only where a
// second product follows (K2 > 0), and the callers pass an addend only
// without one.  Operands are addressed by strides, A(a, k) = A[a ars + k acs],
// B(k, b) = B[k brs + b bcs], so a transposed operand is a swap of strides; C
// and add are row-major with leading dimension ldc.  K2 = 0 leaves the second
// product out, add = nullptr the addend.  A thread owns the rows ay + r nty and the columns bx + c ntx:
// the threads of a warp read consecutive columns of B.  Indices past the edge
// are clamped for the loads and skipped by the stores.  The caller
// synchronizes.
__device__ void gemm(int M, int N, int K1, const float* A1, int a1rs, int a1cs,
                     const float* B1, int b1rs, int b1cs, float alpha, int K2,
                     const float* A2, int a2rs, int a2cs, const float* B2,
                     int b2rs, int b2cs, const float* add, float* C, int ldc) {
  const int ntx = (N + TN - 1) / TN;
  const int nty = (M + TM - 1) / TM;
  for (int tile = threadIdx.x; tile < ntx * nty; tile += blockDim.x) {
    const int bx = tile % ntx;
    const int ay = tile / ntx;
    int row[TM], col[TN];
#pragma unroll
    for (int r = 0; r < TM; ++r) row[r] = min(ay + r * nty, M - 1);
#pragma unroll
    for (int c = 0; c < TN; ++c) col[c] = min(bx + c * ntx, N - 1);
    // the sums start from the addend, so that its loads (from device memory
    // for Q_t) are in flight during the product
    float acc[TM][TN];
#pragma unroll
    for (int r = 0; r < TM; ++r)
#pragma unroll
      for (int c = 0; c < TN; ++c)
        acc[r][c] = add != nullptr ? add[row[r] * ldc + col[c]] : 0.0f;

#pragma unroll 4
    for (int k = 0; k < K1; ++k) {
      float av[TM], bv[TN];
#pragma unroll
      for (int r = 0; r < TM; ++r) av[r] = A1[row[r] * a1rs + k * a1cs];
#pragma unroll
      for (int c = 0; c < TN; ++c) bv[c] = B1[k * b1rs + col[c] * b1cs];
#pragma unroll
      for (int r = 0; r < TM; ++r)
#pragma unroll
        for (int c = 0; c < TN; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
    }
    if (K2 > 0) {
#pragma unroll
      for (int r = 0; r < TM; ++r)
#pragma unroll
        for (int c = 0; c < TN; ++c) acc[r][c] = alpha * acc[r][c];
#pragma unroll 4
      for (int k = 0; k < K2; ++k) {
        float av[TM], bv[TN];
#pragma unroll
        for (int r = 0; r < TM; ++r) av[r] = A2[row[r] * a2rs + k * a2cs];
#pragma unroll
        for (int c = 0; c < TN; ++c) bv[c] = B2[k * b2rs + col[c] * b2cs];
#pragma unroll
        for (int r = 0; r < TM; ++r)
#pragma unroll
          for (int c = 0; c < TN; ++c)
            acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
      }
    }
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      const int a = ay + r * nty;
      if (a >= M) continue;
#pragma unroll
      for (int c = 0; c < TN; ++c) {
        const int b = bx + c * ntx;
        if (b >= N) continue;
        C[a * ldc + b] = acc[r][c];
      }
    }
  }
}

__device__ __forceinline__ void gemm1(int M, int N, int K, const float* A,
                                      int ars, int acs, const float* B,
                                      int brs, int bcs, const float* add,
                                      float* C, int ldc) {
  gemm(M, N, K, A, ars, acs, B, brs, bcs, 1.0f, 0, nullptr, 0, 0, nullptr, 0,
       0, add, C, ldc);
}

// dst[:count] = src[:count] by all threads, eight loads in flight a thread
// before the first store: a step's copies are from device memory, and one
// load at a time would cost a round trip each.
__device__ __forceinline__ void copy(float* dst, const float* src, int count) {
  constexpr int kBatch = 8;
  const int stride = blockDim.x;
  int i = threadIdx.x;
  for (; i + (kBatch - 1) * stride < count; i += kBatch * stride) {
    float v[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) v[b] = src[i + b * stride];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) dst[i + b * stride] = v[b];
  }
  for (; i < count; i += stride) dst[i] = src[i];
}

// Sinv = inv(Sig[:D, :D]) with eps on the determinant; returns det.
template <int D>
__device__ __forceinline__ float top_left_inverse(const float* Sig, int j,
                                                  float eps, float* Sinv) {
  float S[D * D];
#pragma unroll
  for (int r = 0; r < D; ++r)
#pragma unroll
    for (int k = 0; k < D; ++k) S[r * D + k] = Sig[r * j + k];
  return sym_inv<D>(S, eps, Sinv);
}

// e = x - MU[:D, i], se = Sinv e; returns e^T se summed in row order.
template <int D>
__device__ __forceinline__ float score(const float* MU, int n, int i,
                                       const float* x, const float* Sinv,
                                       float* e, float* se) {
#pragma unroll
  for (int r = 0; r < D; ++r) e[r] = x[r] - MU[r * n + i];
  matmul<D, D, 1>(Sinv, e, se);
  float quad = e[0] * se[0];
#pragma unroll
  for (int r = 1; r < D; ++r) quad = quad + e[r] * se[r];
  return quad;
}

// The small products of the conditioning, from Sig (j, j) and Sinv:
// Kc = Sig[:, :D] Sinv (j, D) and Rr = Sig[:D, :] (D, j); with KcT != nullptr
// also KcT = Sinv Sig[:D, :] (D, j) and Sd = Sig[:, :D] (j, D), which K6
// needs after Sig is overwritten.
template <int D>
__device__ __forceinline__ void conditioning_factors(const float* Sig, int j,
                                                     const float* Sinv,
                                                     float* Kc, float* Rr,
                                                     float* KcT, float* Sd) {
  for (int idx = threadIdx.x; idx < j * D; idx += blockDim.x) {
    const int a = idx / D, r = idx % D;
    float acc = Sig[a * j] * Sinv[r];
#pragma unroll
    for (int s = 1; s < D; ++s) acc = acc + Sig[a * j + s] * Sinv[s * D + r];
    Kc[idx] = acc;
    if (Sd != nullptr) Sd[idx] = Sig[a * j + r];
  }
  for (int idx = threadIdx.x; idx < D * j; idx += blockDim.x) {
    const int r = idx / j, b = idx % j;
    Rr[idx] = Sig[idx];
    if (KcT != nullptr) {
      float acc = Sinv[r * D] * Sig[b];
#pragma unroll
      for (int s = 1; s < D; ++s) acc = acc + Sinv[r * D + s] * Sig[s * j + b];
      KcT[idx] = acc;
    }
  }
}

// In place: Sig <- sym(Sig - Kc Rr), MU <- MU + Kc E.  Each thread owns the
// pair (a, b), (b, a), so nothing it reads is written by another.
template <int D>
__device__ __forceinline__ void condition(float* Sig, float* MU, int j, int n,
                                          const float* Kc, const float* Rr,
                                          const float* E) {
  for (int idx = threadIdx.x; idx < j * j; idx += blockDim.x) {
    const int a = idx / j, b = idx % j;
    if (a > b) continue;
    float kab = Kc[a * D] * Rr[b], kba = Kc[b * D] * Rr[a];
#pragma unroll
    for (int r = 1; r < D; ++r) {
      kab = kab + Kc[a * D + r] * Rr[r * j + b];
      kba = kba + Kc[b * D + r] * Rr[r * j + a];
    }
    const float v = 0.5f * ((Sig[a * j + b] - kab) + (Sig[b * j + a] - kba));
    Sig[a * j + b] = v;
    Sig[b * j + a] = v;
  }
  for (int idx = threadIdx.x; idx < j * n; idx += blockDim.x) {
    const int a = idx / n, i = idx % n;
    float acc = Kc[a * D] * E[i];
#pragma unroll
    for (int r = 1; r < D; ++r) acc = acc + Kc[a * D + r] * E[r * n + i];
    MU[idx] = MU[idx] + acc;
  }
}

struct FwdPlace {
  int sig, mu, prod, f;
};

template <int D, bool STORES>
__global__ void __launch_bounds__(kMaxThreads)
    ll_blocked_fwd(const float* __restrict__ F_, const float* __restrict__ Q_,
                   const float* __restrict__ X_, float* __restrict__ ll,
                   float* __restrict__ Sig_st, float* __restrict__ MU_st,
                   float* work, int j, int n, int T, FwdPlace place,
                   int scratch, float eps, float log2pi_term) {
  extern __shared__ __align__(16) float smem[];
  const int p = blockIdx.x;
  const int tid = threadIdx.x;
  const int jj = j * j, jn = j * n;
  const float* Fp = F_ + (size_t)p * T * jj;
  const float* Qp = Q_ + (size_t)p * T * jj;
  const float* Xp = X_ + (size_t)p * n * (T + 1) * D;
  float* wk = work + (size_t)p * scratch;

  float* Kc = smem;       // (j, D)
  float* Rr = Kc + j * D;  // (D, j)
  float* E = smem + round4(6 * j * D);  // (D, n)
  float* Sig = buffer(smem, wk, place.sig);
  float* MU = buffer(smem, wk, place.mu);
  float* prod = buffer(smem, wk, place.prod);
  float* Fs = place.f >= 0 ? smem + place.f : nullptr;

  // Sig_0 = Q_0, MU_0 = [X_0; 0]
  copy(Sig, Qp, jj);
  for (int idx = tid; idx < jn; idx += blockDim.x) {
    const int a = idx / n, i = idx % n;
    MU[idx] = a < D ? Xp[(size_t)i * (T + 1) * D + a] : 0.0f;
  }
  float x[D];
  if (tid < n) {
#pragma unroll
    for (int r = 0; r < D; ++r) x[r] = Xp[(size_t)tid * (T + 1) * D + r];
  }
  float quad_acc = 0.0f, ld_acc = 0.0f, quad_c = 0.0f, ld_c = 0.0f;
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    const float* Ft = Fp + (size_t)t * jj;
    if (STORES) {
      copy(Sig_st + ((size_t)p * (T + 1) + t) * jj, Sig, jj);
      copy(MU_st + ((size_t)p * (T + 1) + t) * jn, MU, jn);
    }
    if (Fs != nullptr) copy(Fs, Ft, jj);
    const float* Fm = Fs != nullptr ? Fs : Ft;

    float Sinv[D * D];
    const float det = top_left_inverse<D>(Sig, j, eps, Sinv);
    if (tid < n) {
      float e[D], se[D];
      const float quad = score<D>(MU, n, tid, x, Sinv, e, se);
      const float mask = t >= 1 ? 1.0f : 0.0f;
      neumaier_add(quad_acc, quad_c, mask * quad);
      neumaier_add(ld_acc, ld_c, mask * logf(det));
#pragma unroll
      for (int r = 0; r < D; ++r) {
        E[r * n + tid] = e[r];
        // the next step's data, in flight during this step's products
        x[r] = Xp[((size_t)tid * (T + 1) + t + 1) * D + r];
      }
    }
    conditioning_factors<D>(Sig, j, Sinv, Kc, Rr, nullptr, nullptr);
    __syncthreads();
    condition<D>(Sig, MU, j, n, Kc, Rr, E);  // Sig holds Sc, MU holds MUc
    __syncthreads();
    gemm1(j, j, j, Fm, j, 1, Sig, j, 1, nullptr, prod, j);  // F Sc
    __syncthreads();
    // Sig' = (F Sc) F^T + Q_t
    gemm1(j, j, j, prod, j, 1, Fm, 1, j, Qp + (size_t)t * jj, Sig, j);
    __syncthreads();
    gemm1(j, n, j, Fm, j, 1, MU, n, 1, nullptr, prod, n);  // F MUc
    __syncthreads();
    copy(MU, prod, jn);
    __syncthreads();
  }

  if (STORES) {
    copy(Sig_st + ((size_t)p * (T + 1) + T) * jj, Sig, jj);
    copy(MU_st + ((size_t)p * (T + 1) + T) * jn, MU, jn);
  }
  if (tid < n) {
    float Sinv[D * D], e[D], se[D];
    const float det = top_left_inverse<D>(Sig, j, eps, Sinv);
    const float quad = score<D>(MU, n, tid, x, Sinv, e, se);
    const float total = (((((quad_c + ld_c) + quad) + logf(det)) + quad_acc) +
                         ld_acc) + log2pi_term;
    ll[(size_t)p * n + tid] = -0.5f * total;
  }
}

// K6: reverse-mode recursion of K5 (the equations of
// likelihood_blocked.py:250-273), one block per parameter set.  B (j, j) and
// m (j, n) carry the cotangents of (Sig_{t+1}, MU_{t+1}).
//
// Seed: the adjoint of the final score on (Sig_T, MU_T), which also gives the
// data cotangent of x_T.  Then t = T-1..0, recomputing Sinv, E, SE, Kc, Sc,
// MUc and F Sc from the stores with K5's arithmetic:
//
//   Bs = sym(B);  Qbar_t = Bs;  Fbar_t = 2 Bs (F Sc) + m MUc^T
//   Scrb = F^T (Bs F);  MUc_bar = F^T m
//   Kcbar = -Scrb Sig[:, :D] + MUc_bar E^T
//   Ebar = KcT MUc_bar - w Sinv E                      [score, t >= 1]
//   Sinvbar = sym(Sig[:D, :] Kcbar - (w/2) E E^T)
//   Sbar = -Sinv Sinvbar Sinv - (sum_i w_i / 2) Sinv
//   B <- Scrb - [KcT Scrb; 0] + [Kcbar Sinv, 0] + [[Sbar, 0], [0, 0]]
//   m <- MUc_bar - [Ebar; 0];  Xbar_t = Ebar
//
// and at t = 0 (Sig_0 = Q_0, MU_0 = [x_0; 0]) the new carries fold into
// Qbar_0 += sym(B) and Xbar_0 += m[:D].  The sums over trials are the
// contractions over n inside the block, so Fbar and Qbar (P, T, j, j) are
// written once, in a fixed order, without atomics or per-trial copies.
//
// Bound on an H100: operations by the count (five j^3-sized products a
// step), with the same one-block-per-set chain as K5; the stores (j^2 + j n
// floats a step) are read once.
struct BwdPlace {
  int b, sig, m, mu, prod, f;
};

template <int D>
__global__ void __launch_bounds__(kMaxThreads)
    ll_blocked_bwd(const float* __restrict__ F_, const float* __restrict__ X_,
                   const float* __restrict__ w_,
                   const float* __restrict__ Sig_st,
                   const float* __restrict__ MU_st, float* __restrict__ Fbar_,
                   float* __restrict__ Qbar_, float* __restrict__ Xbar_,
                   float* work, int j, int n, int T, BwdPlace place,
                   int scratch, float eps) {
  extern __shared__ __align__(16) float smem[];
  const int p = blockIdx.x;
  const int tid = threadIdx.x;
  const int jj = j * j, jn = j * n;
  const float* Fp = F_ + (size_t)p * T * jj;
  const float* Xp = X_ + (size_t)p * n * (T + 1) * D;
  const float* wp = w_ + (size_t)p * n;
  const float* Sp = Sig_st + (size_t)p * (T + 1) * jj;
  const float* Mp = MU_st + (size_t)p * (T + 1) * jn;
  float* Fbp = Fbar_ + (size_t)p * T * jj;
  float* Qbp = Qbar_ + (size_t)p * T * jj;
  float* Xbp = Xbar_ + (size_t)p * n * (T + 1) * D;
  float* wk = work + (size_t)p * scratch;

  float* Kc = smem;          // (j, D)
  float* KcT = Kc + j * D;   // (D, j)
  float* Rr = KcT + j * D;   // (D, j): Sig[:D, :]
  float* Sd = Rr + j * D;    // (j, D): Sig[:, :D]
  float* Kcb = Sd + j * D;   // (j, D): Kcbar
  float* Rowc = Kcb + j * D;  // (D, j): KcT Scrb
  float* E = smem + round4(6 * j * D);  // (D, n)
  float* SE = E + D * n;                // (D, n)
  float* Eb = SE + D * n;               // (D, n): Ebar (SE w in the seed)
  float* Sib = smem + round4(6 * j * D) + round4(3 * D * n);  // (D, D)
  float* Bc = buffer(smem, wk, place.b);
  float* Sg = buffer(smem, wk, place.sig);
  float* Mc = buffer(smem, wk, place.m);
  float* Mu = buffer(smem, wk, place.mu);
  float* prod = buffer(smem, wk, place.prod);
  float* Fs = place.f >= 0 ? smem + place.f : nullptr;

  float wsum = 0.0f;
  for (int i = 0; i < n; ++i) wsum = wsum + wp[i];
  const float wi = tid < n ? wp[tid] : 0.0f;

  // seed
  copy(Sg, Sp + (size_t)T * jj, jj);
  copy(Mu, Mp + (size_t)T * jn, jn);
  __syncthreads();
  {
    float Sinv[D * D];
    top_left_inverse<D>(Sg, j, eps, Sinv);
    if (tid < n) {
      float x[D], e[D], se[D];
#pragma unroll
      for (int r = 0; r < D; ++r)
        x[r] = Xp[((size_t)tid * (T + 1) + T) * D + r];
      score<D>(Mu, n, tid, x, Sinv, e, se);
#pragma unroll
      for (int r = 0; r < D; ++r) {
        SE[r * n + tid] = se[r];
        Eb[r * n + tid] = se[r] * wi;
        Xbp[((size_t)tid * (T + 1) + T) * D + r] = -(se[r] * wi);
      }
    }
    __syncthreads();
    for (int idx = tid; idx < jn; idx += blockDim.x)
      Mc[idx] = idx < D * n ? Eb[idx] : 0.0f;
    for (int idx = tid; idx < jj; idx += blockDim.x) {
      const int a = idx / j, b = idx % j;
      float v = 0.0f;
      if (a < D && b < D) {
        float acc = Eb[a * n] * SE[b * n];
        for (int i = 1; i < n; ++i) acc = acc + Eb[a * n + i] * SE[b * n + i];
        v = 0.5f * (acc - wsum * Sinv[a * D + b]);
      }
      Bc[idx] = v;
    }
    __syncthreads();
  }

  for (int t = T - 1; t >= 0; --t) {
    const float* Ft = Fp + (size_t)t * jj;
    const float mask = t >= 1 ? 1.0f : 0.0f;
    copy(Sg, Sp + (size_t)t * jj, jj);
    copy(Mu, Mp + (size_t)t * jn, jn);
    if (Fs != nullptr) copy(Fs, Ft, jj);
    const float* Fm = Fs != nullptr ? Fs : Ft;
    __syncthreads();

    // the forward intermediates, from the stored carry
    float Sinv[D * D];
    top_left_inverse<D>(Sg, j, eps, Sinv);
    if (tid < n) {
      float x[D], e[D], se[D];
#pragma unroll
      for (int r = 0; r < D; ++r)
        x[r] = Xp[((size_t)tid * (T + 1) + t) * D + r];
      score<D>(Mu, n, tid, x, Sinv, e, se);
#pragma unroll
      for (int r = 0; r < D; ++r) {
        E[r * n + tid] = e[r];
        SE[r * n + tid] = se[r];
      }
    }
    conditioning_factors<D>(Sg, j, Sinv, Kc, Rr, KcT, Sd);
    // Bs = sym(B), in place
    for (int idx = tid; idx < jj; idx += blockDim.x) {
      const int a = idx / j, b = idx % j;
      if (a > b) continue;
      const float v = 0.5f * (Bc[a * j + b] + Bc[b * j + a]);
      Bc[a * j + b] = v;
      Bc[b * j + a] = v;
    }
    __syncthreads();
    condition<D>(Sg, Mu, j, n, Kc, Rr, E);  // Sg holds Sc, Mu holds MUc
    __syncthreads();
    gemm1(j, j, j, Fm, j, 1, Sg, j, 1, nullptr, prod, j);  // F Sc
    __syncthreads();
    // Fbar_t = 2 Bs (F Sc) + m MUc^T
    gemm(j, j, j, Bc, j, 1, prod, j, 1, 2.0f, n, Mc, n, 1, Mu, 1, n, nullptr,
         Fbp + (size_t)t * jj, j);
    __syncthreads();
    gemm1(j, j, j, Bc, j, 1, Fm, j, 1, nullptr, prod, j);  // Bs F
    __syncthreads();
    gemm1(j, j, j, Fm, 1, j, prod, j, 1, nullptr, Sg, j);  // Scrb = F^T (Bs F)
    gemm1(j, n, j, Fm, 1, j, Mc, n, 1, nullptr, Mu, n);    // MUc_bar = F^T m
    __syncthreads();

    // Kcbar = -Scrb Sig[:, :D] + MUc_bar E^T
    for (int idx = tid; idx < j * D; idx += blockDim.x) {
      const int a = idx / D, r = idx % D;
      float s1 = Sg[a * j] * Sd[r];
      for (int b = 1; b < j; ++b) s1 = s1 + Sg[a * j + b] * Sd[b * D + r];
      float s2 = Mu[a * n] * E[r * n];
      for (int i = 1; i < n; ++i) s2 = s2 + Mu[a * n + i] * E[r * n + i];
      Kcb[idx] = s2 - s1;
    }
    // Ebar = KcT MUc_bar - w SE
    for (int idx = tid; idx < D * n; idx += blockDim.x) {
      const int r = idx / n, i = idx % n;
      float acc = KcT[r * j] * Mu[i];
      for (int a = 1; a < j; ++a) acc = acc + KcT[r * j + a] * Mu[a * n + i];
      Eb[idx] = acc - mask * (SE[idx] * wp[i]);
    }
    // the row correction KcT Scrb
    for (int idx = tid; idx < D * j; idx += blockDim.x) {
      const int r = idx / j, b = idx % j;
      float acc = KcT[r * j] * Sg[b];
      for (int a = 1; a < j; ++a) acc = acc + KcT[r * j + a] * Sg[a * j + b];
      Rowc[idx] = acc;
    }
    __syncthreads();
    // Sig[:D, :] Kcbar - (w/2) E E^T, before the symmetrization
    if (tid < D * D) {
      const int r = tid / D, s = tid % D;
      float s1 = Rr[r * j] * Kcb[s];
      for (int b = 1; b < j; ++b) s1 = s1 + Rr[r * j + b] * Kcb[b * D + s];
      float s2 = (E[r * n] * wp[0]) * E[s * n];
      for (int i = 1; i < n; ++i)
        s2 = s2 + (E[r * n + i] * wp[i]) * E[s * n + i];
      Sib[tid] = s1 - (mask * 0.5f) * s2;
    }
    __syncthreads();
    float Sbar[D * D];
    {
      float Sinvbar[D * D], tmp[D * D];
#pragma unroll
      for (int r = 0; r < D; ++r)
#pragma unroll
        for (int s = 0; s < D; ++s)
          Sinvbar[r * D + s] = 0.5f * (Sib[r * D + s] + Sib[s * D + r]);
      matmul<D, D, D>(Sinvbar, Sinv, tmp);
      matmul<D, D, D>(Sinv, tmp, Sbar);
#pragma unroll
      for (int k = 0; k < D * D; ++k)
        Sbar[k] = -Sbar[k] - (mask * 0.5f) * (wsum * Sinv[k]);
    }
    // the new B, in place over Scrb
    for (int idx = tid; idx < jj; idx += blockDim.x) {
      const int a = idx / j, b = idx % j;
      float v = Sg[idx];
      if (a < D) v = v - Rowc[a * j + b];
      if (b < D) {
        float acc = Kcb[a * D] * Sinv[b];
#pragma unroll
        for (int s = 1; s < D; ++s) acc = acc + Kcb[a * D + s] * Sinv[s * D + b];
        v = v + acc;
        if (a < D) v = v + Sbar[a * D + b];
      }
      Sg[idx] = v;
    }
    // the new m, in place over MUc_bar, and the data cotangent
    for (int idx = tid; idx < D * n; idx += blockDim.x) {
      const int r = idx / n, i = idx % n;
      const float eb = Eb[idx];
      const float mnew = Mu[idx] - eb;
      Mu[idx] = mnew;
      Xbp[((size_t)i * (T + 1) + t) * D + r] = t == 0 ? eb + mnew : eb;
    }
    __syncthreads();
    // Qbar_t = Bs, and at t = 0 the fold of the new B
    for (int idx = tid; idx < jj; idx += blockDim.x) {
      const int a = idx / j, b = idx % j;
      float v = Bc[idx];
      if (t == 0) v = v + 0.5f * (Sg[a * j + b] + Sg[b * j + a]);
      Qbp[(size_t)t * jj + idx] = v;
    }
    __syncthreads();
    float* swap = Bc;
    Bc = Sg;
    Sg = swap;
    swap = Mc;
    Mc = Mu;
    Mu = swap;
  }
}

template <int D>
int launch_fwd(const float* F, const float* Q, const float* X, float* ll,
               float* Sig_st, float* MU_st, float* work, int j, int P, int n,
               int T, int threads, int smem_bytes, int scratch, FwdPlace place,
               float eps, float log2pi_term, cudaStream_t s) {
  cudaError_t err;
  if (Sig_st != nullptr) {
    err = cudaFuncSetAttribute(ll_blocked_fwd<D, true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    ll_blocked_fwd<D, true><<<P, threads, smem_bytes, s>>>(
        F, Q, X, ll, Sig_st, MU_st, work, j, n, T, place, scratch, eps,
        log2pi_term);
  } else {
    err = cudaFuncSetAttribute(ll_blocked_fwd<D, false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    ll_blocked_fwd<D, false><<<P, threads, smem_bytes, s>>>(
        F, Q, X, ll, nullptr, nullptr, work, j, n, T, place, scratch, eps,
        log2pi_term);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_bwd(const float* F, const float* X, const float* w,
               const float* Sig_st, const float* MU_st, float* Fbar,
               float* Qbar, float* Xbar, float* work, int j, int P, int n,
               int T, int threads, int smem_bytes, int scratch, BwdPlace place,
               float eps, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      ll_blocked_bwd<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  ll_blocked_bwd<D><<<P, threads, smem_bytes, s>>>(
      F, X, w, Sig_st, MU_st, Fbar, Qbar, Xbar, work, j, n, T, place, scratch,
      eps);
  return static_cast<int>(cudaGetLastError());
}

bool launch_ok(int j, int d, int P, int n, int T, int threads) {
  return j > 12 && j <= 128 && d >= 1 && d <= 4 && n >= 1 && n <= 128 &&
         P >= 1 && T >= 1 && threads >= n && threads >= 32 &&
         threads <= kMaxThreads && threads % 32 == 0;
}

}  // namespace

// Both entries return the first CUDA error of the attribute call or the
// launch, or cudaErrorInvalidValue for sizes outside the kernels' scope.  K5
// writes the stores when Sig_st and MU_st are both given (both null: the
// store-free variant).  smem_bytes, scratch (floats per set) and the places
// come from the wrapper's buffer plan.
extern "C" int lqg_ll_blocked_fwd(const float* F, const float* Q,
                                  const float* X, float* ll, float* Sig_st,
                                  float* MU_st, float* work, int j, int d,
                                  int P, int n, int T, int threads,
                                  int smem_bytes, int scratch, int place_sig,
                                  int place_mu, int place_prod, int place_f,
                                  float eps, float log2pi_term, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!launch_ok(j, d, P, n, T, threads) ||
      (Sig_st == nullptr) != (MU_st == nullptr))
    return cudaErrorInvalidValue;
  const FwdPlace place = {place_sig, place_mu, place_prod, place_f};
  switch (d) {
    case 1:
      return launch_fwd<1>(F, Q, X, ll, Sig_st, MU_st, work, j, P, n, T,
                           threads, smem_bytes, scratch, place, eps,
                           log2pi_term, s);
    case 2:
      return launch_fwd<2>(F, Q, X, ll, Sig_st, MU_st, work, j, P, n, T,
                           threads, smem_bytes, scratch, place, eps,
                           log2pi_term, s);
    case 3:
      return launch_fwd<3>(F, Q, X, ll, Sig_st, MU_st, work, j, P, n, T,
                           threads, smem_bytes, scratch, place, eps,
                           log2pi_term, s);
    default:
      return launch_fwd<4>(F, Q, X, ll, Sig_st, MU_st, work, j, P, n, T,
                           threads, smem_bytes, scratch, place, eps,
                           log2pi_term, s);
  }
}

extern "C" int lqg_ll_blocked_bwd(const float* F, const float* X,
                                  const float* w, const float* Sig_st,
                                  const float* MU_st, float* Fbar, float* Qbar,
                                  float* Xbar, float* work, int j, int d,
                                  int P, int n, int T, int threads,
                                  int smem_bytes, int scratch, int place_b,
                                  int place_sig, int place_m, int place_mu,
                                  int place_prod, int place_f, float eps,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!launch_ok(j, d, P, n, T, threads)) return cudaErrorInvalidValue;
  const BwdPlace place = {place_b,  place_sig,  place_m,
                          place_mu, place_prod, place_f};
  switch (d) {
    case 1:
      return launch_bwd<1>(F, X, w, Sig_st, MU_st, Fbar, Qbar, Xbar, work, j,
                           P, n, T, threads, smem_bytes, scratch, place, eps,
                           s);
    case 2:
      return launch_bwd<2>(F, X, w, Sig_st, MU_st, Fbar, Qbar, Xbar, work, j,
                           P, n, T, threads, smem_bytes, scratch, place, eps,
                           s);
    case 3:
      return launch_bwd<3>(F, X, w, Sig_st, MU_st, Fbar, Qbar, Xbar, work, j,
                           P, n, T, threads, smem_bytes, scratch, place, eps,
                           s);
    default:
      return launch_bwd<4>(F, X, w, Sig_st, MU_st, Fbar, Qbar, Xbar, work, j,
                           P, n, T, threads, smem_bytes, scratch, place, eps,
                           s);
  }
}
