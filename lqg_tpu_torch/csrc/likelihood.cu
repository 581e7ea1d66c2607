// K3: fused conditioned and marginalized trajectory likelihood, one thread
// per lane (parameter set p, trial i), and K4, its analytic adjoint.
//
// K3 replaces lqg_tpu/ops/pallas/likelihood.py:_ll_fwd_kernel, K4 replaces
// likelihood.py:_ll_bwd_kernel.  Wrappers, the torch.autograd.Function that
// joins them, and their plain PyTorch versions:
// lqg_tpu_torch/ops/kernels/likelihood.py.
//
// Inputs, row-major: F, Q (P, T, J, J), X (P, n, T+1, D).  Output ll (P, n).
// The stores variant (STORES, taken only when a gradient is needed) also
// writes the carries Sigma_t (P, n, T+1, J, J) and mu_t (P, n, T+1, J)
// entering each step t, and (Sigma_T, mu_T) into slot T
// (likelihood.py:203-204, :250-251).
// Recursion and accumulation order of likelihood.py:163-264: Sigma_0 = Q_0,
// mu_0 = [x_0; 0]; the score is masked at t = 0; quad and log det accumulate
// with Neumaier compensation; the terminal score is added with the
// compensation terms folded in before the large partials.
//
// Bound on an H100: latency.  480 lanes at the main path's shape, each a
// T-step chain of dependent scalar operations, while the work itself (~7 MB,
// ~0.2 GFLOP at T = 1000) takes the card microseconds.  Sigma and mu stay
// in registers, F[p, t] and Q[p, t] are read by parameter set (the trials
// of one set read the same addresses, no per-trial copies), and there is no
// time chunking.
#include <cuda_runtime.h>

#include "small_matrix.cuh"

namespace {

using namespace lqg;

__device__ __forceinline__ void neumaier_add(float& s, float& comp, float v) {
  const float t = s + v;
  comp = comp + (fabsf(s) >= fabsf(v) ? (s - t) + v : (v - t) + s);
  s = t;
}

// e = x - mu[:D], returns e^T S^-1 e summed in row order; Sinv and det of
// S = Sigma[:D, :D] come back through the arguments.
template <int J, int D>
__device__ __forceinline__ float score(const float* Sigma, const float* mu,
                                       const float* __restrict__ x, float eps,
                                       float* Sinv, float* e, float* det) {
  float S[D * D];
#pragma unroll
  for (int r = 0; r < D; ++r)
#pragma unroll
    for (int k = 0; k < D; ++k) S[r * D + k] = Sigma[r * J + k];
  *det = sym_inv<D>(S, eps, Sinv);
#pragma unroll
  for (int k = 0; k < D; ++k) e[k] = x[k] - mu[k];
  float Se[D];
  matmul<D, D, 1>(Sinv, e, Se);
  float quad = e[0] * Se[0];
#pragma unroll
  for (int r = 1; r < D; ++r) quad = quad + e[r] * Se[r];
  return quad;
}

template <int J, int D, bool STORES>
__global__ void __launch_bounds__(128)
    ll_fwd(const float* __restrict__ F_, const float* __restrict__ Q_,
           const float* __restrict__ X_, float* __restrict__ ll,
           float* __restrict__ Sig_st, float* __restrict__ mu_st, int P, int n,
           int T, float eps, float log2pi_term) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= P * n) return;
  const int p = lane / n;
  const float* Fp = F_ + (size_t)p * T * (J * J);
  const float* Qp = Q_ + (size_t)p * T * (J * J);
  const float* Xl = X_ + (size_t)lane * (T + 1) * D;

  float Sigma[J * J], mu[J];
  load<J * J>(Qp, Sigma);
#pragma unroll
  for (int i = 0; i < J; ++i) mu[i] = i < D ? Xl[i] : 0.0f;
  float quad_acc = 0.0f, ld_acc = 0.0f, quad_c = 0.0f, ld_c = 0.0f;
  float* Sl = STORES ? Sig_st + (size_t)lane * (T + 1) * (J * J) : nullptr;
  float* ml = STORES ? mu_st + (size_t)lane * (T + 1) * J : nullptr;

  for (int t = 0; t < T; ++t) {
    if (STORES) {
      store<J * J>(Sl + (size_t)t * (J * J), Sigma);
      store<J>(ml + (size_t)t * J, mu);
    }
    float Sinv[D * D], e[D], det;
    const float quad = score<J, D>(Sigma, mu, Xl + (size_t)t * D, eps, Sinv,
                                   e, &det);
    const float mask = t >= 1 ? 1.0f : 0.0f;
    neumaier_add(quad_acc, quad_c, mask * quad);
    neumaier_add(ld_acc, ld_c, mask * logf(det));

    float F[J * J], Q[J * J];
    load<J * J>(Fp + (size_t)t * (J * J), F);
    load<J * J>(Qp + (size_t)t * (J * J), Q);
    float FS[J * J], Pm[J * D], Jm[J * D];
    matmul<J, J, J>(F, Sigma, FS);
#pragma unroll
    for (int r = 0; r < J; ++r)
#pragma unroll
      for (int k = 0; k < D; ++k) Pm[r * D + k] = FS[r * J + k];
    matmul<J, D, D>(Pm, Sinv, Jm);

    float Fmu[J], Je[J];
    matmul<J, J, 1>(F, mu, Fmu);
    matmul<J, D, 1>(Jm, e, Je);
#pragma unroll
    for (int i = 0; i < J; ++i) mu[i] = Fmu[i] + Je[i];

    float Ft[J * J], FSFt[J * J], PmT[D * J], JPt[J * J], tmp[J * J];
    transpose<J, J>(F, Ft);
    matmul<J, J, J>(FS, Ft, FSFt);
    transpose<J, D>(Pm, PmT);
    matmul<J, D, J>(Jm, PmT, JPt);
#pragma unroll
    for (int i = 0; i < J * J; ++i) tmp[i] = (FSFt[i] + Q[i]) - JPt[i];
#pragma unroll
    for (int r = 0; r < J; ++r)
#pragma unroll
      for (int k = 0; k < J; ++k)
        Sigma[r * J + k] = 0.5f * (tmp[r * J + k] + tmp[k * J + r]);
  }

  if (STORES) {
    store<J * J>(Sl + (size_t)T * (J * J), Sigma);
    store<J>(ml + (size_t)T * J, mu);
  }
  float Sinv[D * D], e[D], det;
  const float quad = score<J, D>(Sigma, mu, Xl + (size_t)T * D, eps, Sinv, e,
                                 &det);
  const float total = (((((quad_c + ld_c) + quad) + logf(det)) + quad_acc) +
                       ld_acc) + log2pi_term;
  ll[lane] = -0.5f * total;
}

template <int R>
__device__ __forceinline__ void sym(const float* a, float* out) {
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int k = 0; k < R; ++k) out[r * R + k] = 0.5f * (a[r * R + k] + a[k * R + r]);
}

// K4: reverse-mode recursion of K3 (likelihood.py:282-300 for the equations,
// code at :305-411), one thread per lane l = p n + i.
//
// Seed: the adjoint of the final score on (Sigma_T, mu_T), which also gives
// the data cotangent of x_T.  Then t = T-1..0: symmetrize Sigmabar', form
// Qbar_t, Fbar_t, Jbar, Pbar, Sinvbar, ebar, mubar and Sigmabar with the
// score terms masked at t = 0, fold Sigmabar into Qbar_0 at t = 0, and write
// the data cotangent of x_t (x_0 also through mu_0 = [x_0; 0]).  S^-1, e, FS,
// P and J are recomputed from the stores with K3's arithmetic (the same
// sym_inv and eps).  F[p, t] is read by parameter set, as in K3; Fbar and
// Qbar are written per lane, (P, n, T, J, J), and summed over trials by the
// wrapper, so no atomics make the sums' order change from run to run.
//
// Bound on an H100: latency, as K3.  480 lanes at the potential's shape,
// each a T-step chain of dependent scalar operations, while the bytes (the
// stores read, per-lane Fbar and Qbar written: ~230 B per lane-step) take
// the card tens of microseconds.  Both carries stay in registers and every
// step's outputs go straight to their slots; there is no time chunking.
template <int J, int D>
__global__ void __launch_bounds__(128)
    ll_bwd(const float* __restrict__ F_, const float* __restrict__ X_,
           const float* __restrict__ w_, const float* __restrict__ Sig_st,
           const float* __restrict__ mu_st, float* __restrict__ Fbar_,
           float* __restrict__ Qbar_, float* __restrict__ Xbar_, int P, int n,
           int T, float eps) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= P * n) return;
  const int p = lane / n;
  const float* Fp = F_ + (size_t)p * T * (J * J);
  const float* Xl = X_ + (size_t)lane * (T + 1) * D;
  const float* Sl = Sig_st + (size_t)lane * (T + 1) * (J * J);
  const float* ml = mu_st + (size_t)lane * (T + 1) * J;
  float* Fbl = Fbar_ + (size_t)lane * T * (J * J);
  float* Qbl = Qbar_ + (size_t)lane * T * (J * J);
  float* Xbl = Xbar_ + (size_t)lane * (T + 1) * D;
  const float w = w_[lane];

  // seed: ebar = -w S^-1 e, so mubar[:D] = w S^-1 e and xbar_T = ebar;
  // Sbar = -(w/2) S^-1 + (w/2) (S^-1 e)(S^-1 e)^T
  float Sbar[J * J], mbar[J];
  {
    float Sigma[J * J], mu[J], Sinv[D * D], e[D], det, Se[D];
    load<J * J>(Sl + (size_t)T * (J * J), Sigma);
    load<J>(ml + (size_t)T * J, mu);
    score<J, D>(Sigma, mu, Xl + (size_t)T * D, eps, Sinv, e, &det);
    matmul<D, D, 1>(Sinv, e, Se);
#pragma unroll
    for (int i = 0; i < J; ++i) mbar[i] = i < D ? w * Se[i] : 0.0f;
#pragma unroll
    for (int i = 0; i < D; ++i) Xbl[(size_t)T * D + i] = -w * Se[i];
    fill<J * J>(Sbar, 0.0f);
#pragma unroll
    for (int r = 0; r < D; ++r)
#pragma unroll
      for (int k = 0; k < D; ++k)
        Sbar[r * J + k] = 0.5f * w * (Se[r] * Se[k] - Sinv[r * D + k]);
  }

  for (int t = T - 1; t >= 0; --t) {
    float Sigma[J * J], mu[J], F[J * J];
    load<J * J>(Sl + (size_t)t * (J * J), Sigma);
    load<J>(ml + (size_t)t * J, mu);
    load<J * J>(Fp + (size_t)t * (J * J), F);

    // recompute the forward intermediates
    float Sinv[D * D], e[D], det;
    score<J, D>(Sigma, mu, Xl + (size_t)t * D, eps, Sinv, e, &det);
    float FS[J * J], Pm[J * D], Jm[J * D];
    matmul<J, J, J>(F, Sigma, FS);
#pragma unroll
    for (int r = 0; r < J; ++r)
#pragma unroll
      for (int k = 0; k < D; ++k) Pm[r * D + k] = FS[r * J + k];
    matmul<J, D, D>(Pm, Sinv, Jm);

    float Sbn[J * J];  // sym(Sigmabar'), also Qbar_t
    sym<J>(Sbar, Sbn);

    // FSbar = Sbn F;  Fbar = Sbn FS + mubar' mu^T
    float FSbar[J * J], Fbar[J * J], outer[J * J];
    matmul<J, J, J>(Sbn, F, FSbar);
    matmul<J, J, J>(Sbn, FS, Fbar);
    matmul<J, 1, J>(mbar, mu, outer);
#pragma unroll
    for (int k = 0; k < J * J; ++k) Fbar[k] = Fbar[k] + outer[k];
    // Jbar = -(Sbn P) + mubar' e^T;  Pbar = -(Sbn J) + Jbar S^-1
    float SbnP[J * D], me[J * D], Jbar[J * D], SbnJ[J * D], JbarSinv[J * D],
        Pbar[J * D];
    matmul<J, J, D>(Sbn, Pm, SbnP);
    matmul<J, 1, D>(mbar, e, me);
#pragma unroll
    for (int k = 0; k < J * D; ++k) Jbar[k] = -SbnP[k] + me[k];
    matmul<J, J, D>(Sbn, Jm, SbnJ);
    matmul<J, D, D>(Jbar, Sinv, JbarSinv);
#pragma unroll
    for (int k = 0; k < J * D; ++k) Pbar[k] = -SbnJ[k] + JbarSinv[k];
    // Sinvbar = P^T Jbar;  ebar = J^T mubar'
    float PmT[D * J], JmT[D * J], Sinvbar[D * D], ebar[D];
    transpose<J, D>(Pm, PmT);
    transpose<J, D>(Jm, JmT);
    matmul<D, J, D>(PmT, Jbar, Sinvbar);
    matmul<D, J, 1>(JmT, mbar, ebar);

    // score adjoints (t >= 1): ebar -= w S^-1 e;  Sinvbar -= (w/2) e e^T;
    // Sbar gets -(w/2) S^-1 (log det term)
    const float mask = t >= 1 ? 1.0f : 0.0f;
    const float mw = mask * w, hw = mask * 0.5f * w;
    float Se[D], ee[D * D];
    matmul<D, D, 1>(Sinv, e, Se);
#pragma unroll
    for (int k = 0; k < D; ++k) ebar[k] = ebar[k] - Se[k] * mw;
    matmul<D, 1, D>(e, e, ee);
#pragma unroll
    for (int k = 0; k < D * D; ++k) Sinvbar[k] = Sinvbar[k] - ee[k] * hw;
    float SinvbarSinv[D * D], Sb[D * D];
    matmul<D, D, D>(Sinvbar, Sinv, SinvbarSinv);
    matmul<D, D, D>(Sinv, SinvbarSinv, Sb);
#pragma unroll
    for (int k = 0; k < D * D; ++k) Sb[k] = -Sb[k] - Sinv[k] * hw;

    // mubar = F^T mubar';  mubar[:D] -= ebar
    float Ft[J * J], mubar[J];
    transpose<J, J>(F, Ft);
    matmul<J, J, 1>(Ft, mbar, mubar);
#pragma unroll
    for (int r = 0; r < D; ++r) mubar[r] = mubar[r] - ebar[r];

    // data cotangent: xbar_t = ebar (+ mubar_0[:D] at t = 0, mu_0 = [x_0; 0])
    const float is_t0 = t == 0 ? 1.0f : 0.0f;
#pragma unroll
    for (int r = 0; r < D; ++r)
      Xbl[(size_t)t * D + r] = ebar[r] + is_t0 * mubar[r];

    // FSbar[:, :D] += Pbar;  Fbar += FSbar Sigma;  Sigmabar = F^T FSbar
#pragma unroll
    for (int r = 0; r < J; ++r)
#pragma unroll
      for (int k = 0; k < D; ++k)
        FSbar[r * J + k] = FSbar[r * J + k] + Pbar[r * D + k];
    float FSbarSigma[J * J];
    matmul<J, J, J>(FSbar, Sigma, FSbarSigma);
#pragma unroll
    for (int k = 0; k < J * J; ++k) Fbar[k] = Fbar[k] + FSbarSigma[k];
    matmul<J, J, J>(Ft, FSbar, Sbar);  // the new carry Sigmabar
    float Sbs[D * D];
    sym<D>(Sb, Sbs);
#pragma unroll
    for (int r = 0; r < D; ++r)
#pragma unroll
      for (int k = 0; k < D; ++k)
        Sbar[r * J + k] = Sbar[r * J + k] + Sbs[r * D + k];

    // t = 0: Sigma_0 = Q_0, so the carry's cotangent folds into Qbar_0
    float Ssym[J * J];
    sym<J>(Sbar, Ssym);
#pragma unroll
    for (int k = 0; k < J * J; ++k) Sbn[k] = Sbn[k] + Ssym[k] * is_t0;

    store<J * J>(Fbl + (size_t)t * (J * J), Fbar);
    store<J * J>(Qbl + (size_t)t * (J * J), Sbn);
#pragma unroll
    for (int k = 0; k < J; ++k) mbar[k] = mubar[k];
  }
}

constexpr int kThreads = 128;

}  // namespace

// Both entries return cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a (j, d) that is not instantiated or an empty
// problem.  K3 writes the stores when Sig_st and mu_st are both given (both
// null: the store-free variant).
extern "C" int lqg_ll_fwd(const float* F, const float* Q, const float* X,
                          float* ll, float* Sig_st, float* mu_st, int j, int d,
                          int P, int n, int T, float eps, float log2pi_term,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (P < 1 || n < 1 || T < 1 || (Sig_st == nullptr) != (mu_st == nullptr))
    return cudaErrorInvalidValue;
  const int blocks = (P * n + kThreads - 1) / kThreads;
  if (j == 4 && d == 2 && Sig_st != nullptr)
    ll_fwd<4, 2, true><<<blocks, kThreads, 0, s>>>(F, Q, X, ll, Sig_st, mu_st,
                                                   P, n, T, eps, log2pi_term);
  else if (j == 4 && d == 2)
    ll_fwd<4, 2, false><<<blocks, kThreads, 0, s>>>(
        F, Q, X, ll, nullptr, nullptr, P, n, T, eps, log2pi_term);
  else if (j == 5 && d == 2 && Sig_st != nullptr)
    ll_fwd<5, 2, true><<<blocks, kThreads, 0, s>>>(F, Q, X, ll, Sig_st, mu_st,
                                                   P, n, T, eps, log2pi_term);
  else if (j == 5 && d == 2)
    ll_fwd<5, 2, false><<<blocks, kThreads, 0, s>>>(
        F, Q, X, ll, nullptr, nullptr, P, n, T, eps, log2pi_term);
  else
    return cudaErrorInvalidValue;
  return static_cast<int>(cudaGetLastError());
}

extern "C" int lqg_ll_bwd(const float* F, const float* X, const float* w,
                          const float* Sig_st, const float* mu_st, float* Fbar,
                          float* Qbar, float* Xbar, int j, int d, int P, int n,
                          int T, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (P < 1 || n < 1 || T < 1) return cudaErrorInvalidValue;
  const int blocks = (P * n + kThreads - 1) / kThreads;
  if (j == 4 && d == 2)
    ll_bwd<4, 2><<<blocks, kThreads, 0, s>>>(F, X, w, Sig_st, mu_st, Fbar,
                                             Qbar, Xbar, P, n, T, eps);
  else if (j == 5 && d == 2)
    ll_bwd<5, 2><<<blocks, kThreads, 0, s>>>(F, X, w, Sig_st, mu_st, Fbar,
                                             Qbar, Xbar, P, n, T, eps);
  else
    return cudaErrorInvalidValue;
  return static_cast<int>(cudaGetLastError());
}
