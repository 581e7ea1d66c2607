// K3: fused conditioned and marginalized trajectory likelihood, one thread
// per lane (parameter set p, trial i).
//
// Replaces lqg_tpu/ops/pallas/likelihood.py:_ll_fwd_kernel.  Wrapper and
// plain PyTorch version: lqg_tpu_torch/ops/kernels/likelihood.py.
//
// Inputs, row-major: F, Q (P, T, J, J), X (P, n, T+1, D).  Output ll (P, n).
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

template <int J, int D>
__global__ void __launch_bounds__(128)
    ll_fwd(const float* __restrict__ F_, const float* __restrict__ Q_,
           const float* __restrict__ X_, float* __restrict__ ll, int P, int n,
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

  for (int t = 0; t < T; ++t) {
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

  float Sinv[D * D], e[D], det;
  const float quad = score<J, D>(Sigma, mu, Xl + (size_t)T * D, eps, Sinv, e,
                                 &det);
  const float total = (((((quad_c + ld_c) + quad) + logf(det)) + quad_acc) +
                       ld_acc) + log2pi_term;
  ll[lane] = -0.5f * total;
}

}  // namespace

// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// a (j, d) that is not instantiated or an empty problem.
extern "C" int lqg_ll_fwd(const float* F, const float* Q, const float* X,
                          float* ll, int j, int d, int P, int n, int T,
                          float eps, float log2pi_term, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (P < 1 || n < 1 || T < 1) return cudaErrorInvalidValue;
  const int threads = 128;
  const int blocks = (P * n + threads - 1) / threads;
  if (j == 4 && d == 2)
    ll_fwd<4, 2><<<blocks, threads, 0, s>>>(F, Q, X, ll, P, n, T, eps,
                                            log2pi_term);
  else
    return cudaErrorInvalidValue;
  return static_cast<int>(cudaGetLastError());
}
