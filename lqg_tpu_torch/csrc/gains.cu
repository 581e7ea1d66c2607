// K1: fused Riccati backward + Kalman forward gains, one thread per particle.
//
// Replaces lqg_tpu/ops/pallas/gains.py:_gains_merged_kernel.  Wrapper and
// plain PyTorch version: lqg_tpu_torch/ops/kernels/gains.py.
//
// Per particle b, with stationary A (n,n), B (n,m), Q (n,n), R (m,m),
// Qf (n,n), F (p,n), VV = V V^T (n,n), WW = W W^T (p,p), Sigma0 (n,n), all
// row-major with the particle axis leading, one loop over t = 0..T-1 runs
//   Riccati: H = R + B^T S B, G = B^T S A, L = -H^-1 G,
//            S <- (Q + A^T S A) + (L^T H L + (L^T G + G^T L)),
//            L, H -> slot T-1-t;
//   Kalman:  P <- A P A^T + VV, Gk = F P F^T + WW, K = P F^T Gk^-1,
//            P <- P - K (P F^T)^T,  K -> slot t.
// Outputs are (T, B, m, n), (T, B, m, m), (T, B, n, p).
//
// Bound on an H100: latency.  Each thread carries a T-step chain of
// dependent scalar operations; at B = 16,384 there are ~4 warps per SM, too
// few to hide it, while the bytes written (28 B per particle-step) would
// take 0.14 ms at T = 1000.  The spec and both carries stay in registers,
// there is no time chunking (any T), and each step's gains are written
// straight to their final slots.
#include <cuda_runtime.h>

#include "small_matrix.cuh"

namespace {

using namespace lqg;

template <int N, int M, int P>
__global__ void __launch_bounds__(128)
    gains_fwd(const float* __restrict__ A_, const float* __restrict__ B_,
              const float* __restrict__ Q_, const float* __restrict__ R_,
              const float* __restrict__ Qf_, const float* __restrict__ F_,
              const float* __restrict__ VV_, const float* __restrict__ WW_,
              const float* __restrict__ Sigma0_, float* __restrict__ L_out,
              float* __restrict__ H_out, float* __restrict__ K_out, int batch,
              int T, float eps) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= batch) return;

  float A[N * N], Bm[N * M], Q[N * N], R[M * M], F[P * N], VV[N * N],
      WW[P * P];
  load<N * N>(A_ + (size_t)b * N * N, A);
  load<N * M>(B_ + (size_t)b * N * M, Bm);
  load<N * N>(Q_ + (size_t)b * N * N, Q);
  load<M * M>(R_ + (size_t)b * M * M, R);
  load<P * N>(F_ + (size_t)b * P * N, F);
  load<N * N>(VV_ + (size_t)b * N * N, VV);
  load<P * P>(WW_ + (size_t)b * P * P, WW);
  float At[N * N], Bt[M * N], Ft[N * P];
  transpose<N, N>(A, At);
  transpose<N, M>(Bm, Bt);
  transpose<P, N>(F, Ft);

  float S[N * N], Pc[N * N];
  load<N * N>(Qf_ + (size_t)b * N * N, S);
  load<N * N>(Sigma0_ + (size_t)b * N * N, Pc);

  for (int t = 0; t < T; ++t) {
    // --- Riccati backward ---
    float SB[N * M], SA[N * N], BtSB[M * M], H[M * M], G[M * N];
    matmul<N, N, M>(S, Bm, SB);
    matmul<N, N, N>(S, A, SA);
    matmul<M, N, M>(Bt, SB, BtSB);
#pragma unroll
    for (int i = 0; i < M * M; ++i) H[i] = R[i] + BtSB[i];
    matmul<M, N, N>(Bt, SA, G);
    float Hinv[M * M], HinvG[M * N], L[M * N], Lt[N * M], HL[M * N];
    sym_inv<M>(H, eps, Hinv);
    matmul<M, M, N>(Hinv, G, HinvG);
#pragma unroll
    for (int i = 0; i < M * N; ++i) L[i] = -HinvG[i];
    transpose<M, N>(L, Lt);
    matmul<M, M, N>(H, L, HL);
    float AtSA[N * N], LtHL[N * N], LtG[N * N], Gt[N * M], GtL[N * N];
    matmul<N, N, N>(At, SA, AtSA);
    matmul<N, M, N>(Lt, HL, LtHL);
    matmul<N, M, N>(Lt, G, LtG);
    transpose<M, N>(G, Gt);
    matmul<N, M, N>(Gt, L, GtL);
#pragma unroll
    for (int i = 0; i < N * N; ++i)
      S[i] = (Q[i] + AtSA[i]) + (LtHL[i] + (LtG[i] + GtL[i]));
    const size_t rev = (size_t)(T - 1 - t) * batch + b;
    store<M * N>(L_out + rev * (M * N), L);
    store<M * M>(H_out + rev * (M * M), H);

    // --- Kalman forward ---
    float PAt[N * N], Pp[N * N], PFt[N * P], FPFt[P * P], Gk[P * P];
    matmul<N, N, N>(Pc, At, PAt);
    matmul<N, N, N>(A, PAt, Pp);
#pragma unroll
    for (int i = 0; i < N * N; ++i) Pp[i] = Pp[i] + VV[i];
    matmul<N, N, P>(Pp, Ft, PFt);
    matmul<P, N, P>(F, PFt, FPFt);
#pragma unroll
    for (int i = 0; i < P * P; ++i) Gk[i] = FPFt[i] + WW[i];
    float Gkinv[P * P], K[N * P], PFtT[P * N], KPF[N * N];
    sym_inv<P>(Gk, eps, Gkinv);
    matmul<N, P, P>(PFt, Gkinv, K);
    transpose<N, P>(PFt, PFtT);
    matmul<N, P, N>(K, PFtT, KPF);
#pragma unroll
    for (int i = 0; i < N * N; ++i) Pc[i] = Pp[i] - KPF[i];
    store<N * P>(K_out + ((size_t)t * batch + b) * (N * P), K);
  }
}

template <int N, int M, int P>
void launch(const float* A, const float* B, const float* Q, const float* R,
            const float* Qf, const float* F, const float* VV,
            const float* WW, const float* Sigma0, float* L, float* H,
            float* K, int batch, int T, float eps, cudaStream_t stream) {
  const int threads = 128;
  const int blocks = (batch + threads - 1) / threads;
  gains_fwd<N, M, P><<<blocks, threads, 0, stream>>>(
      A, B, Q, R, Qf, F, VV, WW, Sigma0, L, H, K, batch, T, eps);
}

}  // namespace

// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// an (n, m, p) that is not instantiated or an empty problem.
extern "C" int lqg_gains_fwd(const float* A, const float* B, const float* Q,
                             const float* R, const float* Qf, const float* F,
                             const float* VV, const float* WW,
                             const float* Sigma0, float* L, float* H, float* K,
                             int n, int m, int p, int batch, int T, float eps,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch < 1 || T < 1) return cudaErrorInvalidValue;
  if (n == 2 && m == 1 && p == 2)
    launch<2, 1, 2>(A, B, Q, R, Qf, F, VV, WW, Sigma0, L, H, K, batch, T, eps,
                    s);
  else if (n == 2 && m == 1 && p == 1)
    launch<2, 1, 1>(A, B, Q, R, Qf, F, VV, WW, Sigma0, L, H, K, batch, T, eps,
                    s);
  else
    return cudaErrorInvalidValue;
  return static_cast<int>(cudaGetLastError());
}
