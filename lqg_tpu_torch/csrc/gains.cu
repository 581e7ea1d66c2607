// K1: fused Riccati backward + Kalman forward gains, one thread per particle,
// and K2, its analytic adjoint.
//
// K1 replaces lqg_tpu/ops/pallas/gains.py:_gains_merged_kernel, K2 replaces
// gains.py:_gains_adjoint_kernel.  Wrappers, the torch.autograd.Function
// that joins them, and their plain PyTorch versions:
// lqg_tpu_torch/ops/kernels/gains.py.
//
// Per particle b, with stationary A (n,n), B (n,m), Q (n,n), R (m,m),
// Qf (n,n), F (p,n), VV = V V^T (n,n), WW = W W^T (p,p), Sigma0 (n,n), all
// row-major with the particle axis leading, one loop over t = 0..T-1 runs
//   Riccati: H = R + B^T S B, G = B^T S A, L = -H^-1 G,
//            S <- (Q + A^T S A) + (L^T H L + (L^T G + G^T L)),
//            L, H -> slot T-1-t;
//   Kalman:  P <- A P A^T + VV, Gk = F P F^T + WW, K = P F^T Gk^-1,
//            P <- P - K (P F^T)^T,  K -> slot t.
// Outputs are (T, B, m, n), (T, B, m, m), (T, B, n, p).  The stores variant
// (STORES, taken only when a gradient is needed) also writes the Riccati
// carry S entering the step that emits L into L's slot T-1-t, and the Kalman
// carry P entering the predict of step t into slot t, both (T, B, n, n):
// the residues K2 reads (gains.py:213-219).
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

template <int N, int M, int P, bool STORES>
__global__ void __launch_bounds__(128)
    gains_fwd(const float* __restrict__ A_, const float* __restrict__ B_,
              const float* __restrict__ Q_, const float* __restrict__ R_,
              const float* __restrict__ Qf_, const float* __restrict__ F_,
              const float* __restrict__ VV_, const float* __restrict__ WW_,
              const float* __restrict__ Sigma0_, float* __restrict__ L_out,
              float* __restrict__ H_out, float* __restrict__ K_out,
              float* __restrict__ S_st, float* __restrict__ P_st, int batch,
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
    const size_t rev = (size_t)(T - 1 - t) * batch + b;
    const size_t fwd = (size_t)t * batch + b;
    if (STORES) {
      store<N * N>(S_st + rev * (N * N), S);
      store<N * N>(P_st + fwd * (N * N), Pc);
    }
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
    store<N * P>(K_out + fwd * (N * P), K);
  }
}

// K2: the analytic adjoint of K1 (gains.py:244-280 for the equations, with
// code at :320-378), one thread per particle.
//
// Per particle, one loop over i = 0..T-1 runs both adjoint recursions with
// independent carries: the Riccati adjoint (its primal ran backward in time)
// reads S, Lbar, Hbar at slot i ascending, the Kalman adjoint reads P, Kbar
// at slot T-1-i descending.  H, G, L, Pp, PFt, Gk and K are recomputed from
// the stores with K1's arithmetic (the same sym_inv and eps), and the Kalman
// carry is kept in the symmetric gauge (see below).  Cotangents of
// A, B, Q, R, F, VV and WW accumulate in registers; those of Qf and Sigma0
// are the final carries.  Outputs are (B, ., .), written once at the end.
//
// Bound on an H100: latency, as K1.  It reads 2 n^2 + mn + m^2 + np floats
// per particle-step (56 B at (2, 1, 2)) and does ~3x K1's operations, but
// each thread walks a T-step chain of dependent scalar operations.  The
// carries, the accumulators and the spec stay in registers (no shared or
// local memory), there is no time chunking (any T), and each step reads its
// stores straight from their slots.
template <int N, int M, int P>
__global__ void __launch_bounds__(128)
    gains_bwd(const float* __restrict__ A_, const float* __restrict__ B_,
              const float* __restrict__ R_, const float* __restrict__ F_,
              const float* __restrict__ VV_, const float* __restrict__ WW_,
              const float* __restrict__ S_st, const float* __restrict__ P_st,
              const float* __restrict__ Lbar_, const float* __restrict__ Hbar_,
              const float* __restrict__ Kbar_, float* __restrict__ Abar_,
              float* __restrict__ Bbar_, float* __restrict__ Qbar_,
              float* __restrict__ Rbar_, float* __restrict__ Qfbar_,
              float* __restrict__ Fbar_, float* __restrict__ VVbar_,
              float* __restrict__ WWbar_, float* __restrict__ S0bar_,
              int batch, int T, float eps) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= batch) return;

  float A[N * N], Bm[N * M], R[M * M], F[P * N], VV[N * N], WW[P * P];
  load<N * N>(A_ + (size_t)b * N * N, A);
  load<N * M>(B_ + (size_t)b * N * M, Bm);
  load<M * M>(R_ + (size_t)b * M * M, R);
  load<P * N>(F_ + (size_t)b * P * N, F);
  load<N * N>(VV_ + (size_t)b * N * N, VV);
  load<P * P>(WW_ + (size_t)b * P * P, WW);
  float At[N * N], Bt[M * N], Ft[N * P];
  transpose<N, N>(A, At);
  transpose<N, M>(Bm, Bt);
  transpose<P, N>(F, Ft);

  float Sb[N * N], Pb[N * N], aA[N * N], aB[N * M], aQ[N * N], aR[M * M],
      aF[P * N], aV[N * N], aW[P * P];
  fill<N * N>(Sb, 0.0f);
  fill<N * N>(Pb, 0.0f);
  fill<N * N>(aA, 0.0f);
  fill<N * M>(aB, 0.0f);
  fill<N * N>(aQ, 0.0f);
  fill<M * M>(aR, 0.0f);
  fill<P * N>(aF, 0.0f);
  fill<N * N>(aV, 0.0f);
  fill<P * P>(aW, 0.0f);

  for (int i = 0; i < T; ++i) {
    // --- Riccati adjoint (ascending slot i) ---
    const size_t si = (size_t)i * batch + b;
    float S[N * N], Lb[M * N], Hb[M * M];
    load<N * N>(S_st + si * (N * N), S);
    load<M * N>(Lbar_ + si * (M * N), Lb);
    load<M * M>(Hbar_ + si * (M * M), Hb);

    float SB[N * M], SA[N * N], BtSB[M * M], H[M * M], G[M * N];
    matmul<N, N, M>(S, Bm, SB);
    matmul<N, N, N>(S, A, SA);
    matmul<M, N, M>(Bt, SB, BtSB);
#pragma unroll
    for (int k = 0; k < M * M; ++k) H[k] = R[k] + BtSB[k];
    matmul<M, N, N>(Bt, SA, G);
    float Hinv[M * M], HinvG[M * N], L[M * N], HL[M * N];
    sym_inv<M>(H, eps, Hinv);
    matmul<M, M, N>(Hinv, G, HinvG);
#pragma unroll
    for (int k = 0; k < M * N; ++k) L[k] = -HinvG[k];
    matmul<M, M, N>(H, L, HL);

    // Lb += HL Sb^T + (G Sb^T + (G Sb + H (L Sb)))
    float Sbt[N * N], HLSbt[M * N], GSbt[M * N], GSb[M * N], LSb[M * N],
        HLSb[M * N];
    transpose<N, N>(Sb, Sbt);
    matmul<M, N, N>(HL, Sbt, HLSbt);
    matmul<M, N, N>(G, Sbt, GSbt);
    matmul<M, N, N>(G, Sb, GSb);
    matmul<M, N, N>(L, Sb, LSb);
    matmul<M, M, N>(H, LSb, HLSb);
#pragma unroll
    for (int k = 0; k < M * N; ++k)
      Lb[k] = Lb[k] + (HLSbt[k] + (GSbt[k] + (GSb[k] + HLSb[k])));
    // Hb += L (Sb L^T);  Hb += (Hinv Lb) (G^T Hinv)
    float Lt[N * M], SbLt[N * M], LSbLt[M * M];
    transpose<M, N>(L, Lt);
    matmul<N, N, M>(Sb, Lt, SbLt);
    matmul<M, N, M>(L, SbLt, LSbLt);
#pragma unroll
    for (int k = 0; k < M * M; ++k) Hb[k] = Hb[k] + LSbLt[k];
    float HinvLb[M * N], Gt[N * M], GtHinv[N * M], HbL[M * M];
    matmul<M, M, N>(Hinv, Lb, HinvLb);
    transpose<M, N>(G, Gt);
    matmul<N, M, M>(Gt, Hinv, GtHinv);
    matmul<M, N, M>(HinvLb, GtHinv, HbL);
#pragma unroll
    for (int k = 0; k < M * M; ++k) Hb[k] = Hb[k] + HbL[k];
    // Gbar = (L Sb + L Sb^T) - Hinv Lb
    float LSbt[M * N], Gbar[M * N];
    matmul<M, N, N>(L, Sbt, LSbt);
#pragma unroll
    for (int k = 0; k < M * N; ++k) Gbar[k] = (LSb[k] + LSbt[k]) - HinvLb[k];

#pragma unroll
    for (int k = 0; k < M * M; ++k) aR[k] = aR[k] + Hb[k];
#pragma unroll
    for (int k = 0; k < N * N; ++k) aQ[k] = aQ[k] + Sb[k];
    float SBbar[N * M], ASb[N * N], BGbar[N * N], SAbar[N * N];
    matmul<N, M, M>(Bm, Hb, SBbar);
    matmul<N, N, N>(A, Sb, ASb);
    matmul<N, M, N>(Bm, Gbar, BGbar);
#pragma unroll
    for (int k = 0; k < N * N; ++k) SAbar[k] = ASb[k] + BGbar[k];
    // aA += SA Sb^T + S SAbar
    float SASbt[N * N], SSAbar[N * N];
    matmul<N, N, N>(SA, Sbt, SASbt);
    matmul<N, N, N>(S, SAbar, SSAbar);
#pragma unroll
    for (int k = 0; k < N * N; ++k) aA[k] = aA[k] + (SASbt[k] + SSAbar[k]);
    // aB += SA Gbar^T + (SB Hb^T + S SBbar)
    float Gbart[N * M], Hbt[M * M], SAGbt[N * M], SBHbt[N * M], SSBbar[N * M];
    transpose<M, N>(Gbar, Gbart);
    transpose<M, M>(Hb, Hbt);
    matmul<N, N, M>(SA, Gbart, SAGbt);
    matmul<N, M, M>(SB, Hbt, SBHbt);
    matmul<N, N, M>(S, SBbar, SSBbar);
#pragma unroll
    for (int k = 0; k < N * M; ++k)
      aB[k] = aB[k] + (SAGbt[k] + (SBHbt[k] + SSBbar[k]));
    // Sb <- SBbar B^T + SAbar A^T
    float SBbarBt[N * N], SAbarAt[N * N];
    matmul<N, M, N>(SBbar, Bt, SBbarBt);
    matmul<N, N, N>(SAbar, At, SAbarAt);
#pragma unroll
    for (int k = 0; k < N * N; ++k) Sb[k] = SBbarBt[k] + SAbarAt[k];

    // --- Kalman adjoint (descending slot T-1-i) ---
    // The carry in the symmetric gauge, as the scan twin's symmetrize()
    // projects it.  The equations below assume a symmetric P and are no
    // adjoint on antisymmetric matrices: unprojected, the carry can grow
    // (spectral radius above 1.05 at c = 0.01, see
    // tests/test_torch_gains_grad.py) and F's cotangent drowns in its
    // cancellation at long horizons.
    float Pbs[N * N];
#pragma unroll
    for (int r = 0; r < N; ++r)
#pragma unroll
      for (int c = 0; c < N; ++c)
        Pbs[r * N + c] = 0.5f * (Pb[r * N + c] + Pb[c * N + r]);
    store<N * N>(Pb, Pbs);
    const size_t sk = (size_t)(T - 1 - i) * batch + b;
    float Pc[N * N], Kb[N * P];
    load<N * N>(P_st + sk * (N * N), Pc);
    load<N * P>(Kbar_ + sk * (N * P), Kb);

    float PAt[N * N], Pp[N * N], PFt[N * P], FPFt[P * P], Gk[P * P];
    matmul<N, N, N>(Pc, At, PAt);
    matmul<N, N, N>(A, PAt, Pp);
#pragma unroll
    for (int k = 0; k < N * N; ++k) Pp[k] = Pp[k] + VV[k];
    matmul<N, N, P>(Pp, Ft, PFt);
    matmul<P, N, P>(F, PFt, FPFt);
#pragma unroll
    for (int k = 0; k < P * P; ++k) Gk[k] = FPFt[k] + WW[k];
    float Gki[P * P], K[N * P];
    sym_inv<P>(Gk, eps, Gki);
    matmul<N, P, P>(PFt, Gki, K);

    // Kb' = Kb - Pb PFt;  PFtb = -(Pb^T K) + Kb' Gki
    float PbPFt[N * P], Pbt[N * N], PbtK[N * P], KbGki[N * P], PFtb[N * P];
    matmul<N, N, P>(Pb, PFt, PbPFt);
#pragma unroll
    for (int k = 0; k < N * P; ++k) Kb[k] = Kb[k] - PbPFt[k];
    transpose<N, N>(Pb, Pbt);
    matmul<N, N, P>(Pbt, K, PbtK);
    matmul<N, P, P>(Kb, Gki, KbGki);
#pragma unroll
    for (int k = 0; k < N * P; ++k) PFtb[k] = -PbtK[k] + KbGki[k];
    // Gkbar = -(Gki (PFt^T (Kb' Gki)))
    float PFtT[P * N], PFtTKbGki[P * P], Gkbar[P * P];
    transpose<N, P>(PFt, PFtT);
    matmul<P, N, P>(PFtT, KbGki, PFtTKbGki);
    matmul<P, P, P>(Gki, PFtTKbGki, Gkbar);
#pragma unroll
    for (int k = 0; k < P * P; ++k) Gkbar[k] = -Gkbar[k];
#pragma unroll
    for (int k = 0; k < P * P; ++k) aW[k] = aW[k] + Gkbar[k];
    // aF += Gkbar PFt^T;  PFtb += F^T Gkbar;  aF += PFtb^T Pp
    float GkbarPFtT[P * N], FtGkbar[N * P], PFtbT[P * N], PFtbTPp[P * N];
    matmul<P, P, N>(Gkbar, PFtT, GkbarPFtT);
#pragma unroll
    for (int k = 0; k < P * N; ++k) aF[k] = aF[k] + GkbarPFtT[k];
    matmul<N, P, P>(Ft, Gkbar, FtGkbar);
#pragma unroll
    for (int k = 0; k < N * P; ++k) PFtb[k] = PFtb[k] + FtGkbar[k];
    transpose<N, P>(PFtb, PFtbT);
    matmul<P, N, N>(PFtbT, Pp, PFtbTPp);
#pragma unroll
    for (int k = 0; k < P * N; ++k) aF[k] = aF[k] + PFtbTPp[k];
    // Ppbar = Pb + PFtb F;  aV += Ppbar;  aA += (Ppbar + Ppbar^T) (A P)
    float PFtbF[N * N], Ppbar[N * N];
    matmul<N, P, N>(PFtb, F, PFtbF);
#pragma unroll
    for (int k = 0; k < N * N; ++k) Ppbar[k] = Pb[k] + PFtbF[k];
#pragma unroll
    for (int k = 0; k < N * N; ++k) aV[k] = aV[k] + Ppbar[k];
    float Ppsym[N * N], AP[N * N], PpsymAP[N * N];
#pragma unroll
    for (int r = 0; r < N; ++r)
#pragma unroll
      for (int c = 0; c < N; ++c)
        Ppsym[r * N + c] = Ppbar[r * N + c] + Ppbar[c * N + r];
    matmul<N, N, N>(A, Pc, AP);
    matmul<N, N, N>(Ppsym, AP, PpsymAP);
#pragma unroll
    for (int k = 0; k < N * N; ++k) aA[k] = aA[k] + PpsymAP[k];
    // Pb <- A^T (Ppbar A)
    float PpbarA[N * N];
    matmul<N, N, N>(Ppbar, A, PpbarA);
    matmul<N, N, N>(At, PpbarA, Pb);
  }

  store<N * N>(Abar_ + (size_t)b * N * N, aA);
  store<N * M>(Bbar_ + (size_t)b * N * M, aB);
  store<N * N>(Qbar_ + (size_t)b * N * N, aQ);
  store<M * M>(Rbar_ + (size_t)b * M * M, aR);
  store<N * N>(Qfbar_ + (size_t)b * N * N, Sb);
  store<P * N>(Fbar_ + (size_t)b * P * N, aF);
  store<N * N>(VVbar_ + (size_t)b * N * N, aV);
  store<P * P>(WWbar_ + (size_t)b * P * P, aW);
  store<N * N>(S0bar_ + (size_t)b * N * N, Pb);
}

constexpr int kThreads = 128;

inline int blocks_for(int batch) { return (batch + kThreads - 1) / kThreads; }

template <int N, int M, int P>
void launch_fwd(const float* A, const float* B, const float* Q, const float* R,
                const float* Qf, const float* F, const float* VV,
                const float* WW, const float* Sigma0, float* L, float* H,
                float* K, float* S_st, float* P_st, int batch, int T,
                float eps, cudaStream_t stream) {
  if (S_st != nullptr)
    gains_fwd<N, M, P, true><<<blocks_for(batch), kThreads, 0, stream>>>(
        A, B, Q, R, Qf, F, VV, WW, Sigma0, L, H, K, S_st, P_st, batch, T, eps);
  else
    gains_fwd<N, M, P, false><<<blocks_for(batch), kThreads, 0, stream>>>(
        A, B, Q, R, Qf, F, VV, WW, Sigma0, L, H, K, nullptr, nullptr, batch, T,
        eps);
}

template <int N, int M, int P>
void launch_bwd(const float* A, const float* B, const float* R,
                const float* F, const float* VV, const float* WW,
                const float* S_st, const float* P_st, const float* Lbar,
                const float* Hbar, const float* Kbar, float* Abar, float* Bbar,
                float* Qbar, float* Rbar, float* Qfbar, float* Fbar,
                float* VVbar, float* WWbar, float* S0bar, int batch, int T,
                float eps, cudaStream_t stream) {
  gains_bwd<N, M, P><<<blocks_for(batch), kThreads, 0, stream>>>(
      A, B, R, F, VV, WW, S_st, P_st, Lbar, Hbar, Kbar, Abar, Bbar, Qbar, Rbar,
      Qfbar, Fbar, VVbar, WWbar, S0bar, batch, T, eps);
}

}  // namespace

// Both entries return cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for an (n, m, p) that is not instantiated or an empty
// problem.  K1 writes the stores when S_st and P_st are both given (both
// null: the store-free variant).
extern "C" int lqg_gains_fwd(const float* A, const float* B, const float* Q,
                             const float* R, const float* Qf, const float* F,
                             const float* VV, const float* WW,
                             const float* Sigma0, float* L, float* H, float* K,
                             float* S_st, float* P_st, int n, int m, int p,
                             int batch, int T, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch < 1 || T < 1 || (S_st == nullptr) != (P_st == nullptr))
    return cudaErrorInvalidValue;
  if (n == 2 && m == 1 && p == 2)
    launch_fwd<2, 1, 2>(A, B, Q, R, Qf, F, VV, WW, Sigma0, L, H, K, S_st, P_st,
                        batch, T, eps, s);
  else if (n == 2 && m == 1 && p == 1)
    launch_fwd<2, 1, 1>(A, B, Q, R, Qf, F, VV, WW, Sigma0, L, H, K, S_st, P_st,
                        batch, T, eps, s);
  else
    return cudaErrorInvalidValue;
  return static_cast<int>(cudaGetLastError());
}

extern "C" int lqg_gains_bwd(const float* A, const float* B, const float* R,
                             const float* F, const float* VV, const float* WW,
                             const float* S_st, const float* P_st,
                             const float* Lbar, const float* Hbar,
                             const float* Kbar, float* Abar, float* Bbar,
                             float* Qbar, float* Rbar, float* Qfbar,
                             float* Fbar, float* VVbar, float* WWbar,
                             float* S0bar, int n, int m, int p, int batch,
                             int T, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch < 1 || T < 1) return cudaErrorInvalidValue;
  if (n == 2 && m == 1 && p == 2)
    launch_bwd<2, 1, 2>(A, B, R, F, VV, WW, S_st, P_st, Lbar, Hbar, Kbar, Abar,
                        Bbar, Qbar, Rbar, Qfbar, Fbar, VVbar, WWbar, S0bar,
                        batch, T, eps, s);
  else if (n == 2 && m == 1 && p == 1)
    launch_bwd<2, 1, 1>(A, B, R, F, VV, WW, S_st, P_st, Lbar, Hbar, Kbar, Abar,
                        Bbar, Qbar, Rbar, Qfbar, Fbar, VVbar, WWbar, S0bar,
                        batch, T, eps, s);
  else
    return cudaErrorInvalidValue;
  return static_cast<int>(cudaGetLastError());
}
