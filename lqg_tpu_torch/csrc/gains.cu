// K1: fused Riccati backward + Kalman forward gains, in two designs (one
// thread per particle, one block per particle), and K2, its analytic
// adjoint, one thread block per particle.
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
//            symmetrized at m > 1,
//            L, H -> slot T-1-t;
//   Kalman:  P <- A P A^T + VV, Gk = F P F^T + WW, K = P F^T Gk^-1,
//            P <- P - K (P F^T)^T,  K -> slot t.
// Outputs are (T, B, m, n), (T, B, m, m), (T, B, n, p).  The stores variant
// (STORES, taken only when a gradient is needed) also writes the Riccati
// carry S entering the step that emits L into L's slot T-1-t, and the Kalman
// carry P entering the predict of step t into slot t, both (T, B, n, n):
// the residues K2 reads (gains.py:213-219).
//
// Bound on an H100: latency.  Each particle carries two T-step chains of
// dependent scalar operations, while the bytes written (28 B a
// particle-step at (2, 1, 2)) would take 0.14 ms at B = 16,384, T = 1000
// and well under a microsecond at the potential's B = 24.
//
// The thread design (gains_fwd): one thread per particle walks both
// recursions, the spec and both carries in registers, no time chunking (any
// T), each step's gains written straight to their final slots.  At B =
// 16,384 it has ~4 warps an SM, each issuing ~180-1,000 instructions a step
// in order; at the potential's B = 4-24 it has one warp on one SM, and a
// step costs the sum of both recursions' instructions and latencies.
//
// The block design (gains_fwd_block), for small batches: one 64-thread
// block per particle, the Riccati recursion on warp 0 and the Kalman
// recursion on warp 1 (two schedulers), so that the two chains overlap.
// Each warp runs its recursion in one of two layouts, chosen per instance
// (BlockLayout):
// - one lane, the thread design's step as it is;
// - spread, lane r n + q owning entry (r, q) of the carry: the carry goes
//   through a shared tile each step (written by its owners, __syncwarp, read
//   whole by every lane), and each lane computes from it what its entry
//   needs.  Riccati: the columns r and q of S A, G and L, all of S B and H
//   (every lane inverts H itself), then its entry of the new carry; at m > 1
//   the symmetric projection reads the transposed entry by one shuffle.  One
//   exchange a step.  Kalman: entry (r, q) of A P A^T + VV; the lanes below
//   n p then each form one entry of P F^T from a row of it; then every lane
//   forms F P F^T + WW and inverts it, its row of K and its entry of the new
//   carry.  Three exchanges a step.
// Every entry is computed with the same operations in the same order as in
// the thread design (rn_algebra.cuh), so the two designs give the same bits.
// The stores come from the lanes owning the entries (a particle's row of L,
// H, K, S, P at one step is contiguous) and nothing waits on them.
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "pipeline.cuh"
#include "rn_algebra.cuh"
#include "small_matrix.cuh"

namespace {

using namespace lqg;

// out = (x + x^T) / 2 where PROJECT, else x.
template <int N, bool PROJECT>
__device__ __forceinline__ void sym_gauge(const float* x, float* out) {
#pragma unroll
  for (int r = 0; r < N; ++r)
#pragma unroll
    for (int q = 0; q < N; ++q)
      out[r * N + q] = PROJECT ? 0.5f * (x[r * N + q] + x[q * N + r])
                               : x[r * N + q];
}

// Entry (r, q) of L^T G + G^T L from the columns r and q of L and G (each
// of stride s): at m = 1 the sum is symmetric, the product of the lower
// index's L entry fused.
template <int M>
__device__ __forceinline__ float inner_sum(const float* Lr, const float* Gr,
                                           const float* Lq, const float* Gq,
                                           int s, int r, int q) {
  if (M == 1 && r > q)
    return rn::dot_add<M>(Lq, s, Gr, s, rn::dot<M>(Gq, s, Lr, s));
  return rn::dot_add<M>(Lr, s, Gq, s, rn::dot<M>(Gr, s, Lq, s));
}

// One Riccati step of one thread: S (in place) to the next carry, and the
// step's L and H.
template <int N, int M>
__device__ __forceinline__ void riccati_step(const float* A, const float* Bm,
                                             const float* Q, const float* R,
                                             float* S, float* L, float* H,
                                             float eps) {
  float SB[N * M], SA[N * N], BtSB[M * M], G[M * N];
  rn::matmul<N, N, M>(S, Bm, SB);
  rn::matmul<N, N, N>(S, A, SA);
  rn::matmul<M, N, M, true>(Bm, SB, BtSB);
#pragma unroll
  for (int i = 0; i < M * M; ++i) H[i] = rn::add(R[i], BtSB[i]);
  rn::matmul<M, N, N, true>(Bm, SA, G);
  float Hinv[M * M], HinvG[M * N], HL[M * N];
  rn::sym_inv<M>(H, eps, Hinv);
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j)
      HinvG[i * N + j] = rn::dot_inv<M>(G + j, N, Hinv + i * M, 1, i);
#pragma unroll
  for (int i = 0; i < M * N; ++i) L[i] = -HinvG[i];
  rn::matmul<M, M, N>(H, L, HL);
  float AtSA[N * N], X[N * N];
  rn::matmul<N, N, N, true>(A, SA, AtSA);
  // (Q + A^T S A) + (L^T H L + (L^T G + G^T L))
#pragma unroll
  for (int r = 0; r < N; ++r)
#pragma unroll
    for (int q = 0; q < N; ++q)
      X[r * N + q] = rn::add(
          rn::add(Q[r * N + q], AtSA[r * N + q]),
          rn::dot_add<M>(L + r, N, HL + q, N,
                         inner_sum<M>(L + r, G + r, L + q, G + q, N, r, q)));
  // at m > 1 the carry in the symmetric gauge: unprojected, its
  // antisymmetric part reaches H and can grow from rounding
#pragma unroll
  for (int r = 0; r < N; ++r)
#pragma unroll
    for (int q = 0; q < N; ++q)
      S[r * N + q] = M > 1 ? rn::mul(0.5f, rn::add(X[r * N + q], X[q * N + r]))
                           : X[r * N + q];
}

// One Kalman step of one thread: P (in place) to the next carry, and the
// step's K.
template <int N, int P>
__device__ __forceinline__ void kalman_step(const float* A, const float* F,
                                            const float* VV, const float* WW,
                                            float* Pc, float* K, float eps) {
  float PAt[N * N], Pp[N * N], PFt[N * P], FPFt[P * P], Gk[P * P],
      Gki[P * P];
  rn::matmul<N, N, N, false, true>(Pc, A, PAt);
  rn::matmul<N, N, N>(A, PAt, Pp);
#pragma unroll
  for (int i = 0; i < N * N; ++i) Pp[i] = rn::add(Pp[i], VV[i]);
  rn::matmul<N, N, P, false, true>(Pp, F, PFt);
  rn::matmul<P, N, P>(F, PFt, FPFt);
#pragma unroll
  for (int i = 0; i < P * P; ++i) Gk[i] = rn::add(FPFt[i], WW[i]);
  rn::sym_inv<P>(Gk, eps, Gki);
#pragma unroll
  for (int r = 0; r < N; ++r)
#pragma unroll
    for (int j = 0; j < P; ++j)
      K[r * P + j] = rn::dot_inv<P>(PFt + r * P, 1, Gki + j, P, j);
  // P - K (P F^T)^T
#pragma unroll
  for (int r = 0; r < N; ++r)
#pragma unroll
    for (int q = 0; q < N; ++q)
      Pc[r * N + q] =
          rn::sub_dot<P>(Pp[r * N + q], K + r * P, 1, PFt + q * P, 1);
}

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
    float L[M * N], H[M * M], K[N * P];
    riccati_step<N, M>(A, Bm, Q, R, S, L, H, eps);
    store<M * N>(L_out + rev * (M * N), L);
    store<M * M>(H_out + rev * (M * M), H);
    kalman_step<N, P>(A, F, VV, WW, Pc, K, eps);
    store<N * P>(K_out + fwd * (N * P), K);
  }
}

// The block design's Riccati warp in the one-lane layout: lane 0 walks the
// thread design's steps.
template <int N, int M, bool STORES>
__device__ __forceinline__ void riccati_lane(
    const float* __restrict__ A_, const float* __restrict__ B_,
    const float* __restrict__ Q_, const float* __restrict__ R_,
    const float* __restrict__ Qf_, float* __restrict__ L_out,
    float* __restrict__ H_out, float* __restrict__ S_st, int b, int batch,
    int T, float eps) {
  float A[N * N], Bm[N * M], Q[N * N], R[M * M], S[N * N];
  load<N * N>(A_ + (size_t)b * N * N, A);
  load<N * M>(B_ + (size_t)b * N * M, Bm);
  load<N * N>(Q_ + (size_t)b * N * N, Q);
  load<M * M>(R_ + (size_t)b * M * M, R);
  load<N * N>(Qf_ + (size_t)b * N * N, S);
  for (int t = 0; t < T; ++t) {
    const size_t rev = (size_t)(T - 1 - t) * batch + b;
    if (STORES) store<N * N>(S_st + rev * (N * N), S);
    float L[M * N], H[M * M];
    riccati_step<N, M>(A, Bm, Q, R, S, L, H, eps);
    store<M * N>(L_out + rev * (M * N), L);
    store<M * M>(H_out + rev * (M * M), H);
  }
}

// The block design's Kalman warp in the one-lane layout.
template <int N, int P, bool STORES>
__device__ __forceinline__ void kalman_lane(
    const float* __restrict__ A_, const float* __restrict__ F_,
    const float* __restrict__ VV_, const float* __restrict__ WW_,
    const float* __restrict__ Sigma0_, float* __restrict__ K_out,
    float* __restrict__ P_st, int b, int batch, int T, float eps) {
  float A[N * N], F[P * N], VV[N * N], WW[P * P], Pc[N * N];
  load<N * N>(A_ + (size_t)b * N * N, A);
  load<P * N>(F_ + (size_t)b * P * N, F);
  load<N * N>(VV_ + (size_t)b * N * N, VV);
  load<P * P>(WW_ + (size_t)b * P * P, WW);
  load<N * N>(Sigma0_ + (size_t)b * N * N, Pc);
  for (int t = 0; t < T; ++t) {
    const size_t fwd = (size_t)t * batch + b;
    if (STORES) store<N * N>(P_st + fwd * (N * N), Pc);
    float K[N * P];
    kalman_step<N, P>(A, F, VV, WW, Pc, K, eps);
    store<N * P>(K_out + fwd * (N * P), K);
  }
}

// The Riccati warp in the spread layout: lane l = r N + q < N^2 owns entry
// (r, q) of the carry; `tile` holds two carries of pad4(N^2) floats, the
// one a step reads and the one it writes.
template <int N, int M, bool STORES>
__device__ __forceinline__ void riccati_spread(
    const float* __restrict__ A_, const float* __restrict__ B_,
    const float* __restrict__ Q_, const float* __restrict__ R_,
    const float* __restrict__ Qf_, float* __restrict__ L_out,
    float* __restrict__ H_out, float* __restrict__ S_st, float* tile, int b,
    int batch, int T, float eps, int lane) {
  constexpr int NN = N * N, TS = rn::pad4(NN);
  constexpr unsigned mask = rn::lanes_mask(NN);
  if (lane >= NN) return;
  const int r = lane / N, q = lane % N;
  const size_t nn = (size_t)b * NN;
  // the spec: B and R whole, the columns r and q of A, entry (r, q) of Q
  float Bm[N * M], R[M * M], Ar[N], Aq[N];
  load<N * M>(B_ + (size_t)b * N * M, Bm);
  load<M * M>(R_ + (size_t)b * M * M, R);
#pragma unroll
  for (int k = 0; k < N; ++k) {
    Ar[k] = A_[nn + k * N + r];
    Aq[k] = A_[nn + k * N + q];
  }
  const float Qrq = Q_[nn + lane];
  float mine = Qf_[nn + lane];
  tile[lane] = mine;
  __syncwarp(mask);
  for (int t = 0; t < T; ++t) {
    const size_t rev = (size_t)(T - 1 - t) * batch + b;
    if (STORES) S_st[rev * NN + lane] = mine;
    float S[NN];
    rn::read_tile<NN>(tile + (t & 1) * TS, S);
    // S B whole; the columns r and q of S A and G = B^T S A
    float SB[N * M], SAr[N], SAq[N], BtSB[M * M], H[M * M], Gr[M], Gq[M];
    rn::matmul<N, N, M>(S, Bm, SB);
#pragma unroll
    for (int k = 0; k < N; ++k) {
      SAr[k] = rn::dot<N>(S + k * N, 1, Ar, 1);
      SAq[k] = rn::dot<N>(S + k * N, 1, Aq, 1);
    }
    rn::matmul<M, N, M, true>(Bm, SB, BtSB);
#pragma unroll
    for (int i = 0; i < M * M; ++i) H[i] = rn::add(R[i], BtSB[i]);
#pragma unroll
    for (int i = 0; i < M; ++i) {
      Gr[i] = rn::dot<N>(Bm + i, M, SAr, 1);
      Gq[i] = rn::dot<N>(Bm + i, M, SAq, 1);
    }
    // every lane inverts H; the columns r and q of L, the column q of H L
    float Hinv[M * M], Lr[M], Lq[M], HLq[M];
    rn::sym_inv<M>(H, eps, Hinv);
#pragma unroll
    for (int i = 0; i < M; ++i) {
      Lr[i] = -rn::dot_inv<M>(Gr, 1, Hinv + i * M, 1, i);
      Lq[i] = -rn::dot_inv<M>(Gq, 1, Hinv + i * M, 1, i);
    }
#pragma unroll
    for (int i = 0; i < M; ++i) HLq[i] = rn::dot<M>(H + i * M, 1, Lq, 1);
    // entry (r, q) of the new carry
    const float X = rn::add(
        rn::add(Qrq, rn::dot<N>(Ar, 1, SAq, 1)),
        rn::dot_add<M>(Lr, 1, HLq, 1, inner_sum<M>(Lr, Gr, Lq, Gq, 1, r, q)));
    if (M > 1)
      mine = rn::mul(0.5f, rn::add(X, __shfl_sync(mask, X, q * N + r)));
    else
      mine = X;
    tile[((t + 1) & 1) * TS + lane] = mine;
    if (lane < M * N) L_out[rev * (M * N) + lane] = rn::pick<M>(Lq, r);
    if (lane < M * M) H_out[rev * (M * M) + lane] = rn::pick<M * M>(H, lane);
    __syncwarp(mask);
  }
}

// The Kalman warp in the spread layout: lane l = r N + q < N^2 owns entry
// (r, q) of the carry, lane l < N P also entry (l / P, l % P) of P F^T and
// of K.  `tile` holds the carry, A P A^T + VV and P F^T, each padded to a
// multiple of four floats.
template <int N, int P, bool STORES>
__device__ __forceinline__ void kalman_spread(
    const float* __restrict__ A_, const float* __restrict__ F_,
    const float* __restrict__ VV_, const float* __restrict__ WW_,
    const float* __restrict__ Sigma0_, float* __restrict__ K_out,
    float* __restrict__ P_st, float* tile, int b, int batch, int T,
    float eps, int lane) {
  constexpr int NN = N * N, NP = N * P;
  constexpr unsigned mask = rn::lanes_mask(NN);
  float* Pt = tile;
  float* Ppt = tile + rn::pad4(NN);
  float* PFt_t = Ppt + rn::pad4(NN);
  if (lane >= NN) return;
  const int r = lane / N, q = lane % N, i1 = lane / P, j1 = lane % P;
  const size_t nn = (size_t)b * NN;
  // the spec: F and WW whole, the rows r and q of A, the row j1 of F,
  // entry (r, q) of VV
  float F[P * N], WW[P * P], Ar[N], Aq[N], Fj[N];
  load<P * N>(F_ + (size_t)b * P * N, F);
  load<P * P>(WW_ + (size_t)b * P * P, WW);
#pragma unroll
  for (int k = 0; k < N; ++k) {
    Ar[k] = A_[nn + r * N + k];
    Aq[k] = A_[nn + q * N + k];
    Fj[k] = F_[(size_t)b * P * N + j1 * N + k];
  }
  const float VVrq = VV_[nn + lane];
  float mine = Sigma0_[nn + lane];
  Pt[lane] = mine;
  __syncwarp(mask);
  for (int t = 0; t < T; ++t) {
    const size_t fwd = (size_t)t * batch + b;
    if (STORES) P_st[fwd * NN + lane] = mine;
    // entry (r, q) of A P A^T + VV
    float Pc[NN], PAtq[N];
    rn::read_tile<NN>(Pt, Pc);
#pragma unroll
    for (int k = 0; k < N; ++k) PAtq[k] = rn::dot<N>(Pc + k * N, 1, Aq, 1);
    const float Pp = rn::add(rn::dot<N>(Ar, 1, PAtq, 1), VVrq);
    Ppt[lane] = Pp;
    __syncwarp(mask);
    // entry (i1, j1) of P F^T from the row i1 of A P A^T + VV
    if (lane < NP) {
      float row[N];
#pragma unroll
      for (int k = 0; k < N; ++k) row[k] = Ppt[i1 * N + k];
      PFt_t[lane] = rn::dot<N>(row, 1, Fj, 1);
    }
    __syncwarp(mask);
    // every lane inverts F P F^T + WW; the row r of K, entry (r, q) of the
    // new carry
    float PFt[NP], FPFt[P * P], Gk[P * P], Gki[P * P], PFr[P], PFq[P],
        Kr[P];
    rn::read_tile<NP>(PFt_t, PFt);
    rn::matmul<P, N, P>(F, PFt, FPFt);
#pragma unroll
    for (int i = 0; i < P * P; ++i) Gk[i] = rn::add(FPFt[i], WW[i]);
    rn::sym_inv<P>(Gk, eps, Gki);
#pragma unroll
    for (int j = 0; j < P; ++j) {
      PFr[j] = PFt_t[r * P + j];
      PFq[j] = PFt_t[q * P + j];
    }
#pragma unroll
    for (int j = 0; j < P; ++j) Kr[j] = rn::dot_inv<P>(PFr, 1, Gki + j, P, j);
    mine = rn::sub_dot<P>(Pp, Kr, 1, PFq, 1);
    if (lane < NP) {  // entry (i1, j1) of K
      float row[P], col[P];
#pragma unroll
      for (int k = 0; k < P; ++k) {
        row[k] = PFt_t[i1 * P + k];
        col[k] = rn::pick<P>(Gki + k * P, j1);
      }
      K_out[fwd * NP + lane] = rn::dot_inv<P>(row, 1, col, 1, j1);
    }
    Pt[lane] = mine;
    __syncwarp(mask);
  }
}

// Each instance's warp layouts in the block design: true for the spread
// layout, false for one lane.  The fastest of the four at B = 24, T = 1008
// with the stores (the potential's launch), scripts/k1_designs.py on an
// NVIDIA H100 80GB HBM3 at 700 W (ms; R0K0 R0K1 R1K0 R1K1, 0 one lane, 1
// spread, for the Riccati warp and the Kalman warp; the thread design
// last):
//   (2, 1, 2) 0.1277 0.2057 0.1597 0.2123  0.2231
//   (2, 1, 1) 0.1093 0.1977 0.1522 0.1918  0.1868
//   (3, 1, 2) 0.1761 0.2804 0.1754 0.2845  0.3199
//   (4, 1, 3) 0.3486 0.2998 0.3440 0.3068  0.5808
//   (5, 1, 2) 0.3944 0.4264 0.3957 0.3704  0.7934
//   (4, 2, 2) 0.3861 0.3830 0.2993 0.3139  0.6256
// At n = 2 a step is shorter than the exchanges spreading it costs.  The
// instances added for the delay wrapper and for the padded route, (4, 1,
// 1-2), (6, 1, 1-2) and n = 8, take one lane for both warps: beyond n^2 = 32
// entries the spread layout has no lane for each, and the one-lane layout
// is the thread design's step as it is.
template <int N, int M, int P>
struct BlockLayout {
  static constexpr bool riccati = false, kalman = false;
};
template <>
struct BlockLayout<3, 1, 2> {
  static constexpr bool riccati = true, kalman = false;
};
template <>
struct BlockLayout<4, 1, 3> {
  static constexpr bool riccati = false, kalman = true;
};
template <>
struct BlockLayout<5, 1, 2> {
  static constexpr bool riccati = true, kalman = true;
};
template <>
struct BlockLayout<4, 2, 2> {
  static constexpr bool riccati = true, kalman = false;
};

template <int N, int M, int P>
__host__ __device__ constexpr int block_tile_floats() {
  return 4 * rn::pad4(N * N) + rn::pad4(N * P);
}

template <int N, int M, int P, bool STORES, bool SR, bool SK>
__global__ void __launch_bounds__(64)
    gains_fwd_block(const float* __restrict__ A_, const float* __restrict__ B_,
                    const float* __restrict__ Q_, const float* __restrict__ R_,
                    const float* __restrict__ Qf_,
                    const float* __restrict__ F_,
                    const float* __restrict__ VV_,
                    const float* __restrict__ WW_,
                    const float* __restrict__ Sigma0_,
                    float* __restrict__ L_out, float* __restrict__ H_out,
                    float* __restrict__ K_out, float* __restrict__ S_st,
                    float* __restrict__ P_st, int batch, int T, float eps) {
  __shared__ __align__(16) float tile[block_tile_floats<N, M, P>()];
  const int b = blockIdx.x, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == 0) {
    if (SR)
      riccati_spread<N, M, STORES>(A_, B_, Q_, R_, Qf_, L_out, H_out, S_st,
                                   tile, b, batch, T, eps, lane);
    else if (lane == 0)
      riccati_lane<N, M, STORES>(A_, B_, Q_, R_, Qf_, L_out, H_out, S_st, b,
                                 batch, T, eps);
  } else {
    float* ktile = tile + 2 * rn::pad4(N * N);
    if (SK)
      kalman_spread<N, P, STORES>(A_, F_, VV_, WW_, Sigma0_, K_out, P_st,
                                  ktile, b, batch, T, eps, lane);
    else if (lane == 0)
      kalman_lane<N, P, STORES>(A_, F_, VV_, WW_, Sigma0_, K_out, P_st, b,
                                batch, T, eps);
  }
}

// K2: the analytic adjoint of K1 (gains.py:244-280 for the equations, with
// code at :320-378).  One thread block per particle.
//
// The adjoint runs two recursions with independent carries over i = 0..T-1:
// the Riccati adjoint (its primal ran backward in time) reads S, Lbar, Hbar
// at slot i ascending, the Kalman adjoint reads P, Kbar at slot T-1-i
// descending.  Of a step's work only two small linear maps are serial:
//   Riccati:  Sb = sym(Sb) at m > 1 (the adjoint of K1's projection)
//             Lb = Lbar + (HL Sb^T + (G Sb^T + (G Sb + H (L Sb))))
//             Hb = (Hbar + L (Sb L^T)) + (Hinv Lb) (G^T Hinv)
//             Gbar = (L Sb + L Sb^T) - Hinv Lb
//             SBbar = B Hb,  SAbar = A Sb + B Gbar
//             Sb <- SBbar B^T + SAbar A^T
//   Kalman:   Pb = sym(Pb);  Kb = Kbar - Pb PFt;  KbGki = Kb Gki
//             PFtb = -(Pb^T K) + KbGki;  Gkbar = -(Gki (PFt^T KbGki))
//             PFtb += F^T Gkbar;  Ppbar = Pb + PFtb F
//             Pb <- A^T (Ppbar A)
// Their coefficients (H, G, Hinv, L, HL from S_t; Pp, PFt, Gki, K from P_t,
// recomputed with K1's arithmetic: the same sym_inv, eps and order) hold no
// carry, and the cotangents of A, B, Q, R, F, VV and WW are sums over the
// steps of terms that the carries feed but never read:
//   Riccati:  R += Hb,  Q += Sb,  A += SA Sb^T + S SAbar,
//             B += SA Gbar^T + (SB Hb^T + S SBbar)
//   Kalman:   WW += Gkbar,  F += Gkbar PFt^T + PFtb^T Pp,  VV += Ppbar,
//             A += (Ppbar + Ppbar^T) (A P)
// (Sb and the symmetrized Pb entering each step; A's cotangent is the
// Riccati total plus the Kalman total).  Those of Qf and Sigma0 are the
// final carries.  The Kalman carry is kept in the symmetric gauge, as the
// scan twin's symmetrize() projects it: the equations above assume a
// symmetric P and are no adjoint on antisymmetric matrices; unprojected,
// the carry can grow (spectral radius above 1.05 at c = 0.01, see
// tests/test_torch_gains_grad.py) and F's cotangent drowns in its
// cancellation at long horizons.
//
// The block walks T in chunks of kChunk = 32 steps, one lane a step, through
// a ring of chunk slots in shared memory (BwdSlot::slots: four where they
// fit a block's shared memory, else two; the records grow as n^2, and four
// slots at n = 8 would take 321-399 KB), with five warps in roles:
// - warp 0 copies a chunk's inputs into its slot with 4-byte cp.async (rows
//   are strided by batch x size in the (T, B, ., .) layout) that arrive on
//   the slot's mbarrier: S_t, Lbar_t, Hbar_t at ascending slots, P_t, Kbar_t
//   at descending ones;
// - warp 3 recomputes the chunk's coefficients, lane l for step l, and
//   writes them into the slot;
// - lane 0 of warp 1 walks the Riccati carry, lane 0 of warp 2 the Kalman
//   carry (two warps, so two schedulers); each reads its step's
//   coefficients as one record of float4s, loaded a step ahead while the
//   step before computes, and writes the step's carry-derived quantities as
//   another; nothing else runs on these lanes;
// - warp 4 forms each step's contributions, lane l for step l (zero past
//   T), sums the chunk over its lanes with the transpose reduction of
//   pipeline.cuh (a fixed xor tree), 32 values a round (nR + nK values:
//   27 at (2, 1, 2), 120 at (5, 1, 2)), and adds the chunk sums to running
//   totals in chunk order: no atomics, the same bits on every launch.
// The copy warp runs up to slots - 1 chunks ahead of the accumulate warp,
// the recompute warp with it; mbarriers hand each slot from role to role
// (filled, coefficients ready, carried, free).  Any T works: the last chunk
// is masked.
//
// Bound on an H100: latency.  The bytes (56 B a particle-step at (2, 1, 2))
// and operations would take the card well under a microsecond at B = 24,
// T = 1008; the time is the two carry lanes' chains of T dependent steps,
// each ~100 instructions issued in order by one lane (the Kalman step is
// the longer and sets the time), plus the pipeline's fill and drain.  The
// recompute and the sums run beside the chains, a chunk apart.  Splitting
// a step over lanes would cost more shuffle rounds than the step takes.
constexpr int kChunk = 32;  // steps a chunk: one lane a step
constexpr int kMaxSlots = 4;  // chunk slots of the ring, at most
constexpr int kBwdThreads = 160;  // copy, two carry, recompute, sum warps
constexpr int kBwdBarBytes = 128;  // room for 16 mbarriers
constexpr size_t kSmemLimit = 232448;  // 227 KB, a block's most

// mbarriers, one of each for every slot (up to kMaxSlots)
constexpr int kLoaded = 0;               // copy warp -> slot filled (32)
constexpr int kReady = kMaxSlots;        // recompute warp -> coefficients (32)
constexpr int kCarried = 2 * kMaxSlots;  // carry lanes -> their outputs (2)
constexpr int kFree = 3 * kMaxSlots;     // accumulate warp -> released (32)

constexpr int round4(int x) { return (x + 3) / 4 * 4; }

// A chunk slot: arrays of kChunk per-step records, in floats.  The carry
// lanes' records are multiples of four floats, read and written as float4s.
template <int N, int M, int P>
struct BwdSlot {
  // Riccati carry lane's coefficients: Lbar, Hbar (copied); HL, G, H, L,
  // Hinv, G^T Hinv (recomputed)
  static constexpr int oLbar = 0, oHbar = M * N, oHL = oHbar + M * M,
                       oG = oHL + M * N, oH = oG + M * N, oL = oH + M * M,
                       oHinv = oL + M * N, oGtHinv = oHinv + M * M,
                       RC = round4(oGtHinv + N * M);
  // its outputs: Sb (entering the step), Hb, Gbar, SBbar, SAbar
  static constexpr int oSb = 0, oHb = N * N, oGbar = oHb + M * M,
                       oSBbar = oGbar + M * N, oSAbar = oSBbar + N * M,
                       RO = round4(oSAbar + N * N);
  // Kalman carry lane's coefficients: Kbar (copied); PFt, Gki, K
  static constexpr int oKbar = 0, oPFt = N * P, oGki = 2 * N * P,
                       oK = oGki + P * P, KC = round4(oK + N * P);
  // its outputs: Gkbar, PFtb, Ppbar
  static constexpr int oGkbar = 0, oPFtb = P * P, oPpbar = oPFtb + N * P,
                       KO = round4(oPpbar + N * N);
  // S (copied); SA, SB (recomputed); P (copied); A P, Pp (recomputed)
  static constexpr int SS = N * N, RA = N * N + N * M, PS = N * N,
                       KA = 2 * N * N;
  static constexpr int aRC = 0, aRO = aRC + kChunk * RC,
                       aKC = aRO + kChunk * RO, aKO = aKC + kChunk * KC,
                       aS = aKO + kChunk * KO, aRA = aS + kChunk * SS,
                       aP = aRA + kChunk * RA, aKA = aP + kChunk * PS,
                       floats = aKA + kChunk * KA;
  // the accumulate warp's sums, in rounds of 32 values, one value a lane:
  // Rbar, Qbar, A's Riccati part, Bbar; and WWbar, Fbar, VVbar, A's Kalman
  // part; their totals meet in shared memory after the ring
  static constexpr int vR = 0, vQ = M * M, vAR = vQ + N * N,
                       vB = vAR + N * N, nR = vB + N * M;
  static constexpr int vW = 0, vF = P * P, vV = vF + P * N,
                       vAK = vV + N * N, nK = vAK + N * N;
  static constexpr int roundsR = (nR + 31) / 32, roundsK = (nK + 31) / 32;
  static constexpr size_t bytes_at(int slots) {
    return kBwdBarBytes + sizeof(float) * ((size_t)slots * floats + nR + nK);
  }
  // the ring's slots: the most that fit a block (the sums' order does not
  // depend on them)
  static constexpr int slots = bytes_at(kMaxSlots) <= kSmemLimit ? kMaxSlots
                                                                 : 2;
  static constexpr size_t bytes = bytes_at(slots);
  static_assert(bytes <= kSmemLimit, "K2's ring does not fit a block");
};

template <int S>
__device__ __forceinline__ void load4(const float* src, float* dst) {
  static_assert(S % 4 == 0, "float4 record");
#pragma unroll
  for (int k = 0; k < S / 4; ++k) {
    const float4 v = reinterpret_cast<const float4*>(src)[k];
    dst[4 * k] = v.x;
    dst[4 * k + 1] = v.y;
    dst[4 * k + 2] = v.z;
    dst[4 * k + 3] = v.w;
  }
}

template <int S>
__device__ __forceinline__ void store4(float* dst, const float* src) {
  static_assert(S % 4 == 0, "float4 record");
#pragma unroll
  for (int k = 0; k < S / 4; ++k)
    reinterpret_cast<float4*>(dst)[k] =
        make_float4(src[4 * k], src[4 * k + 1], src[4 * k + 2], src[4 * k + 3]);
}

// Stages `len` rows of SZ floats into records of STRIDE floats: row l is
// this particle's entry at slot first + dir l of a (T, batch, SZ) array.
template <int SZ, int STRIDE>
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ src,
                                      int first, int dir, int len, int b,
                                      int batch, int lane) {
  for (int k = lane; k < len * SZ; k += 32) {
    const int l = k / SZ, e = k - l * SZ;
    cp_async4(dst + l * STRIDE + e,
              src + ((size_t)(first + dir * l) * batch + b) * SZ + e);
  }
}

template <int N, int M, int P>
__device__ __forceinline__ void bwd_copy(float* ring, uint64_t* bar,
                                         const float* __restrict__ S_st,
                                         const float* __restrict__ P_st,
                                         const float* __restrict__ Lbar_,
                                         const float* __restrict__ Hbar_,
                                         const float* __restrict__ Kbar_,
                                         int b, int batch, int T, int NC,
                                         int lane) {
  using L = BwdSlot<N, M, P>;
  for (int c = 0; c < NC; ++c) {
    const int s = c % L::slots, u = c / L::slots;
    if (u > 0) mbar_wait(bar + kFree + s, (u - 1) & 1);
    float* slot = ring + s * L::floats;
    const int i0 = c * kChunk, len = min(kChunk, T - i0);
    stage<N * N, L::SS>(slot + L::aS, S_st, i0, 1, len, b, batch, lane);
    stage<M * N, L::RC>(slot + L::aRC + L::oLbar, Lbar_, i0, 1, len, b, batch,
                        lane);
    stage<M * M, L::RC>(slot + L::aRC + L::oHbar, Hbar_, i0, 1, len, b, batch,
                        lane);
    stage<N * N, L::PS>(slot + L::aP, P_st, T - 1 - i0, -1, len, b, batch,
                        lane);
    stage<N * P, L::KC>(slot + L::aKC + L::oKbar, Kbar_, T - 1 - i0, -1, len,
                        b, batch, lane);
    cp_async_arrive(bar + kLoaded + s);
  }
}

// K1's primal quantities of the chunk's steps, lane l for step l.  Lanes
// past T compute on stale slot entries; nothing reads what they write.
template <int N, int M, int P>
__device__ __forceinline__ void bwd_recompute(
    float* ring, uint64_t* bar, const float* __restrict__ A_,
    const float* __restrict__ B_, const float* __restrict__ R_,
    const float* __restrict__ F_, const float* __restrict__ VV_,
    const float* __restrict__ WW_, int b, int NC, float eps, int lane) {
  using L = BwdSlot<N, M, P>;
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
  for (int c = 0; c < NC; ++c) {
    const int s = c % L::slots;
    mbar_wait(bar + kLoaded + s, (c / L::slots) & 1);
    float* slot = ring + s * L::floats;
    // Riccati: SB, SA, H, G, Hinv, L, HL, G^T Hinv from S
    float S[N * N];
    load<N * N>(slot + L::aS + lane * L::SS, S);
    float SB[N * M], SA[N * N], BtSB[M * M], H[M * M], G[M * N];
    matmul<N, N, M>(S, Bm, SB);
    matmul<N, N, N>(S, A, SA);
    matmul<M, N, M>(Bt, SB, BtSB);
#pragma unroll
    for (int k = 0; k < M * M; ++k) H[k] = R[k] + BtSB[k];
    matmul<M, N, N>(Bt, SA, G);
    float Hinv[M * M], HinvG[M * N], Lg[M * N], HL[M * N], Gt[N * M],
        GtHinv[N * M];
    sym_inv<M>(H, eps, Hinv);
    matmul<M, M, N>(Hinv, G, HinvG);
#pragma unroll
    for (int k = 0; k < M * N; ++k) Lg[k] = -HinvG[k];
    matmul<M, M, N>(H, Lg, HL);
    transpose<M, N>(G, Gt);
    matmul<N, M, M>(Gt, Hinv, GtHinv);
    float* ra = slot + L::aRA + lane * L::RA;
    store<N * N>(ra, SA);
    store<N * M>(ra + N * N, SB);
    float* rc = slot + L::aRC + lane * L::RC;
    store<M * N>(rc + L::oHL, HL);
    store<M * N>(rc + L::oG, G);
    store<M * M>(rc + L::oH, H);
    store<M * N>(rc + L::oL, Lg);
    store<M * M>(rc + L::oHinv, Hinv);
    store<N * M>(rc + L::oGtHinv, GtHinv);
    // Kalman: A P, Pp, PFt, Gki, K from P
    float Pc[N * N];
    load<N * N>(slot + L::aP + lane * L::PS, Pc);
    float PAt[N * N], Pp[N * N], PFt[N * P], FPFt[P * P], Gk[P * P],
        Gki[P * P], K[N * P], AP[N * N];
    matmul<N, N, N>(Pc, At, PAt);
    matmul<N, N, N>(A, PAt, Pp);
#pragma unroll
    for (int k = 0; k < N * N; ++k) Pp[k] = Pp[k] + VV[k];
    matmul<N, N, P>(Pp, Ft, PFt);
    matmul<P, N, P>(F, PFt, FPFt);
#pragma unroll
    for (int k = 0; k < P * P; ++k) Gk[k] = FPFt[k] + WW[k];
    sym_inv<P>(Gk, eps, Gki);
    matmul<N, P, P>(PFt, Gki, K);
    matmul<N, N, N>(A, Pc, AP);
    float* ka = slot + L::aKA + lane * L::KA;
    store<N * N>(ka, AP);
    store<N * N>(ka + N * N, Pp);
    float* kc = slot + L::aKC + lane * L::KC;
    store<N * P>(kc + L::oPFt, PFt);
    store<P * P>(kc + L::oGki, Gki);
    store<N * P>(kc + L::oK, K);
    mbar_arrive(bar + kReady + s);
  }
}

// The Riccati adjoint carry, one lane; Qf's cotangent is its final value.
template <int N, int M, int P>
__device__ __forceinline__ void bwd_riccati(float* ring, uint64_t* bar,
                                            const float* __restrict__ A_,
                                            const float* __restrict__ B_,
                                            float* __restrict__ Qfbar_, int b,
                                            int T, int NC) {
  using L = BwdSlot<N, M, P>;
  float A[N * N], Bm[N * M], At[N * N], Bt[M * N];
  load<N * N>(A_ + (size_t)b * N * N, A);
  load<N * M>(B_ + (size_t)b * N * M, Bm);
  transpose<N, N>(A, At);
  transpose<N, M>(Bm, Bt);
  float Sb[N * N];
  fill<N * N>(Sb, 0.0f);
  for (int c = 0; c < NC; ++c) {
    const int s = c % L::slots;
    mbar_wait(bar + kReady + s, (c / L::slots) & 1);
    const float* rc = ring + s * L::floats + L::aRC;
    float* ro = ring + s * L::floats + L::aRO;
    const int len = min(kChunk, T - c * kChunk);
    float cur[L::RC];
    load4<L::RC>(rc, cur);
    for (int l = 0; l < len; ++l) {
      float nxt[L::RC];  // the next step's coefficients, loaded ahead
      load4<L::RC>(rc + ((l + 1) & (kChunk - 1)) * L::RC, nxt);
      const float* Lbar = cur + L::oLbar;
      const float* Hbar = cur + L::oHbar;
      const float* HL = cur + L::oHL;
      const float* G = cur + L::oG;
      const float* H = cur + L::oH;
      const float* Lg = cur + L::oL;
      const float* Hinv = cur + L::oHinv;
      const float* GtHinv = cur + L::oGtHinv;
      float o[L::RO];
      fill<L::RO>(o, 0.0f);
      float* Hb = o + L::oHb;
      float* Gbar = o + L::oGbar;
      float* SBbar = o + L::oSBbar;
      float* SAbar = o + L::oSAbar;
      // the adjoint of K1's projection of its carry at m > 1
      float Sbs[N * N];
      sym_gauge<N, (M > 1)>(Sb, Sbs);
      store<N * N>(o + L::oSb, Sbs);
      // Lb = Lbar + (HL Sb^T + (G Sb^T + (G Sb + H (L Sb))))
      float Sbt[N * N], HLSbt[M * N], GSbt[M * N], GSb[M * N], LSb[M * N],
          HLSb[M * N], Lb[M * N];
      transpose<N, N>(Sbs, Sbt);
      matmul<M, N, N>(HL, Sbt, HLSbt);
      matmul<M, N, N>(G, Sbt, GSbt);
      matmul<M, N, N>(G, Sbs, GSb);
      matmul<M, N, N>(Lg, Sbs, LSb);
      matmul<M, M, N>(H, LSb, HLSb);
#pragma unroll
      for (int k = 0; k < M * N; ++k)
        Lb[k] = Lbar[k] + (HLSbt[k] + (GSbt[k] + (GSb[k] + HLSb[k])));
      // Hb = (Hbar + L (Sb L^T)) + (Hinv Lb) (G^T Hinv)
      float Lt[N * M], SbLt[N * M], LSbLt[M * M], HinvLb[M * N], HbL[M * M];
      transpose<M, N>(Lg, Lt);
      matmul<N, N, M>(Sbs, Lt, SbLt);
      matmul<M, N, M>(Lg, SbLt, LSbLt);
      matmul<M, M, N>(Hinv, Lb, HinvLb);
      matmul<M, N, M>(HinvLb, GtHinv, HbL);
#pragma unroll
      for (int k = 0; k < M * M; ++k) Hb[k] = (Hbar[k] + LSbLt[k]) + HbL[k];
      // Gbar = (L Sb + L Sb^T) - Hinv Lb
      float LSbt[M * N];
      matmul<M, N, N>(Lg, Sbt, LSbt);
#pragma unroll
      for (int k = 0; k < M * N; ++k)
        Gbar[k] = (LSb[k] + LSbt[k]) - HinvLb[k];
      // SBbar = B Hb;  SAbar = A Sb + B Gbar
      float ASb[N * N], BGbar[N * N];
      matmul<N, M, M>(Bm, Hb, SBbar);
      matmul<N, N, N>(A, Sbs, ASb);
      matmul<N, M, N>(Bm, Gbar, BGbar);
#pragma unroll
      for (int k = 0; k < N * N; ++k) SAbar[k] = ASb[k] + BGbar[k];
      store4<L::RO>(ro + l * L::RO, o);
      // Sb <- SBbar B^T + SAbar A^T
      float SBbarBt[N * N], SAbarAt[N * N];
      matmul<N, M, N>(SBbar, Bt, SBbarBt);
      matmul<N, N, N>(SAbar, At, SAbarAt);
#pragma unroll
      for (int k = 0; k < N * N; ++k) Sb[k] = SBbarBt[k] + SAbarAt[k];
#pragma unroll
      for (int k = 0; k < L::RC; ++k) cur[k] = nxt[k];
    }
    mbar_arrive(bar + kCarried + s);
  }
  store<N * N>(Qfbar_ + (size_t)b * N * N, Sb);
}

// The Kalman adjoint carry, one lane; Sigma0's cotangent is its final value.
template <int N, int M, int P>
__device__ __forceinline__ void bwd_kalman(float* ring, uint64_t* bar,
                                           const float* __restrict__ A_,
                                           const float* __restrict__ F_,
                                           float* __restrict__ S0bar_, int b,
                                           int T, int NC) {
  using L = BwdSlot<N, M, P>;
  float A[N * N], F[P * N], At[N * N], Ft[N * P];
  load<N * N>(A_ + (size_t)b * N * N, A);
  load<P * N>(F_ + (size_t)b * P * N, F);
  transpose<N, N>(A, At);
  transpose<P, N>(F, Ft);
  float Pb[N * N];
  fill<N * N>(Pb, 0.0f);
  for (int c = 0; c < NC; ++c) {
    const int s = c % L::slots;
    mbar_wait(bar + kReady + s, (c / L::slots) & 1);
    const float* kc = ring + s * L::floats + L::aKC;
    float* ko = ring + s * L::floats + L::aKO;
    const int len = min(kChunk, T - c * kChunk);
    float cur[L::KC];
    load4<L::KC>(kc, cur);
    for (int l = 0; l < len; ++l) {
      float nxt[L::KC];  // the next step's coefficients, loaded ahead
      load4<L::KC>(kc + ((l + 1) & (kChunk - 1)) * L::KC, nxt);
      const float* Kbar = cur + L::oKbar;
      const float* PFt = cur + L::oPFt;
      const float* Gki = cur + L::oGki;
      const float* K = cur + L::oK;
      float o[L::KO];
      fill<L::KO>(o, 0.0f);
      float* Gkbar = o + L::oGkbar;
      float* PFtb = o + L::oPFtb;
      float* Ppbar = o + L::oPpbar;
      float Pbs[N * N];
#pragma unroll
      for (int r = 0; r < N; ++r)
#pragma unroll
        for (int q = 0; q < N; ++q)
          Pbs[r * N + q] = 0.5f * (Pb[r * N + q] + Pb[q * N + r]);
      // Kb = Kbar - Pb PFt;  PFtb = -(Pb^T K) + Kb Gki
      float PbPFt[N * P], Kb[N * P], Pbt[N * N], PbtK[N * P], KbGki[N * P];
      matmul<N, N, P>(Pbs, PFt, PbPFt);
#pragma unroll
      for (int k = 0; k < N * P; ++k) Kb[k] = Kbar[k] - PbPFt[k];
      transpose<N, N>(Pbs, Pbt);
      matmul<N, N, P>(Pbt, K, PbtK);
      matmul<N, P, P>(Kb, Gki, KbGki);
      // Gkbar = -(Gki (PFt^T (Kb Gki)));  PFtb += F^T Gkbar
      float PFtT[P * N], PFtTKbGki[P * P], GkiX[P * P], FtGkbar[N * P];
      transpose<N, P>(PFt, PFtT);
      matmul<P, N, P>(PFtT, KbGki, PFtTKbGki);
      matmul<P, P, P>(Gki, PFtTKbGki, GkiX);
#pragma unroll
      for (int k = 0; k < P * P; ++k) Gkbar[k] = -GkiX[k];
      matmul<N, P, P>(Ft, Gkbar, FtGkbar);
#pragma unroll
      for (int k = 0; k < N * P; ++k)
        PFtb[k] = (-PbtK[k] + KbGki[k]) + FtGkbar[k];
      // Ppbar = Pb + PFtb F
      float PFtbF[N * N];
      matmul<N, P, N>(PFtb, F, PFtbF);
#pragma unroll
      for (int k = 0; k < N * N; ++k) Ppbar[k] = Pbs[k] + PFtbF[k];
      store4<L::KO>(ko + l * L::KO, o);
      // Pb <- A^T (Ppbar A)
      float PpbarA[N * N];
      matmul<N, N, N>(Ppbar, A, PpbarA);
      matmul<N, N, N>(At, PpbarA, Pb);
#pragma unroll
      for (int k = 0; k < L::KC; ++k) cur[k] = nxt[k];
    }
    mbar_arrive(bar + kCarried + s);
  }
  store<N * N>(S0bar_ + (size_t)b * N * N, Pb);
}

// Adds the warp's sums of a step's values v[0..32 R) to the running totals,
// round r's sum of value 32 r + l to lane l's tot[r]: the transpose
// reduction of pipeline.cuh, a fixed xor tree for every value.
template <int R>
__device__ __forceinline__ void add_rounds(const float (&v)[32 * R],
                                           float (&tot)[R], int lane) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float w[32];
#pragma unroll
    for (int k = 0; k < 32; ++k) w[k] = v[32 * r + k];
    tot[r] = tot[r] + warp_transpose_sum(w, lane);
  }
}

// Each step's contributions, lane l for step l, summed over the chunk by the
// transpose reduction and added to lane l's running totals, round r holding
// value 32 r + l; the totals go out through shared memory.
template <int N, int M, int P>
__device__ __forceinline__ void bwd_accumulate(
    float* ring, uint64_t* bar, float* __restrict__ Abar_,
    float* __restrict__ Bbar_, float* __restrict__ Qbar_,
    float* __restrict__ Rbar_, float* __restrict__ Fbar_,
    float* __restrict__ VVbar_, float* __restrict__ WWbar_, int b, int T,
    int NC, int lane) {
  using L = BwdSlot<N, M, P>;
  constexpr int RR = L::roundsR, RK = L::roundsK;
  float totR[RR], totK[RK];
  fill<RR>(totR, 0.0f);
  fill<RK>(totK, 0.0f);
  for (int c = 0; c < NC; ++c) {
    const int s = c % L::slots, u = c / L::slots;
    mbar_wait(bar + kReady + s, u & 1);
    mbar_wait(bar + kCarried + s, u & 1);
    const float* slot = ring + s * L::floats;
    float S[N * N], SA[N * N], SB[N * M], ro[L::RO], AP[N * N], Pp[N * N],
        PFt[N * P], ko[L::KO];
    load<N * N>(slot + L::aS + lane * L::SS, S);
    load<N * N>(slot + L::aRA + lane * L::RA, SA);
    load<N * M>(slot + L::aRA + lane * L::RA + N * N, SB);
    load4<L::RO>(slot + L::aRO + lane * L::RO, ro);
    load<N * N>(slot + L::aKA + lane * L::KA, AP);
    load<N * N>(slot + L::aKA + lane * L::KA + N * N, Pp);
    load<N * P>(slot + L::aKC + lane * L::KC + L::oPFt, PFt);
    load4<L::KO>(slot + L::aKO + lane * L::KO, ko);
    mbar_arrive(bar + kFree + s);
    const bool valid = lane < T - c * kChunk;

    const float* Sb = ro + L::oSb;
    const float* Hb = ro + L::oHb;
    const float* Gbar = ro + L::oGbar;
    const float* SBbar = ro + L::oSBbar;
    const float* SAbar = ro + L::oSAbar;
    float vR[32 * RR];
    fill<32 * RR>(vR, 0.0f);
    store<M * M>(vR + L::vR, Hb);
    store<N * N>(vR + L::vQ, Sb);
    // A += SA Sb^T + S SAbar
    float Sbt[N * N], SASbt[N * N], SSAbar[N * N];
    transpose<N, N>(Sb, Sbt);
    matmul<N, N, N>(SA, Sbt, SASbt);
    matmul<N, N, N>(S, SAbar, SSAbar);
#pragma unroll
    for (int k = 0; k < N * N; ++k) vR[L::vAR + k] = SASbt[k] + SSAbar[k];
    // B += SA Gbar^T + (SB Hb^T + S SBbar)
    float Gbart[N * M], Hbt[M * M], SAGbt[N * M], SBHbt[N * M], SSBbar[N * M];
    transpose<M, N>(Gbar, Gbart);
    transpose<M, M>(Hb, Hbt);
    matmul<N, N, M>(SA, Gbart, SAGbt);
    matmul<N, M, M>(SB, Hbt, SBHbt);
    matmul<N, N, M>(S, SBbar, SSBbar);
#pragma unroll
    for (int k = 0; k < N * M; ++k)
      vR[L::vB + k] = SAGbt[k] + (SBHbt[k] + SSBbar[k]);
    // steps past T contribute zeros, whatever their stale entries hold
#pragma unroll
    for (int k = 0; k < 32 * RR; ++k) vR[k] = valid ? vR[k] : 0.0f;
    add_rounds<RR>(vR, totR, lane);

    const float* Gkbar = ko + L::oGkbar;
    const float* PFtb = ko + L::oPFtb;
    const float* Ppbar = ko + L::oPpbar;
    float vK[32 * RK];
    fill<32 * RK>(vK, 0.0f);
    store<P * P>(vK + L::vW, Gkbar);
    // F += Gkbar PFt^T + PFtb^T Pp
    float PFtT[P * N], GkbarPFtT[P * N], PFtbT[P * N], PFtbTPp[P * N];
    transpose<N, P>(PFt, PFtT);
    matmul<P, P, N>(Gkbar, PFtT, GkbarPFtT);
    transpose<N, P>(PFtb, PFtbT);
    matmul<P, N, N>(PFtbT, Pp, PFtbTPp);
#pragma unroll
    for (int k = 0; k < P * N; ++k) vK[L::vF + k] = GkbarPFtT[k] + PFtbTPp[k];
    store<N * N>(vK + L::vV, Ppbar);
    // A += (Ppbar + Ppbar^T) (A P)
    float Ppsym[N * N], PpsymAP[N * N];
#pragma unroll
    for (int r = 0; r < N; ++r)
#pragma unroll
      for (int q = 0; q < N; ++q)
        Ppsym[r * N + q] = Ppbar[r * N + q] + Ppbar[q * N + r];
    matmul<N, N, N>(Ppsym, AP, PpsymAP);
#pragma unroll
    for (int k = 0; k < N * N; ++k) vK[L::vAK + k] = PpsymAP[k];
#pragma unroll
    for (int k = 0; k < 32 * RK; ++k) vK[k] = valid ? vK[k] : 0.0f;
    add_rounds<RK>(vK, totK, lane);
  }
  // the totals meet in shared memory: the Riccati ones, then the Kalman ones
  float* sums = ring + L::slots * L::floats;
#pragma unroll
  for (int r = 0; r < RR; ++r)
    if (32 * r + lane < L::nR) sums[32 * r + lane] = totR[r];
#pragma unroll
  for (int r = 0; r < RK; ++r)
    if (32 * r + lane < L::nK) sums[L::nR + 32 * r + lane] = totK[r];
  __syncwarp();
  const float* sK = sums + L::nR;
  const size_t nn = (size_t)b * N * N;
  for (int k = lane; k < M * M; k += 32)
    Rbar_[(size_t)b * M * M + k] = sums[L::vR + k];
  for (int k = lane; k < N * M; k += 32)
    Bbar_[(size_t)b * N * M + k] = sums[L::vB + k];
  for (int k = lane; k < P * P; k += 32)
    WWbar_[(size_t)b * P * P + k] = sK[L::vW + k];
  for (int k = lane; k < P * N; k += 32)
    Fbar_[(size_t)b * P * N + k] = sK[L::vF + k];
  for (int k = lane; k < N * N; k += 32) {
    Qbar_[nn + k] = sums[L::vQ + k];
    VVbar_[nn + k] = sK[L::vV + k];
    // A's cotangent: the Riccati total plus the Kalman total
    Abar_[nn + k] = sums[L::vAR + k] + sK[L::vAK + k];
  }
}

template <int N, int M, int P>
__global__ void __launch_bounds__(kBwdThreads)
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
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  float* ring = reinterpret_cast<float*>(smem + kBwdBarBytes);
  const int b = blockIdx.x, NC = (T + kChunk - 1) / kChunk;
  if (threadIdx.x == 0) {
    for (int s = 0; s < BwdSlot<N, M, P>::slots; ++s) {
      mbar_init(bar + kLoaded + s, 32);
      mbar_init(bar + kReady + s, 32);
      mbar_init(bar + kCarried + s, 2);
      mbar_init(bar + kFree + s, 32);
    }
    mbar_init_fence();
  }
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == 0)
    bwd_copy<N, M, P>(ring, bar, S_st, P_st, Lbar_, Hbar_, Kbar_, b, batch, T,
                      NC, lane);
  else if (warp == 1 && lane == 0)
    bwd_riccati<N, M, P>(ring, bar, A_, B_, Qfbar_, b, T, NC);
  else if (warp == 2 && lane == 0)
    bwd_kalman<N, M, P>(ring, bar, A_, F_, S0bar_, b, T, NC);
  else if (warp == 3)
    bwd_recompute<N, M, P>(ring, bar, A_, B_, R_, F_, VV_, WW_, b, NC, eps,
                           lane);
  else if (warp == 4)
    bwd_accumulate<N, M, P>(ring, bar, Abar_, Bbar_, Qbar_, Rbar_, Fbar_,
                            VVbar_, WWbar_, b, T, NC, lane);
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

constexpr int kBlockThreads = 64;  // the Riccati warp, the Kalman warp

template <int N, int M, int P, bool SR, bool SK>
void launch_fwd_block(const float* A, const float* B, const float* Q,
                      const float* R, const float* Qf, const float* F,
                      const float* VV, const float* WW, const float* Sigma0,
                      float* L, float* H, float* K, float* S_st, float* P_st,
                      int batch, int T, float eps, cudaStream_t stream) {
  if (S_st != nullptr)
    gains_fwd_block<N, M, P, true, SR, SK>
        <<<batch, kBlockThreads, 0, stream>>>(A, B, Q, R, Qf, F, VV, WW,
                                              Sigma0, L, H, K, S_st, P_st,
                                              batch, T, eps);
  else
    gains_fwd_block<N, M, P, false, SR, SK>
        <<<batch, kBlockThreads, 0, stream>>>(A, B, Q, R, Qf, F, VV, WW,
                                              Sigma0, L, H, K, nullptr,
                                              nullptr, batch, T, eps);
}

template <int N, int M, int P>
int launch_bwd(const float* A, const float* B, const float* R, const float* F,
               const float* VV, const float* WW, const float* S_st,
               const float* P_st, const float* Lbar, const float* Hbar,
               const float* Kbar, float* Abar, float* Bbar, float* Qbar,
               float* Rbar, float* Qfbar, float* Fbar, float* VVbar,
               float* WWbar, float* S0bar, int batch, int T, float eps,
               cudaStream_t stream) {
  constexpr size_t bytes = BwdSlot<N, M, P>::bytes;
  const cudaError_t err = cudaFuncSetAttribute(
      gains_bwd<N, M, P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  gains_bwd<N, M, P><<<batch, kBwdThreads, bytes, stream>>>(
      A, B, R, F, VV, WW, S_st, P_st, Lbar, Hbar, Kbar, Abar, Bbar, Qbar, Rbar,
      Qfbar, Fbar, VVbar, WWbar, S0bar, batch, T, eps);
  return static_cast<int>(cudaGetLastError());
}

// The instantiated (n, m, p) of this library: calls fn with Dims<n, m, p>,
// or returns cudaErrorInvalidValue.  The source is built once per part
// (-DLQG_PART=k), each part a library of its own, so that the parts compile
// in parallel; part k holds the instances that
// lqg_tpu_torch/ops/kernels/gains.py:PART maps to k.  Part 0 is the zoo's
// six; parts 1-4 the delay wrapper's (4, 6, 8 states at m = 1, p = 1-2) and
// the envelopes at n = 8 that the rest of the scope is padded onto.
#ifndef LQG_PART
#define LQG_PART 0
#endif
template <int N_, int M_, int P_>
struct Dims {
  static constexpr int N = N_, M = M_, P = P_;
};

template <class Fn>
int dispatch(int n, int m, int p, Fn&& fn) {
#if LQG_PART == 0
  if (n == 2 && m == 1 && p == 2) return fn(Dims<2, 1, 2>{});
  if (n == 2 && m == 1 && p == 1) return fn(Dims<2, 1, 1>{});
  if (n == 3 && m == 1 && p == 2) return fn(Dims<3, 1, 2>{});
  if (n == 4 && m == 1 && p == 3) return fn(Dims<4, 1, 3>{});
  if (n == 5 && m == 1 && p == 2) return fn(Dims<5, 1, 2>{});
  if (n == 4 && m == 2 && p == 2) return fn(Dims<4, 2, 2>{});
#elif LQG_PART == 1
  if (n == 4 && m == 1 && p == 2) return fn(Dims<4, 1, 2>{});
  if (n == 4 && m == 1 && p == 1) return fn(Dims<4, 1, 1>{});
  if (n == 6 && m == 1 && p == 2) return fn(Dims<6, 1, 2>{});
  if (n == 6 && m == 1 && p == 1) return fn(Dims<6, 1, 1>{});
#elif LQG_PART == 2
  if (n == 8 && m == 1 && p == 2) return fn(Dims<8, 1, 2>{});
  if (n == 8 && m == 1 && p == 1) return fn(Dims<8, 1, 1>{});
#elif LQG_PART == 3
  if (n == 8 && m == 1 && p == 3) return fn(Dims<8, 1, 3>{});
  if (n == 8 && m == 2 && p == 1) return fn(Dims<8, 2, 1>{});
#elif LQG_PART == 4
  if (n == 8 && m == 2 && p == 2) return fn(Dims<8, 2, 2>{});
  if (n == 8 && m == 2 && p == 3) return fn(Dims<8, 2, 3>{});
#else
#error "gains.cu has parts 0-4"
#endif
  return cudaErrorInvalidValue;
}

}  // namespace

// Every entry returns cudaGetLastError() after the launch (K2: or the
// error of its shared-memory attribute call), or cudaErrorInvalidValue for
// an (n, m, p) that is not instantiated or an empty problem.  K1 writes the
// stores when S_st and P_st are both given (both null: the store-free
// variant); lqg_gains_fwd launches its thread design.
extern "C" int lqg_gains_fwd(const float* A, const float* B, const float* Q,
                             const float* R, const float* Qf, const float* F,
                             const float* VV, const float* WW,
                             const float* Sigma0, float* L, float* H, float* K,
                             float* S_st, float* P_st, int n, int m, int p,
                             int batch, int T, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch < 1 || T < 1 || (S_st == nullptr) != (P_st == nullptr))
    return cudaErrorInvalidValue;
  return dispatch(n, m, p, [&](auto d) {
    using D = decltype(d);
    launch_fwd<D::N, D::M, D::P>(A, B, Q, R, Qf, F, VV, WW, Sigma0, L, H, K,
                                 S_st, P_st, batch, T, eps, s);
    return static_cast<int>(cudaGetLastError());
  });
}

// K1's block design, each instance in its BlockLayout; the same contract.
extern "C" int lqg_gains_fwd_block(const float* A, const float* B,
                                   const float* Q, const float* R,
                                   const float* Qf, const float* F,
                                   const float* VV, const float* WW,
                                   const float* Sigma0, float* L, float* H,
                                   float* K, float* S_st, float* P_st, int n,
                                   int m, int p, int batch, int T, float eps,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch < 1 || T < 1 || (S_st == nullptr) != (P_st == nullptr))
    return cudaErrorInvalidValue;
  return dispatch(n, m, p, [&](auto d) {
    using D = decltype(d);
    using Lay = BlockLayout<D::N, D::M, D::P>;
    launch_fwd_block<D::N, D::M, D::P, Lay::riccati, Lay::kalman>(
        A, B, Q, R, Qf, F, VV, WW, Sigma0, L, H, K, S_st, P_st, batch, T, eps,
        s);
    return static_cast<int>(cudaGetLastError());
  });
}

#ifdef LQG_K1_LAYOUTS
// The block design in a given layout (spread_riccati, spread_kalman: 1 for
// the spread layout, 0 for one lane), for scripts/k1_designs.py, which
// builds this file with -DLQG_K1_LAYOUTS to measure every layout.
extern "C" int lqg_gains_fwd_layout(const float* A, const float* B,
                                    const float* Q, const float* R,
                                    const float* Qf, const float* F,
                                    const float* VV, const float* WW,
                                    const float* Sigma0, float* L, float* H,
                                    float* K, float* S_st, float* P_st, int n,
                                    int m, int p, int batch, int T, float eps,
                                    int spread_riccati, int spread_kalman,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch < 1 || T < 1 || (S_st == nullptr) != (P_st == nullptr))
    return cudaErrorInvalidValue;
  return dispatch(n, m, p, [&](auto d) {
    using D = decltype(d);
    const int which = 2 * (spread_riccati != 0) + (spread_kalman != 0);
    // the spread layouts need a lane for each of the carry's n^2 entries
    if constexpr (D::N * D::N > 32) {
      if (which != 0) return static_cast<int>(cudaErrorInvalidValue);
      launch_fwd_block<D::N, D::M, D::P, false, false>(
          A, B, Q, R, Qf, F, VV, WW, Sigma0, L, H, K, S_st, P_st, batch, T,
          eps, s);
      return static_cast<int>(cudaGetLastError());
    } else if (which == 0)
      launch_fwd_block<D::N, D::M, D::P, false, false>(
          A, B, Q, R, Qf, F, VV, WW, Sigma0, L, H, K, S_st, P_st, batch, T,
          eps, s);
    else if (which == 1)
      launch_fwd_block<D::N, D::M, D::P, false, true>(
          A, B, Q, R, Qf, F, VV, WW, Sigma0, L, H, K, S_st, P_st, batch, T,
          eps, s);
    else if (which == 2)
      launch_fwd_block<D::N, D::M, D::P, true, false>(
          A, B, Q, R, Qf, F, VV, WW, Sigma0, L, H, K, S_st, P_st, batch, T,
          eps, s);
    else
      launch_fwd_block<D::N, D::M, D::P, true, true>(
          A, B, Q, R, Qf, F, VV, WW, Sigma0, L, H, K, S_st, P_st, batch, T,
          eps, s);
    return static_cast<int>(cudaGetLastError());
  });
}
#endif

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
  return dispatch(n, m, p, [&](auto d) {
    using D = decltype(d);
    return launch_bwd<D::N, D::M, D::P>(A, B, R, F, VV, WW, S_st, P_st, Lbar,
                                        Hbar, Kbar, Abar, Bbar, Qbar, Rbar,
                                        Qfbar, Fbar, VVbar, WWbar, S0bar,
                                        batch, T, eps, s);
  });
}

// K2's steps a chunk, which the plain version's sum order repeats
// (lqg_tpu_torch/ops/kernels/gains.py:CHUNK).
extern "C" int lqg_gains_bwd_chunk() { return kChunk; }
