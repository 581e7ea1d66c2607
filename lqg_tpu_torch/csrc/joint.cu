// The joint (state, belief) system of the marginalized likelihood, assembled
// from the gains straight into the layout K3/K4 read, and its adjoint.
//
// It replaces no TPU kernel: lqg_tpu builds the joint system with jnp ops
// (lqg_tpu/ops/gaussian.py:joint_system) that XLA fuses into the likelihood's
// program.  Eager PyTorch instead ran them as ~27 batched gemms over T P tiny
// matrices (1x2 to 4x4 at the bounded actor) with their cats, expands and
// copies, and the autograd of each.  Wrapper, torch.autograd.Function and
// the plain PyTorch version: lqg_tpu_torch/ops/kernels/joint.py.
//
// What it computes, for parameter set p and step t, from the gains L_t
// (NU x NA) and K_t (NA x NY) and the set's stationary spec matrices
// (dynamics A_d, B_d, F_d, V_d, W_d; actor A_a, B_a, F_a):
//   F_t = [[A_d,          B_d L                              ],
//          [K F_d A_d,    A_a - K F_a A_a + (B_a + K D) L    ]]
//   Q_t = G G^T, G = [[V_d, 0], [K F_d V_d, K W_d]], that is
//       = [[S,            (K U)^T    ],
//          [K U,          K Y K^T    ]]
// with the per-set products D = F_d B_d - F_a B_a, S = V_d V_d^T,
// U = F_d S and Y = U F_d^T + W_d W_d^T (symmetric).  G is never formed.
//
// Layouts, row-major float32: L (T, P, NU, NA) and K (T, P, NA, NY), time
// leading as K1 writes them; each spec matrix (P, r, c) with a set stride
// that is 0 for a matrix shared by every set; F, Q (P, T, J, J), J = ND + NA,
// as K3/K4 read them.  The adjoint maps (F-bar, Q-bar) to L-bar, K-bar in
// the layouts of L, K and to the eight spec gradients per set, (P, r, c),
// each summed over t inside the block.
//
// Bound on an H100: bytes.  At the 96 sets of an IAF batch, T = 1008, the
// forward reads L, K (1.5 MB) and writes F, Q (12.4 MB); the adjoint reads
// F-bar, Q-bar, L, K and writes L-bar, K-bar (14 MB): ~8 us at 3.35 TB/s.
// The arithmetic is ~300 FMAs a step at J = 4.
//
// The forward: a block takes TT consecutive steps of one set, a thread one
// step.  The set's spec matrices and the per-set products are formed once
// a block in shared memory (every thread reads them as broadcasts); a
// thread forms its F_t, then its Q_t, with FMAs in a fixed order, into a
// tile in shared memory (row stride odd, so the threads' rows fall in
// distinct banks), and the block writes each tile out as one contiguous,
// coalesced run of (P, T, J, J).  Q_t is exactly symmetric: each pair of
// mirrored entries is one computed value (S and Y are formed from ordered
// pairs, K Y K^T's upper triangle is mirrored).
//
// The adjoint: one block per set; thread k takes steps k, k + TT, ... and
// recomputes what it needs of the step from L_t, K_t (nothing is stored by
// the forward).  Per step it writes L-bar_t, K-bar_t; where a spec gradient
// is asked for it adds the step's share of ten per-set sums (below) into
// registers, which the block then reduces in a fixed tree in shared memory,
// no atomics, so that two launches give the same bits.  The spec gradients
// are formed from the ten sums once per set.  With Qs = Q-bar + Q-bar^T
// (Q is symmetric) and blocks 11, 12, 21, 22 of the joint matrices:
//   L-bar = B_d^T F-bar12 + (B_a + K D)^T F-bar22
//   K-bar = F-bar21 (F_d A_d)^T + F-bar22 (D L - F_a A_a)^T + Qs21 U^T
//           + Qs22 K Y
//   sums: a1 F-bar11, a2 F-bar12 L^T, a3 K^T F-bar21, a4 F-bar22,
//         a5 F-bar22 L^T, a6 K^T F-bar22, a7 K^T F-bar22 L^T, a8 Qs11,
//         a9 K^T Qs21, a10 K^T Qs22 K
//   A_d-bar = a1 + F_d^T a3          B_d-bar = a2 + F_d^T a7
//   F_d-bar = a3 A_d^T + a7 B_d^T + a9 S + a10 U
//   V_d-bar = Ss V_d, Ss = a8 + F_d^T a9 + a9^T F_d + F_d^T a10 F_d
//   W_d-bar = a10 W_d                A_a-bar = a4 - F_a^T a6
//   B_a-bar = a5 - F_a^T a7          F_a-bar = -a6 A_a^T - a7 B_a^T
// Tensor cores do not apply: the products are at most 12 deep.
#include <cuda_runtime.h>

namespace {

// The eight spec matrices, in the order of the C interface.
enum Mat { kAd, kBd, kFd, kVd, kWd, kAa, kBa, kFa, kMats };

struct Specs {
  const float* ptr[kMats];
  long long stride[kMats];  // floats between two sets' copies; 0: shared
};

struct SpecBars {
  float* ptr[kMats];  // (P, r, c) each, or nullptr where none is asked for
};

// ND dynamics states, NA actor states, NU controls, NY observations, NV and
// NW columns of the process and observation noise scales.
template <int ND_, int NA_, int NU_, int NY_, int NV_, int NW_>
struct Dims {
  static constexpr int ND = ND_, NA = NA_, NU = NU_, NY = NY_, NV = NV_,
                       NW = NW_;
  static constexpr int J = ND + NA, JJ = J * J;
  // a tile row's stride in shared memory: odd, so rows fall in distinct banks
  static constexpr int kStride = JJ % 2 ? JJ : JJ + 1;
  // steps a forward block takes (its tile within 48 KB of static memory)
  static constexpr int kFwdThreads = JJ <= 64 ? 128 : 64;
  static constexpr int kBwdThreads = JJ <= 64 ? 256 : 128;
  // offsets of the adjoint's ten per-set sums in one register array
  static constexpr int kA1 = 0, kA2 = kA1 + ND * ND, kA3 = kA2 + ND * NU,
                       kA4 = kA3 + NY * ND, kA5 = kA4 + NA * NA,
                       kA6 = kA5 + NA * NU, kA7 = kA6 + NY * NA,
                       kA8 = kA7 + NY * NU, kA9 = kA8 + ND * ND,
                       kA10 = kA9 + NY * ND, kSums = kA10 + NY * NY;
};

// One set's spec matrices and the products that do not depend on t.
template <class S>
struct SetMats {
  float Ad[S::ND][S::ND], Bd[S::ND][S::NU], Fd[S::NY][S::ND],
      Vd[S::ND][S::NV], Wd[S::NY][S::NW];
  float Aa[S::NA][S::NA], Ba[S::NA][S::NU], Fa[S::NY][S::NA];
  float FdAd[S::NY][S::ND], FaAa[S::NY][S::NA], D[S::NY][S::NU],
      Sv[S::ND][S::ND], U[S::NY][S::ND], Y[S::NY][S::NY];
};

__device__ __forceinline__ void copy_in(float* dst, const float* src, int n) {
  for (int e = threadIdx.x; e < n; e += blockDim.x) dst[e] = src[e];
}

// Load set p's spec matrices and form its products; ends synchronized.
template <class S>
__device__ void load_set(SetMats<S>& sm, const Specs& specs, int p) {
  constexpr int ND = S::ND, NA = S::NA, NU = S::NU, NY = S::NY, NV = S::NV,
                NW = S::NW;
  float* dst[kMats] = {&sm.Ad[0][0], &sm.Bd[0][0], &sm.Fd[0][0],
                       &sm.Vd[0][0], &sm.Wd[0][0], &sm.Aa[0][0],
                       &sm.Ba[0][0], &sm.Fa[0][0]};
  const int size[kMats] = {ND * ND, ND * NU, NY * ND, ND * NV,
                           NY * NW, NA * NA, NA * NU, NY * NA};
#pragma unroll
  for (int i = 0; i < kMats; ++i)
    copy_in(dst[i], specs.ptr[i] + p * specs.stride[i], size[i]);
  __syncthreads();
  const int tid = threadIdx.x, nth = blockDim.x;
  for (int e = tid; e < NY * ND; e += nth) {
    const int q = e / ND, r = e % ND;
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < ND; ++k) acc = fmaf(sm.Fd[q][k], sm.Ad[k][r], acc);
    sm.FdAd[q][r] = acc;
  }
  for (int e = tid; e < NY * NA; e += nth) {
    const int q = e / NA, c = e % NA;
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < NA; ++k) acc = fmaf(sm.Fa[q][k], sm.Aa[k][c], acc);
    sm.FaAa[q][c] = acc;
  }
  for (int e = tid; e < NY * NU; e += nth) {
    const int q = e / NU, u = e % NU;
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < ND; ++k) acc = fmaf(sm.Fd[q][k], sm.Bd[k][u], acc);
#pragma unroll
    for (int k = 0; k < NA; ++k) acc = fmaf(-sm.Fa[q][k], sm.Ba[k][u], acc);
    sm.D[q][u] = acc;
  }
  for (int e = tid; e < ND * ND; e += nth) {
    // from the ordered pair: S[r][c] and S[c][r] are one value
    const int a = min(e / ND, e % ND), b = max(e / ND, e % ND);
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < NV; ++k) acc = fmaf(sm.Vd[a][k], sm.Vd[b][k], acc);
    sm.Sv[e / ND][e % ND] = acc;
  }
  __syncthreads();
  for (int e = tid; e < NY * ND; e += nth) {
    const int q = e / ND, r = e % ND;
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < ND; ++k) acc = fmaf(sm.Fd[q][k], sm.Sv[k][r], acc);
    sm.U[q][r] = acc;
  }
  __syncthreads();
  for (int e = tid; e < NY * NY; e += nth) {
    const int a = min(e / NY, e % NY), b = max(e / NY, e % NY);
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < NW; ++k) acc = fmaf(sm.Wd[a][k], sm.Wd[b][k], acc);
#pragma unroll
    for (int r = 0; r < ND; ++r) acc = fmaf(sm.U[a][r], sm.Fd[b][r], acc);
    sm.Y[e / NY][e % NY] = acc;
  }
  __syncthreads();
}

// L_t and K_t of set p: (T, P, NU, NA) and (T, P, NA, NY).
template <class S>
__device__ __forceinline__ void load_gains(const float* __restrict__ Lg,
                                           const float* __restrict__ Kg,
                                           int P, int t, int p,
                                           float (&L)[S::NU][S::NA],
                                           float (&K)[S::NA][S::NY]) {
  const long long tp = static_cast<long long>(t) * P + p;
  const float* l = Lg + tp * (S::NU * S::NA);
  const float* k = Kg + tp * (S::NA * S::NY);
#pragma unroll
  for (int u = 0; u < S::NU; ++u)
#pragma unroll
    for (int c = 0; c < S::NA; ++c) L[u][c] = l[u * S::NA + c];
#pragma unroll
  for (int i = 0; i < S::NA; ++i)
#pragma unroll
    for (int q = 0; q < S::NY; ++q) K[i][q] = k[i * S::NY + q];
}

// Write a block's tile of nt steps (row stride kStride) to out, contiguous.
template <class S>
__device__ __forceinline__ void write_tile(const float* tile,
                                           float* __restrict__ out, int nt) {
  for (int e = threadIdx.x; e < nt * S::JJ; e += blockDim.x)
    out[e] = tile[(e / S::JJ) * S::kStride + e % S::JJ];
}

template <class S>
__global__ void __launch_bounds__(S::kFwdThreads)
    joint_fwd(const float* __restrict__ Lg, const float* __restrict__ Kg,
              Specs specs, float* __restrict__ Fo, float* __restrict__ Qo,
              int P, int T) {
  constexpr int ND = S::ND, NA = S::NA, NU = S::NU, NY = S::NY, J = S::J;
  __shared__ SetMats<S> sm;
  __shared__ float tile[S::kFwdThreads * S::kStride];
  const int p = blockIdx.y, t0 = blockIdx.x * S::kFwdThreads;
  const int t = t0 + threadIdx.x, nt = min(S::kFwdThreads, T - t0);
  load_set(sm, specs, p);
  float L[NU][NA], K[NA][NY];
  float* row = tile + threadIdx.x * S::kStride;
  const long long base = (static_cast<long long>(p) * T + t0) * S::JJ;
  if (t < T) {
    load_gains<S>(Lg, Kg, P, t, p, L, K);
#pragma unroll
    for (int r = 0; r < ND; ++r) {
#pragma unroll
      for (int c = 0; c < ND; ++c) row[r * J + c] = sm.Ad[r][c];
#pragma unroll
      for (int c = 0; c < NA; ++c) {
        float acc = 0.0f;
#pragma unroll
        for (int u = 0; u < NU; ++u) acc = fmaf(sm.Bd[r][u], L[u][c], acc);
        row[r * J + ND + c] = acc;
      }
    }
#pragma unroll
    for (int i = 0; i < NA; ++i) {
#pragma unroll
      for (int c = 0; c < ND; ++c) {
        float acc = 0.0f;
#pragma unroll
        for (int q = 0; q < NY; ++q) acc = fmaf(K[i][q], sm.FdAd[q][c], acc);
        row[(ND + i) * J + c] = acc;
      }
      float BK[NU];  // row i of B_a + K D
#pragma unroll
      for (int u = 0; u < NU; ++u) {
        float acc = sm.Ba[i][u];
#pragma unroll
        for (int q = 0; q < NY; ++q) acc = fmaf(K[i][q], sm.D[q][u], acc);
        BK[u] = acc;
      }
#pragma unroll
      for (int c = 0; c < NA; ++c) {
        float acc = sm.Aa[i][c];
#pragma unroll
        for (int q = 0; q < NY; ++q) acc = fmaf(-K[i][q], sm.FaAa[q][c], acc);
#pragma unroll
        for (int u = 0; u < NU; ++u) acc = fmaf(BK[u], L[u][c], acc);
        row[(ND + i) * J + ND + c] = acc;
      }
    }
  }
  __syncthreads();
  write_tile<S>(tile, Fo + base, nt);
  __syncthreads();
  if (t < T) {
#pragma unroll
    for (int r = 0; r < ND; ++r)
#pragma unroll
      for (int c = 0; c < ND; ++c) row[r * J + c] = sm.Sv[r][c];
    float KY[NA][NY];
#pragma unroll
    for (int i = 0; i < NA; ++i) {
#pragma unroll
      for (int r = 0; r < ND; ++r) {
        float acc = 0.0f;
#pragma unroll
        for (int q = 0; q < NY; ++q) acc = fmaf(K[i][q], sm.U[q][r], acc);
        row[(ND + i) * J + r] = acc;
        row[r * J + ND + i] = acc;
      }
#pragma unroll
      for (int q = 0; q < NY; ++q) {
        float acc = 0.0f;
#pragma unroll
        for (int s = 0; s < NY; ++s) acc = fmaf(K[i][s], sm.Y[s][q], acc);
        KY[i][q] = acc;
      }
    }
#pragma unroll
    for (int i = 0; i < NA; ++i)
#pragma unroll
      for (int c = i; c < NA; ++c) {
        float acc = 0.0f;
#pragma unroll
        for (int q = 0; q < NY; ++q) acc = fmaf(KY[i][q], K[c][q], acc);
        row[(ND + i) * J + ND + c] = acc;
        row[(ND + c) * J + ND + i] = acc;
      }
  }
  __syncthreads();
  write_tile<S>(tile, Qo + base, nt);
}

template <class S>
__global__ void __launch_bounds__(S::kBwdThreads)
    joint_bwd(const float* __restrict__ Lg, const float* __restrict__ Kg,
              Specs specs, const float* __restrict__ Fbar,
              const float* __restrict__ Qbar, float* __restrict__ Lbar,
              float* __restrict__ Kbar, SpecBars bars, int P, int T) {
  constexpr int ND = S::ND, NA = S::NA, NU = S::NU, NY = S::NY, NV = S::NV,
                NW = S::NW, J = S::J, TB = S::kBwdThreads;
  constexpr int kChunk = 32;  // sums reduced at a time
  __shared__ SetMats<S> sm;
  __shared__ float red[TB * (kChunk + 1)];
  __shared__ float sums[S::kSums];
  const int p = blockIdx.x, tid = threadIdx.x;
  load_set(sm, specs, p);
  bool need_specs = false;
#pragma unroll
  for (int i = 0; i < kMats; ++i) need_specs |= bars.ptr[i] != nullptr;

  float a[S::kSums];
#pragma unroll
  for (int e = 0; e < S::kSums; ++e) a[e] = 0.0f;

  for (int t = tid; t < T; t += TB) {
    float L[NU][NA], K[NA][NY];
    load_gains<S>(Lg, Kg, P, t, p, L, K);
    const float* fb = Fbar + (static_cast<long long>(p) * T + t) * S::JJ;
    const float* qb = Qbar + (static_cast<long long>(p) * T + t) * S::JJ;
    auto Fb = [&](int r, int c) { return __ldg(fb + r * J + c); };
    // the symmetric part's cotangent, Q-bar + Q-bar^T
    auto Qs = [&](int r, int c) {
      return __ldg(qb + r * J + c) + __ldg(qb + c * J + r);
    };
    const long long tp = static_cast<long long>(t) * P + p;
    if (Lbar != nullptr) {
#pragma unroll
      for (int u = 0; u < NU; ++u) {
        float BK[NA];  // column u of B_a + K D
#pragma unroll
        for (int i = 0; i < NA; ++i) {
          float acc = sm.Ba[i][u];
#pragma unroll
          for (int q = 0; q < NY; ++q) acc = fmaf(K[i][q], sm.D[q][u], acc);
          BK[i] = acc;
        }
#pragma unroll
        for (int c = 0; c < NA; ++c) {
          float acc = 0.0f;
#pragma unroll
          for (int r = 0; r < ND; ++r) acc = fmaf(sm.Bd[r][u], Fb(r, ND + c), acc);
#pragma unroll
          for (int i = 0; i < NA; ++i)
            acc = fmaf(BK[i], Fb(ND + i, ND + c), acc);
          Lbar[tp * (NU * NA) + u * NA + c] = acc;
        }
      }
    }
    if (Kbar != nullptr) {
      float DLm[NY][NA], KY[NA][NY];  // D L - F_a A_a; K Y
#pragma unroll
      for (int q = 0; q < NY; ++q)
#pragma unroll
        for (int c = 0; c < NA; ++c) {
          float acc = -sm.FaAa[q][c];
#pragma unroll
          for (int u = 0; u < NU; ++u) acc = fmaf(sm.D[q][u], L[u][c], acc);
          DLm[q][c] = acc;
        }
#pragma unroll
      for (int c = 0; c < NA; ++c)
#pragma unroll
        for (int q = 0; q < NY; ++q) {
          float acc = 0.0f;
#pragma unroll
          for (int s = 0; s < NY; ++s) acc = fmaf(K[c][s], sm.Y[s][q], acc);
          KY[c][q] = acc;
        }
#pragma unroll
      for (int i = 0; i < NA; ++i)
#pragma unroll
        for (int q = 0; q < NY; ++q) {
          float acc = 0.0f;
#pragma unroll
          for (int r = 0; r < ND; ++r)
            acc = fmaf(Fb(ND + i, r), sm.FdAd[q][r], acc);
#pragma unroll
          for (int c = 0; c < NA; ++c) acc = fmaf(Fb(ND + i, ND + c), DLm[q][c], acc);
#pragma unroll
          for (int r = 0; r < ND; ++r) acc = fmaf(Qs(ND + i, r), sm.U[q][r], acc);
#pragma unroll
          for (int c = 0; c < NA; ++c)
            acc = fmaf(Qs(ND + i, ND + c), KY[c][q], acc);
          Kbar[tp * (NA * NY) + i * NY + q] = acc;
        }
    }
    if (need_specs) {
#pragma unroll
      for (int r = 0; r < ND; ++r) {
#pragma unroll
        for (int c = 0; c < ND; ++c) a[S::kA1 + r * ND + c] += Fb(r, c);
#pragma unroll
        for (int u = 0; u < NU; ++u)
#pragma unroll
          for (int c = 0; c < NA; ++c)
            a[S::kA2 + r * NU + u] =
                fmaf(Fb(r, ND + c), L[u][c], a[S::kA2 + r * NU + u]);
#pragma unroll
        for (int c = 0; c < ND; ++c) a[S::kA8 + r * ND + c] += Qs(r, c);
      }
#pragma unroll
      for (int i = 0; i < NA; ++i) {
#pragma unroll
        for (int q = 0; q < NY; ++q)
#pragma unroll
          for (int c = 0; c < ND; ++c) {
            a[S::kA3 + q * ND + c] =
                fmaf(K[i][q], Fb(ND + i, c), a[S::kA3 + q * ND + c]);
            a[S::kA9 + q * ND + c] =
                fmaf(K[i][q], Qs(ND + i, c), a[S::kA9 + q * ND + c]);
          }
#pragma unroll
        for (int c = 0; c < NA; ++c) a[S::kA4 + i * NA + c] += Fb(ND + i, ND + c);
#pragma unroll
        for (int u = 0; u < NU; ++u)
#pragma unroll
          for (int c = 0; c < NA; ++c)
            a[S::kA5 + i * NU + u] =
                fmaf(Fb(ND + i, ND + c), L[u][c], a[S::kA5 + i * NU + u]);
      }
#pragma unroll
      for (int q = 0; q < NY; ++q)
#pragma unroll
        for (int c = 0; c < NA; ++c) {
          float ktf = 0.0f;  // (K^T F-bar22)[q][c]
#pragma unroll
          for (int i = 0; i < NA; ++i) ktf = fmaf(K[i][q], Fb(ND + i, ND + c), ktf);
          a[S::kA6 + q * NA + c] += ktf;
#pragma unroll
          for (int u = 0; u < NU; ++u)
            a[S::kA7 + q * NU + u] = fmaf(ktf, L[u][c], a[S::kA7 + q * NU + u]);
        }
#pragma unroll
      for (int i = 0; i < NA; ++i)
#pragma unroll
        for (int s = 0; s < NY; ++s) {
          float qk = 0.0f;  // (Qs22 K)[i][s]
#pragma unroll
          for (int c = 0; c < NA; ++c) qk = fmaf(Qs(ND + i, ND + c), K[c][s], qk);
#pragma unroll
          for (int q = 0; q < NY; ++q)
            a[S::kA10 + q * NY + s] = fmaf(K[i][q], qk, a[S::kA10 + q * NY + s]);
        }
    }
  }
  if (!need_specs) return;  // uniform over the block

  // The block's sums, kChunk at a time: each thread's partials into a row of
  // red, then a fixed tree over the rows.
#pragma unroll
  for (int c0 = 0; c0 < S::kSums; c0 += kChunk) {
#pragma unroll
    for (int k = 0; k < kChunk; ++k)
      red[tid * (kChunk + 1) + k] =
          c0 + k < S::kSums ? a[min(c0 + k, S::kSums - 1)] : 0.0f;
    __syncthreads();
    for (int half = TB / 2; half > 0; half /= 2) {
      for (int e = tid; e < half * kChunk; e += TB) {
        const int r = e / kChunk, k = e % kChunk;
        red[r * (kChunk + 1) + k] += red[(r + half) * (kChunk + 1) + k];
      }
      __syncthreads();
    }
    if (tid < kChunk && c0 + tid < S::kSums) sums[c0 + tid] = red[tid];
    __syncthreads();
  }

  const float* a1 = sums + S::kA1;  // (ND, ND)
  const float* a2 = sums + S::kA2;  // (ND, NU)
  const float* a3 = sums + S::kA3;  // (NY, ND)
  const float* a4 = sums + S::kA4;  // (NA, NA)
  const float* a5 = sums + S::kA5;  // (NA, NU)
  const float* a6 = sums + S::kA6;  // (NY, NA)
  const float* a7 = sums + S::kA7;  // (NY, NU)
  const float* a8 = sums + S::kA8;  // (ND, ND)
  const float* a9 = sums + S::kA9;  // (NY, ND)
  const float* a10 = sums + S::kA10;  // (NY, NY)
  float* T1 = red;                  // a10 F_d (NY, ND)
  float* Ss = red + NY * ND;        // (ND, ND)
  for (int e = tid; e < NY * ND; e += TB) {
    const int q = e / ND, c = e % ND;
    float acc = 0.0f;
#pragma unroll
    for (int s = 0; s < NY; ++s) acc = fmaf(a10[q * NY + s], sm.Fd[s][c], acc);
    T1[e] = acc;
  }
  __syncthreads();
  for (int e = tid; e < ND * ND; e += TB) {
    const int r = e / ND, c = e % ND;
    float acc = a8[e];
#pragma unroll
    for (int q = 0; q < NY; ++q) {
      acc = fmaf(sm.Fd[q][r], a9[q * ND + c], acc);
      acc = fmaf(a9[q * ND + r], sm.Fd[q][c], acc);
      acc = fmaf(sm.Fd[q][r], T1[q * ND + c], acc);
    }
    Ss[e] = acc;
  }
  __syncthreads();

  const long long ps = p;
  if (float* out = bars.ptr[kAd])
    for (int e = tid; e < ND * ND; e += TB) {
      const int r = e / ND, c = e % ND;
      float acc = a1[e];
#pragma unroll
      for (int q = 0; q < NY; ++q) acc = fmaf(sm.Fd[q][r], a3[q * ND + c], acc);
      out[ps * ND * ND + e] = acc;
    }
  if (float* out = bars.ptr[kBd])
    for (int e = tid; e < ND * NU; e += TB) {
      const int r = e / NU, u = e % NU;
      float acc = a2[e];
#pragma unroll
      for (int q = 0; q < NY; ++q) acc = fmaf(sm.Fd[q][r], a7[q * NU + u], acc);
      out[ps * ND * NU + e] = acc;
    }
  if (float* out = bars.ptr[kFd])
    for (int e = tid; e < NY * ND; e += TB) {
      const int q = e / ND, r = e % ND;
      float acc = 0.0f;
#pragma unroll
      for (int c = 0; c < ND; ++c) acc = fmaf(a3[q * ND + c], sm.Ad[r][c], acc);
#pragma unroll
      for (int u = 0; u < NU; ++u) acc = fmaf(a7[q * NU + u], sm.Bd[r][u], acc);
#pragma unroll
      for (int c = 0; c < ND; ++c) acc = fmaf(a9[q * ND + c], sm.Sv[c][r], acc);
#pragma unroll
      for (int s = 0; s < NY; ++s) acc = fmaf(a10[q * NY + s], sm.U[s][r], acc);
      out[ps * NY * ND + e] = acc;
    }
  if (float* out = bars.ptr[kVd])
    for (int e = tid; e < ND * NV; e += TB) {
      const int r = e / NV, k = e % NV;
      float acc = 0.0f;
#pragma unroll
      for (int c = 0; c < ND; ++c) acc = fmaf(Ss[r * ND + c], sm.Vd[c][k], acc);
      out[ps * ND * NV + e] = acc;
    }
  if (float* out = bars.ptr[kWd])
    for (int e = tid; e < NY * NW; e += TB) {
      const int q = e / NW, k = e % NW;
      float acc = 0.0f;
#pragma unroll
      for (int s = 0; s < NY; ++s) acc = fmaf(a10[q * NY + s], sm.Wd[s][k], acc);
      out[ps * NY * NW + e] = acc;
    }
  if (float* out = bars.ptr[kAa])
    for (int e = tid; e < NA * NA; e += TB) {
      const int i = e / NA, c = e % NA;
      float acc = a4[e];
#pragma unroll
      for (int q = 0; q < NY; ++q) acc = fmaf(-sm.Fa[q][i], a6[q * NA + c], acc);
      out[ps * NA * NA + e] = acc;
    }
  if (float* out = bars.ptr[kBa])
    for (int e = tid; e < NA * NU; e += TB) {
      const int i = e / NU, u = e % NU;
      float acc = a5[e];
#pragma unroll
      for (int q = 0; q < NY; ++q) acc = fmaf(-sm.Fa[q][i], a7[q * NU + u], acc);
      out[ps * NA * NU + e] = acc;
    }
  if (float* out = bars.ptr[kFa])
    for (int e = tid; e < NY * NA; e += TB) {
      const int q = e / NA, i = e % NA;
      float acc = 0.0f;
#pragma unroll
      for (int c = 0; c < NA; ++c) acc = fmaf(-a6[q * NA + c], sm.Aa[i][c], acc);
#pragma unroll
      for (int u = 0; u < NU; ++u) acc = fmaf(-a7[q * NU + u], sm.Ba[i][u], acc);
      out[ps * NY * NA + e] = acc;
    }
}

template <class S>
static int launch_fwd(const float* L, const float* K, const Specs& specs,
                      float* F, float* Q, int P, int T, cudaStream_t s) {
  const dim3 grid((T + S::kFwdThreads - 1) / S::kFwdThreads, P);
  joint_fwd<S><<<grid, S::kFwdThreads, 0, s>>>(L, K, specs, F, Q, P, T);
  return static_cast<int>(cudaGetLastError());
}

template <class S>
static int launch_bwd(const float* L, const float* K, const Specs& specs,
                      const float* Fbar, const float* Qbar, float* Lbar,
                      float* Kbar, const SpecBars& bars, int P, int T,
                      cudaStream_t s) {
  joint_bwd<S><<<P, S::kBwdThreads, 0, s>>>(L, K, specs, Fbar, Qbar, Lbar,
                                            Kbar, bars, P, T);
  return static_cast<int>(cudaGetLastError());
}

// The instantiated dims of this library: calls fn with Dims<...>, or returns
// cudaErrorInvalidValue.  Part k (-DLQG_PART=k) holds the instances that
// lqg_tpu_torch/ops/kernels/joint.py:PART maps to k.  Part 0: the bounded
// actor and every dim=1 tracking model, the subjective actor, the delay
// wrapper at delay 1 around the dim=1 models, the hand model.  Part 1: the
// dim=2 tracking models (and the point mass, padded onto them), the
// subjective actor at dim=2, the delay wrapper at delay 2, the dim=3 models.
#ifndef LQG_PART
#define LQG_PART 0
#endif

template <class Fn>
static int dispatch(const int* dims, Fn&& fn) {
#define LQG_DIMS(a, b, c, d, e, f)                                          \
  if (dims[0] == a && dims[1] == b && dims[2] == c && dims[3] == d &&       \
      dims[4] == e && dims[5] == f)                                         \
    return fn(Dims<a, b, c, d, e, f>{});
#if LQG_PART == 0
  LQG_DIMS(2, 2, 1, 2, 2, 2)
  LQG_DIMS(2, 3, 1, 2, 2, 2)
  LQG_DIMS(4, 4, 1, 2, 4, 2)
  LQG_DIMS(5, 5, 1, 2, 5, 2)
#elif LQG_PART == 1
  LQG_DIMS(4, 4, 2, 4, 4, 4)
  LQG_DIMS(4, 6, 2, 4, 4, 4)
  LQG_DIMS(6, 6, 1, 2, 6, 2)
  LQG_DIMS(6, 6, 3, 6, 6, 6)
#endif
#undef LQG_DIMS
  return cudaErrorInvalidValue;
}

static bool make_specs(const void* const* mats, const long long* strides,
                       Specs* specs) {
  for (int i = 0; i < kMats; ++i) {
    if (mats[i] == nullptr || strides[i] < 0) return false;
    specs->ptr[i] = static_cast<const float*>(mats[i]);
    specs->stride[i] = strides[i];
  }
  return true;
}

}  // namespace

// dims: ND, NA, NU, NY, NV, NW.  mats: the eight spec matrices in the order
// A_d, B_d, F_d, V_d, W_d, A_a, B_a, F_a, each with its set stride.
extern "C" int lqg_joint_fwd(const float* L, const float* K,
                             const void* const* mats,
                             const long long* strides, float* F, float* Q,
                             const int* dims, int P, int T, void* stream) {
  Specs specs;
  if (P < 1 || P > 65535 || T < 1 || !make_specs(mats, strides, &specs))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch(dims, [&](auto d) {
    return launch_fwd<decltype(d)>(L, K, specs, F, Q, P, T, s);
  });
}

// bars: the eight spec gradients' outputs, (P, r, c) each, or null; Lbar,
// Kbar likewise.
extern "C" int lqg_joint_bwd(const float* L, const float* K,
                             const void* const* mats,
                             const long long* strides, const float* Fbar,
                             const float* Qbar, float* Lbar, float* Kbar,
                             void* const* bars, const int* dims, int P, int T,
                             void* stream) {
  Specs specs;
  if (P < 1 || T < 1 || !make_specs(mats, strides, &specs))
    return cudaErrorInvalidValue;
  SpecBars out;
  for (int i = 0; i < kMats; ++i) out.ptr[i] = static_cast<float*>(bars[i]);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch(dims, [&](auto d) {
    return launch_bwd<decltype(d)>(L, K, specs, Fbar, Qbar, Lbar, Kbar, out, P,
                                   T, s);
  });
}
