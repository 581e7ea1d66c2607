// K3: fused conditioned and marginalized trajectory likelihood, and K4, its
// analytic adjoint.  One thread block per parameter set p; the set's trials
// are threads of the block.
//
// K3 replaces lqg_tpu/ops/pallas/likelihood.py:_ll_fwd_kernel, K4 replaces
// likelihood.py:_ll_bwd_kernel.  They keep those kernels' arithmetic, not
// their layout.  Wrappers, the torch.autograd.Function that joins them, and
// their plain PyTorch versions: lqg_tpu_torch/ops/kernels/likelihood.py.
//
// Inputs, row-major: F, Q (P, T, J, J), X (P, n, T+1, D).  Output ll (P, n).
// The stores variant (STORES, taken only when a gradient is needed) also
// writes the carries entering each step t = 0..T: Sigma_t once per set,
// (P, T+1, J, J), and mu_t trial-fastest, (P, T+1, J, n).
//
// The split.  Sigma_t, S_t^-1, log det S_t, FS_t, P_t = FS_t[:, :D] and
// J_t = P_t S_t^-1 are functions of (F, Q) alone; only mu_t, e_t and the
// quadratic form are per trial.  So
//   ll_i = -0.5 (((((qc_i + ldc) + quad_T,i) + log det S_T) + quad_i) + ld
//                + T D log 2pi)
// with one log-det Neumaier sum (ld, ldc) per set: the very sequence each
// lane of the per-lane formulation computes.  In the adjoint, the mu-bar
// chain (mb <- F^T mb' - [eb; 0], eb = J^T mb' - mask w S^-1 e) is per trial
// and never reads Sigma-bar, and the Sigma-bar chain is linear in its
// per-trial sources with data-free coefficients (F, Sigma, J, P, S^-1).  So
// the sum over trials of Sigma-bar follows the same recursion fed with four
// trial sums a step: A = sum mb' mu^T (J x J), B = sum mb' e^T (J x D),
// C = sum mask w e e^T (D x D) and sw = sum mask w (the seed at t = T:
// C = sum (w/2) (S^-1 e)(S^-1 e)^T, sw = sum w).  F-bar_t = sym(Sb') FS + A
// + FS-bar Sigma and Q-bar_t = sym(Sb') are then produced once per set.
//
// The block.  Warp 0 copies, warp 1 runs the covariance chain, warps 2..
// are the trials, one thread a trial (NT = 32..128 threads; where n > NT a
// thread carries trials i, i + NT, ..., their carries parked in a per-set
// scratch in device memory between time chunks).  Time goes in chunks of
// Tc steps through two rings of two slots in shared memory, each slot with
// mbarriers for "filled" and "released":
// - the copy warp stages F_t, Q_t (K4: F_t, Sigma_t) of a chunk, and a
//   chunk's x_t (K4: also mu_t) for one group of NT trials, with 4-byte
//   cp.async copies that arrive on the slot's mbarrier when they land (the
//   rows are not 16-byte aligned in general: X's trial stride is (T+1) D
//   floats, F's step stride J J; at ~70 copies a lane per chunk the copy
//   warp is far from its issue limit);
// - the covariance warp spreads a J x J matrix over its lanes (element
//   e = lane, lane + 32, ...) and takes products from operands in shared
//   memory; it uses the closed-form sym_inv<D> and eps of small_matrix.cuh
//   and the same symmetrization, and publishes J_t, S_t^-1 (and in K4 FS_t)
//   for the chunk into the slot, up to two chunks ahead of the trials.  In
//   K3 the lane of (r, c) computes rows r and c of FS itself, so a step
//   takes one __syncwarp(); K4's Sigma-bar chain takes two;
// - the trial threads read F_t, J_t and S_t^-1 as broadcasts from shared
//   memory and run mu <- F mu + J e and the quad Neumaier sum (K3), or the
//   mu-bar chain (K4).  No device-memory load sits on either chain.
// K4 walks the chunks backwards.  Its covariance warp recomputes S^-1, FS, P
// and J from Sigma_t exactly as K3 did (for the next chunk, before it waits
// on the trials' sums of this one), then runs the Sigma-bar chain and writes
// F-bar_t and Q-bar_t once per set.  Each trial warp reduces a step's
// J J + J D + D D + 1 contributions with the transpose reduction of
// pipeline.cuh (31 shuffles per 32 values); lane k adds sum k to its warp's
// partial in the slot (groups in order), and the covariance warp adds the
// warps' partials in order: a fixed order, no atomics, so repeated launches
// give identical bits.  The data cotangents are written over the staged x_t
// in shared memory and leave the block one group-chunk at a time, coalesced.
//
// Bound on an H100: latency.  The work (K3 ~7 MB at P = 24, n = 20,
// T = 1000) would take the card microseconds; the time is one set's chain of
// dependent steps, and it is the covariance warp's (with the trial threads'
// arithmetic compiled out, K3 and K4 take nearly as long): per step a D x D
// inverse with its division, a logf, two J-deep dot products and a round
// through shared memory; in K4 the Sigma-bar chain's two rounds.  One warp
// issues in order, so a step costs the sum of its latencies unless the
// compiler can interleave its independent parts, which it does only within
// a basic block.  Hence each step is kept one block: element loops have a
// fixed trip count (lanes past the matrix redo its last element and store
// nothing), the D x D block of S-bar is formed in every lane and selected,
// and t = T runs K3's step on finite unused entries.  K4's recompute of
// S^-1, FS and J takes one step a lane, the steps of a chunk being
// independent.  Tensor cores do not apply: the products are J <= 12 per set,
// below an mma tile.
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "pipeline.cuh"
#include "small_matrix.cuh"

namespace {

using namespace lqg;

constexpr int kRing = 2;             // slots of each ring
constexpr int kRoleThreads = 64;     // the copy warp and the covariance warp
constexpr int kMaxTrialThreads = 128;
constexpr int kMaxChunk = 32;        // time steps a slot
constexpr int kBarBytes = 128;       // room for 16 mbarriers
constexpr size_t kSmemLimit = 232448;  // 227 KB, a block's most

// mbarriers, kRing of each
constexpr int kLoaded = 0;   // copy warp -> chunk slot filled (32 arrivals)
constexpr int kReady = 2;    // covariance warp -> slot published (32)
constexpr int kFree = 4;     // slot released to the copy warp
constexpr int kXFull = 6;    // copy warp -> trial slot filled (32)
constexpr int kXFree = 8;    // trials -> trial slot released (NT)
constexpr int kSummed = 10;  // K4: trials -> a chunk's sums written (NT)

__device__ __forceinline__ void neumaier_add(float& s, float& comp, float v) {
  const float t = s + v;
  comp = comp + (fabsf(s) >= fabsf(v) ? (s - t) + v : (v - t) + s);
  s = t;
}

// Shared memory of K3, after the mbarriers: kRing chunk slots (F_t, Q_t,
// J_t, S_t^-1 for Tc steps), kRing trial slots (x_t of NT trials, Tc D + 1
// floats a trial so that neighbouring threads hit other banks), and the
// covariance warp's two Sigma buffers and the final terms.
template <int J, int D>
struct FwdLayout {
  static constexpr int JJ = J * J;
  int Tc, NT, XS;
  float* ring;
  float* xring;
  float* sig;
  float* fin;

  __host__ __device__ static int slot_floats(int Tc) {
    return Tc * (2 * JJ + J * D + D * D);
  }
  __host__ __device__ static int xslot_floats(int Tc, int NT) {
    return NT * (Tc * D + 1);
  }
  __host__ __device__ static int floats(int Tc, int NT) {
    return kRing * (slot_floats(Tc) + xslot_floats(Tc, NT)) + 2 * JJ + 4;
  }
  __host__ __device__ static size_t bytes(int Tc, int NT) {
    return kBarBytes + sizeof(float) * (size_t)floats(Tc, NT);
  }
  __device__ FwdLayout(unsigned char* smem, int Tc_, int NT_)
      : Tc(Tc_), NT(NT_), XS(Tc_ * D + 1) {
    ring = reinterpret_cast<float*>(smem + kBarBytes);
    xring = ring + kRing * slot_floats(Tc);
    sig = xring + kRing * xslot_floats(Tc, NT);
    fin = sig + 2 * JJ;
  }
  __device__ float* F(int s) const { return ring + s * slot_floats(Tc); }
  __device__ float* Q(int s) const { return F(s) + Tc * JJ; }
  __device__ float* Jm(int s) const { return Q(s) + Tc * JJ; }
  __device__ float* Si(int s) const { return Jm(s) + Tc * J * D; }
  __device__ float* x(int s) const { return xring + s * xslot_floats(Tc, NT); }
};

// K3's copy warp: chunk c's F_t, Q_t (t < T), then its x_t (t <= T) group by
// group, each slot refilled once its consumers released it.
template <int J, int D>
__device__ __forceinline__ void fwd_copy(const FwdLayout<J, D>& L, uint64_t* bar,
                         const float* __restrict__ F_,
                         const float* __restrict__ Q_,
                         const float* __restrict__ X_, int p, int n, int T,
                         int G, int NC, int lane) {
  constexpr int JJ = J * J;
  const float* Fp = F_ + (size_t)p * T * JJ;
  const float* Qp = Q_ + (size_t)p * T * JJ;
  for (int c = 0; c < NC; ++c) {
    const int s = c % kRing, u = c / kRing;
    if (u > 0) mbar_wait(bar + kFree + s, (u - 1) & 1);
    const int t0 = c * L.Tc;
    const int nF = min(L.Tc, T - t0) * JJ;
    float* Fd = L.F(s);
    float* Qd = L.Q(s);
    for (int k = lane; k < nF; k += 32) {
      cp_async4(Fd + k, Fp + (size_t)t0 * JJ + k);
      cp_async4(Qd + k, Qp + (size_t)t0 * JJ + k);
    }
    cp_async_arrive(bar + kLoaded + s);
    const int row = min(L.Tc, T + 1 - t0) * D;
    for (int g = 0; g < G; ++g) {
      const int q = c * G + g, xs = q % kRing, ux = q / kRing;
      if (ux > 0) mbar_wait(bar + kXFree + xs, (ux - 1) & 1);
      const int nq = min(L.NT, n - g * L.NT);
      float* xd = L.x(xs);
      const float* src =
          X_ + ((size_t)p * n + (size_t)g * L.NT) * (T + 1) * D + (size_t)t0 * D;
      for (int k = lane; k < nq * row; k += 32) {
        const int i = k / row, r = k % row;
        cp_async4(xd + i * L.XS + r, src + (size_t)i * (T + 1) * D + r);
      }
      cp_async_arrive(bar + kXFull + xs);
    }
  }
}

// K3's covariance warp: the data-free recursion, once per set.  The lane
// that owns element (r, c) computes rows r and c of FS itself (2 J J FMAs)
// and from them both (r, c) and (c, r) of FS F^T + Q - J P^T, so the new
// Sigma comes out symmetric with one __syncwarp() a step: Sigma ping-pongs
// between two buffers, read from one while written into the other.  Beyond
// J J = 32 a lane owns several elements and recomputes their rows, which
// trades FMAs for the rounds through shared memory.
template <int J, int D, bool STORES>
__device__ __forceinline__ void fwd_cov(const FwdLayout<J, D>& L,
                                        uint64_t* bar,
                                        float* __restrict__ Sig_st, int p,
                                        int T, int NC, float eps, int lane) {
  constexpr int JJ = J * J, DD = D * D;
  float ld_acc = 0.0f, ld_c = 0.0f;
  int cur = 0;
  for (int c = 0; c < NC; ++c) {
    const int s = c % kRing;
    mbar_wait(bar + kLoaded + s, (c / kRing) & 1);
    const float* Fc = L.F(s);
    const float* Qc = L.Q(s);
    float* Jc = L.Jm(s);
    float* Sc = L.Si(s);
    const int t0 = c * L.Tc, len = min(L.Tc, T + 1 - t0);
    if (c == 0) {  // Sigma_0 = Q_0
      for (int e = lane; e < JJ; e += 32) L.sig[e] = Qc[e];
      __syncwarp();
    }
    for (int tt = 0; tt < len; ++tt) {
      const int t = t0 + tt;
      const float* sig = L.sig + cur * JJ;
      float* nxt = L.sig + (cur ^ 1) * JJ;
      float S[DD], Sinv[DD];
#pragma unroll
      for (int r = 0; r < D; ++r)
#pragma unroll
        for (int k = 0; k < D; ++k) S[r * D + k] = sig[r * J + k];
      const float det = sym_inv<D>(S, eps, Sinv);
      if (lane == 0) {
#pragma unroll
        for (int k = 0; k < DD; ++k) Sc[tt * DD + k] = Sinv[k];
      }
      if (STORES) {
#pragma unroll
        for (int e = lane; e < (JJ + 31) / 32 * 32; e += 32)
          if (e < JJ) Sig_st[((size_t)p * (T + 1) + t) * JJ + e] = sig[e];
      }
      // t = T runs the step too, on finite unused slot entries, so that no
      // branch splits it; its log det waits for the final score and its
      // products are never read
      const float ld = logf(det);
      neumaier_add(ld_acc, ld_c, t < T ? (t >= 1 ? 1.0f : 0.0f) * ld : 0.0f);
      if (t == T && lane == 0) {  // the final score's log det, and the sums
        L.fin[0] = ld_c;
        L.fin[1] = ld;
        L.fin[2] = ld_acc;
      }
      const float* Ft = Fc + tt * JJ;
      const float* Qt = Qc + tt * JJ;
      // a fixed trip count keeps the step one basic block, so the compiler
      // can interleave the logf above with the products; lanes past JJ
      // redo the last element and store nothing
#pragma unroll
      for (int e0 = 0; e0 < JJ; e0 += 32) {
        const int e = min(e0 + lane, JJ - 1);
        const bool mine = e0 + lane < JJ;
        const int r = e / J, col = e % J;
        // rows r and col of FS = F Sigma; of J = P S^-1, P = FS[:, :D]
        float fr[J], fc[J], jr[D], jc[D], jout = 0.0f;
#pragma unroll
        for (int k = 0; k < J; ++k) {
          float a = Ft[r * J] * sig[k], b = Ft[col * J] * sig[k];
#pragma unroll
          for (int l = 1; l < J; ++l) {
            a = a + Ft[r * J + l] * sig[l * J + k];
            b = b + Ft[col * J + l] * sig[l * J + k];
          }
          fr[k] = a;
          fc[k] = b;
        }
#pragma unroll
        for (int m = 0; m < D; ++m) {
          float a = fr[0] * Sinv[m], b = fc[0] * Sinv[m];
#pragma unroll
          for (int k = 1; k < D; ++k) {
            a = a + fr[k] * Sinv[k * D + m];
            b = b + fc[k] * Sinv[k * D + m];
          }
          jr[m] = a;
          jc[m] = b;
          if (m == col) jout = a;
        }
        // (FS F^T + Q) - J P^T at (r, col) and (col, r)
        float a = fr[0] * Ft[col * J], b = fc[0] * Ft[r * J];
#pragma unroll
        for (int k = 1; k < J; ++k) {
          a = a + fr[k] * Ft[col * J + k];
          b = b + fc[k] * Ft[r * J + k];
        }
        float ja = jr[0] * fc[0], jb = jc[0] * fr[0];
#pragma unroll
        for (int k = 1; k < D; ++k) {
          ja = ja + jr[k] * fc[k];
          jb = jb + jc[k] * fr[k];
        }
        const float v = 0.5f * (((a + Qt[r * J + col]) - ja) +
                                ((b + Qt[col * J + r]) - jb));
        if (mine) nxt[e] = v;
        if (mine && col < D) Jc[tt * J * D + r * D + col] = jout;
      }
      __syncwarp();
      cur ^= 1;
    }
    mbar_arrive(bar + kReady + s);
  }
}

// K3's trial threads: the mean and the quadratic form of trial g NT + tid.
template <int J, int D, bool STORES>
__device__ __forceinline__ void fwd_trials(const FwdLayout<J, D>& L, uint64_t* bar,
                           float* __restrict__ ll, float* __restrict__ mu_st,
                           float* __restrict__ state, int p, int n, int T,
                           int G, int NC, float log2pi_term, int tid) {
  constexpr int JJ = J * J, DD = D * D;
  const int NT = L.NT, NTot = G * NT;
  float mu[J];
#pragma unroll
  for (int k = 0; k < J; ++k) mu[k] = 0.0f;
  float quad_acc = 0.0f, quad_c = 0.0f;
  for (int c = 0; c < NC; ++c) {
    const int s = c % kRing;
    mbar_wait(bar + kReady + s, (c / kRing) & 1);
    const float* Fc = L.F(s);
    const float* Jc = L.Jm(s);
    const float* Sc = L.Si(s);
    const int t0 = c * L.Tc, len = min(L.Tc, T + 1 - t0);
    for (int g = 0; g < G; ++g) {
      const int q = c * G + g, xs = q % kRing;
      mbar_wait(bar + kXFull + xs, (q / kRing) & 1);
      const int i = g * NT + tid;
      const bool active = i < n;
      float* st = state + (size_t)p * (J + 2) * NTot + i;
      if (c == 0) {
        quad_acc = 0.0f;
        quad_c = 0.0f;
      } else if (G > 1 && active) {
#pragma unroll
        for (int k = 0; k < J; ++k) mu[k] = st[(size_t)k * NTot];
        quad_acc = st[(size_t)J * NTot];
        quad_c = st[(size_t)(J + 1) * NTot];
      }
      const float* xd = L.x(xs) + tid * L.XS;
      for (int tt = 0; tt < len; ++tt) {
        const int t = t0 + tt;
        float x[D];
#pragma unroll
        for (int k = 0; k < D; ++k) x[k] = xd[tt * D + k];
        if (t == 0) {  // mu_0 = [x_0; 0]
#pragma unroll
          for (int k = 0; k < J; ++k) mu[k] = k < D ? x[k] : 0.0f;
        }
        if (STORES && active) {
#pragma unroll
          for (int k = 0; k < J; ++k)
            mu_st[(((size_t)p * (T + 1) + t) * J + k) * n + i] = mu[k];
        }
        float Sinv[DD], e[D], Se[D];
#pragma unroll
        for (int k = 0; k < DD; ++k) Sinv[k] = Sc[tt * DD + k];
#pragma unroll
        for (int k = 0; k < D; ++k) e[k] = x[k] - mu[k];
        matmul<D, D, 1>(Sinv, e, Se);
        float quad = e[0] * Se[0];
#pragma unroll
        for (int r = 1; r < D; ++r) quad = quad + e[r] * Se[r];
        if (t == T) {
          if (active) {
            const float total = (((((quad_c + L.fin[0]) + quad) + L.fin[1]) +
                                  quad_acc) +
                                 L.fin[2]) +
                                log2pi_term;
            ll[(size_t)p * n + i] = -0.5f * total;
          }
          break;
        }
        neumaier_add(quad_acc, quad_c, (t >= 1 ? 1.0f : 0.0f) * quad);
        // mu <- F mu + J e
        const float* Ft = Fc + tt * JJ;
        const float* Jt = Jc + tt * J * D;
        float next[J];
#pragma unroll
        for (int r = 0; r < J; ++r) {
          float fm = Ft[r * J] * mu[0];
#pragma unroll
          for (int k = 1; k < J; ++k) fm = fm + Ft[r * J + k] * mu[k];
          float je = Jt[r * D] * e[0];
#pragma unroll
          for (int k = 1; k < D; ++k) je = je + Jt[r * D + k] * e[k];
          next[r] = fm + je;
        }
#pragma unroll
        for (int r = 0; r < J; ++r) mu[r] = next[r];
      }
      if (G > 1 && active && c < NC - 1) {
#pragma unroll
        for (int k = 0; k < J; ++k) st[(size_t)k * NTot] = mu[k];
        st[(size_t)J * NTot] = quad_acc;
        st[(size_t)(J + 1) * NTot] = quad_c;
      }
      mbar_arrive(bar + kXFree + xs);
    }
    mbar_arrive(bar + kFree + s);
  }
}

template <int J, int D, bool STORES>
__global__ void __launch_bounds__(kRoleThreads + kMaxTrialThreads)
    ll_fwd(const float* __restrict__ F_, const float* __restrict__ Q_,
           const float* __restrict__ X_, float* __restrict__ ll,
           float* __restrict__ Sig_st, float* __restrict__ mu_st,
           float* __restrict__ state, int n, int T, int Tc, float eps,
           float log2pi_term) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int NT = blockDim.x - kRoleThreads;
  const FwdLayout<J, D> L(smem, Tc, NT);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  const int p = blockIdx.x, G = (n + NT - 1) / NT, NC = T / Tc + 1;
  // zeros in the slots of trials i >= n keep their arithmetic finite
  for (int k = threadIdx.x; k < FwdLayout<J, D>::floats(Tc, NT);
       k += blockDim.x)
    L.ring[k] = 0.0f;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kRing; ++s) {
      mbar_init(bar + kLoaded + s, 32);
      mbar_init(bar + kReady + s, 32);
      mbar_init(bar + kFree + s, NT);
      mbar_init(bar + kXFull + s, 32);
      mbar_init(bar + kXFree + s, NT);
    }
    mbar_init_fence();
  }
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == 0)
    fwd_copy<J, D>(L, bar, F_, Q_, X_, p, n, T, G, NC, lane);
  else if (warp == 1)
    fwd_cov<J, D, STORES>(L, bar, Sig_st, p, T, NC, eps, lane);
  else
    fwd_trials<J, D, STORES>(L, bar, ll, mu_st, state, p, n, T, G, NC,
                             log2pi_term, threadIdx.x - kRoleThreads);
}

// Shared memory of K4, after the mbarriers: kRing chunk slots (F_t, Sigma_t,
// FS_t, J_t, S_t^-1 and the trial warps' partial sums, NW x KS a step),
// kRing trial slots (x_t, overwritten by the data cotangent, and mu_t,
// trial-fastest), and the covariance warp's Sigma-bar carry, the chunk's
// sym(Sigma-bar) and FS-bar, step by step, and J-bar.
template <int J, int D>
struct BwdLayout {
  static constexpr int JJ = J * J;
  static constexpr int KS = JJ + J * D + D * D + 1;  // sums a step
  int Tc, NT, NW, XS;
  float* ring;
  float* xring;
  float* sbar;
  float* sbn;    // Tc steps
  float* fsbar;  // Tc steps
  float* jbar;

  __host__ __device__ static int slot_floats(int Tc, int NT) {
    return Tc * (3 * JJ + J * D + D * D + (NT / 32) * KS);
  }
  __host__ __device__ static int xslot_floats(int Tc, int NT) {
    return NT * (Tc * D + 1) + Tc * J * NT;
  }
  __host__ __device__ static int floats(int Tc, int NT) {
    return kRing * (slot_floats(Tc, NT) + xslot_floats(Tc, NT)) + JJ +
           2 * Tc * JJ + J * D;
  }
  __host__ __device__ static size_t bytes(int Tc, int NT) {
    return kBarBytes + sizeof(float) * (size_t)floats(Tc, NT);
  }
  __device__ BwdLayout(unsigned char* smem, int Tc_, int NT_)
      : Tc(Tc_), NT(NT_), NW(NT_ / 32), XS(Tc_ * D + 1) {
    ring = reinterpret_cast<float*>(smem + kBarBytes);
    xring = ring + kRing * slot_floats(Tc, NT);
    sbar = xring + kRing * xslot_floats(Tc, NT);
    sbn = sbar + JJ;
    fsbar = sbn + Tc * JJ;
    jbar = fsbar + Tc * JJ;
  }
  __device__ float* F(int s) const { return ring + s * slot_floats(Tc, NT); }
  __device__ float* Sg(int s) const { return F(s) + Tc * JJ; }
  __device__ float* FS(int s) const { return Sg(s) + Tc * JJ; }
  __device__ float* Jm(int s) const { return FS(s) + Tc * JJ; }
  __device__ float* Si(int s) const { return Jm(s) + Tc * J * D; }
  __device__ float* part(int s) const { return Si(s) + Tc * D * D; }
  __device__ float* x(int s) const { return xring + s * xslot_floats(Tc, NT); }
  __device__ float* mu(int s) const { return x(s) + NT * XS; }
};

// K4's copy warp: chunks backwards; F_t (t < T) and Sigma_t, then x_t and
// mu_t of each group.
template <int J, int D>
__device__ __forceinline__ void bwd_copy(const BwdLayout<J, D>& L, uint64_t* bar,
                         const float* __restrict__ F_,
                         const float* __restrict__ X_,
                         const float* __restrict__ Sig_st,
                         const float* __restrict__ mu_st, int p, int n, int T,
                         int G, int NC, int lane) {
  constexpr int JJ = J * J;
  const float* Fp = F_ + (size_t)p * T * JJ;
  const float* Sp = Sig_st + (size_t)p * (T + 1) * JJ;
  for (int q = 0; q < NC; ++q) {
    const int c = NC - 1 - q, s = q % kRing, u = q / kRing;
    if (u > 0) mbar_wait(bar + kFree + s, (u - 1) & 1);
    const int t0 = c * L.Tc, len = min(L.Tc, T + 1 - t0);
    const int nF = min(len, T - t0) * JJ;
    float* Fd = L.F(s);
    float* Sd = L.Sg(s);
    for (int k = lane; k < nF; k += 32)
      cp_async4(Fd + k, Fp + (size_t)t0 * JJ + k);
    for (int k = lane; k < len * JJ; k += 32)
      cp_async4(Sd + k, Sp + (size_t)t0 * JJ + k);
    cp_async_arrive(bar + kLoaded + s);
    const int row = len * D;
    for (int g = 0; g < G; ++g) {
      const int r = q * G + g, xs = r % kRing, ux = r / kRing;
      if (ux > 0) mbar_wait(bar + kXFree + xs, (ux - 1) & 1);
      const int nq = min(L.NT, n - g * L.NT);
      float* xd = L.x(xs);
      const float* src =
          X_ + ((size_t)p * n + (size_t)g * L.NT) * (T + 1) * D + (size_t)t0 * D;
      for (int k = lane; k < nq * row; k += 32) {
        const int i = k / row, rr = k % row;
        cp_async4(xd + i * L.XS + rr, src + (size_t)i * (T + 1) * D + rr);
      }
      float* md = L.mu(xs);
      const float* msrc =
          mu_st + ((size_t)p * (T + 1) + t0) * J * n + (size_t)g * L.NT;
      for (int k = lane; k < len * J * nq; k += 32) {
        const int rr = k / nq, i = k % nq;
        cp_async4(md + rr * L.NT + i, msrc + (size_t)rr * n + i);
      }
      cp_async_arrive(bar + kXFull + xs);
    }
  }
}

// K4's covariance warp, part 1: S^-1, FS and J of chunk slot s from the
// staged Sigma_t and F_t, as K3 computed them.  The chunk's steps do not
// depend on each other, so each lane takes one.
template <int J, int D>
__device__ __forceinline__ void bwd_prep(const BwdLayout<J, D>& L, int s,
                                         int t0, int len, int T, float eps,
                                         int lane) {
  constexpr int JJ = J * J, DD = D * D;
  for (int tt = lane; tt < len; tt += 32) {
    const float* sig = L.Sg(s) + tt * JJ;
    float S[DD], Sinv[DD];
#pragma unroll
    for (int r = 0; r < D; ++r)
#pragma unroll
      for (int k = 0; k < D; ++k) S[r * D + k] = sig[r * J + k];
    sym_inv<D>(S, eps, Sinv);
#pragma unroll
    for (int k = 0; k < DD; ++k) L.Si(s)[tt * DD + k] = Sinv[k];
    if (t0 + tt == T) continue;
    const float* Ft = L.F(s) + tt * JJ;
    float* FS = L.FS(s) + tt * JJ;
    float* Jt = L.Jm(s) + tt * J * D;
#pragma unroll
    for (int r = 0; r < J; ++r) {
      float row[J];
#pragma unroll
      for (int c = 0; c < J; ++c) {
        float acc = Ft[r * J] * sig[c];
#pragma unroll
        for (int k = 1; k < J; ++k) acc = acc + Ft[r * J + k] * sig[k * J + c];
        row[c] = acc;
        FS[r * J + c] = acc;
      }
#pragma unroll
      for (int c = 0; c < D; ++c) {
        float acc = row[0] * Sinv[c];
#pragma unroll
        for (int m = 1; m < D; ++m) acc = acc + row[m] * Sinv[m * D + c];
        Jt[r * D + c] = acc;
      }
    }
  }
  __syncwarp();
}

// The sum over the trial warps, in order, of a step's partial sum k (a
// fixed trip count, so no loop splits the chain's step).
__device__ __forceinline__ float warp_sums(const float* part, int NW, int KS,
                                           int k) {
  float acc = part[k];
#pragma unroll
  for (int w = 1; w < kMaxTrialThreads / 32; ++w)
    if (w < NW) acc = acc + part[w * KS + k];
  return acc;
}

// K4's covariance warp, part 2: the Sigma-bar chain over chunk slot s, steps
// t0 + len - 1 down to t0, from the trials' sums.  A warp issues in order,
// so a step carries only what the next one needs (Sigma-bar); sym(Sigma-bar)
// and FS-bar are kept step by step, and F-bar_t and Q-bar_t of the chunk
// are formed after its last step, one element a lane, coalesced.
template <int J, int D>
__device__ __forceinline__ void bwd_chain(const BwdLayout<J, D>& L, int s,
                                          int t0, int len, int p, int T,
                                          float* __restrict__ Fbar_,
                                          float* __restrict__ Qbar_, int lane) {
  constexpr int JJ = J * J, DD = D * D, KS = BwdLayout<J, D>::KS;
  constexpr int kB = JJ, kC = JJ + J * D, kW = KS - 1;
  float* sbar = L.sbar;
  int tt = len - 1;
  if (t0 + tt == T) {  // seed: Sigma-bar = sum (w/2) Se Se^T - (sum w / 2) S^-1
    const float* part = L.part(s) + tt * L.NW * KS;
    const float* Si = L.Si(s) + tt * DD;
    const float hw = 0.5f * warp_sums(part, L.NW, KS, kW);
    for (int e = lane; e < JJ; e += 32) {
      const int r = e / J, col = e % J;
      sbar[e] = r < D && col < D
                    ? warp_sums(part, L.NW, KS, kC + r * D + col) -
                          hw * Si[r * D + col]
                    : 0.0f;
    }
    __syncwarp();
    --tt;
  }
  for (; tt >= 0; --tt) {
    const int t = t0 + tt;
    const float* part = L.part(s) + tt * L.NW * KS;
    const float* Si = L.Si(s) + tt * DD;
    const float* Ft = L.F(s) + tt * JJ;
    const float* FS = L.FS(s) + tt * JJ;
    const float* Jt = L.Jm(s) + tt * J * D;
    // Sbn = sym(Sigma-bar'), row r in registers;
    // FS-bar = Sbn F (+ P-bar in its first D columns);
    // J-bar = -(Sbn P) + B; P-bar = -(Sbn J) + J-bar S^-1
#pragma unroll
    for (int e0 = 0; e0 < JJ; e0 += 32) {  // as in fwd_cov: one basic block
      const int e = min(e0 + lane, JJ - 1);
      const bool mine = e0 + lane < JJ;
      const int r = e / J, col = e % J;
      float sr[J];
#pragma unroll
      for (int k = 0; k < J; ++k)
        sr[k] = 0.5f * (sbar[r * J + k] + sbar[k * J + r]);
      const float sbn = 0.5f * (sbar[r * J + col] + sbar[col * J + r]);
      float fsb = sr[0] * Ft[col];
#pragma unroll
      for (int k = 1; k < J; ++k) fsb = fsb + sr[k] * Ft[k * J + col];
      // J-bar row r and P-bar at column cd: lanes with col >= D compute
      // column D - 1 and discard it, so no branch splits the step
      const int cd = min(col, D - 1);
      float jb[D];
#pragma unroll
      for (int m = 0; m < D; ++m) {
        float a = sr[0] * FS[m];
#pragma unroll
        for (int k = 1; k < J; ++k) a = a + sr[k] * FS[k * J + m];
        jb[m] = -a + warp_sums(part, L.NW, KS, kB + r * D + m);
      }
      float sj = sr[0] * Jt[cd];
#pragma unroll
      for (int k = 1; k < J; ++k) sj = sj + sr[k] * Jt[k * D + cd];
      float js = jb[0] * Si[cd];
#pragma unroll
      for (int m = 1; m < D; ++m) js = js + jb[m] * Si[m * D + cd];
      float jc = 0.0f;
#pragma unroll
      for (int m = 0; m < D; ++m)
        if (m == cd) jc = jb[m];
      if (col < D) fsb = fsb + (-sj + js);
      if (mine && col < D) L.jbar[r * D + col] = jc;
      if (mine) {
        L.fsbar[tt * JJ + e] = fsb;
        L.sbn[tt * JJ + e] = sbn;
      }
    }
    __syncwarp();
    // Sigma-bar = F^T FS-bar + sym(S-bar) on the D x D block, with
    // S^-1-bar = P^T J-bar - C / 2 and S-bar = -(S^-1 (S^-1-bar S^-1))
    // - S^-1 (sw / 2)
    const float* fsbar = L.fsbar + tt * JJ;
#pragma unroll
    for (int e0 = 0; e0 < JJ; e0 += 32) {
      const int e = min(e0 + lane, JJ - 1);
      const bool mine = e0 + lane < JJ;
      const int r = e / J, col = e % J;
      float nsb = Ft[r] * fsbar[col];
#pragma unroll
      for (int k = 1; k < J; ++k) nsb = nsb + Ft[k * J + r] * fsbar[k * J + col];
      // S-bar is the same D x D block in every lane; the lanes of that block
      // add their element
      float Sinv[DD], Sib[DD], SS[DD], Sb[DD];
#pragma unroll
      for (int k = 0; k < DD; ++k) Sinv[k] = Si[k];
#pragma unroll
      for (int a = 0; a < D; ++a)
#pragma unroll
        for (int b = 0; b < D; ++b) {
          float acc = FS[a] * L.jbar[b];
#pragma unroll
          for (int k = 1; k < J; ++k) acc = acc + FS[k * J + a] * L.jbar[k * D + b];
          Sib[a * D + b] = acc - warp_sums(part, L.NW, KS, kC + a * D + b) * 0.5f;
        }
      const float hw = 0.5f * warp_sums(part, L.NW, KS, kW);
      matmul<D, D, D>(Sib, Sinv, SS);
      matmul<D, D, D>(Sinv, SS, Sb);
#pragma unroll
      for (int k = 0; k < DD; ++k) Sb[k] = -Sb[k] - Sinv[k] * hw;
      const int rd = min(r, D - 1), cd = min(col, D - 1);
      float v = 0.0f;
#pragma unroll
      for (int a = 0; a < D; ++a)
#pragma unroll
        for (int b = 0; b < D; ++b)
          if (a == rd && b == cd) v = 0.5f * (Sb[a * D + b] + Sb[b * D + a]);
      if (r < D && col < D) nsb = nsb + v;
      if (mine) sbar[e] = nsb;
    }
    __syncwarp();
  }
  // F-bar_t = (Sbn FS + A) + FS-bar Sigma and Q-bar_t = Sbn; at t = 0
  // Sigma_0 = Q_0, so the carry's cotangent folds into Q-bar_0
  for (int idx = lane; idx < len * JJ; idx += 32) {
    const int tt = idx / JJ, e = idx % JJ, t = t0 + tt;
    if (t == T) continue;
    const int r = e / J, col = e % J;
    const float* sbn = L.sbn + tt * JJ;
    const float* fsbar = L.fsbar + tt * JJ;
    const float* FS = L.FS(s) + tt * JJ;
    const float* sig = L.Sg(s) + tt * JJ;
    float sfs = sbn[r * J] * FS[col];
#pragma unroll
    for (int k = 1; k < J; ++k) sfs = sfs + sbn[r * J + k] * FS[k * J + col];
    float fb = fsbar[r * J] * sig[col];
#pragma unroll
    for (int k = 1; k < J; ++k) fb = fb + fsbar[r * J + k] * sig[k * J + col];
    Fbar_[((size_t)p * T + t) * JJ + e] =
        (sfs + warp_sums(L.part(s) + tt * L.NW * KS, L.NW, KS, e)) + fb;
    float qb = sbn[e];
    if (t == 0) qb = qb + 0.5f * (sbar[r * J + col] + sbar[col * J + r]);
    Qbar_[((size_t)p * T + t) * JJ + e] = qb;
  }
  __syncwarp();
}

template <int J, int D>
__device__ __forceinline__ void bwd_cov(const BwdLayout<J, D>& L, uint64_t* bar, int p, int T,
                        int NC, float eps, float* __restrict__ Fbar_,
                        float* __restrict__ Qbar_, int lane) {
  auto prep = [&](int q) {
    const int c = NC - 1 - q, s = q % kRing, t0 = c * L.Tc;
    mbar_wait(bar + kLoaded + s, (q / kRing) & 1);
    bwd_prep<J, D>(L, s, t0, min(L.Tc, T + 1 - t0), T, eps, lane);
    mbar_arrive(bar + kReady + s);
  };
  prep(0);
  for (int q = 0; q < NC; ++q) {
    if (q + 1 < NC) prep(q + 1);  // the trials go on while the chain runs
    const int c = NC - 1 - q, s = q % kRing, t0 = c * L.Tc;
    mbar_wait(bar + kSummed + s, (q / kRing) & 1);
    bwd_chain<J, D>(L, s, t0, min(L.Tc, T + 1 - t0), p, T, Fbar_, Qbar_, lane);
    mbar_arrive(bar + kFree + s);
  }
}

// Trial k's share of a step's sums: A = mb mu^T, B = mb e^T, C = cw e e^T,
// then sw.  k is a compile-time constant once the caller's loop unrolls.
template <int J, int D>
__device__ __forceinline__ float contribution(int k, const float* mb,
                                              const float* mu, const float* e,
                                              float cw, float sw) {
  if (k < J * J) return mb[k / J] * mu[k % J];
  k -= J * J;
  if (k < J * D) return mb[k / D] * e[k % D];
  k -= J * D;
  if (k < D * D) return cw * (e[k / D] * e[k % D]);
  return k == D * D ? sw : 0.0f;
}

// Reduces the step's sums over the warp and adds them to its partial (the
// first group writes it).
template <int J, int D>
__device__ __forceinline__ void reduce_step(float* part, int g, bool active,
                                            const float* mb, const float* mu,
                                            const float* e, float cw, float sw,
                                            int lane) {
  constexpr int KS = BwdLayout<J, D>::KS;
#pragma unroll
  for (int rd = 0; rd < (KS + 31) / 32; ++rd) {
    float v[32];
#pragma unroll
    for (int l = 0; l < 32; ++l)
      v[l] = active ? contribution<J, D>(rd * 32 + l, mb, mu, e, cw, sw) : 0.0f;
    const float sum = warp_transpose_sum(v, lane);
    const int k = rd * 32 + lane;
    if (k < KS) part[k] = g == 0 ? sum : part[k] + sum;
  }
}

// K4's trial threads: the mu-bar chain of trial g NT + tid, its data
// cotangent, and its share of the sums.
template <int J, int D>
__device__ __forceinline__ void bwd_trials(const BwdLayout<J, D>& L, uint64_t* bar,
                           const float* __restrict__ w_,
                           float* __restrict__ Xbar_, float* __restrict__ state,
                           int p, int n, int T, int G, int NC, int tid) {
  constexpr int JJ = J * J, DD = D * D, KS = BwdLayout<J, D>::KS;
  const int NT = L.NT, NTot = G * NT, lane = tid % 32, wt = tid / 32;
  float mb[J], zero[J];
#pragma unroll
  for (int k = 0; k < J; ++k) {
    mb[k] = 0.0f;
    zero[k] = 0.0f;
  }
  float w = tid < n ? w_[(size_t)p * n + tid] : 0.0f;
  for (int q = 0; q < NC; ++q) {
    const int c = NC - 1 - q, s = q % kRing;
    mbar_wait(bar + kReady + s, (q / kRing) & 1);
    const float* Fc = L.F(s);
    const float* Jc = L.Jm(s);
    const float* Sc = L.Si(s);
    const int t0 = c * L.Tc, len = min(L.Tc, T + 1 - t0);
    for (int g = 0; g < G; ++g) {
      const int r = q * G + g, xs = r % kRing;
      mbar_wait(bar + kXFull + xs, (r / kRing) & 1);
      const int i = g * NT + tid;
      const bool active = i < n;
      float* st = state + (size_t)p * J * NTot + i;
      if (G > 1) {
        w = active ? w_[(size_t)p * n + i] : 0.0f;
#pragma unroll
        for (int k = 0; k < J; ++k)
          mb[k] = q > 0 && active ? st[(size_t)k * NTot] : 0.0f;
      }
      float* xd = L.x(xs) + tid * L.XS;
      const float* md = L.mu(xs) + tid;
      for (int tt = len - 1; tt >= 0; --tt) {
        const int t = t0 + tt;
        float* part = L.part(s) + (tt * L.NW + wt) * KS;
        float mu[J], Sinv[DD], e[D], Se[D], xb[D];
#pragma unroll
        for (int k = 0; k < J; ++k) mu[k] = md[(tt * J + k) * NT];
#pragma unroll
        for (int k = 0; k < DD; ++k) Sinv[k] = Sc[tt * DD + k];
#pragma unroll
        for (int k = 0; k < D; ++k) e[k] = xd[tt * D + k] - mu[k];
        matmul<D, D, 1>(Sinv, e, Se);
        if (t == T) {
          // seed: mb = [w S^-1 e; 0], x-bar_T = -w S^-1 e
          reduce_step<J, D>(part, g, active, zero, mu, Se, 0.5f * w, w, lane);
#pragma unroll
          for (int k = 0; k < J; ++k) mb[k] = k < D ? w * Se[k] : 0.0f;
#pragma unroll
          for (int k = 0; k < D; ++k) xb[k] = -w * Se[k];
        } else {
          const float mw = (t >= 1 ? 1.0f : 0.0f) * w;
          reduce_step<J, D>(part, g, active, mb, mu, e, mw, mw, lane);
          // e-bar = J^T mb' - mw S^-1 e;  mb = F^T mb' - [e-bar; 0]
          const float* Ft = Fc + tt * JJ;
          const float* Jt = Jc + tt * J * D;
          float eb[D], nb[J];
#pragma unroll
          for (int k = 0; k < D; ++k) {
            float a = Jt[k] * mb[0];
#pragma unroll
            for (int rr = 1; rr < J; ++rr) a = a + Jt[rr * D + k] * mb[rr];
            eb[k] = a - Se[k] * mw;
          }
#pragma unroll
          for (int k = 0; k < J; ++k) {
            float a = Ft[k] * mb[0];
#pragma unroll
            for (int rr = 1; rr < J; ++rr) a = a + Ft[rr * J + k] * mb[rr];
            nb[k] = k < D ? a - eb[k] : a;
          }
          // data cotangent: x_0 also reaches mu_0 = [x_0; 0]
#pragma unroll
          for (int k = 0; k < D; ++k) xb[k] = t == 0 ? eb[k] + nb[k] : eb[k];
#pragma unroll
          for (int k = 0; k < J; ++k) mb[k] = nb[k];
        }
#pragma unroll
        for (int k = 0; k < D; ++k) xd[tt * D + k] = xb[k];
      }
      if (G > 1 && active && q < NC - 1) {
#pragma unroll
        for (int k = 0; k < J; ++k) st[(size_t)k * NTot] = mb[k];
      }
      // the group's data cotangents leave the block, coalesced
      named_sync(1, NT);
      const int nq = min(NT, n - g * NT), row = len * D;
      const float* xsrc = L.x(xs);
      float* dst = Xbar_ + ((size_t)p * n + (size_t)g * NT) * (T + 1) * D +
                   (size_t)t0 * D;
      for (int k = tid; k < nq * row; k += NT) {
        const int ii = k / row, rr = k % row;
        dst[(size_t)ii * (T + 1) * D + rr] = xsrc[ii * L.XS + rr];
      }
      mbar_arrive(bar + kXFree + xs);
    }
    mbar_arrive(bar + kSummed + s);
  }
}

template <int J, int D>
__global__ void __launch_bounds__(kRoleThreads + kMaxTrialThreads)
    ll_bwd(const float* __restrict__ F_, const float* __restrict__ X_,
           const float* __restrict__ w_, const float* __restrict__ Sig_st,
           const float* __restrict__ mu_st, float* __restrict__ Fbar_,
           float* __restrict__ Qbar_, float* __restrict__ Xbar_,
           float* __restrict__ state, int n, int T, int Tc, float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int NT = blockDim.x - kRoleThreads;
  const BwdLayout<J, D> L(smem, Tc, NT);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  const int p = blockIdx.x, G = (n + NT - 1) / NT, NC = T / Tc + 1;
  for (int k = threadIdx.x; k < BwdLayout<J, D>::floats(Tc, NT);
       k += blockDim.x)
    L.ring[k] = 0.0f;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kRing; ++s) {
      mbar_init(bar + kLoaded + s, 32);
      mbar_init(bar + kReady + s, 32);
      mbar_init(bar + kFree + s, 32);
      mbar_init(bar + kXFull + s, 32);
      mbar_init(bar + kXFree + s, NT);
      mbar_init(bar + kSummed + s, NT);
    }
    mbar_init_fence();
  }
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == 0)
    bwd_copy<J, D>(L, bar, F_, X_, Sig_st, mu_st, p, n, T, G, NC, lane);
  else if (warp == 1)
    bwd_cov<J, D>(L, bar, p, T, NC, eps, Fbar_, Qbar_, lane);
  else
    bwd_trials<J, D>(L, bar, w_, Xbar_, state, p, n, T, G, NC,
                     threadIdx.x - kRoleThreads);
}

// The longest chunk (a power of two, at most kMaxChunk) whose rings fit a
// block's shared memory; 0 if none does.
template <class Layout>
int plan_chunk(int nt, size_t* bytes) {
  for (int Tc = kMaxChunk; Tc >= 1; Tc /= 2) {
    *bytes = Layout::bytes(Tc, nt);
    if (*bytes <= kSmemLimit) return Tc;
  }
  return 0;
}

}  // namespace

template <int J, int D, bool STORES>
static int launch_fwd(const float* F, const float* Q, const float* X,
                      float* ll, float* Sig_st, float* mu_st, float* state,
                      int P, int n, int T, int nt, float eps,
                      float log2pi_term, cudaStream_t s) {
  size_t bytes;
  const int Tc = plan_chunk<FwdLayout<J, D>>(nt, &bytes);
  if (Tc == 0) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      ll_fwd<J, D, STORES>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  ll_fwd<J, D, STORES><<<P, kRoleThreads + nt, bytes, s>>>(
      F, Q, X, ll, Sig_st, mu_st, state, n, T, Tc, eps, log2pi_term);
  return static_cast<int>(cudaGetLastError());
}

template <int J, int D>
static int launch_bwd(const float* F, const float* X, const float* w,
                      const float* Sig_st, const float* mu_st, float* Fbar,
                      float* Qbar, float* Xbar, float* state, int P, int n,
                      int T, int nt, float eps, cudaStream_t s) {
  size_t bytes;
  const int Tc = plan_chunk<BwdLayout<J, D>>(nt, &bytes);
  if (Tc == 0) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      ll_bwd<J, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  ll_bwd<J, D><<<P, kRoleThreads + nt, bytes, s>>>(
      F, X, w, Sig_st, mu_st, Fbar, Qbar, Xbar, state, n, T, Tc, eps);
  return static_cast<int>(cudaGetLastError());
}

// nt trial threads (a multiple of 32, at most 128); when n > nt, `state` is
// a per-set scratch of (j + 2) (K3) or j (K4) floats per trial slot of the
// ceil(n / nt) nt, and may be null otherwise.
static bool launch_ok(int P, int n, int T, int nt, const float* state) {
  return P >= 1 && n >= 1 && T >= 1 && nt >= 32 && nt <= kMaxTrialThreads &&
         nt % 32 == 0 && (n <= nt || state != nullptr);
}

// The instantiated (j, d) of this library: calls fn with JD<j, d>, or
// returns cudaErrorInvalidValue.  The source is built once per part
// (-DLQG_PART=k), each part a library of its own, so that the parts compile
// in parallel; part k holds the instances that
// lqg_tpu_torch/ops/kernels/likelihood.py:PART maps to k.  Part 0 is the
// zoo's six; parts 1-2 are j = 12, the delay wrapper's (12, 2) and the
// envelopes that the rest of the scope is padded onto.
#ifndef LQG_PART
#define LQG_PART 0
#endif
template <int J_, int D_>
struct JD {
  static constexpr int J = J_, D = D_;
};

template <class Fn>
static int dispatch(int j, int d, Fn&& fn) {
#if LQG_PART == 0
  if (j == 4 && d == 2) return fn(JD<4, 2>{});
  if (j == 5 && d == 2) return fn(JD<5, 2>{});
  if (j == 8 && d == 2) return fn(JD<8, 2>{});
  if (j == 8 && d == 4) return fn(JD<8, 4>{});
  if (j == 10 && d == 2) return fn(JD<10, 2>{});
  if (j == 10 && d == 4) return fn(JD<10, 4>{});
#elif LQG_PART == 1
  if (j == 12 && d == 2) return fn(JD<12, 2>{});
  if (j == 12 && d == 1) return fn(JD<12, 1>{});
#elif LQG_PART == 2
  if (j == 12 && d == 3) return fn(JD<12, 3>{});
  if (j == 12 && d == 4) return fn(JD<12, 4>{});
#else
#error "likelihood.cu has parts 0-2"
#endif
  return cudaErrorInvalidValue;
}

// Both entries return the first CUDA error of the attribute call or the
// launch, or cudaErrorInvalidValue for a (j, d) that is not instantiated or
// sizes outside the kernels' scope.  K3 writes the stores when Sig_st and
// mu_st are both given (both null: the store-free variant).
extern "C" int lqg_ll_fwd(const float* F, const float* Q, const float* X,
                          float* ll, float* Sig_st, float* mu_st, float* state,
                          int j, int d, int P, int n, int T, int nt, float eps,
                          float log2pi_term, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!launch_ok(P, n, T, nt, state) ||
      (Sig_st == nullptr) != (mu_st == nullptr))
    return cudaErrorInvalidValue;
  const bool st = Sig_st != nullptr;
  return dispatch(j, d, [&](auto jd) {
    using S = decltype(jd);
    return st ? launch_fwd<S::J, S::D, true>(F, Q, X, ll, Sig_st, mu_st, state,
                                             P, n, T, nt, eps, log2pi_term, s)
              : launch_fwd<S::J, S::D, false>(F, Q, X, ll, nullptr, nullptr,
                                              state, P, n, T, nt, eps,
                                              log2pi_term, s);
  });
}

extern "C" int lqg_ll_bwd(const float* F, const float* X, const float* w,
                          const float* Sig_st, const float* mu_st, float* Fbar,
                          float* Qbar, float* Xbar, float* state, int j, int d,
                          int P, int n, int T, int nt, float eps,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!launch_ok(P, n, T, nt, state)) return cudaErrorInvalidValue;
  return dispatch(j, d, [&](auto jd) {
    using S = decltype(jd);
    return launch_bwd<S::J, S::D>(F, X, w, Sig_st, mu_st, Fbar, Qbar, Xbar,
                                  state, P, n, T, nt, eps, s);
  });
}
