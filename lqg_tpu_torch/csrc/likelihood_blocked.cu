// K5: the large-j conditioned and marginalized trajectory likelihood, one
// thread-block cluster per parameter set, and K6, its analytic adjoint.
//
// K5 replaces lqg_tpu/ops/pallas/likelihood_blocked.py:_ll_blocked_kernel, K6
// replaces likelihood_blocked.py:_ll_blocked_bwd_kernel.  Wrappers, the
// torch.autograd.Function that joins them, the cluster-size rule, the buffer
// plan and their plain PyTorch versions:
// lqg_tpu_torch/ops/kernels/likelihood_blocked.py.
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
// every thread, and the j^3 products and the j^2 n product of a step are
// register-tiled float32 FMA loops.  No tensor cores, no TF32.
//
// Bound on an H100: operations by the count (three j^3-sized products a
// step), but each set's T steps form one chain, and one block per set put
// 24 of the card's 132 SMs to work at the fit's 24 sets.  So a set runs on a
// cluster of C blocks (C in {1, 2, 4, 8}, launched with
// cudaLaunchAttributeClusterDimension; the wrapper picks C).  Rank r of a
// cluster owns the rows R_r of a near-even split of [0, j): every rank holds
// the full carries and F_t in its shared memory, computes the O(j^2) and
// O(j n d) parts of a step redundantly, computes the rows R_r of the j^3
// products, and writes them into every rank's next carry through
// distributed shared memory (cluster.map_shared_rank).  One cluster barrier
// ends a K5 step; the carries are double-buffered so that no rank writes a
// row another still reads.  Each output is summed by one thread in the k
// order of the one-block kernel, starting from its addend, so K5's ll and
// stores are the same bits at every C.  C = 1 is the one-block-per-set
// layout of the earlier kernel.
//
// Buffers: the wrapper places each large buffer in shared memory while the
// block's 227 KB last and in a per-rank scratch in device memory after that
// (place[i] >= 0: offset in shared memory; < 0: offset -place[i] - 1 in the
// scratch); the staged F_t, when it has no room, is read where it lies.  A
// carry in the scratch is written into every rank's copy as one in shared
// memory is.  The kernels address every buffer through generic pointers, so
// one code path serves j = 65 (all in shared memory) and j = n = 128.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "small_matrix.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace lqg;

constexpr int kMaxThreads = 512;
constexpr int kMaxCluster = 8;
// floats at the start of shared memory for the table of the ranks' carry
// addresses: four carries (K5: two Sig, two MU; K6: B, m) of kMaxCluster
// ranks, 8-byte pointers
constexpr int kTable = 4 * kMaxCluster * 2;

__host__ __device__ inline int round4(int k) { return (k + 3) / 4 * 4; }

// Rows [start, start + rows) of rank r: a near-even split of [0, j) over C.
__host__ __device__ inline void row_panel(int j, int C, int r, int& start,
                                          int& rows) {
  const int base = j / C, extra = j % C;
  rows = base + (r < extra ? 1 : 0);
  start = r * base + (r < extra ? r : extra);
}

__device__ __forceinline__ void neumaier_add(float& s, float& comp, float v) {
  const float t = s + v;
  comp = comp + (fabsf(s) >= fabsf(v) ? (s - t) + v : (v - t) + s);
  s = t;
}

__device__ __forceinline__ float* buffer(float* smem, float* scratch,
                                         int place) {
  return place >= 0 ? smem + place : scratch + (-place - 1);
}

// Where a product's outputs go: a row-major matrix of this block, or the
// same rows of every rank's copy of a carry (dst: the ranks' addresses,
// offset to the panel's first row).
struct Local {
  float* C;
  int ld;
  __device__ __forceinline__ void operator()(int a, int b, float v) const {
    C[a * ld + b] = v;
  }
};

struct Peers {
  float* const* dst;
  int ranks, offset, ld;
  __device__ __forceinline__ void operator()(int a, int b, float v) const {
    const int at = offset + a * ld + b;
    for (int q = 0; q < ranks; ++q) dst[q][at] = v;
  }
};

// out(a, b) = alpha (add(a, b) + sum_k A1(a, k) B1(k, b)) + sum_k A2(a, k)
// B2(k, b) for a < M, b < N, by all threads of the block, TM x TN outputs a
// thread.  alpha scales only where a second product follows (K2 > 0), and
// the callers pass an addend only without one.  Operands are addressed by
// strides, A(a, k) = A[a ars + k acs], B(k, b) = B[k brs + b bcs], so a
// transposed operand is a swap of strides; add is row-major with leading
// dimension ldadd.  K2 = 0 leaves the second product out, add = nullptr the
// addend.  A thread owns the rows ay + r nty and the columns bx + c ntx: the
// threads of a warp read consecutive columns of B.  Indices past the edge
// are clamped for the loads and skipped by the stores.  Each output is one
// thread's sum in the order k = 0, 1, ..., whatever the tile, so the bits do
// not depend on TM, TN or the number of threads.  The caller synchronizes.
template <int TM, int TN, class Store>
__device__ void gemm_tiled(int M, int N, int K1, const float* A1, int a1rs,
                           int a1cs, const float* B1, int b1rs, int b1cs,
                           float alpha, int K2, const float* A2, int a2rs,
                           int a2cs, const float* B2, int b2rs, int b2cs,
                           const float* add, int ldadd, Store store) {
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
        acc[r][c] = add != nullptr ? add[row[r] * ldadd + col[c]] : 0.0f;

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
        store(a, b, acc[r][c]);
      }
    }
  }
}

// gemm_tiled with the tile that gives the shortest chain a thread: per k, a
// thread runs TM TN multiply-adds and TM + TN loads, over ceil(tiles /
// threads) tiles.  4 x 4 for a whole j x j product at one block per set, 2 x
// 2 or 1 x 1 for a rank's panel of a few rows.
template <class Store>
__device__ __forceinline__ void gemm(int M, int N, int K1, const float* A1,
                                     int a1rs, int a1cs, const float* B1,
                                     int b1rs, int b1cs, float alpha, int K2,
                                     const float* A2, int a2rs, int a2cs,
                                     const float* B2, int b2rs, int b2cs,
                                     const float* add, int ldadd,
                                     Store store) {
  const int threads = blockDim.x;
  const auto chain = [&](int tm, int tn) {
    const int tiles = ((M + tm - 1) / tm) * ((N + tn - 1) / tn);
    return (tiles + threads - 1) / threads * (tm * tn + tm + tn);
  };
  const int c4 = chain(4, 4), c2 = chain(2, 2), c1 = chain(1, 1);
  if (c4 <= c2 && c4 <= c1)
    gemm_tiled<4, 4>(M, N, K1, A1, a1rs, a1cs, B1, b1rs, b1cs, alpha, K2, A2,
                     a2rs, a2cs, B2, b2rs, b2cs, add, ldadd, store);
  else if (c2 <= c1)
    gemm_tiled<2, 2>(M, N, K1, A1, a1rs, a1cs, B1, b1rs, b1cs, alpha, K2, A2,
                     a2rs, a2cs, B2, b2rs, b2cs, add, ldadd, store);
  else
    gemm_tiled<1, 1>(M, N, K1, A1, a1rs, a1cs, B1, b1rs, b1cs, alpha, K2, A2,
                     a2rs, a2cs, B2, b2rs, b2cs, add, ldadd, store);
}

template <class Store>
__device__ __forceinline__ void gemm1(int M, int N, int K, const float* A,
                                      int ars, int acs, const float* B,
                                      int brs, int bcs, const float* add,
                                      int ldadd, Store store) {
  gemm(M, N, K, A, ars, acs, B, brs, bcs, 1.0f, 0, nullptr, 0, 0, nullptr, 0,
       0, add, ldadd, store);
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

// The table of the ranks' copies of `count` carries: table[c C + q] is
// carry c (shared-memory offset or scratch place[c]) of rank q.  A carry in
// the scratch is at the same offset in rank q's scratch.
__device__ __forceinline__ void carry_table(const cg::cluster_group& cluster,
                                            float** table, float* smem,
                                            float* work, size_t first_rank,
                                            int scratch, const int* place,
                                            int count) {
  const int C = cluster.num_blocks();
  for (int idx = threadIdx.x; idx < count * C; idx += blockDim.x) {
    const int c = idx / C, q = idx % C;
    table[idx] = place[c] >= 0
                     ? cluster.map_shared_rank(smem + place[c], q)
                     : work + (first_rank + q) * scratch + (-place[c] - 1);
  }
}

struct FwdPlace {
  int sig[2], mu[2], fsc, f;
};

template <int D, bool STORES>
__global__ void __launch_bounds__(kMaxThreads)
    ll_blocked_fwd(const float* __restrict__ F_, const float* __restrict__ Q_,
                   const float* __restrict__ X_, float* __restrict__ ll,
                   float* __restrict__ Sig_st, float* __restrict__ MU_st,
                   float* work, int j, int n, int T, FwdPlace place,
                   int scratch, float eps, float log2pi_term) {
  extern __shared__ __align__(16) float smem[];
  const cg::cluster_group cluster = cg::this_cluster();
  const int C = cluster.num_blocks();
  const int rank = cluster.block_rank();
  const int p = blockIdx.x / C;
  const int tid = threadIdx.x;
  const int jj = j * j, jn = j * n;
  int r0, nr;
  row_panel(j, C, rank, r0, nr);
  const float* Fp = F_ + (size_t)p * T * jj;
  const float* Qp = Q_ + (size_t)p * T * jj;
  const float* Xp = X_ + (size_t)p * n * (T + 1) * D;
  float* wk = work + ((size_t)p * C + rank) * scratch;

  // the ranks' copies of Sig[0], Sig[1], MU[0], MU[1]: table[c C + q]
  float** table = reinterpret_cast<float**>(smem);
  float* Kc = smem + kTable;       // (j, D)
  float* Rr = Kc + j * D;          // (D, j)
  float* E = smem + kTable + round4(6 * j * D);  // (D, n)
  float* Sig[2] = {buffer(smem, wk, place.sig[0]),
                   buffer(smem, wk, place.sig[1])};
  float* MU[2] = {buffer(smem, wk, place.mu[0]),
                  buffer(smem, wk, place.mu[1])};
  float* FSc = buffer(smem, wk, place.fsc);  // (nr, j): rows R_r of F Sc
  float* Fs = place.f >= 0 ? smem + place.f : nullptr;
  const int carries[4] = {place.sig[0], place.sig[1], place.mu[0],
                          place.mu[1]};
  carry_table(cluster, table, smem, work, (size_t)p * C, scratch, carries, 4);
  // a carry in device memory is read by the ranks after the cluster barrier
  const bool fence = C > 1 && (place.sig[0] < 0 || place.sig[1] < 0 ||
                               place.mu[0] < 0 || place.mu[1] < 0);

  // Sig_0 = Q_0, MU_0 = [X_0; 0], in every rank
  copy(Sig[0], Qp, jj);
  for (int idx = tid; idx < jn; idx += blockDim.x) {
    const int a = idx / n, i = idx % n;
    MU[0][idx] = a < D ? Xp[(size_t)i * (T + 1) * D + a] : 0.0f;
  }
  float x[D];
  if (tid < n) {
#pragma unroll
    for (int r = 0; r < D; ++r) x[r] = Xp[(size_t)tid * (T + 1) * D + r];
  }
  float quad_acc = 0.0f, ld_acc = 0.0f, quad_c = 0.0f, ld_c = 0.0f;
  // every rank runs, and has its table, before any writes into its memory
  cluster.sync();

  int cur = 0;
  for (int t = 0; t < T; ++t) {
    const float* Ft = Fp + (size_t)t * jj;
    float* Sg = Sig[cur];
    float* Mu = MU[cur];
    if (STORES) {  // each rank its rows
      copy(Sig_st + ((size_t)p * (T + 1) + t) * jj + r0 * j, Sg + r0 * j,
           nr * j);
      copy(MU_st + ((size_t)p * (T + 1) + t) * jn + r0 * n, Mu + r0 * n,
           nr * n);
    }
    if (Fs != nullptr) copy(Fs, Ft, jj);
    const float* Fm = Fs != nullptr ? Fs : Ft;

    // every rank: the score, Kc and the rank-D conditioning
    float Sinv[D * D];
    const float det = top_left_inverse<D>(Sg, j, eps, Sinv);
    if (tid < n) {
      float e[D], se[D];
      const float quad = score<D>(Mu, n, tid, x, Sinv, e, se);
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
    conditioning_factors<D>(Sg, j, Sinv, Kc, Rr, nullptr, nullptr);
    __syncthreads();
    condition<D>(Sg, Mu, j, n, Kc, Rr, E);  // Sg holds Sc, Mu holds MUc
    __syncthreads();
    // rank r: FSc[R_r] = F[R_r] Sc, and MU'[R_r] = F[R_r] MUc into every
    // rank's next MU
    const int nxt = cur ^ 1;
    gemm1(nr, j, j, Fm + r0 * j, j, 1, Sg, j, 1, nullptr, 0, Local{FSc, j});
    gemm1(nr, n, j, Fm + r0 * j, j, 1, Mu, n, 1, nullptr, 0,
          Peers{table + (2 + nxt) * C, C, r0 * n, n});
    __syncthreads();
    // Sig'[R_r] = FSc[R_r] F^T + Q_t[R_r], into every rank's next Sig
    gemm1(nr, j, j, FSc, j, 1, Fm, 1, j, Qp + (size_t)t * jj + r0 * j, j,
          Peers{table + nxt * C, C, r0 * j, j});
    if (fence) __threadfence();
    cluster.sync();
    cur = nxt;
  }

  if (STORES) {
    copy(Sig_st + ((size_t)p * (T + 1) + T) * jj + r0 * j, Sig[cur] + r0 * j,
         nr * j);
    copy(MU_st + ((size_t)p * (T + 1) + T) * jn + r0 * n, MU[cur] + r0 * n,
         nr * n);
  }
  if (rank == 0 && tid < n) {
    float Sinv[D * D], e[D], se[D];
    const float det = top_left_inverse<D>(Sig[cur], j, eps, Sinv);
    const float quad = score<D>(MU[cur], n, tid, x, Sinv, e, se);
    const float total = (((((quad_c + ld_c) + quad) + logf(det)) + quad_acc) +
                         ld_acc) + log2pi_term;
    ll[(size_t)p * n + tid] = -0.5f * total;
  }
}

// K6: reverse-mode recursion of K5 (the equations of
// likelihood_blocked.py:250-273), one cluster per parameter set.  B (j, j)
// and m (j, n) carry the cotangents of (Sig_{t+1}, MU_{t+1}).
//
// Seed: the adjoint of the final score on (Sig_T, MU_T), which also gives the
// data cotangent of x_T.  Then t = T-1..0, recomputing Sinv, E, SE, Kc, Sc
// and MUc from the stores with K5's arithmetic:
//
//   Bs = sym(B);  Qbar_t = Bs;  Fbar_t = 2 (Bs F) Sc + m MUc^T
//   Scrb = (Bs F)^T F;  MUc_bar = F^T m
//   Kcbar = -Scrb Sig[:, :D] + MUc_bar E^T
//   Ebar = KcT MUc_bar - w Sinv E                      [score, t >= 1]
//   Sinvbar = sym(Sig[:D, :] Kcbar - (w/2) E E^T)
//   Sbar = -Sinv Sinvbar Sinv - (sum_i w_i / 2) Sinv
//   B <- Scrb - [KcT Scrb; 0] + [Kcbar Sinv, 0] + [[Sbar, 0], [0, 0]]
//   m <- MUc_bar - [Ebar; 0];  Xbar_t = Ebar
//
// and at t = 0 (Sig_0 = Q_0, MU_0 = [x_0; 0]) the new carries fold into
// Qbar_0 += sym(B) and Xbar_0 += m[:D].  The sums over trials are the
// contractions over n inside the cluster, so Fbar and Qbar (P, T, j, j) are
// written once, in a fixed order, without atomics or per-trial copies.
//
// Rank r of the cluster holds the full carries, F_t and the stored carries,
// computes Bs, the score, Kc, KcT, Sc and MUc redundantly, and the rows R_r
// of Bs F, Fbar_t, Scrb, MUc_bar, Kcbar and Qbar_t.  The three contractions
// over all rows (KcT Scrb, KcT MUc_bar, Sig[:D, :] Kcbar) become partials
// over R_r that each rank writes into every rank's slot r; after the first
// cluster barrier every rank adds the C partials in rank order (no atomics:
// the result does not depend on timing).  Each rank then forms its rows of
// the new B and m in every rank's copy, and the second barrier ends the
// step.  No rank reads the carries after the first barrier, so they need no
// second buffer.
//
// Bound on an H100: operations by the count (five j^3-sized products a
// step), a chain of T steps per set; the stores (j^2 + j n floats a step)
// are read once by each rank.
struct BwdPlace {
  int b, sig, m, mu, bsfr, bsfc, scrb, mucb, f;
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
  const cg::cluster_group cluster = cg::this_cluster();
  const int C = cluster.num_blocks();
  const int rank = cluster.block_rank();
  const int p = blockIdx.x / C;
  const int tid = threadIdx.x;
  const int jj = j * j, jn = j * n;
  int r0, nr;
  row_panel(j, C, rank, r0, nr);
  const float* Fp = F_ + (size_t)p * T * jj;
  const float* Xp = X_ + (size_t)p * n * (T + 1) * D;
  const float* wp = w_ + (size_t)p * n;
  const float* Sp = Sig_st + (size_t)p * (T + 1) * jj;
  const float* Mp = MU_st + (size_t)p * (T + 1) * jn;
  float* Fbp = Fbar_ + (size_t)p * T * jj;
  float* Qbp = Qbar_ + (size_t)p * T * jj;
  float* Xbp = Xbar_ + (size_t)p * n * (T + 1) * D;
  float* wk = work + ((size_t)p * C + rank) * scratch;

  // the ranks' copies of B and m: table[c C + q]
  float** table = reinterpret_cast<float**>(smem);
  float* Kc = smem + kTable;   // (j, D)
  float* KcT = Kc + j * D;     // (D, j)
  float* Rr = KcT + j * D;     // (D, j): Sig[:D, :]
  float* Sd = Rr + j * D;      // (j, D): Sig[:, :D]
  float* Kcb = Sd + j * D;     // (nr, D): Kcbar[R_r]
  float* Rowc = Kcb + j * D;   // (D, j): KcT Scrb
  float* E = smem + kTable + round4(6 * j * D);  // (D, n)
  float* SE = E + D * n;                         // (D, n)
  float* Eb = SE + D * n;  // (D, n): Ebar (SE w in the seed)
  float* Sib = smem + kTable + round4(6 * j * D) + round4(3 * D * n);  // (D, D)
  float* EwE = Sib + 16;   // (D, D): sum_i w_i E E^T
  // rank q's partials of KcT Scrb (D, j), KcT MUc_bar (D, n) and
  // Sig[:D, :] Kcbar (D, D) at slot + q S
  float* slot = Sib + 32;
  const int S = D * j + D * n + D * D;
  float* Bc = buffer(smem, wk, place.b);
  float* Sg = buffer(smem, wk, place.sig);
  float* Mc = buffer(smem, wk, place.m);
  float* Mu = buffer(smem, wk, place.mu);
  float* BsFr = buffer(smem, wk, place.bsfr);  // (nr, j): rows R_r of Bs F
  float* BsFc = buffer(smem, wk, place.bsfc);  // (j, nr): columns R_r
  float* Scrb = buffer(smem, wk, place.scrb);  // (nr, j)
  float* MUcb = buffer(smem, wk, place.mucb);  // (nr, n)
  float* Fs = place.f >= 0 ? smem + place.f : nullptr;
  const int carries[2] = {place.b, place.m};
  carry_table(cluster, table, smem, work, (size_t)p * C, scratch, carries, 2);
  float* const* Bpeer = table;
  float* const* Mpeer = table + C;
  const bool fence = C > 1 && (place.b < 0 || place.m < 0);

  float wsum = 0.0f;
  for (int i = 0; i < n; ++i) wsum = wsum + wp[i];
  const float wi = tid < n ? wp[tid] : 0.0f;

  // seed, in every rank
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
        if (rank == 0) Xbp[((size_t)tid * (T + 1) + T) * D + r] = -(se[r] * wi);
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
  }
  // every rank runs, and has its table, before any writes into its memory
  cluster.sync();

  for (int t = T - 1; t >= 0; --t) {
    const float* Ft = Fp + (size_t)t * jj;
    const float mask = t >= 1 ? 1.0f : 0.0f;
    copy(Sg, Sp + (size_t)t * jj, jj);
    copy(Mu, Mp + (size_t)t * jn, jn);
    if (Fs != nullptr) copy(Fs, Ft, jj);
    const float* Fm = Fs != nullptr ? Fs : Ft;
    __syncthreads();

    // every rank: the forward intermediates, from the stored carry
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
    // rank r: the rows and the columns R_r of Bs F, and Qbar_t[R_r] = Bs
    gemm1(nr, j, j, Bc + r0 * j, j, 1, Fm, j, 1, nullptr, 0, Local{BsFr, j});
    gemm1(j, nr, j, Bc, j, 1, Fm + r0, j, 1, nullptr, 0, Local{BsFc, nr});
    copy(Qbp + (size_t)t * jj + r0 * j, Bc + r0 * j, nr * j);
    __syncthreads();
    // Fbar_t[R_r] = 2 (Bs F)[R_r] Sc + m[R_r] MUc^T
    gemm(nr, j, j, BsFr, j, 1, Sg, j, 1, 2.0f, n, Mc + r0 * n, n, 1, Mu, 1, n,
         nullptr, 0, Local{Fbp + (size_t)t * jj + r0 * j, j});
    // Scrb[R_r] = ((Bs F)[:, R_r])^T F, MUc_bar[R_r] = F[:, R_r]^T m
    gemm1(nr, j, j, BsFc, 1, nr, Fm, j, 1, nullptr, 0, Local{Scrb, j});
    gemm1(nr, n, j, Fm + r0, 1, j, Mc, n, 1, nullptr, 0, Local{MUcb, n});
    __syncthreads();

    // Kcbar[R_r] = -Scrb[R_r] Sig[:, :D] + MUc_bar[R_r] E^T
    for (int idx = tid; idx < nr * D; idx += blockDim.x) {
      const int a = idx / D, r = idx % D;
      float s1 = Scrb[a * j] * Sd[r];
      for (int b = 1; b < j; ++b) s1 = s1 + Scrb[a * j + b] * Sd[b * D + r];
      float s2 = MUcb[a * n] * E[r * n];
      for (int i = 1; i < n; ++i) s2 = s2 + MUcb[a * n + i] * E[r * n + i];
      Kcb[idx] = s2 - s1;
    }
    // the partials over R_r of KcT Scrb and KcT MUc_bar, into every rank
    for (int idx = tid; idx < D * j; idx += blockDim.x) {
      const int r = idx / j, b = idx % j;
      float acc = KcT[r * j + r0] * Scrb[b];
      for (int a = 1; a < nr; ++a)
        acc = acc + KcT[r * j + r0 + a] * Scrb[a * j + b];
      for (int q = 0; q < C; ++q)
        cluster.map_shared_rank(slot, q)[rank * S + idx] = acc;
    }
    for (int idx = tid; idx < D * n; idx += blockDim.x) {
      const int r = idx / n, i = idx % n;
      float acc = KcT[r * j + r0] * MUcb[i];
      for (int a = 1; a < nr; ++a)
        acc = acc + KcT[r * j + r0 + a] * MUcb[a * n + i];
      for (int q = 0; q < C; ++q)
        cluster.map_shared_rank(slot, q)[rank * S + D * j + idx] = acc;
    }
    // sum_i w_i E E^T, in every rank
    if (tid < D * D) {
      const int r = tid / D, s = tid % D;
      float s2 = (E[r * n] * wp[0]) * E[s * n];
      for (int i = 1; i < n; ++i)
        s2 = s2 + (E[r * n + i] * wp[i]) * E[s * n + i];
      EwE[tid] = s2;
    }
    __syncthreads();
    // the partial over R_r of Sig[:D, :] Kcbar, into every rank
    if (tid < D * D) {
      const int r = tid / D, s = tid % D;
      float s1 = Rr[r * j + r0] * Kcb[s];
      for (int b = 1; b < nr; ++b) s1 = s1 + Rr[r * j + r0 + b] * Kcb[b * D + s];
      for (int q = 0; q < C; ++q)
        cluster.map_shared_rank(slot, q)[rank * S + D * j + D * n + tid] = s1;
    }
    cluster.sync();  // barrier 1: every rank's partials have arrived

    // the contractions: the partials added in rank order
    for (int idx = tid; idx < D * j; idx += blockDim.x) {
      float v = slot[idx];
      for (int q = 1; q < C; ++q) v = v + slot[q * S + idx];
      Rowc[idx] = v;
    }
    for (int idx = tid; idx < D * n; idx += blockDim.x) {
      const int i = idx % n;
      float v = slot[D * j + idx];
      for (int q = 1; q < C; ++q) v = v + slot[q * S + D * j + idx];
      Eb[idx] = v - mask * (SE[idx] * wp[i]);
    }
    if (tid < D * D) {
      float v = slot[D * j + D * n + tid];
      for (int q = 1; q < C; ++q) v = v + slot[q * S + D * j + D * n + tid];
      Sib[tid] = v - (mask * 0.5f) * EwE[tid];
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
    // the rows R_r of the new B, into every rank's B
    for (int idx = tid; idx < nr * j; idx += blockDim.x) {
      const int a = idx / j, b = idx % j, ga = r0 + a;
      float v = Scrb[idx];
      if (ga < D) v = v - Rowc[ga * j + b];
      if (b < D) {
        float acc = Kcb[a * D] * Sinv[b];
#pragma unroll
        for (int s = 1; s < D; ++s) acc = acc + Kcb[a * D + s] * Sinv[s * D + b];
        v = v + acc;
        if (ga < D) v = v + Sbar[ga * D + b];
      }
      for (int q = 0; q < C; ++q) Bpeer[q][ga * j + b] = v;
    }
    // the rows R_r of the new m, into every rank's m
    for (int idx = tid; idx < nr * n; idx += blockDim.x) {
      const int a = idx / n, i = idx % n, ga = r0 + a;
      float v = MUcb[idx];
      if (ga < D) v = v - Eb[ga * n + i];
      for (int q = 0; q < C; ++q) Mpeer[q][ga * n + i] = v;
    }
    if (rank == 0) {  // the data cotangent
      for (int idx = tid; idx < D * n; idx += blockDim.x) {
        const int r = idx / n, i = idx % n;
        Xbp[((size_t)i * (T + 1) + t) * D + r] = Eb[idx];
      }
    }
    if (fence) __threadfence();
    cluster.sync();  // barrier 2: every rank holds the new B and m
  }

  // t = 0: Qbar_0 += sym(B) on the rows R_r, and Xbar_0 += m[:D]
  for (int idx = tid; idx < nr * j; idx += blockDim.x) {
    const int a = r0 + idx / j, b = idx % j;
    float* q = Qbp + a * j + b;
    *q = *q + 0.5f * (Bc[a * j + b] + Bc[b * j + a]);
  }
  if (rank == 0) {
    for (int idx = tid; idx < D * n; idx += blockDim.x) {
      const int r = idx / n, i = idx % n;
      float* xb = Xbp + (size_t)i * (T + 1) * D + r;
      *xb = *xb + Mc[idx];
    }
  }
}

// Launch `kernel` as P clusters of C blocks (C = 1: a plain launch) and
// return the first CUDA error of the attribute call or the launch.
template <class... Params, class... Args>
int launch(void (*kernel)(Params...), int P, int C, int threads,
           int smem_bytes, cudaStream_t s, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(P * C);
  config.blockDim = dim3(threads);
  config.dynamicSmemBytes = smem_bytes;
  config.stream = s;
  config.attrs = attr;
  config.numAttrs = C > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&config, kernel, args...);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// How many clusters of C blocks of `kernel` the card runs at once.
template <class... Params>
int max_clusters(void (*kernel)(Params...), int C, int threads,
                 int smem_bytes, int* count) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(C);
  config.blockDim = dim3(threads);
  config.dynamicSmemBytes = smem_bytes;
  config.attrs = attr;
  config.numAttrs = 1;
  return static_cast<int>(
      cudaOccupancyMaxActiveClusters(count, kernel, &config));
}

template <int D>
int launch_fwd(const float* F, const float* Q, const float* X, float* ll,
               float* Sig_st, float* MU_st, float* work, int j, int P, int C,
               int n, int T, int threads, int smem_bytes, int scratch,
               FwdPlace place, float eps, float log2pi_term, cudaStream_t s) {
  if (Sig_st != nullptr)
    return launch(ll_blocked_fwd<D, true>, P, C, threads, smem_bytes, s, F, Q,
                  X, ll, Sig_st, MU_st, work, j, n, T, place, scratch, eps,
                  log2pi_term);
  return launch(ll_blocked_fwd<D, false>, P, C, threads, smem_bytes, s, F, Q,
                X, ll, Sig_st, MU_st, work, j, n, T, place, scratch, eps,
                log2pi_term);
}

bool launch_ok(int j, int d, int P, int C, int n, int T, int threads) {
  return j > 12 && j <= 128 && d >= 1 && d <= 4 && n >= 1 && n <= 128 &&
         P >= 1 && T >= 1 && threads >= n && threads >= 32 &&
         threads <= kMaxThreads && threads % 32 == 0 &&
         (C == 1 || C == 2 || C == 4 || C == 8);
}

}  // namespace

// Both entries return the first CUDA error of the attribute call or the
// launch, or cudaErrorInvalidValue for sizes outside the kernels' scope.  K5
// writes the stores when Sig_st and MU_st are both given (both null: the
// store-free variant).  C is the cluster size, smem_bytes, scratch (floats
// per rank) and the places come from the wrapper's buffer plan for that C.
extern "C" int lqg_ll_blocked_fwd(const float* F, const float* Q,
                                  const float* X, float* ll, float* Sig_st,
                                  float* MU_st, float* work, int j, int d,
                                  int P, int C, int n, int T, int threads,
                                  int smem_bytes, int scratch, int place_sig0,
                                  int place_sig1, int place_mu0,
                                  int place_mu1, int place_fsc, int place_f,
                                  float eps, float log2pi_term, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!launch_ok(j, d, P, C, n, T, threads) ||
      (Sig_st == nullptr) != (MU_st == nullptr))
    return cudaErrorInvalidValue;
  const FwdPlace place = {{place_sig0, place_sig1},
                          {place_mu0, place_mu1},
                          place_fsc,
                          place_f};
  switch (d) {
    case 1:
      return launch_fwd<1>(F, Q, X, ll, Sig_st, MU_st, work, j, P, C, n, T,
                           threads, smem_bytes, scratch, place, eps,
                           log2pi_term, s);
    case 2:
      return launch_fwd<2>(F, Q, X, ll, Sig_st, MU_st, work, j, P, C, n, T,
                           threads, smem_bytes, scratch, place, eps,
                           log2pi_term, s);
    case 3:
      return launch_fwd<3>(F, Q, X, ll, Sig_st, MU_st, work, j, P, C, n, T,
                           threads, smem_bytes, scratch, place, eps,
                           log2pi_term, s);
    default:
      return launch_fwd<4>(F, Q, X, ll, Sig_st, MU_st, work, j, P, C, n, T,
                           threads, smem_bytes, scratch, place, eps,
                           log2pi_term, s);
  }
}

extern "C" int lqg_ll_blocked_bwd(const float* F, const float* X,
                                  const float* w, const float* Sig_st,
                                  const float* MU_st, float* Fbar, float* Qbar,
                                  float* Xbar, float* work, int j, int d,
                                  int P, int C, int n, int T, int threads,
                                  int smem_bytes, int scratch, int place_b,
                                  int place_sig, int place_m, int place_mu,
                                  int place_bsfr, int place_bsfc,
                                  int place_scrb, int place_mucb, int place_f,
                                  float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!launch_ok(j, d, P, C, n, T, threads)) return cudaErrorInvalidValue;
  const BwdPlace place = {place_b,    place_sig,  place_m,
                          place_mu,   place_bsfr, place_bsfc,
                          place_scrb, place_mucb, place_f};
#define LQG_BWD(DD)                                                         \
  launch(ll_blocked_bwd<DD>, P, C, threads, smem_bytes, s, F, X, w, Sig_st, \
         MU_st, Fbar, Qbar, Xbar, work, j, n, T, place, scratch, eps)
  switch (d) {
    case 1:
      return LQG_BWD(1);
    case 2:
      return LQG_BWD(2);
    case 3:
      return LQG_BWD(3);
    default:
      return LQG_BWD(4);
  }
#undef LQG_BWD
}

// How many clusters of C blocks the card runs at once, in *count, for K5
// (kernel 0: store-free, 1: with stores) or K6 (kernel 2) at observed dim d;
// returns the CUDA error of the query.
extern "C" int lqg_ll_blocked_max_clusters(int kernel, int d, int C,
                                           int threads, int smem_bytes,
                                           int* count) {
  if (d < 1 || d > 4 || kernel < 0 || kernel > 2 || C < 1 ||
      C > kMaxCluster)
    return cudaErrorInvalidValue;
#define LQG_QUERY(DD)                                                       \
  (kernel == 0   ? max_clusters(ll_blocked_fwd<DD, false>, C, threads,     \
                                smem_bytes, count)                          \
   : kernel == 1 ? max_clusters(ll_blocked_fwd<DD, true>, C, threads,      \
                                smem_bytes, count)                          \
                 : max_clusters(ll_blocked_bwd<DD>, C, threads, smem_bytes, \
                                count))
  switch (d) {
    case 1:
      return LQG_QUERY(1);
    case 2:
      return LQG_QUERY(2);
    case 3:
      return LQG_QUERY(3);
    default:
      return LQG_QUERY(4);
  }
#undef LQG_QUERY
}
