// Explicitly rounded small-matrix algebra for K1 (csrc/gains.cu), and the
// helpers of its lane-spread block design.
//
// K1 has two designs, one thread per particle and one block per particle
// with a step's entries spread over lanes, and they must give the same
// bits.  Left to itself nvcc contracts a product and a sum into a fused
// multiply-add wherever it sees one, and which pairs it sees depends on how
// the code around them is laid out (which products common-subexpression
// elimination shares, where a negation sits): an entry computed whole in
// one thread and the same entry assembled from operands another lane sent
// differ in the last bit.  So every operation here is a rounding intrinsic
// that the compiler neither contracts nor reorders (__fmul_rn, __fadd_rn,
// __fsub_rn, __fmaf_rn, __frcp_rn), in the order of the plain PyTorch
// version (lqg_tpu_torch/ops/kernels/gains.py:_gains_reference), with each
// product fused exactly where nvcc fused it when the thread design was
// written with small_matrix.cuh's algebra, so that the thread design keeps
// those bits (held against that build on 1,024 random specs an instance):
// - in a sum of products the first product is fused into the addition of
//   the second and each later one into its own addition (dot);
// - a lone product is fused into the sum or difference it feeds (dot_add,
//   sub_dot); x y - z w keeps z w rounded (msub);
// - against a row or column of a 2 x 2 symmetric inverse, whose
//   off-diagonal entry is a negation, the product with the diagonal entry
//   is the fused one (dot_inv);
// - at m = 1 the Riccati carry's L^T G + G^T L is symmetric (gains.cu:
//   inner_sum).
#pragma once

namespace lqg {
namespace rn {

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ float fma(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}

// sum_t a[t sa] b[t sb], t = 0..K-1: (a0 b0 + a1 b1) + a2 b2 + ..., the
// first product fused into the first addition, each later one into its own.
template <int K>
__device__ __forceinline__ float dot(const float* a, int sa, const float* b,
                                     int sb) {
  if (K == 1) return mul(a[0], b[0]);
  float acc = fma(a[0], b[0], mul(a[sa], b[sb]));
#pragma unroll
  for (int t = 2; t < K; ++t) acc = fma(a[t * sa], b[t * sb], acc);
  return acc;
}

// dot<K>(a, sa, b, sb) with b a row or column of a symmetric inverse and
// b[d sb] its diagonal entry: at K = 2 the product with the diagonal entry
// is the fused one (the off-diagonal entry is a negation).
template <int K>
__device__ __forceinline__ float dot_inv(const float* a, int sa,
                                         const float* b, int sb, int d) {
  if (K != 2 || d == 0) return dot<K>(a, sa, b, sb);
  return fma(a[sa], b[sb], mul(a[0], b[0]));
}

// dot<K>(a, sa, b, sb) + c; a lone product fused into the addition.
template <int K>
__device__ __forceinline__ float dot_add(const float* a, int sa,
                                         const float* b, int sb, float c) {
  return K == 1 ? fma(a[0], b[0], c) : add(dot<K>(a, sa, b, sb), c);
}

// c - dot<K>(a, sa, b, sb); a lone product fused into the subtraction.
template <int K>
__device__ __forceinline__ float sub_dot(float c, const float* a, int sa,
                                         const float* b, int sb) {
  return K == 1 ? fma(-a[0], b[0], c) : sub(c, dot<K>(a, sa, b, sb));
}

// x y - z w, z w rounded.
__device__ __forceinline__ float msub(float x, float y, float z, float w) {
  return fma(x, y, -mul(z, w));
}

// out (R, C) = a (R, K) b (K, C), row-major; with TA, a is given as its
// transpose (K, R); with TB, b as its transpose (C, K).
template <int R, int K, int C, bool TA = false, bool TB = false>
__device__ __forceinline__ void matmul(const float* a, const float* b,
                                       float* out) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < C; ++j)
      out[i * C + j] = dot<K>(TA ? a + i : a + i * K, TA ? R : 1,
                              TB ? b + j * K : b + j, TB ? 1 : C);
}

// Closed-form inverse of a symmetric PD matrix with eps on the determinant
// (lqg_tpu/ops/pallas/gains.py:_sym_inv; gains.py:_sym_inv_det), k <= 3.
template <int K>
__device__ __forceinline__ void sym_inv(const float* a, float eps, float* out);

template <>
__device__ __forceinline__ void sym_inv<1>(const float* a, float eps,
                                           float* out) {
  out[0] = __frcp_rn(add(a[0], eps));
}

template <>
__device__ __forceinline__ void sym_inv<2>(const float* a, float eps,
                                           float* out) {
  const float det = msub(a[0], a[3], a[1], a[1]);
  const float inv = __frcp_rn(add(det, eps));
  out[0] = mul(a[3], inv);
  out[1] = mul(-a[1], inv);
  out[2] = out[1];
  out[3] = mul(a[0], inv);
}

// Cofactor expansion on the six distinct entries of a symmetric 3 x 3.
template <>
__device__ __forceinline__ void sym_inv<3>(const float* s, float eps,
                                           float* out) {
  const float a = s[0], b = s[1], c = s[2], e = s[4], f = s[5], i = s[8];
  const float A11 = msub(e, i, f, f);
  const float A12 = msub(c, f, b, i);
  const float A13 = msub(b, f, c, e);
  const float det = fma(c, A13, fma(a, A11, mul(b, A12)));
  const float inv = __frcp_rn(add(det, eps));
  const float A22 = msub(a, i, c, c);
  const float A23 = msub(b, c, a, f);
  const float A33 = msub(a, e, b, b);
  out[0] = mul(A11, inv);
  out[1] = mul(A12, inv);
  out[2] = mul(A13, inv);
  out[3] = out[1];
  out[4] = mul(A22, inv);
  out[5] = mul(A23, inv);
  out[6] = out[2];
  out[7] = out[5];
  out[8] = mul(A33, inv);
}

// x[k] for a lane-dependent k < S, from registers: a chain of selects, so
// that x stays in registers (a run-time index would put it in local
// memory).
template <int S>
__device__ __forceinline__ float pick(const float* x, int k) {
  float v = x[0];
#pragma unroll
  for (int i = 1; i < S; ++i) v = k == i ? x[i] : v;
  return v;
}

// The first S floats of a 16-byte aligned shared tile into registers, as
// float4 loads (the tile is padded to a multiple of four floats).
template <int S>
__device__ __forceinline__ void read_tile(const float* tile, float* x) {
#pragma unroll
  for (int k = 0; k < (S + 3) / 4; ++k) {
    const float4 v = reinterpret_cast<const float4*>(tile)[k];
    const float w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (4 * k + i < S) x[4 * k + i] = w[i];
  }
}

__host__ __device__ constexpr int pad4(int x) { return (x + 3) / 4 * 4; }

// The mask of a warp's first `lanes` lanes.
__host__ __device__ constexpr unsigned lanes_mask(int lanes) {
  return lanes >= 32 ? 0xffffffffu : (1u << lanes) - 1u;
}

}  // namespace rn
}  // namespace lqg
