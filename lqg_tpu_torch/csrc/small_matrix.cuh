// Register-resident small-matrix algebra for one thread.
//
// Matrices are row-major float arrays whose sizes are template constants, so
// after full unrolling every element is a named register.  The order of the
// operations is that of the Pallas tile algebra in
// lqg_tpu/ops/pallas/gains.py (_matmul: acc = a[i,0] b[0,j], then
// acc += a[i,t] b[t,j]) and of the plain PyTorch versions beside the kernels.
#pragma once

namespace lqg {

template <int R, int K, int C>
__device__ __forceinline__ void matmul(const float* a, const float* b,
                                       float* out) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
#pragma unroll
    for (int j = 0; j < C; ++j) {
      float acc = a[i * K] * b[j];
#pragma unroll
      for (int t = 1; t < K; ++t) acc = acc + a[i * K + t] * b[t * C + j];
      out[i * C + j] = acc;
    }
  }
}

template <int R, int C>
__device__ __forceinline__ void transpose(const float* a, float* out) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < C; ++j) out[j * R + i] = a[i * C + j];
}

template <int S>
__device__ __forceinline__ void load(const float* __restrict__ src,
                                     float* dst) {
#pragma unroll
  for (int i = 0; i < S; ++i) dst[i] = src[i];
}

template <int S>
__device__ __forceinline__ void store(float* __restrict__ dst,
                                      const float* src) {
#pragma unroll
  for (int i = 0; i < S; ++i) dst[i] = src[i];
}

// Closed-form inverse of a symmetric PD matrix with eps on the determinant
// (lqg_tpu/ops/pallas/gains.py:_sym_inv); returns the determinant without
// eps (lqg_tpu/ops/pallas/likelihood.py:_sym_inv_det).
template <int K>
__device__ __forceinline__ float sym_inv(const float* a, float eps,
                                         float* out);

template <>
__device__ __forceinline__ float sym_inv<1>(const float* a, float eps,
                                            float* out) {
  out[0] = 1.0f / (a[0] + eps);
  return a[0];
}

template <>
__device__ __forceinline__ float sym_inv<2>(const float* a, float eps,
                                            float* out) {
  const float det = a[0] * a[3] - a[1] * a[1];
  const float inv = 1.0f / (det + eps);
  out[0] = a[3] * inv;
  out[1] = -a[1] * inv;
  out[2] = -a[1] * inv;
  out[3] = a[0] * inv;
  return det;
}

}  // namespace lqg
