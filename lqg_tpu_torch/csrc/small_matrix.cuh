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

template <int S>
__device__ __forceinline__ void fill(float* dst, float value) {
#pragma unroll
  for (int i = 0; i < S; ++i) dst[i] = value;
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

// Cofactor expansion on the six distinct entries of a symmetric 3 x 3.
template <>
__device__ __forceinline__ float sym_inv<3>(const float* s, float eps,
                                            float* out) {
  const float a = s[0], b = s[1], c = s[2], e = s[4], f = s[5], i = s[8];
  const float A11 = e * i - f * f;
  const float A12 = c * f - b * i;
  const float A13 = b * f - c * e;
  const float det = a * A11 + b * A12 + c * A13;
  const float inv = 1.0f / (det + eps);
  const float A22 = a * i - c * c;
  const float A23 = b * c - a * f;
  const float A33 = a * e - b * b;
  out[0] = A11 * inv;
  out[1] = A12 * inv;
  out[2] = A13 * inv;
  out[3] = A12 * inv;
  out[4] = A22 * inv;
  out[5] = A23 * inv;
  out[6] = A13 * inv;
  out[7] = A23 * inv;
  out[8] = A33 * inv;
  return det;
}

// Blockwise Schur complement on the 2 x 2 blocks of a symmetric 4 x 4:
// with S = [[A, B], [B^T, C]], Si = (sym(C - B^T A^-1 B))^-1, the inverse is
// [[A^-1 + A^-1 B Si (A^-1 B)^T, -A^-1 B Si], [., Si]] and det = det A det Sc.
template <>
__device__ __forceinline__ float sym_inv<4>(const float* s, float eps,
                                            float* out) {
  const float Ab[4] = {s[0], s[1], s[4], s[5]};
  const float Bb[4] = {s[2], s[3], s[6], s[7]};
  const float Cb[4] = {s[10], s[11], s[14], s[15]};
  float Ai[4], AiB[4], Bt[4], BtAiB[4], Sc[4], Si[4];
  const float detA = sym_inv<2>(Ab, eps, Ai);
  matmul<2, 2, 2>(Ai, Bb, AiB);
  transpose<2, 2>(Bb, Bt);
  matmul<2, 2, 2>(Bt, AiB, BtAiB);
  const float c01 = Cb[1] - BtAiB[1], c10 = Cb[2] - BtAiB[2];
  Sc[0] = Cb[0] - BtAiB[0];
  Sc[1] = 0.5f * (c01 + c10);
  Sc[2] = Sc[1];
  Sc[3] = Cb[3] - BtAiB[3];
  const float detS = sym_inv<2>(Sc, eps, Si);
  float AiBt[4], SiAiBt[4], corr[4], TR[4];
  transpose<2, 2>(AiB, AiBt);
  matmul<2, 2, 2>(Si, AiBt, SiAiBt);
  matmul<2, 2, 2>(AiB, SiAiBt, corr);
  matmul<2, 2, 2>(AiB, Si, TR);
  out[0] = Ai[0] + corr[0];
  out[1] = Ai[1] + corr[1];
  out[4] = Ai[2] + corr[2];
  out[5] = Ai[3] + corr[3];
  out[2] = -TR[0];
  out[3] = -TR[1];
  out[6] = -TR[2];
  out[7] = -TR[3];
  out[8] = -TR[0];
  out[9] = -TR[2];
  out[12] = -TR[1];
  out[13] = -TR[3];
  out[10] = Si[0];
  out[11] = Si[1];
  out[14] = Si[2];
  out[15] = Si[3];
  return detA * detS;
}

}  // namespace lqg
