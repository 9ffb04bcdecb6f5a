// Shared-memory DFT building blocks for the fused PFB kernels.
//
// One decomposition serves every transform of the port: a length
// n = R * Q DFT (R odd, Q = 2^logq) runs in place on rows held in shared
// memory as
//   1. a direct radix-R DFT over the Q-strided samples of each column q,
//      times the twiddle w_n^(q*kr)   (skipped when R == 1), then
//   2. a radix-2 decimation-in-frequency FFT over each length-Q sub-row.
// Input is in natural order; output bin k lands at
//   dft_rq_pos(k) = (k % R) * Q + bitrev(k / R, logq).
// Every twiddle comes from a host table tab[m * tstride] = w_n^m computed in
// float64 from the exact integer m (no fp32 sinf of a large angle); the sign
// of the transform is the table's.
#pragma once

#include "complex.cuh"

__device__ __forceinline__ int bitrev(int v, int bits) {
  return bits == 0 ? 0 : static_cast<int>(__brev(static_cast<unsigned>(v)) >> (32 - bits));
}

template <int R>
__device__ __forceinline__ int dft_rq_pos(int k, int q, int logq) {
  return (k % R) * q + bitrev(k / R, logq);
}

// In-place DFT of `rows` rows (row i at buf + i*ld) of length n = R*q.
// Called by every thread of the block; returns after a __syncthreads().
template <int R>
__device__ void dft_rq_inplace(float2* buf, int ld, int rows, int q, int logq,
                               const float2* __restrict__ tab, int tstride) {
  const int n = R * q;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  if (R > 1) {
    for (int idx = tid; idx < rows * q; idx += nthr) {
      const int row = idx / q;
      const int col = idx - row * q;
      float2* p = buf + static_cast<long long>(row) * ld + col;
      float2 v[R];
#pragma unroll
      for (int i = 0; i < R; ++i) v[i] = p[i * q];
#pragma unroll
      for (int kr = 0; kr < R; ++kr) {
        float2 acc = v[0];
#pragma unroll
        for (int i = 1; i < R; ++i) {
          acc = c_add(acc, c_mul(v[i], tab[((i * kr) % R) * q * tstride]));
        }
        p[kr * q] = c_mul(acc, tab[((col * kr) % n) * tstride]);
      }
    }
    __syncthreads();
  }
  const int half = q >> 1;
  for (int h = half; h >= 1; h >>= 1) {
    const int wstep = (n / (2 * h)) * tstride;
    for (int idx = tid; idx < rows * R * half; idx += nthr) {
      const int sub = idx / half;
      const int b = idx - sub * half;
      const int row = sub / R;
      const int kr = sub - row * R;
      float2* p = buf + static_cast<long long>(row) * ld + kr * q;
      const int g = b / h;
      const int j = b - g * h;
      const int i0 = g * 2 * h + j;
      const float2 a = p[i0];
      const float2 c = p[i0 + h];
      p[i0] = c_add(a, c);
      p[i0 + h] = c_mul(c_sub(a, c), tab[j * wstep]);
    }
    __syncthreads();
  }
}

// Launch helper: opts in to more than 48 KB of dynamic shared memory when
// needed, launches on the caller's stream, and returns the launch status.
template <typename Kern, typename... Args>
static cudaError_t launch_kernel(Kern kern, dim3 grid, dim3 block, size_t smem,
                                 void* stream, Args... args) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kern<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(args...);
  return cudaGetLastError();
}
