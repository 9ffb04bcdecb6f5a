// Fused zero-padded (SKA-Mid) analysis fold, no reversal.
//
// Replaces the Pallas kernel of
//   ska_pst_dsp_tpu/ops/pallas/analysis_padded_fused.py::polyphase_analysis_padded_fused
//   (_kernel, launched by the pallas_call in _fold_call).
//
//   g[p, k, j] = sum_m f_rev[m, j] * x[p, k*step - fl + m*block + j],
//   fl = phases*block, x = 0 outside [0, n_dat)
//
// The reversal and block^2 * IFFT of the reference become a forward FFT
// times a per-bin constant in the next kernel (chan_dft_fused.cu), so this
// kernel stores the true, unreversed fold rows.
//
// What bounds it on the H100: bytes. At mid a spectrum is 25 phases x
// 4096 real-by-complex products (~0.4 Mflop) against ~29 KB of new input
// and 32 KB of output, ~7 flop per byte, under the fp32 ridge of ~20.
// Each input sample feeds phases*block/step (~29) spectra, so the fold must
// not re-read frames from device memory.
//
// Design: a span of (K-1)*step + fl samples (1.7 MB at mid for K = 32)
// does not fit in shared memory, but every fold term sits on a W-wide row
// grid. With W = gcd(step, block), D = block/W, S = step/W and
// j = d*W + c, the term x[k*step - fl + m*block + j] is row S*k + D*m + d
// (less D*phases), column c, of the stream viewed as W-wide rows. A thread
// block owns K consecutive spectra and C columns c of one polarization and
// stages only S*(K-1) + D*phases rows x C columns (417 x 32 x 8 B =
// 107 KB at mid), loading rows before the stream start or past its end as
// zeros (no padded copy of the input). Each staged value feeds about
// phases*K*D/(S*(K-1) + D*phases) (~15) terms. Thread (d, c) keeps K
// complex accumulators in registers, reads each filter tap once and stores
// its K outputs time-major (pol, spectrum, channel): a warp writes 32
// contiguous channels. fp32 SIMT arithmetic throughout.
#include "dft_smem.cuh"

constexpr int kSpec = 32;  // consecutive spectra per thread block (K)
constexpr int kCols = 32;  // W-row columns per thread block (C)

__global__ void padded_fold_kernel(const float2* __restrict__ x,
                                   float2* __restrict__ g,
                                   const float* __restrict__ f2d,
                                   long long n_dat, int nblocks, int block, int w,
                                   int d_rows, int s_rows, int phases) {
  extern __shared__ float2 smem[];
  const int k0 = blockIdx.x * kSpec;
  const int c0 = blockIdx.y * kCols;
  const int p = blockIdx.z;
  const int rows = s_rows * (kSpec - 1) + d_rows * phases;
  const float2* xp = x + static_cast<long long>(p) * n_dat;
  // staged row i is stream row r0 + i; rows before the start are zeros
  const long long r0 = static_cast<long long>(s_rows) * k0 -
                       static_cast<long long>(d_rows) * phases;
  for (int idx = threadIdx.x; idx < rows * kCols; idx += blockDim.x) {
    const int i = idx / kCols;
    const int c = idx - i * kCols;
    const long long s = (r0 + i) * w + c0 + c;
    smem[idx] = (s >= 0 && s < n_dat) ? xp[s] : make_float2(0.f, 0.f);
  }
  __syncthreads();

  const int c = threadIdx.x % kCols;
  const int nd = blockDim.x / kCols;
  for (int d = threadIdx.x / kCols; d < d_rows; d += nd) {
    const int j = d * w + c0 + c;
    float2 acc[kSpec];
#pragma unroll
    for (int k = 0; k < kSpec; ++k) acc[k] = make_float2(0.f, 0.f);
    for (int m = 0; m < phases; ++m) {
      const float f = f2d[m * block + j];
      const float2* src = smem + (d_rows * m + d) * kCols + c;
#pragma unroll
      for (int k = 0; k < kSpec; ++k) {
        const float2 v = src[k * s_rows * kCols];
        acc[k].x = fmaf(f, v.x, acc[k].x);
        acc[k].y = fmaf(f, v.y, acc[k].y);
      }
    }
#pragma unroll
    for (int k = 0; k < kSpec; ++k) {
      if (k0 + k < nblocks) {
        g[(static_cast<long long>(p) * nblocks + k0 + k) * block + j] = acc[k];
      }
    }
  }
}

// x: (n_pol, n_dat) complex64; g: (n_pol, nblocks, block) complex64;
// f2d: (phases, block) float32, the reversed filter. block = d_rows * w,
// step = s_rows * w, w a multiple of kCols.
extern "C" int padded_fold_launch(const void* x, void* g, const void* f2d, int n_pol,
                                  long long n_dat, int nblocks, int block, int w,
                                  int d_rows, int s_rows, int phases, void* stream) {
  if (w % kCols || n_pol > 65535 || d_rows * w != block) return cudaErrorInvalidValue;
  const size_t rows = static_cast<size_t>(s_rows) * (kSpec - 1) +
                      static_cast<size_t>(d_rows) * phases;
  const size_t smem = rows * kCols * sizeof(float2);
  const int threads = kCols * (d_rows < 8 ? d_rows : 8);
  const dim3 grid((nblocks + kSpec - 1) / kSpec, w / kCols, n_pol);
  return launch_kernel(padded_fold_kernel, grid, dim3(threads), smem, stream,
                       static_cast<const float2*>(x), static_cast<float2*>(g),
                       static_cast<const float*>(f2d), n_dat, nblocks, block, w,
                       d_rows, s_rows, phases);
}
