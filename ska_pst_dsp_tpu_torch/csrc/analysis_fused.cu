// Fused single-stage analysis PFB (SKA-Low): fold + DFT + derotation ramp.
//
// Replaces the Pallas kernel of
//   ska_pst_dsp_tpu/ops/pallas/analysis_fused.py::polyphase_analysis_fused
//   (_kernel, launched by the pallas_call in _fused_call).
//
//   out[p, k, c] = block * ramp[(k + block0) % period, c]
//                  * sum_j fold[k, j] * w^(j*c),   w = exp(-2*pi*i/block)
//   fold[k, j]   = sum_m f2d[m, j] * x[p, k*step + m*block + j]
//
// What bounds it on the H100: bytes. At the low geometry a spectrum costs
// ~25 kflop (13-phase fold, 256-point FFT, ramp) against ~4 KB of input and
// output, ~6 flop per device-memory byte, under the fp32 ridge of ~20
// (67 TFLOP/s over 3.35 TB/s). Each input sample feeds
// ceil(phases*block/step) (~17) frames, so the fold must not read frames
// from device memory; past that, the fold's shared-memory loads
// (phases*K per thread) are the next limit.
//
// Design: one thread block owns K consecutive spectra of one polarization.
// It stages the contiguous input span those spectra touch,
// (K-1)*step + phases*block samples (74 KB for K = 32 at low), in shared
// memory with coalesced loads, so device memory sees each sample about
// span/(K*step) = 1.5 times. Thread j folds column j of all K spectra into
// registers, the span's storage is then reused for the K folded rows, and
// the K block-point FFTs run in shared memory (dft_smem.cuh). The ramp
// multiply and the block gain are applied on the way out, written
// time-major (pol, spectrum, channel) so a warp stores contiguous bytes.
// fp32 SIMT arithmetic throughout; no tensor cores (bf16 and TF32 both
// miss the -60 dB purity floor).
#include "dft_smem.cuh"

constexpr int K = 32;  // consecutive spectra per thread block

template <int R>
__global__ void analysis_fused_kernel(const float2* __restrict__ x,
                                      float2* __restrict__ out,
                                      const float* __restrict__ f2d,
                                      const float2* __restrict__ tab,
                                      const float2* __restrict__ ramp,
                                      long long n_dat, int nblocks, int block,
                                      int q, int logq, int step, int phases,
                                      int period, long long block0) {
  extern __shared__ float2 smem[];
  const int p = blockIdx.y;
  const long long k0 = static_cast<long long>(blockIdx.x) * K;
  const int span = (K - 1) * step + phases * block;
  const float2* xp = x + static_cast<long long>(p) * n_dat;
  const long long s0 = k0 * step;
  for (int i = threadIdx.x; i < span; i += blockDim.x) {
    const long long s = s0 + i;
    smem[i] = s < n_dat ? xp[s] : make_float2(0.f, 0.f);
  }
  __syncthreads();

  const int j = threadIdx.x;  // blockDim.x == block
  float2 acc[K];
#pragma unroll
  for (int k = 0; k < K; ++k) acc[k] = make_float2(0.f, 0.f);
  for (int m = 0; m < phases; ++m) {
    const float f = f2d[m * block + j];
    const float2* src = smem + m * block + j;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float2 v = src[k * step];
      acc[k].x = fmaf(f, v.x, acc[k].x);
      acc[k].y = fmaf(f, v.y, acc[k].y);
    }
  }
  __syncthreads();  // the span is dead: its storage takes the folded rows
#pragma unroll
  for (int k = 0; k < K; ++k) smem[k * block + j] = acc[k];
  __syncthreads();

  dft_rq_inplace<R>(smem, block, K, q, logq, tab, 1);

  const int pos = dft_rq_pos<R>(j, q, logq);
  const float gain = static_cast<float>(block);
  for (int k = 0; k < K; ++k) {
    const long long kabs = k0 + k;
    if (kabs >= nblocks) break;
    const int row = static_cast<int>((kabs + block0) % period);
    const float2 v = c_mul(smem[k * block + pos], ramp[row * block + j]);
    out[(static_cast<long long>(p) * nblocks + kabs) * block + j] = c_scale(v, gain);
  }
}

using AnalysisKern = void (*)(const float2*, float2*, const float*, const float2*,
                              const float2*, long long, int, int, int, int, int,
                              int, int, long long);

static AnalysisKern pick_radix(int r) {
  switch (r) {
    case 1: return analysis_fused_kernel<1>;
    case 3: return analysis_fused_kernel<3>;
    default: return nullptr;
  }
}

// x: (n_pol, n_dat) complex64; out: (n_pol, nblocks, block) complex64;
// f2d: (phases, block) float32; tab: (block,) w^m; ramp: (period, block).
// block = r * q with q = 2^logq.
extern "C" int analysis_fused_launch(const void* x, void* out, const void* f2d,
                                     const void* tab, const void* ramp,
                                     int n_pol, long long n_dat, int nblocks,
                                     int block, int r, int q, int logq, int step,
                                     int phases, int period, long long block0,
                                     void* stream) {
  AnalysisKern kern = pick_radix(r);
  if (kern == nullptr || block > 1024 || n_pol > 65535) return cudaErrorInvalidValue;
  const long long span = static_cast<long long>(K - 1) * step +
                         static_cast<long long>(phases) * block;
  const long long rows = static_cast<long long>(K) * block;
  const size_t smem = static_cast<size_t>(span > rows ? span : rows) * sizeof(float2);
  const dim3 grid((nblocks + K - 1) / K, n_pol);
  return launch_kernel(kern, grid, dim3(block), smem, stream,
                       static_cast<const float2*>(x), static_cast<float2*>(out),
                       static_cast<const float*>(f2d), static_cast<const float2*>(tab),
                       static_cast<const float2*>(ramp), n_dat, nblocks, block, q,
                       logq, step, phases, period, block0);
}
