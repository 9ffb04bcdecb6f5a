// Fused channel DFT + derotation constant of the zero-padded (SKA-Mid)
// analysis: the stage between the fold (analysis_padded_fused.cu) and the
// inversion frontend.
//
// Replaces the Pallas kernel of
//   ska_pst_dsp_tpu/ops/pallas/chan_dft_fused.py::chan_dft_ramp
//   (kern, launched by its pallas_call).
//
//   out[p, (k - delay) mod nb, q] = cst[(k + block0) % nu, q]
//                                   * sum_j g[p, k, j] * w^(j*q),
//   w = exp(-2*pi*i/block)
//
// cst carries block * exp(-2*pi*i*q/block) (reverse + block^2 * IFFT of
// the reference as a forward FFT) times the derotation ramp; the
// group-delay roll of the padded analysis is the output row index, so no
// separate pass moves the stream.
//
// What bounds it on the H100: bytes, then shared memory. A 4096-point
// spectrum is ~0.25 Mflop of radix-2 FFT against 32 KB in and 32 KB out,
// ~4 flop per byte, under the fp32 ridge of ~20; its 12 butterfly stages
// each pass the rows through shared memory.
//
// Design: one thread block owns kRows consecutive spectra of one
// polarization. It copies their rows into shared memory with coalesced
// loads (natural order, no transposes: the TPU kernel's k2-major planes and
// the transpose after it are a Mosaic layout rule), runs the block-point
// FFTs there (dft_smem.cuh), and writes each spectrum in channel order
// times its constant row, so a warp stores 32 contiguous channels.
// fp32 SIMT arithmetic throughout.
#include "dft_smem.cuh"

constexpr int kRows = 2;  // spectra per thread block

template <int R>
__global__ void chan_dft_kernel(const float2* __restrict__ g,
                                float2* __restrict__ out,
                                const float2* __restrict__ tab,
                                const float2* __restrict__ cst, int nblocks,
                                int block, int q, int logq, int nu,
                                long long block0, int delay) {
  extern __shared__ float2 smem[];
  const int k0 = blockIdx.x * kRows;
  const int p = blockIdx.y;
  const float2* gp = g + static_cast<long long>(p) * nblocks * block;
  for (int idx = threadIdx.x; idx < kRows * block; idx += blockDim.x) {
    const int r = idx / block;
    const int j = idx - r * block;
    const int k = k0 + r;
    smem[idx] = k < nblocks ? gp[static_cast<long long>(k) * block + j]
                            : make_float2(0.f, 0.f);
  }
  __syncthreads();

  dft_rq_inplace<R>(smem, block, kRows, q, logq, tab, 1);

  float2* op = out + static_cast<long long>(p) * nblocks * block;
  for (int idx = threadIdx.x; idx < kRows * block; idx += blockDim.x) {
    const int r = idx / block;
    const int ch = idx - r * block;
    const int k = k0 + r;
    if (k >= nblocks) continue;
    const int row = static_cast<int>((k + block0) % nu);
    int ko = k - delay;
    if (ko < 0) ko += nblocks;
    const float2 v = smem[r * block + dft_rq_pos<R>(ch, q, logq)];
    op[static_cast<long long>(ko) * block + ch] =
        c_mul(v, cst[static_cast<long long>(row) * block + ch]);
  }
}

using ChanDftKern = void (*)(const float2*, float2*, const float2*, const float2*,
                             int, int, int, int, int, long long, int);

static ChanDftKern pick_radix(int r) {
  switch (r) {
    case 1: return chan_dft_kernel<1>;
    case 3: return chan_dft_kernel<3>;
    case 7: return chan_dft_kernel<7>;
    default: return nullptr;
  }
}

// g, out: (n_pol, nblocks, block) complex64; tab: (block,) w^m;
// cst: (nu, block) complex64. block = r * q, q = 2^logq;
// 0 <= delay < nblocks.
extern "C" int chan_dft_launch(const void* g, void* out, const void* tab,
                               const void* cst, int n_pol, int nblocks, int block,
                               int r, int q, int logq, int nu, long long block0,
                               int delay, void* stream) {
  ChanDftKern kern = pick_radix(r);
  if (kern == nullptr || n_pol > 65535 || delay < 0 || delay >= nblocks) {
    return cudaErrorInvalidValue;
  }
  const size_t smem = static_cast<size_t>(kRows) * block * sizeof(float2);
  const dim3 grid((nblocks + kRows - 1) / kRows, n_pol);
  return launch_kernel(kern, grid, dim3(512), smem, stream,
                       static_cast<const float2*>(g), static_cast<float2*>(out),
                       static_cast<const float2*>(tab), static_cast<const float2*>(cst),
                       nblocks, block, q, logq, nu, block0, delay);
}
