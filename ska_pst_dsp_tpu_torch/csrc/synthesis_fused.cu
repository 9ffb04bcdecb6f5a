// Fused Golden-inversion frontend: overlap-save frame, temporal taper,
// L-point forward DFT, fftshifted passband keep and deripple.
//
// Replaces the Pallas kernel of
//   ska_pst_dsp_tpu/ops/pallas/synthesis_fused.py::polyphase_synthesis_fused
//   (_kernel, launched by the pallas_call in _fused_synthesis).
//
//   out[p, b, c, j] = dr[j] * sum_t taper[t] * x[p, b*keep + t, perm[c]]
//                             * w^(t * ((kpos + j) mod L)),  w = exp(-2*pi*i/L)
//
// i.e. the raw DFT bins (kpos + j) mod L are exactly the fftshifted bins
// [discard, discard + FN_width) of polyphase_synthesis.m:163-251, so the
// fftshift, the keep and the deripple are an output-index selection.
//
// What bounds it on the H100: bytes. Each overlap-save block reads
// L/keep = 1.6 times the stream (low: L = 256, keep = 160) and writes
// FN_width/keep = 1.2 times it; an L-point FFT per channel and block
// (~10 kflop at L = 256) against ~3.5 KB read and written is ~3 flop per
// byte, under the fp32 ridge of ~20.
//
// Design: one thread block owns one overlap-save block b of one
// polarization and a tile of CT channels. It reads the L time rows of that
// tile from the (pol, time, chan) stream, CT consecutive channels per row
// (coalesced; strides are arguments, so a channel-major stream or a
// sample_offset view needs no copy), applies the taper and the combine
// permutation on the way into shared memory, transposed to one row per
// channel (row stride L+1 against bank conflicts), runs the CT L-point
// FFTs in shared memory (dft_smem.cuh) and writes the FN_width kept bins
// per channel, already in assembled spectrum order (pol, block, chan, j).
// Overlapping frames are re-read by neighbouring thread blocks; the L2
// cache absorbs most of that. fp32 SIMT arithmetic throughout.
#include "dft_smem.cuh"

constexpr int kChanTile = 16;

template <int R>
__global__ void synthesis_frontend_kernel(const float2* __restrict__ x,
                                          float2* __restrict__ out,
                                          const float* __restrict__ taper,
                                          const float* __restrict__ dr,
                                          const int* __restrict__ perm,
                                          const float2* __restrict__ tab,
                                          long long sp, long long st, long long sc,
                                          int n_chan, int n_blocks, int L, int q,
                                          int logq, int keep, int kpos, int fnw) {
  extern __shared__ float2 smem[];
  const int b = blockIdx.x;
  const int c0 = blockIdx.y * kChanTile;
  const int p = blockIdx.z;
  const int ld = L + 1;
  const float2* xb = x + p * sp + static_cast<long long>(b) * keep * st;
  for (int idx = threadIdx.x; idx < L * kChanTile; idx += blockDim.x) {
    const int t = idx / kChanTile;
    const int cl = idx - t * kChanTile;
    const int c = c0 + cl;
    float2 v = make_float2(0.f, 0.f);
    if (c < n_chan) v = c_scale(xb[t * st + perm[c] * sc], taper[t]);
    smem[cl * ld + t] = v;
  }
  __syncthreads();

  dft_rq_inplace<R>(smem, ld, kChanTile, q, logq, tab, 1);

  float2* ob = out + (static_cast<long long>(p) * n_blocks + b) * n_chan * fnw;
  for (int idx = threadIdx.x; idx < kChanTile * fnw; idx += blockDim.x) {
    const int cl = idx / fnw;
    const int j = idx - cl * fnw;
    const int c = c0 + cl;
    if (c >= n_chan) continue;
    int k = kpos + j;
    if (k >= L) k -= L;
    const float2 v = smem[cl * ld + dft_rq_pos<R>(k, q, logq)];
    ob[static_cast<long long>(c) * fnw + j] = c_scale(v, dr[j]);
  }
}

using FrontendKern = void (*)(const float2*, float2*, const float*, const float*,
                              const int*, const float2*, long long, long long,
                              long long, int, int, int, int, int, int, int, int);

static FrontendKern pick_radix(int r) {
  switch (r) {
    case 1: return synthesis_frontend_kernel<1>;
    case 3: return synthesis_frontend_kernel<3>;
    default: return nullptr;
  }
}

// x: complex64 stream with element strides (sp, st, sc) over (pol, time,
// chan); out: (n_pol, n_blocks, n_chan, fnw) complex64; taper: (L,) float32;
// dr: (fnw,) float32; perm: (n_chan,) int32; tab: (L,) w^m. L = r * q,
// q = 2^logq; every frame b*keep + [0, L) must lie inside the stream.
extern "C" int synthesis_fused_launch(const void* x, void* out, const void* taper,
                                      const void* dr, const void* perm,
                                      const void* tab, long long sp, long long st,
                                      long long sc, int n_pol, int n_chan,
                                      int n_blocks, int L, int r, int q, int logq,
                                      int keep, int kpos, int fnw, void* stream) {
  FrontendKern kern = pick_radix(r);
  if (kern == nullptr || n_pol > 65535) return cudaErrorInvalidValue;
  const size_t smem = static_cast<size_t>(kChanTile) * (L + 1) * sizeof(float2);
  const dim3 grid(n_blocks, (n_chan + kChanTile - 1) / kChanTile, n_pol);
  return launch_kernel(kern, grid, dim3(256), smem, stream,
                       static_cast<const float2*>(x), static_cast<float2*>(out),
                       static_cast<const float*>(taper), static_cast<const float*>(dr),
                       static_cast<const int*>(perm), static_cast<const float2*>(tab),
                       sp, st, sc, n_chan, n_blocks, L, q, logq, keep, kpos, fnw);
}
