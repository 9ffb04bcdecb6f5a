// Out-of-core Golden-inversion epilogue for SKA-Mid-class block lengths
// (mid: N = 1,835,008 = 3584 * 512), as two kernels that meet in device
// memory.
//
// Replaces the two Pallas kernels of
//   ska_pst_dsp_tpu/ops/pallas/ifft_big.py::fused_big_ifft_oc
//   (kern1 and kern2, launched by its two pallas_calls).
//
// Four-step split N = n2 * n1, frequency f = n1*i2 + i1, time
// t = k2 + n2*k1:
//
//   inner: A[p, b, k2, i1] = sum_i2 X[p, b, n1*i2 + i1] * elem[n1*i2 + i1]
//                                   * exp(+2*pi*i*i2*k2/n2)
//   outer: y[p, b, t - lo] = gain/N * exp(-2*pi*i*roll*t/N)
//                            * sum_i1 A[p, b, k2, i1] * exp(+2*pi*i*i1*k2/N)
//                                     * exp(+2*pi*i*i1*k1/n1),
//          k1 in [lo/n2, (N - lo)/n2)
//
// which equals IFFT(roll(X * elem, -roll))[lo:N-lo] * gain (elem arrives
// pre-rolled by +roll; the roll is the modulation theorem's phase).
//
// What bounds it on the H100: bytes. Per mid block the two kernels move
// 14.7 MB in, 14.7 MB of A out and back, and 7.3 MB of kept samples out
// (51 MB) against ~0.19 Gflop of FFT, ~4 flop per byte, under the fp32
// ridge of ~20.
//
// Design. The low epilogue (ifft_fused.cu) holds 32 columns of n2 points in
// shared memory; at n2 = 3584 that would be 917 KB. Here:
//   inner: a thread block owns kColTile = 4 columns i1 of one block and
//          holds 4 x 3584 points (115 KB, two thread blocks per SM). Each
//          row of X contributes one 32-byte sector per thread block, so X
//          is read once. The n2-point DFT is dft_smem.cuh's radix-7 step
//          (the p = 7 DFT over alpha with its twiddle, i2 = 512*alpha +
//          beta) followed by 512-point radix-2 sub-transforms (the q DFT
//          per gamma), all in shared memory. elem multiplies on the way in.
//   outer: a thread block owns kRowTile = 16 rows k2, multiplies the
//          N-level twiddle on the way in (an (N,) float64-built host table
//          indexed by the exact product i1*k2 mod N), runs the n1-point
//          DFT, and writes only the kept k1 (the overlap discard is never
//          stored) with the roll phase (index roll*t mod N, 64-bit) and
//          gain/N, in time order.
// fp32 SIMT arithmetic throughout.
#include "dft_smem.cuh"

constexpr int kColTile = 4;   // i1 columns per inner thread block
constexpr int kRowTile = 16;  // k2 rows per outer thread block

template <int R>
__global__ void ifft_big_inner_kernel(const float2* __restrict__ X,
                                      const float2* __restrict__ elem,
                                      float2* __restrict__ A,
                                      const float2* __restrict__ tabN,
                                      long long xsp, long long xsb, int n_blocks,
                                      int n, int n2, int n1, int q, int logq) {
  extern __shared__ float2 smem[];
  const int b = blockIdx.x;
  const int c0 = blockIdx.y * kColTile;
  const int p = blockIdx.z;
  const int ld = n2 + 1;
  const float2* xb = X + p * xsp + b * xsb;
  for (int idx = threadIdx.x; idx < n2 * kColTile; idx += blockDim.x) {
    const int i2 = idx / kColTile;
    const int cl = idx - i2 * kColTile;
    const int i1 = c0 + cl;
    float2 v = make_float2(0.f, 0.f);
    if (i1 < n1) {
      const long long f = static_cast<long long>(i2) * n1 + i1;
      v = xb[f];
      if (elem != nullptr) v = c_mul(v, elem[f]);
    }
    smem[cl * ld + i2] = v;
  }
  __syncthreads();

  dft_rq_inplace<R>(smem, ld, kColTile, q, logq, tabN, n / n2);

  float2* ab = A + (static_cast<long long>(p) * n_blocks + b) * n;
  for (int idx = threadIdx.x; idx < n2 * kColTile; idx += blockDim.x) {
    const int k2 = idx / kColTile;
    const int cl = idx - k2 * kColTile;
    const int i1 = c0 + cl;
    if (i1 >= n1) continue;
    ab[static_cast<long long>(k2) * n1 + i1] = smem[cl * ld + dft_rq_pos<R>(k2, q, logq)];
  }
}

template <int R>
__global__ void ifft_big_outer_kernel(const float2* __restrict__ A,
                                      float2* __restrict__ out,
                                      const float2* __restrict__ tabN, int n_blocks,
                                      int n, int n2, int n1, int q, int logq,
                                      int k1_lo, int n1_keep, long long lo,
                                      long long roll, float scale) {
  extern __shared__ float2 smem[];
  const int b = blockIdx.x;
  const int k2_0 = blockIdx.y * kRowTile;
  const int p = blockIdx.z;
  const int ld = n1 + 1;
  const float2* ab = A + (static_cast<long long>(p) * n_blocks + b) * n;
  for (int idx = threadIdx.x; idx < kRowTile * n1; idx += blockDim.x) {
    const int kl = idx / n1;
    const int i1 = idx - kl * n1;
    const int k2 = k2_0 + kl;
    float2 v = make_float2(0.f, 0.f);
    if (k2 < n2) {
      const long long tw = (static_cast<long long>(i1) * k2) % n;
      v = c_mul(ab[static_cast<long long>(k2) * n1 + i1], tabN[tw]);
    }
    smem[kl * ld + i1] = v;
  }
  __syncthreads();

  dft_rq_inplace<R>(smem, ld, kRowTile, q, logq, tabN, n / n1);

  const long long keep = static_cast<long long>(n1_keep) * n2;
  float2* ob = out + (static_cast<long long>(p) * n_blocks + b) * keep;
  for (int idx = threadIdx.x; idx < n1_keep * kRowTile; idx += blockDim.x) {
    const int kk = idx / kRowTile;
    const int kl = idx - kk * kRowTile;
    const int k2 = k2_0 + kl;
    if (k2 >= n2) continue;
    const int k1 = k1_lo + kk;
    const long long t = k2 + static_cast<long long>(n2) * k1;
    float2 w = tabN[(roll * t) % n];
    w.y = -w.y;  // exp(-2*pi*i*roll*t/N)
    const float2 v = c_mul(smem[kl * ld + dft_rq_pos<R>(k1, q, logq)], w);
    ob[t - lo] = c_scale(v, scale);
  }
}

using InnerKern = void (*)(const float2*, const float2*, float2*, const float2*,
                           long long, long long, int, int, int, int, int, int);
using OuterKern = void (*)(const float2*, float2*, const float2*, int, int, int, int,
                           int, int, int, int, long long, long long, float);

static InnerKern pick_inner(int r) {
  switch (r) {
    case 1: return ifft_big_inner_kernel<1>;
    case 3: return ifft_big_inner_kernel<3>;
    case 7: return ifft_big_inner_kernel<7>;
    default: return nullptr;
  }
}

static OuterKern pick_outer(int r) {
  switch (r) {
    case 1: return ifft_big_outer_kernel<1>;
    case 3: return ifft_big_outer_kernel<3>;
    case 7: return ifft_big_outer_kernel<7>;
    default: return nullptr;
  }
}

// X: complex64 with element strides (xsp, xsb) over (pol, block), bins
// contiguous; elem: (n,) complex64 or null; A: (n_pol, n_blocks, n2, n1)
// complex64; tabN: (n,) exp(+2*pi*i*m/n). n2 = r2 * 2^logq2.
extern "C" int ifft_big_inner_launch(const void* X, const void* elem, void* A,
                                     const void* tabN, long long xsp, long long xsb,
                                     int n_pol, int n_blocks, int n, int n2, int r2,
                                     int q2, int logq2, int n1, void* stream) {
  InnerKern inner = pick_inner(r2);
  if (inner == nullptr || n_pol > 65535 || static_cast<long long>(n2) * n1 != n) {
    return cudaErrorInvalidValue;
  }
  const size_t smem = static_cast<size_t>(kColTile) * (n2 + 1) * sizeof(float2);
  const dim3 grid(n_blocks, (n1 + kColTile - 1) / kColTile, n_pol);
  return launch_kernel(inner, grid, dim3(512), smem, stream,
                       static_cast<const float2*>(X), static_cast<const float2*>(elem),
                       static_cast<float2*>(A), static_cast<const float2*>(tabN), xsp,
                       xsb, n_blocks, n, n2, n1, q2, logq2);
}

// A: (n_pol, n_blocks, n2, n1) complex64; out: (n_pol, n_blocks, n - 2*lo)
// complex64; lo = k1_lo * n2; n1 = r1 * 2^logq1; 0 <= roll < n.
extern "C" int ifft_big_outer_launch(const void* A, void* out, const void* tabN,
                                     int n_pol, int n_blocks, int n, int n2, int n1,
                                     int r1, int q1, int logq1, int k1_lo, int n1_keep,
                                     long long lo, long long roll, float scale,
                                     void* stream) {
  OuterKern outer = pick_outer(r1);
  if (outer == nullptr || n_pol > 65535 || static_cast<long long>(n2) * n1 != n) {
    return cudaErrorInvalidValue;
  }
  const size_t smem = static_cast<size_t>(kRowTile) * (n1 + 1) * sizeof(float2);
  const dim3 grid(n_blocks, (n2 + kRowTile - 1) / kRowTile, n_pol);
  return launch_kernel(outer, grid, dim3(256), smem, stream,
                       static_cast<const float2*>(A), static_cast<float2*>(out),
                       static_cast<const float2*>(tabN), n_blocks, n, n2, n1, q1,
                       logq1, k1_lo, n1_keep, lo, roll, scale);
}
