// Fused Golden-inversion epilogue: backward FFT of each assembled block
// with the elementwise taper/filter, the DC-centering roll, the overlap
// discard and the gain folded in.
//
// Replaces the Pallas kernel of
//   ska_pst_dsp_tpu/ops/pallas/ifft_fused.py::fused_big_ifft
//   (kern, launched by its pallas_call).
//
//   y[p, b, t - lo] = gain/N * exp(-2*pi*i*roll*t/N)
//                     * sum_k X[p, b, k] * elem[k] * exp(+2*pi*i*k*t/N),
//   t in [lo, N - lo)
//
// which equals IFFT(roll(X * elem, -roll))[lo:N-lo] * gain (the roll by the
// modulation theorem; elem arrives pre-rolled by +roll).
//
// What bounds it on the H100: bytes. A 49152-point block is ~3.8 Mflop of
// FFT against 384 KiB in and 240 KiB out, ~6 flop per byte, under the
// fp32 ridge of ~20.
//
// Design: the TPU kernel holds a whole 49152-point block (384 KiB in
// complex64) in VMEM; that is more than the 227 KB of shared memory a
// thread block can have, so this port runs the four-step split
// N = n2 * n1 (128 * 384 at low), input k = n1*m2 + m1, output
// t = k2 + n2*k1, as two launches that meet in device memory:
//   inner: for a tile of 32 columns m1, the n2-point DFT over m2 (the
//          strided reads are 32 contiguous bins per row, coalesced), times
//          elem on the way in and the twiddle exp(+2*pi*i*m1*k2/N) on the
//          way out, stored as A[p, b, k2, m1];
//   outer: for a tile of 16 rows k2, the n1-point DFT over m1 (384 =
//          3 * 128: radix 3, then radix 2), keeping only the outputs
//          k1 in [lo/n2, (N-lo)/n2): the overlap discard is never stored.
//          The roll phase and gain/N are applied on the way out, and the
//          kept samples leave in time order.
// Each transform is dft_smem.cuh's shared-memory DFT; every twiddle is one
// host table w_N^m = exp(+2*pi*i*m/N) indexed by exact integer products
// mod N. fp32 SIMT arithmetic throughout.
#include "dft_smem.cuh"

constexpr int kColTile = 32;  // m1 columns per inner thread block
constexpr int kRowTile = 16;  // k2 rows per outer thread block

template <int R>
__global__ void ifft_inner_kernel(const float2* __restrict__ X,
                                  const float2* __restrict__ elem,
                                  float2* __restrict__ A,
                                  const float2* __restrict__ tabN,
                                  long long xsp, long long xsb, int n_valid,
                                  int n, int n2, int n1, int q, int logq) {
  extern __shared__ float2 smem[];
  const int b = blockIdx.x;
  const int m1_0 = blockIdx.y * kColTile;
  const int p = blockIdx.z;
  const int ld = n2 + 1;
  const float2* xb = X + p * xsp + b * xsb;
  for (int idx = threadIdx.x; idx < n2 * kColTile; idx += blockDim.x) {
    const int m2 = idx / kColTile;
    const int ml = idx - m2 * kColTile;
    const int m1 = m1_0 + ml;
    float2 v = make_float2(0.f, 0.f);
    if (m1 < n1) {
      const int k = m2 * n1 + m1;
      v = xb[k];
      if (elem != nullptr) v = c_mul(v, elem[k]);
    }
    smem[ml * ld + m2] = v;
  }
  __syncthreads();

  dft_rq_inplace<R>(smem, ld, kColTile, q, logq, tabN, n / n2);

  float2* ab = A + (static_cast<long long>(p) * n_valid + b) * n;
  for (int idx = threadIdx.x; idx < n2 * kColTile; idx += blockDim.x) {
    const int k2 = idx / kColTile;
    const int ml = idx - k2 * kColTile;
    const int m1 = m1_0 + ml;
    if (m1 >= n1) continue;
    const float2 v = smem[ml * ld + dft_rq_pos<R>(k2, q, logq)];
    const int tw = static_cast<int>((static_cast<long long>(m1) * k2) % n);
    ab[static_cast<long long>(k2) * n1 + m1] = c_mul(v, tabN[tw]);
  }
}

template <int R>
__global__ void ifft_outer_kernel(const float2* __restrict__ A,
                                  float2* __restrict__ out,
                                  const float2* __restrict__ tabN, int n_valid,
                                  int n, int n2, int n1, int q, int logq,
                                  int k1_lo, int n1_keep, int lo, int roll,
                                  float scale) {
  extern __shared__ float2 smem[];
  const int b = blockIdx.x;
  const int k2_0 = blockIdx.y * kRowTile;
  const int p = blockIdx.z;
  const int ld = n1 + 1;
  const float2* ab = A + (static_cast<long long>(p) * n_valid + b) * n;
  for (int idx = threadIdx.x; idx < kRowTile * n1; idx += blockDim.x) {
    const int kl = idx / n1;
    const int m1 = idx - kl * n1;
    const int k2 = k2_0 + kl;
    smem[kl * ld + m1] =
        k2 < n2 ? ab[static_cast<long long>(k2) * n1 + m1] : make_float2(0.f, 0.f);
  }
  __syncthreads();

  dft_rq_inplace<R>(smem, ld, kRowTile, q, logq, tabN, n / n1);

  const long long keep = static_cast<long long>(n1_keep) * n2;
  float2* ob = out + (static_cast<long long>(p) * n_valid + b) * keep;
  for (int idx = threadIdx.x; idx < n1_keep * kRowTile; idx += blockDim.x) {
    const int kk = idx / kRowTile;
    const int kl = idx - kk * kRowTile;
    const int k2 = k2_0 + kl;
    if (k2 >= n2) continue;
    const int k1 = k1_lo + kk;
    const long long t = k2 + static_cast<long long>(n2) * k1;
    float2 w = tabN[static_cast<int>((static_cast<long long>(roll) * t) % n)];
    w.y = -w.y;  // exp(-2*pi*i*roll*t/N)
    const float2 v = c_mul(smem[kl * ld + dft_rq_pos<R>(k1, q, logq)], w);
    ob[t - lo] = c_scale(v, scale);
  }
}

using InnerKern = void (*)(const float2*, const float2*, float2*, const float2*,
                           long long, long long, int, int, int, int, int, int);
using OuterKern = void (*)(const float2*, float2*, const float2*, int, int, int,
                           int, int, int, int, int, int, int, float);

static InnerKern pick_inner(int r) {
  switch (r) {
    case 1: return ifft_inner_kernel<1>;
    case 3: return ifft_inner_kernel<3>;
    default: return nullptr;
  }
}

static OuterKern pick_outer(int r) {
  switch (r) {
    case 1: return ifft_outer_kernel<1>;
    case 3: return ifft_outer_kernel<3>;
    default: return nullptr;
  }
}

// X: complex64 with element strides (xsp, xsb) over (pol, block), bins
// contiguous; elem: (n,) complex64 or null; A: (n_pol, n_valid, n) scratch;
// out: (n_pol, n_valid, n - 2*lo) complex64; tabN: (n,) exp(+2*pi*i*m/n).
// n2 = r2 * 2^logq2, n1 = r1 * 2^logq1; lo = k1_lo * n2.
extern "C" int ifft_fused_launch(const void* X, const void* elem, void* A, void* out,
                                 const void* tabN, long long xsp, long long xsb,
                                 int n_pol, int n_valid, int n, int n2, int r2,
                                 int q2, int logq2, int n1, int r1, int q1,
                                 int logq1, int k1_lo, int n1_keep, int roll,
                                 float scale, void* stream) {
  InnerKern inner = pick_inner(r2);
  OuterKern outer = pick_outer(r1);
  if (inner == nullptr || outer == nullptr || n_pol > 65535) return cudaErrorInvalidValue;
  const float2* tab = static_cast<const float2*>(tabN);
  const size_t smem_in = static_cast<size_t>(kColTile) * (n2 + 1) * sizeof(float2);
  const dim3 grid_in(n_valid, (n1 + kColTile - 1) / kColTile, n_pol);
  cudaError_t e = launch_kernel(inner, grid_in, dim3(256), smem_in, stream,
                                static_cast<const float2*>(X),
                                static_cast<const float2*>(elem),
                                static_cast<float2*>(A), tab, xsp, xsb, n_valid,
                                n, n2, n1, q2, logq2);
  if (e != cudaSuccess) return e;
  const size_t smem_out = static_cast<size_t>(kRowTile) * (n1 + 1) * sizeof(float2);
  const dim3 grid_out(n_valid, (n2 + kRowTile - 1) / kRowTile, n_pol);
  return launch_kernel(outer, grid_out, dim3(256), smem_out, stream,
                       static_cast<const float2*>(A), static_cast<float2*>(out),
                       tab, n_valid, n, n2, n1, q1, logq1, k1_lo, n1_keep,
                       k1_lo * n2, roll, scale);
}
