// Fused Golden-inversion epilogue (SKA-Low): backward FFT of each assembled
// block with the elementwise taper/filter, the DC-centering roll, the
// overlap discard and the gain folded in, one thread-block cluster per
// transform.
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
// FFT against 384 KiB in and 240 KiB out, ~6 flop per byte, under the fp32
// ridge of ~20; the low batch (2 x 272 blocks) must move 348 MB, 0.104 ms at
// 3.35 TB/s. The first version could not hold a block in one thread block
// (384 KiB against 227 KB of shared memory), so it ran the four-step split
// as two launches that met in a scratch of the batch's size in device
// memory (428 MB more traffic), gathered every twiddle from a 49152-entry
// table with a 64-bit % per element and ran 7-8 radix-2 shared-memory
// passes per launch; it took 11x the bound.
//
// Design: the four-step split N = n2 * n1 = 128 * n1 (n1 = 384 at low,
// 128 also instantiated), input k = n1*m2 + m1, output t = k2 + n2*k1, on
// a cluster of four thread blocks whose shared memory together holds the
// block, so the transposition between the steps stays on chip (Hopper's
// distributed shared memory):
//   * block c of the cluster owns the columns m1 in [c*n1/4, (c+1)*n1/4) and
//     the rows k2 in [32c, 32c + 32). One persistent cluster per resident
//     slot (cudaOccupancyMaxActiveClusters) walks over the transforms;
//   * the block's columns of all 128 rows arrive by asynchronous bulk copies
//     (cp.async.bulk, one 768-byte row each at low) on a transaction
//     barrier; the next transform's copies are issued as soon as the column
//     buffer is free, so they are in flight during the row transforms;
//   * the 128-point DFTs over m2 run as 8 * 16: one radix-8 pass of
//     fft_reg.cuh's form in shared memory (times elem on the way in), then
//     the 16-point DFT of each group in registers (dft16), lanes on
//     neighbouring columns (conflict-free). Each output is multiplied by the
//     N-level twiddle w_N^(m1*k2) = tw_a[k2/16][m1] * tw_b[k2%16][m1], two
//     exact float64-built tables whose columns the block stages once, and
//     written straight from registers into the shared memory of the block
//     that owns row k2 (map_shared_rank): the exchange is the transposition;
//   * a split cluster barrier orders the exchange: each block arrives once
//     it has read its receive buffer, and waits for all before writing into
//     the others'; a full cluster barrier then publishes the data;
//   * each block runs the n1-point DFTs of its 32 rows on rows of n1 + 1
//     points (odd: a warp on 32 rows at one offset hits 32 banks): one
//     shared-memory pass in which a thread's 24 points take the radix-3 step
//     and a radix-8 pass in registers, then the 16-point DFTs in registers,
//     whose stores keep only the kept k1, times roll_row[k2] * gain/N *
//     roll_col[k1] (the roll phase w_N^(-roll*t) factored into two exact
//     tables): a warp writes 32 consecutive samples t. The discarded 2*lo
//     samples are never stored;
//   * no scratch in device memory, no index reduced modulo N.
// Shared memory at low: 96 KiB of columns, 96 KiB of rows and 25 KiB of
// tables per block, one block per SM. fp32 SIMT arithmetic throughout.
// Why four blocks of 512 threads: four is the smallest portable cluster
// whose shared memory holds a block; eight blocks (two per SM) and 256
// threads measured no faster on the H100 (PERF.md).
#include <cooperative_groups.h>

#include <cstdint>

#include "bulk_async.cuh"
#include "fft_reg.cuh"

namespace cg = cooperative_groups;

constexpr int kCluster = 4;    // thread blocks per transform (a portable cluster)
constexpr int kThreads = 512;
constexpr int kN2 = 128;       // the column transform, FftRegPlan<7>: radix 8, 8, 2
constexpr int kRows = kN2 / kCluster;  // rows k2 per block
constexpr int kTwA = 8, kTwB = 16;     // k2 = 16*a + b

template <int R1>
struct ClusterPlan {
  static constexpr int N1 = R1 * 128;
  static constexpr int CPC = N1 / kCluster;  // columns m1 per block
  static constexpr int LDR = N1 + 1;         // row stride of the receive buffer
  static constexpr int kCol = kN2 * CPC;
  static constexpr int kRecv = kRows * LDR;
  static constexpr int kTwPass = FftRegPlan<7>::kTw;
  static constexpr int kTwN1 = R1 > 1 ? N1 : 0;
  static constexpr int kTab = (kTwA + kTwB) * CPC;
  static constexpr int kF2 = kCol + kRecv + kTwPass + kTwN1 + kTab + kRows + N1;
  static constexpr size_t kBytes = static_cast<size_t>(kF2) * sizeof(float2) + 16;
};

// The column copies of transform tr into `col`: row m2 of the block's
// columns is CPC contiguous bins. Warp 0 issues them.
template <int R1>
__device__ __forceinline__ void cluster_issue(float2* col, uint64_t* bar, const float2* X,
                                              long long xsp, long long xsb, int n_valid,
                                              int tr, int c0) {
  using P = ClusterPlan<R1>;
  const int lane = threadIdx.x;
  const int pol = tr / n_valid;
  const float2* xb = X + pol * xsp + (tr - pol * n_valid) * xsb + c0;
  if (lane == 0) mbar_expect_tx(bar, P::kCol * sizeof(float2));
  __syncwarp();
  fence_proxy_async();
  for (int m2 = lane; m2 < kN2; m2 += 32) {
    bulk_load(col + m2 * P::CPC, xb + static_cast<long long>(m2) * P::N1,
              P::CPC * sizeof(float2), bar);
  }
}

template <int R1>
__global__ void __launch_bounds__(kThreads, 1)
ifft_cluster_kernel(const float2* __restrict__ X, const float2* __restrict__ elem,
                    float2* __restrict__ out, const float2* __restrict__ tw_pass,
                    const float2* __restrict__ tw_n1, const float2* __restrict__ tw_a,
                    const float2* __restrict__ tw_b, const float2* __restrict__ roll_row,
                    const float2* __restrict__ roll_col, long long xsp, long long xsb,
                    int n_valid, int n_tr, int k1_lo, int n1_keep, float scale) {
  using P = ClusterPlan<R1>;
  constexpr int N1 = P::N1, CPC = P::CPC, LDR = P::LDR;
  extern __shared__ __align__(16) float2 smem[];
  float2* col = smem;             // [m2][CPC]
  float2* recv = col + P::kCol;   // [k2 - r0][LDR]: R1 sub-rows of 128
  float2* tw = recv + P::kRecv;   // per-pass table of the 128-point transform
  float2* twn = tw + P::kTwPass;  // w_n1^m (R1 > 1)
  float2* tab = twn + P::kTwN1;   // [a][c] w_N^(16*a*m1), then [b][c] w_N^(b*m1)
  float2* rrow = tab + P::kTab;   // roll_row[r0 + kl] * gain/N
  float2* rcol = rrow + kRows;    // roll_col[k1]
  uint64_t* bar = reinterpret_cast<uint64_t*>(rcol + N1);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  const int c0 = rank * CPC;
  const int r0 = rank * kRows;
  const int n_cl = gridDim.x / kCluster;
  const long long keep = static_cast<long long>(n1_keep) * kN2;

  for (int i = tid; i < P::kTwPass; i += kThreads) tw[i] = tw_pass[i];
  if constexpr (R1 > 1) {
    for (int i = tid; i < N1; i += kThreads) twn[i] = tw_n1[i];
  }
  for (int i = tid; i < P::kTab; i += kThreads) {
    const int row = i / CPC;
    const int c = i - row * CPC;
    tab[i] = row < kTwA ? tw_a[row * N1 + c0 + c] : tw_b[(row - kTwA) * N1 + c0 + c];
  }
  for (int i = tid; i < kRows; i += kThreads) rrow[i] = c_scale(roll_row[r0 + i], scale);
  for (int i = tid; i < N1; i += kThreads) rcol[i] = roll_col[i];
  if (tid == 0) {
    mbar_init(bar, 1);
    fence_mbar_init();
  }
  __syncthreads();

  int tr = blockIdx.x / kCluster;
  if (tr < n_tr && tid < 32) cluster_issue<R1>(col, bar, X, xsp, xsb, n_valid, tr, c0);
  cluster_arrive();  // this block's receive buffer is free
  for (int it = 0; tr < n_tr; tr += n_cl, ++it) {
    mbar_wait(bar, it & 1);

    // columns, 128 = 8 * 16: the radix-8 pass of span 16 (times elem on the
    // way in); lanes on neighbouring columns
    for (int item = tid; item < CPC * 16; item += kThreads) {
      const int c = item % CPC;
      const int j = item / CPC;
      float2 v[8];
#pragma unroll
      for (int m = 0; m < 8; ++m) v[m] = col[(j + 16 * m) * CPC + c];
      if (elem != nullptr) {
#pragma unroll
        for (int m = 0; m < 8; ++m) {
          v[m] = c_mul(v[m], __ldg(elem + (j + 16 * m) * N1 + c0 + c));
        }
      }
      dft_reg<8, 1>(v);
      if (j != 0) {
#pragma unroll
        for (int d = 1; d < 8; ++d) v[d] = c_mul(v[d], tw[(d - 1) * 16 + j]);
      }
#pragma unroll
      for (int d = 0; d < 8; ++d) col[(j + 16 * d) * CPC + c] = v[d];
    }
    __syncthreads();

    // then the 16-point DFT of each group d in registers: outputs
    // k2 = d + 8*k, times the N-level twiddle, into row k2 of the block that
    // owns it
    cluster_wait();  // every block has read its receive buffer
    for (int item = tid; item < CPC * 8; item += kThreads) {
      const int c = item % CPC;
      const int d = item / CPC;
      float2 v[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) v[j] = col[(16 * d + j) * CPC + c];
      dft16<1>(v);
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const int k2 = d + 8 * k;
        const float2 w = c_mul(tab[(k2 >> 4) * CPC + c], tab[(kTwA + (k2 & 15)) * CPC + c]);
        float2* dst = cluster.map_shared_rank(recv, k2 / kRows);
        dst[(k2 % kRows) * LDR + c0 + c] = c_mul(v[k], w);
      }
    }
    __syncthreads();  // the column buffer is free: the next transform's copies
    if (tr + n_cl < n_tr && tid < 32) {
      cluster_issue<R1>(col, bar, X, xsp, xsb, n_valid, tr + n_cl, c0);
    }
    cluster_arrive();
    cluster_wait();  // every block's rows are complete

    // rows, n1 = R1 * 8 * 16 with m1 = j + 16*m + 128*alpha: the thread of
    // (row, j) loads its R1 * 8 points, runs the radix-R1 DFTs over alpha,
    // times w_n1^((j + 16*m)*kr), and the radix-8 DFTs over m, times
    // w_128^(j*d), into sub-row kr at j + 16*d; lanes on the rows
    for (int item = tid; item < kRows * 16; item += kThreads) {
      const int kl = item % kRows;
      const int j = item / kRows;
      float2* p = recv + kl * LDR + j;
      float2 u[R1][8];
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        float2 t[R1];
#pragma unroll
        for (int a = 0; a < R1; ++a) t[a] = p[16 * m + 128 * a];
        if constexpr (R1 > 1) {
          dft_radix<R1, 1>(t);
#pragma unroll
          for (int kr = 1; kr < R1; ++kr) t[kr] = c_mul(t[kr], twn[(j + 16 * m) * kr]);
        }
#pragma unroll
        for (int kr = 0; kr < R1; ++kr) u[kr][m] = t[kr];
      }
#pragma unroll
      for (int kr = 0; kr < R1; ++kr) {
        dft_reg<8, 1>(u[kr]);
        if (j != 0) {
#pragma unroll
          for (int d = 1; d < 8; ++d) u[kr][d] = c_mul(u[kr][d], tw[(d - 1) * 16 + j]);
        }
#pragma unroll
        for (int d = 0; d < 8; ++d) p[128 * kr + 16 * d] = u[kr][d];
      }
    }
    __syncthreads();

    // the 16-point DFT of each group (kr, d) in registers: outputs
    // k1 = kr + R1*(d + 8*k); only the kept ones, in time order
    // t - lo = k2 + 128*(k1 - k1_lo)
    float2* ob = out + static_cast<long long>(tr) * keep + r0;
    for (int item = tid; item < kRows * R1 * 8; item += kThreads) {
      const int kl = item % kRows;
      const int g = item / kRows;
      const int kr = g % R1;
      const int d = g / R1;
      const float2* p = recv + kl * LDR + kr * 128 + 16 * d;
      float2 v[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) v[j] = p[j];
      dft16<1>(v);
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const int k1 = kr + R1 * (d + 8 * k);
        const int kk = k1 - k1_lo;
        if (static_cast<unsigned>(kk) < static_cast<unsigned>(n1_keep)) {
          ob[kl + static_cast<long long>(kN2) * kk] = c_mul(v[k], c_mul(rrow[kl], rcol[k1]));
        }
      }
    }
    cluster_arrive();  // this block's receive buffer has been read
  }
  cluster_wait();
}

using ClusterKern = void (*)(const float2*, const float2*, float2*, const float2*,
                             const float2*, const float2*, const float2*, const float2*,
                             const float2*, long long, long long, int, int, int, int, float);

// The launch configuration of `kern`: its shared-memory allowance set, and
// how many of its clusters are resident on the current card at once. Both
// queries cost tens of microseconds, so each (kernel, device) is prepared
// once; a lock keeps the table whole when host threads launch together.
static cudaError_t prepare_cluster(const void* kern, size_t smem, int* clusters) {
  struct Prepared {
    const void* kern;
    int dev, clusters;
  };
  static std::mutex mu;
  static Prepared done[16];
  static int n_done = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < n_done; ++i) {
    if (done[i].kern == kern && done[i].dev == dev) {
      *clusters = done[i].clusters;
      return cudaSuccess;
    }
  }
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (e == cudaSuccess) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  }
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster * 1024);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kCluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  e = cudaOccupancyMaxActiveClusters(clusters, kern, &cfg);
  if (e != cudaSuccess) return e;
  if (*clusters <= 0) return cudaErrorInvalidConfiguration;  // the card refuses the cluster
  if (n_done < 16) done[n_done++] = {kern, dev, *clusters};
  return cudaSuccess;
}

template <int R1>
static cudaError_t launch_cluster(const float2* X, const float2* elem, float2* out,
                                  const float2* tw_pass, const float2* tw_n1,
                                  const float2* tw_a, const float2* tw_b,
                                  const float2* roll_row, const float2* roll_col,
                                  long long xsp, long long xsb, int n_valid, int n_tr,
                                  int k1_lo, int n1_keep, float scale, cudaStream_t stream) {
  const ClusterKern kern = ifft_cluster_kernel<R1>;
  constexpr size_t smem = ClusterPlan<R1>::kBytes;
  int clusters = 0;
  cudaError_t e = prepare_cluster(reinterpret_cast<const void*>(kern), smem, &clusters);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster * (n_tr < clusters ? n_tr : clusters));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kCluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kern, X, elem, out, tw_pass, tw_n1, tw_a, tw_b, roll_row,
                         roll_col, xsp, xsb, n_valid, n_tr, k1_lo, n1_keep, scale);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// Clusters of the n1-point kernel resident on the current card at once
// (the persistent grid's size), or an error where the card refuses it.
extern "C" int ifft_fused_clusters(int n1, int* clusters) {
  if (n1 == 384) {
    return prepare_cluster(reinterpret_cast<const void*>(ifft_cluster_kernel<3>),
                           ClusterPlan<3>::kBytes, clusters);
  }
  if (n1 == 128) {
    return prepare_cluster(reinterpret_cast<const void*>(ifft_cluster_kernel<1>),
                           ClusterPlan<1>::kBytes, clusters);
  }
  return cudaErrorInvalidValue;
}

// X: complex64 with element strides (xsp, xsb) over (pol, block), bins
// contiguous, 16-byte aligned with even strides; elem: (n,) complex64 or
// null; out: (n_pol, n_valid, n1_keep * 128) complex64, the kept
// k1 in [k1_lo, k1_lo + n1_keep); tw_pass: the per-pass table of the
// 128-point backward transform (fft_reg_pass_tw); tw_n1: (n1,)
// exp(+2*pi*i*m/n1); tw_a, tw_b: (8, n1), (16, n1) exp(+2*pi*i*16*a*m1/N),
// exp(+2*pi*i*b*m1/N); roll_row, roll_col: (128,), (n1,)
// exp(-2*pi*i*roll*k2/N), exp(-2*pi*i*roll*128*k1/N). n2 = 128, n1 in
// {128, 384}. One persistent cluster of four blocks per resident slot.
extern "C" int ifft_fused_launch(const void* X, const void* elem, void* out,
                                 const void* tw_pass, const void* tw_n1, const void* tw_a,
                                 const void* tw_b, const void* roll_row,
                                 const void* roll_col, long long xsp, long long xsb,
                                 int n_pol, int n_valid, int n2, int n1, int k1_lo,
                                 int n1_keep, float scale, void* stream) {
  const long long n_tr = static_cast<long long>(n_pol) * n_valid;
  if (n2 != kN2 || n_pol <= 0 || n_valid <= 0 || n_tr > (1LL << 30) || k1_lo < 0 ||
      n1_keep <= 0 || k1_lo + n1_keep > n1 || xsp % 2 || xsb % 2 ||
      reinterpret_cast<uintptr_t>(X) % 16) {
    return cudaErrorInvalidValue;
  }
  const auto* x = static_cast<const float2*>(X);
  const auto* e = static_cast<const float2*>(elem);
  auto* o = static_cast<float2*>(out);
  const auto* tp = static_cast<const float2*>(tw_pass);
  const auto* tn = static_cast<const float2*>(tw_n1);
  const auto* ta = static_cast<const float2*>(tw_a);
  const auto* tb = static_cast<const float2*>(tw_b);
  const auto* rr = static_cast<const float2*>(roll_row);
  const auto* rc = static_cast<const float2*>(roll_col);
  const auto s = static_cast<cudaStream_t>(stream);
  const int nt = static_cast<int>(n_tr);
  if (n1 == 384) {
    return launch_cluster<3>(x, e, o, tp, tn, ta, tb, rr, rc, xsp, xsb, n_valid, nt, k1_lo,
                             n1_keep, scale, s);
  }
  if (n1 == 128) {
    return launch_cluster<1>(x, e, o, tp, tn, ta, tb, rr, rc, xsp, xsb, n_valid, nt, k1_lo,
                             n1_keep, scale, s);
  }
  return cudaErrorInvalidValue;
}
