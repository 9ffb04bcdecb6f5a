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
// Design: the four-step split N = n2 * n1 = 128 * n1 (n1 = 384 at low;
// 128, 192 and 448 also instantiated), input k = n1*m2 + m1, output
// t = k2 + n2*k1, on a cluster of four thread blocks whose shared memory
// together holds the block, so the transposition between the steps stays on
// chip (Hopper's distributed shared memory). What follows is the low
// instantiation; the others differ in the sizes only (ClusterPlan):
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
//
// The row transform is n1 = R1 * Q1 with Q1 = 8 * G, G = 16 (Q1 = 128) or
// 8 (Q1 = 64: n1 = 192 = 3 * 64 and 448 = 7 * 64). For R1 > 3 a thread's
// R1 * 8 points do not fit in its registers, so it runs the radix-R1 step
// and the radix-8 pass one after the other through its own shared-memory
// points. A 448-point block (57344 points, 448 KiB, twice over for columns
// and rows) does not fit in four blocks' shared memory and runs on a cluster
// of eight, the largest portable one, each block owning 16 rows.
#include <cooperative_groups.h>

#include <cstdint>

#include "bulk_async.cuh"
#include "fft_reg.cuh"

namespace cg = cooperative_groups;

constexpr int kThreads = 512;
constexpr int kN2 = 128;       // the column transform, FftRegPlan<7>: radix 8, 8, 2
constexpr int kTwA = 8, kTwB = 16;     // k2 = 16*a + b

// n1 = R1 * Q1 on a cluster of CL thread blocks (a portable cluster: CL <= 8)
template <int R1, int Q1, int CL>
struct ClusterPlan {
  static_assert((Q1 == 64 || Q1 == 128) && (CL == 4 || CL == 8), "cluster epilogue: sizes");
  static constexpr int N1 = R1 * Q1;
  static constexpr int G = Q1 / 8;           // the row transform's last DFT, in registers
  static constexpr int kRows = kN2 / CL;     // rows k2 per block
  static constexpr int CPC = N1 / CL;        // columns m1 per block
  static_assert(CPC * CL == N1 && CPC % 2 == 0, "cluster epilogue: 16-byte column rows");
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
template <class P>
__device__ __forceinline__ void cluster_issue(float2* col, uint64_t* bar, const float2* X,
                                              long long xsp, long long xsb, int n_valid,
                                              int tr, int c0) {
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

template <int R1, int Q1, int CL>
__global__ void __launch_bounds__(kThreads, 1)
ifft_cluster_kernel(const float2* __restrict__ X, const float2* __restrict__ elem,
                    float2* __restrict__ out, const float2* __restrict__ tw_pass,
                    const float2* __restrict__ tw_n1, const float2* __restrict__ tw_a,
                    const float2* __restrict__ tw_b, const float2* __restrict__ roll_row,
                    const float2* __restrict__ roll_col, long long xsp, long long xsb,
                    int n_valid, int n_tr, int k1_lo, int n1_keep, float scale) {
  using P = ClusterPlan<R1, Q1, CL>;
  constexpr int N1 = P::N1, CPC = P::CPC, LDR = P::LDR, G = P::G, kRows = P::kRows;
  constexpr int TS = 16 / G;  // w_Q1^(j*d) = w_128^(TS*j*d) = tw[(d - 1)*16 + TS*j]
  extern __shared__ __align__(16) float2 smem[];
  float2* col = smem;             // [m2][CPC]
  float2* recv = col + P::kCol;   // [k2 - r0][LDR]: R1 sub-rows of Q1
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
  const int n_cl = gridDim.x / CL;
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

  int tr = blockIdx.x / CL;
  if (tr < n_tr && tid < 32) cluster_issue<P>(col, bar, X, xsp, xsb, n_valid, tr, c0);
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
      cluster_issue<P>(col, bar, X, xsp, xsb, n_valid, tr + n_cl, c0);
    }
    cluster_arrive();
    cluster_wait();  // every block's rows are complete

    // rows, n1 = R1 * 8 * G with m1 = j + G*m + Q1*alpha: the thread of
    // (row, j) takes its R1 * 8 points through the radix-R1 DFTs over alpha,
    // times w_n1^((j + G*m)*kr), and the radix-8 DFTs over m, times
    // w_Q1^(j*d), into sub-row kr at j + G*d; lanes on the rows
    for (int item = tid; item < kRows * G; item += kThreads) {
      const int kl = item % kRows;
      const int j = item / kRows;
      float2* p = recv + kl * LDR + j;
      if constexpr (R1 <= 3) {  // all R1 * 8 points in registers
        float2 u[R1][8];
#pragma unroll
        for (int m = 0; m < 8; ++m) {
          float2 t[R1];
#pragma unroll
          for (int a = 0; a < R1; ++a) t[a] = p[G * m + Q1 * a];
          if constexpr (R1 > 1) {
            dft_radix<R1, 1>(t);
#pragma unroll
            for (int kr = 1; kr < R1; ++kr) t[kr] = c_mul(t[kr], twn[(j + G * m) * kr]);
          }
#pragma unroll
          for (int kr = 0; kr < R1; ++kr) u[kr][m] = t[kr];
        }
#pragma unroll
        for (int kr = 0; kr < R1; ++kr) {
          dft_reg<8, 1>(u[kr]);
          if (j != 0) {
#pragma unroll
            for (int d = 1; d < 8; ++d) u[kr][d] = c_mul(u[kr][d], tw[(d - 1) * 16 + TS * j]);
          }
#pragma unroll
          for (int d = 0; d < 8; ++d) p[Q1 * kr + G * d] = u[kr][d];
        }
      } else {  // the two steps in turn, through the thread's own points
        for (int m = 0; m < 8; ++m) {
          float2 t[R1];
#pragma unroll
          for (int a = 0; a < R1; ++a) t[a] = p[G * m + Q1 * a];
          dft_radix<R1, 1>(t);
          p[G * m] = t[0];
#pragma unroll
          for (int kr = 1; kr < R1; ++kr) {
            p[G * m + Q1 * kr] = c_mul(t[kr], twn[(j + G * m) * kr]);
          }
        }
        for (int kr = 0; kr < R1; ++kr) {
          float2 v[8];
#pragma unroll
          for (int m = 0; m < 8; ++m) v[m] = p[Q1 * kr + G * m];
          dft_reg<8, 1>(v);
          if (j != 0) {
#pragma unroll
            for (int d = 1; d < 8; ++d) v[d] = c_mul(v[d], tw[(d - 1) * 16 + TS * j]);
          }
#pragma unroll
          for (int d = 0; d < 8; ++d) p[Q1 * kr + G * d] = v[d];
        }
      }
    }
    __syncthreads();

    // the G-point DFT of each group (kr, d) in registers: outputs
    // k1 = kr + R1*(d + 8*k); only the kept ones, in time order
    // t - lo = k2 + 128*(k1 - k1_lo)
    float2* ob = out + static_cast<long long>(tr) * keep + r0;
    for (int item = tid; item < kRows * R1 * 8; item += kThreads) {
      const int kl = item % kRows;
      const int g = item / kRows;
      const int kr = g % R1;
      const int d = g / R1;
      const float2* p = recv + kl * LDR + kr * Q1 + G * d;
      float2 v[G];
#pragma unroll
      for (int j = 0; j < G; ++j) v[j] = p[j];
      if constexpr (G == 16) dft16<1>(v);
      else dft_reg<8, 1>(v);
#pragma unroll
      for (int k = 0; k < G; ++k) {
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

// The launch configuration of `kern` on clusters of `cl` blocks: its
// shared-memory allowance set, and how many of its clusters are resident on
// the current card at once. Both queries cost tens of microseconds, so each
// (kernel, device) is prepared once; a lock keeps the table whole when host
// threads launch together.
static cudaError_t prepare_cluster(const void* kern, size_t smem, int cl, int* clusters) {
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
  cfg.gridDim = dim3(cl * 1024);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cl;
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

struct ClusterArgs {
  const float2 *X, *elem;
  float2* out;
  const float2 *tw_pass, *tw_n1, *tw_a, *tw_b, *roll_row, *roll_col;
  long long xsp, xsb;
  int n_valid, n_tr, k1_lo, n1_keep;
  float scale;
  cudaStream_t stream;
};

// Prepares the kernel of one instantiation and reports its resident
// clusters; with arguments, launches it on that many (or fewer).
template <int R1, int Q1, int CL>
static cudaError_t cluster_entry(const ClusterArgs* a, int* clusters) {
  const ClusterKern kern = ifft_cluster_kernel<R1, Q1, CL>;
  constexpr size_t smem = ClusterPlan<R1, Q1, CL>::kBytes;
  cudaError_t e = prepare_cluster(reinterpret_cast<const void*>(kern), smem, CL, clusters);
  if (e != cudaSuccess || a == nullptr) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CL * (a->n_tr < *clusters ? a->n_tr : *clusters));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = a->stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = CL;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kern, a->X, a->elem, a->out, a->tw_pass, a->tw_n1, a->tw_a,
                         a->tw_b, a->roll_row, a->roll_col, a->xsp, a->xsb, a->n_valid,
                         a->n_tr, a->k1_lo, a->n1_keep, a->scale);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// n1 -> (R1, Q1, cluster size): 128 and 384 = 3 * 128 and 192 = 3 * 64 on four
// blocks, 448 = 7 * 64 on eight (ops/kernels/ifft_fused.py N1S)
static cudaError_t cluster_dispatch(int n1, const ClusterArgs* a, int* clusters) {
  switch (n1) {
    case 384: return cluster_entry<3, 128, 4>(a, clusters);
    case 128: return cluster_entry<1, 128, 4>(a, clusters);
    case 192: return cluster_entry<3, 64, 4>(a, clusters);
    case 448: return cluster_entry<7, 64, 8>(a, clusters);
    default: return cudaErrorInvalidValue;
  }
}

// Clusters of the n1-point kernel resident on the current card at once
// (the persistent grid's size), or an error where the card refuses it.
extern "C" int ifft_fused_clusters(int n1, int* clusters) {
  return cluster_dispatch(n1, nullptr, clusters);
}

// X: complex64 with element strides (xsp, xsb) over (pol, block), bins
// contiguous, 16-byte aligned with even strides; elem: (n,) complex64 or
// null; out: (n_pol, n_valid, n1_keep * 128) complex64, the kept
// k1 in [k1_lo, k1_lo + n1_keep); tw_pass: the per-pass table of the
// 128-point backward transform (fft_reg_pass_tw); tw_n1: (n1,)
// exp(+2*pi*i*m/n1); tw_a, tw_b: (8, n1), (16, n1) exp(+2*pi*i*16*a*m1/N),
// exp(+2*pi*i*b*m1/N); roll_row, roll_col: (128,), (n1,)
// exp(-2*pi*i*roll*k2/N), exp(-2*pi*i*roll*128*k1/N). n2 = 128, n1 in
// {128, 192, 384, 448}. One persistent cluster per resident slot.
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
  const ClusterArgs a = {
      static_cast<const float2*>(X),        static_cast<const float2*>(elem),
      static_cast<float2*>(out),            static_cast<const float2*>(tw_pass),
      static_cast<const float2*>(tw_n1),    static_cast<const float2*>(tw_a),
      static_cast<const float2*>(tw_b),     static_cast<const float2*>(roll_row),
      static_cast<const float2*>(roll_col), xsp, xsb, n_valid, static_cast<int>(n_tr),
      k1_lo, n1_keep, scale, static_cast<cudaStream_t>(stream)};
  int clusters = 0;
  return cluster_dispatch(n1, &a, &clusters);
}
