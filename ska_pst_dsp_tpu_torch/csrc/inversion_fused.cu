// Fused SKA-Low Golden inversion: the frontend (overlap-save frame,
// temporal taper, L-point forward DFT, fftshifted passband keep, deripple,
// channel permutation) and the backward-FFT epilogue (elementwise factor,
// DC-centering roll, overlap discard, gain) in one launch, each assembled
// 49152-point block held in the shared memory of one thread-block cluster
// from the frontend's last pass to the kept output samples.
//
// Replaces no Pallas kernel alone: it fuses the ports of
//   ska_pst_dsp_tpu/ops/pallas/synthesis_fused.py::_fused_synthesis
//   (csrc/synthesis_fused.cu) and
//   ska_pst_dsp_tpu/ops/pallas/ifft_fused.py::fused_big_ifft
//   (csrc/ifft_fused.cu, the cluster route)
// at the one geometry where the epilogue's cluster can hold a block and
// the frontend's tile fills one of its thread blocks: L = 256, 256
// channels, FN_width = 192, N = 49152 = 128 * 384. It computes
//
//   X[p, b, 192*c + j] = dr[j] * sum_t taper[t] * x[p, b*keep + t, perm[c]]
//                               * w_L^(t * ((kpos + j) mod L))
//   y[p, b, t - lo]    = IFFT(roll(X[p, b] * elem, -roll))[t] * gain,
//                        t in [lo, N - lo)
//
// as synthesis_fused followed by fused_big_ifft compute it, the epilogue
// with the same passes and tables; the frontend's DFT runs as 16 * 16.
//
// What bounds it on the H100: bytes. The two kernels it replaces met in
// device memory: the frontend wrote each (pol, block)'s assembled spectrum
// (384 KiB) and the epilogue read it straight back, 544 * 768 KiB = 428 MB
// a low request (2 pol x 272 blocks). Without that traffic the request
// must still read its 544 * 256 channels x 256-sample frames (286 MB, less
// where neighbouring frames meet in L2) and write the 30720 kept samples of
// each block (134 MB): 419 MB, 0.125 ms at 3.35 TB/s, against ~3.5 Gflop
// of FFT (0.052 ms at 67 TFLOP/s).
//
// Design: one persistent cluster of eight 256-thread blocks per resident
// slot walks over the (pol, block) transforms (eight: 256 channels are
// eight 32-channel tiles, and eight blocks are the largest portable
// cluster), two blocks an SM. For each transform, with the four-step split
// N = n2 * n1 = 128 * 384, input k = 384*m2 + m1, output t = k2 + 128*k1:
//   * block r is the frontend of channels [32r, 32r + 32), in two halves
//     of 16. The thread of (channel c, j) loads its 16 frame samples
//     t = j + 16*m from device memory into registers (strides are
//     arguments: a channel-major stream or a sample_offset view needs no
//     copy; 16 channels of one time row are 128 contiguous bytes of the
//     time-major stream), tapers them there, runs the 16-point DFT over m
//     and the twiddle w_L^(j*d) and stores them in a row of 257 points
//     (odd: 16 channels at one offset hit 16 banks); the thread of (c, d)
//     then runs the 16-point DFT over j of bins k = d + 16*e in registers.
//     The second half's samples load during the first half's passes;
//   * the epilogue's roll is a circular shift of its input, and its gain a
//     factor: each kept bin j' of channel c, times dr[j'] * gain/N, goes to
//     k' = (192*c + j' - roll) mod N, row m2 = k' / 384 and column
//     m1 = k' % 384, straight into the column buffer of the block that owns
//     m1 (map_shared_rank: block r owns m1 in [48r, 48r + 48)): the
//     assembled block never leaves the cluster, and the output needs no
//     phase;
//   * a cluster barrier; meanwhile each thread loads the next transform's
//     first-half samples into its registers, in flight through the
//     epilogue;
//   * then the epilogue of csrc/ifft_fused.cu on its 48 columns and 16
//     rows k2 in [16r, 16r + 16): the 128-point column DFTs (radix 8 in
//     shared memory, times elem at the shifted bin; 16 points in
//     registers), the N-level twiddle and the exchange into the rows'
//     owners, a cluster barrier, the 384-point row DFTs (radix 3 and
//     radix 8 in registers, 16 points in registers) and only the kept
//     samples stored;
//   * two cluster barriers a transform: the one after the column stores
//     also tells each block that every other has read its frontend rows
//     and its receive buffer of the transform before, and the one after
//     the exchange that every other has read its columns.
// Why 256 threads and two blocks an SM: with one 512-thread block an SM
// (the first version) every warp of the SM waited at the same barriers; a
// transform took ~11 us a cluster against ~3.5 us of shared-memory traffic,
// no faster than the two kernels. Two blocks of two clusters interleave
// their phases. Shared memory per block (110 KiB, under half the SM's 228
// KB): 48 KiB of columns, 48 KiB of rows whose first 32 KiB also hold the
// frontend's 16 rows of a half, 11 KiB of tables; w_n1 is read through L1.
// fp32 SIMT arithmetic throughout. The two-kernel route stays for every
// other geometry (SKA-Mid, the other cluster splits, the cascades).
#include <cooperative_groups.h>

#include "bulk_async.cuh"
#include "fft_reg.cuh"

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kCl = 8;                 // thread blocks of a cluster
constexpr int kChan = 32;              // channels per block
constexpr int kHalf = 16;              // channels of one frontend half
constexpr int kNChan = kChan * kCl;    // 256
constexpr int kFnw = 192;              // kept bins per channel
constexpr int kN2 = 128, kN1 = 384;    // N = 49152 = kN2 * kN1
constexpr int kR1 = 3, kQ1 = 128, kG = 16;  // n1 = 3 * 8 * 16
constexpr int kTwA = 8, kTwB = 16;     // k2 = 16*a + b
constexpr int kCpc = kN1 / kCl;        // columns m1 per block
constexpr int kRows = kN2 / kCl;       // rows k2 per block
constexpr int kLdr = kN1 + 1;          // row stride of the receive buffer (odd)

constexpr int kL = 256;                // the frame length L
constexpr int kR = 16;                 // L = 16 * 16: two passes of 16 points
constexpr int kLd = kL + 1;            // frontend row stride (odd)
static_assert(kR * kR == kL && kHalf * kR == kThreads, "inversion: frontend tiling");
static_assert(kNChan * kFnw == kN2 * kN1 && 2 * kFnw == kN1, "inversion: two channels a row");
static_assert(kR1 * kQ1 == kN1 && kQ1 == 8 * kG && kCpc * kCl == kN1, "inversion: row split");
constexpr int kN = kN2 * kN1;

// shared memory, in float2: the frontend's rows of a half share the
// receive buffer (the rows are read before the cluster barrier after which
// other blocks write the receive buffer)
constexpr int kCol = kN2 * kCpc;                 // [m2][kCpc]
constexpr int kRecv = kRows * kLdr;              // [k2 - r0][kLdr]
constexpr int kBuf = kHalf * kLd;                // [channel][kLd]
static_assert(kBuf <= kRecv, "inversion: frontend rows inside the receive buffer");
constexpr int kTwC = FftRegPlan<7>::kTw;         // backward 128-point per-pass table
constexpr int kTab = (kTwA + kTwB) * kCpc;
constexpr int kF2 = kCol + kRecv + kL + kTwC + kTab;
constexpr size_t kSmem = static_cast<size_t>(kF2) * sizeof(float2) +
                         static_cast<size_t>(kL + kFnw) * sizeof(float);
// two blocks an SM: 228 KB, less 1 KB each for the system
static_assert(2 * (kSmem + 1024) <= 228 * 1024, "inversion: two blocks an SM");

// The first-pass samples of thread (c, j) = (tid % 16, tid / 16), channel
// ch0 + c, for transform tr: v[m] = x[pol, b*keep + j + 16*m, perm[ch0 + c]].
__device__ __forceinline__ void frame_load(float2 (&v)[kR], const float2* x, const int* perm,
                                           long long sp, long long st, long long sc,
                                           int n_blocks, int keep, int tr, int ch0) {
  const int pol = tr / n_blocks;
  const int b = tr - pol * n_blocks;
  const float2* xb = x + pol * sp +
                     (static_cast<long long>(b) * keep + (threadIdx.x >> 4)) * st +
                     static_cast<long long>(__ldg(perm + ch0 + (threadIdx.x & 15))) * sc;
#pragma unroll
  for (int m = 0; m < kR; ++m) v[m] = xb[static_cast<long long>(kR * m) * st];
}

// One half of the frontend: the L-point DFTs of 16 channels from ch0,
// L = 16 * 16 with t = j + 16*m and bin k = d + 16*e, whose first-pass
// samples are in v; the next half's (ch_next, transform tr_next; none where
// tr_next < 0) are loaded into v after the first pass. The first pass (the
// thread of (c, j)): taper, the 16-point DFT over m in registers, times
// w_L^(j*d), into row c at 16*j + d. The second (the thread of (c, d)): the
// 16-point DFT over j in registers; each kept bin, j' = (k - kpos) mod L <
// FN_width, times dr[j'] * gain/N, at k' = (192*c + j' - roll) mod N of the
// assembled block (the epilogue's roll, as a shift of its input): row
// m2 = k' / 384, column m1 = k' % 384, in the shared memory of the block
// that owns m1. Ends with every thread past its reads of buf.
__device__ __forceinline__ void frontend_half(float2 (&v)[kR], float2* buf, float2* col,
                                              const float2* twf, const float* tap,
                                              const float* drs, int ch0, int kpos, int roll,
                                              const float2* x, const int* perm, long long sp,
                                              long long st, long long sc, int n_blocks,
                                              int keep, int tr_next, int ch_next,
                                              cg::cluster_group& cluster) {
  const int tid = threadIdx.x;
  {
    const int c = tid & 15;
    const int j = tid >> 4;
#pragma unroll
    for (int m = 0; m < kR; ++m) v[m] = c_scale(v[m], tap[j + kR * m]);
    dft16<-1>(v);
    float2* row = buf + c * kLd + kR * j;
    row[0] = v[0];
#pragma unroll
    for (int d = 1; d < kR; ++d) row[d] = j == 0 ? v[d] : c_mul(v[d], twf[j * d]);
  }
  if (tr_next >= 0) frame_load(v, x, perm, sp, st, sc, n_blocks, keep, tr_next, ch_next);
  __syncthreads();

  const int c = tid >> 4;
  const int d = tid & 15;
  float2 w[kR];
  const float2* row = buf + c * kLd + d;
#pragma unroll
  for (int j = 0; j < kR; ++j) w[j] = row[kR * j];
  dft16<-1>(w);
  const int k_ch = (ch0 + c) * kFnw - roll;
#pragma unroll
  for (int e = 0; e < kR; ++e) {
    int j = d + kR * e - kpos;
    if (j < 0) j += kL;
    if (j < kFnw) {
      int k = k_ch + j;
      if (k < 0) k += kN;
      const int m2 = k / kN1;
      const int m1 = k - m2 * kN1;
      const int owner = m1 / kCpc;
      float2* dst = cluster.map_shared_rank(col, owner);
      dst[m2 * kCpc + m1 - owner * kCpc] = c_scale(w[e], drs[j]);
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads, 2)
inversion_fused_kernel(const float2* __restrict__ x, const float2* __restrict__ elem,
                       float2* __restrict__ out, const float* __restrict__ taper,
                       const float* __restrict__ dr, const int* __restrict__ perm,
                       const float2* __restrict__ tw_l, const float2* __restrict__ tw_pass,
                       const float2* __restrict__ tw_n1, const float2* __restrict__ tw_a,
                       const float2* __restrict__ tw_b, long long sp, long long st,
                       long long sc, int n_blocks, int n_tr, int keep, int kpos, int roll,
                       int k1_lo, int n1_keep, float scale) {
  extern __shared__ __align__(16) float2 smem[];
  float2* col = smem;             // [m2][kCpc]: this block's columns of the block
  float2* recv = col + kCol;      // [k2 - r0][kLdr]: R1 sub-rows of Q1
  float2* buf = recv;             // the frontend's 16 channel rows of a half
  float2* twf = recv + kRecv;     // w_L^m, forward
  float2* tw = twf + kL;          // per-pass table of the 128-point backward transform
  float2* tab = tw + kTwC;        // [a][c] w_N^(16*a*m1), then [b][c] w_N^(b*m1)
  float* tap = reinterpret_cast<float*>(tab + kTab);
  float* drs = tap + kL;          // dr[j] * gain/N
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  const int ch0 = rank * kChan;   // this block's channels
  const int c0 = rank * kCpc;     // this block's columns
  const int r0 = rank * kRows;    // this block's rows
  const int n_cl = gridDim.x / kCl;
  const long long out_len = static_cast<long long>(n1_keep) * kN2;

  int tr = blockIdx.x / kCl;
  float2 v[kR];
  if (tr < n_tr) frame_load(v, x, perm, sp, st, sc, n_blocks, keep, tr, ch0);
  for (int i = tid; i < kL; i += kThreads) twf[i] = tw_l[i];
  for (int i = tid; i < kTwC; i += kThreads) tw[i] = tw_pass[i];
  for (int i = tid; i < kTab; i += kThreads) {
    const int row = i / kCpc;
    const int c = i - row * kCpc;
    tab[i] = row < kTwA ? tw_a[row * kN1 + c0 + c] : tw_b[(row - kTwA) * kN1 + c0 + c];
  }
  for (int i = tid; i < kL; i += kThreads) tap[i] = taper[i];
  for (int i = tid; i < kFnw; i += kThreads) drs[i] = dr[i] * scale;
  __syncthreads();
  // every block of the cluster has started before any writes into another
  cluster_arrive();
  cluster_wait();

  for (; tr < n_tr; tr += n_cl) {
    // the frontend of this block's 32 channels, two halves of 16; the
    // second half's samples are loaded during the first
    frontend_half(v, buf, col, twf, tap, drs, ch0, kpos, roll, x, perm, sp, st, sc, n_blocks,
                  keep, tr, ch0 + kHalf, cluster);
    frontend_half(v, buf, col, twf, tap, drs, ch0 + kHalf, kpos, roll, x, perm, sp, st, sc,
                  n_blocks, keep, -1, 0, cluster);
    cluster_arrive();  // this block's part of the assembled block is stored
    // the next transform's first half, in flight through the epilogue
    if (tr + n_cl < n_tr) frame_load(v, x, perm, sp, st, sc, n_blocks, keep, tr + n_cl, ch0);
    cluster_wait();  // every block's columns are complete, every frontend row read

    // columns, 128 = 8 * 16: the radix-8 pass of span 16 (times elem on the
    // way in); lanes on neighbouring columns
    for (int item = tid; item < kCpc * 16; item += kThreads) {
      const int c = item % kCpc;
      const int j = item / kCpc;
      float2 w[8];
#pragma unroll
      for (int m = 0; m < 8; ++m) w[m] = col[(j + 16 * m) * kCpc + c];
      if (elem != nullptr) {
#pragma unroll
        for (int m = 0; m < 8; ++m) {
          int k = (j + 16 * m) * kN1 + c0 + c + roll;  // the position's bin before the shift
          if (k >= kN) k -= kN;
          w[m] = c_mul(w[m], __ldg(elem + k));
        }
      }
      dft_reg<8, 1>(w);
      if (j != 0) {
#pragma unroll
        for (int d = 1; d < 8; ++d) w[d] = c_mul(w[d], tw[(d - 1) * 16 + j]);
      }
#pragma unroll
      for (int d = 0; d < 8; ++d) col[(j + 16 * d) * kCpc + c] = w[d];
    }
    __syncthreads();

    // then the 16-point DFT of each group d in registers: outputs
    // k2 = d + 8*k, times the N-level twiddle, into row k2 of the block that
    // owns it
    for (int item = tid; item < kCpc * 8; item += kThreads) {
      const int c = item % kCpc;
      const int d = item / kCpc;
      float2 w[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) w[j] = col[(16 * d + j) * kCpc + c];
      dft16<1>(w);
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const int k2 = d + 8 * k;
        const float2 t = c_mul(tab[(k2 >> 4) * kCpc + c], tab[(kTwA + (k2 & 15)) * kCpc + c]);
        float2* dst = cluster.map_shared_rank(recv, k2 / kRows);
        dst[(k2 % kRows) * kLdr + c0 + c] = c_mul(w[k], t);
      }
    }
    cluster_arrive();
    cluster_wait();  // every block's rows are complete

    // rows, n1 = 3 * 8 * 16 with m1 = j + 16*m + 128*alpha: the thread of
    // (row, j) takes its 24 points through the radix-3 DFTs over alpha,
    // times w_n1^((j + 16*m)*kr), and the radix-8 DFTs over m, times
    // w_128^(j*d), into sub-row kr at j + 16*d; lanes on the rows
    for (int item = tid; item < kRows * kG; item += kThreads) {
      const int kl = item % kRows;
      const int j = item / kRows;
      float2* p = recv + kl * kLdr + j;
      float2 u[kR1][8];
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        float2 t[kR1];
#pragma unroll
        for (int a = 0; a < kR1; ++a) t[a] = p[kG * m + kQ1 * a];
        dft_radix<kR1, 1>(t);
#pragma unroll
        for (int kr = 1; kr < kR1; ++kr) t[kr] = c_mul(t[kr], __ldg(tw_n1 + (j + kG * m) * kr));
#pragma unroll
        for (int kr = 0; kr < kR1; ++kr) u[kr][m] = t[kr];
      }
#pragma unroll
      for (int kr = 0; kr < kR1; ++kr) {
        dft_reg<8, 1>(u[kr]);
        if (j != 0) {
#pragma unroll
          for (int d = 1; d < 8; ++d) u[kr][d] = c_mul(u[kr][d], tw[(d - 1) * 16 + j]);
        }
#pragma unroll
        for (int d = 0; d < 8; ++d) p[kQ1 * kr + kG * d] = u[kr][d];
      }
    }
    __syncthreads();

    // the 16-point DFT of each group (kr, d) in registers: outputs
    // k1 = kr + 3*(d + 8*k); only the kept ones, in time order
    // t - lo = k2 + 128*(k1 - k1_lo)
    float2* ob = out + static_cast<long long>(tr) * out_len + r0;
    for (int item = tid; item < kRows * kR1 * 8; item += kThreads) {
      const int kl = item % kRows;
      const int g = item / kRows;
      const int kr = g % kR1;
      const int d = g / kR1;
      const float2* p = recv + kl * kLdr + kr * kQ1 + kG * d;
      float2 w[kG];
#pragma unroll
      for (int j = 0; j < kG; ++j) w[j] = p[j];
      dft16<1>(w);
#pragma unroll
      for (int k = 0; k < kG; ++k) {
        const int k1 = kr + kR1 * (d + 8 * k);
        const int kk = k1 - k1_lo;
        if (static_cast<unsigned>(kk) < static_cast<unsigned>(n1_keep)) {
          ob[kl + static_cast<long long>(kN2) * kk] = w[k];
        }
      }
    }
    __syncthreads();  // the rows are read: the next transform's frontend rows
  }
}

// The kernel's shared-memory allowance, set once per device, and how many
// of its clusters are resident on the current card at once (both queries
// cost tens of microseconds; a lock keeps the table whole when host threads
// launch together).
static cudaError_t prepare(int* clusters) {
  struct Prepared {
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
    if (done[i].dev == dev) {
      *clusters = done[i].clusters;
      return cudaSuccess;
    }
  }
  const void* kern = reinterpret_cast<const void*>(inversion_fused_kernel);
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(kSmem));
  if (e == cudaSuccess) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  }
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCl * 1024);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmem;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kCl;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  e = cudaOccupancyMaxActiveClusters(clusters, inversion_fused_kernel, &cfg);
  if (e != cudaSuccess) return e;
  if (*clusters <= 0) return cudaErrorInvalidConfiguration;  // the card refuses the cluster
  if (n_done < 16) done[n_done++] = {dev, *clusters};
  return cudaSuccess;
}

// Clusters of the kernel resident on the current card at once (the
// persistent grid's size), or an error where the card refuses it.
extern "C" int inversion_fused_clusters(int* clusters) { return prepare(clusters); }

// x: complex64 stream with element strides (sp, st, sc) over (pol, time,
// chan), every frame b*keep + [0, L) inside it; elem: (N,) complex64,
// pre-rolled by +roll, or null; out: (n_pol, n_blocks, n1_keep * 128)
// complex64, the kept k1 in [k1_lo, k1_lo + n1_keep); taper: (L,) float32;
// dr: (FN_width,) float32; perm: (n_chan,) int32; tw_l: (L,) w_L^m of the
// forward transform; tw_pass, tw_n1, tw_a, tw_b: csrc/ifft_fused.cu's
// tables at n1 = 384 (ops/kernels/ifft_fused.py cluster_tables); roll in
// [0, N); scale = gain / N. Takes L = 256, 256 channels, FN_width = 192
// (N = 49152 = 128 * 384) only.
extern "C" int inversion_fused_launch(const void* x, const void* elem, void* out,
                                      const void* taper, const void* dr, const void* perm,
                                      const void* tw_l, const void* tw_pass,
                                      const void* tw_n1, const void* tw_a, const void* tw_b,
                                      long long sp, long long st, long long sc, int n_pol,
                                      int n_chan, int n_blocks, int L, int keep, int kpos,
                                      int roll, int fnw, int k1_lo, int n1_keep, float scale,
                                      void* stream) {
  const long long n_tr = static_cast<long long>(n_pol) * n_blocks;
  if (L != kL || n_chan != kNChan || fnw != kFnw || n_pol <= 0 || n_blocks <= 0 ||
      n_tr > (1LL << 30) || keep <= 0 || kpos < 0 || kpos >= kL || roll < 0 || roll >= kN ||
      k1_lo < 0 || n1_keep <= 0 || k1_lo + n1_keep > kN1) {
    return cudaErrorInvalidValue;
  }
  int clusters = 0;
  cudaError_t e = prepare(&clusters);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCl * (n_tr < clusters ? static_cast<int>(n_tr) : clusters));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kCl;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(
      &cfg, inversion_fused_kernel, static_cast<const float2*>(x),
      static_cast<const float2*>(elem), static_cast<float2*>(out),
      static_cast<const float*>(taper), static_cast<const float*>(dr),
      static_cast<const int*>(perm), static_cast<const float2*>(tw_l),
      static_cast<const float2*>(tw_pass), static_cast<const float2*>(tw_n1),
      static_cast<const float2*>(tw_a), static_cast<const float2*>(tw_b), sp, st, sc,
      n_blocks, static_cast<int>(n_tr), keep, kpos, roll, k1_lo, n1_keep, scale);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}
