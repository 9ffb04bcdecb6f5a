// Fused Golden inversion: the frontend (overlap-save frame, temporal taper,
// L-point forward DFT, fftshifted passband keep, deripple, channel
// permutation) and the backward-FFT epilogue (elementwise factor,
// DC-centering roll, overlap discard, gain) in one launch, each assembled
// block held in the shared memory of one thread-block cluster from the
// frontend's last pass to the kept output samples.
//
// Replaces no Pallas kernel alone: it fuses the ports of
//   ska_pst_dsp_tpu/ops/pallas/synthesis_fused.py::_fused_synthesis
//   (csrc/synthesis_fused.cu) and
//   ska_pst_dsp_tpu/ops/pallas/ifft_fused.py::fused_big_ifft
//   (csrc/ifft_fused.cu, the cluster route; elsewhere the composed epilogue)
// at the three geometries where the epilogue's cluster can hold a block and
// the frontend's tiles fill its thread blocks, FN_width = 3L/4 (InvPlan):
//   * SKA-Low: L = 256, 256 channels, N = 49152 = 128 * 384 (LowPlan);
//   * a LowCBF PST slab, the 216 kept channels of one coarse channel of the
//     SKA-Low PST cascade: L = 256, N = 41472 = 216 * 192 (PsiPlan). Neither
//     package has an epilogue plan at this length (41472 = 2^9 * 3^4: no
//     split with n2 a multiple of 128 and n1 a multiple of 8), so without
//     this kernel it runs the frontend kernel and the composed epilogue
//     (cuFFT, roll, scale, a strided copy);
//   * the same slab at L = 512, the frame a PST node takes where the
//     chirp's reach leaves too little of a 256-sample frame: N = 82944 =
//     216 * 384 (Psi512Plan), no epilogue plan either. It computes
//
//   X[p, b, FNW*c + j] = dr[j] * sum_t taper[t] * x[p, b*keep + t, perm[c]]
//                               * w_L^(t * ((kpos + j) mod L))
//   y[p, b, t - lo]    = IFFT(roll(X[p, b] * elem[p % rows], -roll))[t] * gain,
//                        t in [lo, N - lo)
//
// as synthesis_fused followed by the epilogue computes it; the frontend's
// DFT runs as 16 * (L / 16). elem is a (rows, N) table (rows = 1: one factor for
// every stream; an SKA-Low PST node's chirps, one a coarse channel, with
// the streams laid out (pol, coarse channel): rows = the coarse channels).
//
// What bounds it on the H100: bytes. The two kernels it replaces at SKA-Low
// met in device memory: the frontend wrote each (pol, block)'s assembled
// spectrum (384 KiB) and the epilogue read it straight back, 544 * 768 KiB
// = 428 MB a low request (2 pol x 272 blocks). Without that traffic the
// request must still read its 544 * 256 channels x 256-sample frames (286
// MB, less where neighbouring frames meet in L2) and write the 30720 kept
// samples of each block (134 MB): 419 MB, 0.125 ms at 3.35 TB/s, against
// ~3.5 Gflop of FFT (0.052 ms at 67 TFLOP/s). A cascade slab's transform
// reads 216 x 256 frame samples (442 KB; 276 KB of them new) and writes
// 25920 samples (207 KB) for ~5.4 Mflop of FFT: ~10 flop a byte, under the
// fp32 ridge of ~20.
//
// Design: one persistent cluster of eight 256-thread blocks per resident
// slot walks over the (pol, block) transforms (eight: the largest portable
// cluster), two blocks an SM where a block's shared memory allows (one at
// L = 512). For each transform, with the four-step split
// N = n2 * n1, input k = n1*m2 + m1, output t = k2 + n2*k1:
//   * block r is the frontend of channels [C*r, C*r + C) (C = 32, or 27 in
//     the cascade's slab), in two halves of up to 16 (16 + 16, 16 + 11: a
//     short half's spare threads load and store nothing). The thread of (channel c,
//     j) loads its M = L/16 frame samples t = j + 16*m from device memory into
//     registers (strides are arguments: a channel-major stream or a
//     sample_offset view needs no copy; a stream's carried samples and its
//     new block are two inputs with a seam between them, Src, so the
//     streaming inversion joins nothing), tapers them there, runs the
//     M-point DFT over m and the twiddle w_L^(j*d) and stores them in a row
//     of L + 1 points (odd: 16 channels at one offset hit 16 banks); the
//     thread of (c, d), for each of its M/16 values of d, then runs the
//     16-point DFT over j of bins k = d + M*e in registers. The lanes of the first pass lie on
//     channels (16 channels of one time row are 128 contiguous bytes of the
//     time-major stream the one-shot round trip hands over); the slab's
//     kernel puts them on time, for the channel-major slabs the cascade's
//     inverse hands over (a warp loads two channels' 128 contiguous bytes;
//     its rows, skewed by j, are its own through both passes, so warp
//     barriers order them: 3.06 against 3.33 ms for 512 x 9 channel-major
//     slab transforms on the H100, 4.18 against 3.08 time-major). The
//     second half's samples load during the first half's passes;
//   * the epilogue's roll is a circular shift of its input, and its gain a
//     factor: each kept bin j' of channel c, times dr[j'] * gain/N, goes to
//     k' = (FNW*c + j' - roll) mod N, row m2 = k' / n1 and column
//     m1 = k' % n1, straight into the column buffer of the block that owns
//     m1 (map_shared_rank: block r owns m1 in [r*n1/8, (r+1)*n1/8)): the
//     assembled block never leaves the cluster, and the output needs no
//     phase;
//   * a cluster barrier; meanwhile each thread loads the next transform's
//     first-half samples into its registers, in flight through the
//     epilogue;
//   * then the epilogue of csrc/ifft_fused.cu on the block's n1/8 columns
//     and n2/8 rows: the n2-point column DFTs (times elem at the shifted
//     bin), the N-level twiddle w_N^(m1*k2) = tab_a[k2 / S] * tab_b[k2 % S]
//     (two exact float64-built tables) and the exchange into the rows'
//     owners, a cluster barrier, the n1 = 3 * 8 * G-point row DFTs (radix 3
//     and radix 8 in registers, G points in registers) and only the kept
//     samples stored. At SKA-Low n2 = 128 runs as a radix-8 pass in shared
//     memory and 16 points in registers (S = 16), n1 = 384 with G = 16;
//   * two cluster barriers a transform: the one after the column stores
//     also tells each block that every other has read its frontend rows
//     and its receive buffer of the transform before, and the one after
//     the exchange that every other has read its columns.
// The cascade's split, 216 * 192: the output overlap 7776 = 36 * 216 and
// the keep region 25920 = 120 * 216 are whole rows; with n1 = 192 = FN_width
// each channel's bins fill one row m2 (two rows with the roll), and
// n1 = 3 * 8 * 8 is csrc/ifft_fused.cu's row plan at 192 (R1 = 3, Q1 = 64);
// 216 = 6 * 6 * 6 runs as three radix-6 passes (dft6: 2 * 3 by the
// prime-factor map, a third of the direct sum's arithmetic), the first two
// in shared memory with a per-pass table of their twiddles, the third in
// registers straight into the exchange (S = 36: k2 = d0 + 6*d1 + 36*d2).
// Eight blocks of 27 channels, 24 columns and 27 rows keep the 256-channel
// kernel's cluster, threads and frontend halves; 216 = 9 * 24 would need a
// non-portable cluster of nine.
// The slab at L = 512, 216 * 384: FN_width = 384 = n1, so again each
// channel's bins fill one row; the output overlap of a PST node's discard
// is whole rows (16200 = 75 * 216 at PSR J1909-3744's DM), the columns are
// the slab's radix-6 passes and the rows SKA-Low's 3 * 128 (G = 16). The
// frontend runs 16 * 32: 32 samples a thread and a 32-point DFT (dft32) in
// registers, two bins d a thread in the second pass. Its block needs 188
// KiB (columns 81 KiB, rows 81 KiB, twiddles 16 KiB): one block an SM, so
// its launch bounds allow 255 registers. At L = 1024 the columns and rows
// alone would need twice 648 KiB over the cluster's eight blocks, more
// than an SM holds.
// Why 256 threads and two blocks an SM: with one 512-thread block an SM
// (the first version) every warp of the SM waited at the same barriers; a
// transform took ~11 us a cluster against ~3.5 us of shared-memory traffic,
// no faster than the two kernels. Two blocks of two clusters interleave
// their phases. Shared memory per block (SKA-Low 110 KiB, the slab 95 KiB,
// under half the SM's 228 KB; the slab at L = 512 188 KiB): the columns,
// the rows (whose first 32 or 64 KiB also hold the frontend's 16 rows of a
// half) and the tables; w_n1 is read through L1. fp32 SIMT arithmetic throughout. The two-kernel route stays
// for every other geometry (SKA-Mid, the other cluster splits, the critical
// cascades).
#include <cooperative_groups.h>

#include "bulk_async.cuh"
#include "fft_reg.cuh"

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kCl = 8;                 // thread blocks of a cluster
constexpr int kHalf = 16;              // channels of a full frontend half
constexpr int kR = 16;                 // the frontend's second pass: 16 points over j
static_assert(kHalf * kR == kThreads, "inversion: frontend tiling");

// One instantiation: frame length L (FN_width = 3L/4 kept bins a channel),
// NCHAN channels, N = NCHAN * FN_width = N2 * N1 with N1 = R1 * Q1
// (Q1 = 8 * G); the column transform N2 is 128 = 8 * 16 or 216 = 6 * 6 * 6;
// CM: the frontend's first-pass lanes on time (see lane_chan).
template <int NCHAN, int N2, int R1, int Q1, bool CM, int L>
struct InvPlan {
  static constexpr bool kCm = CM;
  static constexpr int kL = L;
  static constexpr int kFnw = 3 * L / 4;             // kept bins per channel
  static constexpr int kM = L / kR;                  // L = 16 * M: M samples a thread
  static constexpr int kDpt = kM / kR;               // second-pass bins d a thread
  static constexpr int kLd = L + 1;                  // frontend row stride (odd)
  static constexpr int kChan = NCHAN / kCl;          // channels per block
  static constexpr int kHalf1 = kChan - kHalf;       // channels of the second half
  static constexpr int kN2 = N2, kR1 = R1, kQ1 = Q1, kN1 = R1 * Q1, kG = Q1 / 8;
  static constexpr int kN = N2 * kN1;
  static constexpr int kCpc = kN1 / kCl;            // columns m1 per block
  static constexpr int kRows = N2 / kCl;            // rows k2 per block
  static constexpr int kLdr = kN1 + 1;              // row stride of the receive buffer (odd)
  static constexpr int kTwS = N2 == 128 ? 16 : 36;  // k2 = S*a + b
  static constexpr int kTwA = N2 / kTwS, kTwB = kTwS;
  // the column transform's per-pass table: the 128-point one
  // (fft_reg_pass_tw), or the radix-6 passes of span 36 and 6 (5 rows each)
  static constexpr int kTwC = N2 == 128 ? FftRegPlan<7>::kTw : 5 * 36 + 5 * 6;
  // the row transform's radix-8 pass reads the 128-point table: the column
  // table at SKA-Low, a second table in the slab
  static constexpr int kTwR = N2 == 128 ? 0 : FftRegPlan<7>::kTw;
  // shared memory, in float2: the frontend's rows of a half share the
  // receive buffer (the rows are read before the cluster barrier after
  // which other blocks write the receive buffer)
  static constexpr int kCol = N2 * kCpc;            // [m2][kCpc]
  static constexpr int kRecv = kRows * kLdr;        // [k2 - r0][kLdr]
  static constexpr int kBuf = kHalf * kLd;          // [channel][kLd]
  static constexpr int kTab = (kTwA + kTwB) * kCpc;
  static constexpr int kF2 = kCol + kRecv + kL + kTwC + kTwR + kTab;
  static constexpr size_t kSmem = static_cast<size_t>(kF2) * sizeof(float2) +
                                  static_cast<size_t>(kL + kFnw) * sizeof(float);
  // blocks an SM: 228 KB, less 1 KB each for the system; two where they fit
  static constexpr int kBlocksPerSm = 2 * (kSmem + 1024) <= 228 * 1024 ? 2 : 1;
  static_assert(kM * kR == L && (kM == 16 || kM == 32), "inversion: L = 16 * 16 or 16 * 32");
  static_assert(kChan * kCl == NCHAN && kHalf1 > 0 && kHalf1 <= kHalf,
                "inversion: two frontend halves a block");
  static_assert(NCHAN * kFnw == kN && kCpc * kCl == kN1 && kRows * kCl == N2,
                "inversion: the split");
  static_assert((N2 == 128 || N2 == 216) && (Q1 == 64 || Q1 == 128) && R1 == 3,
                "inversion: the instantiated transforms");
  static_assert(kBuf <= kRecv, "inversion: frontend rows inside the receive buffer");
  static_assert(kSmem + 1024 <= 228 * 1024, "inversion: one block an SM");
};

// SKA-Low: 49152 = 128 * 384, lanes on channels (the one-shot round trip
// hands the analysis' time-major channels over)
using LowPlan = InvPlan<256, 128, 3, 128, false, 256>;
// a LowCBF PST slab: 41472 = 216 * 192, lanes on time (the cascade's
// inverse hands channel-major slabs over)
using PsiPlan = InvPlan<216, 216, 3, 64, true, 256>;
// the slab at L = 512: 82944 = 216 * 384, lanes on time (a PST node's
// channel-major beam at a frame its DM needs)
using Psi512Plan = InvPlan<216, 216, 3, 128, true, 512>;
static_assert(LowPlan::kBlocksPerSm == 2 && PsiPlan::kBlocksPerSm == 2 &&
              Psi512Plan::kBlocksPerSm == 1, "inversion: the plans' blocks an SM");

// The thread of (channel c, j) in the frontend's first pass: lanes on
// channels, (tid % 16, tid / 16), which suits a time-major stream; lanes on
// time, (tid / 16, tid % 16), which suits a channel-major one (CM: a warp
// reads two channels' 16 consecutive samples, 256 contiguous bytes).
template <bool CM>
__device__ __forceinline__ int lane_chan() {
  return CM ? threadIdx.x >> 4 : threadIdx.x & 15;
}

// A launch's input as the frontend reads it: the stream of the held samples
// followed by the new block, sample t (counted from the stream's start)
// from held[pol, t, chan] where t < h and from x[pol, t - h, chan] after
// that, each with its own element strides over (pol, time, chan). A
// streaming inversion hands the samples it carried and the caller's block
// over as they lie, so nothing is joined. With h = 0 every frame lies in x
// and held is never read.
struct Src {
  const float2* x;
  const float2* held;
  long long sp, st, sc;  // x's strides
  long long hp, ht, hc;  // held's strides
  long long h;           // the seam
};

// The first-pass samples of thread (c, j), channel ch0 + c, for transform
// tr: v[m] = stream[pol, b*keep + j + 16*m, perm[ch0 + c]], m < M. A frame
// wholly on one side of the seam picks its input and stride once, and only
// a frame across it picks each sample's side. In a half of NC < 16 channels
// the spare threads (c >= NC) load nothing: their rows are never read.
template <class P, int NC>
__device__ __forceinline__ void frame_load(float2 (&v)[P::kM], const Src& s, const int* perm,
                                           int n_blocks, int keep, int tr, int ch0) {
  constexpr bool CM = P::kCm;
  constexpr int kM = P::kM;
  const int pol = tr / n_blocks;
  const int b = tr - pol * n_blocks;
  const int c = lane_chan<CM>();
  if (NC < kHalf && c >= NC) return;
  const int j = CM ? threadIdx.x & 15 : threadIdx.x >> 4;
  const long long ch = __ldg(perm + ch0 + c);
  const long long t0 = static_cast<long long>(b) * keep + j;  // the thread's first sample
  const long long f0 = t0 - j;                                 // the frame's
  const bool in_held = f0 + P::kL <= s.h;
  if (in_held || f0 >= s.h) {
    const long long st = in_held ? s.ht : s.st;
    const float2* xb = in_held ? s.held + pol * s.hp + t0 * s.ht + ch * s.hc
                               : s.x + pol * s.sp + (t0 - s.h) * s.st + ch * s.sc;
#pragma unroll
    for (int m = 0; m < kM; ++m) v[m] = xb[static_cast<long long>(kR * m) * st];
  } else {
    const float2* hb = s.held + pol * s.hp + ch * s.hc;
    const float2* xb = s.x + pol * s.sp + ch * s.sc;
#pragma unroll
    for (int m = 0; m < kM; ++m) {
      const long long t = t0 + kR * m;
      v[m] = t < s.h ? hb[t * s.ht] : xb[(t - s.h) * s.st];
    }
  }
}

// cos(2*pi*m/32); called with constants after unrolling, so it folds into
// an immediate
__device__ __forceinline__ float w32_cos(int m) {
  switch (m & 31) {
    case 1: case 31: return 0.98078528040323044913f;
    case 3: case 29: return 0.83146961230254523708f;
    case 5: case 27: return 0.55557023301960222474f;
    case 7: case 25: return 0.19509032201612826785f;
    case 9: case 23: return -0.19509032201612826785f;
    case 11: case 21: return -0.55557023301960222474f;
    case 13: case 19: return -0.83146961230254523708f;
    case 15: case 17: return -0.98078528040323044913f;
    default: return w16_cos((m & 31) >> 1);
  }
}

// In-register 32-point DFT y[k] = sum_m v[m] * exp(SIGN*2*pi*i*m*k/32),
// natural order: the 16-point DFTs of the even and the odd samples and one
// radix-2 layer, y[d] = E[d] + w32^d O[d], y[d + 16] = E[d] - w32^d O[d].
template <int SIGN>
__device__ __forceinline__ void dft32(float2 (&v)[32]) {
  float2 e[16], o[16];
#pragma unroll
  for (int m = 0; m < 16; ++m) {
    e[m] = v[2 * m];
    o[m] = v[2 * m + 1];
  }
  dft16<SIGN>(e);
  dft16<SIGN>(o);
#pragma unroll
  for (int d = 0; d < 16; ++d) {
    const float c = w32_cos(d), s = SIGN * w32_cos(d + 24);  // sin x = cos(x - pi/2)
    const float2 t = d == 0 ? o[d] : make_float2(o[d].x * c - o[d].y * s,
                                                 o[d].x * s + o[d].y * c);
    v[d] = c_add(e[d], t);
    v[d + 16] = c_sub(e[d], t);
  }
}

// One half of the frontend: the L-point DFTs of NC channels from ch0,
// L = 16 * M with t = j + 16*m and bin k = d + M*e, whose first-pass
// samples are in v; the next half's (NN channels from ch_next, transform
// tr_next; none where tr_next < 0) are loaded into v after the first pass.
// The first pass (the thread of (c, j)): taper, the M-point DFT over m in
// registers, times w_L^(j*d), into row c at M*j + d (with lanes on time at
// M*j + (d + j) % M: a half-warp's 16 j at one d hit 16 banks). The
// second (the thread of (c, d) for its M/16 values of d, c < NC): the
// 16-point DFT over j in registers; each kept bin, j' = (k - kpos) mod L <
// FN_width, times dr[j'] * gain/N, at k' = (FNW*c + j' - roll) mod N of the
// assembled block (the epilogue's roll, as a shift of its input): row
// m2 = k' / n1, column m1 = k' % n1, in the shared memory of the block that
// owns m1. Ends with every thread past its reads of buf. With lanes on time
// a warp's two rows are its own in both passes, so a warp barrier orders
// them.
template <class P, int NC, int NN>
__device__ __forceinline__ void frontend_half(float2 (&v)[P::kM], float2* buf, float2* col,
                                              const float2* twf, const float* tap,
                                              const float* drs, int ch0, int kpos, int roll,
                                              const Src& src, const int* perm, int n_blocks,
                                              int keep, int tr_next, int ch_next,
                                              cg::cluster_group& cluster) {
  constexpr bool CM = P::kCm;
  constexpr int kM = P::kM, kL = P::kL, kLd = P::kLd, kFnw = P::kFnw;
  const int tid = threadIdx.x;
  const int cf = lane_chan<CM>();
  if (NC == kHalf || cf < NC) {
    const int j = CM ? tid & 15 : tid >> 4;
#pragma unroll
    for (int m = 0; m < kM; ++m) v[m] = c_scale(v[m], tap[j + kR * m]);
    if constexpr (kM == 16) dft16<-1>(v);
    else dft32<-1>(v);
    float2* row = buf + cf * kLd + kM * j;
    row[CM ? j : 0] = v[0];
#pragma unroll
    for (int d = 1; d < kM; ++d) {
      row[CM ? (d + j) & (kM - 1) : d] = j == 0 ? v[d] : c_mul(v[d], twf[j * d]);
    }
  }
  if (tr_next >= 0) frame_load<P, NN>(v, src, perm, n_blocks, keep, tr_next, ch_next);
  if constexpr (CM) __syncwarp();
  else __syncthreads();

  const int c = tid >> 4;
  if (NC == kHalf || c < NC) {
    const float2* row = buf + c * kLd;
    const int k_ch = (ch0 + c) * kFnw - roll;
#pragma unroll
    for (int q = 0; q < P::kDpt; ++q) {
      const int d = (tid & 15) + kR * q;
      float2 w[kR];
#pragma unroll
      for (int j = 0; j < kR; ++j) w[j] = row[kM * j + (CM ? (d + j) & (kM - 1) : d)];
      dft16<-1>(w);
#pragma unroll
      for (int e = 0; e < kR; ++e) {
        int j = d + kM * e - kpos;
        if (j < 0) j += kL;
        if (j < kFnw) {
          int k = k_ch + j;
          if (k < 0) k += P::kN;
          const int m2 = k / P::kN1;
          const int m1 = k - m2 * P::kN1;
          const int owner = m1 / P::kCpc;
          float2* dst = cluster.map_shared_rank(col, owner);
          dst[m2 * P::kCpc + m1 - owner * P::kCpc] = c_scale(w[e], drs[j]);
        }
      }
    }
  }
  if constexpr (CM) __syncwarp();
  else __syncthreads();
}

// The backward 6-point DFT in registers, natural order, as 2 * 3 by the
// prime-factor map (no twiddles): the 3-point DFTs of the inputs
// 3*n1 + 2*n2 (mod 6), then the 2-point DFTs into outputs 3*k1 + 4*k2
// (mod 6); a third of dft_radix<6>'s direct sum.
__device__ __forceinline__ void dft6(float2 (&v)[6]) {
  float2 a[3] = {v[0], v[2], v[4]};
  float2 b[3] = {v[3], v[5], v[1]};
  dft_radix<3, 1>(a);
  dft_radix<3, 1>(b);
  v[0] = c_add(a[0], b[0]);
  v[3] = c_sub(a[0], b[0]);
  v[4] = c_add(a[1], b[1]);
  v[1] = c_sub(a[1], b[1]);
  v[2] = c_add(a[2], b[2]);
  v[5] = c_sub(a[2], b[2]);
}

template <class P>
__global__ void __launch_bounds__(kThreads, P::kBlocksPerSm)
inversion_fused_kernel(const float2* __restrict__ x, const float2* __restrict__ held,
                       const float2* __restrict__ elem,
                       float2* __restrict__ out, const float* __restrict__ taper,
                       const float* __restrict__ dr, const int* __restrict__ perm,
                       const float2* __restrict__ tw_l, const float2* __restrict__ tw_pass,
                       const float2* __restrict__ tw_n1, const float2* __restrict__ tw_a,
                       const float2* __restrict__ tw_b, const float2* __restrict__ tw_row,
                       long long sp, long long st, long long sc, long long hp, long long ht,
                       long long hc, long long h, int n_blocks, int n_tr, int rows, int keep,
                       int kpos, int roll, int k1_lo, int n1_keep, float scale) {
  constexpr int kN = P::kN, kN1 = P::kN1, kN2 = P::kN2, kCpc = P::kCpc, kRows = P::kRows;
  constexpr int kLdr = P::kLdr, kR1 = P::kR1, kQ1 = P::kQ1, kG = P::kG, kTwA = P::kTwA;
  constexpr int kL = P::kL;
  constexpr int TS = 16 / kG;  // w_Q1^(j*d) = w_128^(TS*j*d) = twr[(d - 1)*16 + TS*j]
  extern __shared__ __align__(16) float2 smem[];
  float2* col = smem;               // [m2][kCpc]: this block's columns of the block
  float2* recv = col + P::kCol;     // [k2 - r0][kLdr]: R1 sub-rows of Q1
  float2* buf = recv;               // the frontend's 16 channel rows of a half
  float2* twf = recv + P::kRecv;    // w_L^m, forward
  float2* tw = twf + kL;            // per-pass table of the column transform
  float2* twr = P::kTwR ? tw + P::kTwC : tw;  // the 128-point table of the rows
  float2* tab = tw + P::kTwC + P::kTwR;  // [a][c] w_N^(S*a*m1), then [b][c] w_N^(b*m1)
  float* tap = reinterpret_cast<float*>(tab + P::kTab);
  float* drs = tap + kL;            // dr[j] * gain/N
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  const int ch0 = rank * P::kChan;  // this block's channels
  const int c0 = rank * kCpc;       // this block's columns
  const int r0 = rank * kRows;      // this block's rows
  const int n_cl = gridDim.x / kCl;
  const long long out_len = static_cast<long long>(n1_keep) * kN2;
  const Src src = {x, held, sp, st, sc, hp, ht, hc, h};

  int tr = blockIdx.x / kCl;
  float2 v[P::kM];
  if (tr < n_tr) frame_load<P, kHalf>(v, src, perm, n_blocks, keep, tr, ch0);
  for (int i = tid; i < kL; i += kThreads) twf[i] = tw_l[i];
  for (int i = tid; i < P::kTwC; i += kThreads) tw[i] = tw_pass[i];
  for (int i = tid; i < P::kTwR; i += kThreads) twr[i] = tw_row[i];
  for (int i = tid; i < P::kTab; i += kThreads) {
    const int row = i / kCpc;
    const int c = i - row * kCpc;
    tab[i] = row < kTwA ? tw_a[row * kN1 + c0 + c] : tw_b[(row - kTwA) * kN1 + c0 + c];
  }
  for (int i = tid; i < kL; i += kThreads) tap[i] = taper[i];
  for (int i = tid; i < P::kFnw; i += kThreads) drs[i] = dr[i] * scale;
  __syncthreads();
  // every block of the cluster has started before any writes into another
  cluster_arrive();
  cluster_wait();

  for (; tr < n_tr; tr += n_cl) {
    // the frontend of this block's channels, two halves; the second half's
    // samples are loaded during the first
    frontend_half<P, kHalf, P::kHalf1>(v, buf, col, twf, tap, drs, ch0, kpos, roll, src, perm,
                                       n_blocks, keep, tr, ch0 + kHalf, cluster);
    frontend_half<P, P::kHalf1, kHalf>(v, buf, col, twf, tap, drs, ch0 + kHalf, kpos, roll,
                                       src, perm, n_blocks, keep, -1, 0, cluster);
    cluster_arrive();  // this block's part of the assembled block is stored
    // the next transform's first half, in flight through the epilogue
    if (tr + n_cl < n_tr) {
      frame_load<P, kHalf>(v, src, perm, n_blocks, keep, tr + n_cl, ch0);
    }
    cluster_wait();  // every block's columns are complete, every frontend row read
    // this transform's stream p reads row p % rows of the elem table
    const float2* el = elem;
    if (el != nullptr) el += static_cast<long long>((tr / n_blocks) % rows) * kN;

    if constexpr (kN2 == 128) {
      // columns, 128 = 8 * 16: the radix-8 pass of span 16 (times elem on
      // the way in); lanes on neighbouring columns
      for (int item = tid; item < kCpc * 16; item += kThreads) {
        const int c = item % kCpc;
        const int j = item / kCpc;
        float2 w[8];
#pragma unroll
        for (int m = 0; m < 8; ++m) w[m] = col[(j + 16 * m) * kCpc + c];
        if (el != nullptr) {
#pragma unroll
          for (int m = 0; m < 8; ++m) {
            int k = (j + 16 * m) * kN1 + c0 + c + roll;  // the position's bin before the shift
            if (k >= kN) k -= kN;
            w[m] = c_mul(w[m], __ldg(el + k));
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
      // k2 = d + 8*k, times the N-level twiddle, into row k2 of the block
      // that owns it
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
    } else {
      // columns, 216 = 6 * 6 * 6: the radix-6 pass of span 36 (times elem
      // on the way in), then the pass of span 6 within each group of 36;
      // lanes on neighbouring columns
      for (int item = tid; item < kCpc * 36; item += kThreads) {
        const int c = item % kCpc;
        const int j = item / kCpc;
        float2 w[6];
#pragma unroll
        for (int m = 0; m < 6; ++m) w[m] = col[(j + 36 * m) * kCpc + c];
        if (el != nullptr) {
#pragma unroll
          for (int m = 0; m < 6; ++m) {
            int k = (j + 36 * m) * kN1 + c0 + c + roll;  // the position's bin before the shift
            if (k >= kN) k -= kN;
            w[m] = c_mul(w[m], __ldg(el + k));
          }
        }
        dft6(w);
        if (j != 0) {
#pragma unroll
          for (int d = 1; d < 6; ++d) w[d] = c_mul(w[d], tw[(d - 1) * 36 + j]);
        }
#pragma unroll
        for (int d = 0; d < 6; ++d) col[(j + 36 * d) * kCpc + c] = w[d];
      }
      __syncthreads();
      for (int item = tid; item < kCpc * 36; item += kThreads) {
        const int c = item % kCpc;
        const int u = item / kCpc;  // 6*g + j: group g at 36*g, butterfly j
        const int j = u % 6;
        float2* p = col + ((u - j) * 6 + j) * kCpc + c;
        float2 w[6];
#pragma unroll
        for (int m = 0; m < 6; ++m) w[m] = p[6 * m * kCpc];
        dft6(w);
        if (j != 0) {
#pragma unroll
          for (int d = 1; d < 6; ++d) w[d] = c_mul(w[d], tw[5 * 36 + (d - 1) * 6 + j]);
        }
#pragma unroll
        for (int d = 0; d < 6; ++d) p[6 * d * kCpc] = w[d];
      }
      __syncthreads();

      // then the last radix-6 DFT of each butterfly g = 6*d0 + d1 in
      // registers: outputs k2 = d0 + 6*d1 + 36*d, times the N-level
      // twiddle, into row k2 of the block that owns it
      for (int item = tid; item < kCpc * 36; item += kThreads) {
        const int c = item % kCpc;
        const int g = item / kCpc;
        float2 w[6];
#pragma unroll
        for (int m = 0; m < 6; ++m) w[m] = col[(6 * g + m) * kCpc + c];
        dft6(w);
        const int b = g / 6 + 6 * (g % 6);  // k2 % 36
        const float2 tb = tab[(kTwA + b) * kCpc + c];
#pragma unroll
        for (int d = 0; d < 6; ++d) {
          const int k2 = b + 36 * d;
          const float2 t = c_mul(tab[d * kCpc + c], tb);
          float2* dst = cluster.map_shared_rank(recv, k2 / kRows);
          dst[(k2 % kRows) * kLdr + c0 + c] = c_mul(w[d], t);
        }
      }
    }
    cluster_arrive();
    cluster_wait();  // every block's rows are complete

    // rows, n1 = 3 * 8 * G with m1 = j + G*m + Q1*alpha: the thread of
    // (row, j) takes its 24 points through the radix-3 DFTs over alpha,
    // times w_n1^((j + G*m)*kr), and the radix-8 DFTs over m, times
    // w_Q1^(j*d), into sub-row kr at j + G*d; lanes on the rows
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
          for (int d = 1; d < 8; ++d) u[kr][d] = c_mul(u[kr][d], twr[(d - 1) * 16 + TS * j]);
        }
#pragma unroll
        for (int d = 0; d < 8; ++d) p[kQ1 * kr + kG * d] = u[kr][d];
      }
    }
    __syncthreads();

    // the G-point DFT of each group (kr, d) in registers: outputs
    // k1 = kr + 3*(d + 8*k); only the kept ones, in time order
    // t - lo = k2 + n2*(k1 - k1_lo)
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
      if constexpr (kG == 16) dft16<1>(w);
      else dft_reg<8, 1>(w);
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

using InvKern = void (*)(const float2*, const float2*, const float2*, float2*, const float*,
                         const float*, const int*, const float2*, const float2*,
                         const float2*, const float2*, const float2*, const float2*, long long,
                         long long, long long, long long, long long, long long, long long, int,
                         int, int, int, int, int, int, int, float);

// The launch configuration of `kern` (shared memory `smem`) on clusters of
// eight: its shared-memory allowance set, and how many of its clusters are
// resident on the current card at once. Both queries cost tens of
// microseconds, so each (kernel, device) is prepared once; a lock keeps the
// table whole when host threads launch together.
static cudaError_t prepare(const void* kern, size_t smem, int* clusters) {
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
  cfg.gridDim = dim3(kCl * 1024);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kCl;
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

struct InvArgs {
  const float2 *x, *held, *elem;
  float2* out;
  const float *taper, *dr;
  const int* perm;
  const float2 *tw_l, *tw_pass, *tw_n1, *tw_a, *tw_b, *tw_row;
  long long sp, st, sc, hp, ht, hc, h;
  int n_blocks, n_tr, rows, keep, kpos, roll, k1_lo, n1_keep;
  float scale;
  cudaStream_t stream;
};

// Prepares the kernel of one instantiation and reports its resident
// clusters; with arguments, checks the plan's limits and launches it on
// that many (or fewer).
template <class P>
static cudaError_t inversion_entry(const InvArgs* a, int* clusters) {
  const InvKern kern = inversion_fused_kernel<P>;
  if (a != nullptr && (a->roll < 0 || a->roll >= P::kN || a->k1_lo < 0 || a->n1_keep <= 0 ||
                       a->k1_lo + a->n1_keep > P::kN1)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t e = prepare(reinterpret_cast<const void*>(kern), P::kSmem, clusters);
  if (e != cudaSuccess || a == nullptr) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCl * (a->n_tr < *clusters ? a->n_tr : *clusters));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = P::kSmem;
  cfg.stream = a->stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kCl;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kern, a->x, a->held, a->elem, a->out, a->taper, a->dr, a->perm,
                         a->tw_l, a->tw_pass, a->tw_n1, a->tw_a, a->tw_b, a->tw_row, a->sp, a->st,
                         a->sc, a->hp, a->ht, a->hc, a->h, a->n_blocks, a->n_tr, a->rows, a->keep,
                         a->kpos, a->roll, a->k1_lo, a->n1_keep, a->scale);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// (frame length, channels) -> the instantiation: (256, 256) SKA-Low,
// (256, 216) a LowCBF PST slab, (512, 216) that slab at L = 512
// (ops/kernels/inversion_fused.py GEOMETRIES)
static cudaError_t inversion_dispatch(int L, int n_chan, const InvArgs* a, int* clusters) {
  if (L == 256 && n_chan == 256) return inversion_entry<LowPlan>(a, clusters);
  if (L == 256 && n_chan == 216) return inversion_entry<PsiPlan>(a, clusters);
  if (L == 512 && n_chan == 216) return inversion_entry<Psi512Plan>(a, clusters);
  return cudaErrorInvalidValue;
}

// Clusters of the kernel of frame length L and n_chan channels resident on
// the current card at once (the persistent grid's size), or an error where
// the card refuses it.
extern "C" int inversion_fused_clusters(int L, int n_chan, int* clusters) {
  return inversion_dispatch(L, n_chan, nullptr, clusters);
}

// x: complex64 stream with element strides (sp, st, sc) over (pol, time,
// chan); held: null (h = 0), or the h samples that come before x, with
// strides (hp, ht, hc): every frame b*keep + [0, L) inside the h samples
// of held and those of x that follow them; elem: (rows, N) complex64,
// each row pre-rolled by +roll, stream p reading row p % rows (n_pol a
// multiple of rows), or null; out: (n_pol, n_blocks, n1_keep * n2)
// complex64, the kept k1 in [k1_lo, k1_lo + n1_keep); taper: (L,) float32;
// dr: (FN_width,) float32; perm: (n_chan,) int32; tw_l: (L,) w_L^m of the
// forward transform; tw_pass: the column transform's per-pass table;
// tw_n1: (n1,) w_n1^m; tw_a, tw_b: (n2 / S, n1) w_N^(S*a*m1), (S, n1)
// w_N^(b*m1); tw_row: the 128-point per-pass table (read at 216 channels);
// all backward (ops/kernels/inversion_fused.py kernel_tables); roll in
// [0, N); scale = gain / N. Takes FN_width = 3L/4 and (L, channels) (256,
// 256) (N = 49152 = 128 * 384), (256, 216) (N = 41472 = 216 * 192) or
// (512, 216) (N = 82944 = 216 * 384) only.
extern "C" int inversion_fused_launch(const void* x, const void* held, const void* elem,
                                      void* out, const void* taper, const void* dr,
                                      const void* perm, const void* tw_l, const void* tw_pass,
                                      const void* tw_n1, const void* tw_a, const void* tw_b,
                                      const void* tw_row, long long sp, long long st,
                                      long long sc, long long hp, long long ht, long long hc,
                                      long long h, int n_pol, int n_chan, int n_blocks, int L,
                                      int rows, int keep, int kpos, int roll, int fnw,
                                      int k1_lo, int n1_keep, float scale, void* stream) {
  const long long n_tr = static_cast<long long>(n_pol) * n_blocks;
  if (4 * fnw != 3 * L || n_pol <= 0 || n_blocks <= 0 || n_tr > (1LL << 30) ||
      rows <= 0 || n_pol % rows || keep <= 0 || kpos < 0 || kpos >= L || h < 0 ||
      (h > 0 && held == nullptr)) {
    return cudaErrorInvalidValue;
  }
  const InvArgs a = {
      static_cast<const float2*>(x),      static_cast<const float2*>(held),
      static_cast<const float2*>(elem),   static_cast<float2*>(out),
      static_cast<const float*>(taper),   static_cast<const float*>(dr),
      static_cast<const int*>(perm),
      static_cast<const float2*>(tw_l),   static_cast<const float2*>(tw_pass),
      static_cast<const float2*>(tw_n1),  static_cast<const float2*>(tw_a),
      static_cast<const float2*>(tw_b),   static_cast<const float2*>(tw_row),
      sp, st, sc, hp, ht, hc, h, n_blocks, static_cast<int>(n_tr), rows, keep, kpos, roll, k1_lo,
      n1_keep, scale, static_cast<cudaStream_t>(stream)};
  int clusters = 0;
  return inversion_dispatch(L, n_chan, &a, &clusters);
}
