// Out-of-core Golden-inversion epilogue for SKA-Mid-class block lengths
// (mid: N = 1,835,008 = 3584 * 512), as two kernels that meet in a scratch
// buffer A.
//
// Replaces the two Pallas kernels of
//   ska_pst_dsp_tpu/ops/pallas/ifft_big.py::fused_big_ifft_oc
//   (kern1 and kern2, launched by its two pallas_calls).
//
// Four-step split N = n2 * n1, frequency f = n1*i2 + i1, time
// t = k2 + n2*k1:
//
//   inner: A[k2, i1] = sum_i2 X[n1*i2 + i1] * elem[n1*i2 + i1]
//                             * exp(+2*pi*i*i2*k2/n2)
//   outer: y[t - lo] = gain/N * exp(-2*pi*i*roll*t/N)
//                      * sum_i1 A[k2, i1] * exp(+2*pi*i*i1*k2/N)
//                               * exp(+2*pi*i*i1*k1/n1),
//          k1 in [lo/n2, (N - lo)/n2)
//
// which equals IFFT(roll(X * elem, -roll))[lo:N-lo] * gain (elem arrives
// pre-rolled by +roll; the roll is the modulation theorem's phase).
//
// What bounds it on the H100: bytes. Each transform must read 14.7 MB of X
// and write 7.3 MB of kept samples (0.0526 ms for the mid batch of eight at
// 3.35 TB/s); its ~0.19 Gflop of FFT is 4 flop per byte, under the fp32
// ridge. The 14.7 MB of A per transform goes through HBM as well. Measured,
// the pair runs at about 4x that bound, and no single part dominates: the
// strided reads of X, the shared-memory passes and the stores each take a
// share (PERF.md).
//
// Design:
//   * one inner and one outer launch over the whole batch, A through HBM.
//     Running the pair per transform, so that its 14.7 MB of A is read back
//     from L2, measured slower on the H100: the extra launches' ramps and
//     tails cost more than the A traffic they save (PERF.md);
//   * inner: one persistent thread block per SM walks over tiles of
//     kCols = 4 columns i1 (4 x n2 points: 32-byte rows of X, whole
//     sectors; 158 KB of shared memory at mid with its w_n2 table). Each
//     thread loads the R values X[n1*(beta + Q*alpha) + i1] of its
//     (beta, column), runs the radix-R DFT over alpha in registers
//     (constant roots, fft_reg.cuh dft_radix) and multiplies the twiddle
//     w_n2^(beta*kr) into shared memory; it then loads the next tile's X
//     into the same registers, so those loads are in flight while the
//     Q-point DFTs over beta run as fft_reg.cuh's three register passes on
//     padded sub-rows, the last one storing A[k2, i1] straight from
//     registers;
//   * outer: one persistent thread block per SM walks over tiles of
//     kRows = 16 rows k2, loading the next tile's rows of A into registers
//     while the current one runs its passes. The N-level twiddle
//     w_N^(i1*k2) is the product row_hi[k2][i1 / 32] * row_lo[k2][i1 % 32]
//     of two exact host tables (the block stages its rows of both), so the
//     32 threads of a warp, on 32 neighbouring i1 of one row, read row_lo
//     without bank conflicts and row_hi as one broadcast. The n1-point DFT
//     runs as register passes, and the last pass stores only the kept k1, in
//     time order, times roll_row[k2] * roll_col[k1] * gain/N: the roll phase
//     w_N^(-roll*t) factored over t = k2 + n2*k1 into two exact tables, so
//     no index is reduced modulo N on the card;
//   * every twiddle is a float64-built host table staged in shared memory
//     (w_n2 for the inner kernel, w_n1 and the row tables for the outer);
//     none is gathered from a table of N entries.
// fp32 SIMT arithmetic throughout.
#include "fft_reg.cuh"

// Tile shapes, the fastest measured on the H100 (PERF.md). 512 threads a
// block leave each thread 128 registers.
constexpr int kCols = 4;     // i1 columns per inner tile
constexpr int kRows = 16;    // k2 rows per outer tile
constexpr int kThreads = 512;
constexpr int kLanes = 32;  // w_N^(i1*k2) = row_hi[k2][i1 / 32] * row_lo[k2][i1 % 32]

// Shared-memory stride of one inner column: R padded sub-rows of Q points
// (fft_reg_phys<true>), rounded to 4 (mod 16) so the four columns of a
// half-warp fall in four quarters of the banks.
__host__ __device__ constexpr int inner_ld(int r, int q) {
  return (r * (q + q / 8) + 15) / 16 * 16 + 4;
}

// The R values X[n1*(beta + Q*alpha) + i1] of each (beta, column) a thread
// owns in tile `tile` (transform tile / tiles_per_tr, columns
// (tile % tiles_per_tr) * kCols + c).
template <int R, int Q, int kItems>
__device__ __forceinline__ void inner_load(float2 (&v)[kItems][R], const float2* X,
                                           long long xsp, long long xsb, int n_blocks,
                                           int tiles_per_tr, int tile, int n1) {
  const int tr = tile / tiles_per_tr;
  const int pol = tr / n_blocks;
  const float2* xb = X + pol * xsp + (tr - pol * n_blocks) * xsb +
                     (tile % tiles_per_tr) * kCols;
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const int idx = threadIdx.x + it * kThreads;
    const long long f = static_cast<long long>(idx / kCols) * n1 + idx % kCols;
#pragma unroll
    for (int a = 0; a < R; ++a) v[it][a] = xb[f + static_cast<long long>(a) * Q * n1];
  }
}

// n2 = R * 2^LOGQ. A persistent loop over the n_tr * n1/kCols tiles (tile
// t: transform t / (n1/kCols)); the next tile's X is loaded into registers
// while the current one runs its passes.
template <int R, int LOGQ>
__global__ void __launch_bounds__(kThreads, 1)
ifft_big_inner_kernel(const float2* __restrict__ X, const float2* __restrict__ elem,
                      float2* __restrict__ A, const float2* __restrict__ tw_n2,
                      long long xsp, long long xsb, int n_blocks, int n_tr, int n1) {
  constexpr int Q = 1 << LOGQ;
  constexpr int N2 = R * Q;
  constexpr int SQ = Q + Q / 8;  // padded sub-row
  constexpr int LD = inner_ld(R, Q);
  constexpr int kItems = kCols * Q / kThreads;
  static_assert(kItems > 0 && kItems * kThreads == kCols * Q, "inner: tiling");
  constexpr int kLast = FftRegPlan<LOGQ>::kLast;
  constexpr int kPer = Q / kLast;
  extern __shared__ float2 smem[];
  float2* tw = smem;
  float2* buf = smem + N2;
  const int tid = threadIdx.x;
  const int tiles_per_tr = n1 / kCols;
  const int n_tiles = n_tr * tiles_per_tr;
  int tile = blockIdx.x;
  float2 v[kItems][R];
  if (tile < n_tiles) {
    inner_load<R, Q, kItems>(v, X, xsp, xsb, n_blocks, tiles_per_tr, tile, n1);
  }
  for (int i = tid; i < N2; i += kThreads) tw[i] = tw_n2[i];
  __syncthreads();

  for (; tile < n_tiles; tile += gridDim.x) {
    const int tr = tile / tiles_per_tr;
    const int c0 = (tile - tr * tiles_per_tr) * kCols;
    if (elem != nullptr) {
#pragma unroll
      for (int it = 0; it < kItems; ++it) {
        const int idx = tid + it * kThreads;
        const long long f = static_cast<long long>(idx / kCols) * n1 + c0 + idx % kCols;
#pragma unroll
        for (int a = 0; a < R; ++a) {
          v[it][a] = c_mul(v[it][a], elem[f + static_cast<long long>(a) * Q * n1]);
        }
      }
    }
    // radix-R DFT over alpha (i2 = beta + Q*alpha) and the twiddle
    // w_n2^(beta*kr)
#pragma unroll
    for (int it = 0; it < kItems; ++it) {
      const int idx = tid + it * kThreads;
      const int c = idx % kCols;
      const int beta = idx / kCols;
      if constexpr (R > 1) dft_radix<R>(v[it]);
      float2* col = buf + c * LD + fft_reg_phys<true>(beta);
      col[0] = v[it][0];
#pragma unroll
      for (int kr = 1; kr < R; ++kr) col[kr * SQ] = c_mul(v[it][kr], tw[beta * kr]);
    }
    if (tile + gridDim.x < n_tiles) {
      inner_load<R, Q, kItems>(v, X, xsp, xsb, n_blocks, tiles_per_tr, tile + gridDim.x, n1);
    }
    __syncthreads();

    // Q-point DFTs over beta of the kCols * R sub-rows; output kq of
    // sub-row kr is bin k2 = kr + R*kq
    fft_reg_pass8<Q, Q / 8, kCols, true>(buf, LD, R, SQ, tw, N2);
    fft_reg_pass8<Q, Q / 64, kCols, true>(buf, LD, R, SQ, tw, N2);
    float2* ab = A + static_cast<long long>(tr) * N2 * n1 + c0;
    for (int item = tid; item < kCols * R * kPer; item += kThreads) {
      const int c = item % kCols;
      const int rest = item / kCols;
      const int g = rest % kPer;
      const int kr = rest / kPer;
      const float2* row = buf + c * LD + kr * SQ;
      float2 w[kLast];
#pragma unroll
      for (int m = 0; m < kLast; ++m) w[m] = row[fft_reg_phys<true>(g * kLast + m)];
      dft_reg<kLast>(w);
#pragma unroll
      for (int d = 0; d < kLast; ++d) {
        const int k2 = kr + R * fft_reg_out_index(g, d);
        ab[static_cast<long long>(k2) * n1 + c] = w[d];
      }
    }
    __syncthreads();
  }
}

// n1 = R * 2^LOGQ. A persistent loop over the n_tr * n2/kRows row tiles of
// A (tile t: transform t / (n2/kRows)); the next tile's rows of A are
// loaded into registers while the current one runs its passes.
template <int R, int LOGQ>
__global__ void __launch_bounds__(kThreads, 1)
ifft_big_outer_kernel(const float2* __restrict__ A, float2* __restrict__ out,
                      const float2* __restrict__ tw_n1, const float2* __restrict__ row_hi,
                      const float2* __restrict__ row_lo, const float2* __restrict__ roll_row,
                      const float2* __restrict__ roll_col, int n2, int n_tr, int k1_lo,
                      int n1_keep, float scale) {
  constexpr int Q = 1 << LOGQ;
  constexpr int N1 = R * Q;
  constexpr int LD = N1 + 1;  // odd: 16 rows at one offset hit 16 banks
  constexpr int kHi = N1 / kLanes;
  constexpr int kLast = FftRegPlan<LOGQ>::kLast;
  constexpr int kPer = Q / kLast;
  constexpr int kSteps = kRows * N1 / kThreads;
  static_assert(kThreads % kLanes == 0 && (kRows * N1) % kThreads == 0,
                "outer: tiling");
  extern __shared__ float2 smem[];
  float2* tw = smem;
  float2* hi = tw + N1;                // [row][i1 / 32]
  float2* lo = hi + kRows * kHi;       // [row][i1 % 32]
  float2* buf = lo + kRows * kLanes;
  const int tid = threadIdx.x;
  const int tiles_per_tr = n2 / kRows;
  const int n_tiles = n_tr * tiles_per_tr;
  const long long keep = static_cast<long long>(n1_keep) * n2;
  int tile = blockIdx.x;
  float2 v[kSteps];
  if (tile < n_tiles) {
    const float2* ab = A + static_cast<long long>(tile) * kRows * N1;
#pragma unroll
    for (int s = 0; s < kSteps; ++s) v[s] = ab[tid + s * kThreads];
  }
  for (int i = tid; i < N1; i += kThreads) tw[i] = tw_n1[i];

  for (; tile < n_tiles; tile += gridDim.x) {
    const int tr = tile / tiles_per_tr;
    const int k2_0 = (tile - tr * tiles_per_tr) * kRows;
    for (int i = tid; i < kRows * kHi; i += kThreads) hi[i] = row_hi[k2_0 * kHi + i];
    for (int i = tid; i < kRows * kLanes; i += kThreads) lo[i] = row_lo[k2_0 * kLanes + i];
    __syncthreads();

    // rows k2 of A times the N-level twiddle w_N^(i1*k2): a warp holds 32
    // neighbouring i1 of one row, so lo is read conflict-free and hi is one
    // broadcast
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      const int idx = tid + s * kThreads;
      const int row = idx / N1;
      const int i1 = idx - row * N1;
      const float2 w = c_mul(hi[row * kHi + i1 / kLanes], lo[row * kLanes + i1 % kLanes]);
      buf[row * LD + i1] = c_mul(v[s], w);
    }
    if (tile + gridDim.x < n_tiles) {
      const float2* ab = A + static_cast<long long>(tile + gridDim.x) * kRows * N1;
#pragma unroll
      for (int s = 0; s < kSteps; ++s) v[s] = ab[tid + s * kThreads];
    }
    __syncthreads();

    if constexpr (R > 1) {
      for (int item = tid; item < kRows * Q; item += kThreads) {
        const int row = item % kRows;
        const int beta = item / kRows;
        float2* p = buf + row * LD + beta;
        float2 u[R];
#pragma unroll
        for (int a = 0; a < R; ++a) u[a] = p[a * Q];
        dft_radix<R>(u);
        p[0] = u[0];
#pragma unroll
        for (int kr = 1; kr < R; ++kr) p[kr * Q] = c_mul(u[kr], tw[beta * kr]);
      }
      __syncthreads();
    }

    fft_reg_pass8<Q, Q / 8, kRows, false>(buf, LD, R, Q, tw, N1);
    fft_reg_pass8<Q, Q / 64, kRows, false>(buf, LD, R, Q, tw, N1);
    float2* ob = out + static_cast<long long>(tr) * keep;
    for (int item = tid; item < kRows * R * kPer; item += kThreads) {
      const int row = item % kRows;
      const int rest = item / kRows;
      const int g = rest % kPer;
      const int kr = rest / kPer;
      const float2* p = buf + row * LD + kr * Q + g * kLast;
      float2 w[kLast];
#pragma unroll
      for (int m = 0; m < kLast; ++m) w[m] = p[m];
      dft_reg<kLast>(w);
      const int k2 = k2_0 + row;
      const float2 rr = c_scale(__ldg(roll_row + k2), scale);
#pragma unroll
      for (int d = 0; d < kLast; ++d) {
        const int kk = kr + R * fft_reg_out_index(g, d) - k1_lo;
        if (static_cast<unsigned>(kk) < static_cast<unsigned>(n1_keep)) {
          const float2 ph = c_mul(rr, __ldg(roll_col + kk + k1_lo));
          ob[k2 + static_cast<long long>(n2) * kk] = c_mul(w[d], ph);
        }
      }
    }
    __syncthreads();
  }
}

using InnerKern = void (*)(const float2*, const float2*, float2*, const float2*, long long,
                           long long, int, int, int);
using OuterKern = void (*)(const float2*, float2*, const float2*, const float2*,
                           const float2*, const float2*, const float2*, int, int, int, int,
                           float);

// n2 = r * 2^logq: r <= 8 with a 512-point power of two, or r in {1, 3, 7}
// with 128 or 256.
static InnerKern pick_inner(int r, int logq) {
  if (logq == 9) {
    switch (r) {
      case 1: return ifft_big_inner_kernel<1, 9>;
      case 2: return ifft_big_inner_kernel<2, 9>;
      case 3: return ifft_big_inner_kernel<3, 9>;
      case 4: return ifft_big_inner_kernel<4, 9>;
      case 6: return ifft_big_inner_kernel<6, 9>;
      case 7: return ifft_big_inner_kernel<7, 9>;
      case 8: return ifft_big_inner_kernel<8, 9>;
      default: return nullptr;
    }
  }
  if (logq == 8 || logq == 7) {
    switch (r) {
      case 1: return logq == 8 ? ifft_big_inner_kernel<1, 8> : ifft_big_inner_kernel<1, 7>;
      case 3: return logq == 8 ? ifft_big_inner_kernel<3, 8> : ifft_big_inner_kernel<3, 7>;
      case 7: return logq == 8 ? ifft_big_inner_kernel<7, 8> : ifft_big_inner_kernel<7, 7>;
      default: return nullptr;
    }
  }
  return nullptr;
}

// n1 in {128, 256, 384, 512}.
static OuterKern pick_outer(int r, int logq) {
  if (r == 1 && logq == 7) return ifft_big_outer_kernel<1, 7>;
  if (r == 1 && logq == 8) return ifft_big_outer_kernel<1, 8>;
  if (r == 1 && logq == 9) return ifft_big_outer_kernel<1, 9>;
  if (r == 3 && logq == 7) return ifft_big_outer_kernel<3, 7>;
  return nullptr;
}

static size_t inner_smem(int r, int logq) {
  const int q = 1 << logq;
  return static_cast<size_t>(r * q + kCols * inner_ld(r, q)) * sizeof(float2);
}

static size_t outer_smem(int r, int logq) {
  const size_t n1 = static_cast<size_t>(r) << logq;
  return (n1 + kRows * (n1 / kLanes + kLanes) + kRows * (n1 + 1)) * sizeof(float2);
}

// X: complex64 with element strides (xsp, xsb) over (pol, block), bins
// contiguous; elem: (n,) complex64 or null; A: (n_pol * n_blocks, n2, n1)
// complex64; tw_n2: (n2,) exp(+2*pi*i*m/n2). n2 = r2 * 2^logq2. One
// persistent thread block per resident slot.
extern "C" int ifft_big_inner_launch(const void* X, const void* elem, void* A,
                                     const void* tw_n2, long long xsp, long long xsb,
                                     int n_pol, int n_blocks, int n2, int r2, int logq2,
                                     int n1, void* stream) {
  const InnerKern inner = pick_inner(r2, logq2);
  const int n_tr = n_pol * n_blocks;
  if (inner == nullptr || (r2 << logq2) != n2 || n_tr <= 0 || n1 % kCols) {
    return cudaErrorInvalidValue;
  }
  const size_t smem = inner_smem(r2, logq2);
  int slots = 0;
  const cudaError_t e =
      prepare_persistent(reinterpret_cast<const void*>(inner), kThreads, smem, &slots);
  if (e != cudaSuccess) return e;
  const int tiles = n_tr * (n1 / kCols);
  inner<<<tiles < slots ? tiles : slots, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(X), static_cast<const float2*>(elem),
      static_cast<float2*>(A), static_cast<const float2*>(tw_n2), xsp, xsb, n_blocks, n_tr,
      n1);
  return cudaGetLastError();
}

// A: (n_tr, n2, n1) complex64; out: (n_tr, n1_keep * n2) complex64, the kept
// k1 in [k1_lo, k1_lo + n1_keep); tw_n1: (n1,) exp(+2*pi*i*m/n1); row_hi,
// row_lo: (n2, n1/32), (n2, 32) exp(+2*pi*i*32*s*k2/N), exp(+2*pi*i*l*k2/N);
// roll_row, roll_col: (n2,), (n1,) exp(-2*pi*i*roll*k2/N),
// exp(-2*pi*i*roll*n2*k1/N). One persistent thread block per resident slot.
extern "C" int ifft_big_outer_launch(const void* A, void* out, const void* tw_n1,
                                     const void* row_hi, const void* row_lo,
                                     const void* roll_row, const void* roll_col, int n_tr,
                                     int n2, int n1, int r1, int logq1, int k1_lo,
                                     int n1_keep, float scale, void* stream) {
  const OuterKern outer = pick_outer(r1, logq1);
  if (outer == nullptr || (r1 << logq1) != n1 || n_tr <= 0 || n2 % kRows) {
    return cudaErrorInvalidValue;
  }
  const size_t smem = outer_smem(r1, logq1);
  int slots = 0;
  const cudaError_t e =
      prepare_persistent(reinterpret_cast<const void*>(outer), kThreads, smem, &slots);
  if (e != cudaSuccess) return e;
  const int tiles = n_tr * (n2 / kRows);
  outer<<<tiles < slots ? tiles : slots, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(A), static_cast<float2*>(out),
      static_cast<const float2*>(tw_n1), static_cast<const float2*>(row_hi),
      static_cast<const float2*>(row_lo), static_cast<const float2*>(roll_row),
      static_cast<const float2*>(roll_col), n2, n_tr, k1_lo, n1_keep, scale);
  return cudaGetLastError();
}
