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
// output, ~6 flop per device-memory byte, under the fp32 ridge of ~20; the
// low stream (2 x 2^23 samples in, 2 x 43673 spectra out) must move 313 MB,
// 0.0935 ms at 3.35 TB/s. Each input sample feeds ceil(phases*block/step)
// (~17) frames, so the fold must not read frames from device memory. The
// first version staged each span with synchronous loads (nothing overlapped
// them), folded with 13 shared-memory reads per output point, ran eight
// radix-2 shared-memory passes and read the result back bit-reversed; it
// took 6.3x the bound.
//
// Design (block = R * Q, Q = 2^LOGQ, R in {1, 3}, 128 <= block <= 1024):
//   * a tile is K consecutive spectra of one polarization (K = 32 up to
//     block 256, 16 up to 512, 8 above). One persistent 512-thread block per
//     SM walks over the tiles, spectrum tiles fastest, so the spans in
//     flight at once share their overlap through L2;
//   * each tile's input span, (K - 1)*step + phases*block samples (74 KB at
//     low), arrives by asynchronous bulk copies (cp.async.bulk) on a
//     transaction barrier into a ring of two buffers: the next tile's span
//     loads while this one folds and transforms. A copy must start on 16
//     bytes: a span whose first sample is not (odd p*n_dat + k0*step; never
//     at low, where both are even) starts one sample early and is read at
//     offset 1; an odd last sample is loaded by the issuing thread. Where two
//     spans do not fit in shared memory, one buffer is used;
//   * fold at the low geometry (a template specialisation): with g =
//     gcd(step, block), spectrum k + block/g at phase m - step/g reads the
//     sample spectrum k reads at phase m (at low: 4 spectra = 3 blocks).
//     A thread owns column j of one residue class k mod 4 of the tile: it
//     reads the 3*(U-1) + 13 rows that the class's U = K/4 spectra touch
//     once each from shared memory and adds each to every spectrum that uses
//     it, its 13 filter coefficients in registers: 34 reads for 8 outputs
//     (4.25 a point, 13 before). Other geometries fold directly;
//   * the folded rows replace the span in its buffer, R sub-rows of Q + 1
//     points per spectrum (odd stride: a warp on 32 spectra at one offset
//     hits 32 banks) with fft_reg_swizzle's XOR swizzle inside each sub-row;
//   * the DFT: the radix-R step over the sub-rows, then fft_reg.cuh's
//     register radix-8 passes (SIGN -1; 256 = 8 * 8 * 4: two exchanges), the
//     last pass on lanes of neighbouring butterflies rev8(tq), whose outputs
//     are neighbouring channels: it stores from registers in channel order,
//     32 consecutive channels per warp, times the ramp row and the block
//     gain. Nothing is read back bit-reversed;
//   * the ramp ((period, block), period 4 at low) is staged in shared memory
//     once where it fits in 16 KB, and each spectrum's row offset is one
//     32-bit % per spectrum (block0 reduced modulo period on the host);
//   * channel-major store (CM, instantiated for the generic 256-point fold
//     only, which both stages of SKA-Low's PST cascade run): out[p, i, k]
//     holds bin rows[i] of spectrum k, so the cascade's corner turns are
//     views and LowCBF writes its 216 kept bins alone. Stored from the last
//     pass, each lane's 8 B would land nblocks * 8 B from its neighbour's.
//     So the last pass keeps its outputs (times ramp and gain, the same
//     arithmetic) in registers; after a barrier they go into the span
//     buffer, free by then, as a (bin, spectrum) tile of odd stride K + 1;
//     after another, lanes on the K spectra store one output row at a time
//     (256 contiguous bytes a row a tile), rows read from the table.
// fp32 SIMT arithmetic throughout; no tensor cores (bf16 and TF32 both miss
// the -60 dB purity floor).
#include <cstdint>

#include "bulk_async.cuh"
#include "fft_reg.cuh"

constexpr int kThreads = 512;
constexpr int kHeader = 160;       // bytes: two barriers, two offsets, K row offsets
constexpr int kRampStage = 16384;  // bytes of ramp staged in shared memory at most

// spectra per tile
__host__ __device__ constexpr int tile_spectra(int block) {
  return block <= 256 ? 32 : block <= 512 ? 16 : 8;
}

// bytes each lane of the issuing warp copies: a 32nd of the span, rounded
// up to 16 (the last lane's copy may be shorter or empty)
__device__ __forceinline__ uint32_t span_chunk(uint32_t bytes) {
  return (((bytes + 31u) >> 5) + 15u) & ~15u;
}

struct Span {
  long long n_dat, pol_stride;  // samples of a polarization; elements between two
  int step, span, n_kt, kspec;
};

// Warp 0: the span of tile `tile` into buffer `dst` (offset of its first
// sample into *off), completion on `bar`.
__device__ __forceinline__ void issue_span(float2* dst, int* off, uint64_t* bar,
                                           const float2* x, const Span& s, int tile) {
  const int lane = threadIdx.x;
  const int pol = tile / s.n_kt;
  const long long s0 = static_cast<long long>(tile - pol * s.n_kt) * s.kspec * s.step;
  const long long e0 = pol * s.pol_stride + s0;
  const int o = static_cast<int>(e0 & 1);
  const long long avail = s.n_dat - s0;
  const int nv = (avail < s.span ? static_cast<int>(avail) : s.span) + o;
  const uint32_t bytes = (static_cast<uint32_t>(nv) * 8u) & ~15u;
  const float2* src = x + (e0 - o);
  if (lane == 0) {
    *off = o;
    if (bytes < static_cast<uint32_t>(nv) * 8u) dst[nv - 1] = src[nv - 1];
    mbar_expect_tx(bar, bytes);
  }
  __syncwarp();
  fence_proxy_async();
  const uint32_t chunk = span_chunk(bytes);
  const uint32_t start = lane * chunk;
  if (start < bytes) {
    const uint32_t n = bytes - start < chunk ? bytes - start : chunk;
    bulk_load(reinterpret_cast<char*>(dst) + start,
              reinterpret_cast<const char*>(src) + start, n, bar);
  }
}

// PH > 0: the fold of a geometry with PH phases at step SB*block/BB
// (gcd(step, block) = block/BB); PH = 0: any geometry, folded directly.
// CM: the channel-major store of the n_rows bins of `rows`; else the
// time-major store of every bin (rows unread).
template <int R, int LOGQ, int PH, int SB, int BB, bool CM = false>
__global__ void __launch_bounds__(kThreads, 1)
analysis_fused_kernel(const float2* __restrict__ x, float2* __restrict__ out,
                      const float* __restrict__ f2d, const float2* __restrict__ tw_pass,
                      const float2* __restrict__ tw_n, const float2* __restrict__ ramp,
                      Span sp, int nblocks, int phases, int period, int b0, int n_tiles,
                      int buf_f2, int stages, int ramp_staged, const int* __restrict__ rows,
                      int n_rows) {
  using Plan = FftRegPlan<LOGQ>;
  constexpr int Q = Plan::kQ;
  constexpr int BLOCK = R * Q;
  constexpr int K = tile_spectra(BLOCK);
  constexpr int LDQ = Q + 1;
  constexpr int NSR = K * R;     // Q-point sub-rows per tile
  constexpr int PER = Q / 8;
  constexpr int RL = Plan::kLast;
  constexpr int ND = Plan::kDigits;
  constexpr int SPAN = Q / RL;   // last-pass butterflies per sub-row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem_raw);
  int* soff = reinterpret_cast<int*>(smem_raw + 16);
  int* rowoff = soff + 2;
  float2* bufs = reinterpret_cast<float2*>(smem_raw + kHeader);
  float2* tw = bufs + stages * buf_f2;
  float2* twn = tw + Plan::kTw;
  float2* rst = twn + (R > 1 ? BLOCK : 0);
  const float2* rp = ramp_staged ? rst : ramp;
  const int tid = threadIdx.x;

  for (int i = tid; i < Plan::kTw; i += kThreads) tw[i] = tw_pass[i];
  if constexpr (R > 1) {
    for (int i = tid; i < BLOCK; i += kThreads) twn[i] = tw_n[i];
  }
  if (ramp_staged) {
    for (int i = tid; i < period * BLOCK; i += kThreads) rst[i] = ramp[i];
  }
  if (tid == 0) {
    mbar_init(bar, 1);
    mbar_init(bar + 1, 1);
    fence_mbar_init();
  }
  // the static fold's filter coefficients, fixed per thread: column j of
  // residue class r for item it = (tid + it*kThreads) = j + BLOCK*r
  constexpr int ITEMS = PH > 0 ? BLOCK * BB / kThreads : 1;
  constexpr int U = PH > 0 ? K / BB : 1;
  float fc[ITEMS][PH > 0 ? PH : 1];
  if constexpr (PH > 0) {
    static_assert(ITEMS * kThreads == BLOCK * BB && U * BB == K, "analysis: fold tiling");
#pragma unroll
    for (int it = 0; it < ITEMS; ++it) {
      const int j = (tid + it * kThreads) % BLOCK;
#pragma unroll
      for (int m = 0; m < PH; ++m) fc[it][m] = f2d[m * BLOCK + j];
    }
  }
  __syncthreads();
  if (tid < 32) {
    for (int s = 0; s < stages; ++s) {
      const int t = blockIdx.x + s * gridDim.x;
      if (t < n_tiles) issue_span(bufs + s * buf_f2, soff + s, bar + s, x, sp, t);
    }
  }

  constexpr int ITG = PH > 0 ? 1 : K * BLOCK / kThreads;
  for (int it = 0, tile = blockIdx.x; tile < n_tiles; ++it, tile += gridDim.x) {
    const int b = stages == 2 ? (it & 1) : 0;
    const int use = stages == 2 ? (it >> 1) : it;
    const int pol = tile / sp.n_kt;
    const int k0 = (tile - pol * sp.n_kt) * K;
    if (tid < K) rowoff[tid] = ((k0 + tid + b0) % period) * BLOCK;
    float2* buf = bufs + b * buf_f2;
    mbar_wait(bar + b, use & 1);
    __syncthreads();
    const float2* span = buf + soff[b];

    // fold into registers
    float2 fold[PH > 0 ? ITEMS : ITG][PH > 0 ? U : 1];
    if constexpr (PH > 0) {
      constexpr int STEP = SB * BLOCK / BB;
      constexpr int ROWS = SB * (U - 1) + PH;
#pragma unroll
      for (int it2 = 0; it2 < ITEMS; ++it2) {
        const int item = tid + it2 * kThreads;
        const int j = item % BLOCK;
        const int r = item / BLOCK;
        const float2* src = span + r * STEP + j;
#pragma unroll
        for (int u = 0; u < U; ++u) fold[it2][u] = make_float2(0.f, 0.f);
#pragma unroll
        for (int i = 0; i < ROWS; ++i) {
          const float2 v = src[i * BLOCK];
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const int m = i - SB * u;
            if (m >= 0 && m < PH) {
              fold[it2][u].x = fmaf(fc[it2][m], v.x, fold[it2][u].x);
              fold[it2][u].y = fmaf(fc[it2][m], v.y, fold[it2][u].y);
            }
          }
        }
      }
    } else {
#pragma unroll
      for (int it2 = 0; it2 < ITG; ++it2) {
        const int item = tid + it2 * kThreads;
        const int j = item % BLOCK;
        const int kk = item / BLOCK;
        const float2* src = span + kk * sp.step + j;
        float2 acc = make_float2(0.f, 0.f);
        for (int m = 0; m < phases; ++m) {
          const float f = __ldg(f2d + m * BLOCK + j);
          const float2 v = src[m * BLOCK];
          acc.x = fmaf(f, v.x, acc.x);
          acc.y = fmaf(f, v.y, acc.y);
        }
        fold[it2][0] = acc;
      }
    }
    __syncthreads();  // the span is dead: its buffer takes the folded rows

    // point j of spectrum kk -> sub-row kk*R + j/Q, position fft_reg_swizzle(j % Q)
    if constexpr (PH > 0) {
#pragma unroll
      for (int it2 = 0; it2 < ITEMS; ++it2) {
        const int item = tid + it2 * kThreads;
        const int j = item % BLOCK;
        const int r = item / BLOCK;
        const int pos = (j / Q) * LDQ + fft_reg_swizzle<LOGQ>(j % Q);
#pragma unroll
        for (int u = 0; u < U; ++u) buf[(r + BB * u) * R * LDQ + pos] = fold[it2][u];
      }
    } else {
#pragma unroll
      for (int it2 = 0; it2 < ITG; ++it2) {
        const int item = tid + it2 * kThreads;
        const int j = item % BLOCK;
        const int kk = item / BLOCK;
        buf[(kk * R + j / Q) * LDQ + fft_reg_swizzle<LOGQ>(j % Q)] = fold[it2][0];
      }
    }
    __syncthreads();

    // radix-R step over the Q-strided points into sub-row kr, times
    // w_block^(beta*kr); lanes on spectra
    if constexpr (R > 1) {
      for (int item = tid; item < K * Q; item += kThreads) {
        const int kk = item % K;
        const int beta = item / K;
        float2* p = buf + kk * R * LDQ + fft_reg_swizzle<LOGQ>(beta);
        float2 u[R];
#pragma unroll
        for (int a = 0; a < R; ++a) u[a] = p[a * LDQ];
        dft_radix<R, -1>(u);
        p[0] = u[0];
#pragma unroll
        for (int kr = 1; kr < R; ++kr) p[kr * LDQ] = c_mul(u[kr], twn[beta * kr]);
      }
      __syncthreads();
    }

    // the radix-8 passes (span H = Q / 8^(s+1)), lanes on sub-rows
#pragma unroll
    for (int s = 0; s < ND; ++s) {
      const int H = Q >> (3 * (s + 1));
      const float2* tws = tw + fft_reg_pass_tw(Q, s);
      for (int item = tid; item < NSR * PER; item += kThreads) {
        const int sr = item % NSR;
        const int u = item / NSR;
        const int grp = u / H;
        const int j = u - grp * H;
        const int off = grp * 8 * H + j;
        float2* row = buf + sr * LDQ;
        float2 w[8];
#pragma unroll
        for (int m = 0; m < 8; ++m) w[m] = row[fft_reg_swizzle<LOGQ>(off + H * m)];
        dft_reg<8, -1>(w);
        if (j != 0) {
#pragma unroll
          for (int d = 1; d < 8; ++d) w[d] = c_mul(w[d], tws[(d - 1) * H + j]);
        }
#pragma unroll
        for (int d = 0; d < 8; ++d) row[fft_reg_swizzle<LOGQ>(off + H * d)] = w[d];
      }
      __syncthreads();
    }

    // last pass, lanes on butterflies rev8(tq): channels kr + R*(tq +
    // SPAN*d), times the ramp row and the block gain
    const float gain = static_cast<float>(BLOCK);
    if constexpr (CM) {
      constexpr int ITL = NSR * SPAN / kThreads;
      constexpr int LDK = K + 1;
      static_assert(R == 1 && ITL * kThreads == NSR * SPAN, "analysis: channel-major tiling");
      float2 res[ITL][RL];
#pragma unroll
      for (int it2 = 0; it2 < ITL; ++it2) {
        const int item = tid + it2 * kThreads;
        const int kk = item / SPAN;
        const int tq = item - kk * SPAN;
        const float2* row = buf + kk * LDQ;
        const int base = fft_reg_rev8<ND>(tq) * RL;
        float2 w[RL];
#pragma unroll
        for (int m = 0; m < RL; ++m) w[m] = row[fft_reg_swizzle<LOGQ>(base + m)];
        dft_reg<RL, -1>(w);
        const float2* rr = rp + rowoff[kk];
#pragma unroll
        for (int d = 0; d < RL; ++d) {
          const int ch = tq + SPAN * d;
          res[it2][d] = c_scale(c_mul(w[d], rr[ch]), gain);
        }
      }
      __syncthreads();  // every row read: the buffer takes the (bin, spectrum) tile
#pragma unroll
      for (int it2 = 0; it2 < ITL; ++it2) {
        const int item = tid + it2 * kThreads;
        const int kk = item / SPAN;
        const int tq = item - kk * SPAN;
#pragma unroll
        for (int d = 0; d < RL; ++d) buf[(tq + SPAN * d) * LDK + kk] = res[it2][d];
      }
      __syncthreads();
      // a warp a row, lanes on spectra: row i of the output takes bin
      // rows[i] of the tile
      static_assert(K == 32, "analysis: channel-major rows of one warp");
      const int lane = tid & 31;
      if (k0 + lane < nblocks) {
        float2* op = out + (static_cast<long long>(pol) * n_rows) * nblocks + k0 + lane;
#pragma unroll 4
        for (int i = tid >> 5; i < n_rows; i += kThreads / 32) {
          op[static_cast<long long>(i) * nblocks] = buf[__ldg(rows + i) * LDK + lane];
        }
      }
    } else {
      for (int item = tid; item < NSR * SPAN; item += kThreads) {
        const int sr = item / SPAN;
        const int tq = item - sr * SPAN;
        const int kk = sr / R;
        const int kr = sr - kk * R;
        if (k0 + kk >= nblocks) continue;
        const float2* row = buf + sr * LDQ;
        const int base = fft_reg_rev8<ND>(tq) * RL;
        float2 w[RL];
#pragma unroll
        for (int m = 0; m < RL; ++m) w[m] = row[fft_reg_swizzle<LOGQ>(base + m)];
        dft_reg<RL, -1>(w);
        const float2* rr = rp + rowoff[kk];
        float2* op = out + (static_cast<long long>(pol) * nblocks + k0 + kk) * BLOCK;
#pragma unroll
        for (int d = 0; d < RL; ++d) {
          const int ch = kr + R * (tq + SPAN * d);
          op[ch] = c_scale(c_mul(w[d], rr[ch]), gain);
        }
      }
    }
    __syncthreads();  // the buffer is free: the span of the tile `stages` on
    if (tid < 32) {
      const int next = tile + stages * gridDim.x;
      if (next < n_tiles) issue_span(buf, soff + b, bar + b, x, sp, next);
    }
  }
}

using AnalysisKern = void (*)(const float2*, float2*, const float*, const float2*,
                              const float2*, const float2*, Span, int, int, int, int, int,
                              int, int, int, const int*, int);

// block = r * 2^logq; the low geometry (block 256, 13 phases, step 192) has
// its own fold. The channel-major store (cm) exists for block 256 on the
// generic fold alone.
static AnalysisKern pick_kernel(int r, int logq, int phases, int step, bool cm) {
  const bool low_fold = r == 1 && logq == 8 && phases == 13 && step == 192;
  if (cm) {
    return r == 1 && logq == 8 && !low_fold ? analysis_fused_kernel<1, 8, 0, 0, 0, true>
                                            : nullptr;
  }
  if (low_fold) return analysis_fused_kernel<1, 8, 13, 3, 4>;
  if (r == 1) {
    switch (logq) {
      case 7: return analysis_fused_kernel<1, 7, 0, 0, 0>;
      case 8: return analysis_fused_kernel<1, 8, 0, 0, 0>;
      case 9: return analysis_fused_kernel<1, 9, 0, 0, 0>;
      case 10: return analysis_fused_kernel<1, 10, 0, 0, 0>;
      default: return nullptr;
    }
  }
  if (r == 3 && logq == 7) return analysis_fused_kernel<3, 7, 0, 0, 0>;
  if (r == 3 && logq == 8) return analysis_fused_kernel<3, 8, 0, 0, 0>;
  return nullptr;
}

// Shared memory of a block of `stages` span buffers (the layout of
// analysis_fused_kernel; mirrored by ops/kernels/analysis_fused.py
// smem_bytes): the header, the buffers (a span plus one sample, the
// folded sub-rows or, for the channel-major store, the (bin, spectrum)
// tile, whichever is largest, in 16-byte units), the pass table, w_block
// (r > 1) and the ramp where staged.
static size_t analysis_smem(int r, int logq, int step, int phases, int period, int stages,
                            bool cm, int* buf_f2, int* ramp_staged) {
  const int q = 1 << logq;
  const int block = r * q;
  const int k = tile_spectra(block);
  const long long span = static_cast<long long>(k - 1) * step +
                         static_cast<long long>(phases) * block + 1;
  const long long sub_rows = static_cast<long long>(k) * r * (q + 1);
  const long long tile = cm ? static_cast<long long>(block) * (k + 1) : 0;
  const long long rows = sub_rows > tile ? sub_rows : tile;
  const long long f2 = ((span > rows ? span : rows) + 1) / 2 * 2;
  const int last = q >> (3 * ((logq + 2) / 3 - 1));
  const long long ramp_bytes = static_cast<long long>(period) * block * 8;
  *ramp_staged = ramp_bytes <= kRampStage;
  *buf_f2 = static_cast<int>(f2 < (1 << 30) ? f2 : (1 << 30));
  return kHeader + static_cast<size_t>((stages * f2 + (q - last) + (r > 1 ? block : 0)) * 8) +
         (*ramp_staged ? static_cast<size_t>(ramp_bytes) : 0);
}

// x: (n_pol, n_dat) complex64, pol_stride elements between polarizations
// (>= n_dat), samples contiguous; out: (n_pol, nblocks, block) complex64,
// or with rows (n_rows int32 bins, 1 <= n_rows <= block, each < block) the
// channel-major (n_pol, n_rows, nblocks), row i bin rows[i];
// f2d: (phases, block) float32; tw_pass: the per-pass table of the Q-point
// forward transform (fft_reg_pass_tw); tw_n: (block,) exp(-2*pi*i*m/block),
// read only when r > 1; ramp: (period, block) complex64; 0 <= b0 = block0
// mod period < period. block = r * 2^logq, r in {1, 3}, 128 <= block <=
// 1024. Two span buffers where they fit in `smem_limit` bytes, else one.
// One persistent thread block per resident slot.
extern "C" int analysis_fused_launch(const void* x, void* out, const void* f2d,
                                     const void* tw_pass, const void* tw_n, const void* ramp,
                                     const void* rows, int n_pol, long long n_dat,
                                     long long pol_stride, int nblocks, int block,
                                     int r, int logq, int step, int phases, int period,
                                     int b0, int n_rows, int smem_limit, void* stream) {
  const bool cm = rows != nullptr;
  const AnalysisKern kern = pick_kernel(r, logq, phases, step, cm);
  if (kern == nullptr || (r << logq) != block || n_pol <= 0 || nblocks <= 0 || step <= 0 ||
      (cm && (n_rows <= 0 || n_rows > block)) ||
      (n_pol > 1 && pol_stride < n_dat) ||
      phases <= 0 || period <= 0 || b0 < 0 || b0 >= period ||
      static_cast<long long>(nblocks - 1) * step + static_cast<long long>(phases) * block >
          n_dat) {
    return cudaErrorInvalidValue;
  }
  int buf_f2 = 0, ramp_staged = 0, stages = 2;
  size_t smem = analysis_smem(r, logq, step, phases, period, 2, cm, &buf_f2, &ramp_staged);
  if (smem > static_cast<size_t>(smem_limit)) {
    stages = 1;
    smem = analysis_smem(r, logq, step, phases, period, 1, cm, &buf_f2, &ramp_staged);
    if (smem > static_cast<size_t>(smem_limit)) return cudaErrorInvalidValue;
  }
  const int k = tile_spectra(block);
  const int n_kt = (nblocks + k - 1) / k;
  const long long n_tiles = static_cast<long long>(n_pol) * n_kt;
  if (n_tiles > (1LL << 30)) return cudaErrorInvalidValue;
  // the allowance is the card's limit, so one preparation serves every
  // geometry of a kernel; 512 threads of over 64 registers hold an SM alone
  int slots = 0;
  const cudaError_t e =
      prepare_persistent(reinterpret_cast<const void*>(kern), kThreads, smem_limit, &slots);
  if (e != cudaSuccess) return e;
  const Span sp = {n_dat, pol_stride, step, (k - 1) * step + phases * block, n_kt, k};
  const int tiles = static_cast<int>(n_tiles);
  kern<<<tiles < slots ? tiles : slots, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(x), static_cast<float2*>(out),
      static_cast<const float*>(f2d), static_cast<const float2*>(tw_pass),
      static_cast<const float2*>(tw_n), static_cast<const float2*>(ramp), sp, nblocks, phases,
      period, b0, tiles, buf_f2, stages, ramp_staged, static_cast<const int*>(rows), n_rows);
  return cudaGetLastError();
}
