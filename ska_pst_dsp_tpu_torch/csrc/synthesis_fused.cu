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
// What bounds it on the H100: bytes. It must read the stream once and
// write FN_width/keep of it (low: L = 256, keep = 160, FN_width = 192; mid:
// L = 512, keep = 256, FN_width = 448); an L-point FFT per channel and
// block is ~3 flop per byte, under the fp32 ridge of ~20. The first version
// staged every frame transposed into shared memory, ran the FFT as eight or
// nine radix-2 passes with a barrier each, computed all L bins and read
// them back through bit-reversed positions; it took 5.1x (low) and 6.4x
// (mid) that bound.
//
// Design (L = 2^logL, 128 <= L <= 512):
//   * a tile is one overlap-save block b of one polarization and 32
//     channels, so that a warp reads 256 contiguous bytes of one time row
//     of the time-major (pol, time, chan) stream. Strides are arguments: a
//     channel-major stream or a sample_offset view needs no copy;
//   * one persistent 512-thread block per SM walks over the tiles, block b
//     fastest, so the tiles in flight at once share their overlapping
//     frames through L2;
//   * first pass: lane c of a warp owns channel c of the tile (perm[c] read
//     once per tile) and the radix-8 butterflies of span L/8; it loads their
//     8 time samples from global memory into registers, tapers them there,
//     runs the DFT and twiddle and writes one row per channel to shared
//     memory. It then loads the next tile's samples into the same
//     registers, in flight while the current tile runs its other passes;
//   * the middle radix-8 pass (fft_reg.cuh) keeps lanes on channels: rows
//     of L + 1 points (odd), so 32 channels at one offset hit 32 banks, and
//     every twiddle read is a broadcast;
//   * the last pass is the transpose: lanes move to bins. Thread tq of a
//     channel takes butterfly rev8(tq), whose outputs are bins
//     tq + (L/r_last)*d, so a warp holds 32 consecutive bins. It stores
//     only the FN_width kept bins j = (k - kpos) mod L, times dr[j], in
//     (pol, block, chan, j) order: 256 contiguous bytes per warp. The L -
//     FN_width discarded bins are never stored. An XOR swizzle of each row
//     (fft_reg_swizzle) keeps these reads free of bank conflicts.
// Two shared-memory round trips per point (three passes); fp32 SIMT
// arithmetic throughout.
#include "fft_reg.cuh"

constexpr int kThreads = 512;
constexpr int kChan = 32;  // channels per tile

// The first-pass samples of lane c (channel c0 + c) in the tile (pol, b,
// c0): v[it][m] = x[pol, b*keep + j + m*L/8, perm[c0 + c]], j = warp +
// 16*it; zeros for a channel past n_chan.
template <int LOGL, int IT>
__device__ __forceinline__ void frontend_load(float2 (&v)[IT][8], const float2* x,
                                              const int* perm, long long sp, long long st,
                                              long long sc, int n_chan, int n_blocks,
                                              int n_ct, int keep, int tile) {
  constexpr int PER = (1 << LOGL) / 8;
  const int b = tile % n_blocks;
  const int rest = tile / n_blocks;
  const int pol = rest / n_ct;
  const int c = (rest - pol * n_ct) * kChan + (threadIdx.x & 31);
  if (c < n_chan) {
    const float2* xb = x + pol * sp + static_cast<long long>(b) * keep * st +
                       static_cast<long long>(__ldg(perm + c)) * sc;
#pragma unroll
    for (int it = 0; it < IT; ++it) {
      const int j = (threadIdx.x >> 5) + it * (kThreads / 32);
#pragma unroll
      for (int m = 0; m < 8; ++m) v[it][m] = xb[static_cast<long long>(j + PER * m) * st];
    }
  } else {
#pragma unroll
    for (int it = 0; it < IT; ++it) {
#pragma unroll
      for (int m = 0; m < 8; ++m) v[it][m] = make_float2(0.f, 0.f);
    }
  }
}

template <int LOGL>
__global__ void __launch_bounds__(kThreads, 1)
synthesis_frontend_kernel(const float2* __restrict__ x, float2* __restrict__ out,
                          const float* __restrict__ taper, const float* __restrict__ dr,
                          const int* __restrict__ perm, const float2* __restrict__ tw_pass,
                          long long sp, long long st, long long sc, int n_chan,
                          int n_blocks, int n_ct, int n_tiles, int keep, int kpos,
                          int fnw) {
  using Plan = FftRegPlan<LOGL>;
  constexpr int L = Plan::kQ;
  constexpr int PER = L / 8;
  constexpr int RL = Plan::kLast;
  constexpr int ND = Plan::kDigits;
  constexpr int SPAN = L / RL;  // last-pass butterflies per row
  constexpr int LD = L + 1;     // odd row stride
  constexpr int IT = kChan * PER / kThreads;
  static_assert(IT >= 1 && IT * kThreads == kChan * PER, "frontend: tiling");
  extern __shared__ float2 smem[];
  float2* tw = smem;
  float2* buf = tw + Plan::kTw;
  float* tap = reinterpret_cast<float*>(buf + kChan * LD);
  float* drs = tap + L;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  int tile = blockIdx.x;
  float2 v[IT][8];
  if (tile < n_tiles) {
    frontend_load<LOGL, IT>(v, x, perm, sp, st, sc, n_chan, n_blocks, n_ct, keep, tile);
  }
  for (int i = tid; i < Plan::kTw; i += kThreads) tw[i] = tw_pass[i];
  for (int i = tid; i < L; i += kThreads) tap[i] = taper[i];
  for (int i = tid; i < fnw; i += kThreads) drs[i] = dr[i];
  __syncthreads();

  for (; tile < n_tiles; tile += gridDim.x) {
    const int b = tile % n_blocks;
    const int rest = tile / n_blocks;
    const int pol = rest / n_ct;
    const int c0 = (rest - pol * n_ct) * kChan;

    // first radix-8 pass (span L/8): taper, DFT, twiddle, into row `lane`
    float2* row = buf + lane * LD;
#pragma unroll
    for (int it = 0; it < IT; ++it) {
      const int j = (tid >> 5) + it * (kThreads / 32);
#pragma unroll
      for (int m = 0; m < 8; ++m) v[it][m] = c_scale(v[it][m], tap[j + PER * m]);
      dft_reg<8, -1>(v[it]);
      if (j != 0) {
#pragma unroll
        for (int d = 1; d < 8; ++d) v[it][d] = c_mul(v[it][d], tw[(d - 1) * PER + j]);
      }
#pragma unroll
      for (int d = 0; d < 8; ++d) row[fft_reg_swizzle<LOGL>(j + PER * d)] = v[it][d];
    }
    if (tile + gridDim.x < n_tiles) {
      frontend_load<LOGL, IT>(v, x, perm, sp, st, sc, n_chan, n_blocks, n_ct, keep,
                              tile + gridDim.x);
    }
    __syncthreads();

    // middle radix-8 passes (span H = L / 8^(s+1)), lanes on channels
#pragma unroll
    for (int s = 1; s < ND; ++s) {
      const int H = L >> (3 * (s + 1));
      const float2* tws = tw + fft_reg_pass_tw(L, s);
      for (int item = tid; item < kChan * PER; item += kThreads) {
        const int u = item >> 5;
        const int grp = u / H;
        const int j = u - grp * H;
        const int off = grp * 8 * H + j;
        float2 w[8];
#pragma unroll
        for (int m = 0; m < 8; ++m) w[m] = row[fft_reg_swizzle<LOGL>(off + H * m)];
        dft_reg<8, -1>(w);
        if (j != 0) {
#pragma unroll
          for (int d = 1; d < 8; ++d) w[d] = c_mul(w[d], tws[(d - 1) * H + j]);
        }
#pragma unroll
        for (int d = 0; d < 8; ++d) row[fft_reg_swizzle<LOGL>(off + H * d)] = w[d];
      }
      __syncthreads();
    }

    // last pass, lanes on bins: butterfly rev8(tq) of channel c holds bins
    // k = tq + SPAN*d; store the kept ones, j = (k - kpos) mod L < fnw
    float2* ob = out + (static_cast<long long>(pol * n_blocks + b) * n_chan + c0) * fnw;
    for (int item = tid; item < kChan * SPAN; item += kThreads) {
      const int c = item / SPAN;
      const int tq = item - c * SPAN;
      if (c0 + c >= n_chan) continue;
      const float2* rc = buf + c * LD;
      const int base = fft_reg_rev8<ND>(tq) * RL;
      float2 w[RL];
#pragma unroll
      for (int m = 0; m < RL; ++m) w[m] = rc[fft_reg_swizzle<LOGL>(base + m)];
      dft_reg<RL, -1>(w);
      float2* oc = ob + static_cast<long long>(c) * fnw;
#pragma unroll
      for (int d = 0; d < RL; ++d) {
        int j = tq + SPAN * d - kpos;
        if (j < 0) j += L;
        if (j < fnw) oc[j] = c_scale(w[d], drs[j]);
      }
    }
    __syncthreads();
  }
}

using FrontendKern = void (*)(const float2*, float2*, const float*, const float*,
                              const int*, const float2*, long long, long long, long long,
                              int, int, int, int, int, int, int);

static FrontendKern pick_kernel(int logl) {
  switch (logl) {
    case 7: return synthesis_frontend_kernel<7>;
    case 8: return synthesis_frontend_kernel<8>;
    case 9: return synthesis_frontend_kernel<9>;
    default: return nullptr;
  }
}

static size_t frontend_smem(int logl) {
  const int l = 1 << logl;
  const int last = l >> (3 * ((logl + 2) / 3 - 1));
  return static_cast<size_t>(l - last + kChan * (l + 1)) * sizeof(float2) +
         2 * static_cast<size_t>(l) * sizeof(float);
}

// x: complex64 stream with element strides (sp, st, sc) over (pol, time,
// chan); out: (n_pol, n_blocks, n_chan, fnw) complex64; taper: (L,)
// float32; dr: (fnw,) float32; perm: (n_chan,) int32; tw_pass: the per-pass
// table of the L-point forward transform (fft_reg_pass_tw). L = 2^logl,
// 128 <= L <= 512; every frame b*keep + [0, L) must lie inside the stream.
// One persistent thread block per resident slot.
extern "C" int synthesis_fused_launch(const void* x, void* out, const void* taper,
                                      const void* dr, const void* perm,
                                      const void* tw_pass, long long sp, long long st,
                                      long long sc, int n_pol, int n_chan, int n_blocks,
                                      int L, int logl, int keep, int kpos, int fnw,
                                      void* stream) {
  const FrontendKern kern = pick_kernel(logl);
  const int n_ct = (n_chan + kChan - 1) / kChan;
  if (kern == nullptr || (1 << logl) != L || n_pol <= 0 || n_chan <= 0 ||
      n_blocks <= 0 || fnw <= 0 || fnw > L || kpos < 0 || kpos >= L ||
      static_cast<long long>(n_pol) * n_ct * n_blocks > (1LL << 30)) {
    return cudaErrorInvalidValue;
  }
  const size_t smem = frontend_smem(logl);
  int slots = 0;
  const cudaError_t e =
      prepare_persistent(reinterpret_cast<const void*>(kern), kThreads, smem, &slots);
  if (e != cudaSuccess) return e;
  const int tiles = n_pol * n_ct * n_blocks;
  kern<<<tiles < slots ? tiles : slots, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(x), static_cast<float2*>(out),
      static_cast<const float*>(taper), static_cast<const float*>(dr),
      static_cast<const int*>(perm), static_cast<const float2*>(tw_pass), sp, st, sc,
      n_chan, n_blocks, n_ct, tiles, keep, kpos, fnw);
  return cudaGetLastError();
}
