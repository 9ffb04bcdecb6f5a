// Fused channel DFT + derotation constant of the zero-padded (SKA-Mid)
// analysis: the stage between the fold (analysis_padded_fused.cu) and the
// inversion frontend.
//
// Replaces the Pallas kernel of
//   ska_pst_dsp_tpu/ops/pallas/chan_dft_fused.py::chan_dft_ramp
//   (kern, launched by its pallas_call).
//
//   out[p, (k - delay) mod nb, q] = cst[(k + block0) % nu, q]
//                                   * sum_j g[p, k, j] * w^(j*q),
//   w = exp(-2*pi*i/block)
//
// cst carries block * exp(-2*pi*i*q/block) (reverse + block^2 * IFFT of
// the reference as a forward FFT) times the derotation ramp; the
// group-delay roll of the padded analysis is the output row index, so no
// separate pass moves the stream.
//
// What bounds it on the H100: bytes. A 4096-point spectrum is ~0.25 Mflop
// of FFT against 32 KB in and 32 KB out, ~4 flop per byte, under the fp32
// ridge of ~20; the mid stage (2 x 1280 spectra) must move 168 MB, 0.050 ms
// at 3.35 TB/s. The first version ran each spectrum as twelve radix-2
// shared-memory passes with a barrier each, read its outputs back through a
// bit-reversed gather and reduced a 64-bit index per element; it took 6.8x
// that bound.
//
// Design (block = r * Q, Q = 2^logq, r in {1, 3}):
//   * a tile is 4096 points: one spectrum at mid, 4096 / block spectra for
//     a smaller block. One persistent 512-thread block per resident slot
//     (two per SM at mid) walks over the tiles;
//   * r = 1: each thread owns one radix-8 butterfly of the first pass. It
//     loads its 8 points g[k, t + m*Q/8] straight from global memory into
//     registers (neighbouring threads on neighbouring addresses), runs the
//     radix-8 DFT and twiddle there and writes the results to shared
//     memory; it then loads the next tile's points into the same registers,
//     so those loads are in flight while the current tile runs its other
//     passes. r = 3 (block 3072): a radix-3 step over the three sub-rows of
//     Q, from global memory, comes first;
//   * the other passes are fft_reg.cuh radix-8 passes (4096 = 8^4: three
//     shared-memory exchanges), their twiddles read from the per-pass table
//     (neighbouring threads, neighbouring entries);
//   * the last pass gives thread t the butterfly rev8(t), whose outputs are
//     channels t + Q/r_last * d: the store from registers lands in channel
//     order, 32 consecutive channels per warp, times the constant row. An
//     XOR swizzle of the points' low bits by their high bits (chan_phys)
//     keeps every pass's shared-memory accesses free of bank conflicts, so
//     no padding is needed and the output is never staged;
//   * the constant row (k + block0) % nu and the output row (k - delay)
//     mod nb are computed once per spectrum, in 32-bit integers (block0 is
//     reduced modulo nu on the host);
//   * two shared-memory buffers alternate between tiles, so a tile's first
//     pass need not wait for the previous tile's last reads.
// fp32 SIMT arithmetic throughout: the stage is bound by bytes, so tensor
// cores would buy nothing, and TF32 or bf16 inputs would spoil the -60 dB
// purity.
#include "fft_reg.cuh"

constexpr int kThreads = 512;
constexpr int kPoints = 4096;  // points per tile

// Position of point p of a Q-point sub-row (a bijection: the low four bits
// are XORed with bits above them). Bits LOGQ-3.. of p go to slot bits 0-2
// and bit 6 to slot bit 3: the last pass's threads, on the top digit and on
// bit 6, and the span-8 pass's, on bits 0-2 and 6, then fall in 16
// distinct eight-byte slots per half-warp.
template <int LOGQ>
__device__ __forceinline__ int chan_phys(int p) {
  return p ^ (((p >> (LOGQ - 3)) & 7) | (((p >> 6) & 1) << 3));
}

// The 8 first-pass points of thread tid in tile `tile` (r = 1).
template <int LOGQ, int S>
__device__ __forceinline__ void chan_load(float2 (&v)[8], const float2* g, int tile,
                                          int n_spec) {
  constexpr int Q = 1 << LOGQ;
  constexpr int PER = Q / 8;
  const int si = threadIdx.x / PER;
  const int j = threadIdx.x - si * PER;
  const int s = tile * S + si;
  if (si < S && s < n_spec) {
    const float2* gs = g + static_cast<long long>(s) * Q + j;
#pragma unroll
    for (int m = 0; m < 8; ++m) v[m] = gs[m * PER];
  } else {
#pragma unroll
    for (int m = 0; m < 8; ++m) v[m] = make_float2(0.f, 0.f);
  }
}

template <int R, int LOGQ>
__global__ void __launch_bounds__(kThreads, 2)
chan_dft_kernel(const float2* __restrict__ g, float2* __restrict__ out,
                const float2* __restrict__ tw_pass, const float2* __restrict__ tw_n,
                const float2* __restrict__ cst, int n_spec, int nb, int nu, int b0,
                int delay) {
  using Plan = FftRegPlan<LOGQ>;
  constexpr int Q = Plan::kQ;
  constexpr int N = R * Q;
  constexpr int S = kPoints / N;  // spectra per tile
  constexpr int ROWS = S * R;     // Q-point sub-rows per tile
  constexpr int PER = Q / 8;      // radix-8 butterflies per sub-row
  constexpr int RL = Plan::kLast;
  constexpr int ND = Plan::kDigits;
  constexpr int SPAN = Q / RL;    // last-pass butterflies per sub-row
  static_assert(S >= 1 && S * PER <= kThreads, "chan_dft: tiling");
  extern __shared__ float2 smem[];
  float2* tw = smem;
  float2* twn = tw + Plan::kTw;
  float2* bufs = twn + (R > 1 ? N : 0);
  // per buffer and spectrum of the tile: output offset (-1: none), constant offset
  long long* meta = reinterpret_cast<long long*>(bufs + 2 * ROWS * Q);
  const int tid = threadIdx.x;
  const int n_tiles = (n_spec + S - 1) / S;
  int tile = blockIdx.x;
  float2 v[8];
  if constexpr (R == 1) {
    if (tile < n_tiles) chan_load<LOGQ, S>(v, g, tile, n_spec);
  }
  for (int i = tid; i < Plan::kTw; i += kThreads) tw[i] = tw_pass[i];
  if constexpr (R > 1) {
    for (int i = tid; i < N; i += kThreads) twn[i] = tw_n[i];
  }
  __syncthreads();

  for (int par = 0; tile < n_tiles; tile += gridDim.x, par ^= 1) {
    float2* buf = bufs + par * ROWS * Q;
    long long* mt = meta + par * 2 * S;
    if (tid < S) {
      const int s = tile * S + tid;
      long long o = -1, c = 0;
      if (s < n_spec) {
        const int pol = s / nb;
        const int k = s - pol * nb;
        int ko = k - delay;
        if (ko < 0) ko += nb;
        o = (static_cast<long long>(pol) * nb + ko) * N;
        c = static_cast<long long>((k + b0) % nu) * N;
      }
      mt[2 * tid] = o;
      mt[2 * tid + 1] = c;
    }
    if constexpr (R == 1) {
      // first radix-8 pass (span Q/8) from the registers loaded last round
      if (tid < S * PER) {
        const int si = tid / PER;
        const int j = tid - si * PER;
        dft_reg<8, -1>(v);
        if (j != 0) {
#pragma unroll
          for (int d = 1; d < 8; ++d) v[d] = c_mul(v[d], tw[(d - 1) * PER + j]);
        }
        float2* row = buf + si * Q;
#pragma unroll
        for (int d = 0; d < 8; ++d) row[chan_phys<LOGQ>(j + PER * d)] = v[d];
      }
      if (tile + gridDim.x < n_tiles) chan_load<LOGQ, S>(v, g, tile + gridDim.x, n_spec);
    } else {
      // radix-R step over the Q-strided points, times w_N^(beta*kr), into
      // sub-row kr
      for (int item = tid; item < S * Q; item += kThreads) {
        const int si = item / Q;
        const int beta = item - si * Q;
        const int s = tile * S + si;
        float2 u[R];
#pragma unroll
        for (int a = 0; a < R; ++a) {
          u[a] = s < n_spec ? g[static_cast<long long>(s) * N + beta + Q * a]
                            : make_float2(0.f, 0.f);
        }
        dft_radix<R, -1>(u);
        float2* rows = buf + si * R * Q;
        rows[chan_phys<LOGQ>(beta)] = u[0];
#pragma unroll
        for (int kr = 1; kr < R; ++kr) {
          rows[kr * Q + chan_phys<LOGQ>(beta)] = c_mul(u[kr], twn[beta * kr]);
        }
      }
    }
    __syncthreads();

    // the remaining radix-8 passes, span H = Q / 8^(s+1)
#pragma unroll
    for (int s = (R == 1 ? 1 : 0); s < ND; ++s) {
      const int H = Q >> (3 * (s + 1));
      const float2* tws = tw + fft_reg_pass_tw(Q, s);
      for (int item = tid; item < ROWS * PER; item += kThreads) {
        const int rw = item / PER;
        const int u = item - rw * PER;
        const int grp = u / H;
        const int j = u - grp * H;
        float2* row = buf + rw * Q;
        const int off = grp * 8 * H + j;
        float2 w[8];
#pragma unroll
        for (int m = 0; m < 8; ++m) w[m] = row[chan_phys<LOGQ>(off + H * m)];
        dft_reg<8, -1>(w);
        if (j != 0) {
#pragma unroll
          for (int d = 1; d < 8; ++d) w[d] = c_mul(w[d], tws[(d - 1) * H + j]);
        }
#pragma unroll
        for (int d = 0; d < 8; ++d) row[chan_phys<LOGQ>(off + H * d)] = w[d];
      }
      __syncthreads();
    }

    // last pass: thread on tq takes butterfly rev8(tq), whose outputs are
    // kq = tq + SPAN*d, channel kr + R*kq; stored times the constant row
    for (int item = tid; item < ROWS * SPAN; item += kThreads) {
      const int rw = item / SPAN;
      const int tq = item - rw * SPAN;
      const int si = rw / R;
      const int kr = rw - si * R;
      const long long o = mt[2 * si];
      if (o < 0) continue;
      const float2* cr = cst + mt[2 * si + 1];
      float2* op = out + o;
      const float2* row = buf + rw * Q;
      const int base = fft_reg_rev8<ND>(tq) * RL;
      float2 w[RL];
#pragma unroll
      for (int m = 0; m < RL; ++m) w[m] = row[chan_phys<LOGQ>(base + m)];
      dft_reg<RL, -1>(w);
#pragma unroll
      for (int d = 0; d < RL; ++d) {
        const int ch = kr + R * (tq + SPAN * d);
        op[ch] = c_mul(w[d], __ldg(cr + ch));
      }
    }
  }
}

using ChanDftKern = void (*)(const float2*, float2*, const float2*, const float2*,
                             const float2*, int, int, int, int, int);

// block = r * 2^logq: 512, 1024, 2048, 4096 (r = 1) or 3072 (r = 3).
static ChanDftKern pick_kernel(int r, int logq) {
  if (r == 1) {
    switch (logq) {
      case 9: return chan_dft_kernel<1, 9>;
      case 10: return chan_dft_kernel<1, 10>;
      case 11: return chan_dft_kernel<1, 11>;
      case 12: return chan_dft_kernel<1, 12>;
      default: return nullptr;
    }
  }
  if (r == 3 && logq == 10) return chan_dft_kernel<3, 10>;
  return nullptr;
}

static size_t chan_dft_smem(int r, int logq) {
  const int q = 1 << logq;
  const int n = r * q;
  const int spec = kPoints / n;
  const int last = q >> (3 * ((logq + 2) / 3 - 1));
  return static_cast<size_t>(q - last + (r > 1 ? n : 0) + 2 * spec * r * q) * sizeof(float2) +
         4 * spec * sizeof(long long);
}

// g, out: (n_pol, nb, block) complex64; tw_pass: the per-pass table of the
// Q-point forward transform (fft_reg_pass_tw, Q - r_last entries); tw_n:
// (block,) exp(-2*pi*i*m/block), read only when r > 1; cst: (nu, block)
// complex64. block = r * 2^logq; 0 <= b0 = block0 mod nu < nu;
// 0 <= delay < nb. One persistent thread block per resident slot.
extern "C" int chan_dft_launch(const void* g, void* out, const void* tw_pass,
                               const void* tw_n, const void* cst, int n_pol, int nb,
                               int block, int r, int logq, int nu, int b0, int delay,
                               void* stream) {
  const ChanDftKern kern = pick_kernel(r, logq);
  if (kern == nullptr || (r << logq) != block || n_pol <= 0 || nb <= 0 || nu <= 0 ||
      b0 < 0 || b0 >= nu || delay < 0 || delay >= nb ||
      static_cast<long long>(n_pol) * nb > (1LL << 30)) {
    return cudaErrorInvalidValue;
  }
  const size_t smem = chan_dft_smem(r, logq);
  int slots = 0;
  const cudaError_t e =
      prepare_persistent(reinterpret_cast<const void*>(kern), kThreads, smem, &slots);
  if (e != cudaSuccess) return e;
  const int n_spec = n_pol * nb;
  const int spec = kPoints / block;
  const int tiles = (n_spec + spec - 1) / spec;
  kern<<<tiles < slots ? tiles : slots, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(g), static_cast<float2*>(out),
      static_cast<const float2*>(tw_pass), static_cast<const float2*>(tw_n),
      static_cast<const float2*>(cst), n_spec, nb, nu, b0, delay);
  return cudaGetLastError();
}
