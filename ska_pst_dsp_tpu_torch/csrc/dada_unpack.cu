// The DADA ingest engine on the card: raw file words -> complex64 planes
// (two unpacks) and complex64 planes -> raw file words (the pack).
//
// Replaces the host C++ engine of the JAX package (native/dada_engine.cpp,
// bound by ska_pst_dsp_tpu/io/native.py), which is not a Pallas kernel:
//   * dada_unpack_kernel:  convert_tfp_to_pft (:75-93) under
//     dada_read_split (:137-171);
//   * lowcbf_unpack_kernel: lowcbf_read_split (:209-250);
//   * dada_pack_kernel:    convert_pft_to_tfp (:95-118) under
//     dada_write_split (:173-207).
//
// A DADA file stores TFP words: the pair (re, im) of time sample t, column
// c = f * npol + p (channel f, polarization p) at pair index t * w + c,
// w = npol * nchan, as int8, int16, float32 or float64. The port's planes
// are complex64 (P, F, T): row p * nchan + f, sample t. A LowCBF heap file
// stores 32-sample heaps, each heap FPT packets with t fastest: pair
// (h * w + f * npol + p) * 32 + t is sample h * 32 + t.
//
//   unpack: out[p * nchan + f][t] = (float(re), float(im))   (float64
//           rounds to nearest, as static_cast<float>)
//   pack:   word = T(v), v = x * scale, and for NBIT 8 / 16
//           v = min(max(rint(v), lo), hi): round half to even, as
//           std::nearbyint in the default rounding mode, then the clip
//
// What bounds them on the H100: bytes. Each moves its input once and its
// output once and does one conversion a word; at 2 pol x 2^23 samples the
// unpack reads 32 / 64 / 128 MB (NBIT 8 / 16 / 32) and writes 128 MB.
//
// Design (simple and right first):
//   * the two TFP kernels are a tiled transpose through shared memory: a
//     tile holds 1024 complex samples, tc columns by tt = 1024 / tc
//     samples, tc = min(32, next power of two >= w) (the host picks
//     log2 tc: ops/kernels/dada_unpack.py::tile_columns), so a stream of
//     one or two columns still fills its tiles. The TFP side walks the
//     tile column fastest and the PFT side sample fastest, so both sides'
//     global accesses are contiguous within a tile row; the shared tile
//     has rows of tt + 1 samples. Ragged tiles (count or w not a multiple
//     of the tile) are masked;
//   * a word pair is one load or store (char2, short2, float2, double2):
//     the raw pointer must be aligned to a pair, which the wrapper checks;
//   * the LowCBF unpack needs no transpose: a packet of 32 samples lands on
//     32 contiguous samples of one row, so one thread a pair, grid-stride.
#include <cuda_runtime.h>

#include <cstdint>

constexpr int kThreads = 256;
constexpr int kTile = 1024;      // complex samples per tile
constexpr int kLogTile = 10;
constexpr int kHeap = 32;        // samples per LowCBF heap packet

// The word and word-pair types of an NBIT; the integer NBITs quantise on
// the write, into [kLo, kHi].
template <int kNbit> struct Word;
template <> struct Word<8> {
  using T = int8_t;
  using Pair = char2;
  static constexpr bool kQuant = true;
  static constexpr float kLo = -128.f, kHi = 127.f;
};
template <> struct Word<16> {
  using T = int16_t;
  using Pair = short2;
  static constexpr bool kQuant = true;
  static constexpr float kLo = -32768.f, kHi = 32767.f;
};
template <> struct Word<32> {
  using T = float;
  using Pair = float2;
  static constexpr bool kQuant = false;
  static constexpr float kLo = 0.f, kHi = 0.f;
};
template <> struct Word<64> {
  using T = double;
  using Pair = double2;
  static constexpr bool kQuant = false;
  static constexpr float kLo = 0.f, kHi = 0.f;
};

template <typename P>
__device__ __forceinline__ float2 to_float2(P v) {
  return make_float2(static_cast<float>(v.x), static_cast<float>(v.y));
}

template <int kNbit>
__device__ __forceinline__ typename Word<kNbit>::T to_word(float v, float scale) {
  using W = Word<kNbit>;
  v = v * scale;
  if (W::kQuant) v = fminf(fmaxf(rintf(v), W::kLo), W::kHi);
  return static_cast<typename W::T>(v);
}

template <int kNbit>
__global__ void __launch_bounds__(kThreads) dada_unpack_kernel(
    const typename Word<kNbit>::Pair* __restrict__ raw, float2* __restrict__ out, int npol,
    int nchan, long long count, int log_tc) {
  __shared__ float2 tile[kTile + 32];
  const int tc = 1 << log_tc;
  const int log_tt = kLogTile - log_tc;
  const int tt = 1 << log_tt;
  const int w = npol * nchan;
  const long long t0 = static_cast<long long>(blockIdx.x) << log_tt;
  const int c0 = blockIdx.y << log_tc;
  for (int i = threadIdx.x; i < kTile; i += kThreads) {
    const int c = i & (tc - 1), t = i >> log_tc;
    if (t0 + t < count && c0 + c < w) {
      tile[c * (tt + 1) + t] = to_float2(raw[(t0 + t) * w + c0 + c]);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kTile; i += kThreads) {
    const int t = i & (tt - 1), c = i >> log_tt;
    const int col = c0 + c;
    if (t0 + t < count && col < w) {
      const int p = col % npol, f = col / npol;
      out[(static_cast<long long>(p) * nchan + f) * count + t0 + t] = tile[c * (tt + 1) + t];
    }
  }
}

template <int kNbit>
__global__ void __launch_bounds__(kThreads) dada_pack_kernel(
    const float2* __restrict__ in, typename Word<kNbit>::Pair* __restrict__ raw, int npol,
    int nchan, long long count, int log_tc, float scale) {
  __shared__ float2 tile[kTile + 32];
  const int tc = 1 << log_tc;
  const int log_tt = kLogTile - log_tc;
  const int tt = 1 << log_tt;
  const int w = npol * nchan;
  const long long t0 = static_cast<long long>(blockIdx.x) << log_tt;
  const int c0 = blockIdx.y << log_tc;
  for (int i = threadIdx.x; i < kTile; i += kThreads) {
    const int t = i & (tt - 1), c = i >> log_tt;
    const int col = c0 + c;
    if (t0 + t < count && col < w) {
      const int p = col % npol, f = col / npol;
      tile[c * (tt + 1) + t] = in[(static_cast<long long>(p) * nchan + f) * count + t0 + t];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kTile; i += kThreads) {
    const int c = i & (tc - 1), t = i >> log_tc;
    if (t0 + t < count && c0 + c < w) {
      const float2 v = tile[c * (tt + 1) + t];
      typename Word<kNbit>::Pair q;
      q.x = to_word<kNbit>(v.x, scale);
      q.y = to_word<kNbit>(v.y, scale);
      raw[(t0 + t) * w + c0 + c] = q;
    }
  }
}

template <int kNbit>
__global__ void __launch_bounds__(kThreads) lowcbf_unpack_kernel(
    const typename Word<kNbit>::Pair* __restrict__ raw, float2* __restrict__ out, int npol,
    int nchan, long long n_heaps) {
  const int w = npol * nchan;
  const long long n_samp = n_heaps * kHeap;
  const long long total = n_samp * w;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x; i < total;
       i += stride) {
    const int t = static_cast<int>(i & (kHeap - 1));
    const long long packet = i / kHeap;
    const int c = static_cast<int>(packet % w);
    const long long h = packet / w;
    const int p = c % npol, f = c / npol;
    out[(static_cast<long long>(p) * nchan + f) * n_samp + h * kHeap + t] = to_float2(raw[i]);
  }
}

namespace {

bool tile_args_ok(int npol, int nchan, long long count, int log_tc) {
  const long long w = static_cast<long long>(npol) * nchan;
  return npol > 0 && nchan > 0 && count > 0 && log_tc >= 0 && log_tc <= 5 &&
         w < (1LL << 31) && ((w + (1 << log_tc) - 1) >> log_tc) <= 65535 &&
         ((count + (kTile >> log_tc) - 1) >> (kLogTile - log_tc)) < (1LL << 31);
}

dim3 tile_grid(int npol, int nchan, long long count, int log_tc) {
  const long long w = static_cast<long long>(npol) * nchan;
  return dim3(static_cast<unsigned>((count + (kTile >> log_tc) - 1) >> (kLogTile - log_tc)),
              static_cast<unsigned>((w + (1 << log_tc) - 1) >> log_tc));
}

template <int kNbit>
void unpack(const void* raw, void* out, int npol, int nchan, long long count, int log_tc,
            cudaStream_t s) {
  dada_unpack_kernel<kNbit><<<tile_grid(npol, nchan, count, log_tc), kThreads, 0, s>>>(
      static_cast<const typename Word<kNbit>::Pair*>(raw), static_cast<float2*>(out), npol,
      nchan, count, log_tc);
}

template <int kNbit>
void lowcbf(const void* raw, void* out, int npol, int nchan, long long n_heaps, int blocks,
            cudaStream_t s) {
  lowcbf_unpack_kernel<kNbit><<<blocks, kThreads, 0, s>>>(
      static_cast<const typename Word<kNbit>::Pair*>(raw), static_cast<float2*>(out), npol,
      nchan, n_heaps);
}

template <int kNbit>
void pack(const void* in, void* raw, int npol, int nchan, long long count, int log_tc,
          float scale, cudaStream_t s) {
  dada_pack_kernel<kNbit><<<tile_grid(npol, nchan, count, log_tc), kThreads, 0, s>>>(
      static_cast<const float2*>(in), static_cast<typename Word<kNbit>::Pair*>(raw), npol,
      nchan, count, log_tc, scale);
}

}  // namespace

// raw: count * npol * nchan word pairs of nbit-bit words (8, 16: int;
// 32, 64: float); out: complex64 (npol, nchan, count).
extern "C" int dada_unpack_launch(const void* raw, void* out, int nbit, int npol, int nchan,
                                  long long count, int log_tc, void* stream) {
  if (!tile_args_ok(npol, nchan, count, log_tc)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nbit) {
    case 8: unpack<8>(raw, out, npol, nchan, count, log_tc, s); break;
    case 16: unpack<16>(raw, out, npol, nchan, count, log_tc, s); break;
    case 32: unpack<32>(raw, out, npol, nchan, count, log_tc, s); break;
    case 64: unpack<64>(raw, out, npol, nchan, count, log_tc, s); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// raw: n_heaps LowCBF heaps of npol * nchan packets of 32 word pairs (nbit
// 8, 16: int; 32: float); out: complex64 (npol, nchan, 32 * n_heaps).
extern "C" int lowcbf_unpack_launch(const void* raw, void* out, int nbit, int npol, int nchan,
                                    long long n_heaps, int blocks, void* stream) {
  if (npol <= 0 || nchan <= 0 || n_heaps <= 0 || blocks <= 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nbit) {
    case 8: lowcbf<8>(raw, out, npol, nchan, n_heaps, blocks, s); break;
    case 16: lowcbf<16>(raw, out, npol, nchan, n_heaps, blocks, s); break;
    case 32: lowcbf<32>(raw, out, npol, nchan, n_heaps, blocks, s); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// in: complex64 (npol, nchan, count); raw: count * npol * nchan word pairs
// of nbit bits (8, 16: int8 / int16 after rint and the clip; 32: float).
extern "C" int dada_pack_launch(const void* in, void* raw, int nbit, int npol, int nchan,
                                long long count, int log_tc, float scale, void* stream) {
  if (!tile_args_ok(npol, nchan, count, log_tc)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nbit) {
    case 8: pack<8>(in, raw, npol, nchan, count, log_tc, scale, s); break;
    case 16: pack<16>(in, raw, npol, nchan, count, log_tc, scale, s); break;
    case 32: pack<32>(in, raw, npol, nchan, count, log_tc, scale, s); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
