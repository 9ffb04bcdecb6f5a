// Fused zero-padded (SKA-Mid) analysis fold, no reversal.
//
// Replaces the Pallas kernel of
//   ska_pst_dsp_tpu/ops/pallas/analysis_padded_fused.py::polyphase_analysis_padded_fused
//   (_kernel, launched by the pallas_call in _fold_call).
//
//   g[p, k, j] = sum_m f_rev[m, j] * x[p, k*step - fl + m*block + j],
//   fl = phases*block, x = 0 outside [0, n_dat)
//
// The reversal and block^2 * IFFT of the reference become a forward FFT
// times a per-bin constant in the next kernel (chan_dft_fused.cu), so this
// kernel stores the true, unreversed fold rows.
//
// What bounds it on the H100: bytes. At mid a spectrum is 25 phases x
// 4096 real-by-complex products (~0.4 Mflop) against ~29 KB of new input
// and 32 KB of output, ~7 flop per byte, under the fp32 ridge of ~20; the
// mid stream (2 x 4,587,520 samples in, 2 x 1280 spectra out) must move
// 157 MB, 0.047 ms at 3.35 TB/s. Each input sample feeds phases*block/step
// (~29) spectra, so the fold must not re-read frames from device memory,
// and 25 shared-memory reads per output point would cost more than the
// device memory does. The first version staged 417 rows per 32 spectra with
// synchronous loads (the input staged 1.86 times, nothing overlapping the
// loads), read shared memory 25 times a point and its coefficients from
// global memory in the inner loop, on 1280 blocks of a plain grid; it took
// 6.1x the bound.
//
// Every fold term sits on a W-wide row grid. With W = gcd(step, block),
// D = block/W, S = step/W and j = d*W + c, the term
// x[k*step - fl + m*block + j] is row S*k + D*m + d - D*phases, column c,
// of the stream viewed as W-wide rows: spectrum k reads the D*phases rows
// before row S*k.
//
// Design:
//   * a work unit is one polarization, one group of kCols columns c of the
//     row view, and a run of up to seg_tiles tiles of kSpec consecutive
//     spectra. One persistent 512-thread block per SM walks over the units,
//     column groups fastest, so the units in flight read the same rows of
//     device memory;
//   * a run's rows lie in shared memory in stream order: slot i of the
//     buffer is stream row S*k_run - D*phases + i, and tile t reads the
//     window of D*phases + S*(kSpec - 1) slots from S*kSpec*t. The first
//     tile of a run loads its window (rounded up to whole boxes, below),
//     every later one only the S*kSpec rows past what is loaded, so a run
//     of T tiles stages (window + (T - 1)*S*kSpec) rows to advance
//     T*S*kSpec. The run ends where the buffer does, so no slot index is
//     ever reduced modulo the buffer: a ring that wraps costs a compare and
//     a subtract on every read of the unrolled fold, and runs have to be
//     short anyway to give every SM a few units. With kSpec = 32 and
//     kCols = 16 (128-byte rows) seven tiles fit at mid: 1792 rows staged
//     for 1568, 1.14 times. Measured on the H100 at the mid shape
//     (tools/torch_fold_variants.py), kSpec 16 to 64, kCols 16 to 64, 256
//     to 1024 threads and every run length lie within 0.066-0.091 ms; these
//     sizes with runs of four to seven tiles are the fastest (0.066-0.067);
//   * rows arrive through a 3-D tensor map over the stream as (column, row,
//     polarization): one cp.async.bulk.tensor instruction copies a box of
//     box_rows rows x kCols columns, issued by one thread on two
//     transaction barriers that alternate by step (a step is one tile).
//     Rows before the stream start (and past its last whole row) lie
//     outside the tensor and arrive as zeros, counted like any others, so
//     each barrier expects boxes * box bytes. The first design issued one
//     plain bulk copy per row: about 70 clocks a copy on each SM whatever
//     its size, which held the kernel at 4x its bound. box_rows is the
//     largest divisor of S*kSpec up to 256 (the engine's limit), so every
//     load is whole boxes. The rows of step n + 1 are issued before step n
//     folds: they land past step n's window, or, for the first tile of the
//     next unit, at the start of the buffer once this window has moved
//     beyond it (otherwise they are issued after the fold). The map wants
//     the polarization stride a multiple of 16 bytes: the wrapper hands
//     over such a view (a copy only for an odd stream length). Encoding a
//     map costs the host several microseconds, so the last few are kept
//     (tensor_map_of): a stream folded again from the same buffer, as a
//     pipeline's is, encodes nothing;
//   * fold at the mid geometry (a template specialisation: 25 phases,
//     S = 7, D = 8): spectrum k + D at phase m - S reads the row spectrum k
//     reads at phase m. A thread owns column (d, c) of one residue class
//     k mod D of the tile: it reads the S*(U - 1) + phases slots that the
//     class's U = kSpec/D spectra touch once each, at constant offsets
//     from one address, and adds each to every spectrum that uses it, its
//     25 coefficients in registers (reloaded per unit): 46 reads for 4
//     outputs (11.5 a point, 25 before). Other geometries fold directly;
//   * stores are time-major (pol, spectrum, channel), each warp on kCols
//     consecutive channels per row d: whole 128-byte lines.
// fp32 SIMT arithmetic throughout; no tensor cores (bf16 and TF32 both miss
// the -60 dB purity floor).
#include <cstdint>
#include <cstring>

#include <cuda.h>

#include "bulk_async.cuh"
#include "fft_reg.cuh"

// the wrapper's K_TILE and C_TILE mirror kSpec and kCols
constexpr int kThreads = 512;
constexpr int kSpec = 32;            // consecutive spectra per tile (K)
constexpr int kCols = 16;            // W-row columns per work unit (C)
constexpr int kHeader = 128;         // bytes: two barriers; keeps the rows on 128 bytes
constexpr int kBoxRows = 256;        // most rows of a tensor-map box
// a box row is 2*kCols floats (at most 256) and starts on 128 bytes
static_assert(kCols % 16 == 0 && 2 * kCols <= 256, "padded fold: box row");

struct Fold {
  int nblocks, block, w, d_rows, s_rows, phases;
  int box_rows, window_pad;  // rows of a box; the window in whole boxes
  int n_cg, n_seg, seg_tiles, n_units;
};

struct Unit {
  int pol, c0, k_run, tiles;
};

// unit u: column group fastest, then run, then polarization
__device__ __forceinline__ Unit unit_of(const Fold& f, int u) {
  Unit r;
  const int cg = u % f.n_cg;
  const int rest = u / f.n_cg;
  const int seg = rest % f.n_seg;
  r.pol = rest / f.n_seg;
  r.c0 = cg * kCols;
  r.k_run = seg * f.seg_tiles * kSpec;
  const int left = (f.nblocks - r.k_run + kSpec - 1) / kSpec;
  r.tiles = left < f.seg_tiles ? left : f.seg_tiles;
  return r;
}

// One thread: the boxes tile t of unit u adds to the buffer, completion on
// `bar`. Slot i holds stream row S*k_run - D*phases + i; tile 0 loads slots
// [0, window_pad), tile t > 0 the S*kSpec after those loaded before it.
__device__ __forceinline__ void issue_rows(float2* rows, uint64_t* bar, const void* map,
                                           const Fold& f, const Unit& u, int t) {
  const int slide = f.s_rows * kSpec;
  const int r0 = f.s_rows * u.k_run - f.d_rows * f.phases;
  const int lo = t == 0 ? 0 : f.window_pad + slide * (t - 1);
  const int hi = f.window_pad + slide * t;
  mbar_expect_tx(bar, static_cast<uint32_t>(hi - lo) * (kCols * 8));
  fence_proxy_async();
  for (int slot = lo; slot < hi; slot += f.box_rows) {
    tensor_load_3d(rows + slot * kCols, map, 2 * u.c0, r0 + slot, u.pol, bar);
  }
}

// PH > 0: the fold of a geometry with PH phases, step = SB*w and
// block = BB*w; PH = 0: any geometry, folded directly.
template <int PH, int SB, int BB>
__global__ void __launch_bounds__(kThreads, 1)
padded_fold_kernel(const __grid_constant__ CUtensorMap map, float2* __restrict__ g,
                   const float* __restrict__ f2d, Fold f) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem_raw);
  float2* rows = reinterpret_cast<float2*>(smem_raw + kHeader);
  const int tid = threadIdx.x;
  const int slide = f.s_rows * kSpec;

  if (tid == 0) {
    mbar_init(bar, 1);
    mbar_init(bar + 1, 1);
    fence_mbar_init();
  }
  __syncthreads();
  int unit = blockIdx.x;
  if (unit >= f.n_units) return;
  Unit u = unit_of(f, unit);
  if (tid == 0) issue_rows(rows, bar, &map, f, u, 0);

  // the static fold's items: column (d, c) = item % (BB*kCols) of residue
  // class item / (BB*kCols); a thread's items share the column
  constexpr int DC = PH > 0 ? BB * kCols : 1;
  constexpr int ITEMS = PH > 0 ? BB * DC / kThreads : 1;
  constexpr int U = PH > 0 ? kSpec / BB : 1;
  static_assert(PH == 0 || (kThreads % DC == 0 && ITEMS * kThreads == BB * DC &&
                            U * BB == kSpec),
                "padded fold: item tiling");
  float fc[PH > 0 ? PH : 1];

  int t = 0;
  for (int n = 0; unit < f.n_units; ++n) {
    int next_unit = unit, next_t = t + 1;
    if (next_t == u.tiles) {
      next_unit = unit + gridDim.x;
      next_t = 0;
    }
    const bool has_next = next_unit < f.n_units;
    const Unit nu = next_t == 0 && has_next ? unit_of(f, next_unit) : u;
    // the next unit's first boxes start the buffer anew: early only once
    // this tile's window lies wholly past them
    const bool early = has_next && (next_t > 0 || slide * t >= f.window_pad);
    if (tid == 0 && early) issue_rows(rows, bar + ((n + 1) & 1), &map, f, nu, next_t);

    const int k0 = u.k_run + t * kSpec;
    float2* out = g + (static_cast<long long>(u.pol) * f.nblocks + k0) * f.block + u.c0;
    if constexpr (PH > 0) {
      const int dc = tid % DC;
      const int d = dc / kCols;
      const int c = dc - d * kCols;
      if (t == 0) {
#pragma unroll
        for (int m = 0; m < PH; ++m) fc[m] = f2d[m * f.block + d * f.w + u.c0 + c];
      }
      mbar_wait(bar + (n & 1), (n >> 1) & 1);
      constexpr int NROW = SB * (U - 1) + PH;
#pragma unroll
      for (int it = 0; it < ITEMS; ++it) {
        const int rho = tid / DC + it * (kThreads / DC);
        const float2* src = rows + (slide * t + SB * rho + d) * kCols + c;
        float2 acc[U];
#pragma unroll
        for (int q = 0; q < U; ++q) acc[q] = make_float2(0.f, 0.f);
#pragma unroll
        for (int i = 0; i < NROW; ++i) {
          const float2 v = src[i * BB * kCols];
#pragma unroll
          for (int q = 0; q < U; ++q) {
            const int m = i - SB * q;
            if (m >= 0 && m < PH) {
              acc[q].x = fmaf(fc[m], v.x, acc[q].x);
              acc[q].y = fmaf(fc[m], v.y, acc[q].y);
            }
          }
        }
#pragma unroll
        for (int q = 0; q < U; ++q) {
          const int kk = rho + BB * q;
          if (k0 + kk < f.nblocks) {
            out[static_cast<long long>(kk) * f.block + d * f.w + c] = acc[q];
          }
        }
      }
    } else {
      mbar_wait(bar + (n & 1), (n >> 1) & 1);
      const int dc_n = f.d_rows * kCols;
      for (int item = tid; item < kSpec * dc_n; item += kThreads) {
        const int kk = item / dc_n;
        const int dc = item - kk * dc_n;
        const int d = dc / kCols;
        const int c = dc - d * kCols;
        if (k0 + kk >= f.nblocks) break;
        const int j = d * f.w + u.c0 + c;
        const float2* src = rows + (slide * t + f.s_rows * kk + d) * kCols + c;
        float2 acc = make_float2(0.f, 0.f);
        for (int m = 0; m < f.phases; ++m) {
          const float fm = __ldg(f2d + m * f.block + j);
          const float2 v = src[m * f.d_rows * kCols];
          acc.x = fmaf(fm, v.x, acc.x);
          acc.y = fmaf(fm, v.y, acc.y);
        }
        out[static_cast<long long>(kk) * f.block + d * f.w + c] = acc;
      }
    }
    __syncthreads();  // this tile's window is read: slots before the next one are free
    if (tid == 0 && has_next && !early) {
      issue_rows(rows, bar + ((n + 1) & 1), &map, f, nu, next_t);
    }
    unit = next_unit;
    t = next_t;
    u = nu;
  }
}

using FoldKern = void (*)(const CUtensorMap, float2*, const float*, Fold);

// the mid geometry (25 phases, step 7w, block 8w) has its own fold
static FoldKern pick_kernel(int phases, int s_rows, int d_rows) {
  if (phases == 25 && s_rows == 7 && d_rows == 8) return padded_fold_kernel<25, 7, 8>;
  return padded_fold_kernel<0, 0, 0>;
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of the CUDA driver API, looked up once (the library links
// against the runtime only)
static EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess) {
      p = nullptr;
    }
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// The tensor map of the stream as float32 (2w, whole rows, n_pol), boxes of
// (2*kCols, box_rows, 1): rows outside read as zeros. A map depends on the
// address and the shape only, so the last kMaps are kept by both, under a
// lock, and a repeated call encodes nothing.
static cudaError_t tensor_map_of(const void* x, long long n_dat, long long pol_stride,
                                 int n_pol, int w, int box_rows, CUtensorMap* map) {
  struct Key {
    const void* x;
    long long n_dat, pol_stride;
    int dev, n_pol, w, box_rows;
  };
  constexpr int kMaps = 8;
  static std::mutex mu;
  static Key keys[kMaps];
  static CUtensorMap maps[kMaps];
  static int n_maps = 0, next = 0;
  Key key = {};
  key.x = x;
  key.n_dat = n_dat;
  key.pol_stride = pol_stride;
  key.n_pol = n_pol;
  key.w = w;
  key.box_rows = box_rows;
  const cudaError_t e = cudaGetDevice(&key.dev);
  if (e != cudaSuccess) return e;
  const std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < n_maps; ++i) {
    if (std::memcmp(&keys[i], &key, sizeof(Key)) == 0) {
      *map = maps[i];
      return cudaSuccess;
    }
  }
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {2ull * w, static_cast<cuuint64_t>(n_dat / w),
                              static_cast<cuuint64_t>(n_pol)};
  const cuuint64_t strides[2] = {8ull * w, 8ull * static_cast<cuuint64_t>(pol_stride)};
  const cuuint32_t box[3] = {2u * kCols, static_cast<cuuint32_t>(box_rows), 1u};
  const cuuint32_t ones[3] = {1u, 1u, 1u};
  if (encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(x), dims, strides,
             box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS) {
    return cudaErrorInvalidValue;
  }
  keys[next] = key;
  maps[next] = *map;
  next = (next + 1) % kMaps;
  if (n_maps < kMaps) ++n_maps;
  return cudaSuccess;
}

// Thread blocks of the fold kernel of a geometry resident on the current
// card at once: the persistent grid's size, and what the wrapper balances
// its runs against. The allowance is the card's limit, so one preparation
// serves every geometry of a kernel.
extern "C" int padded_fold_slots(int phases, int s_rows, int d_rows, int smem_limit,
                                 int* slots) {
  return prepare_persistent(reinterpret_cast<const void*>(pick_kernel(phases, s_rows, d_rows)),
                            kThreads, smem_limit, slots);
}

// x: (n_pol, n_dat) complex64, 16-byte aligned, polarization p at
// x + p*pol_stride samples, pol_stride even; g: (n_pol, nblocks, block)
// complex64; f2d: (phases, block) float32, the reversed filter. block =
// d_rows * w, step = s_rows * w, w a multiple of kCols. A run holds up to
// seg_tiles tiles (ops/kernels/analysis_padded_fused.py plan): its rows, the
// window D*phases + S*(kSpec - 1) in whole boxes plus (seg_tiles - 1) *
// S*kSpec, of kCols samples each, must fit in `smem_limit` bytes with the
// header. One persistent thread block per resident slot.
extern "C" int padded_fold_launch(const void* x, void* g, const void* f2d, int n_pol,
                                  long long n_dat, long long pol_stride, int nblocks,
                                  int block, int w, int d_rows, int s_rows, int phases,
                                  int seg_tiles, int smem_limit, void* stream) {
  if (w <= 0 || w % kCols || d_rows <= 0 || s_rows <= 0 ||
      phases <= 0 || seg_tiles <= 0 || d_rows * w != block || n_pol <= 0 || nblocks <= 0 ||
      static_cast<long long>(nblocks) * s_rows * w > n_dat || n_dat / w >= (1LL << 31) ||
      pol_stride < n_dat || (pol_stride & 1) || (reinterpret_cast<uintptr_t>(x) & 15)) {
    return cudaErrorInvalidValue;
  }
  const int slide = s_rows * kSpec;
  int box_rows = slide < kBoxRows ? slide : kBoxRows;
  while (slide % box_rows) --box_rows;
  const int window = d_rows * phases + s_rows * (kSpec - 1);
  const int window_pad = (window + box_rows - 1) / box_rows * box_rows;
  const long long buf_rows = window_pad + static_cast<long long>(seg_tiles - 1) * slide;
  const long long smem = kHeader + buf_rows * kCols * 8;
  if (smem > smem_limit) return cudaErrorInvalidValue;
  const int n_tiles = (nblocks + kSpec - 1) / kSpec;
  const int n_seg = (n_tiles + seg_tiles - 1) / seg_tiles;
  const int n_cg = w / kCols;
  const long long n_units = static_cast<long long>(n_pol) * n_seg * n_cg;
  if (n_units > (1LL << 30)) return cudaErrorInvalidValue;
  CUtensorMap map;
  cudaError_t e = tensor_map_of(x, n_dat, pol_stride, n_pol, w, box_rows, &map);
  if (e != cudaSuccess) return e;
  int slots = 0;
  e = static_cast<cudaError_t>(padded_fold_slots(phases, s_rows, d_rows, smem_limit, &slots));
  if (e != cudaSuccess) return e;
  const FoldKern kern = pick_kernel(phases, s_rows, d_rows);
  const Fold f = {nblocks, block, w, d_rows, s_rows, phases, box_rows, window_pad,
                  n_cg, n_seg, seg_tiles, static_cast<int>(n_units)};
  const int units = static_cast<int>(n_units);
  kern<<<units < slots ? units : slots, kThreads, static_cast<size_t>(smem),
         static_cast<cudaStream_t>(stream)>>>(map, static_cast<float2*>(g),
                                              static_cast<const float*>(f2d), f);
  return cudaGetLastError();
}
