// Register-resident FFT building blocks for the Hopper kernels.
//
// A length-Q transform (Q = 2^k, 128 <= Q <= 4096) over rows held in shared
// memory runs as ceil(k/3) decimation-in-frequency passes, all of radix 8
// but the last, of radix 2, 4 or 8 (FftRegPlan). Each butterfly loads its
// RAD values into registers, transforms them there, multiplies by the pass
// twiddle and stores them back, so a 512-point transform costs three
// shared-memory round trips and a 4096-point one four (a radix-2 form
// costs nine and twelve, each with a __syncthreads).
//
// Pass s has radix r_s and span h_s = Q / (r_0 ... r_s). Its butterfly at
// offset j < h_s of group g reads x[g*r_s*h_s + j + h_s*m], m < r_s, and
// writes output d to x[g*r_s*h_s + j + h_s*d] times w_{r_s*h_s}^(j*d). After
// the passes output k = d0 + 8*d1 + 64*d2 + ... sits at position
// d0*Q/8 + d1*Q/64 + ... + d_last: the last pass's butterfly g (the digits
// d0, d1, ... of all but the last pass, d0 most significant) holds the
// outputs d_last = 0..r_last-1 in registers, and a kernel stores them
// wherever it wants (fft_reg_out_index gives k).
//
// Every twiddle comes from a table built on the host in float64 from exact
// integers and staged in shared memory: either tab[m] = w_n^m, read as
// w_L^(j*d) = tab[j*d*(n/L)] with j*d < L, or the per-pass table of
// fft_reg_pass_tw; no index is ever reduced. The sign of the transform is
// the template parameter SIGN (+1 backward, -1 forward) of the fixed radix
// constants, and the table must be built with the same sign.
#pragma once

#include <mutex>

#include "complex.cuh"

// a * exp(SIGN*i*pi/4)
template <int SIGN = 1>
__device__ __forceinline__ float2 mul_w8_1(float2 a) {
  const float c = 0.70710678118654752f;
  return SIGN > 0 ? make_float2(c * (a.x - a.y), c * (a.x + a.y))
                  : make_float2(c * (a.x + a.y), c * (a.y - a.x));
}

// a * exp(SIGN*i*pi/2)
template <int SIGN = 1>
__device__ __forceinline__ float2 mul_w8_2(float2 a) {
  return SIGN > 0 ? make_float2(-a.y, a.x) : make_float2(a.y, -a.x);
}

// a * exp(SIGN*3i*pi/4)
template <int SIGN = 1>
__device__ __forceinline__ float2 mul_w8_3(float2 a) {
  const float c = 0.70710678118654752f;
  return SIGN > 0 ? make_float2(-c * (a.x + a.y), c * (a.x - a.y))
                  : make_float2(c * (a.y - a.x), -c * (a.x + a.y));
}

template <int SIGN = 1>
__device__ __forceinline__ void dft4(float2& x0, float2& x1, float2& x2, float2& x3) {
  const float2 t0 = c_add(x0, x2), t1 = c_sub(x0, x2);
  const float2 t2 = c_add(x1, x3), t3 = mul_w8_2<SIGN>(c_sub(x1, x3));
  x0 = c_add(t0, t2);
  x2 = c_sub(t0, t2);
  x1 = c_add(t1, t3);
  x3 = c_sub(t1, t3);
}

// In-register DFT y[d] = sum_m v[m] * exp(SIGN*2*pi*i*m*d/RAD), natural
// order, RAD in {2, 4, 8}. Radix 8 runs as two radix-4 DFTs (even and odd
// m) and one radix-2 layer: y[d] = E[d] + w^d O[d], y[d+4] = E[d] - w^d O[d].
template <int RAD, int SIGN = 1>
__device__ __forceinline__ void dft_reg(float2 (&v)[RAD]) {
  static_assert(RAD == 2 || RAD == 4 || RAD == 8, "dft_reg: radix 2, 4 or 8");
  if constexpr (RAD == 2) {
    const float2 a = v[0];
    v[0] = c_add(a, v[1]);
    v[1] = c_sub(a, v[1]);
  } else if constexpr (RAD == 4) {
    dft4<SIGN>(v[0], v[1], v[2], v[3]);
  } else {
    float2 e0 = v[0], e1 = v[2], e2 = v[4], e3 = v[6];
    float2 o0 = v[1], o1 = v[3], o2 = v[5], o3 = v[7];
    dft4<SIGN>(e0, e1, e2, e3);
    dft4<SIGN>(o0, o1, o2, o3);
    o1 = mul_w8_1<SIGN>(o1);
    o2 = mul_w8_2<SIGN>(o2);
    o3 = mul_w8_3<SIGN>(o3);
    v[0] = c_add(e0, o0);
    v[4] = c_sub(e0, o0);
    v[1] = c_add(e1, o1);
    v[5] = c_sub(e1, o1);
    v[2] = c_add(e2, o2);
    v[6] = c_sub(e2, o2);
    v[3] = c_add(e3, o3);
    v[7] = c_sub(e3, o3);
  }
}

// cos(2*pi*m/16); called with constants after unrolling, so it folds into
// an immediate
__device__ __forceinline__ float w16_cos(int m) {
  switch (m & 15) {
    case 0: return 1.f;
    case 1: case 15: return 0.92387953251128674f;
    case 2: case 14: return 0.70710678118654752f;
    case 3: case 13: return 0.38268343236508977f;
    case 4: case 12: return 0.f;
    case 5: case 11: return -0.38268343236508977f;
    case 6: case 10: return -0.70710678118654752f;
    case 7: case 9: return -0.92387953251128674f;
    default: return -1.f;
  }
}

// a * exp(SIGN*2*pi*i*m/16) for a constant m
template <int SIGN = 1>
__device__ __forceinline__ float2 mul_w16(float2 a, int m) {
  const float c = w16_cos(m), s = SIGN * w16_cos(m + 12);  // sin x = cos(x - pi/2)
  return make_float2(a.x * c - a.y * s, a.x * s + a.y * c);
}

// In-register 16-point DFT y[k] = sum_m v[m] * exp(SIGN*2*pi*i*m*k/16),
// natural order: radix-4 DFTs over m1 (m = 4*m1 + m2), the twiddle
// w16^(m2*k1), radix-4 DFTs over m2 (k = k1 + 4*k2).
template <int SIGN = 1>
__device__ __forceinline__ void dft16(float2 (&v)[16]) {
  float2 a[4][4];
#pragma unroll
  for (int m2 = 0; m2 < 4; ++m2) {
    float2 t0 = v[m2], t1 = v[4 + m2], t2 = v[8 + m2], t3 = v[12 + m2];
    dft4<SIGN>(t0, t1, t2, t3);
    a[m2][0] = t0;
    a[m2][1] = m2 == 0 ? t1 : mul_w16<SIGN>(t1, m2);
    a[m2][2] = m2 == 0 ? t2 : mul_w16<SIGN>(t2, 2 * m2);
    a[m2][3] = m2 == 0 ? t3 : mul_w16<SIGN>(t3, 3 * m2);
  }
#pragma unroll
  for (int k1 = 0; k1 < 4; ++k1) {
    float2 t0 = a[0][k1], t1 = a[1][k1], t2 = a[2][k1], t3 = a[3][k1];
    dft4<SIGN>(t0, t1, t2, t3);
    v[k1] = t0;
    v[k1 + 4] = t1;
    v[k1 + 8] = t2;
    v[k1 + 12] = t3;
  }
}

// cos and sin of 2*pi*m/r for the odd and mixed radices the kernels use
// (r in {3, 6, 7}); called with constants after unrolling, so they fold
// into immediates.
__device__ __forceinline__ float root_cos(int r, int m) {
  switch (r * 8 + m) {
    case 3 * 8 + 1: case 3 * 8 + 2: return -0.5f;
    case 6 * 8 + 1: case 6 * 8 + 5: return 0.5f;
    case 6 * 8 + 2: case 6 * 8 + 4: return -0.5f;
    case 6 * 8 + 3: return -1.f;
    case 7 * 8 + 1: case 7 * 8 + 6: return 6.234898019e-01f;
    case 7 * 8 + 2: case 7 * 8 + 5: return -2.225209340e-01f;
    case 7 * 8 + 3: case 7 * 8 + 4: return -9.009688679e-01f;
    default: return 1.f;
  }
}

__device__ __forceinline__ float root_sin(int r, int m) {
  switch (r * 8 + m) {
    case 3 * 8 + 1: case 6 * 8 + 1: case 6 * 8 + 2: return 8.660254038e-01f;
    case 3 * 8 + 2: case 6 * 8 + 4: case 6 * 8 + 5: return -8.660254038e-01f;
    case 7 * 8 + 1: return 7.818314825e-01f;
    case 7 * 8 + 2: return 9.749279122e-01f;
    case 7 * 8 + 3: return 4.338837391e-01f;
    case 7 * 8 + 4: return -4.338837391e-01f;
    case 7 * 8 + 5: return -9.749279122e-01f;
    case 7 * 8 + 6: return -7.818314825e-01f;
    default: return 0.f;
  }
}

// In-register R-point DFT of sign SIGN for any R <= 8: radices 2, 4 and 8
// as above; odd R by the symmetric form (pairs a, R-a share the cosine,
// their difference the sine: about half the multiplies of the direct sum);
// R = 6 directly.
template <int R, int SIGN = 1>
__device__ __forceinline__ void dft_radix(float2 (&v)[R]) {
  if constexpr (R == 2 || R == 4 || R == 8) {
    dft_reg<R, SIGN>(v);
  } else if constexpr (R % 2 == 1) {
    constexpr int H = (R - 1) / 2;
    float2 s[H + 1], d[H + 1];
    float2 y0 = v[0];
#pragma unroll
    for (int a = 1; a <= H; ++a) {
      s[a] = c_add(v[a], v[R - a]);
      d[a] = c_sub(v[a], v[R - a]);
      y0 = c_add(y0, s[a]);
    }
#pragma unroll
    for (int k = 1; k <= H; ++k) {
      float2 re = v[0], im = make_float2(0.f, 0.f);
#pragma unroll
      for (int a = 1; a <= H; ++a) {
        const float c = root_cos(R, (a * k) % R), sn = SIGN * root_sin(R, (a * k) % R);
        re = make_float2(fmaf(s[a].x, c, re.x), fmaf(s[a].y, c, re.y));
        im = make_float2(fmaf(d[a].x, sn, im.x), fmaf(d[a].y, sn, im.y));
      }
      v[k] = make_float2(re.x - im.y, re.y + im.x);      // re + i*im
      v[R - k] = make_float2(re.x + im.y, re.y - im.x);  // re - i*im
    }
    v[0] = y0;
  } else {
    float2 y[R];
#pragma unroll
    for (int k = 0; k < R; ++k) {
      float2 acc = v[0];
#pragma unroll
      for (int a = 1; a < R; ++a) {
        const int m = (a * k) % R;
        acc = c_add(acc, m == 0 ? v[a]
                                : c_mul(v[a], make_float2(root_cos(R, m),
                                                          SIGN * root_sin(R, m))));
      }
      y[k] = acc;
    }
#pragma unroll
    for (int k = 0; k < R; ++k) v[k] = y[k];
  }
}

// Position of point p of a sub-row: with PAD one slot follows every eight
// points, so the eight consecutive points of a last-pass butterfly, taken by
// neighbouring threads, spread over all banks.
template <bool PAD>
__device__ __forceinline__ int fft_reg_phys(int p) {
  return PAD ? p + (p >> 3) : p;
}

// One butterfly of a pass over the sub-row at `row`: points off + h*m ->
// DFT -> times w^(j*d) = tab[j*d*tstep] -> points off + h*d.
template <int RAD, bool PAD, int SIGN = 1>
__device__ __forceinline__ void fft_reg_butterfly(float2* row, int off, int h, int j,
                                                  const float2* tab, int tstep) {
  float2 v[RAD];
#pragma unroll
  for (int m = 0; m < RAD; ++m) v[m] = row[fft_reg_phys<PAD>(off + m * h)];
  dft_reg<RAD, SIGN>(v);
  if (j != 0) {
#pragma unroll
    for (int d = 1; d < RAD; ++d) v[d] = c_mul(v[d], tab[j * d * tstep]);
  }
#pragma unroll
  for (int d = 0; d < RAD; ++d) row[fft_reg_phys<PAD>(off + d * h)] = v[d];
}

// The passes of a 2^LOGQ-point transform: kPasses = ceil(LOGQ / 3), all of
// radix 8 but the last, of radix kLast in {2, 4, 8}. Pass s < kPasses - 1
// has span Q / 8^(s+1); the last has span 1, and its butterfly g holds the
// outputs k = fft_reg_out_index<kDigits>(g, d), d < kLast.
template <int LOGQ>
struct FftRegPlan {
  static_assert(LOGQ >= 7 && LOGQ <= 12, "fft_reg: 128 <= Q <= 4096");
  static constexpr int kQ = 1 << LOGQ;
  static constexpr int kPasses = (LOGQ + 2) / 3;
  static constexpr int kDigits = kPasses - 1;
  static constexpr int kLast = kQ >> (3 * kDigits);
  // entries of the per-pass twiddle table (fft_reg_pass_tw)
  static constexpr int kTw = kQ - kLast;
};

// Position of point p in a row of 2^LOGQ points whose radix-8 passes run
// with lanes on rows and whose last pass runs with lanes on butterflies
// rev8(tq) (a bijection on [0, 2^LOGQ)): the top three bits of p, which the
// last pass's lanes vary together with bit log2(r_last), are XORed into the
// other three of the low four bits, so a half-warp's 16 reads fall in 16
// distinct eight-byte slots.
template <int LOGQ>
__device__ __forceinline__ int fft_reg_swizzle(int p) {
  constexpr int kLast = FftRegPlan<LOGQ>::kLast;
  const int a = (p >> (LOGQ - 3)) & 7;
  if constexpr (kLast == 8) return p ^ a;
  else if constexpr (kLast == 4) return p ^ ((a & 3) | ((a & 4) << 1));
  else return p ^ ((a & 1) | ((a & 6) << 1));
}

// Offset of radix-8 pass s in the per-pass twiddle table: pass s (span H)
// holds 7 rows d = 1..7 of H entries w_8H^(j*d), j < H, so that threads on
// neighbouring j read neighbouring entries (host: ops/kernels
// pass_twiddles). The spans before s sum to (Q - Q/8^s) / 7, so the table
// holds Q - kLast entries.
__device__ __forceinline__ int fft_reg_pass_tw(int q, int s) {
  return q - (q >> (3 * s));
}

// One of the first two passes (radix 8, span H) over the sub-rows of Q
// points at buf + lane*ld + sub*sub_ld, lane < LANES, sub < subs.
// Butterflies are numbered lane-fastest, so neighbouring threads touch
// neighbouring lanes at the same offset. Ends with __syncthreads().
template <int Q, int H, int LANES, bool PAD, int SIGN = 1>
__device__ __forceinline__ void fft_reg_pass8(float2* buf, int ld, int subs, int sub_ld,
                                              const float2* tab, int n_tab) {
  constexpr int kPer = Q / 8;
  const int total = LANES * subs * kPer;
  const int tstep = n_tab / (8 * H);
  for (int item = threadIdx.x; item < total; item += blockDim.x) {
    const int lane = item % LANES;
    const int rest = item / LANES;
    const int u = rest % kPer;
    const int sub = rest / kPer;
    const int g = u / H;
    const int j = u - g * H;
    fft_reg_butterfly<8, PAD, SIGN>(buf + lane * ld + sub * sub_ld, g * 8 * H + j, H, j,
                                    tab, tstep);
  }
  __syncthreads();
}

// t with its NDIG base-8 digits reversed.
template <int NDIG>
__device__ __forceinline__ int fft_reg_rev8(int t) {
  int r = 0;
#pragma unroll
  for (int i = 0; i < NDIG; ++i) {
    r = (r << 3) | (t & 7);
    t >>= 3;
  }
  return r;
}

// Output index k of the last pass's butterfly g, register d, of a transform
// of NDIG + 1 passes: k = rev8(g) + 8^NDIG * d (three passes: k = d0 + 8*d1
// + 64*d with g = 8*d0 + d1).
template <int NDIG = 2>
__device__ __forceinline__ int fft_reg_out_index(int g, int d) {
  return fft_reg_rev8<NDIG>(g) + (d << (3 * NDIG));
}

// Sets the shared-memory allowance of `kern` and returns how many of its
// thread blocks of `threads` are resident on the current card at once, for
// a persistent grid. Both queries cost tens of microseconds, so each
// (kernel, device) is prepared once; a lock keeps the table whole when host
// threads launch at the same time.
static cudaError_t prepare_persistent(const void* kern, int threads, size_t smem,
                                      int* slots) {
  struct Prepared {
    const void* kern;
    int dev, slots;
  };
  static std::mutex mu;
  static Prepared done[64];
  static int n_done = 0;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < n_done; ++i) {
    if (done[i].kern == kern && done[i].dev == dev) {
      *slots = done[i].slots;
      return cudaSuccess;
    }
  }
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads, smem);
  }
  if (e != cudaSuccess) return e;
  *slots = sms * (per_sm > 0 ? per_sm : 1);
  if (n_done < 64) done[n_done++] = {kern, dev, *slots};
  return cudaSuccess;
}
