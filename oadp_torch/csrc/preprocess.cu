// resize_crops: the CLIP crops of a dispatch, from the source images and
// each crop's 9 scalars to normalized bf16 pixels, in one launch.
//
// Replaces what oadp_tpu leaves to XLA inside its jitted objects and
// globals programs (not a Pallas kernel): prep_one vmapped over the chunks
// and normalize_clip (oadp_tpu/oake/encoders.py:401-432), that is
// device_coeffs (oadp_tpu/ops/preprocess.py:304), the bf16 branch of
// _resize_one (:410) through apply_resize_coeffs (:511), and
// normalize_clip (:542). The port's route before this kernel scattered every
// crop's taps into dense (crops, 224, pad) matrices and multiplied them
// against the whole padded image: a (crops, pad, 224, 3) fp32 intermediate
// and some hundred small launches a dispatch.
//
//   crop c reads image c / per_image; meta[c] = x0, y0, cw, ch, ow, oh,
//   left, top, identity (oake clip_transform_meta); for each output pixel
//   (e, o) and channel ch:
//     taps of each axis as device_coeffs derives them, each weight rounded
//     to bf16 (the cast of apply_resize_coeffs' bf16 branch);
//     t[h][o][ch] = round_u8(sum_k wx[o][k] * img[h][xs[o] + k][ch])
//     p[e][o][ch] = round_u8(sum_k wy[e][k] * t[ys[e] + k][o][ch])
//     dst = bf16((p - mean[ch]) / std[ch])
//   with round_u8(v) = clamp(floor(v + 0.5), 0, 255) and pixels outside
//   the padded image reading 0 (PIL's zero-fill crop).
//
// Exactness: the taps are bit for bit device_coeffs'. nvcc contracts a * b
// + c into an FMA unless told not to, so every step is written with the _rn
// intrinsics in the plain version's order (as nms.cu's IoU is): the
// multiply-then-divide center, both truncations, the bicubic polynomial
// term by term, the tap sum (left to right, in two halves past 32 taps, as
// oadp_tpu's XLA reduction takes it, split where the crop's own tap count
// splits it: an image may have fewer taps than the group's k_pad) and the
// 22-bit quantisation.
// Each product of a pass is exact in fp32 (an 8-bit integer times a bf16
// weight), so the fp32 sums taken left to right over the taps equal the
// plain version's (ops/preprocess.py:resize_crops_plain) to the bit.
//
// Bound: writing the crops (crops x 224 x 224 x 3 bf16, 616 MB at an
// objects dispatch of 2048 crops: ~0.18 ms at 3.35 TB/s); the tap sums, at
// most 35 fp32 products a value, sit under that for crops of scale below
// ~4 and above it for the largest.
//
// Design: a block per (crop, band of output rows): the whole crop where
// the crops alone fill the card twice over (an objects dispatch), else as
// many bands as do, of at least 16 rows. The block derives the crop's
// horizontal taps for all output columns and the band's vertical taps
// into shared memory (the prologue, once a band), then, sub-band by
// sub-band, runs the horizontal pass over only the source rows the
// sub-band's vertical taps reach, keeping those rows as uint8 in shared
// memory, and the vertical pass from there. A sub-band is as many rows as
// keep the source rows within ROWS_MAX (a crop of scale ~8 reaches ~8
// source rows an output row); the image (1.2 MB at 640 x 640) is read from
// L2.
#include <limits.h>
#include <algorithm>
#include <math.h>

#include "common.cuh"

namespace oadp {
namespace {

constexpr int MIN_BAND = 16;  // the fewest output rows a block takes
constexpr int ROWS_MAX = 96;  // source rows of a sub-band kept in shared memory
constexpr int ROW_GROUP = 4;  // source rows a thread of the horizontal pass takes
constexpr int THREADS = 256;
constexpr int MAX_TAPS = 64;  // device_coeffs' tap sum has a known order up to here
constexpr float QUANT = 4194304.0f;  // 2^22: Pillow's PRECISION_BITS

struct Scalars {
  float m[3], s[3];
};

// Pillow's bicubic filter (a = -0.5), term by term as ops/preprocess.py's
// _bicubic_t evaluates it.
__device__ __forceinline__ float bicubic(float x) {
  const float ax = fabsf(x);
  if (ax < 1.0f)  // ((a + 2) * ax - (a + 3)) * ax * ax + 1
    return __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(__fmul_rn(1.5f, ax), 2.5f), ax), ax), 1.0f);
  if (ax < 2.0f)  // (((ax - 5) * ax + 8) * ax - 4) * a
    return __fmul_rn(
        __fsub_rn(__fmul_rn(__fadd_rn(__fmul_rn(__fsub_rn(ax, 5.0f), ax), 8.0f), ax), 4.0f),
        -0.5f);
  return 0.0f;
}

// Where device_coeffs splits its tap sum (ops/preprocess.py:tap_sum_half).
__device__ __forceinline__ int tap_sum_half(int k_pad) {
  return k_pad > 32 ? (k_pad + 1) / 2 : k_pad;
}

// Tap k's weight before normalisation: the bicubic at its position, 0
// past the window.
__device__ __forceinline__ float raw_tap(int k, float xmin, float center, float filterscale,
                                         float valid) {
  const float kf = static_cast<float>(k);
  const float pos =
      __fdiv_rn(__fadd_rn(__fsub_rn(__fadd_rn(kf, xmin), center), 0.5f), filterscale);
  return kf < valid ? bicubic(pos) : 0.0f;
}

// One output pixel's taps along one axis, as device_coeffs derives them:
// the weights rounded to bf16 (as the passes use them) into w[0, k_pad),
// the first tap's source index into *start and the taps that may be
// nonzero into *count (those past it weigh exactly 0); the tap sum is split
// after `half` taps. The fp32 weights go to `dbg_w` and the start to
// `dbg_s` too when given.
__device__ void axis_taps(float crop0, float size, float n_out, float offset, bool identity,
                          int o, int k_pad, int half, bf16* w, int* start, int* count,
                          float* dbg_w, int* dbg_s) {
  if (identity) {
    // PIL skips resampling: one unit tap, at (crop0 + offset) + o
    for (int k = 0; k < k_pad; ++k) {
      w[k] = __float2bfloat16_rn(k == 0 ? 1.0f : 0.0f);
      if (dbg_w != nullptr) dbg_w[k] = k == 0 ? 1.0f : 0.0f;
    }
    *start = static_cast<int>(__fadd_rn(__fadd_rn(crop0, offset), static_cast<float>(o)));
    *count = 1;
  } else {
    const float scale = __fdiv_rn(size, n_out);
    const float filterscale = fmaxf(scale, 1.0f);
    const float support = __fmul_rn(2.0f, filterscale);
    // multiply-then-divide keeps exact-tie centers exact
    const float center = __fdiv_rn(
        __fmul_rn(__fadd_rn(__fadd_rn(static_cast<float>(o), offset), 0.5f), size), n_out);
    const float xmin = fmaxf(truncf(__fadd_rn(__fsub_rn(center, support), 0.5f)), 0.0f);
    const float xend = fminf(truncf(__fadd_rn(__fadd_rn(center, support), 0.5f)), size);
    const float valid = __fsub_rn(xend, xmin);
    // the tap sum in device_coeffs' order: left to right over [0, half)
    // and over [half, k_pad), the two parts added (no split up to 32 taps)
    float ww = 0.0f, rest = 0.0f;
    for (int k = 0; k < k_pad; ++k) {
      const float v = raw_tap(k, xmin, center, filterscale, valid);
      if (k < half)
        ww = k == 0 ? v : __fadd_rn(ww, v);
      else
        rest = k == half ? v : __fadd_rn(rest, v);
    }
    if (half < k_pad) ww = __fadd_rn(ww, rest);
    const float div = ww == 0.0f ? 1.0f : ww;
    // each weight again (the same operations give the same value), then
    // normalized and quantised to 22 bits: trunc(v * 2^22 + sign(v) / 2)
    // / 2^22, the division by a power of two done exactly as a product
    for (int k = 0; k < k_pad; ++k) {
      const float v = __fdiv_rn(raw_tap(k, xmin, center, filterscale, valid), div);
      const float round = v > 0.0f ? 0.5f : (v < 0.0f ? -0.5f : 0.0f);
      const float q = __fmul_rn(truncf(__fadd_rn(__fmul_rn(v, QUANT), round)), 1.0f / QUANT);
      w[k] = __float2bfloat16_rn(q);
      if (dbg_w != nullptr) dbg_w[k] = q;
    }
    *start = static_cast<int>(__fadd_rn(xmin, crop0));
    *count = valid <= 0.0f ? 0 : min(k_pad, static_cast<int>(valid));
  }
  if (dbg_s != nullptr) *dbg_s = *start;
}

__device__ __forceinline__ float round_u8(float v) {
  return fminf(fmaxf(floorf(__fadd_rn(v, 0.5f)), 0.0f), 255.0f);
}

struct ResizeArgs {
  const uint8_t* images;
  long long image_stride;  // elements between consecutive images
  int per_image, PH, PW;
  const float* meta;
  const int* halves;  // (G) where an image's crops split their tap sums, or null
  int k_pad, out, band, bands;
  Scalars norm;
  bf16* dst;
  float* taps_w;  // (crops, 2, out, k_pad) fp32 or null
  int* taps_s;    // (crops, 2, out) or null
};

__global__ void __launch_bounds__(THREADS) resize_crops_kernel(ResizeArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int crop = blockIdx.x / a.bands;
  const int e0 = (blockIdx.x % a.bands) * a.band;
  const int e1 = min(e0 + a.band, a.out);
  const int out = a.out, k_pad = a.k_pad, tid = threadIdx.x;
  int* xs = reinterpret_cast<int*>(smem);  // (out) first taps, then counts
  int* xn = xs + out;
  int* ys = xn + out;  // (band)
  int* yn = ys + a.band;
  bf16* wx = reinterpret_cast<bf16*>(yn + a.band);  // (out, k_pad)
  bf16* wy = wx + out * k_pad;                      // (band, k_pad)
  uint8_t* t = reinterpret_cast<uint8_t*>(wy + a.band * k_pad);  // (ROWS_MAX, out, 3)

  const float* m = a.meta + crop * 9;
  const bool identity = m[8] != 0.0f;
  const int half =
      a.halves == nullptr ? tap_sum_half(k_pad) : a.halves[crop / a.per_image];
  float* dbg_w = a.taps_w == nullptr ? nullptr : a.taps_w + (size_t)crop * 2 * out * k_pad;
  int* dbg_s = a.taps_s == nullptr ? nullptr : a.taps_s + (size_t)crop * 2 * out;
  const bool dbg_x = dbg_w != nullptr && e0 == 0;  // one block of the crop writes the x taps
  for (int o = tid; o < out; o += THREADS)
    axis_taps(m[0], m[2], m[4], m[6], identity, o, k_pad, half, wx + o * k_pad, xs + o,
              xn + o, dbg_x ? dbg_w + o * k_pad : nullptr, dbg_x ? dbg_s + o : nullptr);
  for (int r = tid; r < e1 - e0; r += THREADS)
    axis_taps(m[1], m[3], m[5], m[7], identity, e0 + r, k_pad, half, wy + r * k_pad, ys + r,
              yn + r, dbg_w ? dbg_w + (out + e0 + r) * k_pad : nullptr,
              dbg_w ? dbg_s + out + e0 + r : nullptr);
  __syncthreads();

  const uint8_t* img = a.images + (size_t)(crop / a.per_image) * a.image_stride;
  const size_t row_bytes = (size_t)a.PW * 3;
  bf16* dst = a.dst + (size_t)crop * out * out * 3;
  for (int r = e0; r < e1;) {
    // the sub-band [r, r1): rows whose taps keep the source rows it
    // reaches, [lo, hi), within ROWS_MAX (a row alone reaches at most
    // k_pad <= MAX_TAPS < ROWS_MAX)
    int lo = INT_MAX, hi = INT_MIN, r1 = r;
    for (; r1 < e1; ++r1) {
      const int n = yn[r1 - e0];
      if (n == 0) continue;
      const int l = min(lo, ys[r1 - e0]), h = max(hi, ys[r1 - e0] + n);
      if (h - l > ROWS_MAX && r1 > r) break;
      lo = l;
      hi = h;
    }
    const int rows = hi > lo ? hi - lo : 0;
    // horizontal pass over the reached rows, rounded to uint8: a thread
    // takes one output column of ROW_GROUP rows, so each tap's weight and
    // column serve them all and their sums run side by side (each still
    // over the taps in order)
    const int groups = (rows + ROW_GROUP - 1) / ROW_GROUP;
    for (int i = tid; i < groups * out; i += THREADS) {
      const int g0 = (i / out) * ROW_GROUP, o = i % out;
      const uint8_t* src[ROW_GROUP];
#pragma unroll
      for (int r = 0; r < ROW_GROUP; ++r) {
        const int h = lo + g0 + r;
        src[r] = g0 + r < rows && h >= 0 && h < a.PH ? img + (size_t)h * row_bytes : nullptr;
      }
      float acc[ROW_GROUP][3] = {};
      const bf16* w = wx + o * k_pad;
      const int s = xs[o], n = xn[o];
      for (int k = 0; k < n; ++k) {
        const int c = s + k;
        if (c < 0 || c >= a.PW) continue;
        const float wk = __bfloat162float(w[k]);
#pragma unroll
        for (int r = 0; r < ROW_GROUP; ++r) {
          if (src[r] == nullptr) continue;
          const uint8_t* p = src[r] + c * 3;
#pragma unroll
          for (int ch = 0; ch < 3; ++ch)
            acc[r][ch] = __fadd_rn(acc[r][ch], __fmul_rn(wk, static_cast<float>(__ldg(p + ch))));
        }
      }
#pragma unroll
      for (int r = 0; r < ROW_GROUP; ++r) {
        if (g0 + r >= rows) break;
        uint8_t* q = t + ((size_t)(g0 + r) * out + o) * 3;
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) q[ch] = static_cast<uint8_t>(round_u8(acc[r][ch]));
      }
    }
    __syncthreads();
    // vertical pass, rounded, normalized, written
    for (int i = tid; i < (r1 - r) * out; i += THREADS) {
      const int e = r + i / out, o = i % out;
      const bf16* w = wy + (e - e0) * k_pad;
      const int n = yn[e - e0], s = n > 0 ? ys[e - e0] - lo : 0;
      float acc0 = 0.0f, acc1 = 0.0f, acc2 = 0.0f;
      for (int k = 0; k < n; ++k) {
        const uint8_t* p = t + ((size_t)(s + k) * out + o) * 3;
        const float wk = __bfloat162float(w[k]);
        acc0 = __fadd_rn(acc0, __fmul_rn(wk, static_cast<float>(p[0])));
        acc1 = __fadd_rn(acc1, __fmul_rn(wk, static_cast<float>(p[1])));
        acc2 = __fadd_rn(acc2, __fmul_rn(wk, static_cast<float>(p[2])));
      }
      const float v[3] = {round_u8(acc0), round_u8(acc1), round_u8(acc2)};
      bf16* q = dst + ((size_t)e * out + o) * 3;
#pragma unroll
      for (int ch = 0; ch < 3; ++ch)
        q[ch] = __float2bfloat16_rn(__fdiv_rn(__fsub_rn(v[ch], a.norm.m[ch]), a.norm.s[ch]));
    }
    __syncthreads();
    r = r1;
  }
}

}  // namespace
}  // namespace oadp

extern "C" {

// Checked by the Python wrapper (oadp_torch/ops/preprocess.py:resize_crops):
// images uint8 (G, PH, PW, 3), each image's (PH, PW, 3) contiguous, image g
// at images + g * image_stride; meta (G * per_image, 9) fp32 contiguous;
// halves (G) int32 (tap_sum_half of each image's own tap count) or null;
// dst (G * per_image, out, out, 3) bf16 contiguous; taps_w (crops, 2, out,
// k_pad) fp32 and taps_s (crops, 2, out) int32 both given or both null.
int oadp_resize_crops(const void* images, long long image_stride, int G, int per_image, int PH,
                      int PW, const void* meta, int k_pad, const void* halves, int out,
                      float m0, float m1, float m2, float s0, float s1, float s2, void* dst,
                      void* taps_w, void* taps_s, void* stream) {
  using namespace oadp;
  if (G <= 0 || per_image <= 0) return cudaSuccess;
  if (k_pad <= 0 || k_pad > MAX_TAPS || out <= 0 || PH <= 0 || PW <= 0)
    return cudaErrorInvalidValue;
  if ((taps_w == nullptr) != (taps_s == nullptr)) return cudaErrorInvalidValue;
  ResizeArgs a;
  a.images = static_cast<const uint8_t*>(images);
  a.image_stride = image_stride;
  a.per_image = per_image;
  a.PH = PH;
  a.PW = PW;
  a.meta = static_cast<const float*>(meta);
  a.halves = static_cast<const int*>(halves);
  a.k_pad = k_pad;
  a.out = out;
  // bands a crop: enough blocks for two a multiprocessor, bands of at
  // least MIN_BAND rows
  const long long crops = (long long)G * per_image;
  const int max_bands = (out + MIN_BAND - 1) / MIN_BAND;
  const long long want = (2LL * sm_count() + crops - 1) / crops;
  const int bands = (int)std::min<long long>(max_bands, std::max<long long>(1, want));
  a.band = (out + bands - 1) / bands;
  a.bands = (out + a.band - 1) / a.band;
  a.norm = Scalars{{m0, m1, m2}, {s0, s1, s2}};
  a.dst = static_cast<bf16*>(dst);
  a.taps_w = static_cast<float*>(taps_w);
  a.taps_s = static_cast<int*>(taps_s);
  const size_t smem = (size_t)(out + a.band) * 8 + (size_t)(out + a.band) * k_pad * 2 +
                      (size_t)ROWS_MAX * out * 3;
  if (smem > 232448) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(resize_crops_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const long long blocks = crops * a.bands;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  resize_crops_kernel<<<(int)blocks, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

}  // extern "C"
