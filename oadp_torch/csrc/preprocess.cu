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
// Design: a block per (crop, band of output rows): the whole crop where the
// crops alone fill the card twice over (an objects dispatch), else as many
// bands as do, of at least 16 rows (the launch's layout: bands, ring rows,
// staging cap and shared memory, is planned by the caller,
// ops/preprocess.py:resize_crops, and checked here). The block derives the
// crop's horizontal taps for all output columns and the band's vertical taps
// into shared memory (the prologue, once a band), each cut to the taps that
// fall inside the image (the others weigh nothing: skipping them adds the
// same exact zeros the plain version adds), and a 3 x 256 bf16 table of the
// normalisation, (v - mean) / std for every uint8 v, so no pixel divides. It
// then walks sub-bands of output rows whose vertical taps reach at most RING
// rows of the source, in order, keeping the horizontal pass's uint8 results
// in a ring of RING rows: a source row's horizontal pass runs once, however
// many sub-bands read it. The rows a sub-band adds are staged in chunks:
// each chunk's source rows, only the columns the crop's taps reach, in
// 16-pixel units (three 16-byte loads), each pixel stored as one 4-byte word
// (a chunk ends at the staging cap, chosen with the ring so that two blocks
// fit on an SM). The horizontal pass reads a tap's three channels with one
// 4-byte load (one shared-memory wavefront a warp), a thread taking one
// output column of ROW_GROUP rows. Widening takes no conversion instruction:
// byte_perm puts a byte under the exponent of 2^23 and one subtraction takes
// 2^23 away (exact for 0..255); rounding back to uint8 adds 2^23 rounding
// down and reads the mantissa. Each tap's product is exact in fp32, so an
// FMA adds exactly what a multiply and an add would: the sums are the plain
// version's, in its order. The vertical pass gives each thread 8 consecutive
// values of an output row's out x 3 (channels interleaved, as the output
// lies): one 8-byte ring load a tap, the normalisation by table, one 16-byte
// store.
#include <limits.h>
#include <math.h>

#include "common.cuh"

namespace oadp {
namespace {

constexpr int ROW_GROUP = 4;  // source rows a thread of the horizontal pass takes
// two blocks an SM of 512 threads: the passes wait on shared-memory loads
// (256 threads a block ran 15% slower; unrolling the tap loops did not help)
constexpr int THREADS = 512;
constexpr int MAX_TAPS = 64;  // device_coeffs' tap sum has a known order up to here
constexpr float QUANT = 4194304.0f;  // 2^22: Pillow's PRECISION_BITS
constexpr float TWO23 = 8388608.0f;  // 2^23: a byte under this exponent is the byte

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

// round_u8 as an integer, clamp(floor(v + 0.5), 0, 255), with no
// conversion instruction: adding 2^23 rounding down leaves floor(t) in the
// low mantissa bits for 0 <= t < 2^23 (the ulp there is 1) and a negative
// integer below it for t < 0, which the clamp takes to 0 as floor would.
__device__ __forceinline__ int round_u8(float v) {
  const float f = __fadd_rd(__fadd_rn(v, 0.5f), TWO23);
  return min(max(__float_as_int(f) - 0x4B000000, 0), 255);
}

// Byte `b` (a constant 0..3) of `word` as a float, exactly: byte_perm puts
// it in the low mantissa bits under 0x4B (the float 2^23 + byte), and the
// subtraction leaves the byte; an integer op and an fp32 add, no I2F.
template <int B>
__device__ __forceinline__ float widen(uint32_t word) {
  return __int_as_float(static_cast<int>(__byte_perm(word, 0x4B000000u, 0x7440 + B))) - TWO23;
}

// Pixel `P` (a constant 0..15) of 48 source bytes held as 12 words, as
// one word R, G, B, x (bytes 3P..3P+2 in order, from one word or two).
template <int P>
__device__ __forceinline__ uint32_t pixel_word(const uint32_t* w) {
  constexpr int I = (3 * P) >> 2, OFF = (3 * P) & 3;
  constexpr uint32_t SEL = OFF | (OFF + 1) << 4 | (OFF + 2) << 8;
  return __byte_perm(w[I], OFF > 1 ? w[I + 1] : 0u, SEL);
}

// Sixteen source pixels (48 bytes as 12 words) as four 16-byte words of
// four pixels each, stored at dst.
template <int Q = 0>
__device__ __forceinline__ void store_pixels(const uint32_t* w, uint4* dst) {
  if constexpr (Q < 4) {
    dst[Q] = make_uint4(pixel_word<4 * Q>(w), pixel_word<4 * Q + 1>(w), pixel_word<4 * Q + 2>(w),
                        pixel_word<4 * Q + 3>(w));
    store_pixels<Q + 1>(w, dst);
  }
}

// A tap's window cut to the source inside the image ([0, limit)): its
// first in-image source index, the tap it is, and how many follow.
__device__ __forceinline__ void clip_taps(int start, int count, int limit, int* s, int* k0,
                                          int* n) {
  const int lo = max(0, -start), hi = min(count, limit - start);
  *s = hi > lo ? start + lo : 0;
  *k0 = hi > lo ? lo : 0;
  *n = hi > lo ? hi - lo : 0;
}

struct ResizeArgs {
  const uint8_t* images;
  long long image_stride;  // elements between consecutive images
  int per_image, PH, PW;
  const float* meta;
  const int* halves;  // (G) where an image's crops split their tap sums, or null
  int k_pad, out, band, bands;
  int ring, cap;  // ring rows of horizontal results; staged source bytes a chunk
  int aligned;    // every image row starts 16-byte aligned: stage by cp.async
  Scalars norm;
  bf16* dst;
  float* taps_w;  // (crops, 2, out, k_pad) fp32 or null
  int* taps_s;    // (crops, 2, out) or null
  long long* cycles;  // (blocks, 4) or null: thread 0's clock64 cycles by part
};

// Shared memory, in order: the ring (ring x out * 3 bytes), the staged
// source (cap + 16 bytes: rows of 4-byte pixel words), the
// taps' first source, first tap and count (out columns, then band rows),
// the weights (out x k_pad, band x k_pad bf16), the normalisation table
// (3 x 256 bf16). ops/preprocess.py:resize_smem computes it for the
// launch, which is refused where the two differ.
__host__ __device__ __forceinline__ int smem_source(int ring, int out) {
  return (ring * out * 3 + 15) & ~15;
}

__host__ __device__ __forceinline__ int smem_ints(int ring, int out, int cap) {
  return smem_source(ring, out) + cap + 16;
}

__host__ __device__ __forceinline__ int smem_bytes(int ring, int out, int band, int cap,
                                                   int k_pad) {
  return smem_ints(ring, out, cap) + 12 * (out + band) + 2 * (out + band) * k_pad + 3 * 256 * 2;
}

__global__ void __launch_bounds__(THREADS, 2) resize_crops_kernel(ResizeArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int span[2];  // the crop's source columns [span[0], span[1]) its taps reach
  const int crop = blockIdx.x / a.bands;
  const int e0 = (blockIdx.x % a.bands) * a.band;
  const int e1 = min(e0 + a.band, a.out);
  const int out = a.out, k_pad = a.k_pad, tid = threadIdx.x, T = a.ring;
  const int rp = out * 3;  // a ring row: one horizontal result row, channels interleaved
  uint8_t* ring = smem;
  uint8_t* src = smem + smem_source(T, out);
  int* xs = reinterpret_cast<int*>(smem + smem_ints(T, out, a.cap));  // (out): first source
  int* xk = xs + out;  // first tap
  int* xn = xk + out;  // taps in the image
  int* ys = xn + out;  // (band) the same for the band's rows
  int* yk = ys + a.band;
  int* yn = yk + a.band;
  bf16* wx = reinterpret_cast<bf16*>(yn + a.band);  // (out, k_pad)
  bf16* wy = wx + out * k_pad;                      // (band, k_pad)
  bf16* table = wy + a.band * k_pad;                // (3, 256)

  // cycles by part, thread 0's (barrier waits included): the prologue,
  // staging (with the sub-band plan), the horizontal and the vertical pass
  const bool timed = a.cycles != nullptr && tid == 0;
  long long t_mark = timed ? clock64() : 0, spent[4] = {0, 0, 0, 0};
  auto lap = [&](int part) {
    if (timed) {
      const long long now = clock64();
      spent[part] += now - t_mark;
      t_mark = now;
    }
  };
  const float* m = a.meta + crop * 9;
  const bool identity = m[8] != 0.0f;
  const int half =
      a.halves == nullptr ? tap_sum_half(k_pad) : a.halves[crop / a.per_image];
  float* dbg_w = a.taps_w == nullptr ? nullptr : a.taps_w + (size_t)crop * 2 * out * k_pad;
  int* dbg_s = a.taps_s == nullptr ? nullptr : a.taps_s + (size_t)crop * 2 * out;
  const bool dbg_x = dbg_w != nullptr && e0 == 0;  // one block of the crop writes the x taps
  for (int o = tid; o < out; o += THREADS) {
    int start, count;
    axis_taps(m[0], m[2], m[4], m[6], identity, o, k_pad, half, wx + o * k_pad, &start, &count,
              dbg_x ? dbg_w + o * k_pad : nullptr, dbg_x ? dbg_s + o : nullptr);
    clip_taps(start, count, a.PW, xs + o, xk + o, xn + o);
  }
  for (int r = tid; r < e1 - e0; r += THREADS) {
    int start, count;
    axis_taps(m[1], m[3], m[5], m[7], identity, e0 + r, k_pad, half, wy + r * k_pad, &start,
              &count, dbg_w ? dbg_w + (out + e0 + r) * k_pad : nullptr,
              dbg_w ? dbg_s + out + e0 + r : nullptr);
    clip_taps(start, count, a.PH, ys + r, yk + r, yn + r);
  }
  for (int i = tid; i < 3 * 256; i += THREADS) {
    const int ch = i >> 8;
    table[i] = __float2bfloat16_rn(
        __fdiv_rn(__fsub_rn(static_cast<float>(i & 255), a.norm.m[ch]), a.norm.s[ch]));
  }
  __syncthreads();
  if (tid < 32) {  // the columns the crop's taps reach
    int lo = INT_MAX, hi = 0;
    for (int o = tid; o < out; o += 32)
      if (xn[o] > 0) {
        lo = min(lo, xs[o]);
        hi = max(hi, xs[o] + xn[o]);
      }
    for (int d = 16; d > 0; d >>= 1) {
      lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, d));
      hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, d));
    }
    if (tid == 0) {
      span[0] = lo;
      span[1] = hi;
    }
  }
  __syncthreads();
  // staged source pixels [c_lo, c_lo + px) of each row, a 4-byte word
  // each (R, G, B, x): 16-pixel units (48 source bytes, three 16-byte
  // loads) covering the reached columns
  const int c_lo = span[1] > span[0] ? span[0] & ~15 : 0;
  const int px = span[1] > span[0] ? (span[1] - c_lo + 15) & ~15 : 16;
  const int chunk = max(1, a.cap / (4 * px));  // source rows a staging
  lap(0);

  const uint8_t* img = a.images + (size_t)(crop / a.per_image) * a.image_stride;
  const int row_bytes = a.PW * 3;
  bf16* dst = a.dst + (size_t)crop * out * rp;
  uint32_t* src32 = reinterpret_cast<uint32_t*>(src);
  int done = 0;  // the ring holds the horizontal results of the rows below `done` it needs
  for (int r = e0; r < e1;) {
    // the sub-band [r, r1): rows whose taps reach source rows [lo, hi),
    // at most T of them
    int lo = INT_MAX, hi = INT_MIN, r1 = r;
    for (; r1 < e1; ++r1) {
      const int n = yn[r1 - e0];
      if (n == 0) continue;
      const int l = min(lo, ys[r1 - e0]), h = max(hi, ys[r1 - e0] + n);
      if (h - l > T) break;  // never on the first: a row reaches k_pad <= T rows
      lo = l;
      hi = h;
    }
    for (int c0 = max(lo, done); c0 < hi; c0 += chunk) {
      // stage source rows [c0, c1), then their horizontal pass
      const int c1 = min(hi, c0 + chunk), units = px >> 4;
      for (int i = tid; i < (c1 - c0) * units; i += THREADS) {
        const int row = i / units, u = i - row * units;
        const int b = 3 * (c_lo + 16 * u);  // the unit's first source byte
        const uint8_t* g = img + (size_t)(c0 + row) * row_bytes + b;
        uint32_t w[12];
        if (a.aligned && b + 48 <= row_bytes) {
#pragma unroll
          for (int q = 0; q < 3; ++q) {
            const uint4 v = __ldg(reinterpret_cast<const uint4*>(g) + q);
            w[4 * q] = v.x;
            w[4 * q + 1] = v.y;
            w[4 * q + 2] = v.z;
            w[4 * q + 3] = v.w;
          }
        } else {  // the row's tail, or rows not 16-byte aligned: bytes, zero past the row
#pragma unroll
          for (int q = 0; q < 12; ++q) {
            uint32_t word = 0;
#pragma unroll
            for (int j = 0; j < 4; ++j)
              if (b + 4 * q + j < row_bytes) word |= uint32_t(g[4 * q + j]) << (8 * j);
            w[q] = word;
          }
        }
        store_pixels(w, reinterpret_cast<uint4*>(src32 + row * px + 16 * u));
      }
      __syncthreads();
      lap(1);
      const int groups = (c1 - c0 + ROW_GROUP - 1) / ROW_GROUP;
      for (int i = tid; i < groups * out; i += THREADS) {
        const int g0 = (i / out) * ROW_GROUP, o = i - (i / out) * out;
        float acc[ROW_GROUP][3] = {};
        const int n = xn[o];
        const bf16* w = wx + o * k_pad + xk[o];
        const uint32_t* p = src32 + g0 * px + (xs[o] - c_lo);
        for (int k = 0; k < n; ++k, ++p) {
          const float wk = __bfloat162float(w[k]);
#pragma unroll
          for (int r = 0; r < ROW_GROUP; ++r) {
            if (g0 + r < c1 - c0) {
              const uint32_t v = p[r * px];
              acc[r][0] = __fmaf_rn(wk, widen<0>(v), acc[r][0]);
              acc[r][1] = __fmaf_rn(wk, widen<1>(v), acc[r][1]);
              acc[r][2] = __fmaf_rn(wk, widen<2>(v), acc[r][2]);
            }
          }
        }
        int slot = (c0 + g0) % T;
#pragma unroll
        for (int r = 0; r < ROW_GROUP; ++r) {
          if (g0 + r < c1 - c0) {
            uint8_t* q = ring + slot * rp + 3 * o;
#pragma unroll
            for (int ch = 0; ch < 3; ++ch) q[ch] = static_cast<uint8_t>(round_u8(acc[r][ch]));
          }
          slot = slot + 1 == T ? 0 : slot + 1;
        }
      }
      __syncthreads();
      lap(2);
    }
    done = max(done, hi);
    // vertical pass, rounded, normalised by the table, 16 bytes a thread
    const int groups = rp >> 3;
    for (int i = tid; i < (r1 - r) * groups; i += THREADS) {
      const int el = r - e0 + i / groups, j = i - (i / groups) * groups;
      float acc[8] = {};
      const int n = yn[el];
      const bf16* w = wy + el * k_pad + yk[el];
      for (int k = 0, slot = n > 0 ? ys[el] % T : 0; k < n; ++k) {
        const float wk = __bfloat162float(w[k]);
        const uint2 v = *reinterpret_cast<const uint2*>(ring + slot * rp + 8 * j);
        acc[0] = __fmaf_rn(wk, widen<0>(v.x), acc[0]);
        acc[1] = __fmaf_rn(wk, widen<1>(v.x), acc[1]);
        acc[2] = __fmaf_rn(wk, widen<2>(v.x), acc[2]);
        acc[3] = __fmaf_rn(wk, widen<3>(v.x), acc[3]);
        acc[4] = __fmaf_rn(wk, widen<0>(v.y), acc[4]);
        acc[5] = __fmaf_rn(wk, widen<1>(v.y), acc[5]);
        acc[6] = __fmaf_rn(wk, widen<2>(v.y), acc[6]);
        acc[7] = __fmaf_rn(wk, widen<3>(v.y), acc[7]);
        slot = slot + 1 == T ? 0 : slot + 1;
      }
      const unsigned short* bits = reinterpret_cast<const unsigned short*>(table);
      uint32_t word[4];
      int ch = (8 * j) % 3;  // the channel of value 8 j
#pragma unroll
      for (int v = 0; v < 8; v += 2) {
        const uint32_t lo = bits[ch * 256 + round_u8(acc[v])];
        ch = ch == 2 ? 0 : ch + 1;
        const uint32_t hi = bits[ch * 256 + round_u8(acc[v + 1])];
        ch = ch == 2 ? 0 : ch + 1;
        word[v >> 1] = lo | (hi << 16);
      }
      *reinterpret_cast<uint4*>(dst + (size_t)(e0 + el) * rp + 8 * j) =
          make_uint4(word[0], word[1], word[2], word[3]);
    }
    __syncthreads();  // the ring's rows, before the next sub-band rewrites them
    lap(3);
    r = r1;
  }
  if (timed)
    for (int i = 0; i < 4; ++i) a.cycles[4 * (size_t)blockIdx.x + i] = spent[i];
}

}  // namespace
}  // namespace oadp

extern "C" {

// Checked by the Python wrapper (oadp_torch/ops/preprocess.py:resize_crops):
// images uint8 (G, PH, PW, 3), each image's (PH, PW, 3) contiguous, image g
// at images + g * image_stride; meta (G * per_image, 9) fp32 contiguous;
// halves (G) int32 (tap_sum_half of each image's own tap count) or null;
// dst (G * per_image, out, out, 3) bf16 contiguous, out a multiple of 8;
// taps_w (crops, 2, out, k_pad) fp32 and taps_s (crops, 2, out) int32 both
// given or both null. The layout, as planned by the wrapper: bands a crop
// of band output rows each (ops/preprocess.py:resize_bands), ring >= k_pad
// rows and cap >= 16 bytes (resize_stage_plan), smem bytes
// (resize_smem; refused unless it is smem_bytes'). cycles (G * per_image *
// bands, 4) int64 or null.
int oadp_resize_crops(const void* images, long long image_stride, int G, int per_image, int PH,
                      int PW, const void* meta, int k_pad, const void* halves, int out,
                      float m0, float m1, float m2, float s0, float s1, float s2, int bands,
                      int band, int ring, int cap, int smem, void* dst, void* taps_w,
                      void* taps_s, void* cycles, void* stream) {
  using namespace oadp;
  if (G <= 0 || per_image <= 0) return cudaSuccess;
  if (k_pad <= 0 || k_pad > MAX_TAPS || out <= 0 || out % 8 || PH <= 0 || PW <= 0 ||
      ring < k_pad || cap < 16 || cap % 16 || band <= 0 || bands <= 0 ||
      (long long)bands * band < out || (bands - 1) * band >= out)
    return cudaErrorInvalidValue;
  if (smem != smem_bytes(ring, out, band, cap, k_pad) || smem > 232448)
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
  a.band = band;
  a.bands = bands;
  a.ring = ring;
  a.cap = cap;
  a.aligned = reinterpret_cast<uintptr_t>(images) % 16 == 0 && image_stride % 16 == 0 &&
              (PW * 3) % 16 == 0;
  a.norm = Scalars{{m0, m1, m2}, {s0, s1, s2}};
  a.dst = static_cast<bf16*>(dst);
  a.taps_w = static_cast<float*>(taps_w);
  a.taps_s = static_cast<int*>(taps_s);
  a.cycles = static_cast<long long*>(cycles);
  cudaError_t e = cudaFuncSetAttribute(resize_crops_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const long long blocks = (long long)G * per_image * bands;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  resize_crops_kernel<<<(int)blocks, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

}  // extern "C"
