// The CLIP image encoders' patch embedding around its product: the conv's
// im2col rows (patch_rows) and the CLS token, positional embedding and
// ln_pre (embed_ln_pre). The product itself, rows x conv1 K-major, is an
// ln_gemm launch without LayerNorm or epilogue (ops/embed.py:patch_embed).
//
// Replaces what oadp_tpu leaves to XLA (not a Pallas kernel):
// oadp_tpu/models/clip.py:331-364 _embed_patches (the strided conv at :350,
// or the patch reshape and product at stride = patch) and the ln_pre
// LayerNorm at :423. The port's route before these kernels computed the
// half-stride conv as one product of the image's non-overlapping blocks
// with four sub-kernels: a (B, 15, 15, 4, D) fp32 partial tensor (5.66 GB
// at 2048 crops) and its shifted sums, then a cast, a concatenation, an add
// and F.layer_norm, each a pass over device memory.
//
// patch_rows: crops (B, H, W, 3) bf16 -> rows (B * g * g, 3 * P * P) bf16,
//   row (b, gy, gx), column (c, i, j) in the order of conv1.reshape(D, -1)
//   over the (D, 3, P, P) layout:
//     rows[(b * g + gy) * g + gx][(c * P + i) * P + j]
//       = crops[b][gy * S + i - pad][gx * S + j - pad][c], 0 outside.
//   Bound: bytes (0.62 GB read, 2.47 GB written at 2048 crops of the half
//   stride: ~0.92 ms). A block per (b, gy) stages the P source rows of its
//   band in shared memory (16-byte loads) and writes its g rows in 16-byte
//   stores of 8 consecutive j, so every store is coalesced.
//
// embed_ln_pre: x = ln_pre(cat(cls, rows) + pos), rounding as the plain
//   route does: the sum of two bf16 values rounded to bf16, then LayerNorm
//   with fp32 statistics (eps 1e-5) and the bf16-rounded scale and bias
//   (passed as fp32), rounded once. Bound: bytes (0.62 GB read, 0.62 GB
//   written at 2048 crops: ~0.37 ms). A warp a row, the row in registers.
#include "common.cuh"

namespace oadp {
namespace {

constexpr int THREADS = 256;
constexpr int EMBED_CHUNKS = 4;  // D <= 32 * 8 * EMBED_CHUNKS

__global__ void __launch_bounds__(THREADS)
    patch_rows_kernel(const bf16* __restrict__ crops, int H, int W, int P, int S, int pad, int g,
                      bf16* __restrict__ rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* band = reinterpret_cast<uint4*>(smem);  // (P, W * 3) bf16
  const bf16* sb = reinterpret_cast<const bf16*>(smem);
  const int b = blockIdx.x / g, gy = blockIdx.x % g;
  const int y0 = gy * S - pad;
  const int vec_row = W * 3 / 8;
  const uint4 zero = make_uint4(0, 0, 0, 0);
  for (int i = threadIdx.x; i < P * vec_row; i += THREADS) {
    const int r = i / vec_row, y = y0 + r;
    band[i] = (y >= 0 && y < H)
                  ? reinterpret_cast<const uint4*>(crops + ((size_t)b * H + y) * W * 3)[i % vec_row]
                  : zero;
  }
  __syncthreads();
  const int K = 3 * P * P, chunks = K / 8;
  uint4* out = reinterpret_cast<uint4*>(rows + (size_t)blockIdx.x * g * K);
  for (int i = threadIdx.x; i < g * chunks; i += THREADS) {
    const int gx = i / chunks, e = (i % chunks) * 8;
    const int c = e / (P * P), r = (e / P) % P, x0 = gx * S - pad + e % P;
    const bf16* src = sb + (size_t)r * W * 3 + c;
    uint4 v;
    bf16* h = reinterpret_cast<bf16*>(&v);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int x = x0 + j;
      h[j] = (x >= 0 && x < W) ? src[x * 3] : __float2bfloat16_rn(0.0f);
    }
    out[i] = v;
  }
}

__global__ void __launch_bounds__(THREADS)
    embed_ln_pre_kernel(const bf16* __restrict__ rows, const bf16* __restrict__ cls,
                        const bf16* __restrict__ pos, const float* __restrict__ gamma,
                        const float* __restrict__ beta, int B, int T, int D,
                        bf16* __restrict__ out) {
  const int row = (blockIdx.x * THREADS + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= B * T) return;
  const int b = row / T, t = row % T;
  const uint4* src = reinterpret_cast<const uint4*>(
      t == 0 ? cls : rows + ((size_t)b * (T - 1) + t - 1) * D);
  const uint4* p4 = reinterpret_cast<const uint4*>(pos + (size_t)t * D);
  uint4* q = reinterpret_cast<uint4*>(out + (size_t)row * D);
  const int chunks = D / 8;
  float f[EMBED_CHUNKS][8];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < EMBED_CHUNKS; ++i) {
    const int c = lane + 32 * i;
    if (c < chunks) {
      float x[8], y[8];
      unpack8(src[c], x);
      unpack8(p4[c], y);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        // the token plus its position, rounded to bf16 as a bf16 add is
        f[i][j] = __bfloat162float(__float2bfloat16_rn(__fadd_rn(x[j], y[j])));
        s += f[i][j];
      }
    }
  }
  const float mean = warp_sum(s) / D;
  float v = 0.f;
#pragma unroll
  for (int i = 0; i < EMBED_CHUNKS; ++i) {
    if (lane + 32 * i < chunks) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float d = f[i][j] - mean;
        v += d * d;
      }
    }
  }
  const float rstd = rsqrtf(warp_sum(v) / D + 1e-5f);
#pragma unroll
  for (int i = 0; i < EMBED_CHUNKS; ++i) {
    const int c = lane + 32 * i;
    if (c < chunks) {
      const float4* g4 = reinterpret_cast<const float4*>(gamma + c * 8);
      const float4* b4 = reinterpret_cast<const float4*>(beta + c * 8);
      const float4 g0 = g4[0], g1 = g4[1], b0 = b4[0], b1 = b4[1];
      const float gg[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
      const float bb[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int j = 0; j < 8; ++j) f[i][j] = (f[i][j] - mean) * rstd * gg[j] + bb[j];
      q[c] = pack8(f[i]);
    }
  }
}

}  // namespace
}  // namespace oadp

extern "C" {

// Checked by the Python wrapper (oadp_torch/ops/embed.py:patch_rows): crops
// (B, H, W, 3) and rows (B * g * g, 3 * P * P) bf16, contiguous, 16-byte
// aligned; W * 3 % 8 == 0, P % 8 == 0, g = (H + 2 * pad - P) / S + 1.
int oadp_patch_rows(const void* crops, int B, int H, int W, int P, int S, int pad, int g,
                    void* rows, void* stream) {
  using namespace oadp;
  if (B <= 0) return cudaSuccess;
  if ((W * 3) % 8 || P % 8 || g <= 0 || S <= 0) return cudaErrorInvalidValue;
  const size_t smem = (size_t)P * W * 3 * 2;
  if (smem > 232448 || (long long)B * g > INT32_MAX) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(patch_rows_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  patch_rows_kernel<<<B * g, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(crops), H, W, P, S, pad, g, static_cast<bf16*>(rows));
  return cudaGetLastError();
}

// Checked by the Python wrapper (oadp_torch/ops/embed.py:embed_ln_pre):
// rows (B, T - 1, D), cls (D), pos (T, D) and out (B, T, D) bf16, gamma and
// beta (D) fp32, all contiguous and 16-byte aligned; D % 8 == 0, D <= 1024.
int oadp_embed_ln_pre(const void* rows, const void* cls, const void* pos, const void* gamma,
                      const void* beta, int B, int T, int D, void* out, void* stream) {
  using namespace oadp;
  if (B <= 0) return cudaSuccess;
  if (D % 8 || D > 32 * 8 * EMBED_CHUNKS || T < 1) return cudaErrorInvalidValue;
  const long long warps = (long long)B * T, per_block = THREADS / 32;
  const long long blocks = (warps + per_block - 1) / per_block;
  if (blocks > INT32_MAX) return cudaErrorInvalidValue;
  embed_ln_pre_kernel<<<(int)blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(rows), static_cast<const bf16*>(cls),
      static_cast<const bf16*>(pos), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), B, T, D, static_cast<bf16*>(out));
  return cudaGetLastError();
}

}  // extern "C"
