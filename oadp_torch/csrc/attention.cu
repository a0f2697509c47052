// attention: per-(crop, head) softmax attention over a packed QKV tensor,
// with the OAKE side row (the masked attention pool) as an extra query.
//
// The second kernel family behind the ported Pallas kernels of
// oadp_tpu/ops/attention.py: the per-head attention of _surgery_layer_kernel
// (main rows and side row), of _ln_qkv_attn_kernel and _mha_packed_kernel
// (main rows only) and of _side_attn_kernel (side row only).
//
//   q, k, v, out (B, N, D): each its own base pointer, crop stride and row
//   stride (in elements), so they may be column slices of one packed
//   (B, N, 3D) qkv or (B, N, 2D) kv; heads are 64-wide column slices (no
//   transpose is materialised).
//   main rows (out != nullptr): out[b, r, h*64:] = softmax(q k^T * scale) v.
//   side row (side_out != nullptr): query qy[b, h*64:] over keys [k[1:], ky]
//   and values [v[1:], vy] (qy, ky, vy: (B, D) rows, each with its own row
//   stride), with the additive bias (B, N) = [patch biases..., y bias].
//
// TPU semantics kept exactly (oadp_tpu/ops/attention.py:46-50, 93-99): the
// logits are clamped at 80 before exp, with no max subtraction, and the
// normalisation runs after the PV product; exp weights are rounded to bf16
// for the PV product while the row sums stay fp32, as in the Pallas body.
// Because there is no running max, key chunks need no rescaling: each
// 16-key chunk's exp weights go straight from the score registers into
// the PV product.
//
// Bound on the H100: one (crop, head) is 2 x 197 x 197 x 64 x 2 = 10 MFLOP on
// 75 KB of q/k/v, about 130 FLOP/byte, under the card's ridge; at the
// objects batch the layer's attention is 0.24 TFLOP against 1.2 GB of qkv,
// so reading qkv bounds it. The design reads each of q, k and v once: one
// block per (crop, head) stages K and V of the head in shared memory with
// cp.async (2 x 208 x 72 bf16 = 60 KB, three blocks an SM), each warp
// takes 32 query rows at a time with Q loaded straight into registers,
// and scores, exp weights and the output stay in registers (mma.sync
// m16n8k16, ldmatrix for K and V). The side row alone (_side_attn_kernel)
// is 4 x N x 64 FLOP a head against the head's K and V: reading K and V
// (1.24 GB at 2048 crops) bounds it, and each is read once.
#include "common.cuh"

namespace oadp {
namespace {

constexpr int HD = 64;         // head width this kernel is written for
constexpr int WARPS = 4;
constexpr int KV_LD = HD + 8;  // padded shared-memory rows

__host__ __device__ inline int padded_tokens(int N) { return (N + 15) & ~15; }

// K, V, then the side row's fp32 scratch
__host__ __device__ inline int smem_bytes(int N) {
  return 2 * padded_tokens(N) * KV_LD * (int)sizeof(bf16) +
         (padded_tokens(N) + WARPS * HD + WARPS) * (int)sizeof(float);
}

// Operands of one launch; strides are in elements.
struct Args {
  int N;
  float scale;
  const bf16* q; long long q_bs; int q_ld;  // main queries (main rows only)
  const bf16* k; long long k_bs; int k_ld;
  const bf16* v; long long v_bs; int v_ld;
  bf16* out; long long out_bs; int out_ld;  // main rows, or nullptr
  const bf16* qy; int qy_ld;                // side row (with side_out)
  const bf16* ky; int ky_ld;
  const bf16* vy; int vy_ld;
  const float* bias;                        // (B, N), contiguous
  bf16* side_out; int side_ld;              // side row, or nullptr
};

__global__ void __launch_bounds__(WARPS * 32) attention_kernel(const Args a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int N = a.N;
  const int np = padded_tokens(N);
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + np * KV_LD;

  const bf16* kb = a.k + (size_t)b * a.k_bs + h * HD;
  const bf16* vb = a.v + (size_t)b * a.v_bs + h * HD;
  // Stage K and V of this head with every copy in flight at once; rows
  // N..np-1 are zero-filled.
  for (int c = tid; c < np * 8; c += WARPS * 32) {
    const int r = c >> 3, cc = (c & 7) * 8;
    const size_t rr = r < N ? r : 0;
    cp_async16(Ks + r * KV_LD + cc, kb + rr * a.k_ld + cc, r < N);
    cp_async16(Vs + r * KV_LD + cc, vb + rr * a.v_ld + cc, r < N);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  if (a.out != nullptr) {
    const bf16* qb = a.q + (size_t)b * a.q_bs + h * HD;
    // Each warp takes 32 query rows at a time as two 16-row tiles that
    // share every K and V fragment load: twice the independent MMAs per
    // load, which is what the warp's latency hiding runs on.
    const int g = lane >> 2, t = lane & 3;
    for (int r0 = warp * 32; r0 < N; r0 += WARPS * 32) {
      // Q fragments straight from global memory (the A operand layout):
      // register j of k-step ks holds rows g (+8 for j odd) and columns
      // ks*16 + 2t (+8 for j >= 2).
      unsigned qf[2][HD / 16][4];
#pragma unroll
      for (int tile = 0; tile < 2; ++tile) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int row = r0 + tile * 16 + g + (j & 1) * 8;
          const bf16* src = qb + (size_t)row * a.q_ld + 2 * t + (j >> 1) * 8;
#pragma unroll
          for (int ks = 0; ks < HD / 16; ++ks)
            qf[tile][ks][j] = row < N ? *reinterpret_cast<const unsigned*>(src + ks * 16) : 0u;
        }
      }

      float o[2][HD / 8][4];
#pragma unroll
      for (int tile = 0; tile < 2; ++tile)
#pragma unroll
        for (int i = 0; i < HD / 8; ++i) o[tile][i][0] = o[tile][i][1] = o[tile][i][2] = o[tile][i][3] = 0.f;
      float sums[2][2] = {{0.f, 0.f}, {0.f, 0.f}};  // [tile][rows g, g + 8]

      for (int k0 = 0; k0 < np; k0 += 16) {
        // scores of 16 keys: s[tile][j] covers keys k0 + 8j .. k0 + 8j + 7
        float s[2][2][4];
#pragma unroll
        for (int tile = 0; tile < 2; ++tile)
#pragma unroll
          for (int j = 0; j < 2; ++j) s[tile][j][0] = s[tile][j][1] = s[tile][j][2] = s[tile][j][3] = 0.f;
#pragma unroll
        for (int ks = 0; ks < HD / 16; ++ks) {
          unsigned kf[4];
          ldmatrix_x4(kf, Ks + (k0 + (lane & 7) + ((lane >> 4) << 3)) * KV_LD + ks * 16 +
                              ((lane >> 3) & 1) * 8);
#pragma unroll
          for (int tile = 0; tile < 2; ++tile) {
            mma_bf16(s[tile][0], qf[tile][ks], kf[0], kf[1]);
            mma_bf16(s[tile][1], qf[tile][ks], kf[2], kf[3]);
          }
        }
        // exp(min(s, 80)); padded keys weigh 0; the score fragments are
        // the A operand of P V (keys as k)
        unsigned pa[2][4];
#pragma unroll
        for (int tile = 0; tile < 2; ++tile) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int key = k0 + j * 8 + 2 * t + (e & 1);
              const float w =
                  key < N ? exp2f(fminf(s[tile][j][e] * a.scale, 80.f) * 1.4426950408889634f) : 0.f;
              s[tile][j][e] = w;
              sums[tile][e >> 1] += w;
            }
          }
          pa[tile][0] = pack2(s[tile][0][0], s[tile][0][1]);
          pa[tile][1] = pack2(s[tile][0][2], s[tile][0][3]);
          pa[tile][2] = pack2(s[tile][1][0], s[tile][1][1]);
          pa[tile][3] = pack2(s[tile][1][2], s[tile][1][3]);
        }
#pragma unroll
        for (int dp = 0; dp < HD / 16; ++dp) {
          unsigned vf[4];
          ldmatrix_x4_trans(vf, Vs + (k0 + (lane & 15)) * KV_LD + dp * 16 + (lane >> 4) * 8);
#pragma unroll
          for (int tile = 0; tile < 2; ++tile) {
            mma_bf16(o[tile][2 * dp], pa[tile], vf[0], vf[1]);
            mma_bf16(o[tile][2 * dp + 1], pa[tile], vf[2], vf[3]);
          }
        }
      }
#pragma unroll
      for (int tile = 0; tile < 2; ++tile) {
        // each row's sum is spread over the four lanes of its quad
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          sums[tile][hh] += __shfl_xor_sync(0xffffffffu, sums[tile][hh], 1);
          sums[tile][hh] += __shfl_xor_sync(0xffffffffu, sums[tile][hh], 2);
        }
        const int row = r0 + tile * 16 + g;
        bf16* dst = a.out + (size_t)b * a.out_bs + (size_t)row * a.out_ld + h * HD + 2 * t;
#pragma unroll
        for (int n = 0; n < HD / 8; ++n) {
          if (row < N)
            *reinterpret_cast<__nv_bfloat162*>(dst + n * 8) = __floats2bfloat162_rn(
                o[tile][n][0] / sums[tile][0], o[tile][n][1] / sums[tile][0]);
          if (row + 8 < N)
            *reinterpret_cast<__nv_bfloat162*>(dst + 8 * (size_t)a.out_ld + n * 8) =
                __floats2bfloat162_rn(o[tile][n][2] / sums[tile][1], o[tile][n][3] / sums[tile][1]);
        }
      }
    }
  }

  if (a.side_out != nullptr) {
    // One query per crop: first one key per thread (index 0 stands for
    // y's own key, index j >= 1 for patch key j), then one head-dim pair
    // per lane with the keys split over the warps, then a sum over warps.
    float* E = reinterpret_cast<float*>(Vs + np * KV_LD);  // [np]
    float* part = E + np;                                // [WARPS][HD]
    float* psum = part + WARPS * HD;                     // [WARPS]
    const bf16* qy = a.qy + (size_t)b * a.qy_ld + h * HD;
    const bf16* ky = a.ky + (size_t)b * a.ky_ld + h * HD;
    const bf16* vy = a.vy + (size_t)b * a.vy_ld + h * HD;
    const float* bb = a.bias + (size_t)b * N;
    for (int j = tid; j < N; j += WARPS * 32) {
      const bf16* kr = j == 0 ? ky : Ks + j * KV_LD;
      float acc = 0.f;
#pragma unroll
      for (int d = 0; d < HD; d += 8) {
        float fq[8], fk[8];
        unpack8(*reinterpret_cast<const uint4*>(qy + d), fq);
        unpack8(*reinterpret_cast<const uint4*>(kr + d), fk);
#pragma unroll
        for (int i = 0; i < 8; ++i) acc += fq[i] * fk[i];
      }
      E[j] = expf(fminf(acc * a.scale + (j == 0 ? bb[N - 1] : bb[j - 1]), 80.f));
    }
    __syncthreads();
    float sum = 0.f, o0 = 0.f, o1 = 0.f;
    for (int j = 1 + warp; j < N; j += WARPS) {
      const float e = E[j];
      sum += e;
      const float eb = __bfloat162float(__float2bfloat16(e));  // P is bf16 in the product
      const float2 v = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(Vs + j * KV_LD + 2 * lane));
      o0 += eb * v.x;
      o1 += eb * v.y;
    }
    part[warp * HD + 2 * lane] = o0;
    part[warp * HD + 2 * lane + 1] = o1;
    if (lane == 0) psum[warp] = sum;
    __syncthreads();
    if (warp == 0) {
      o0 = o1 = sum = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        o0 += part[w * HD + 2 * lane];
        o1 += part[w * HD + 2 * lane + 1];
        sum += psum[w];
      }
      const float ey = E[0];
      const float2 fy = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(vy + 2 * lane));
      o0 += ey * fy.x;
      o1 += ey * fy.y;
      const float z = sum + ey;
      *reinterpret_cast<__nv_bfloat162*>(a.side_out + (size_t)b * a.side_ld + h * HD + 2 * lane) =
          __floats2bfloat162_rn(o0 / z, o1 / z);
    }
  }
}

}  // namespace
}  // namespace oadp

extern "C" {

// Checked by the Python wrapper: head width 64, N <= 256, B < 65536, every
// pointer 16-byte aligned and every stride a multiple of 8 elements.
int oadp_attention(int B, int N, int heads, float scale, const void* q, long long q_bs,
                   int q_ld, const void* k, long long k_bs, int k_ld, const void* v,
                   long long v_bs, int v_ld, void* out, long long out_bs, int out_ld,
                   const void* qy, int qy_ld, const void* ky, int ky_ld, const void* vy,
                   int vy_ld, const float* bias, void* side_out, int side_ld, void* stream) {
  using namespace oadp;
  const int smem = smem_bytes(N);
  cudaError_t e = cudaFuncSetAttribute(
      attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const Args a{N,
               scale,
               static_cast<const bf16*>(q), q_bs, q_ld,
               static_cast<const bf16*>(k), k_bs, k_ld,
               static_cast<const bf16*>(v), v_bs, v_ld,
               static_cast<bf16*>(out), out_bs, out_ld,
               static_cast<const bf16*>(qy), qy_ld,
               static_cast<const bf16*>(ky), ky_ld,
               static_cast<const bf16*>(vy), vy_ld,
               bias,
               static_cast<bf16*>(side_out), side_ld};
  dim3 grid(heads, B);
  attention_kernel<<<grid, WARPS * 32, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

}  // extern "C"
