// long_attention: per-(crop, head) softmax attention past 256 tokens, with
// the OAKE side row (the masked attention pool) as an extra query, K and V
// streamed through shared memory in 64-key tiles.
//
// The same function as attention.cu (the per-head attention of
// oadp_tpu/ops/attention.py:_surgery_layer_kernel, _mha_packed_kernel and
// _side_attn_kernel) for the sequences that attention.cu cannot hold: it
// keeps a whole (crop, head) item's K and V on chip, which caps it at 256
// tokens. OADP's surgery on a 14-px tower (CLIP ViT-L/14: a 32 x 32 grid,
// 1,025 tokens) needs four times that.
//
//   q, k, v, out (B, N, D): each its own base pointer, crop stride and row
//   stride (in elements), so they may be column slices of one packed qkv;
//   heads are 64-wide column slices.
//   main rows (out != nullptr): out[b, r, h*64:] = softmax(q k^T * scale) v.
//   side row (side_out != nullptr): query qy[b, h*64:] over keys [k[1:], ky]
//   and values [v[1:], vy] with the additive fp32 bias (B, N) = [patch
//   biases..., y bias].
//
// Semantics as attention.cu's (oadp_tpu/ops/attention.py:46-50, 93-99):
// logits clamped at 80 before exp, no max subtracted, exp weights rounded
// to bf16 for the PV product (y's own weight on the side row is not), fp32
// row sums, the normalisation after the product. Because of the clamp a
// streamed kernel needs no running max and no rescale: each key tile's
// exp weights go straight into the PV product. The sum of N terms of at
// most e^80 stays finite in fp32 up to about 6,100 keys.
//
// Bound on the H100: one (crop, head) at N = 1,025 is 4 x N x N x 64 =
// 269 MFLOP on 0.5 MB of q/k/v/out, about 520 FLOP/byte, above the card's
// ridge: the tensor cores bound it (9 ms a layer at 2,048 crops x 16
// heads), with N x N exps (MUFU) as a second limit of the same size at
// head width 64.
//
// Design: persistent blocks walk work units; a unit is W 16-row query
// tiles of one (crop, head) item (W consumer warps, one tile each; the
// side row rides as row N of the tile after the main rows). One producer
// warp loads a unit's Q tiles with one TMA into one of two Q slots, and
// streams the item's K and V in 64-key tiles (TMA, 128-byte swizzle, rows
// past N as zeros) through a ring of stages guarded by full/empty
// mbarriers, running ahead into the next unit. Each consumer warp keeps
// its Q fragments in registers and runs QK^T and PV on mma.sync m16n8k16
// with K and V fragments from ldmatrix in 32-key chunks, as attention.cu
// does (its notes: wgmma with P computed between the two products was
// serialised by ptxas and ran slower). The side row's warp adds the bias
// and drops key 0 (the main CLS) for that row alone, and adds y's own key
// and value at the end in fp32; its inputs (qy, ky, vy, the bias row) are
// copied into the unit's side slot by the producer warp's lanes with
// cp.async, tracked by the Q slot's barrier. With the side row alone (no
// main rows) a unit is one tile holding only the side row.
#include <algorithm>

#include "common.cuh"

namespace oadp {
namespace {

constexpr int HD = 64;             // head width this kernel is written for
constexpr int KT = 64;             // keys a K/V tile
// consumer warps: with the producer 12 warps, three to each SM
// sub-partition, so a thread may hold 168 registers (13 consumers, five
// units of 1,025 tokens, left 128 and spilled: 12% slower)
constexpr int MAX_WARPS = 11;
constexpr int MAX_STAGES = 8;      // K/V ring stages, at most
constexpr int SMEM_LIMIT = 232448; // dynamic shared memory a block may take
constexpr int TILE_BYTES = 16 * 128;     // a 16-row Q tile
constexpr int KV_BYTES = 2 * KT * 128;   // a stage: K and V tiles
constexpr float LOG2E = 1.4426950408889634f;

struct Layout {
  int q, side_slot, side, bars, stages, total;
};

// The ring of K/V stages first (1024-byte aligned for the swizzle), two Q
// slots of W tiles, two side slots (qy, ky, vy, then the bias row shifted
// by one key), the barriers: as many stages as fit, up to MAX_STAGES.
__host__ __device__ inline Layout layout(int warps, int kv_tiles) {
  Layout l;
  l.side_slot = (3 * HD * 2 + 4 * (kv_tiles * KT + 4) + 127) & ~127;
  const int fixed = 2 * warps * TILE_BYTES + 2 * l.side_slot + (4 + 2 * MAX_STAGES) * 8 + 1024;
  const int fit = (SMEM_LIMIT - fixed) / KV_BYTES;
  l.stages = fit < MAX_STAGES ? fit : MAX_STAGES;
  l.q = l.stages * KV_BYTES;
  l.side = l.q + 2 * warps * TILE_BYTES;
  l.bars = l.side + 2 * l.side_slot;
  l.total = l.bars + (4 + 2 * l.stages) * 8 + 1024;  // + slack to align to 1024
  return l;
}

struct Args {
  int B, N, heads;
  int warps;     // consumer warps = query tiles a unit
  int tiles;     // query tiles an item (the side row's included)
  int kv_tiles;  // 64-key tiles an item
  int per_item;  // units an item
  int side_tile, side_row;  // where the side row sits (tile, row in it)
  float scale;
  bf16* out; long long out_bs; int out_ld;  // main rows, or nullptr
  const bf16* qy; int qy_ld;                // side row (with side_out)
  const bf16* ky; int ky_ld;
  const bf16* vy; int vy_ld;
  const float* bias;                        // (B, N), contiguous
  bf16* side_out; int side_ld;              // side row, or nullptr
};

// Where a warp's side row sits: the lanes of row `g` (g = lane / 4) hold
// it, in the accumulators' low half (row g) or high half (row g + 8).
struct SideRow {
  bool lo, hi;
  const float* bias;  // the chunk's bias in log2 units, key j at bias[j]
};

// One chunk of KC keys (32, or 16 for the tail) of a warp's 16 query rows,
// as attention.cu's key_chunk: the scores on mma.sync from Q fragments in
// registers and K fragments from ldmatrix; the exp weights, the side row's
// logits (SIDE) biased (its bias row holds -inf at key 0, the main CLS,
// which then weighs 0), keys at or past `lim` weighing 0 with MASK; the
// PV product with the weights rounded to bf16 as its A operand and V from
// ldmatrix.trans.
template <int KC, bool MASK, bool SIDE>
__device__ __forceinline__ void key_chunk(const unsigned (&qf)[HD / 16][4], uint32_t Ks,
                                          uint32_t Vs, const Frag& f, int lim, float scale_log2,
                                          const SideRow& sr, int lane, float (&o)[HD / 8][4],
                                          float (&sums)[2]) {
  constexpr int NB = KC / 8;
  const int t = lane & 3;
  (void)sr;
  float s[NB][4];
#pragma unroll
  for (int j = 0; j < NB; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks) {
#pragma unroll
    for (int jj = 0; jj < NB / 2; ++jj) {
      unsigned kf[4];
      ldmatrix_x4(kf, Ks + jj * 16 * 128 + f.k[ks]);
      mma_bf16(s[2 * jj], qf[ks], kf[0], kf[1]);
      mma_bf16(s[2 * jj + 1], qf[ks], kf[2], kf[3]);
    }
  }
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    // the side row's bias for this lane's two keys, 0 on the other rows
    float add[4] = {0.f, 0.f, 0.f, 0.f};
    if (SIDE) {
      const float2 bb = *reinterpret_cast<const float2*>(sr.bias + j * 8 + 2 * t);
      add[0] = sr.lo ? bb.x : 0.f;
      add[1] = sr.lo ? bb.y : 0.f;
      add[2] = sr.hi ? bb.x : 0.f;
      add[3] = sr.hi ? bb.y : 0.f;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = j * 8 + 2 * t + (e & 1);
      const float x = SIDE ? fmaf(s[j][e], scale_log2, add[e]) : s[j][e] * scale_log2;
      const float w = ex2(fminf(x, 80.f * LOG2E));
      const bool keep = !MASK || key < lim;
      s[j][e] = keep ? w : 0.f;
      sums[e >> 1] += s[j][e];
    }
  }
#pragma unroll
  for (int kk = 0; kk < KC / 16; ++kk) {
    const unsigned pa[4] = {pack2(s[2 * kk][0], s[2 * kk][1]), pack2(s[2 * kk][2], s[2 * kk][3]),
                            pack2(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                            pack2(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
    for (int dp = 0; dp < HD / 16; ++dp) {
      unsigned vf[4];
      ldmatrix_x4_trans(vf, Vs + kk * 16 * 128 + f.v[dp]);
      mma_bf16(o[2 * dp], pa, vf[0], vf[1]);
      mma_bf16(o[2 * dp + 1], pa, vf[2], vf[3]);
    }
  }
}

// A K/V tile of `valid` keys (the item's last may hold fewer than 64):
// unmasked 32-key chunks, then masked ones up to the 16-row edge.
template <bool SIDE>
__device__ __forceinline__ void kv_tile(const unsigned (&qf)[HD / 16][4], uint32_t Ks,
                                        uint32_t Vs, const Frag& f, int valid, float scale_log2,
                                        SideRow sr, int lane, float (&o)[HD / 8][4],
                                        float (&sums)[2]) {
  const int edge = (valid + 15) & ~15;
  int j = 0;
  for (; j + 32 <= valid; j += 32, sr.bias += 32)
    key_chunk<32, false, SIDE>(qf, Ks + j * 128, Vs + j * 128, f, 0, scale_log2, sr, lane, o,
                               sums);
  for (; j + 32 <= edge; j += 32, sr.bias += 32)
    key_chunk<32, true, SIDE>(qf, Ks + j * 128, Vs + j * 128, f, valid - j, scale_log2, sr,
                              lane, o, sums);
  if (j < edge)
    key_chunk<16, true, SIDE>(qf, Ks + j * 128, Vs + j * 128, f, valid - j, scale_log2, sr,
                              lane, o, sums);
}

__global__ void __launch_bounds__(32 * (MAX_WARPS + 1), 1)
long_attention_kernel(__grid_constant__ const CUtensorMap tm_q,
                      __grid_constant__ const CUtensorMap tm_k,
                      __grid_constant__ const CUtensorMap tm_v, const Args a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const Layout l = layout(a.warps, a.kv_tiles);
  uint64_t* qfull = reinterpret_cast<uint64_t*>(base + l.bars);
  uint64_t* qempty = qfull + 2;
  uint64_t* kvfull = qempty + 2;
  uint64_t* kvempty = kvfull + l.stages;
  unsigned char* ring = base;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool with_q = a.out != nullptr;
  const bool side = a.side_out != nullptr;
  if (threadIdx.x == 0) {
    for (int s = 0; s < 2; ++s) {
      // the producer's arrive [, one per producer lane for its side copies]
      mbar_init(&qfull[s], side ? 33 : 1);
      mbar_init(&qempty[s], a.warps);
    }
    for (int s = 0; s < l.stages; ++s) {
      mbar_init(&kvfull[s], 1);
      mbar_init(&kvempty[s], a.warps);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int units = a.B * a.heads * a.per_item;
  if (warp == a.warps) {
    // producer: lane 0 loads a unit's Q tiles and streams the item's K and
    // V tiles, running ahead into the next unit as far as the slots allow;
    // the lanes copy the side row's inputs with cp.async
    int it = 0;
    for (int unit = blockIdx.x, u = 0; unit < units; unit += gridDim.x, ++u) {
      const int item = unit / a.per_item, part = unit % a.per_item;
      const int b = item / a.heads, h = item % a.heads;
      const int qs = u & 1;
      mbar_wait(&qempty[qs], ((u >> 1) & 1) ^ 1);  // the first pass finds both free
      if (lane == 0) {
        if (with_q) {
          mbar_arrive_expect_tx(&qfull[qs], a.warps * TILE_BYTES);  // rows past N as zeros
          tma_load_3d(base + l.q + qs * a.warps * TILE_BYTES, &tm_q, &qfull[qs], h * HD,
                      part * a.warps * 16, b);
        } else {
          mbar_arrive(&qfull[qs]);
        }
      }
      if (side) {
        const int first = part * a.warps;
        if (a.side_tile >= first && a.side_tile < first + a.warps) {
          unsigned char* in = base + l.side + qs * l.side_slot;
          if (lane < 24) {  // 8 16-byte chunks each of qy, ky, vy
            const int r = lane >> 3;
            const bf16* src = r == 0 ? a.qy + (size_t)b * a.qy_ld
                            : r == 1 ? a.ky + (size_t)b * a.ky_ld
                                     : a.vy + (size_t)b * a.vy_ld;
            cp_async16(in + lane * 16, src + h * HD + (lane & 7) * 8);
          }
          // key j's bias at [j]: patch j's is bias[j - 1], y's own bias[N - 1] at [N]
          float* bias = reinterpret_cast<float*>(in + 3 * HD * 2);
          for (int j = lane; j < a.N; j += 32)
            cp_async4(bias + 1 + j, a.bias + (size_t)b * a.N + j);
        }
        cp_async_arrive(&qfull[qs]);
      }
      for (int kt = 0; kt < a.kv_tiles; ++kt, ++it) {
        const int s = it % l.stages;
        mbar_wait(&kvempty[s], ((it / l.stages) & 1) ^ 1);
        if (lane == 0) {
          unsigned char* dst = ring + s * KV_BYTES;
          mbar_arrive_expect_tx(&kvfull[s], KV_BYTES);  // rows past N count, as zeros
          tma_load_3d(dst, &tm_k, &kvfull[s], h * HD, kt * KT, b);
          tma_load_3d(dst + KV_BYTES / 2, &tm_v, &kvfull[s], h * HD, kt * KT, b);
        }
      }
    }
    return;
  }

  const int g = lane >> 2, t = lane & 3;
  const Frag f = frag_offsets(lane);
  int it = 0;
  for (int unit = blockIdx.x, u = 0; unit < units; unit += gridDim.x, ++u) {
    const int item = unit / a.per_item, part = unit % a.per_item;
    const int b = item / a.heads, h = item % a.heads;
    const int qs = u & 1;
    const int tile = part * a.warps + warp;
    const bool active = tile < a.tiles;
    const bool side_tile = side && tile == a.side_tile;
    unsigned char* Qs = base + l.q + (qs * a.warps + warp) * TILE_BYTES;
    const unsigned char* in = base + l.side + qs * l.side_slot;
    mbar_wait(&qfull[qs], (u >> 1) & 1);
    if (side_tile) {
      // the side query into its row of the tile (a tile of zeros without
      // main rows)
      if (!with_q) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          reinterpret_cast<uint4*>(Qs)[lane * 4 + i] = make_uint4(0, 0, 0, 0);
        __syncwarp();
      }
      if (lane < 8)
        *reinterpret_cast<uint4*>(Qs + swz(a.side_row, lane)) =
            *reinterpret_cast<const uint4*>(in + lane * 16);
      __syncwarp();
    }
    unsigned qf[HD / 16][4];
    float o[HD / 8][4];
    float sums[2] = {0.f, 0.f};  // rows g, g + 8
#pragma unroll
    for (int i = 0; i < HD / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
    if (active) {
#pragma unroll
      for (int ks = 0; ks < HD / 16; ++ks)
        ldmatrix_x4(qf[ks], smem_u32(Qs) + swz(lane & 15, ks * 2 + (lane >> 4)));
    }
    const bool side_lane = side_tile && g == (a.side_row & 7);
    SideRow sr{side_lane && a.side_row < 8, side_lane && a.side_row >= 8,
               reinterpret_cast<const float*>(in + 3 * HD * 2)};
    if (side_tile) {
      // the keys' bias in log2 units, the main CLS's -inf (y's own at N
      // stays as it came)
      float* bias = reinterpret_cast<float*>(base + l.side + qs * l.side_slot + 3 * HD * 2);
      for (int j = lane; j < a.N; j += 32) bias[j] = j == 0 ? -INFINITY : bias[j] * LOG2E;
      __syncwarp();
    }
    for (int kt = 0; kt < a.kv_tiles; ++kt, ++it) {
      const int s = it % l.stages;
      mbar_wait(&kvfull[s], (it / l.stages) & 1);
      if (active) {
        const uint32_t Ks = smem_u32(ring + s * KV_BYTES), Vs = Ks + KV_BYTES / 2;
        const int valid = min(KT, a.N - kt * KT);
        if (side_tile) {
          kv_tile<true>(qf, Ks, Vs, f, valid, a.scale * LOG2E, sr, lane, o, sums);
        } else {
          kv_tile<false>(qf, Ks, Vs, f, valid, a.scale * LOG2E, sr, lane, o, sums);
        }
      }
      sr.bias += KT;
      __syncwarp();
      if (lane == 0) mbar_arrive(&kvempty[s]);
    }
    if (active) {
      // each row's sum is spread over the four lanes of its quad
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        sums[hh] += __shfl_xor_sync(0xffffffffu, sums[hh], 1);
        sums[hh] += __shfl_xor_sync(0xffffffffu, sums[hh], 2);
      }
      if (side_tile) {
        // y's own key and value, unrounded, then the side row's output
        const bf16* qy = reinterpret_cast<const bf16*>(in);
        const float* bias = reinterpret_cast<const float*>(in + 3 * HD * 2);
        const float2 q2 = __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(qy)[lane]);
        const float2 k2 =
            __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(qy + HD)[lane]);
        const float dot = warp_sum(q2.x * k2.x + q2.y * k2.y);
        const float ey = expf(fminf(dot * a.scale + bias[a.N], 80.f));
        if (side_lane) {
          // selects, not o[n][2 * hh]: an index known only at run time
          // would put the accumulators in local memory for the whole kernel
          const bool hi = sr.hi;
          const float inv = 1.f / ((hi ? sums[1] : sums[0]) + ey);
          bf16* dst = a.side_out + (size_t)b * a.side_ld + h * HD;
#pragma unroll
          for (int n = 0; n < HD / 8; ++n) {
            const int d0 = n * 8 + 2 * t;
            const float2 v2 = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(qy + 2 * HD + d0));
            *reinterpret_cast<__nv_bfloat162*>(dst + d0) = __floats2bfloat162_rn(
                ((hi ? o[n][2] : o[n][0]) + ey * v2.x) * inv,
                ((hi ? o[n][3] : o[n][1]) + ey * v2.y) * inv);
          }
        }
      }
      if (with_q) {
        // Stage the 16 x 64 output over this warp's own Q rows (its Q is in
        // registers), then write whole 128-byte rows, 16 bytes a lane.
        const float inv[2] = {1.f / sums[0], 1.f / sums[1]};
#pragma unroll
        for (int n = 0; n < HD / 8; ++n) {
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            *reinterpret_cast<__nv_bfloat162*>(Qs + swz(g + 8 * hh, n) + 4 * t) =
                __floats2bfloat162_rn(o[n][2 * hh] * inv[hh], o[n][2 * hh + 1] * inv[hh]);
          }
        }
        __syncwarp();
        bf16* dst = a.out + (size_t)b * a.out_bs + h * HD;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = i * 4 + (lane >> 3), c = lane & 7;
          const int row = tile * 16 + r;
          if (row < a.N)
            *reinterpret_cast<uint4*>(dst + (size_t)row * a.out_ld + c * 8) =
                *reinterpret_cast<const uint4*>(Qs + swz(r, c));
        }
      }
    }
    // the Q slot and the side slot may be overwritten by the next loads
    fence_proxy_async();
    __syncwarp();
    if (lane == 0) mbar_arrive(&qempty[qs]);
  }
}

}  // namespace
}  // namespace oadp

extern "C" {

// Checked by the Python wrapper (ops/attention.py:_attention): head width
// 64, N <= 4096 (it routes N > 256 here), every pointer 16-byte aligned
// and every stride a multiple of 8 elements; the crop stride of q, k and
// v at least N row strides.
int oadp_long_attention(int B, int N, int heads, float scale, const void* q, long long q_bs,
                        int q_ld, const void* k, long long k_bs, int k_ld, const void* v,
                        long long v_bs, int v_ld, void* out, long long out_bs, int out_ld,
                        const void* qy, int qy_ld, const void* ky, int ky_ld, const void* vy,
                        int vy_ld, const float* bias, void* side_out, int side_ld,
                        void* stream) {
  using namespace oadp;
  const bool with_q = out != nullptr;
  const bool side = side_out != nullptr;
  if (B <= 0 || N <= 0 || N > 4096 || (!with_q && !side)) return cudaErrorInvalidValue;
  // the side row: row N after the main rows, or alone in a tile of its own
  const int tiles = with_q ? (N + (side ? 1 : 0) + 15) / 16 : 1;
  // a unit's warps: the item's tiles over the fewest units of at most
  // MAX_WARPS, spread evenly (N = 1,025 with the side row: 65 tiles, 6
  // units of 11; N = 257: 17 tiles, 2 units of 9); the side row alone: 1
  const int fewest = (tiles + MAX_WARPS - 1) / MAX_WARPS;
  const int warps = (tiles + fewest - 1) / fewest;
  const int kv_tiles = (N + KT - 1) / KT;
  const Layout l = layout(warps, kv_tiles);
  if (l.stages < 2 || l.total > SMEM_LIMIT) return cudaErrorInvalidValue;
  static const cudaError_t attr = cudaFuncSetAttribute(
      long_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
  cudaError_t e = attr;
  if (e != cudaSuccess) return e;

  // (D, N, B) tensor maps over the column slices: Q boxes of W tiles, K and
  // V boxes of one 64-key tile, one head's 64 columns each
  CUtensorMap tm[3] = {};
  const void* ptr[3] = {q, k, v};
  const long long bs[3] = {q_bs, k_bs, v_bs};
  const int ld[3] = {q_ld, k_ld, v_ld};
  for (int i = with_q ? 0 : 1; i < 3; ++i) {
    const uint64_t dims[3] = {(uint64_t)heads * HD, (uint64_t)N, (uint64_t)B};
    const uint64_t strides[2] = {(uint64_t)ld[i] * 2, (uint64_t)bs[i] * 2};
    const uint32_t box[3] = {HD, (uint32_t)(i == 0 ? warps * 16 : KT), 1};
    if ((e = make_tmap(&tm[i], ptr[i], 3, dims, strides, box)) != cudaSuccess) return e;
  }
  const int per_item = (tiles + warps - 1) / warps;
  const Args a{B, N, heads, warps, tiles, kv_tiles, per_item,
               with_q ? N / 16 : 0, with_q ? N % 16 : 0, scale,
               static_cast<bf16*>(out), out_bs, out_ld,
               static_cast<const bf16*>(qy), qy_ld,
               static_cast<const bf16*>(ky), ky_ld,
               static_cast<const bf16*>(vy), vy_ld,
               bias,
               static_cast<bf16*>(side_out), side_ld};
  const long long units = (long long)B * heads * per_item;
  if (units > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int grid = (int)std::min<long long>(units, sm_count());
  long_attention_kernel<<<grid, 32 * (warps + 1), l.total,
                          static_cast<cudaStream_t>(stream)>>>(tm[0], tm[1], tm[2], a);
  return cudaGetLastError();
}

}  // extern "C"
