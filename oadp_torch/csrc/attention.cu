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
// objects batch the main rows read 1.86 GB of q/k/v and write 0.62 GB, so
// bytes bound them (0.74 ms at 2048 crops), with ~1 G exps (MUFU) and the
// tensor-core work to hide under the loads.
// Design: a persistent, warp-specialised block per SM walks the (crop, head)
// items. One producer warp issues TMA loads of an item's Q, K and V (64
// columns x the tokens rounded up to 16 rows, 128-byte swizzle; rows past N
// arrive as zeros) through 3-D tensor maps over the strided column slices,
// into a ring of stages guarded by full/empty mbarriers, so the next
// items load while the current one is computed. Each consumer warp owns one
// 16-row query tile (13 warps for N = 197, so no warp idles; for short
// sequences a stage holds several items, e.g. 3 x 4 tiles at N = 50). A
// warp reads its Q fragments from shared memory with ldmatrix, runs QK^T
// and PV on mma.sync m16n8k16 with K and V fragments from ldmatrix (the
// swizzle makes every ldmatrix conflict-free) in 32-key chunks, takes the
// exps on ex2.approx with the key mask only in the chunk that reaches past
// N, writes its normalised rows back over its own Q rows in shared memory
// and stores them with 16-byte coalesced writes. The issue slots are the
// scarce resource here: each lane's ldmatrix offsets are computed once
// (chunks start at multiples of 16 rows, so the swizzle term is the
// lane's own), and each row takes one reciprocal instead of 64 divisions.
// wgmma for QK^T and PV (one m64 query tile per consumer warpgroup, P from
// registers) ran slower: ptxas serialises the wgmmas whose A operand, P,
// is computed between them (see PERF.md). The side row alone
// (_side_attn_kernel) is 4 x N x 64 FLOP a head against the head's K and
// V: reading K and V (1.24 GB at 2048 crops) bounds it; it runs on the
// consumer warps from the same staged K and V, its small inputs (qy, ky,
// vy, the bias row) copied into the stage by the producer warp's lanes
// with cp.async, tracked by the same barrier.
#include <algorithm>

#include "common.cuh"

namespace oadp {
namespace {

constexpr int HD = 64;             // head width this kernel is written for
// consumer warps: with the producer, 16 warps, 4 to each SM sub-partition,
// so a thread may hold 128 registers
constexpr int MAX_CONSUMERS = 15;
constexpr int MAX_TILES = 16;  // 16-row tiles per item (N <= 256)
constexpr int MAX_STAGES = 4;
constexpr int RING_BYTES = 200 * 1024;  // the stages, at most
// The side row alone (K and V only) runs one item a block, in blocks of
// SIDE_WARPS consumer warps and one stage, three blocks an SM (by shared
// memory): three independent items in flight keep its loads at the rate
// of loads alone.
constexpr int SIDE_WARPS = 4;

// Shared memory: stages x group x [Q,] K, V tiles of (16 * tiles) rows of
// 128 bytes; stages x the side row's inputs (qy, ky, vy of the head and
// the bias row); two sets of the side row's fp32 partial sums, one row per
// consumer warp (items alternate); the full and empty barriers.
struct Layout {
  int tile, item, stage, stages, side_in, side_stage, scratch, bars, total;
};

// As many stages as fit in RING_BYTES, up to max_stages: more loads in
// flight where an item is small.
__host__ __device__ inline Layout layout(int tiles, int group, bool with_q, int max_stages,
                                         int consumers) {
  Layout l;
  l.tile = tiles * 16 * 128;
  l.item = (with_q ? 3 : 2) * l.tile;
  l.stage = group * l.item;
  l.stages = RING_BYTES / l.stage < max_stages ? RING_BYTES / l.stage : max_stages;
  l.side_in = l.stages * l.stage;
  l.side_stage = 3 * HD * 2 + tiles * 16 * 4;
  l.scratch = l.side_in + l.stages * l.side_stage;
  // two of: part[consumers][HD], psum[consumers]
  l.bars = l.scratch + 2 * 4 * consumers * (HD + 1);
  l.bars = (l.bars + 15) & ~15;  // mbarriers are 8-byte aligned
  l.total = l.bars + 2 * l.stages * 8 + 1024;  // + slack to align to 1024 bytes
  return l;
}

struct Args {
  int B, N, heads;
  int tiles;      // 16-row tiles per item
  int group;      // items per stage
  int consumers;  // consumer warps
  int max_stages;
  float scale;
  bf16* out; long long out_bs; int out_ld;  // main rows, or nullptr
  const bf16* qy; int qy_ld;                // side row (with side_out)
  const bf16* ky; int ky_ld;
  const bf16* vy; int vy_ld;
  const float* bias;                        // (B, N), contiguous
  bf16* side_out; int side_ld;              // side row, or nullptr
};

// exp(min(x, 80)) as exp2 of the clamped logit in log2 units
constexpr float LOG2E = 1.4426950408889634f;

// One chunk of KC keys (32, or 16 for the tail) of a warp's 16 query rows:
// scores on mma.sync from Q fragments in registers and K fragments from
// ldmatrix, exp weights rounded to bf16 as the A operand of P V, and the
// PV product from ldmatrix.trans of V. With MASK, keys at or past `lim`
// weigh 0 (only a chunk that reaches past N needs it). Ks, Vs: the
// chunk's first row (shared-memory addresses).
template <int KC, bool MASK>
__device__ __forceinline__ void key_chunk(const unsigned (&qf)[HD / 16][4], uint32_t Ks,
                                          uint32_t Vs, const Frag& f, int lim, float scale_log2,
                                          int lane, float (&o)[HD / 8][4], float (&sums)[2]) {
  constexpr int NB = KC / 8;  // 8-key column blocks of the scores
  const int t = lane & 3;
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
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float w = ex2(fminf(s[j][e] * scale_log2, 80.f * LOG2E));
      const bool keep = !MASK || j * 8 + 2 * t + (e & 1) < lim;
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

// One warp's 16 query rows of one (crop, head): Q, K, V staged tiles.
__device__ __forceinline__ void main_rows(const Args& a, unsigned char* Qs,
                                          const unsigned char* Ks, const unsigned char* Vs,
                                          int r0, int b, int h, int lane) {
  const int N = a.N, np = a.tiles * 16;
  const int g = lane >> 2, t = lane & 3;
  // Q fragments (the A operand layout): lanes 0-15 give rows r0..r0+15 of
  // the low 8 columns of a k-step, lanes 16-31 the high 8
  unsigned qf[HD / 16][4];
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks)
    ldmatrix_x4(qf[ks], smem_u32(Qs) + swz(r0 + (lane & 15), ks * 2 + (lane >> 4)));

  float o[HD / 8][4];
#pragma unroll
  for (int i = 0; i < HD / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float sums[2] = {0.f, 0.f};  // rows g, g + 8
  const float scale_log2 = a.scale * LOG2E;
  const Frag f = frag_offsets(lane);
  const uint32_t ks_ = smem_u32(Ks), vs_ = smem_u32(Vs);
  int k0 = 0;
  for (; k0 + 32 <= N; k0 += 32)
    key_chunk<32, false>(qf, ks_ + k0 * 128, vs_ + k0 * 128, f, 0, scale_log2, lane, o, sums);
  for (; k0 + 32 <= np; k0 += 32)
    key_chunk<32, true>(qf, ks_ + k0 * 128, vs_ + k0 * 128, f, N - k0, scale_log2, lane, o, sums);
  if (k0 < np)
    key_chunk<16, true>(qf, ks_ + k0 * 128, vs_ + k0 * 128, f, N - k0, scale_log2, lane, o, sums);

  // each row's sum is spread over the four lanes of its quad
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    sums[hh] += __shfl_xor_sync(0xffffffffu, sums[hh], 1);
    sums[hh] += __shfl_xor_sync(0xffffffffu, sums[hh], 2);
  }
  // Stage the 16 x 64 output over this warp's own Q rows (its Q is in
  // registers now), then write whole 128-byte rows, 16 bytes a lane.
  const float inv[2] = {1.f / sums[0], 1.f / sums[1]};
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      *reinterpret_cast<__nv_bfloat162*>(Qs + swz(r0 + g + 8 * hh, n) + 4 * t) =
          __floats2bfloat162_rn(o[n][2 * hh] * inv[hh], o[n][2 * hh + 1] * inv[hh]);
    }
  }
  __syncwarp();
  bf16* dst = a.out + (size_t)b * a.out_bs + h * HD;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + i * 4 + (lane >> 3), c = lane & 7;
    if (row < N)
      *reinterpret_cast<uint4*>(dst + (size_t)row * a.out_ld + c * 8) =
          *reinterpret_cast<const uint4*>(Qs + swz(row, c));
  }
}

// The side row of one (crop, head) over all consumer warps, from the
// staged K and V and the staged inputs `in` (qy, ky, vy rows of the head,
// then the bias row). Key index 0 stands for y's own key and value, index
// j >= 1 for patch key j. Each warp takes 16 keys at a time: two lanes a
// key for the logits (32 head dims each), then one head-dim pair a lane
// for the weighted values; the warps' partial sums meet in shared memory
// (two sets, items alternating: one barrier an item) and warp 0 adds them.
__device__ __forceinline__ void side_row(const Args& a, const unsigned char* Ks,
                                         const unsigned char* Vs, const unsigned char* in,
                                         float* scratch, int b, int h, int warp, int lane) {
  const int N = a.N;
  float* part = scratch;                // [consumers][HD]
  float* psum = part + a.consumers * HD;  // [consumers]
  const bf16* qy = reinterpret_cast<const bf16*>(in);
  const bf16* ky = qy + HD;
  const bf16* vy = ky + HD;
  const float* bb = reinterpret_cast<const float*>(in + 3 * HD * 2);
  // this lane's 32 head dims of qy, for every key it takes
  const int half = lane >> 4;
  uint4 qh[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) qh[c] = *reinterpret_cast<const uint4*>(qy + (half * 4 + c) * 8);
  float sum = 0.f, o0 = 0.f, o1 = 0.f;
  for (int j0 = warp * 16; j0 < N; j0 += a.consumers * 16) {
    // chunks start at multiples of 16 rows: row j's swizzle term is lane & 7
    const int j = j0 + (lane & 15);
    float dot = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float fq[8], fk[8];
      unpack8(qh[c], fq);
      unpack8(j == 0 ? *reinterpret_cast<const uint4*>(ky + (half * 4 + c) * 8)
                     : *reinterpret_cast<const uint4*>(Ks + swz(j, half * 4 + c)),
              fk);
#pragma unroll
      for (int i = 0; i < 8; ++i) dot += fq[i] * fk[i];
    }
    dot += __shfl_xor_sync(0xffffffffu, dot, 16);
    // keys past N weigh 0, and their staged V rows are zeros
    const float e =
        j < N ? expf(fminf(dot * a.scale + (j == 0 ? bb[N - 1] : bb[j - 1]), 80.f)) : 0.f;
    const unsigned char* vrow = Vs + j0 * 128 + 4 * (lane & 3);
#pragma unroll
    for (int kk = 0; kk < 16; ++kk) {
      const float ek = __shfl_sync(0xffffffffu, e, kk);
      sum += ek;
      // P is bf16 in the product for the patch keys; y's own weight is not
      float p = __bfloat162float(__float2bfloat16(ek));
      const unsigned char* src = vrow + kk * 128 + (((lane >> 2) ^ (kk & 7)) << 4);
      if (kk == 0 && j0 == 0) {
        p = ek;
        src = reinterpret_cast<const unsigned char*>(vy + 2 * lane);
      }
      const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(src));
      o0 += p * v.x;
      o1 += p * v.y;
    }
  }
  part[warp * HD + 2 * lane] = o0;
  part[warp * HD + 2 * lane + 1] = o1;
  if (lane == 0) psum[warp] = sum;
  named_barrier(1, a.consumers * 32);
  if (warp == 0) {
    o0 = o1 = sum = 0.f;
    for (int w = 0; w < a.consumers; ++w) {
      o0 += part[w * HD + 2 * lane];
      o1 += part[w * HD + 2 * lane + 1];
      sum += psum[w];
    }
    *reinterpret_cast<__nv_bfloat162*>(a.side_out + (size_t)b * a.side_ld + h * HD + 2 * lane) =
        __floats2bfloat162_rn(o0 / sum, o1 / sum);
  }
}

__global__ void __launch_bounds__(32 * (MAX_CONSUMERS + 1), 1)
attention_kernel(__grid_constant__ const CUtensorMap tm_q, __grid_constant__ const CUtensorMap tm_k,
                 __grid_constant__ const CUtensorMap tm_v, const Args a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const bool with_q = a.out != nullptr;
  const Layout l = layout(a.tiles, a.group, with_q, a.max_stages, a.consumers);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + l.bars);
  uint64_t* empty = full + l.stages;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool side = a.side_out != nullptr;
  if (threadIdx.x == 0) {
    for (int s = 0; s < l.stages; ++s) {
      // the TMA bytes' arrive [, one per producer lane for its side-input copies]
      mbar_init(&full[s], side ? 33 : 1);
      mbar_init(&empty[s], a.consumers);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int items = a.B * a.heads;
  const int groups = (items + a.group - 1) / a.group;
  if (warp == a.consumers) {
    // producer: lane 0 loads a stage's items by TMA while the consumers
    // work on the other stages; for the side row (one item a stage) the
    // lanes copy its small inputs with cp.async, which the full barrier
    // tracks, so the producer never waits on a load
    int it = 0;
    for (int grp = blockIdx.x; grp < groups; grp += gridDim.x, ++it) {
      const int s = it % l.stages;
      mbar_wait(&empty[s], ((it / l.stages) & 1) ^ 1);  // the first pass finds all free
      const int first = grp * a.group;
      const int n = min(items - first, a.group);
      if (lane == 0) {
        mbar_arrive_expect_tx(&full[s], n * l.item);  // rows past N count, as zeros
        unsigned char* dst = base + s * l.stage;
        for (int i = 0; i < n; ++i) {
          const int b = (first + i) / a.heads, h = (first + i) % a.heads;
          unsigned char* d = dst + i * l.item;
          if (with_q) {
            tma_load_3d(d, &tm_q, &full[s], h * HD, 0, b);
            d += l.tile;
          }
          tma_load_3d(d, &tm_k, &full[s], h * HD, 0, b);
          tma_load_3d(d + l.tile, &tm_v, &full[s], h * HD, 0, b);
        }
      }
      if (side) {
        const int b = grp / a.heads, h = grp % a.heads;
        unsigned char* in = base + l.side_in + s * l.side_stage;
        if (lane < 24) {  // 8 16-byte chunks each of qy, ky, vy
          const int r = lane >> 3;
          const bf16* src = r == 0 ? a.qy + (size_t)b * a.qy_ld
                          : r == 1 ? a.ky + (size_t)b * a.ky_ld
                                   : a.vy + (size_t)b * a.vy_ld;
          cp_async16(in + lane * 16, src + h * HD + (lane & 7) * 8);
        }
        float* bias = reinterpret_cast<float*>(in + 3 * HD * 2);
        for (int j = lane; j < a.N; j += 32) cp_async4(bias + j, a.bias + (size_t)b * a.N + j);
        cp_async_arrive(&full[s]);
      }
    }
    return;
  }

  int it = 0;
  for (int grp = blockIdx.x; grp < groups; grp += gridDim.x, ++it) {
    const int s = it % l.stages;
    mbar_wait(&full[s], (it / l.stages) & 1);
    if (with_q) {
      // a warp's 16-row tiles: slot (item of the stage) x tile
      for (int tw = warp; tw < a.tiles * a.group; tw += a.consumers) {
        const int slot = tw / a.tiles, item = grp * a.group + slot;
        if (item >= items) break;
        unsigned char* Qs = base + s * l.stage + slot * l.item;
        main_rows(a, Qs, Qs + l.tile, Qs + 2 * l.tile, (tw % a.tiles) * 16, item / a.heads,
                  item % a.heads, lane);
      }
    }
    if (side) {  // one item a stage
      const unsigned char* Ks = base + s * l.stage + (with_q ? l.tile : 0);
      float* scratch = reinterpret_cast<float*>(base + l.scratch) + (it & 1) * a.consumers * (HD + 1);
      side_row(a, Ks, Ks + l.tile, base + l.side_in + s * l.side_stage, scratch, grp / a.heads,
               grp % a.heads, warp, lane);
    }
    // this warp's staged rows may be overwritten by the next TMA load
    fence_proxy_async();
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }
}

}  // namespace
}  // namespace oadp

extern "C" {

// Checked by the Python wrapper: head width 64, N <= 256, every pointer
// 16-byte aligned and every stride a multiple of 8 elements; the crop
// stride of q, k and v at least N row strides.
int oadp_attention(int B, int N, int heads, float scale, const void* q, long long q_bs,
                   int q_ld, const void* k, long long k_bs, int k_ld, const void* v,
                   long long v_bs, int v_ld, void* out, long long out_bs, int out_ld,
                   const void* qy, int qy_ld, const void* ky, int ky_ld, const void* vy,
                   int vy_ld, const float* bias, void* side_out, int side_ld, void* stream) {
  using namespace oadp;
  const int tiles = (N + 15) / 16;
  if (tiles > MAX_TILES || B <= 0) return cudaErrorInvalidValue;
  const bool with_q = out != nullptr;
  const bool side_only = !with_q;
  // items a stage: one with the side row, else enough for all consumers
  const int group = side_out != nullptr ? 1 : std::max(1, MAX_CONSUMERS / tiles);
  const int consumers = side_only ? SIDE_WARPS : std::min(tiles * group, MAX_CONSUMERS);
  const int max_stages = side_only ? 1 : MAX_STAGES;
  const Layout l = layout(tiles, group, with_q, max_stages, consumers);
  // the most any shape takes, set once (occupancy follows each launch's
  // own size)
  constexpr int max_smem = RING_BYTES + MAX_STAGES * (3 * HD * 2 + MAX_TILES * 16 * 4) +
                           2 * 4 * MAX_CONSUMERS * (HD + 1) + 16 + 2 * MAX_STAGES * 8 + 1024;
  static const cudaError_t attr = cudaFuncSetAttribute(
      attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);
  cudaError_t e = attr;
  if (e != cudaSuccess) return e;

  // (D, N, B) tensor maps over the column slices; a box is one head's 64
  // columns of every row, rounded up to whole 16-row tiles
  CUtensorMap tm[3] = {};
  const void* ptr[3] = {q, k, v};
  const long long bs[3] = {q_bs, k_bs, v_bs};
  const int ld[3] = {q_ld, k_ld, v_ld};
  for (int i = with_q ? 0 : 1; i < 3; ++i) {
    const uint64_t dims[3] = {(uint64_t)heads * HD, (uint64_t)N, (uint64_t)B};
    const uint64_t strides[2] = {(uint64_t)ld[i] * 2, (uint64_t)bs[i] * 2};
    const uint32_t box[3] = {HD, (uint32_t)tiles * 16, 1};
    if ((e = make_tmap(&tm[i], ptr[i], 3, dims, strides, box)) != cudaSuccess) return e;
  }
  const Args a{B, N, heads, tiles, group, consumers, max_stages, scale,
               static_cast<bf16*>(out), out_bs, out_ld,
               static_cast<const bf16*>(qy), qy_ld,
               static_cast<const bf16*>(ky), ky_ld,
               static_cast<const bf16*>(vy), vy_ld,
               bias,
               static_cast<bf16*>(side_out), side_ld};
  const int groups = (B * heads + group - 1) / group;
  const int grid = side_only ? groups : std::min(groups, sm_count());
  attention_kernel<<<grid, 32 * (consumers + 1), l.total,
                     static_cast<cudaStream_t>(stream)>>>(tm[0], tm[1], tm[2], a);
  return cudaGetLastError();
}

}  // extern "C"
