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
// bf16 q, k, v; fp32 logits clamped at 80 before the exp (taken in fp32 on
// ex2.approx, in log2 units), no max subtracted; fp32 row sums of the fp32
// weights; the weights rounded to bf16 only as the A operand of the PV
// product (y's own weight on the side row is not); the normalisation after
// the product. Because of the clamp a streamed kernel needs no running max
// and no rescale: each key tile's weights go straight into the PV product.
// The sum of N terms of at most e^80 stays finite in fp32 up to about
// 6,100 keys.
//
// Bounds on the H100, one layer at 2,048 crops x 16 heads x 1,025 tokens:
// 4 N^2 x 64 x 32,768 = 8.8 TFLOP on the tensor cores, 8.9 ms at 989
// TFLOP/s; N^2 x 32,768 = 34.4 G exps on MUFU (16 a clock an SM), 8.9 ms
// at the clock that peak assumes: at head width 64 the two bounds are the
// same size (256 FLOP an exp). q, k, v and out are 17 GB (5 ms), read once.
//
// Design: persistent blocks of four warpgroups walk work units. An item's
// rows (its main rows, then the side row at row N; or the side row alone)
// are cut into 64-row tiles, and a unit is three consecutive tiles of one
// item, one for each consumer warpgroup (N = 1,025: 17 tiles, 16 of main
// rows and one holding row 1,024 and the side row, in 6 units; a warpgroup
// past the item's last tile passes its key tiles on unread). The producer
// warp loads a unit's Q tiles with TMA into one of two Q slots and streams
// the item's K and V in 64-key tiles (TMA, 128-byte swizzle, rows past N
// as zeros) through a ring of stages guarded by full/empty mbarriers,
// running ahead into the next unit; its lanes copy the side row's inputs
// (qy, ky, vy, the bias row) into a side slot with cp.async, tracked by the
// Q slot's barrier. An item's units are adjacent in the walk, so they run
// on neighbouring SMs at about the same time and stream its K and V from
// L2.
//
// A consumer warpgroup holds its tile's Q as wgmma A fragments (ldmatrix,
// once) and for each key tile j issues S_j = Q K_j^T (4 wgmma m64n64k16, K
// from shared memory) and O += P_{j-1} V_{j-1} (4 wgmma m64n64k16, P from
// registers, V the MN-major B operand) as two commit groups; waits for S_j
// alone (wait_group 1), takes its exps and row sums in fp32, waits for the
// PV product, releases stage j - 1 and rounds the weights to bf16 into P
// (the m64n64 accumulator layout is the register A fragment's, so P never
// leaves the registers). The last key tile (1 valid key at N = 1,025) is
// peeled out of the loop with the key mask; full tiles take none. The
// side row's warp adds its bias (-inf at key 0, the main CLS) to that row
// alone, and y's own key and value at the end in fp32.
//
// Where the exps meet the products: issuing a wgmma holds the issuing warp
// for about the product's own time (~34 clocks an m64n64k16, measured), so
// a warpgroup's exps do not run under its own products; they run under the
// other warpgroups'. Hence three consumer warpgroups (22.0 ms a main + side
// layer on an H100 SXM at 700 W, CUDA events) rather than two (25.5-26.5
// ms); a second score buffer with tile j + 1's scores in flight, key tiles
// taken two at a time, turns between the warpgroups on named barriers, S
// issued before the PV, Q read from shared memory, a 16-key last tile, and
// part of the exps on an FMA polynomial each measured no faster (PERF.md
// §6).
//
// Shared memory read a layer: each 64-row tile reads each K and V tile
// once, 17 x 17 x 16 KB x 32,768 items = 155 GB, and its Q once (5 GB),
// against ~558 GB when each 16-row tile read K and V itself. L2 to shared
// memory: each unit streams the item's 262 KB of K and V, 6 units an item,
// 52 GB a layer (~6.6 ms at the ~7.8 TB/s measured for the stream alone,
// under the products).
//
// Padded work at N = 1,025: the tail tile holds 2 of its 64 rows, and the
// last key tile 1 of its 64 keys, so the warpgroups compute 1,088 x 1,088
// scores for 1,026 x 1,025: 12.6% more products and exps than the layer's.
//
// Why ptxas keeps these wgmmas asynchronous, where attention.cu's attempt
// (P from registers at N = 197) was serialised: every pipeline stage
// (wgmma.fence to wait_group 0) lies within one key tile's straight-line
// code, and no instruction other than a wgmma touches O, or the P
// registers a pending wgmma reads; S is read only after its own group's
// wait_group 1; P, Q and the zeroed O are written before the stage's fence,
// and empty asm fences pin those writes there. There is no running max and
// so no rescale of O. The build's ptxas report (build.log) is checked for
// serialisation and spills (chip_smoke.long_attention_build).
//
// Registers: the 512-thread block launches with 128 a thread; setmaxnreg
// leaves the producer warpgroup 32 (24 spilled its unit loop) and gives
// the consumers 160: S 32, O 32, P 16 and Q 16 with the addresses, no
// spill.
#include <algorithm>

#include "common.cuh"

namespace oadp {
namespace {

constexpr int HD = 64;               // head width this kernel is written for
constexpr int KT = 64;               // keys a K/V tile
constexpr int WGS = 3;               // consumer warpgroups: 64-row tiles a unit
constexpr int MAX_STAGES = 8;        // K/V ring stages, at most
// registers a thread after setmaxnreg: the producer warpgroup's, the
// consumers' (at launch each of the 512 threads has 128 of an SM's 65,536)
constexpr int PRODUCER_REGS = 32, CONSUMER_REGS = 160;
constexpr int SMEM_LIMIT = 232448;   // dynamic shared memory a block may take
constexpr int TILE16 = 16 * 128;     // a warp's 16 rows of a Q tile
constexpr int TILE64 = 64 * 128;     // a 64-row Q tile (also a K or V tile)
constexpr int QSLOT = WGS * TILE64;
constexpr int KV_BYTES = 2 * KT * 128;  // a stage: K and V tiles
constexpr float LOG2E = 1.4426950408889634f;
constexpr float CLAMP_LOG2 = 80.f * LOG2E;

struct Layout {
  int q, side_slot, side, bars, stages, total;
};

// The ring of K/V stages first (1024-byte aligned for the swizzle), two Q
// slots of a unit's 64-row tiles, two side slots (qy, ky, vy, then the bias
// row shifted by one key), the barriers: as many stages as fit, up to
// MAX_STAGES.
__host__ __device__ inline Layout layout(int kv_tiles) {
  Layout l;
  l.side_slot = (3 * HD * 2 + 4 * (kv_tiles * KT + 4) + 127) & ~127;
  const int fixed = 2 * QSLOT + 2 * l.side_slot + (4 + 2 * MAX_STAGES) * 8 + 1024;
  const int fit = (SMEM_LIMIT - fixed) / KV_BYTES;
  l.stages = fit < MAX_STAGES ? fit : MAX_STAGES;
  l.q = l.stages * KV_BYTES;
  l.side = l.q + 2 * QSLOT;
  l.bars = l.side + 2 * l.side_slot;
  l.total = l.bars + (4 + 2 * l.stages) * 8 + 1024;  // + slack to align to 1024
  return l;
}

struct Args {
  int B, N, heads;
  int tiles;     // 64-row tiles an item: its main rows, then the side row
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

// ---------------------------------------------------------------------------
// wgmma with A in registers
// ---------------------------------------------------------------------------

// d (64 x 64 fp32 per warpgroup) = (d if accumulate) + A (64 x 16, registers:
// the m16n8k16 A fragment of each warp's 16 rows) * B (shared), B K-major
// (a 64 x 16 slice of 64 rows of 128 bytes, the key tile for QK^T) or with
// TRANS_B MN-major (16 rows of 64 contiguous values, the value tile for
// PV); both with the 128-byte swizzle.
template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs_m64n64k16(float* d, const unsigned (&a)[4],
                                                   uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate), "n"(TRANS_B));
}

// Keep the compiler from moving the writes of a register A operand past
// the wgmma.fence that precedes the wgmma reading it.
template <int K>
__device__ __forceinline__ void fence_frag(unsigned (&r)[K][4]) {
#pragma unroll
  for (int i = 0; i < K; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// A wgmma shared-memory descriptor (smem_desc's) from its low word, the
// start address / 16 and the fixed leading offset, `at16` x 16 bytes
// further on (the tiles lie below 256 KB, so the sum never carries out of
// the address field). The high word is smem_desc's: the 1024-byte stride
// between 8-row groups and the 128-byte swizzle.
constexpr uint32_t DESC_HI = (1024 >> 4) | (1u << 30);
__device__ __forceinline__ uint64_t desc_at(uint32_t lo, uint32_t at16) {
  return (static_cast<uint64_t>(DESC_HI) << 32) | (lo + at16);
}

// The K/V ring as a consumer warp sees it: the stages' base descriptor, the
// full and empty barriers, and the position (stage s, phase ph) of the next
// tile to take.
struct Ring {
  uint32_t lo;  // smem_desc of stage 0, its low word
  uint64_t *full, *empty;
  int stages, s;
  unsigned ph;
  // wait for the next tile and return its stage
  __device__ __forceinline__ int take() {
    const int at = s;
    mbar_wait(&full[at], ph);
    if (++s == stages) s = 0, ph ^= 1;
    return at;
  }
  // release a stage once the warp is done with it
  __device__ __forceinline__ void give(int stage, int lane) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[stage]);
  }
};

// S = Q K^T over the key tile of `stage` (Q in registers).
__device__ __forceinline__ void issue_scores(float (&s)[32], const unsigned (&qf)[HD / 16][4],
                                             const Ring& r, int stage) {
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks)
    wgmma_rs_m64n64k16<0>(s, qf[ks], desc_at(r.lo, stage * (KV_BYTES / 16) + ks * 2), ks > 0);
}

// O += P V over the value tile of `stage` (P in registers).
__device__ __forceinline__ void issue_values(float (&o)[32], const unsigned (&p)[KT / 16][4],
                                             const Ring& r, int stage) {
#pragma unroll
  for (int kk = 0; kk < KT / 16; ++kk)
    wgmma_rs_m64n64k16<1>(
        o, p[kk], desc_at(r.lo, stage * (KV_BYTES / 16) + KV_BYTES / 32 + kk * 128), 1);
}

// ---------------------------------------------------------------------------
// A warpgroup's 64-row tile
// ---------------------------------------------------------------------------

// Where the side row sits in a thread's accumulators: row g (lo) or g + 8
// (hi) of its warp's 16.
struct SideRow {
  bool lo, hi;
};

// The weights of one key tile in place of its scores, and their fp32 row
// sums: accumulator s[4 jn + 2 hh + e] is row g + 8 hh of the warp's 16,
// key 8 jn + 2 t + e; with MASK keys at or past `lim` weigh 0; with SIDE
// the side row's logits take the keys' bias in log2 units (key 8 jn + 2 t
// + e at bias[8 jn + 2 t + e]; -inf at the item's key 0, the main CLS).
template <bool MASK, bool SIDE>
__device__ __forceinline__ void weights(float (&s)[32], float scale_log2, int lim, int t,
                                        const SideRow& sr, const float* bias, float (&sums)[2]) {
#pragma unroll
  for (int jn = 0; jn < KT / 8; ++jn) {
    float2 bb = make_float2(0.f, 0.f);
    if (SIDE) bb = *reinterpret_cast<const float2*>(bias + jn * 8 + 2 * t);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x;
      if (SIDE) {
        const bool on = e < 2 ? sr.lo : sr.hi;
        x = fmaf(s[4 * jn + e], scale_log2, on ? (e & 1 ? bb.y : bb.x) : 0.f);
      } else {
        x = s[4 * jn + e] * scale_log2;
      }
      const float w = ex2(fminf(x, CLAMP_LOG2));
      s[4 * jn + e] = !MASK || jn * 8 + 2 * t + (e & 1) < lim ? w : 0.f;
      sums[e >> 1] += s[4 * jn + e];
    }
  }
}

// The weights rounded to bf16 as the PV product's A fragments: k-step kk
// (keys 16 kk..) takes rows g and g + 8 at keys 2t.. and 2t + 8...
__device__ __forceinline__ void round_weights(const float (&s)[32], unsigned (&p)[KT / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < KT / 16; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) p[kk][r] = pack2(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
  }
}

// A warpgroup's state through an item's key tiles: Q's fragments, the
// scores of the current tile, O, P (the previous tile's weights in bf16),
// the row sums and the previous tile's stage.
template <bool SIDE>
struct Pipe {
  unsigned qf[HD / 16][4];
  float s[32], o[32];
  unsigned p[KT / 16][4];
  float sums[2];  // rows g, g + 8 of the warp's 16
  int prev;
  float scale_log2;
  int t, lane;
  SideRow sr;
  const float* bias;

  // Key tile j: its scores, and (unless FIRST) the previous tile's PV
  // issued with them; its weights computed while the PV product runs (with
  // MASK keys at or past `lim` weigh 0); the previous tile's stage released
  // once its product is done; P rounded from the weights.
  template <bool FIRST, bool MASK>
  __device__ __forceinline__ void tile(Ring& r, int j, int lim) {
    const int a = r.take();
    fence_acc<32>(s);
    fence_acc<32>(o);
    fence_frag(p);
    wgmma_fence();
    issue_scores(s, qf, r, a);
    wgmma_commit();
    if (!FIRST) {
      issue_values(o, p, r, prev);
      wgmma_commit();
      wgmma_wait<1>();
    } else {
      wgmma_wait<0>();
    }
    fence_acc<32>(s);
    weights<MASK, SIDE>(s, scale_log2, lim, t, sr, bias + j * KT, sums);
    if (!FIRST) {
      wgmma_wait<0>();
      fence_acc<32>(o);
      fence_frag(p);
      r.give(prev, lane);
    }
    round_weights(s, p);
    prev = a;
  }

  // Every key tile of an item (at least two), the last one masked, then
  // the last tile's PV product.
  __device__ __forceinline__ void run(Ring& r, int kv_tiles, int n) {
    const int last = kv_tiles - 1;
    fence_frag(qf);
    tile<true, false>(r, 0, KT);
    for (int j = 1; j < last; ++j) tile<false, false>(r, j, KT);
    tile<false, true>(r, last, n - last * KT);
    fence_acc<32>(o);
    fence_frag(p);
    wgmma_fence();
    issue_values(o, p, r, prev);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc<32>(o);
    r.give(prev, lane);
  }
};

// Tile `tile` of item (b, h) by warpgroup warp w (rows 16 w.. of it, at
// Qs): its Q rows from the slot into the wgmma A fragments (with SIDE, the
// side row's query written into its row first, and the keys' bias turned
// to log2 units); every key tile of the item from the ring; the normalised
// main rows below N written to out, and with SIDE the side row, with y's
// own key and value added in fp32, to side_out.
template <bool SIDE>
__device__ __forceinline__ void attend_tile(const Args& a, unsigned char* Qs, unsigned char* in,
                                            Ring& ring, int b, int h, int tile, int w, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const bool with_q = a.out != nullptr;
  const bool side_warp = SIDE && w == (a.side_row >> 4);
  const bool side_lane = side_warp && g == (a.side_row & 7);
  float* bias = reinterpret_cast<float*>(in + 3 * HD * 2);
  if (SIDE) {
    // the side query into its row of the tile (a tile of zeros without
    // main rows), the keys' bias in log2 units with the main CLS's -inf
    // (y's own at N stays as it came)
    if (!with_q) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        reinterpret_cast<uint4*>(Qs)[lane * 4 + i] = make_uint4(0, 0, 0, 0);
      __syncwarp();
    }
    if (side_warp) {
      if (lane < 8)
        *reinterpret_cast<uint4*>(Qs + swz(a.side_row & 15, lane)) =
            *reinterpret_cast<const uint4*>(in + lane * 16);
      for (int j = lane; j < a.N; j += 32) bias[j] = j == 0 ? -INFINITY : bias[j] * LOG2E;
    }
    __syncwarp();
  }
  Pipe<SIDE> pp;
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks)
    ldmatrix_x4(pp.qf[ks], smem_u32(Qs) + swz(lane & 15, ks * 2 + (lane >> 4)));
#pragma unroll
  for (int i = 0; i < 32; ++i) pp.o[i] = 0.f;
  pp.sums[0] = pp.sums[1] = 0.f;
  pp.scale_log2 = a.scale * LOG2E;
  pp.t = t;
  pp.lane = lane;
  pp.sr = SideRow{side_lane && (a.side_row & 8) == 0, side_lane && (a.side_row & 8) != 0};
  pp.bias = bias;
  pp.run(ring, a.kv_tiles, a.N);
  float* o = pp.o;
  float* sums = pp.sums;

  // each row's sum is spread over the four lanes of its quad
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    sums[hh] += __shfl_xor_sync(0xffffffffu, sums[hh], 1);
    sums[hh] += __shfl_xor_sync(0xffffffffu, sums[hh], 2);
  }
  if (side_warp) {
    // y's own key and value, unrounded, then the side row's output
    const bf16* qy = reinterpret_cast<const bf16*>(in);
    const float2 q2 = __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(qy)[lane]);
    const float2 k2 =
        __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(qy + HD)[lane]);
    const float dot = warp_sum(q2.x * k2.x + q2.y * k2.y);
    const float ey = expf(fminf(dot * a.scale + bias[a.N], 80.f));
    if (side_lane) {
      // selects, not o[4 jn + 2 hh]: an index known only at run time would
      // put the accumulators in local memory for the whole kernel
      const bool hi = pp.sr.hi;
      const float inv = 1.f / ((hi ? sums[1] : sums[0]) + ey);
      bf16* dst = a.side_out + (size_t)b * a.side_ld + h * HD;
#pragma unroll
      for (int jn = 0; jn < HD / 8; ++jn) {
        const int d0 = jn * 8 + 2 * t;
        const float2 v2 =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(qy + 2 * HD + d0));
        *reinterpret_cast<__nv_bfloat162*>(dst + d0) =
            __floats2bfloat162_rn(((hi ? o[4 * jn + 2] : o[4 * jn]) + ey * v2.x) * inv,
                                  ((hi ? o[4 * jn + 3] : o[4 * jn + 1]) + ey * v2.y) * inv);
      }
    }
  }
  if (with_q) {
    // Stage the warp's 16 x 64 output over its own Q rows (its Q is in
    // registers), then write whole 128-byte rows below N, 16 bytes a lane.
    const float inv[2] = {1.f / sums[0], 1.f / sums[1]};
#pragma unroll
    for (int jn = 0; jn < HD / 8; ++jn) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        *reinterpret_cast<__nv_bfloat162*>(Qs + swz(g + 8 * hh, jn) + 4 * t) =
            __floats2bfloat162_rn(o[4 * jn + 2 * hh] * inv[hh], o[4 * jn + 2 * hh + 1] * inv[hh]);
      }
    }
    __syncwarp();
    bf16* dst = a.out + (size_t)b * a.out_bs + h * HD;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = i * 4 + (lane >> 3), c = lane & 7;
      const int row = tile * 64 + w * 16 + r;
      if (row < a.N)
        *reinterpret_cast<uint4*>(dst + (size_t)row * a.out_ld + c * 8) =
            *reinterpret_cast<const uint4*>(Qs + swz(r, c));
    }
  }
}

// ---------------------------------------------------------------------------
// The kernel
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(128 * (WGS + 1), 1)
long_attention_kernel(__grid_constant__ const CUtensorMap tm_q,
                      __grid_constant__ const CUtensorMap tm_k,
                      __grid_constant__ const CUtensorMap tm_v, const Args a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const Layout l = layout(a.kv_tiles);
  uint64_t* qfull = reinterpret_cast<uint64_t*>(base + l.bars);
  uint64_t* qempty = qfull + 2;
  uint64_t* kvfull = qempty + 2;
  uint64_t* kvempty = kvfull + l.stages;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool with_q = a.out != nullptr;
  const bool side = a.side_out != nullptr;
  if (threadIdx.x == 0) {
    for (int s = 0; s < 2; ++s) {
      // the producer's arrive [, one per producer lane for its side copies]
      mbar_init(&qfull[s], side ? 33 : 1);
      mbar_init(&qempty[s], 4 * WGS);  // one arrive per consumer warp
    }
    for (int s = 0; s < l.stages; ++s) {
      mbar_init(&kvfull[s], 1);
      mbar_init(&kvempty[s], 4 * WGS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int units = a.B * a.heads * a.per_item;
  if (warp < 4) {
    // producer warpgroup: its first warp's lane 0 loads a unit's Q tiles
    // and streams the item's K and V tiles, running ahead into the next
    // unit as far as the slots allow; the lanes copy the side row's inputs
    // with cp.async; the warpgroup leaves its registers to the consumers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS) : "memory");
    if (warp != 0) return;
    int it = 0;
    for (int unit = blockIdx.x, u = 0; unit < units; unit += gridDim.x, ++u) {
      const int item = unit / a.per_item, part = unit % a.per_item;
      const int b = item / a.heads, h = item % a.heads;
      const int qs = u & 1;
      mbar_wait(&qempty[qs], ((u >> 1) & 1) ^ 1);  // the first pass finds both free
      if (lane == 0) {
        if (with_q) {
          // the unit's tiles; rows past N come as zeros and count
          mbar_arrive_expect_tx(&qfull[qs], QSLOT);
          for (int c = 0; c < WGS; ++c)
            tma_load_3d(base + l.q + qs * QSLOT + c * TILE64, &tm_q, &qfull[qs], h * HD,
                        (part * WGS + c) * 64, b);
        } else {
          mbar_arrive(&qfull[qs]);
        }
      }
      if (side) {
        if (part == a.side_tile / WGS) {
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
          unsigned char* dst = base + s * KV_BYTES;
          mbar_arrive_expect_tx(&kvfull[s], KV_BYTES);  // rows past N count, as zeros
          tma_load_3d(dst, &tm_k, &kvfull[s], h * HD, kt * KT, b);
          tma_load_3d(dst + KV_BYTES / 2, &tm_v, &kvfull[s], h * HD, kt * KT, b);
        }
      }
    }
    return;
  }

  // a consumer warpgroup: tile part x WGS + cw of the unit's item; warp w
  // of it holds rows 16 w.. in the wgmma fragments
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS) : "memory");
  const int cw = (warp >> 2) - 1, w = warp & 3;
  Ring ring{static_cast<uint32_t>(smem_desc(base)), kvfull, kvempty, l.stages, 0, 0};
  for (int unit = blockIdx.x, u = 0; unit < units; unit += gridDim.x, ++u) {
    const int item = unit / a.per_item, part = unit % a.per_item;
    const int b = item / a.heads, h = item % a.heads;
    const int qs = u & 1;
    const int tile = part * WGS + cw;
    unsigned char* Qs = base + l.q + qs * QSLOT + cw * TILE64 + w * TILE16;
    unsigned char* in = base + l.side + qs * l.side_slot;
    mbar_wait(&qfull[qs], (u >> 1) & 1);
    if (tile >= a.tiles) {
      // past the item's last tile: pass its key tiles on
      for (int kt = 0; kt < a.kv_tiles; ++kt) ring.give(ring.take(), lane);
    } else if (side && tile == a.side_tile) {
      attend_tile<true>(a, Qs, in, ring, b, h, tile, w, lane);
    } else {
      attend_tile<false>(a, Qs, in, ring, b, h, tile, w, lane);
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
// v at least N row strides. N > 64: an item has two key tiles or more.
int oadp_long_attention(int B, int N, int heads, float scale, const void* q, long long q_bs,
                        int q_ld, const void* k, long long k_bs, int k_ld, const void* v,
                        long long v_bs, int v_ld, void* out, long long out_bs, int out_ld,
                        const void* qy, int qy_ld, const void* ky, int ky_ld, const void* vy,
                        int vy_ld, const float* bias, void* side_out, int side_ld,
                        void* stream) {
  using namespace oadp;
  const bool with_q = out != nullptr;
  const bool side = side_out != nullptr;
  if (B <= 0 || N <= KT || N > 4096 || (!with_q && !side)) return cudaErrorInvalidValue;
  // an item's rows (its main rows, then the side row at N; or the side row
  // alone) in 64-row tiles, WGS tiles a unit (N = 1,025 with the side row:
  // 17 tiles in 6 units, the last tile holding row 1,024 and the side row)
  const int rows = (with_q ? N : 0) + (side ? 1 : 0);
  const int tiles = (rows + 63) / 64;
  const int per_item = (tiles + WGS - 1) / WGS;
  const int kv_tiles = (N + KT - 1) / KT;
  const Layout l = layout(kv_tiles);
  if (l.stages < 2 || l.total > SMEM_LIMIT) return cudaErrorInvalidValue;
  static const cudaError_t attr = cudaFuncSetAttribute(
      long_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
  cudaError_t e = attr;
  if (e != cudaSuccess) return e;

  // (D, N, B) tensor maps over the column slices: boxes of one 64-row tile,
  // one head's 64 columns
  CUtensorMap tm[3] = {};
  const void* ptr[3] = {q, k, v};
  const long long bs[3] = {q_bs, k_bs, v_bs};
  const int ld[3] = {q_ld, k_ld, v_ld};
  for (int i = with_q ? 0 : 1; i < 3; ++i) {
    const uint64_t dims[3] = {(uint64_t)heads * HD, (uint64_t)N, (uint64_t)B};
    const uint64_t strides[2] = {(uint64_t)ld[i] * 2, (uint64_t)bs[i] * 2};
    const uint32_t box[3] = {HD, 64, 1};
    if ((e = make_tmap(&tm[i], ptr[i], 3, dims, strides, box)) != cudaSuccess) return e;
  }
  const Args a{B, N, heads, tiles, kv_tiles, per_item,
               with_q ? N / 64 : 0, with_q ? N % 64 : 0, scale,
               static_cast<bf16*>(out), out_bs, out_ld,
               static_cast<const bf16*>(qy), qy_ld,
               static_cast<const bf16*>(ky), ky_ld,
               static_cast<const bf16*>(vy), vy_ld,
               bias,
               static_cast<bf16*>(side_out), side_ld};
  const long long units = (long long)B * heads * per_item;
  if (units > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int grid = (int)std::min<long long>(units, sm_count());
  long_attention_kernel<<<grid, 128 * (1 + WGS), l.total,
                          static_cast<cudaStream_t>(stream)>>>(tm[0], tm[1], tm[2], a);
  return cudaGetLastError();
}

}  // extern "C"
