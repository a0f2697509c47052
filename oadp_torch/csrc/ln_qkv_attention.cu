// ln_qkv_attention: LayerNorm -> QKV product -> per-head softmax attention of
// short sequences (the stock CLIP encoder's N = 50 tokens), with the qkv
// tensor kept in shared memory.
//
// Replaces oadp_tpu/ops/attention.py:fused_ln_qkv_attention (kernel
// _ln_qkv_attn_kernel) on the H100 for the shapes whose slots fit (see
// layout): out[b, r, h*64:] = softmax(q k^T * scale) v of head h, where
// q | k | v = LN(x[b]) @ Wqkv + bqkv.
//   x (B, N, D) bf16; LN in fp32, eps 1e-5, rounded to bf16; the product
//   with fp32 accumulation, the bias added in fp32, rounded to bf16; then
//   per head the TPU semantics of the attention (oadp_tpu/ops/attention.py:
//   46-50): logits x scale clamped at 80, exp with no max subtraction, the
//   weights rounded to bf16 for the PV product, fp32 row sums, normalised
//   after PV. Wt (3D, D) is the K-major weight as the OpenAI state dict
//   holds it; head h reads its rows h*64, D + h*64 and 2D + h*64 in place.
//
// Bound on the H100 at the blocks batch (B = 728 crops of 50 tokens, 36,400
// rows, D = 768, 12 heads): 128.8 GFLOP of QKV product and 5.6 GFLOP of
// attention, 0.136 ms at 989 TFLOP/s, against 112 MB of x in and out
// (0.033 ms at 3.35 TB/s): bound by operations. The route it replaces (an LN
// pass, ln_gemm, attention) also moves LN(x) out and back (2 x 55.9 MB) and
// the packed qkv out and back (2 x 167.7 MB), about 560 MB or 0.167 ms of
// bytes beside its ~0.195 ms of product.
//
// Design: two launches, the LN pass (one warp a row, LN(x) written in bf16)
// and the fused kernel, one block per (head, crop range): the B crops are
// cut into `ranges` contiguous ranges, ranges x heads <= the SMs, so every
// block runs at once and the 12 blocks of one range read its LN rows from
// L2 together. A block walks its range's rows in 128-row tiles that ignore
// the crop boundaries, so no row of a tile is padding but in the range's
// last tile (4% at B = 728); a tile of crop-aligned rows would waste 22%
// (2 crops of 50 in 128 rows). Warpgroup 0 is the producer: one thread
// issues TMA loads of the 128 x 64 LN k-tile and of the head's three 64 x 64
// weight k-tiles (one 192-row B operand) into a ring of 128-byte-swizzled
// 40 KB stages on full/empty mbarriers. Warpgroups 1-2 run the product,
// 64 rows each, on wgmma m64n192k16 from shared memory with a group in
// flight; their epilogue adds the bias in fp32 and writes q, k and v as
// bf16 from the accumulators into crop slots in shared memory: each crop
// has a q, a k and a v tile of 64 rows of 128 bytes, its rows at the
// tile's start, rows past N zero. Warpgroup 3 attends each crop as soon as
// a tile completes it, while warpgroups 1-2 run the next tile's product:
// S = Q K^T and O = P V on wgmma m64n64k16 from shared memory (V read as
// an MN-major operand, so the epilogue writes v as it writes q and k), P
// written in bf16 over Q. The slots hold every crop one tile can touch
// (127 / N + 2 of them, so N >= 26 fits beside two stages); a tile's
// epilogue waits until the previous tile's crops are attended, and then
// no slot it writes is still read. So q, k and v never leave the SM, and
// only LN(x) makes a round trip through device memory.
// What it leaves on the table: the epilogue, which no warpgroup overlaps
// (a warpgroup cannot hold two tiles' 64 x 192 accumulators), and the LN
// pass; times by part in PERF.md (chip_smoke.py phase 3).
// LayerNorm stays a pass of its own: normalising a range's rows once into
// shared memory does not fit beside the ring and the slots (a tile's 128 x
// 768 LN rows are 192 KB), and normalising the A k-tiles in the product
// would repeat it for each of the 12 heads (every form of LN on ln_gemm's
// A path measured slower than the pass there, at 9 repeats: PERF.md).
#include <algorithm>

#include "common.cuh"

namespace oadp {
namespace {

constexpr int HD = 64;                   // head width
constexpr int BM = 128, BK = 64;         // rows of a tile, k of a stage
constexpr int BN = 3 * HD;               // a head's q, k, v columns
// warpgroup 0: the producer (one thread); 1-2: the product's consumers;
// 3: attention
constexpr int THREADS = 512;
constexpr int CONSUMERS = 256;
constexpr int MAX_N = 64;                // a crop's tokens: one wgmma M and N
constexpr int PART = MAX_N * 128;        // a slot's Q, K or V tile
constexpr int SLOT = 3 * PART;
constexpr int SMEM_LIMIT = 232448;       // dynamic shared memory a block may take
constexpr int A_BYTES = BM * BK * 2;
constexpr int STAGE = A_BYTES + BN * BK * 2;
constexpr int MAX_STAGES = 4;
constexpr float LOG2E = 1.4426950408889634f;

// Shared memory: the ring of stages (A k-tile, then the 192-row weight
// k-tile), the crop slots, the head's bias in fp32, the barriers (full and
// empty per stage; `ready`: a tile's q, k, v are in the slots; `done`: the
// crops it completed are attended). stages < 2: the shape does not fit.
struct Layout {
  int slots, stages, slot0, bias, bars, total;
};

__host__ __device__ inline Layout layout(int N) {
  Layout l;
  l.slots = (BM - 1) / N + 2;  // crops one 128-row tile can touch
  const int fixed = 1024 + BN * 4 + (2 * MAX_STAGES + 2) * 8;
  const int room = SMEM_LIMIT - fixed - l.slots * SLOT;
  l.stages = N > MAX_N ? 0 : room / STAGE < MAX_STAGES ? room / STAGE : MAX_STAGES;
  l.slot0 = l.stages * STAGE;
  l.bias = l.slot0 + l.slots * SLOT;
  l.bars = l.bias + BN * 4;
  l.total = l.bars + (2 * l.stages + 2) * 8 + 1024;  // + slack to align to 1024
  return l;
}

struct Args {
  int B, N, heads, ranges;
  float scale_log2;  // scale * log2(e)
  const bf16* bias;  // (3D,)
  bf16* out;         // (B, N, D)
};

// ---------------------------------------------------------------------------
// wgmma with the head's q | k | v columns as B
// ---------------------------------------------------------------------------

// d (64 x 192 fp32 per warpgroup) += A (64 x 16, shared) * B (192 x 16, shared)^T,
// both K-major with the 128-byte swizzle.
__device__ __forceinline__ void wgmma_m64n192k16(float* d, uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, "
      "%96, %97, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// ---------------------------------------------------------------------------
// Attention of one crop by the attention warpgroup
// ---------------------------------------------------------------------------

// The crop's slot holds Q, K and V, each 64 token rows x 64 dims of 128
// bytes with the 128-byte swizzle; rows past N are zero. S = Q K^T on wgmma
// m64n64k16 from shared memory (Q and K K-major); the exp weights (keys past
// N weigh 0) are rounded to bf16 into P over Q, which S no longer needs; O =
// P V on wgmma from shared memory (V the MN-major B operand, 16 key rows a
// k-step), so no A operand comes from registers (a register A computed
// between wgmmas serialises them); rows are normalised by their fp32 sums
// and rows < N written to dst (row stride ld). Thread: warp w of the
// warpgroup, g = lane / 4, tq = lane % 4; barrier `bar` is the
// warpgroup's own.
__device__ __forceinline__ void attend_crop(unsigned char* slot, int N, float scale_log2, bf16* dst,
                                            int ld, int bar, int w, int g, int tq) {
  unsigned char* Qs = slot;
  const unsigned char* Ks = slot + PART;
  const unsigned char* Vs = slot + 2 * PART;
  float s[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks)
    wgmma_m64n64k16<0>(s, smem_desc(Qs + ks * 32), smem_desc(Ks + ks * 32));
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc<32>(s);
  named_barrier(bar, 128);  // every warp's product has read Q: P goes over it
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int jn = 0; jn < 8; ++jn) {
    const int key = jn * 8 + 2 * tq;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float p0 = key < N ? ex2(fminf(s[jn * 4 + 2 * hh] * scale_log2, 80.f * LOG2E)) : 0.f;
      const float p1 =
          key + 1 < N ? ex2(fminf(s[jn * 4 + 2 * hh + 1] * scale_log2, 80.f * LOG2E)) : 0.f;
      sum[hh] += p0 + p1;
      *reinterpret_cast<__nv_bfloat162*>(Qs + swz(w * 16 + g + 8 * hh, jn) + 4 * tq) =
          __floats2bfloat162_rn(p0, p1);
    }
  }
  fence_proxy_async();  // P, before the product reads it
  named_barrier(bar, 128);
  float o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks)
    wgmma_m64n64k16<1>(o, smem_desc(Qs + ks * 32), smem_desc(Vs + ks * 16 * 128));
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc<32>(o);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float total = sum[hh];
    total += __shfl_xor_sync(0xffffffffu, total, 1);
    total += __shfl_xor_sync(0xffffffffu, total, 2);
    const float inv = 1.f / total;
    const int row = w * 16 + g + 8 * hh;
    if (row < N) {
#pragma unroll
      for (int jn = 0; jn < 8; ++jn)
        *reinterpret_cast<__nv_bfloat162*>(dst + (size_t)row * ld + jn * 8 + 2 * tq) =
            __floats2bfloat162_rn(o[jn * 4 + 2 * hh] * inv, o[jn * 4 + 2 * hh + 1] * inv);
    }
  }
}

// ---------------------------------------------------------------------------
// The fused kernel: one block per (head, crop range)
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(THREADS, 1)
ln_qkv_attention_kernel(const __grid_constant__ CUtensorMap tm_a,
                        const __grid_constant__ CUtensorMap tm_w, const Args a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const Layout l = layout(a.N);
  unsigned char* slots = base + l.slot0;
  float* bias_s = reinterpret_cast<float*>(base + l.bias);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + l.bars);
  uint64_t* empty = full + l.stages;
  uint64_t* ready = empty + l.stages;
  uint64_t* done = ready + 1;

  const int N = a.N, D = a.heads * HD, KT = D / BK;
  const int h = blockIdx.x % a.heads, range = blockIdx.x / a.heads;
  const int c0 = (int)((long long)a.B * range / a.ranges);
  const int c1 = (int)((long long)a.B * (range + 1) / a.ranges);
  const int rows = (c1 - c0) * N, tiles = (rows + BM - 1) / BM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // rows past N stay zero in every slot: those keys weigh 0, and their V
  // rows must be finite
  for (int i = tid; i < l.slots * SLOT / 16; i += THREADS)
    reinterpret_cast<uint4*>(slots)[i] = make_uint4(0, 0, 0, 0);
  for (int c = tid; c < BN; c += THREADS)
    bias_s[c] = __bfloat162float(a.bias[(c / HD) * D + h * HD + c % HD]);
  if (tid == 0) {
    for (int s = 0; s < l.stages; ++s) {
      mbar_init(&full[s], 1);   // the producer's arrive, plus the TMA bytes
      mbar_init(&empty[s], 8);  // one arrive per consumer warp
    }
    mbar_init(ready, CONSUMERS);
    mbar_init(done, 128);
    mbar_init_fence();
  }
  fence_proxy_async();  // the zeroed slots, before wgmma reads them
  __syncthreads();

  if (warp < 4) {
    // producer: the LN k-tile of the tile's rows and the head's q, k and v
    // weight k-tiles (rows past B x N arrive as zeros)
    if (tid == 0) {
      int stage = 0;
      unsigned phase = 0;
      for (int t = 0; t < tiles; ++t) {
        for (int kt = 0; kt < KT; ++kt) {
          mbar_wait(&empty[stage], phase ^ 1);  // the first pass finds every slot free
          unsigned char* dst = base + stage * STAGE;
          mbar_arrive_expect_tx(&full[stage], STAGE);
          tma_load_2d(dst, &tm_a, &full[stage], kt * BK, c0 * N + t * BM);
#pragma unroll
          for (int p = 0; p < 3; ++p)
            tma_load_2d(dst + A_BYTES + p * HD * 128, &tm_w, &full[stage], kt * BK,
                        p * D + h * HD);
          if (++stage == l.stages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  const int w = (tid & 127) >> 5, g = lane >> 2, tq = lane & 3;
  if (warp >= 12) {
    // attention: after each tile, the crops it completed
    int next = 0;  // the first crop not yet attended
    for (int t = 0; t < tiles; ++t) {
      mbar_wait(ready, t & 1);
      const int last = min((t + 1) * BM, rows) / N;  // crops [next, last) are complete
      for (int cr = next; cr < last; ++cr)
        attend_crop(slots + (cr % l.slots) * SLOT, N, a.scale_log2,
                    a.out + (size_t)(c0 + cr) * N * D + h * HD, D, 2, w, g, tq);
      next = last;
      mbar_arrive(done);
    }
    return;
  }

  // consumers: 64 rows of each tile a warpgroup
  const int cw = (tid >> 7) - 1;
  float acc[BN / 2];
  int stage = 0;
  unsigned phase = 0;
  for (int t = 0; t < tiles; ++t) {
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    int held = -1;  // the stage the in-flight wgmma group reads
    for (int kt = 0; kt < KT; ++kt) {
      mbar_wait(&full[stage], phase);
      const unsigned char* a_s = base + stage * STAGE + cw * 64 * 128;
      const unsigned char* b_s = base + stage * STAGE + A_BYTES;
      fence_acc<BN / 2>(acc);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < BK / 16; ++ks)
        wgmma_m64n192k16(acc, smem_desc(a_s + ks * 32), smem_desc(b_s + ks * 32));
      wgmma_commit();
      wgmma_wait<1>();
      fence_acc<BN / 2>(acc);
      if (held >= 0 && lane == 0) mbar_arrive(&empty[held]);
      held = stage;
      if (++stage == l.stages) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    fence_acc<BN / 2>(acc);
    if (lane == 0) mbar_arrive(&empty[held]);

    // the previous tile's crops are attended: no slot written here is read
    if (t > 0) mbar_wait(done, (t - 1) & 1);
    // fragments acc[jn * 4 + 2hh + e]: row w * 16 + g + 8hh, column
    // jn * 8 + 2tq + e of q | k | v; bias in fp32, one rounding to bf16
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = t * BM + cw * 64 + w * 16 + g + 8 * hh;  // row of the range
      if (r < rows) {
        const int cr = r / N, rr = r - cr * N;
        unsigned char* slot = slots + (cr % l.slots) * SLOT;
#pragma unroll
        for (int jn = 0; jn < BN / 8; ++jn) {
          const float2 bb = *reinterpret_cast<const float2*>(bias_s + jn * 8 + 2 * tq);
          *reinterpret_cast<__nv_bfloat162*>(slot + (jn >> 3) * PART + swz(rr, jn & 7) + 4 * tq) =
              __floats2bfloat162_rn(acc[jn * 4 + 2 * hh] + bb.x, acc[jn * 4 + 2 * hh + 1] + bb.y);
        }
      }
    }
    fence_proxy_async();  // the slots' writes, before wgmma reads them
    mbar_arrive(ready);
  }
}

}  // namespace
}  // namespace oadp

extern "C" {

// Checked by the Python wrapper (oadp_torch/ops/attention.py): D = heads x
// 64 <= 1024, the slots of N fit (ln_qkv_attention_fits), every pointer
// 16-byte aligned, x, ln_out, out contiguous. ln_out (B x N, D) receives
// LN(x); Wt (3D, D) is the K-major weight, bias (3D,) bf16.
int oadp_ln_qkv_attention(int B, int N, int heads, float scale, const void* x,
                          const float* gamma, const float* beta, void* ln_out, const void* Wt,
                          const void* bias, void* out, void* stream) {
  using namespace oadp;
  const int D = heads * HD;
  const Layout l = layout(N > 0 ? N : 1);
  if (B <= 0 || N <= 0 || heads <= 0 || D > 32 * 8 * LN_CHUNKS || l.stages < 2)
    return cudaErrorInvalidValue;
  static const cudaError_t attr = cudaFuncSetAttribute(
      ln_qkv_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);  // once
  cudaError_t e = attr;
  if (e != cudaSuccess) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows = B * N, rows_per_block = 8;  // 256 threads, a warp a row
  layer_norm_kernel<<<(rows + rows_per_block - 1) / rows_per_block, 256, 0, s>>>(
      static_cast<const bf16*>(x), rows, nullptr, 0, D, gamma, beta, static_cast<bf16*>(ln_out));
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  CUtensorMap tm_a, tm_w;
  const uint64_t k_bytes[1] = {(uint64_t)D * 2};
  const uint64_t dims_a[2] = {(uint64_t)D, (uint64_t)rows}, dims_w[2] = {(uint64_t)D, 3ull * D};
  const uint32_t box_a[2] = {BK, BM}, box_w[2] = {BK, HD};
  if ((e = make_tmap(&tm_a, ln_out, 2, dims_a, k_bytes, box_a)) != cudaSuccess) return e;
  if ((e = make_tmap(&tm_w, Wt, 2, dims_w, k_bytes, box_w)) != cudaSuccess) return e;
  // ranges x heads blocks, at most one wave of the SMs where B allows
  const int ranges = std::max(1, std::min(B, sm_count() / heads));
  const Args a{B, N, heads, ranges, scale * LOG2E, static_cast<const bf16*>(bias),
               static_cast<bf16*>(out)};
  ln_qkv_attention_kernel<<<ranges * heads, THREADS, l.total, s>>>(tm_a, tm_w, a);
  return cudaGetLastError();
}

}  // extern "C"
