// ln_gemm: C = epilogue(LN?(A) @ W + bias), bf16 in and out, fp32 accumulate.
//
// One of the two kernel families behind the ported Pallas kernels
// (oadp_tpu/ops/attention.py): it carries every product those kernels do
// outside the per-head attention -- the QKV projection after LayerNorm
// (_surgery_layer_kernel, _ln_qkv_attn_kernel), the folded out-projection
// with its residual add (_surgery_layer_kernel with out_w), and both halves
// of the row MLP (_row_mlp_kernel) -- and the encoder glue that oadp_tpu
// leaves to XLA (oadp_tpu/models/clip.py:_mlp and _block_fused's
// out-projection): the x-stream MLP of every fused layer and the stock
// encoder's out-projection with their residuals (ops/attention.py:
// ln_mlp_residual, out_proj_residual).
//
//   A (M, K) row-major; Wt (N, K) the weight K-major, as the OpenAI state
//   dict holds it (the caller prepares it once, oadp_torch/models/clip.py);
//   bias (N,); optional residual R (M, N); C (M, N). One launch carries up
//   to two such row sets (segments) with the same K, weight, LayerNorm and
//   epilogue, each with its own A, R, C and column slice of the weight: the
//   surgery layer's x rows and its y rows.
//   LN:        A row -> (a - mean) * rstd * gamma + beta in fp32, rounded to
//              bf16 before the product (eps 1e-5; the Pallas kernels round the
//              LN output to the activation type the same way).
//   epilogue:  0 none, 1 quick_gelu x*sigmoid(1.702x), 2 residual R + x.
//
// Bound on the H100: the QKV GEMM of the objects encoder (M = 2048 x 197,
// K = 768, N = 2304) is 1.43 TFLOP against 0.62 GB of A, far above the
// card's ~295 FLOP/byte ridge, so it is bound by tensor-core operations;
// so are the x-stream MLP's two products at that M (768 -> 3072 with
// quick_gelu, 3072 -> 768 with the residual, 1.9 TFLOP each). The
// out-projection with its residual (N = 768, K = 768) is 0.48 TFLOP
// against 1.86 GB: its bytes weigh as much as its products. At the globals
// rows (M = 800) every product is a few microseconds, bound by how fast the
// few busy SMs pull their operands through L2.
//
// Design: a persistent, warp-specialised wgmma GEMM, one block per SM. Its
// first warpgroup gives up registers (setmaxnreg) and one thread of it
// issues TMA loads of the A and W k-tiles (64 deep, 128-byte swizzle) into
// a ring of 3-8 stages, each guarded by a full and an empty mbarrier,
// running ahead through tile boundaries. The two consumer warpgroups issue
// wgmma m64nBNk16 straight from shared memory, keep one wgmma group in
// flight across k-tiles (wait_group 1), release a stage as soon as the
// group that read it has retired, and run the epilogue: bias, quick_gelu
// (__expf, __fdividef) or the residual in fp32, rounded once to bf16 into
// swizzled 64 x 64 staging tiles that TMA stores write out. The residual
// comes by TMA into those staging tiles early in each tile's k-loop, so it
// is added in place. Tiles are walked N fastest, a second segment's after
// the first's. Two schedules share all of this (the caller picks one, with
// its tile width, per launch: ops/attention.py:ln_gemm_plan, from rates
// measured by oadp_torch/profile_kernels.py gemm):
//   cooperative (gemm_kernel): both consumers work one 128 x BN tile, 64
//     rows each, and run its epilogue together before either issues the
//     next tile's first wgmma, so the tensor cores idle for every epilogue
//     (quick_gelu's two special-function operations an element cost about
//     a fifth of the fc's time). Each 128 x 256 tile reads the fewest bytes
//     through L2 per product.
//   ping-pong (pingpong_kernel): each consumer owns whole 64 x 256 tiles,
//     every other tile of the block's walk, and a pair of mbarriers makes
//     their main loops take turns: one issues its tile's wgmmas while the
//     other runs the previous tile's epilogue and stores, so the epilogue
//     leaves the tensor cores' path. The ring's stages are consumed in tile
//     order, and a consumer waits on its first stage only after the other
//     has issued its main loop, so it never waits on a fill two rounds
//     ahead (which mbarrier parity cannot tell apart). 64-row tiles alone
//     would read each W k-tile through L2 for half the rows; so the blocks
//     run in clusters of two, which take the two 64-row halves of a
//     128 x 256 tile, each loading half of its W k-tile, multicast by TMA
//     into both (a stage is refilled once the consumers of both blocks
//     have released it): the bytes through L2 per product are the
//     cooperative tile's. (Without clusters, or at 64 or 128 columns,
//     ping-pong ran slower than the cooperative tile at every shape the
//     encoders run: PERF.md.)
// Which launch takes which (PERF.md section 6, profile_kernels.py gemm on
// an H100): ping-pong only for the x-stream fc with quick_gelu at the
// objects and blocks rows, where every block gets four tiles or more and
// the hidden epilogue (quick_gelu's two special-function operations an
// element) pays for ping-pong's products running ~10% below the
// cooperative 128 x 256 tile's (each W k-tile written into shared memory
// serves 64 rows, not 128): without quick_gelu the cooperative tile is
// faster (kernel 1), and a block with one or two tiles has nothing to
// alternate with (kernel 2, the globals rows). The cooperative
// width follows the waves: 256 for the objects proj (K = 3072), 128 for
// the residual at K = 768, kernel 2 and the blocks proj, 64 and 256 at
// the globals rows.
// The LN prologue stays a one-warp-a-row pass that writes LN(A) in bf16
// (both segments in one launch), which the product then reads: normalising
// on the product's A path was measured slower in every form tried -- an
// in-place rewrite of each landed A k-tile by spare warps, by the consumers,
// or wgmma with A from registers normalised between k-steps -- because at
// N = 2304 each A k-tile is normalised again for each of the nine column
// tiles, and the read-only statistics pass those forms need costs most of
// what the pass saves (PERF.md).
#include <algorithm>

#include "common.cuh"

namespace oadp {
namespace {

constexpr int BK = 64;
constexpr int THREADS = 384;  // producer warpgroup + two consumer warpgroups
constexpr int SMEM_LIMIT = 232448;  // dynamic shared memory a block may take
constexpr int OUT_TILE = 64 * 64 * 2;

enum Epilogue { EPI_NONE = 0, EPI_GELU = 1, EPI_RESIDUAL = 2 };
enum Schedule { COOPERATIVE = 0, PINGPONG = 1 };

// Shared memory: the k-tile ring (a stage holds a block's TM x 64 A k-tile
// and its BN x 64 W k-tile), then per consumer warpgroup its bf16 64 x 64
// staging tiles for the TMA stores (the residual epilogue keeps one per 64
// columns, R lands there; the others alternate two), then the barriers:
// full and empty per stage, then per consumer one for its R blocks and
// (ping-pong) one for its turn.
template <int BN, int EPI, int PP>
struct Tile {
  static constexpr int TM = PP ? 64 : 128;  // a block's rows of a tile
  static constexpr int A_BYTES = TM * BK * 2;
  static constexpr int STAGE = A_BYTES + BN * BK * 2;
  static constexpr int OUT_TILES = EPI == EPI_RESIDUAL ? BN / 64 : 2;
  static constexpr int OUT_BYTES = 2 * OUT_TILES * OUT_TILE;
  static constexpr int BAR_BYTES = (2 * 8 + 4) * 8;
  static constexpr int FIT = (SMEM_LIMIT - 1024 - BAR_BYTES - OUT_BYTES) / STAGE;
  static constexpr int STAGES = FIT > 8 ? 8 : FIT;
  static constexpr int OUT = STAGES * STAGE;  // staging tiles [2 consumers][OUT_TILES]
  static constexpr int BARS = OUT + OUT_BYTES;
  static constexpr int SMEM = BARS + BAR_BYTES + 1024;  // + slack to align to 1024
  static_assert(STAGES >= 3, "the ring needs three stages");
};

// One row set of a launch. Its units are [first, first + row units x
// tiles_n) of the launch's walk; a unit is one tile (cooperative), or the
// pair of vertically adjacent tiles a cluster's blocks share (ping-pong).
struct Seg {
  int M, N, tiles_n, first;
  const bf16* bias;  // (N,): the segment's column slice
};

struct Params {
  CUtensorMap a[2], w[2], c[2], r[2];  // per segment: A, W slice (BN / CL rows a box), C, R
  Seg seg[2];
  int segs, units, K;
};

// A TMA load that lands at `dst`'s offset in both blocks of a cluster and
// completes its bytes on the mbarrier at `bar`'s offset in each (the
// cluster helpers are in common.cuh).
__device__ __forceinline__ void tma_load_2d_multicast(void* dst, const CUtensorMap* map,
                                                      uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%3, %4}], [%2], %5;\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1),
      "h"(static_cast<uint16_t>(0x3))
      : "memory");
}

// d (64 x 128 fp32 per warpgroup) += A (64 x 16, shared) * B (128 x 16, shared)^T,
// both K-major with the 128-byte swizzle.
__device__ __forceinline__ void wgmma_m64n128k16(float* d, uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// d (64 x 256 fp32 per warpgroup) += A (64 x 16, shared) * B (256 x 16, shared)^T,
// both K-major with the 128-byte swizzle.
__device__ __forceinline__ void wgmma_m64n256k16(float* d, uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 0;\n"
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
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

template <int BN>
__device__ __forceinline__ void wgmma_tile(float* d, uint64_t desc_a, uint64_t desc_b) {
  if constexpr (BN == 256) wgmma_m64n256k16(d, desc_a, desc_b);
  else if constexpr (BN == 128) wgmma_m64n128k16(d, desc_a, desc_b);
  else wgmma_m64n64k16(d, desc_a, desc_b);
}

struct TileAt {
  int s, m0, n0;  // segment, this block's first row and column
};

// The tile of block `rank` of a cluster of CL in unit `unit`; with CL = 2
// its rows may lie wholly past M (the second tile of a segment's last
// unit), and then its loads bring zeros and its stores write nothing.
template <int BN, int TM, int CL>
__device__ __forceinline__ TileAt tile_at(const Params& p, int unit, int rank) {
  const int s = p.segs > 1 && unit >= p.seg[1].first ? 1 : 0;
  const int local = unit - p.seg[s].first;
  return {s, (CL * (local / p.seg[s].tiles_n) + rank) * TM, (local % p.seg[s].tiles_n) * BN};
}

// One 64 x 64 block of a consumer warpgroup's output, from the wgmma
// fragments acc (acc[jn * 4 + 2h + e]: row w * 16 + g + 8h, column
// jn * 8 + 2t + e): bias, quick_gelu or residual in fp32, rounded once to
// bf16 into the swizzled staging tile buf. The residual is read from buf,
// where TMA loaded it, each thread reading and overwriting its own pairs.
// n0 is the block's first column; columns past N take no bias.
template <int EPI>
__device__ __forceinline__ void epilogue_block(const float* acc, unsigned char* buf, int n0,
                                               int N, const bf16* bias, int w, int g, int t) {
#pragma unroll
  for (int jn = 0; jn < 8; ++jn) {
    const int n = n0 + jn * 8 + 2 * t;
    const float2 bb = n < N ? __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(bias + n))
                            : make_float2(0.f, 0.f);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = w * 16 + g + h * 8;  // row within the block's 64
      __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(buf + swz(r, jn) + 4 * t);
      float v0 = acc[jn * 4 + 2 * h] + bb.x;
      float v1 = acc[jn * 4 + 2 * h + 1] + bb.y;
      if (EPI == EPI_GELU) {  // fast exp and divide: a few fp32 ulps, far below bf16's
        v0 = __fdividef(v0, 1.f + __expf(-1.702f * v0));
        v1 = __fdividef(v1, 1.f + __expf(-1.702f * v1));
      }
      if (EPI == EPI_RESIDUAL) {
        const float2 rr = __bfloat1622float2(*dst);
        v0 = rr.x + v0;
        v1 = rr.y + v1;
      }
      *dst = __floats2bfloat162_rn(v0, v1);
    }
  }
}

// The body of both schedules (PP: ping-pong, in clusters of CL = 2
// blocks; cooperative: CL = 1). Named barrier 1 + cw: a consumer's own
// epilogue. Ping-pong's turns: consumer cw's warps arrive on turn[cw] once
// they have issued a main loop (so every fill it read has landed), and the
// other consumer waits on it before its next main loop; an mbarrier, so
// that a fault traps rather than hangs.
template <int BN, int EPI, int PP>
__device__ __forceinline__ void gemm_body(const Params& p) {
  using T = Tile<BN, EPI, PP>;
  constexpr int CL = PP ? 2 : 1;
  extern __shared__ unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: align the ring to it
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + T::BARS);
  uint64_t* empty = full + T::STAGES;
  uint64_t* rfull = empty + T::STAGES;  // residual: a consumer's R blocks have landed
  uint64_t* turn = rfull + 2;

  const int tid = threadIdx.x, wg = tid >> 7;
  if (tid == 0) {
    for (int s = 0; s < T::STAGES; ++s) {
      mbar_init(&full[s], 1);  // the producer's arrive, plus the TMA bytes
      // one arrive per consumer warp that reads the stage: both consumers'
      // (cooperative), or one consumer's in each block of the cluster
      mbar_init(&empty[s], 8);
    }
    for (int c = 0; c < 2; ++c) {
      mbar_init(&rfull[c], 1);
      mbar_init(&turn[c], 4);  // one arrive per warp of the consumer
    }
    mbar_init_fence();
  }
  if (CL > 1)
    cluster_sync();  // both blocks' barriers are ready before either loads
  else
    __syncthreads();

  const int KT = p.K / BK;

  if (wg == 0) {
    // producer: one thread keeps the ring full, through tile boundaries
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == 0) {
      const int rank = CL > 1 ? cluster_rank() : 0;
      int stage = 0;
      unsigned phase = 0;
      for (int unit = blockIdx.x / CL; unit < p.units; unit += gridDim.x / CL) {
        const TileAt at = tile_at<BN, T::TM, CL>(p, unit, rank);
        for (int kt = 0; kt < KT; ++kt) {
          // free in this block (and the peer: this block's W half lands in both)
          mbar_wait(&empty[stage], phase ^ 1);  // the first pass finds every slot free
          unsigned char* dst = ring + stage * T::STAGE;
          mbar_arrive_expect_tx(&full[stage], T::STAGE);  // rows past M or N come as zeros
          tma_load_2d(dst, &p.a[at.s], &full[stage], kt * BK, at.m0);
          if (CL > 1)
            tma_load_2d_multicast(dst + T::A_BYTES + rank * (BN / 2) * 128, &p.w[at.s],
                                  &full[stage], kt * BK, at.n0 + rank * (BN / 2));
          else
            tma_load_2d(dst + T::A_BYTES, &p.w[at.s], &full[stage], kt * BK, at.n0);
          if (++stage == T::STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int rank = CL > 1 ? cluster_rank() : 0;
    const int first = blockIdx.x / CL, units_step = gridDim.x / CL;  // the block's walk
    const int cw = wg - 1;
    const int ctid = tid & 127, lane = tid & 31, w = ctid >> 5;
    const int g = lane >> 2, t = lane & 3;
    unsigned char* out_s = ring + T::OUT + cw * T::OUT_TILES * OUT_TILE;
    float acc[BN / 2];
    int stage = 0, stores = 0;
    unsigned phase = 0, rphase = 0, tphase = 0;
    // cooperative: every unit of the walk, this consumer's 64 rows of it;
    // ping-pong: units i = cw, cw + 2, ... of the walk, all 64 rows
    for (int i = PP ? cw : 0, unit = first + i * units_step; unit < p.units;
         i += PP ? 2 : 1, unit += (PP ? 2 : 1) * units_step) {
      const TileAt at = tile_at<BN, T::TM, CL>(p, unit, rank);
      const int m0 = at.m0 + (PP ? 0 : cw * 64);
      const int N = p.seg[at.s].N;
      const bf16* bias = p.seg[at.s].bias;
      if (PP) {
        // the other consumer has issued unit i - 1's main loop, so every
        // fill before this unit's has landed; this unit's k-tiles start at
        // position i x KT of the ring's sequence
        if (i > 0) {
          mbar_wait(&turn[cw ^ 1], tphase);
          tphase ^= 1;
        }
        stage = (i * KT) % T::STAGES;
        phase = ((i * KT) / T::STAGES) & 1;
      }
#pragma unroll
      for (int j = 0; j < BN / 2; ++j) acc[j] = 0.f;
      int held = -1;  // the stage the in-flight wgmma group reads
      for (int kt = 0; kt < KT; ++kt) {
        mbar_wait(&full[stage], phase);
        const unsigned char* a_s = ring + stage * T::STAGE + (PP ? 0 : cw * 64 * 128);
        const unsigned char* b_s = ring + stage * T::STAGE + T::A_BYTES;
        fence_acc<BN / 2>(acc);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < BK / 16; ++ks)  // 16 k = 32 bytes into each swizzled row
          wgmma_tile<BN>(acc, smem_desc(a_s + ks * 32), smem_desc(b_s + ks * 32));
        wgmma_commit();
        if (EPI == EPI_RESIDUAL && ctid == 0 && kt == min(2, KT - 1)) {
          // R of this tile into the staging tiles, once the stores of
          // this consumer's previous tile have read them
          asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
          mbar_arrive_expect_tx(&rfull[cw], T::OUT_TILES * OUT_TILE);  // rows past M: zeros
#pragma unroll
          for (int cc = 0; cc < T::OUT_TILES; ++cc)
            tma_load_2d(out_s + cc * OUT_TILE, &p.r[at.s], &rfull[cw], at.n0 + cc * 64, m0);
        }
        // the group of k-tile kt-1 has retired: its stage may be refilled
        wgmma_wait<1>();
        fence_acc<BN / 2>(acc);
        if (held >= 0 && lane == 0) {
          mbar_arrive(&empty[held]);
          if (CL > 1) mbar_arrive_peer(&empty[held], rank ^ 1);
        }
        held = stage;
        if (++stage == T::STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      // the other consumer's next main loop may start behind this one's
      if (PP && lane == 0 && unit + units_step < p.units) mbar_arrive(&turn[cw]);
      wgmma_wait<0>();
      fence_acc<BN / 2>(acc);
      if (lane == 0) {
        mbar_arrive(&empty[held]);
        if (CL > 1) mbar_arrive_peer(&empty[held], rank ^ 1);
      }

      // Epilogue, 64 columns at a time, each block stored by TMA as soon
      // as it is staged (rows past M, columns past N are not written).
      // The residual's blocks each have their own staging tile; the
      // others alternate two, a tile being rewritten once the store
      // issued from it two blocks earlier has read it.
      if (EPI == EPI_RESIDUAL) {
        mbar_wait(&rfull[cw], rphase);
        rphase ^= 1;
      }
#pragma unroll
      for (int cc = 0; cc < BN / 64; ++cc, ++stores) {
        unsigned char* buf = out_s + (EPI == EPI_RESIDUAL ? cc : stores & 1) * OUT_TILE;
        if (EPI != EPI_RESIDUAL) {
          if (ctid == 0) asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
          named_barrier(1 + cw, 128);
        }
        epilogue_block<EPI>(acc + cc * 32, buf, at.n0 + cc * 64, N, bias, w, g, t);
        fence_proxy_async();  // the staging writes, before the TMA store reads them
        named_barrier(1 + cw, 128);
        if (ctid == 0) {
          tma_store_2d(&p.c[at.s], buf, at.n0 + cc * 64, m0);
          asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        }
      }
    }
    // the staging tiles must outlive the stores' reads of them
    if (ctid == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
  if (CL > 1) cluster_sync();  // no block leaves while its peer may still signal it
}

template <int BN, int EPI>
__global__ void __launch_bounds__(THREADS, 1) gemm_kernel(const __grid_constant__ Params p) {
  gemm_body<BN, EPI, 0>(p);
}

template <int BN, int EPI>
__global__ void __launch_bounds__(THREADS, 1) pingpong_kernel(const __grid_constant__ Params p) {
  gemm_body<BN, EPI, 1>(p);
}

// The host side of one segment.
struct SegArgs {
  const bf16* a;
  int M, N, col0;
  const bf16* r;
  bf16* c;
};

// Launches one schedule's kernel over the segments. `units` is the unit
// count the caller's plan expects (ops/attention.py:ln_gemm_units); a
// launch whose walk would differ is refused.
template <int BN, int EPI, int PP>
cudaError_t launch(int K, const bf16* Wt, const bf16* bias, const SegArgs* segs, int nseg,
                   int units, cudaStream_t stream) {
  using T = Tile<BN, EPI, PP>;
  constexpr int CL = PP ? 2 : 1;
  const auto kernel = [] {
    if constexpr (PP)
      return pingpong_kernel<BN, EPI>;
    else
      return gemm_kernel<BN, EPI>;
  }();
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);  // once
  cudaError_t e = attr;
  if (e != cudaSuccess) return e;
  Params p = {};
  p.segs = nseg;
  p.K = K;
  const uint64_t k_bytes[1] = {(uint64_t)K * 2};
  const uint32_t box_a[2] = {BK, T::TM}, box_w[2] = {BK, BN / CL}, box_c[2] = {64, 64};
  int walk = 0;
  for (int s = 0; s < nseg; ++s) {
    const SegArgs& g = segs[s];
    const uint64_t n_bytes[1] = {(uint64_t)g.N * 2};
    const uint64_t dims_a[2] = {(uint64_t)K, (uint64_t)g.M}, dims_w[2] = {(uint64_t)K, (uint64_t)g.N};
    const uint64_t dims_c[2] = {(uint64_t)g.N, (uint64_t)g.M};
    if ((e = make_tmap(&p.a[s], g.a, 2, dims_a, k_bytes, box_a)) != cudaSuccess) return e;
    if ((e = make_tmap(&p.w[s], Wt + (size_t)g.col0 * K, 2, dims_w, k_bytes, box_w)) !=
        cudaSuccess)
      return e;
    if ((e = make_tmap(&p.c[s], g.c, 2, dims_c, n_bytes, box_c)) != cudaSuccess) return e;
    if (EPI == EPI_RESIDUAL &&
        (e = make_tmap(&p.r[s], g.r, 2, dims_c, n_bytes, box_c)) != cudaSuccess)
      return e;
    p.seg[s].M = g.M;
    p.seg[s].N = g.N;
    p.seg[s].tiles_n = (g.N + BN - 1) / BN;
    p.seg[s].first = walk;
    p.seg[s].bias = bias + g.col0;
    const int row_tiles = (g.M + T::TM - 1) / T::TM;
    walk += ((row_tiles + CL - 1) / CL) * p.seg[s].tiles_n;
  }
  if (walk != units) return cudaErrorInvalidValue;
  p.units = units;
  if constexpr (CL == 1) {
    kernel<<<std::min(units, sm_count()), THREADS, T::SMEM, stream>>>(p);
  } else {  // clusters of CL blocks, as many as can be resident at once
    cudaLaunchAttribute cluster[1];
    cluster[0].id = cudaLaunchAttributeClusterDimension;
    cluster[0].val.clusterDim.x = CL;
    cluster[0].val.clusterDim.y = 1;
    cluster[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(CL);
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = T::SMEM;
    cfg.stream = stream;
    cfg.attrs = cluster;
    cfg.numAttrs = 1;
    static const int resident = [&] {  // once
      int n = 0;
      return cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) == cudaSuccess ? n : 0;
    }();
    if (resident <= 0) return cudaErrorInvalidConfiguration;
    cfg.gridDim = dim3(CL * std::min(units, resident));
    if ((e = cudaLaunchKernelEx(&cfg, kernel, p)) != cudaSuccess) return e;
  }
  return cudaGetLastError();
}

template <int BN, int PP>
cudaError_t launch_epilogue(int epilogue, int K, const bf16* Wt, const bf16* bias,
                            const SegArgs* segs, int nseg, int units, cudaStream_t s) {
  switch (epilogue) {
    case EPI_NONE: return launch<BN, EPI_NONE, PP>(K, Wt, bias, segs, nseg, units, s);
    case EPI_GELU: return launch<BN, EPI_GELU, PP>(K, Wt, bias, segs, nseg, units, s);
    case EPI_RESIDUAL: return launch<BN, EPI_RESIDUAL, PP>(K, Wt, bias, segs, nseg, units, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace oadp

extern "C" {

// Shapes are checked by the Python wrapper: K % 64 == 0 (and K <= 1024
// with LN), N % 8 == 0, every pointer 16-byte aligned. Wt (rows, K) is the
// whole K-major weight; segment s reads its rows col0_s .. col0_s + N_s and
// bias[col0_s ..]. The second segment is absent when A1 == nullptr.
// gamma == nullptr means no LayerNorm; otherwise ln_out (M0 + M1, K)
// receives LN of both segments' rows and the product reads it. The plan
// (ops/attention.py:ln_gemm_plan): schedule 0 cooperative (tile_n 64, 128
// or 256) or 1 ping-pong (tile_n 256), and the walk's unit count it
// expects.
int oadp_ln_gemm(int K, const float* gamma, const float* beta, void* ln_out, const void* Wt,
                 const void* bias, int epilogue, int schedule, int tile_n, int units,
                 const void* A0, int M0, int N0, int col00, const void* R0, void* C0,
                 const void* A1, int M1, int N1, int col01, const void* R1, void* C1,
                 void* stream) {
  using namespace oadp;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  SegArgs segs[2] = {
      {static_cast<const bf16*>(A0), M0, N0, col00, static_cast<const bf16*>(R0),
       static_cast<bf16*>(C0)},
      {static_cast<const bf16*>(A1), M1, N1, col01, static_cast<const bf16*>(R1),
       static_cast<bf16*>(C1)}};
  const int nseg = A1 != nullptr ? 2 : 1;
  if (schedule != COOPERATIVE && (schedule != PINGPONG || tile_n != 256))
    return cudaErrorInvalidValue;
  if (gamma != nullptr) {
    const int rows = M0 + (nseg > 1 ? M1 : 0), rows_per_block = 8;  // 256 threads, a warp a row
    bf16* ln = static_cast<bf16*>(ln_out);
    layer_norm_kernel<<<(rows + rows_per_block - 1) / rows_per_block, 256, 0, s>>>(
        segs[0].a, M0, segs[1].a, nseg > 1 ? M1 : 0, K, gamma, beta, ln);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    segs[0].a = ln;
    segs[1].a = ln + (size_t)M0 * K;
  }
  const bf16* w = static_cast<const bf16*>(Wt);
  const bf16* b = static_cast<const bf16*>(bias);
  if (schedule == PINGPONG) return launch_epilogue<256, 1>(epilogue, K, w, b, segs, nseg, units, s);
  switch (tile_n) {
    case 64: return launch_epilogue<64, 0>(epilogue, K, w, b, segs, nseg, units, s);
    case 128: return launch_epilogue<128, 0>(epilogue, K, w, b, segs, nseg, units, s);
    case 256: return launch_epilogue<256, 0>(epilogue, K, w, b, segs, nseg, units, s);
  }
  return cudaErrorInvalidValue;
}

const char* oadp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
