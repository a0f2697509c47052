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
// card's ~295 FLOP/byte ridge, so it is bound by tensor-core operations.
// The out-projection with its residual (N = 768) is 0.48 TFLOP against
// 1.86 GB (A and R read, C written): 0.48 ms of operations, 0.56 ms of
// bytes, so its epilogue's bytes weigh as much as its products. The
// x-stream MLP's two products at that M (768 -> 3072 with quick_gelu,
// 3072 -> 768 with the residual) are 1.9 TFLOP each, bound by operations;
// the consumers run each tile's epilogue between its products, so the
// quick_gelu (fast exp and divide) and the residual add to the products'
// time (PERF.md).
// Design: a persistent, warp-specialised wgmma GEMM. One block per SM walks
// output tiles of 128 x BN (BN 256, 128 or 64 by shape and epilogue, see
// pick_tile_n), N tiles fastest so the blocks that read one A row-panel run
// together; a second segment's tiles follow the first's. Its first
// warpgroup gives up registers (setmaxnreg) and one thread of it issues TMA
// loads of the 128 x 64 A and BN x 64 W k-tiles (128-byte swizzle) into a
// ring of 3-8 stages, each guarded by a full and an empty mbarrier; it runs
// ahead into the next tile while the consumers finish the current one. Two
// consumer warpgroups of 64 rows each wait on the full barrier, issue wgmma
// m64nBNk16 straight from shared memory, keep one wgmma group in flight
// across k-tiles (wait_group 1) and release a stage as soon as the group
// that read it has retired. The epilogue adds bias, quick_gelu or the
// residual in fp32 and rounds once to bf16 into swizzled 64 x 64 staging
// tiles, which TMA stores write out. The residual comes by TMA as well:
// early in each tile's k-loop, the consumer thread that issued the previous
// tile's stores waits until they have read their staging tiles and loads
// the tile's R blocks into them (one 64 x 64 block per 64 columns, on the
// warpgroup's own mbarrier), so R is in shared memory when the epilogue
// starts and is added in place, in the layout the epilogue writes, with no
// load from global memory.
// The LN prologue stays a one-warp-a-row pass that writes LN(A) in bf16
// (both segments in one launch), which the product then reads: normalising
// on the product's A path was measured slower in every form tried -- an
// in-place rewrite of each landed A k-tile by spare warps, by the consumers,
// or wgmma with A from registers normalised between k-steps -- because at
// N = 2304 each A k-tile is normalised again for each of the nine column
// tiles, and the read-only statistics pass those forms need costs most of
// what the pass saves (PERF.md).
// Rates against cuBLAS: oadp_torch/profile_kernels.py.
#include <algorithm>

#include "common.cuh"

namespace oadp {
namespace {

constexpr int BM = 128, BK = 64;
constexpr int THREADS = 384;  // producer warpgroup + two consumer warpgroups
constexpr int SMEM_LIMIT = 232448;  // dynamic shared memory a block may take
constexpr int OUT_TILE = 64 * 64 * 2;

enum Epilogue { EPI_NONE = 0, EPI_GELU = 1, EPI_RESIDUAL = 2 };

// Shared memory: the k-tile ring, then per consumer warpgroup its bf16
// 64 x 64 staging tiles for the TMA stores (the residual epilogue keeps one
// per 64 columns, R lands there; the others alternate two), then the
// barriers: full and empty per stage, one R barrier per consumer.
template <int BN, int EPI>
struct Tile {
  static constexpr int A_BYTES = BM * BK * 2;
  static constexpr int STAGE = A_BYTES + BN * BK * 2;
  static constexpr int OUT_TILES = EPI == EPI_RESIDUAL ? BN / 64 : 2;
  static constexpr int OUT_BYTES = 2 * OUT_TILES * OUT_TILE;
  static constexpr int BAR_BYTES = (2 * 8 + 2) * 8;
  static constexpr int FIT = (SMEM_LIMIT - 1024 - BAR_BYTES - OUT_BYTES) / STAGE;
  static constexpr int STAGES = FIT > 8 ? 8 : FIT;
  static constexpr int OUT = STAGES * STAGE;  // staging tiles [2 consumers][OUT_TILES]
  static constexpr int BARS = OUT + OUT_BYTES;
  static constexpr int SMEM = BARS + BAR_BYTES + 1024;  // + slack to align to 1024
  static_assert(STAGES >= 3, "the ring needs three stages");
};

// One row set of a launch. Its tiles are [first, first + m tiles x tiles_n)
// of the launch's walk.
struct Seg {
  int M, N, tiles_n, first;
  const bf16* bias;  // (N,): the segment's column slice
};

struct Params {
  CUtensorMap a[2], w[2], c[2], r[2];  // per segment: A, W slice, C, R
  Seg seg[2];
  int segs, tiles, K;
};

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
  int s, m0, n0;  // segment, first row and column
};

template <int BN>
__device__ __forceinline__ TileAt tile_at(const Params& p, int tile) {
  const int s = p.segs > 1 && tile >= p.seg[1].first ? 1 : 0;
  const int local = tile - p.seg[s].first;
  return {s, (local / p.seg[s].tiles_n) * BM, (local % p.seg[s].tiles_n) * BN};
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

template <int BN, int EPI>
__global__ void __launch_bounds__(THREADS, 1) gemm_kernel(const __grid_constant__ Params p) {
  using T = Tile<BN, EPI>;
  extern __shared__ unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: align the ring to it
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + T::BARS);
  uint64_t* empty = full + T::STAGES;
  uint64_t* rfull = empty + T::STAGES;  // residual: a consumer's R blocks have landed

  const int tid = threadIdx.x, wg = tid >> 7;
  if (tid == 0) {
    for (int s = 0; s < T::STAGES; ++s) {
      mbar_init(&full[s], 1);   // the producer's arrive, plus the TMA bytes
      mbar_init(&empty[s], 8);  // one arrive per consumer warp
    }
    mbar_init(&rfull[0], 1);
    mbar_init(&rfull[1], 1);
    mbar_init_fence();
  }
  __syncthreads();

  const int KT = p.K / BK;

  if (wg == 0) {
    // producer: one thread keeps the ring full, through tile boundaries
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == 0) {
      int stage = 0;
      unsigned phase = 0;
      for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
        const TileAt at = tile_at<BN>(p, tile);
        for (int kt = 0; kt < KT; ++kt) {
          mbar_wait(&empty[stage], phase ^ 1);  // the first pass finds every slot free
          unsigned char* dst = ring + stage * T::STAGE;
          mbar_arrive_expect_tx(&full[stage], T::STAGE);  // rows past M or N come as zeros
          tma_load_2d(dst, &p.a[at.s], &full[stage], kt * BK, at.m0);
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
    const int cw = wg - 1;  // this warpgroup's 64 rows of the tile
    const int ctid = tid & 127, lane = tid & 31, w = ctid >> 5;
    const int g = lane >> 2, t = lane & 3;
    unsigned char* out_s = ring + T::OUT + cw * T::OUT_TILES * OUT_TILE;
    float acc[BN / 2];
    int stage = 0, stores = 0;
    unsigned phase = 0, rphase = 0;
    for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
      const TileAt at = tile_at<BN>(p, tile);
      const int N = p.seg[at.s].N;
      const bf16* bias = p.seg[at.s].bias;
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
      int held = -1;  // the stage the in-flight wgmma group reads
      for (int kt = 0; kt < KT; ++kt) {
        mbar_wait(&full[stage], phase);
        const unsigned char* a_s = ring + stage * T::STAGE + cw * 64 * 128;
        const unsigned char* b_s = ring + stage * T::STAGE + T::A_BYTES;
        fence_acc<BN / 2>(acc);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < BK / 16; ++ks)  // 16 k = 32 bytes into each swizzled row
          wgmma_tile<BN>(acc, smem_desc(a_s + ks * 32), smem_desc(b_s + ks * 32));
        wgmma_commit();
        if (EPI == EPI_RESIDUAL && ctid == 0 && kt == min(2, KT - 1)) {
          // R of this tile into the staging tiles, once the stores of the
          // previous tile have read them
          asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
          mbar_arrive_expect_tx(&rfull[cw], T::OUT_TILES * OUT_TILE);  // rows past M: zeros
#pragma unroll
          for (int cc = 0; cc < T::OUT_TILES; ++cc)
            tma_load_2d(out_s + cc * OUT_TILE, &p.r[at.s], &rfull[cw], at.n0 + cc * 64,
                        at.m0 + cw * 64);
        }
        // the group of k-tile kt-1 has retired: its stage may be refilled
        wgmma_wait<1>();
        fence_acc<BN / 2>(acc);
        if (held >= 0 && lane == 0) mbar_arrive(&empty[held]);
        held = stage;
        if (++stage == T::STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_acc<BN / 2>(acc);
      if (lane == 0) mbar_arrive(&empty[held]);

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
          tma_store_2d(&p.c[at.s], buf, at.n0 + cc * 64, at.m0 + cw * 64);
          asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        }
      }
    }
    // the staging tiles must outlive the stores' reads of them
    if (ctid == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

// The host side of one segment.
struct SegArgs {
  const bf16* a;
  int M, N, col0;
  const bf16* r;
  bf16* c;
};

template <int BN, int EPI>
cudaError_t launch(int K, const bf16* Wt, const bf16* bias, const SegArgs* segs, int nseg,
                   cudaStream_t stream) {
  using T = Tile<BN, EPI>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      gemm_kernel<BN, EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);  // once
  cudaError_t e = attr;
  if (e != cudaSuccess) return e;
  Params p = {};
  p.segs = nseg;
  p.K = K;
  const uint64_t k_bytes[1] = {(uint64_t)K * 2};
  const uint32_t box_a[2] = {BK, BM}, box_w[2] = {BK, BN}, box_c[2] = {64, 64};
  int tiles = 0;
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
    p.seg[s].first = tiles;
    p.seg[s].bias = bias + g.col0;
    tiles += ((g.M + BM - 1) / BM) * p.seg[s].tiles_n;
  }
  p.tiles = tiles;
  const int grid = std::min(tiles, sm_count());
  gemm_kernel<BN, EPI><<<grid, THREADS, T::SMEM, stream>>>(p);
  return cudaGetLastError();
}

template <int BN>
cudaError_t launch_epilogue(int epilogue, int K, const bf16* Wt, const bf16* bias,
                            const SegArgs* segs, int nseg, cudaStream_t s) {
  switch (epilogue) {
    case EPI_NONE: return launch<BN, EPI_NONE>(K, Wt, bias, segs, nseg, s);
    case EPI_GELU: return launch<BN, EPI_GELU>(K, Wt, bias, segs, nseg, s);
    case EPI_RESIDUAL: return launch<BN, EPI_RESIDUAL>(K, Wt, bias, segs, nseg, s);
  }
  return cudaErrorInvalidValue;
}

// The tile width whose last wave ends first: waves x BN / rate(BN), the
// time of one block's tiles, with rate(BN) the width's products per second
// relative to the best width (oadp_torch/profile_kernels.py, H100 at 700 W):
// without a residual at the objects QKV shape 1, 0.87, 0.51 for 256, 128,
// 64 (wider tiles read fewer bytes through L2 per product); with it, at the
// objects out-projection, 0.93, 1, 0.67 (its R staging leaves the 256-wide
// tile three ring stages). Large products take the fastest width, a short
// one (kernel 2's 2048 rows) the width that fills the SMs.
int pick_tile_n(const SegArgs* segs, int nseg, int epilogue) {
  constexpr int widths[3] = {256, 128, 64};
  constexpr double rate[2][3] = {{1.0, 0.87, 0.51}, {0.93, 1.0, 0.67}};
  const double* r = rate[epilogue == EPI_RESIDUAL];
  int best = 256;
  double best_cost = 0.0;
  for (int i = 0; i < 3; ++i) {
    long long tiles = 0;
    for (int s = 0; s < nseg; ++s)
      tiles += (long long)((segs[s].M + BM - 1) / BM) * ((segs[s].N + widths[i] - 1) / widths[i]);
    const double cost = (double)((tiles + sm_count() - 1) / sm_count()) * widths[i] / r[i];
    if (i == 0 || cost < best_cost) {
      best = widths[i];
      best_cost = cost;
    }
  }
  return best;
}

}  // namespace
}  // namespace oadp

extern "C" {

// Shapes are checked by the Python wrapper: K % 64 == 0 (and K <= 1024
// with LN), N % 8 == 0, every pointer 16-byte aligned. Wt (rows, K) is the
// whole K-major weight; segment s reads its rows col0_s .. col0_s + N_s and
// bias[col0_s ..]. The second segment is absent when A1 == nullptr.
// gamma == nullptr means no LayerNorm; otherwise ln_out (M0 + M1, K)
// receives LN of both segments' rows and the product reads it. tile_n: 64,
// 128 or 256, or 0 to pick by shape.
int oadp_ln_gemm(int K, const float* gamma, const float* beta, void* ln_out, const void* Wt,
                 const void* bias, int epilogue, int tile_n, const void* A0, int M0, int N0,
                 int col00, const void* R0, void* C0, const void* A1, int M1, int N1, int col01,
                 const void* R1, void* C1, void* stream) {
  using namespace oadp;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  SegArgs segs[2] = {
      {static_cast<const bf16*>(A0), M0, N0, col00, static_cast<const bf16*>(R0),
       static_cast<bf16*>(C0)},
      {static_cast<const bf16*>(A1), M1, N1, col01, static_cast<const bf16*>(R1),
       static_cast<bf16*>(C1)}};
  const int nseg = A1 != nullptr ? 2 : 1;
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
  switch (tile_n == 0 ? pick_tile_n(segs, nseg, epilogue) : tile_n) {
    case 64: return launch_epilogue<64>(epilogue, K, w, b, segs, nseg, s);
    case 128: return launch_epilogue<128>(epilogue, K, w, b, segs, nseg, s);
    case 256: return launch_epilogue<256>(epilogue, K, w, b, segs, nseg, s);
  }
  return cudaErrorInvalidValue;
}

const char* oadp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
