// greedy_nms: the exact greedy keep sets of P independent score-sorted NMS
// problems, in one launch, with no suppression matrix in device memory.
//
// Replaces the greedy NMS that oadp_tpu runs on its device inside one jitted
// program: oadp_tpu/ops/nms.py:38 (nms, a lax.while_loop over 256-wide
// tiles that exits once max_out boxes are kept) and :187
// (_sorted_block_nms_lazy, the class-parallel tile scan of multiclass_nms
// that recomputes IoU strips from the sorted boxes), each vmapped over a
// batch by its callers (oadp_tpu/models/rpn.py:rpn_proposals,
// models/detector.py:simple_test, dp/test_calibrate.py:rescore). Neither
// is a Pallas kernel.
//
//   problem p: candidates i < n in descending score order, box i =
//   boxes[p * n + i], or, when `order` is given, boxes[s * n + order[p * n
//   + i]] with s = p / group (box set s shared by `group` problems, each
//   reading it in its own order: one image's classes); alive[p * n + i];
//   keep[p * n + i] = 1 iff i is alive, no kept i' < i has IoU(i', i) >
//   thr, and fewer than max_keep candidates before it are kept.
//
// Exactness: keep sets equal the plain version's (ops/nms.py:_pair_iou,
// _greedy_keep) bit for bit. nvcc contracts a * b + c into an FMA unless
// told not to, so the IoU is written with the _rn intrinsics in
// _pair_iou's order: areas as clamp(x1 - x0) * clamp(y1 - y0), inter from
// the clamped max/min overlap, union = (area_a + area_b) - inter clamped at
// 1e-6f, then one IEEE division, compared with the fp32 threshold (torch
// compares an fp32 tensor with a Python float in fp32). inter == 0 gives
// an IoU of 0 with no division. Max, min and the clamps propagate NaN, as
// torch.maximum, torch.minimum and clamp do (fmaxf and fminf return the
// other operand): a box with a NaN coordinate has a NaN IoU with every box,
// which is not > thr, so it suppresses nothing and nothing suppresses it.
// The IoU of a pair is symmetric to the bit, so a column word may hold the
// earlier candidate's suppression of the later one.
//
// Design: the reference's blocked form, lazily, from the front, one
// problem to a cluster of CL blocks (CL = 1: a plain block; the launch's
// plan, ops/nms.py:nms_plan, picks CL, the block's threads and the tile).
// The cluster walks its problem in TILE-candidate tiles and holds what it
// has kept so far, the kept list (at most max_keep boxes), dealt round-
// robin over its blocks: kept candidate g lives in block g % CL, slot
// g / CL, in shared memory (or a workspace past 8,192 slots a block). For
// each tile, with its boxes already in shared memory:
//   (a) every block tests the tile's alive columns against its slice of
//       the kept list, a thread a column and every (THREADS / TILE)-th kept
//       box, until one suppresses it; a warp's hits are OR-ed as one word
//       into the tile's hit words in every block (atom.shared::cluster.or
//       after mapa);
//   (b) block r computes the column words of columns j = r, r + CL, ...:
//       bit i of column j is set iff i < j, both are alive and i
//       suppresses j; it stores them into every block (st.shared::cluster);
//       a block alone (CL = 1) first waits for its hits and skips the
//       columns and rows they remove;
//   then one cluster barrier, split: between its arrive and its wait the
//   next tile's boxes, fetched by cp.async at the tile's start, land;
//   (c) in every block, the first TILE / 32 warps decide the tile from the
//       words, the same way and so alike: passes over the undecided alive
//       columns keep each one that no kept or undecided column before it
//       suppresses and drop each one that a kept one suppresses, until none
//       is undecided (the first undecided is decided in every pass, so
//       passes <= the longest suppression chain + 1; each decision is the
//       serial greedy one, whose keep set is the unique fixpoint of this
//       triangular recurrence); the kept columns past max_keep are cut, and
//       each block appends its share of the kept ones to its slice.
// A block barrier closes the tile; the hit and column words are double-
// buffered by tile parity, so a fast block's next tile cannot overwrite
// words a slow one is still deciding from (it passes the next cluster
// barrier only after the slow block arrives there). Every block computes
// the same end, counts and decisions, so all take the same number of
// cluster barriers. The walk stops after the last alive candidate (read
// here from `alive`) and once max_keep are kept, as the reference's
// outer_cond does (the first max_keep of the greedy set do not depend on
// later candidates).
//
// Bound on the H100: the function reads each box (16 bytes) and alive flag
// once and writes one byte a candidate, and needs the IoU of each kept
// candidate with the alive ones after it, up to the stop (14 fp32
// operations a pair): at the main path's shapes both are microseconds.
// What takes the time is the walk: a problem's tiles are decided one after
// another, each behind two or three barriers. Many problems (multiclass_nms: a
// batch's images x classes) fill the card with small blocks, several to
// an SM; a few long ones (the RPN's, one an image of 5-9k candidates)
// spread each tile's tests against the kept list over a cluster of SMs.
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "common.cuh"

namespace oadp {
namespace {

constexpr int SMEM_KEPT = 8192;  // most kept boxes a block holds in shared memory (160 KB)

// max and min that return NaN when either operand is NaN
__device__ __forceinline__ float nan_max(float a, float b) { return a > b || a != a ? a : b; }
__device__ __forceinline__ float nan_min(float a, float b) { return a < b || a != a ? a : b; }

__device__ __forceinline__ float box_area(float4 b) {
  return __fmul_rn(nan_max(__fsub_rn(b.z, b.x), 0.f), nan_max(__fsub_rn(b.w, b.y), 0.f));
}

// IoU(a, b) > thr, evaluated as ops/nms.py:_pair_iou evaluates it
__device__ __forceinline__ bool suppresses(float4 a, float area_a, float4 b, float area_b,
                                           float thr) {
  const float w = nan_max(__fsub_rn(nan_min(a.z, b.z), nan_max(a.x, b.x)), 0.f);
  const float h = nan_max(__fsub_rn(nan_min(a.w, b.w), nan_max(a.y, b.y)), 0.f);
  const float inter = __fmul_rn(w, h);
  if (inter == 0.f) return 0.f > thr;  // a NaN inter is not 0: it goes on to a NaN IoU
  const float uni = nan_max(__fsub_rn(__fadd_rn(area_a, area_b), inter), 1e-6f);
  return __fdiv_rn(inter, uni) > thr;
}

struct Args {
  int n, group;
  int cap;  // kept-list slots of a block
  const float4* boxes;
  const int64_t* order;
  const uint8_t* alive;
  float thr;
  int max_keep;
  uint8_t* keep;
  float4* kept_ws;
  long long* cycles;
};

// Bit c of a tile's words held in registers (no indexing at run time,
// which would put them in local memory).
template <int NW>
__device__ __forceinline__ bool bit(const uint32_t (&words)[NW], int c) {
  uint32_t w = words[0];
#pragma unroll
  for (int q = 1; q < NW; ++q)
    if (c >> 5 == q) w = words[q];
  return (w >> (c & 31)) & 1;
}

// A word of this tile's words in block `peer` of the cluster (or here):
// stored, or OR-ed in.
template <int CL>
__device__ __forceinline__ void put_word(uint32_t* p, int peer, uint32_t v) {
  if (CL > 1) {
    st_peer_u32(p, peer, v);
  } else {
    *p = v;
  }
}

template <int CL>
__device__ __forceinline__ void or_word(uint32_t* p, int peer, uint32_t v) {
  if (CL > 1) {
    or_peer_u32(p, peer, v);
  } else {
    atomicOr(p, v);
  }
}

// cycles (P, 4), when given: per problem, thread 0 of the cluster's first
// block, clock64() cycles in (a) its tests against the kept list, (b) its
// warp's column words, the barriers before (b) (CL = 1) and (c) (waiting
// for the other warps and blocks), and (c) the decision, the appends and
// the block barrier
template <int THREADS, int CL, int TILE>
__global__ void __launch_bounds__(THREADS) greedy_nms_kernel(const Args a) {
  constexpr int WARPS = THREADS / 32, NW = TILE / 32;
  static_assert(WARPS >= NW && THREADS % TILE == 0 && CL <= 32,
                "a lane a column, in (a) a thread a column; a lane a block");
  extern __shared__ float4 kept_smem[];  // the block's slice of the kept list: boxes, then areas
  __shared__ float4 s_box[2][TILE];
  __shared__ uint32_t s_col[2][TILE][NW];  // column j, word q: bit i set iff 32q + i suppresses j
  __shared__ uint32_t s_live[2][NW], s_hit[2][NW];
  __shared__ int s_end, s_count;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rank = CL > 1 ? cluster_rank() : 0;
  const int n = a.n;
  const int p = blockIdx.x / CL;
  const int64_t off = int64_t(p) * n;
  const float4* set = a.boxes + (a.order != nullptr ? int64_t(p / a.group) * n : off);
  const int64_t* order = a.order != nullptr ? a.order + off : nullptr;
  const uint8_t* alive = a.alive + off;
  // cap is a multiple of 4, so every block's slice starts 16-byte aligned
  float4* kbox = a.kept_ws != nullptr ? a.kept_ws + int64_t(blockIdx.x) * (a.cap + a.cap / 4)
                                      : kept_smem;
  float* karea = reinterpret_cast<float*>(kbox + a.cap);
  const bool timed = a.cycles != nullptr && rank == 0 && tid == 0;
  long long c_a = 0, c_b = 0, c_bar = 0, c_c = 0;

  // thread tid < TILE: where candidate base + tid's box is in its set (-1
  // past n), read a tile before the fetch that needs it, so that no warp
  // waits for it
  auto place = [&](int base) -> int64_t {
    const int i = base + tid;
    return tid < TILE && i < n ? (order != nullptr ? order[i] : i) : -1;
  };
  // the box into s_box[buf] by cp.async, and its alive flag
  auto fetch = [&](int64_t at, int base, int buf) -> bool {
    if (at < 0) return false;
    cp_async16(&s_box[buf][tid], set + at);
    return alive[base + tid] != 0;
  };
  // after the fetch has landed: the tile's alive words
  auto publish = [&](bool live, int buf) {
    const uint32_t word = __ballot_sync(~0u, live);
    if (warp < NW && lane == 0) s_live[buf][warp] = word;
  };

  if (tid == 0) {
    s_end = 0;
    s_count = 0;
  }
  if (tid < 2 * NW) (&s_hit[0][0])[tid] = 0;
  __syncthreads();
  // the walk ends after the last alive candidate
  for (int q = warp; q * 32 < n; q += WARPS) {
    const int j = q * 32 + lane;
    const uint32_t live = __ballot_sync(~0u, j < n && alive[j] != 0);
    if (lane == 0 && live) atomicMax(&s_end, q * 32 + 32 - __clz(live));
  }
  bool next = fetch(place(0), 0, 0);
  int64_t ahead = place(TILE);
  cp_async_wait_all();
  publish(next, 0);
  // every block of the cluster has started (its shared memory may be
  // written) and holds the first tile
  if (CL > 1) {
    cluster_sync();
  } else {
    __syncthreads();
  }
  const int end = s_end;

  int count = 0, base = 0;
  for (int t = 0; base < end && count < a.max_keep; base += TILE, ++t) {
    const int buf = t & 1;
    const long long t0 = clock64();
    // the words of two tiles back, read by every warp before the block
    // barrier that closed the last tile, take this tile's successor's hits
    if (tid < NW) s_hit[buf ^ 1][tid] = 0;
    next = base + TILE < end && fetch(ahead, base + TILE, buf ^ 1);
    ahead = place(base + 2 * TILE);
    uint32_t live[NW];
#pragma unroll
    for (int q = 0; q < NW; ++q) live[q] = s_live[buf][q];
    const int kn = count;
    // (a) the alive columns against this block's slice of the kept list:
    // kept candidates g = rank, rank + CL, ... of the kn
    const int mine = kn > rank ? (kn - rank + CL - 1) / CL : 0;
    {
      // a thread a column and every (THREADS / TILE)-th kept box, until one
      // suppresses it; a warp's 32 columns' hits OR-ed as one word
      const int c = tid % TILE;
      bool hit = false;
      if (bit(live, c)) {
        const float4 b = s_box[buf][c];
        const float ab = box_area(b);
        for (int r = tid / TILE; r < mine && !hit; r += THREADS / TILE)
          hit = suppresses(kbox[r], karea[r], b, ab, a.thr);
      }
      const uint32_t word = __ballot_sync(~0u, hit);
      if (word != 0 && lane < CL) or_word<CL>(&s_hit[buf][c >> 5], lane, word);
    }
    const long long t1 = clock64();
    if constexpr (CL == 1) {
      // a block alone knows the hits now: (b) skips the columns and rows
      // the kept list suppressed (most of them where boxes cluster)
      __syncthreads();
#pragma unroll
      for (int q = 0; q < NW; ++q) live[q] &= ~s_hit[buf][q];
    }
    const long long t1b = clock64();
    // (b) this block's columns' words, into every block
    for (int j = rank + warp * CL; j < TILE; j += WARPS * CL) {
      if (!bit(live, j)) continue;
      const float4 bj = s_box[buf][j];
      const float aj = box_area(bj);
#pragma unroll
      for (int q = 0; q < NW; ++q) {
        const int i = q * 32 + lane;
        bool sup = false;
        if (i < j && ((live[q] >> lane) & 1)) {
          const float4 bi = s_box[buf][i];
          sup = suppresses(bi, box_area(bi), bj, aj, a.thr);
        }
        const uint32_t word = __ballot_sync(~0u, sup);
        if (lane < CL) put_word<CL>(&s_col[buf][j][q], lane, word);
      }
    }
    const long long t2 = clock64();
    // every block's hits and words are in; the next tile lands meanwhile
    if (CL > 1) cluster_arrive();
    cp_async_wait_all();
    if (CL > 1) {
      cluster_wait();
    } else {
      __syncthreads();
    }
    const long long t3 = clock64();
    // (c) the tile's decision, alike in the first NW warps of every block:
    // lane l holds columns l, l + 32, ...
    if (warp < NW) {
      uint32_t col[NW][NW], und[NW], kept[NW];
#pragma unroll
      for (int k = 0; k < NW; ++k) {
        und[k] = live[k] & ~s_hit[buf][k];
        kept[k] = 0;
#pragma unroll
        for (int q = 0; q < NW; ++q) col[k][q] = s_col[buf][k * 32 + lane][q];
      }
      for (;;) {
        uint32_t left = 0;
#pragma unroll
        for (int k = 0; k < NW; ++k) left |= und[k];
        if (left == 0) break;
        uint32_t kb[NW], db[NW];
#pragma unroll
        for (int k = 0; k < NW; ++k) {
          bool by_kept = false, by_und = false;
#pragma unroll
          for (int q = 0; q < NW; ++q) {
            by_kept |= (col[k][q] & kept[q]) != 0;
            by_und |= (col[k][q] & und[q]) != 0;
          }
          const bool u = (und[k] >> lane) & 1;
          kb[k] = __ballot_sync(~0u, u && !by_kept && !by_und);
          db[k] = __ballot_sync(~0u, u && by_kept);
        }
#pragma unroll
        for (int k = 0; k < NW; ++k) {
          kept[k] |= kb[k];
          und[k] &= ~(kb[k] | db[k]);
        }
      }
      // the first max_keep - kn of them; this warp's columns, the kept
      // ones before them
      int room = a.max_keep - kn, before = 0, total = 0;
      uint32_t own = 0;
#pragma unroll
      for (int k = 0; k < NW; ++k) {
        while (__popc(kept[k]) > room) kept[k] &= ~(0x80000000u >> __clz(kept[k]));
        room -= __popc(kept[k]);
        if (k < warp) before += __popc(kept[k]);
        if (k == warp) own = kept[k];
        total += __popc(kept[k]);
      }
      const bool is_kept = (own >> lane) & 1;
      const int g = kn + before + __popc(own & ((1u << lane) - 1));
      if (is_kept && g % CL == rank) {
        const float4 b = s_box[buf][tid];
        kbox[g / CL] = b;
        karea[g / CL] = box_area(b);
      }
      if (rank == 0 && base + tid < n) a.keep[off + base + tid] = is_kept;
      if (tid == 0) s_count = kn + total;
    }
    publish(next, buf ^ 1);
    __syncthreads();  // the slice, the count and the next tile
    count = s_count;
    if (timed) {
      c_a += t1 - t0;
      c_b += t2 - t1b;
      c_bar += (t1b - t1) + (t3 - t2);
      c_c += clock64() - t3;
    }
  }
  cp_async_wait_all();  // a fetch of a tile the walk did not reach
  for (int j = base + rank * THREADS + tid; j < n; j += CL * THREADS) a.keep[off + j] = 0;
  if (timed) {
    long long* c = a.cycles + 4 * int64_t(p);
    c[0] = c_a;
    c[1] = c_b;
    c[2] = c_bar;
    c[3] = c_c;
  }
}

template <int THREADS, int CL, int TILE>
cudaError_t launch(const Args& a, int P, cudaStream_t stream) {
  const auto kernel = greedy_nms_kernel<THREADS, CL, TILE>;
  const size_t smem = a.kept_ws != nullptr ? 0 : size_t(a.cap) * 20;
  cudaError_t e;
  if (smem > 48 * 1024 &&
      (e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                int(smem))) != cudaSuccess)
    return e;
  if constexpr (CL == 1) {
    kernel<<<P, THREADS, smem, stream>>>(a);
  } else {
    if constexpr (CL > 8) {
      static const cudaError_t allowed =  // once
          cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (allowed != cudaSuccess) return allowed;
    }
    cudaLaunchAttribute cluster[1];
    cluster[0].id = cudaLaunchAttributeClusterDimension;
    cluster[0].val.clusterDim.x = CL;
    cluster[0].val.clusterDim.y = 1;
    cluster[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(P * CL);
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cfg.attrs = cluster;
    cfg.numAttrs = 1;
    if ((e = cudaLaunchKernelEx(&cfg, kernel, a)) != cudaSuccess) return e;
  }
  return cudaGetLastError();
}

// The plans ops/nms.py:NMS_PLANS lists: a block a problem of 128 or 256
// threads on tiles of 64, or of 1024 threads on tiles of 128, alone or in
// clusters of 2-16. Measured both ways (profile_kernels.py --only nms, an
// H100): tiles of 128 ran 5-30% faster than tiles of 64 on clusters, and
// 5-8% on one block of 1024 threads at OV-COCO's and OV-LVIS's shapes (2%
// slower at the RPN's); tiles of 64 3-10% faster on blocks of 128 threads
// at a batch's many problems.
cudaError_t launch_plan(const Args& a, int P, int cluster, int threads, int tile,
                        cudaStream_t s) {
  if (cluster == 1 && tile == 64) {
    if (threads == 128) return launch<128, 1, 64>(a, P, s);
    if (threads == 256) return launch<256, 1, 64>(a, P, s);
  } else if (threads == 1024 && tile == 128) {
    switch (cluster) {
      case 1: return launch<1024, 1, 128>(a, P, s);
      case 2: return launch<1024, 2, 128>(a, P, s);
      case 4: return launch<1024, 4, 128>(a, P, s);
      case 8: return launch<1024, 8, 128>(a, P, s);
      case 16: return launch<1024, 16, 128>(a, P, s);
    }
  }
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace oadp

extern "C" {

// Checked by the Python wrapper (oadp_torch/ops/nms.py): fp32 boxes
// 16-byte aligned, (P * n, 4) or, with order (P, n) int64, (P / group * n,
// 4); alive and keep (P, n) bool; the plan, one of launch_plan's; a block's cap =
// ceil(min(max_keep, n) / cluster) rounded up to a multiple of 4; kept_ws,
// P x cluster x cap x 20 bytes 16-byte aligned, given iff cap > 8192 (the
// kept list past shared memory), else null; cycles (P, 4) int64 or null.
int oadp_greedy_nms(int P, int n, int group, const void* boxes, const void* order,
                    const void* alive, float thr, int max_keep, int cluster, int threads,
                    int tile, void* keep, void* kept_ws, void* cycles, void* stream) {
  using namespace oadp;
  if (P <= 0 || n <= 0) return cudaSuccess;
  if (order != nullptr && (group <= 0 || P % group != 0)) return cudaErrorInvalidValue;
  if (cluster <= 0) return cudaErrorInvalidValue;
  const int kept = std::max(0, std::min(max_keep, n));
  const int cap = ((kept + cluster - 1) / cluster + 3) / 4 * 4;
  if ((kept_ws != nullptr) != (cap > SMEM_KEPT)) return cudaErrorInvalidValue;
  Args a;
  a.n = n;
  a.group = order != nullptr ? group : 1;
  a.cap = cap;
  a.boxes = static_cast<const float4*>(boxes);
  a.order = static_cast<const int64_t*>(order);
  a.alive = static_cast<const uint8_t*>(alive);
  a.thr = thr;
  a.max_keep = max_keep;
  a.keep = static_cast<uint8_t*>(keep);
  a.kept_ws = static_cast<float4*>(kept_ws);
  a.cycles = static_cast<long long*>(cycles);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return launch_plan(a, P, cluster, threads, tile, s);
}

}  // extern "C"
