// greedy_nms: the exact greedy keep sets of P independent score-sorted NMS
// problems, in one launch, with no suppression matrix in device memory.
//
// Replaces the greedy NMS that oadp_tpu runs on its device inside one jitted
// program: oadp_tpu/ops/nms.py:38 (nms, a lax.while_loop over 256-wide
// tiles that exits once max_out boxes are kept) and :187
// (_sorted_block_nms_lazy, the class-parallel tile scan of multiclass_nms
// that recomputes IoU strips from the sorted boxes). Neither is a Pallas
// kernel; the port's torch form of them built the bool suppression matrix
// and read one flag back to the host per greedy pass (ops/nms.py).
//
//   problem p (one block): candidates i < n in descending score order, box
//   i = boxes[p * n + i] (or boxes[order[p * n + i]] when `order` is given:
//   one shared box set read in each problem's own order), alive[p * n + i];
//   keep[p * n + i] = 1 iff i is alive, no kept i' < i has IoU(i', i) > thr,
//   and fewer than max_keep candidates before it are kept.
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
//
// Design: the reference's blocked form, lazily, from the front. A block
// walks its problem in 64-candidate tiles and keeps the boxes of what it
// has kept so far (the kept list: at most max_keep, in shared memory, or
// in a workspace past 8,192). For each tile: (a) each warp takes a column
// of the tile and its lanes test the kept list 32 boxes at a time, until
// one suppresses it; (b) the warps compute the tile's 64 x 64 upper-
// triangle IoU bits as 64-bit words (two ballots a row), for rows still
// available; (c) one thread decides the tile serially from those words in
// registers (find the next available row, keep it, clear what it
// suppresses), and the kept rows join the kept list. The walk stops after
// the last alive candidate (read here from `alive`) and once max_keep are
// kept, as the reference's outer_cond does (the first max_keep of the
// greedy set do not depend on later candidates); a candidate past the
// stop costs nothing, so the IoUs computed are those of the candidates
// reached against the kept ones before them, each column stopping at its
// first suppressor.
//
// Bound on the H100: the function reads each box (16 bytes) and alive flag
// once and writes one byte a candidate, and needs the IoU of each kept
// candidate with the alive ones after it, up to the stop (14 fp32
// operations a pair): at the main path's shapes both are microseconds.
// The walk over the tiles is serial within a problem (five block barriers
// and one thread's decisions a tile), so a single problem (the RPN's
// 8,819 candidates) runs on one SM; many problems (multiclass_nms: one a
// class) fill the card.
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace oadp {
namespace {

constexpr int TILE = 64;
constexpr int SMEM_KEPT = 8192;  // most kept boxes held in shared memory (160 KB)

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

__device__ __forceinline__ float4 load_box(const float4* __restrict__ boxes,
                                           const int64_t* __restrict__ order, int64_t off,
                                           int i) {
  return __ldg(boxes + (order != nullptr ? order[off + i] : off + i));
}

// cycles (P, 3), when given: per problem, thread 0's clock64() cycles in
// the tiles' tests against the kept list (a), IoU words (b) and serial
// decisions (c)
template <int THREADS>
__global__ void __launch_bounds__(THREADS)
    greedy_nms_kernel(int n, int cap, const float4* __restrict__ boxes,
                      const int64_t* __restrict__ order, const uint8_t* __restrict__ alive,
                      float thr, int max_keep, uint8_t* __restrict__ keep, float4* kept_ws,
                      long long* __restrict__ cycles) {
  constexpr int WARPS = THREADS / 32;
  extern __shared__ float4 kept_smem[];  // the kept list: cap boxes, then cap areas
  __shared__ float4 s_box[TILE];
  __shared__ float s_area[TILE];
  __shared__ uint64_t s_diag[TILE];
  __shared__ uint64_t s_kept;
  __shared__ uint32_t s_live[2], s_hit[2];
  __shared__ int s_end, s_count;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t off = int64_t(blockIdx.x) * n;
  // cap is a multiple of 4, so every problem's boxes start 16-byte aligned
  float4* kbox = kept_ws != nullptr ? kept_ws + int64_t(blockIdx.x) * (cap + cap / 4) : kept_smem;
  float* karea = reinterpret_cast<float*>(kbox + cap);
  long long t_kept = 0, t_diag = 0, t_decide = 0;

  if (tid == 0) {
    s_end = 0;
    s_count = 0;
  }
  __syncthreads();
  // the walk ends after the last alive candidate
  for (int q = warp; q * 32 < n; q += WARPS) {
    const int j = q * 32 + lane;
    const uint32_t live = __ballot_sync(~0u, j < n && alive[off + j] != 0);
    if (lane == 0 && live) atomicMax(&s_end, q * 32 + 32 - __clz(live));
  }
  __syncthreads();
  const int end = s_end;

  int base = 0;
  for (; base < end && s_count < max_keep; base += TILE) {
    const long long t0 = clock64();
    if (tid < TILE) {
      const int i = base + tid;
      const bool in = i < n;
      const float4 b = in ? load_box(boxes, order, off, i) : make_float4(0.f, 0.f, 0.f, 0.f);
      s_box[tid] = b;
      s_area[tid] = box_area(b);
      const uint32_t live = __ballot_sync(~0u, in && alive[off + i] != 0);
      if (lane == 0) {
        s_live[warp] = live;
        s_hit[warp] = 0;
      }
    }
    __syncthreads();
    // (a) the tile's alive columns against the kept list, a warp a column
    const int kn = s_count;
    for (int c = warp; c < TILE; c += WARPS) {
      if (!((s_live[c >> 5] >> (c & 31)) & 1)) continue;
      const float4 b = s_box[c];
      const float ab = s_area[c];
      bool hit = false;
      for (int r0 = 0; r0 < kn && !hit; r0 += 32) {
        const int r = r0 + lane;
        hit = __any_sync(~0u, r < kn && suppresses(kbox[r], karea[r], b, ab, thr));
      }
      if (lane == 0 && hit) atomicOr(&s_hit[c >> 5], 1u << (c & 31));
    }
    __syncthreads();
    const long long t1 = clock64();
    const uint64_t rem = ~(s_live[0] | (uint64_t(s_live[1]) << 32)) |
                         (s_hit[0] | (uint64_t(s_hit[1]) << 32));
    // (b) the tile's upper-triangle IoU words, for rows still available
    for (int i = warp; i < TILE; i += WARPS) {
      uint64_t word = 0;
      if (!((rem >> i) & 1)) {
        const float4 a = s_box[i];
        const float aa = s_area[i];
        const bool lo = lane > i && suppresses(a, aa, s_box[lane], s_area[lane], thr);
        const bool hi = lane + 32 > i &&
                        suppresses(a, aa, s_box[lane + 32], s_area[lane + 32], thr);
        word = __ballot_sync(~0u, lo) | (uint64_t(__ballot_sync(~0u, hi)) << 32);
      }
      if (lane == 0) s_diag[i] = word;
    }
    __syncthreads();
    const long long t2 = clock64();
    // (c) one thread decides the tile: keep the first available row, drop
    // what it suppresses, repeat
    if (tid == 0) {
      uint64_t todo = ~rem, kept = 0;
      int count = kn;
      while (todo != 0 && count < max_keep) {
        const int i = __ffsll(static_cast<long long>(todo)) - 1;
        kept |= 1ull << i;
        ++count;
        todo &= ~s_diag[i];  // bits after i only
        todo &= todo - 1;    // and i itself
      }
      s_kept = kept;
      s_count = count;
    }
    __syncthreads();
    // the tile's keep flags; its kept rows join the kept list in order
    const uint64_t kept = s_kept;
    if (tid < TILE) {
      if (base + tid < n) keep[off + base + tid] = (kept >> tid) & 1;
      if ((kept >> tid) & 1) {
        const int slot = kn + __popcll(kept & ((1ull << tid) - 1));
        kbox[slot] = s_box[tid];
        karea[slot] = s_area[tid];
      }
    }
    __syncthreads();
    if (cycles != nullptr) {
      t_kept += t1 - t0;
      t_diag += t2 - t1;
      t_decide += clock64() - t2;
    }
  }
  for (int j = base + tid; j < n; j += THREADS) keep[off + j] = 0;
  if (cycles != nullptr && tid == 0) {
    cycles[3 * blockIdx.x] = t_kept;
    cycles[3 * blockIdx.x + 1] = t_diag;
    cycles[3 * blockIdx.x + 2] = t_decide;
  }
}

template <int THREADS>
cudaError_t launch(int P, int n, int cap, const void* boxes, const void* order,
                   const void* alive, float thr, int max_keep, void* keep, void* kept_ws,
                   void* cycles, cudaStream_t stream) {
  const size_t smem = kept_ws != nullptr ? 0 : size_t(cap) * 20;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        greedy_nms_kernel<THREADS>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return e;
  }
  greedy_nms_kernel<THREADS><<<P, THREADS, smem, stream>>>(
      n, cap, static_cast<const float4*>(boxes), static_cast<const int64_t*>(order),
      static_cast<const uint8_t*>(alive), thr, max_keep, static_cast<uint8_t*>(keep),
      static_cast<float4*>(kept_ws), static_cast<long long*>(cycles));
  return cudaGetLastError();
}

}  // namespace
}  // namespace oadp

extern "C" {

// Checked by the Python wrapper (oadp_torch/ops/nms.py): fp32 boxes
// 16-byte aligned, (P * n, 4) or, with order (P, n) int64, (n, 4); alive
// and keep (P, n) bool; cap = min(max_keep, n) rounded up to a multiple of
// 4; kept_ws, P x cap x 20 bytes 16-byte aligned, given iff cap > 8192 (the
// kept list past shared memory), else null.
int oadp_greedy_nms(int P, int n, const void* boxes, const void* order, const void* alive,
                    float thr, int max_keep, void* keep, void* kept_ws, void* cycles,
                    void* stream) {
  using namespace oadp;
  if (P <= 0 || n <= 0) return cudaSuccess;
  const int cap = (std::max(0, std::min(max_keep, n)) + 3) / 4 * 4;
  if ((kept_ws != nullptr) != (cap > SMEM_KEPT)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // a few thousand candidates give 1024 threads columns to share; short
  // problems come many to a launch, so smaller blocks fill the SMs
  return n > 2048
             ? launch<1024>(P, n, cap, boxes, order, alive, thr, max_keep, keep, kept_ws, cycles, s)
             : launch<256>(P, n, cap, boxes, order, alive, thr, max_keep, keep, kept_ws, cycles, s);
}

}  // extern "C"
