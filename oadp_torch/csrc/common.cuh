// Shared helpers of the hand-written Hopper kernels (sm_90a).
//
// The kernels take bf16 activations and weights, accumulate in fp32 on the
// tensor cores (wgmma in ln_gemm.cu and ln_qkv_attention.cu, mma.sync
// m16n8k16 fed by ldmatrix in attention.cu), load their tiles with TMA into
// 128-byte-swizzled shared memory, and are bound to PyTorch through a plain
// C interface loaded with ctypes (oadp_torch/ops/cuda_lib.py). Every entry
// point launches on the caller's stream, allocates nothing, and returns a
// cudaError_t so the Python wrapper can raise.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace oadp {

using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------------------
// Host: TMA tensor maps and launch settings
// ---------------------------------------------------------------------------

// A bf16 tensor map over `rank` (2 or 3) dimensions, innermost first:
// dims[i] elements, strides[i] bytes between consecutive indices of
// dimension i + 1, a box of box[i] elements, 128-byte swizzle (box[0] must
// be 64 bf16), zeros for elements outside the tensor. Returns the driver's
// error as a cudaError_t (cudaErrorInvalidValue for any refusal).
inline cudaError_t make_tmap(CUtensorMap* map, const void* base, int rank, const uint64_t* dims,
                             const uint64_t* strides, const uint32_t* box) {
  const uint32_t ones[3] = {1, 1, 1};
  const CUresult r = cuTensorMapEncodeTiled(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base), dims, strides, box,
      ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Multiprocessors of the current device, read once.
inline int sm_count() {
  static const int n = [] {
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    return sms > 0 ? sms : 1;
  }();
  return n;
}

// ---------------------------------------------------------------------------
// Device: mbarriers, TMA, fences
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// Make the initialised barriers visible to the async proxy (TMA).
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Spin until the phase of parity `parity` has completed. Real waits last
// microseconds; one that spins 2^20 times (seconds: a failed try_wait
// suspends for microseconds) is a fault, and the kernel traps (the launch
// fails) instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  for (uint32_t spins = 0; !done; ++spins) {
    if (spins == (1u << 20)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Arrive and add `bytes` to the transactions the current phase waits for.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// TMA tile loads; coordinates innermost first, completion on `bar`.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// TMA tile store from shared memory, tracked by the bulk async-group of
// the issuing thread.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, const void* src, int c0,
                                             int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1)
      : "memory");
}

// Asynchronous global -> shared copies of 16 or 4 bytes (L2 only, or
// through L1 for 4), and an arrive on `bar` once all of this thread's
// earlier copies have landed (the barrier's count must include it).
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// Order this thread's generic-proxy shared-memory accesses before later
// async-proxy (TMA) writes to the same bytes.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Clusters: a barrier over every thread of the cluster's blocks (whole,
// or split into its arrive and its wait, the wait acquiring what the
// other blocks wrote before their arrive), this block's rank in the
// cluster, an arrive on the mbarrier at `bar`'s offset in block `peer`,
// and a store or an OR of a 32-bit word at `p`'s offset in block `peer`'s
// shared memory (mapa: the same offset in the peer's window).
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return static_cast<int>(r);
}

__device__ __forceinline__ void mbar_arrive_peer(uint64_t* bar, int peer) {
  asm volatile(
      "{\n"
      ".reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [remote];\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(peer)
      : "memory");
}

__device__ __forceinline__ void st_peer_u32(const void* p, int peer, uint32_t v) {
  asm volatile(
      "{\n"
      ".reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "st.shared::cluster.u32 [remote], %2;\n"
      "}\n" ::"r"(smem_u32(p)),
      "r"(peer), "r"(v)
      : "memory");
}

__device__ __forceinline__ void or_peer_u32(const void* p, int peer, uint32_t v) {
  uint32_t old;
  asm volatile(
      "{\n"
      ".reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %1, %2;\n"
      "atom.shared::cluster.or.b32 %0, [remote], %3;\n"
      "}\n"
      : "=r"(old)
      : "r"(smem_u32(p)), "r"(peer), "r"(v)
      : "memory");
}

// Wait until every cp.async of this thread has landed in shared memory.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Barrier `id` (1..15; 0 is __syncthreads) over `threads` threads.
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Byte offset of 16-byte chunk `chunk` of row `row` in a tile of 128-byte
// rows written by TMA with the 128-byte swizzle (tile 1024-byte aligned).
__device__ __forceinline__ int swz(int row, int chunk) {
  return row * 128 + ((chunk ^ (row & 7)) << 4);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// 8 bf16 values travel as one 16-byte word.
__device__ __forceinline__ void unpack8(const uint4& w, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&w);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 p = __bfloat1622float2(h[i]);
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float* f) {
  uint4 w;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&w);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return w;
}

// Four 8x8 b16 matrices from shared memory (a smem_u32 address); lane l
// gives the address of row (l % 8) of matrix (l / 8).
__device__ __forceinline__ void ldmatrix_x4(unsigned* r, uint32_t s) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s)
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned* r, uint32_t s) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s)
               : "memory");
}

// A lane's ldmatrix offsets into a swizzled K or V tile of one 64-wide
// head (attention.cu, long_attention.cu) for a chunk that starts at a
// multiple of 16 rows: the swizzle term (row & 7) is then the lane's own,
// so a chunk only adds k0 * 128 (the offsets are computed once).
struct Frag {
  uint32_t k[4];  // K, k-step ks: rows (lane & 7) + 8 (lane >> 4), low/high 8 dims
  uint32_t v[4];  // V transposed, dims 16 dp..: rows lane & 15
};

__device__ __forceinline__ Frag frag_offsets(int lane) {
  Frag f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f.k[i] = swz((lane & 7) + ((lane >> 4) << 3), i * 2 + ((lane >> 3) & 1));
    f.v[i] = swz(lane & 15, i * 2 + (lane >> 4));
  }
  return f;
}

// c (16x8 fp32) += a (16x16 bf16, row) * b (16x8 bf16, col). Fragment
// layout, with g = lane / 4 and t = lane % 4: c[0..1] = row g, columns
// 2t and 2t+1; c[2..3] = row g + 8, the same columns.
__device__ __forceinline__ void mma_bf16(float* c, const unsigned* a, unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x on the special-function unit, subnormal results flushed to zero.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two floats as one bf16x2 register, the first in the low half.
__device__ __forceinline__ unsigned pack2(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&h);
}

// ---------------------------------------------------------------------------
// The LN pass and wgmma, shared by ln_gemm.cu and ln_qkv_attention.cu
// ---------------------------------------------------------------------------

namespace {  // each kernel file has its own copy of the LN pass

// One warp per row: LayerNorm of the rows of a0 (M0 rows), then of a1 (M1
// rows), each (rows, K) bf16, with fp32 statistics (two passes over the row
// held in registers, eps 1e-5), written as bf16 rows to out (M0 + M1, K) --
// the rounding the Pallas kernels apply before their products.
// K <= 32 * 8 * LN_CHUNKS, so each row is read from memory once.
constexpr int LN_CHUNKS = 4;

__global__ void layer_norm_kernel(const bf16* __restrict__ a0, int M0, const bf16* __restrict__ a1,
                                  int M1, int K, const float* __restrict__ gamma,
                                  const float* __restrict__ beta, bf16* __restrict__ out) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= M0 + M1) return;
  const uint4* p = reinterpret_cast<const uint4*>(
      row < M0 ? a0 + (size_t)row * K : a1 + (size_t)(row - M0) * K);
  uint4* q = reinterpret_cast<uint4*>(out + (size_t)row * K);
  const int chunks = K / 8;
  float f[LN_CHUNKS][8];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < LN_CHUNKS; ++i) {
    const int c = lane + 32 * i;
    if (c < chunks) {
      unpack8(p[c], f[i]);
#pragma unroll
      for (int j = 0; j < 8; ++j) s += f[i][j];
    }
  }
  const float mean = warp_sum(s) / K;
  float v = 0.f;
#pragma unroll
  for (int i = 0; i < LN_CHUNKS; ++i) {
    if (lane + 32 * i < chunks) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float d = f[i][j] - mean;
        v += d * d;
      }
    }
  }
  const float rstd = rsqrtf(warp_sum(v) / K + 1e-5f);
#pragma unroll
  for (int i = 0; i < LN_CHUNKS; ++i) {
    const int c = lane + 32 * i;
    if (c < chunks) {
      const float4* g4 = reinterpret_cast<const float4*>(gamma + c * 8);
      const float4* b4 = reinterpret_cast<const float4*>(beta + c * 8);
      const float4 g0 = g4[0], g1 = g4[1], b0 = b4[0], b1 = b4[1];
      const float g[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int j = 0; j < 8; ++j) f[i][j] = (f[i][j] - mean) * rstd * g[j] + b[j];
      q[c] = pack8(f[i]);
    }
  }
}

// Shared-memory matrix descriptor of wgmma: start address, SBO 1024 bytes
// (eight 128-byte rows), 128-byte swizzle (the leading offset is unused
// for swizzled K-major tiles).
__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  const uint32_t addr = smem_u32(p);
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N committed wgmma groups of this warpgroup are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving accesses of accumulators across the
// asynchronous wgmma that writes them.
template <int R>
__device__ __forceinline__ void fence_acc(float* d) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 64 fp32 per warpgroup) += A (64 x 16, shared) * B, A K-major; B
// (64 x 16, shared)^T K-major, or with TRANS_B (16 x 64) MN-major: 16 rows
// of 64 contiguous values, two 8-row swizzle atoms 1024 bytes apart (the
// descriptor's SBO); both with the 128-byte swizzle.
template <int TRANS_B = 0>
__device__ __forceinline__ void wgmma_m64n64k16(float* d, uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, %35;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(1), "n"(TRANS_B));
}

}  // namespace

}  // namespace oadp
