// ln_gemm: C = epilogue(LN?(A) @ W + bias), bf16 in and out, fp32 accumulate.
//
// One of the two kernel families behind the three ported Pallas kernels
// (oadp_tpu/ops/attention.py): it carries every product those kernels do
// outside the per-head attention -- the QKV projection after LayerNorm
// (_surgery_layer_kernel, _ln_qkv_attn_kernel), the folded out-projection
// with its residual add (_surgery_layer_kernel with out_w), and both halves
// of the row MLP (_row_mlp_kernel).
//
//   A (M, K) row-major, Wt (N, K) the weight transposed (the wrapper
//   transposes the (K, N) slice it is given, a few MB a call), bias (N,),
//   optional residual R (M, N), C (M, N).
//   LN:        A row -> (a - mean) * rstd * gamma + beta in fp32, rounded to
//              bf16 before the product (eps 1e-5; the Pallas kernels round the
//              LN output to the activation type the same way).
//   epilogue:  0 none, 1 quick_gelu x*sigmoid(1.702x), 2 residual R + x.
//
// Bound on the H100: the QKV GEMM of the objects encoder (M = 2048 x 197,
// K = 768, N = 2304) is 1.43 TFLOP against 0.62 GB of A, far above the
// card's ~295 FLOP/byte ridge, so it is bound by tensor-core operations.
// Design: Hopper's warpgroup MMA. 128x128x64 block tiles, two warpgroups
// of 64 rows each issuing wgmma m64n128k16 straight from shared memory
// (128-byte swizzled tiles; the no-swizzle core-matrix layout ran about a
// third as fast), and a 3-stage cp.async ring (96 KB, two blocks an SM)
// so two k-tiles load while one is multiplied. Keeping a wgmma group in
// flight across iterations needs a 4th stage, and with it one block an
// SM, which ran slower. The LN prologue is a one-warp-a-row pass that
// writes LN(A) in bf16 (for the objects QKV: 0.62 GB written and read
// again, ~0.4 ms at 3.35 TB/s); normalising each tile in shared memory
// instead ran slower, because it sat on every k-tile's critical path
// behind an extra barrier. The grid walks the N tiles fastest so the
// blocks that read one A row-panel run together and A streams from device
// memory about once. Rates against cuBLAS: oadp_torch/profile_kernels.py.
// Not yet done: TMA loads, a producer warp and a persistent schedule.
#include "common.cuh"

namespace oadp {
namespace {

constexpr int BM = 128, BN = 128, BK = 64, STAGES = 3;
constexpr int THREADS = 256;  // two warpgroups, 64 rows each
// A k-tile of R rows is stored K-major with the 128-byte swizzle: row r
// (64 bf16 = 128 bytes) at byte r * 128, its 16-byte chunk c at chunk
// slot c ^ (r % 8). Eight rows form one 1024-byte swizzle atom (SBO).
constexpr int TILE_A = BM * BK;  // elements
constexpr int TILE_B = BN * BK;
constexpr int SMEM_BYTES = STAGES * (TILE_A + TILE_B) * (int)sizeof(bf16);

enum Epilogue { EPI_NONE = 0, EPI_GELU = 1, EPI_RESIDUAL = 2 };

// One warp per row: LayerNorm of a (M, K) bf16 matrix with fp32 statistics
// (two passes over the row held in registers, eps 1e-5), written back as
// bf16 rows -- the rounding the Pallas kernels apply before their products.
// K <= 32 * 8 * LN_CHUNKS, so each row is read from memory once.
constexpr int LN_CHUNKS = 4;

__global__ void layer_norm_kernel(const bf16* __restrict__ a, int M, int K,
                                  const float* __restrict__ gamma,
                                  const float* __restrict__ beta, bf16* __restrict__ out) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= M) return;
  const uint4* p = reinterpret_cast<const uint4*>(a + (size_t)row * K);
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
#pragma unroll
      for (int j = 0; j < 8; ++j)
        f[i][j] = (f[i][j] - mean) * rstd * gamma[c * 8 + j] + beta[c * 8 + j];
      q[c] = pack8(f[i]);
    }
  }
}

// d (64x128 fp32 per warpgroup) += A (64x16, shared, K-major) * B (128x16,
// shared, K-major)^T. Warp w of the warpgroup holds rows 16w..16w+15 in the
// mma.sync C layout, repeated for each of the 16 column groups of 8.
__device__ __forceinline__ void wgmma_m64n128k16(float* d, uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n"
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

// Shared-memory matrix descriptor: start address, SBO 1024 B, 128-byte
// swizzle (the leading offset is unused for swizzled K-major tiles).
__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

template <int EPI>
__global__ void __launch_bounds__(THREADS, 2)
gemm_kernel(const bf16* __restrict__ A, int M, int K, const bf16* __restrict__ Wt, int N,
            const bf16* __restrict__ bias, const bf16* __restrict__ R,
            bf16* __restrict__ C) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  bf16* As = reinterpret_cast<bf16*>(smem_raw);  // [STAGES][TILE_A]
  bf16* Bs = As + STAGES * TILE_A;               // [STAGES][TILE_B]

  const int tid = threadIdx.x, lane = tid & 31;
  const int wg = tid >> 7, w = (tid >> 5) & 3;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;

  // Each thread copies four 16-byte chunks of each operand per k-tile:
  // chunk q is row q / 8, k elements 8 * (q % 8) .. + 7. Eight consecutive
  // threads fill one row, so a warp's reads are whole 128-byte lines and
  // its swizzled shared-memory writes hit every bank once.
  auto issue = [&](int kt) {
    const int k0 = kt * BK, stage = kt % STAGES;
    unsigned char* a_s = reinterpret_cast<unsigned char*>(As + stage * TILE_A);
    unsigned char* b_s = reinterpret_cast<unsigned char*>(Bs + stage * TILE_B);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q = tid + i * THREADS;
      const int r = q >> 3, c = q & 7;
      const int off = r * 128 + ((c ^ (r & 7)) << 4);
      const int m = m0 + r, n = n0 + r;
      cp_async16(a_s + off, A + (size_t)(m < M ? m : 0) * K + k0 + c * 8, m < M);
      cp_async16(b_s + off, Wt + (size_t)(n < N ? n : 0) * K + k0 + c * 8, n < N);
    }
  };

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  const int KT = K / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) issue(s);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 2>();  // this thread's part of k-tile kt has landed
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to wgmma
    __syncthreads();  // everyone's part; the products of tile kt-1 are done
    if (kt + STAGES - 1 < KT) issue(kt + STAGES - 1);  // into the slot of tile kt-1
    cp_async_commit();

    const bf16* a_s = As + (kt % STAGES) * TILE_A + wg * 64 * BK;  // this warpgroup's rows
    const bf16* b_s = Bs + (kt % STAGES) * TILE_B;
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks)  // 16 k = 32 bytes into each swizzled row
      wgmma_m64n128k16(acc, smem_desc(a_s + ks * 16), smem_desc(b_s + ks * 16));
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  }
  cp_async_wait<0>();

  // Epilogue straight from the accumulators: a thread owns column pairs.
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int n = n0 + j * 8 + 2 * t;
    if (n >= N) continue;
    const float2 bb = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(bias + n));
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wg * 64 + w * 16 + g + h * 8;
      if (m >= M) continue;
      float v0 = acc[j * 4 + 2 * h] + bb.x;
      float v1 = acc[j * 4 + 2 * h + 1] + bb.y;
      if (EPI == EPI_GELU) {
        v0 = v0 / (1.f + expf(-1.702f * v0));
        v1 = v1 / (1.f + expf(-1.702f * v1));
      }
      if (EPI == EPI_RESIDUAL) {
        const float2 rr = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(R + (size_t)m * N + n));
        v0 = rr.x + v0;
        v1 = rr.y + v1;
      }
      *reinterpret_cast<__nv_bfloat162*>(C + (size_t)m * N + n) = __floats2bfloat162_rn(v0, v1);
    }
  }
}

template <int EPI>
cudaError_t launch(const bf16* A, int M, int K, const bf16* Wt, int N, const bf16* bias,
                   const bf16* R, bf16* C, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      gemm_kernel<EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (e != cudaSuccess) return e;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  gemm_kernel<EPI><<<grid, THREADS, SMEM_BYTES, stream>>>(A, M, K, Wt, N, bias, R, C);
  return cudaGetLastError();
}

}  // namespace
}  // namespace oadp

extern "C" {

// Shapes are checked by the Python wrapper: K % 64 == 0 (and K <= 1024
// with LN), N % 8 == 0, every pointer 16-byte aligned,
// (M + 127) / 128 < 65536. The weight comes
// transposed, Wt (N, K), so both operands are K-major. gamma == nullptr
// means no LayerNorm; otherwise ln_out (M, K) receives LN(A) and the
// product reads it.
int oadp_ln_gemm(const void* A, int M, int K, const float* gamma, const float* beta,
                 void* ln_out, const void* Wt, int N, const void* bias, int epilogue,
                 const void* R, void* C, void* stream) {
  using namespace oadp;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* a = static_cast<const bf16*>(A);
  if (gamma != nullptr) {
    const int rows_per_block = 8;  // 256 threads, one warp a row
    layer_norm_kernel<<<(M + rows_per_block - 1) / rows_per_block, 256, 0, s>>>(
        a, M, K, gamma, beta, static_cast<bf16*>(ln_out));
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    a = static_cast<const bf16*>(ln_out);
  }
  const bf16* w = static_cast<const bf16*>(Wt);
  const bf16* b = static_cast<const bf16*>(bias);
  const bf16* r = static_cast<const bf16*>(R);
  bf16* c = static_cast<bf16*>(C);
  switch (epilogue) {
    case EPI_NONE: return launch<EPI_NONE>(a, M, K, w, N, b, r, c, s);
    case EPI_GELU: return launch<EPI_GELU>(a, M, K, w, N, b, r, c, s);
    case EPI_RESIDUAL: return launch<EPI_RESIDUAL>(a, M, K, w, N, b, r, c, s);
  }
  return cudaErrorInvalidValue;
}

const char* oadp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
