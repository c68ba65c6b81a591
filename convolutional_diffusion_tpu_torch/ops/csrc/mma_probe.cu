// One warp-level mma.sync m16n8k16 (bf16 in, fp32 accumulate) per tile, to
// observe how the tensor core rounds the fp32 sum. Not on any score path:
// `ops.k2_numerics` runs it to choose how the plain 'high' version rounds.
#include <cuda_runtime.h>
#include <stdint.h>

// D = A.B + C for n independent tiles; A [n][16 rows][8 words] and
// B [n][8 cols][8 words] hold bf16 pairs along k; C, D [n][16][8] fp32.
__global__ void mma_probe_kernel(const uint32_t* A, const uint32_t* B,
                                 const float* C, float* D, int n) {
  const int lane = threadIdx.x, g = lane >> 2, t = lane & 3;
  for (int it = 0; it < n; ++it) {
    const uint32_t* a = A + it * 128;
    const uint32_t* b = B + it * 64;
    const float* c = C + it * 128;
    float* d = D + it * 128;
    float c0 = c[g * 8 + 2 * t], c1 = c[g * 8 + 2 * t + 1];
    float c2 = c[(g + 8) * 8 + 2 * t], c3 = c[(g + 8) * 8 + 2 * t + 1];
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c0), "+f"(c1), "+f"(c2), "+f"(c3)
        : "r"(a[g * 8 + t]), "r"(a[(g + 8) * 8 + t]), "r"(a[g * 8 + t + 4]),
          "r"(a[(g + 8) * 8 + t + 4]), "r"(b[g * 8 + t]), "r"(b[g * 8 + t + 4]));
    d[g * 8 + 2 * t] = c0;
    d[g * 8 + 2 * t + 1] = c1;
    d[(g + 8) * 8 + 2 * t] = c2;
    d[(g + 8) * 8 + 2 * t + 1] = c3;
  }
}

extern "C" int mma_probe(const void* A, const void* B, const void* C, void* D,
                         int n) {
  mma_probe_kernel<<<1, 32>>>((const uint32_t*)A, (const uint32_t*)B,
                              (const float*)C, (float*)D, n);
  cudaError_t err = cudaDeviceSynchronize();
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// The same question for the warpgroup product: one wgmma.mma_async
// m64n8k16 (bf16 from shared memory, no swizzle, fp32 accumulate) per
// tile, 128 threads, D = A.B^T + C (use_c) or D = A.B^T from zero
// (scale-d false). A [n][64 rows][16] and B [n][8 cols][16] bf16 along k;
// C, D [n][64][8] fp32. Shared memory holds each operand as 8-row x 16-byte
// core matrices, the one of rows 8 i .. and features 8 j .. at byte
// 256 i + 128 j; `lbo` and `sbo` are the descriptor's leading and stride
// byte offsets for A (B takes 128 for both), so a call with (128, 256) and
// one with (256, 128) tell which field is the feature direction.
__device__ __forceinline__ uint64_t wgmma_desc(const void* smem, int lbo, int sbo) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(smem);
  return (uint64_t)((a >> 4) & 0x3fff) | ((uint64_t)((lbo >> 4) & 0x3fff) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3fff) << 32);  // layout type 0: no swizzle
}

__global__ void wgmma_probe_kernel(const uint16_t* A, const uint16_t* B,
                                   const float* C, float* D, int n, int lbo,
                                   int sbo, int use_c) {
  __shared__ __align__(256) uint16_t As[64 * 16];
  __shared__ __align__(256) uint16_t Bs[8 * 16];
  const int t = threadIdx.x, w = t >> 5, l = t & 31;
  const int row = w * 16 + (l >> 2), col = (l & 3) * 2;
  for (int it = 0; it < n; ++it) {
    for (int e = t; e < 64 * 16; e += 128) {
      const int m = e / 16, k = e % 16;
      As[((m / 8) * 256 + (k / 8) * 128 + (m % 8) * 16 + (k % 8) * 2) / 2] = A[it * 1024 + e];
    }
    if (t < 128) {
      const int nn = t / 16, k = t % 16;
      Bs[((k / 8) * 128 + nn * 16 + (k % 8) * 2) / 2] = B[it * 128 + t];
    }
    __syncthreads();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    const float* c = C + it * 512;
    float d0 = c[row * 8 + col], d1 = c[row * 8 + col + 1];
    float d2 = c[(row + 8) * 8 + col], d3 = c[(row + 8) * 8 + col + 1];
    const uint64_t da = wgmma_desc(As, lbo, sbo), db = wgmma_desc(Bs, 128, 128);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3}, %4, %5, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d0), "+f"(d1), "+f"(d2), "+f"(d3)
        : "l"(da), "l"(db), "r"(use_c));
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    float* d = D + it * 512;
    d[row * 8 + col] = d0;
    d[row * 8 + col + 1] = d1;
    d[(row + 8) * 8 + col] = d2;
    d[(row + 8) * 8 + col + 1] = d3;
    __syncthreads();
  }
}

extern "C" int wgmma_probe(const void* A, const void* B, const void* C, void* D,
                           int n, int lbo, int sbo, int use_c) {
  wgmma_probe_kernel<<<1, 128>>>((const uint16_t*)A, (const uint16_t*)B,
                                 (const float*)C, (float*)D, n, lbo, sbo, use_c);
  cudaError_t err = cudaDeviceSynchronize();
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}
