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
