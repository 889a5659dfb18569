// Throughput of mma.sync m16n8k8 TF32 on one card: every warp runs
// NACC independent chains of mma into registers (NACC = 8), or one chain
// (NACC = 1, its latency).  chip_probes/k6_design.py launches it.
#include <cuda_runtime.h>
#include <stdint.h>
template <int NACC>
__global__ void peak(float* out, int iters) {
  uint32_t a[4] = {threadIdx.x * 0x3f800000u, 0x3f800000u, 0x3f000000u, threadIdx.x};
  uint32_t b0 = 0x3f800000u ^ blockIdx.x, b1 = 0x3e800000u;
  float c[NACC][4];
#pragma unroll
  for (int j = 0; j < NACC; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < NACC; ++j)
      asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                   : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < NACC; ++j) s += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int run(int nacc, int blocks, int threads, int iters, float* out) {
  if (nacc == 1) peak<1><<<blocks, threads>>>(out, iters);
  else peak<8><<<blocks, threads>>>(out, iters);
  return (int)cudaGetLastError();
}
