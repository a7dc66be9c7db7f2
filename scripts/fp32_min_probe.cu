// Issue-rate probe for the min-plus kernel's two instructions on one
// CUDA card: FADD alone, FMNMX (min.f32) alone, the two alternating, the
// kernel's pattern (t = x + y; acc = min(acc, t)) and FFMA, each on 8
// independent chains per thread, at 4, 8, 16 and 32 warps per SM. Prints
// warp-instructions per clock per SM at the 1980 MHz boost clock (an SM
// issues at most 4).
//
//   mkdir -p chip_check && nvcc -gencode arch=compute_90a,code=sm_90a -O3 \
//       -o chip_check/probe scripts/fp32_min_probe.cu && chip_check/probe
#include <cstdio>
#include <cuda_runtime.h>
template <int MODE>
__global__ void probe(float* out, float c, int iters) {
  float x[8];
  for (int i = 0; i < 8; ++i) x[i] = threadIdx.x + i;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (MODE == 0) asm volatile("add.f32 %0, %0, %1;" : "+f"(x[i]) : "f"(c));
      if (MODE == 1) asm volatile("min.f32 %0, %0, %1;" : "+f"(x[i]) : "f"(c));
      if (MODE == 2) {
        asm volatile("add.f32 %0, %0, %1;" : "+f"(x[i]) : "f"(c));
        asm volatile("min.f32 %0, %0, %1;" : "+f"(x[i]) : "f"(c));
      }
      if (MODE == 3) {  // the kernel's pattern: t = d + a; acc = min(acc, t), 8 accs
        float t;
        asm volatile("add.f32 %0, %1, %2;" : "=f"(t) : "f"(c), "f"(x[(i + 1) & 7]));
        asm volatile("min.f32 %0, %0, %1;" : "+f"(x[i]) : "f"(t));
      }
      if (MODE == 4) asm volatile("fma.rn.f32 %0, %0, %1, %1;" : "+f"(x[i]) : "f"(c));
    }
  }
  float s = 0;
  for (int i = 0; i < 8; ++i) s += x[i];
  if (s == 1234.5f) out[0] = s;
}
int main() {
  float* out; cudaMalloc(&out, 4);
  int iters = 1 << 14;
  const char* names[] = {"fadd", "fmnmx", "fadd+fmnmx", "kernel-pattern", "ffma"};
  for (int warps : {4, 8, 16, 32}) {
    for (int mode = 0; mode < 5; ++mode) {
      cudaEvent_t a, b; cudaEventCreate(&a); cudaEventCreate(&b);
      dim3 grid(132 * (warps / 4)), block(128);
      auto run = [&] {
        if (mode == 0) probe<0><<<grid, block>>>(out, 1.0f, iters);
        if (mode == 1) probe<1><<<grid, block>>>(out, 1.0f, iters);
        if (mode == 2) probe<2><<<grid, block>>>(out, 1.0f, iters);
        if (mode == 3) probe<3><<<grid, block>>>(out, 1.0f, iters);
        if (mode == 4) probe<4><<<grid, block>>>(out, 1.0f, iters);
      };
      run(); cudaDeviceSynchronize();
      cudaEventRecord(a); run(); cudaEventRecord(b); cudaEventSynchronize(b);
      float ms; cudaEventElapsedTime(&ms, a, b);
      double instr = (double)grid.x * block.x / 32 * iters * 8 * (mode == 2 || mode == 3 ? 2 : 1);
      // warp-instructions per clock per SM at 1.98 GHz
      printf("warps/SM %2d %-15s %.3f ms  %.2f warp-instr/clk/SM\n", warps, names[mode], ms,
             instr / 132 / (ms * 1e-3 * 1.98e9));
    }
  }
  return 0;
}
