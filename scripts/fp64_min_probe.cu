// Issue-rate probe for the f64 min-plus kernel's candidate on one CUDA
// card: t = x + y; acc = min(acc, t) on doubles, written four ways, beside
// DADD, DFMA and min.f64 alone, each on 8 independent chains per thread,
// at 4, 8, 16 and 32 warps per SM. Prints candidates (or operations) per
// clock per SM at the 1980 MHz boost clock; the FP64 pipes do 64 adds a
// clock per SM.
//
//   min.f64          fmin: DSETP.MIN, two selects, a NaN fix-up
//   setp.f64 + selp  the ternary c < acc ? c : acc
//   u64 compare      the bit patterns compared as unsigned integers:
//                    exact only where both values are >= +0.0 (or NaN-free
//                    and of one sign), so a measure of the ceiling only
//   s64 key          acc kept as a signed-integer key of its bits (the
//                    sign-magnitude order as two's complement: bits ^
//                    (sign ? 0x7fff... : 0)), exact for every non-NaN
//                    double; -0.0 sorts below +0.0
//
//   mkdir -p chip_check && nvcc -gencode arch=compute_90a,code=sm_90a -O3 \
//       -o chip_check/probe64 scripts/fp64_min_probe.cu && chip_check/probe64
#include <cstdio>
#include <cuda_runtime.h>

template <int MODE>
__global__ void probe(double* out, double c, int iters) {
  double x[8];
  long long k[8];
  for (int i = 0; i < 8; ++i) {
    x[i] = threadIdx.x + i;
    k[i] = __double_as_longlong(x[i]);
  }
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (MODE == 0) asm volatile("add.f64 %0, %0, %1;" : "+d"(x[i]) : "d"(c));
      if (MODE == 1) asm volatile("min.f64 %0, %0, %1;" : "+d"(x[i]) : "d"(c));
      if (MODE == 2) {  // the kernel: t = d + a; acc = fmin(acc, t)
        double t;
        asm volatile("add.f64 %0, %1, %2;" : "=d"(t) : "d"(c), "d"(x[(i + 1) & 7]));
        asm volatile("min.f64 %0, %0, %1;" : "+d"(x[i]) : "d"(t));
      }
      if (MODE == 3) {  // c < acc ? c : acc
        double t;
        asm volatile("add.f64 %0, %1, %2;" : "=d"(t) : "d"(c), "d"(x[(i + 1) & 7]));
        asm volatile(
            "{ .reg .pred p; setp.lt.f64 p, %1, %0; selp.f64 %0, %1, %0, p; }"
            : "+d"(x[i]) : "d"(t));
      }
      if (MODE == 4) {  // unsigned compare of the bits (non-negative only)
        double t;
        asm volatile("add.f64 %0, %1, %2;" : "=d"(t) : "d"(c), "d"(x[(i + 1) & 7]));
        asm volatile(
            "{ .reg .pred p; .reg .b64 a, b; mov.b64 a, %1; mov.b64 b, %0;"
            " setp.lt.u64 p, a, b; selp.f64 %0, %1, %0, p; }"
            : "+d"(x[i]) : "d"(t));
      }
      if (MODE == 5) {  // signed key of the bits, acc kept as a key
        double t;
        asm volatile("add.f64 %0, %1, %2;" : "=d"(t) : "d"(c),
                     "d"(__longlong_as_double(k[(i + 1) & 7])));
        asm volatile(
            "{ .reg .pred p; .reg .b64 b, m;"
            " mov.b64 b, %1; shr.s64 m, b, 63; and.b64 m, m, 0x7fffffffffffffff;"
            " xor.b64 b, b, m; setp.lt.s64 p, b, %0; selp.b64 %0, b, %0, p; }"
            : "+l"(k[i]) : "d"(t));
      }
      if (MODE == 6) asm volatile("fma.rn.f64 %0, %0, %1, %1;" : "+d"(x[i]) : "d"(c));
    }
  }
  double s = 0;
  for (int i = 0; i < 8; ++i) s += x[i] + __longlong_as_double(k[i]);
  if (s == 1234.5) out[0] = s;
}

int main() {
  double* out;
  cudaMalloc(&out, 8);
  const int iters = 1 << 13;
  const char* names[] = {"dadd", "min.f64", "kernel min.f64",
                         "kernel setp+selp", "kernel u64 compare",
                         "kernel s64 key", "dfma"};
  for (int warps : {4, 8, 16, 32}) {
    for (int mode = 0; mode < 7; ++mode) {
      cudaEvent_t a, b;
      cudaEventCreate(&a);
      cudaEventCreate(&b);
      dim3 grid(132 * (warps / 4)), block(128);
      auto run = [&] {
        switch (mode) {
          case 0: probe<0><<<grid, block>>>(out, 1.0, iters); break;
          case 1: probe<1><<<grid, block>>>(out, 1.0, iters); break;
          case 2: probe<2><<<grid, block>>>(out, 1.0, iters); break;
          case 3: probe<3><<<grid, block>>>(out, 1.0, iters); break;
          case 4: probe<4><<<grid, block>>>(out, 1.0, iters); break;
          case 5: probe<5><<<grid, block>>>(out, 1.0, iters); break;
          case 6: probe<6><<<grid, block>>>(out, 1.0, iters); break;
        }
      };
      run();
      cudaEventRecord(a);
      run();
      cudaEventRecord(b);
      cudaEventSynchronize(b);
      float ms;
      cudaEventElapsedTime(&ms, a, b);
      // One candidate (or operation) per chain per iteration per thread.
      const double per_sm = (double)block.x * (grid.x / 132) * 8 * iters;
      const double clocks = ms * 1e-3 * 1.98e9;
      printf("{\"warps_per_sm\": %d, \"pattern\": \"%s\", \"ms\": %.4f, "
             "\"per_clock_per_sm\": %.2f}\n",
             warps, names[mode], ms, per_sm / clocks);
    }
  }
  return cudaGetLastError() != cudaSuccess;
}
