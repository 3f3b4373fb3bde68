// Issue rates of the SIMD video instructions kernel KM (csrc/me.cu) is
// built on, for tools/bench_me.py:simd_rates (a measurement, not a kernel
// of any path).
//
// Op 0: __vsadu4 with its accumulate (VABSDIFF4), op 1: __vsadu2 with its
// accumulate (vabsdiff2, which ptxas expands into several instructions),
// op 2: __vhaddu4 (the truncating per-byte average; a few int32
// instructions), op 3: an int32 multiply-add (IMAD), the reference, op 4:
// the scalar vabsdiff with its accumulate on one 16-bit half of each
// operand (vabsdiff with half selectors, also expanded by ptxas), one
// pyramid value a step, op 5: min.u16x2, the per-half minimum of two
// pairs of 16-bit values (one instruction on sm_90). Each thread runs `iters` rounds of 8 independent chains
// of the op, each step reading the chain's last value (the minimum reads
// its pair's too: min(x, y) then min(y, x')), so nothing can be hoisted
// or merged; thread 0 of each CTA reads the SM clock before and
// after. A CTA of 1024 threads asks for 120 KB of shared memory, so each
// SM holds one.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kChains = 8;
constexpr int kSmem = 120 * 1024;

template <int OP>
__device__ __forceinline__ uint32_t step(uint32_t acc, uint32_t other,
                                         uint32_t b, uint32_t c) {
  uint32_t r;
  if (OP == 0)
    asm volatile("vabsdiff4.u32.u32.u32.add %0, %1, %2, %1;"
                 : "=r"(r) : "r"(acc), "r"(b));
  else if (OP == 1)
    asm volatile("vabsdiff2.u32.u32.u32.add %0, %1, %2, %1;"
                 : "=r"(r) : "r"(acc), "r"(b));
  else if (OP == 2)
    r = __vhaddu4(acc, b);
  else if (OP == 3)
    asm volatile("mad.lo.u32 %0, %1, %2, %3;"
                 : "=r"(r) : "r"(acc), "r"(b), "r"(c));
  else if (OP == 4)
    asm volatile("vabsdiff.u32.u32.u32.add %0, %1.h1, %2.h0, %1;"
                 : "=r"(r) : "r"(acc), "r"(b));
  else
    asm volatile("min.u16x2 %0, %1, %2;" : "=r"(r) : "r"(acc), "r"(other));
  return r;
}

template <int OP>
__global__ void __launch_bounds__(kThreads)
simd_rate_kernel(uint32_t b, uint32_t c, int iters,
                 long long* __restrict__ cycles, uint32_t* __restrict__ sink) {
  extern __shared__ uint32_t hold[];  // only keeps other CTAs off the SM
  uint32_t acc[kChains];
#pragma unroll
  for (int i = 0; i < kChains; i++) acc[i] = threadIdx.x * kChains + i + c;
  __syncthreads();
  const long long t0 = clock64();
  for (int it = 0; it < iters; it++) {
#pragma unroll
    for (int i = 0; i < kChains; i++)
      acc[i] = step<OP>(acc[i], acc[i ^ 1], b, c);
  }
  __syncthreads();
  const long long t1 = clock64();
  uint32_t s = 0;
#pragma unroll
  for (int i = 0; i < kChains; i++) s ^= acc[i];
  if (s == 0xdeadbeefu) hold[threadIdx.x] = s;
  sink[blockIdx.x * kThreads + threadIdx.x] = s;
  if (threadIdx.x == 0) cycles[blockIdx.x] = t1 - t0;
}

template <int OP>
int run(int iters, int ctas, long long* cycles, uint32_t* sink,
        cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      simd_rate_kernel<OP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmem);
  if (e != cudaSuccess) return (int)e;
  simd_rate_kernel<OP><<<ctas, kThreads, kSmem, stream>>>(
      0x5a3c9617u, 0x01234567u, iters, cycles, sink);
  return (int)cudaGetLastError();
}

}  // namespace

// ops[op] per thread per round: kChains; cycles [ctas] int64, sink [ctas *
// 1024] uint32.
extern "C" int th_simd_rate(int op, int iters, int ctas, long long* cycles,
                            uint32_t* sink, void* stream) {
  if (iters < 1 || ctas < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (op) {
    case 0: return run<0>(iters, ctas, cycles, sink, s);
    case 1: return run<1>(iters, ctas, cycles, sink, s);
    case 2: return run<2>(iters, ctas, cycles, sink, s);
    case 3: return run<3>(iters, ctas, cycles, sink, s);
    case 4: return run<4>(iters, ctas, cycles, sink, s);
    case 5: return run<5>(iters, ctas, cycles, sink, s);
  }
  return (int)cudaErrorInvalidValue;
}
