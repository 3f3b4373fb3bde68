// Kernel K2: 8x8 integer forward DCT + round-to-nearest quantization of the
// encode scan, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas kernel theora_tpu/ops/pallas_kernels.py:
// fdct_quantize_soa (body _fdct_quant_kernel), which computes the function
// of `fdct8x8` + `quantize` in the JAX encode scan
// (theora_tpu/encode/tpu_gop.py:203-218). Besides the quantized values it
// writes the unquantized zig-zag DCT, which the trellis reads. Plain
// PyTorch version: theora_tpu_torch/ops/transforms.py:fdct_quantize.
//
// Per 8x8 block b (raster index k = 8*row + col, zig-zag index z):
//   x[k]  = res[b][k] << 2; x[0] += (x[0] != 0) + 1; x[1] += 1; x[8] -= 1
//           (the systematic-error biases, fdct.c:134-141)
//   y     = 1-D fDCT of each column of x, written as the rows of y;
//   w     = 1-D fDCT of each column of y (fdct.c:27-120, int16 wrap of
//           every output);
//   dct[z] = i16((w[zig[z]] + 2) >> 2)
//   d     = deq[inter[b]][z]; v2 = 2|dct[z]|
//   q[z]  = sign(dct[z]) * (v2 >= d ? (v2 + d) / (2d) : 0)   (enquant.c)
// All arithmetic is int32; products go through uint32 so a wrap is
// defined, and right shifts of negative values are arithmetic, as in JAX.
//
// Bound: memory. Per block the kernel reads 128 B of residuals and 1 B of
// flag and writes 2 x 128 B (the 256 B of dequant rows stay in L1/L2):
// ~385 B against ~1,300 int32 operations, far below the card's
// operations-per-byte balance. Design (as kernel K1): a thread block takes
// 32 blocks; residuals are staged through shared memory with coalesced
// loads, 8 threads per block run one column each in both passes (a row of
// 9 words keeps the second pass's reads on distinct banks), and both
// outputs leave through shared memory with coalesced stores.
//
// Plain C interface (loaded with ctypes); launches on the caller's stream,
// allocates nothing and returns cudaGetLastError().
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlocksPerCta = 32;
constexpr int kThreads = kBlocksPerCta * 8;

constexpr int C1S7 = 64277, C2S6 = 60547, C3S5 = 54491, C5S3 = 36410,
              C6S2 = 25080, C7S1 = 12785;

// Row-major coefficient index -> zig-zag index.
__constant__ int8_t kNatToZig[64] = {
    0,  1,  5,  6,  14, 15, 27, 28, 2,  4,  7,  13, 16, 26, 29, 42,
    3,  8,  12, 17, 25, 30, 41, 43, 9,  11, 18, 24, 31, 40, 44, 53,
    10, 19, 23, 32, 39, 45, 52, 54, 20, 22, 33, 38, 46, 51, 55, 60,
    21, 34, 37, 47, 50, 56, 59, 61, 35, 36, 48, 49, 57, 58, 62, 63};

__device__ __forceinline__ int32_t i16(int32_t x) {
  return ((x + 0x8000) & 0xFFFF) - 0x8000;
}

// c * x with two's-complement wrap (no signed overflow).
__device__ __forceinline__ int32_t mul(int32_t c, int32_t x) {
  return (int32_t)((uint32_t)c * (uint32_t)x);
}

__device__ __forceinline__ int32_t nz(int32_t t) { return t != 0; }

// 1-D 8-point fDCT (fdct.c:27-120): x[0..7] in, y[0..7] out (wrapped).
__device__ __forceinline__ void fdct8(const int32_t x[8], int32_t y[8]) {
  int32_t t0 = x[0] + x[7], t7 = x[0] - x[7];
  int32_t t1 = x[1] + x[6], t6 = x[1] - x[6];
  int32_t t2 = x[2] + x[5], t5 = x[2] - x[5];
  int32_t t3 = x[3] + x[4], t4 = x[3] - x[4];
  int32_t r = t0 + t3;
  t3 = t0 - t3;
  t0 = r;
  r = t1 + t2;
  t2 = t1 - t2;
  t1 = r;
  r = t6 + t5;
  t5 = t6 - t5;
  t6 = r;
  int32_t s = (((mul(27146, t5) + 0xB500) >> 16) + t5 + nz(t5)) >> 1;
  r = t4 + s;
  t5 = t4 - s;
  t4 = r;
  s = (((mul(27146, t6) + 0xB500) >> 16) + t6 + nz(t6)) >> 1;
  r = t7 + s;
  t6 = t7 - s;
  t7 = r;
  r = ((mul(27146, t0) + 0x4000) >> 16) + t0 + nz(t0);
  s = ((mul(27146, t1) + 0xB500) >> 16) + t1 + nz(t1);
  int32_t u = (r + s) >> 1;
  y[0] = i16(u);
  y[4] = i16(r - u);
  u = ((mul(C6S2, t2) + mul(C2S6, t3) + 0x6CB7) >> 16) + nz(t3);
  s = (mul(C6S2, u) >> 16) - t2;
  y[2] = i16(u);
  y[6] = i16(((mul(s, 21600) + 0x2800) >> 18) + s + nz(s));
  u = ((mul(C5S3, t6) + mul(C3S5, t5) + 0x0E3D) >> 16) + nz(t5);
  s = t6 - (mul(C5S3, u) >> 16);
  y[5] = i16(u);
  y[3] = i16(((mul(s, 26568) + 0x3400) >> 17) + s + nz(s));
  u = ((mul(C7S1, t4) + mul(C1S7, t7) + 0x7B1B) >> 16) + nz(t7);
  s = (mul(C7S1, u) >> 16) - t4;
  y[1] = i16(u);
  y[7] = i16(((mul(s, 20539) + 0x3000) >> 20) + s + nz(s));
}

__global__ void __launch_bounds__(kThreads)
fdct_quant_kernel(const int16_t* __restrict__ res,
                  const int16_t* __restrict__ deq,
                  const uint8_t* __restrict__ inter,
                  int16_t* __restrict__ qout, int16_t* __restrict__ dout,
                  int64_t n) {
  __shared__ int16_t s_in[kBlocksPerCta * 64];
  // First-pass output; a row of 9 words keeps the column reads of the
  // second pass on distinct banks.
  __shared__ int32_t s_y[kBlocksPerCta * 8 * 9];
  __shared__ int16_t s_q[kBlocksPerCta * 64];
  __shared__ int16_t s_d[kBlocksPerCta * 64];

  const int64_t first = (int64_t)blockIdx.x * kBlocksPerCta;
  const int nb = (int)min((int64_t)kBlocksPerCta, n - first);
  const int tid = threadIdx.x;

  const int16_t* src = res + first * 64;
  for (int k = tid; k < nb * 64; k += kThreads) s_in[k] = src[k];
  __syncthreads();

  const int lb = tid >> 3;  // local block
  const int c = tid & 7;    // column (first pass), row of y (second)
  const bool live = lb < nb;
  if (live) {
    int32_t x[8], y[8];
#pragma unroll
    for (int k = 0; k < 8; k++) x[k] = (int32_t)s_in[lb * 64 + 8 * k + c] * 4;
    if (c == 0) {
      x[0] += nz(x[0]) + 1;
      x[1] -= 1;  // raster index 8
    } else if (c == 1) {
      x[0] += 1;  // raster index 1
    }
    fdct8(x, y);
#pragma unroll
    for (int j = 0; j < 8; j++) s_y[(lb * 8 + c) * 9 + j] = y[j];
  }
  __syncthreads();

  if (live) {
    int32_t x[8], w[8];
#pragma unroll
    for (int k = 0; k < 8; k++) x[k] = s_y[(lb * 8 + k) * 9 + c];
    fdct8(x, w);
    const int16_t* row = deq + (inter[first + lb] ? 64 : 0);
#pragma unroll
    for (int j = 0; j < 8; j++) {
      const int z = kNatToZig[8 * c + j];
      const int32_t v = i16((w[j] + 2) >> 2);
      const int32_t d = row[z];
      const int32_t v2 = (v < 0 ? -v : v) << 1;
      const int32_t q = v2 >= d ? (v2 + d) / (2 * d) : 0;
      s_d[lb * 64 + z] = (int16_t)v;
      s_q[lb * 64 + z] = (int16_t)(v < 0 ? -q : q);
    }
  }
  __syncthreads();

  int16_t* qdst = qout + first * 64;
  int16_t* ddst = dout + first * 64;
  for (int k = tid; k < nb * 64; k += kThreads) {
    qdst[k] = s_q[k];
    ddst[k] = s_d[k];
  }
}

}  // namespace

extern "C" int th_fdct_quant(const int16_t* res, const int16_t* deq,
                             const uint8_t* inter, int16_t* qout,
                             int16_t* dout, int64_t n, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const int64_t grid = (n + kBlocksPerCta - 1) / kBlocksPerCta;
  fdct_quant_kernel<<<(unsigned)grid, kThreads, 0, (cudaStream_t)stream>>>(
      res, deq, inter, qout, dout, n);
  return (int)cudaGetLastError();
}
