// Kernel K1: dequantization + 8x8 integer iDCT of the decode scan, for
// NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas kernel theora_tpu/ops/pallas_kernels.py:idct8x8_soa
// (body _idct_kernel) together with the dequant, DC and DC-only fill steps
// the JAX decode scan wraps around it (theora_tpu/decode/tpu_batch.py:
// 85-106, transforms_jax.dequantize_idct). Plain PyTorch version:
// theora_tpu_torch/ops/transforms.py:dequantize_idct_frames.
//
// Per 8x8 block b (natural order index k = 8*row + col, zig-zag index z):
//   x[k]   = i16(qz[b][z] * tab[frame[b]][qii[b]][inter[b]][z])   (k != 0)
//   x[0]   = i16(dc[b] * dcq),  dcq = tab[frame[b]][0][inter[b]][0]
//   y      = column iDCT of row iDCT of x, i16 wrap at every butterfly
//            (idct.c:30-81, 285-296); out = i16((y + 8) >> 4)
//   dc_only blocks: out = i16((dc[b] * dcq + 15) >> 5)   (state.c:967-975)
// All arithmetic is int32 with an explicit 16-bit wrap; right shifts of
// negative values are arithmetic, as in JAX.
//
// Bound: memory. Per block the kernel reads 128 B of coefficients, 2 B of
// DC, 4 B of frame index and 3 B of flags, and writes 128 B of residuals
// (the dequant table, F*384 B, stays in L1/L2): ~265 B against ~600 int32
// operations, far below the card's operations-per-byte balance. Design:
// a thread block takes 32 coefficient blocks; the coefficients are staged
// through shared memory with coalesced loads, 8 threads per block run one
// row each in the first pass and one column each in the second, and the
// residuals leave through shared memory with coalesced stores.
//
// Plain C interface (loaded with ctypes); launches on the caller's stream,
// allocates nothing and returns cudaGetLastError().
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlocksPerCta = 32;
constexpr int kThreads = kBlocksPerCta * 8;

constexpr int C1S7 = 64277, C2S6 = 60547, C3S5 = 54491, C4S4 = 46341,
              C5S3 = 36410, C6S2 = 25080, C7S1 = 12785;

// Row-major coefficient index -> zig-zag index.
__constant__ int8_t kNatToZig[64] = {
    0,  1,  5,  6,  14, 15, 27, 28, 2,  4,  7,  13, 16, 26, 29, 42,
    3,  8,  12, 17, 25, 30, 41, 43, 9,  11, 18, 24, 31, 40, 44, 53,
    10, 19, 23, 32, 39, 45, 52, 54, 20, 22, 33, 38, 46, 51, 55, 60,
    21, 34, 37, 47, 50, 56, 59, 61, 35, 36, 48, 49, 57, 58, 62, 63};

__device__ __forceinline__ int32_t i16(int32_t x) {
  return ((x + 0x8000) & 0xFFFF) - 0x8000;
}

__device__ __forceinline__ int32_t m16(int32_t c, int32_t x) {
  return (c * x) >> 16;
}

// 1-D 8-point iDCT (idct.c:30-81), in place on x[0..7].
__device__ __forceinline__ void idct8(int32_t x[8]) {
  int32_t t0 = m16(C4S4, i16(x[0] + x[4]));
  int32_t t1 = m16(C4S4, i16(x[0] - x[4]));
  int32_t t2 = m16(C6S2, x[2]) - m16(C2S6, x[6]);
  int32_t t3 = m16(C2S6, x[2]) + m16(C6S2, x[6]);
  int32_t t4 = m16(C7S1, x[1]) - m16(C1S7, x[7]);
  int32_t t5 = m16(C3S5, x[5]) - m16(C5S3, x[3]);
  int32_t t6 = m16(C5S3, x[5]) + m16(C3S5, x[3]);
  int32_t t7 = m16(C1S7, x[1]) + m16(C7S1, x[7]);
  int32_t r = t4 + t5;
  t5 = m16(C4S4, i16(t4 - t5));
  t4 = r;
  r = t7 + t6;
  t6 = m16(C4S4, i16(t7 - t6));
  t7 = r;
  r = t0 + t3;
  t3 = t0 - t3;
  t0 = r;
  r = t1 + t2;
  t2 = t1 - t2;
  t1 = r;
  r = t6 + t5;
  t5 = t6 - t5;
  t6 = r;
  x[0] = i16(t0 + t7);
  x[1] = i16(t1 + t6);
  x[2] = i16(t2 + t5);
  x[3] = i16(t3 + t4);
  x[4] = i16(t3 - t4);
  x[5] = i16(t2 - t5);
  x[6] = i16(t1 - t6);
  x[7] = i16(t0 - t7);
}

__global__ void __launch_bounds__(kThreads)
dequant_idct_kernel(const int16_t* __restrict__ qz,
                    const int16_t* __restrict__ dc,
                    const int16_t* __restrict__ tab,
                    const int32_t* __restrict__ frame,
                    const uint8_t* __restrict__ qii,
                    const uint8_t* __restrict__ inter,
                    const uint8_t* __restrict__ dc_only,
                    int16_t* __restrict__ out, int64_t n) {
  __shared__ int16_t s_q[kBlocksPerCta * 64];
  // Row-pass results; a row of 9 words keeps the column reads of the
  // second pass on distinct banks.
  __shared__ int32_t s_w[kBlocksPerCta * 8 * 9];
  __shared__ int16_t s_out[kBlocksPerCta * 64];

  const int64_t first = (int64_t)blockIdx.x * kBlocksPerCta;
  const int nb = (int)min((int64_t)kBlocksPerCta, n - first);
  const int tid = threadIdx.x;

  // Coalesced load of this CTA's zig-zag coefficients.
  const int16_t* src = qz + first * 64;
  for (int k = tid; k < nb * 64; k += kThreads) s_q[k] = src[k];
  __syncthreads();

  const int lb = tid >> 3;  // local block
  const int r = tid & 7;    // row (first pass), column (second pass)
  const bool live = lb < nb;
  int32_t dcq = 0, dcv = 0;
  if (live) {
    const int64_t b = first + lb;
    const int32_t f = frame[b];
    const int32_t it = inter[b];
    const int16_t* row = tab + (int64_t)((f * 3 + qii[b]) * 2 + it) * 64;
    dcq = tab[(int64_t)(f * 3 * 2 + it) * 64];
    dcv = dc[b];
    int32_t x[8];
#pragma unroll
    for (int j = 0; j < 8; j++) {
      const int z = kNatToZig[r * 8 + j];
      x[j] = z == 0 ? i16(dcv * dcq)
                    : i16((int32_t)s_q[lb * 64 + z] * (int32_t)row[z]);
    }
    idct8(x);
#pragma unroll
    for (int j = 0; j < 8; j++) s_w[(lb * 8 + r) * 9 + j] = x[j];
  }
  __syncthreads();

  if (live) {
    int32_t y[8];
#pragma unroll
    for (int i = 0; i < 8; i++) y[i] = s_w[(lb * 8 + i) * 9 + r];
    idct8(y);
    const bool fill = dc_only[first + lb] != 0;
    const int32_t fv = i16((dcv * dcq + 15) >> 5);
#pragma unroll
    for (int i = 0; i < 8; i++)
      s_out[lb * 64 + i * 8 + r] = (int16_t)(fill ? fv : i16((y[i] + 8) >> 4));
  }
  __syncthreads();

  int16_t* dst = out + first * 64;
  for (int k = tid; k < nb * 64; k += kThreads) dst[k] = s_out[k];
}

}  // namespace

extern "C" int th_dequant_idct(const int16_t* qz, const int16_t* dc,
                               const int16_t* tab, const int32_t* frame,
                               const uint8_t* qii, const uint8_t* inter,
                               const uint8_t* dc_only, int16_t* out,
                               int64_t n, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const int64_t grid = (n + kBlocksPerCta - 1) / kBlocksPerCta;
  dequant_idct_kernel<<<(unsigned)grid, kThreads, 0, (cudaStream_t)stream>>>(
      qz, dc, tab, frame, qii, inter, dc_only, out, n);
  return (int)cudaGetLastError();
}
