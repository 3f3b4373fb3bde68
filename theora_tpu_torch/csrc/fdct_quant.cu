// Kernel K2: 8x8 integer forward DCT + round-to-nearest quantization of the
// encode scan at K quantizer rows, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas kernel theora_tpu/ops/pallas_kernels.py:
// fdct_quantize_soa (body _fdct_quant_kernel), which computes the function
// of `fdct8x8` + `quantize` in the JAX encode scan
// (theora_tpu/encode/tpu_gop.py:203-218); with adaptive quantization the
// scan quantizes one fDCT with each of its K <= 3 qi rows
// (tpu_gop.py:249-264). Besides the K quantized rows it writes the
// unquantized zig-zag DCT, which the trellis reads. Plain PyTorch version:
// theora_tpu_torch/ops/transforms.py:fdct_quantize.
//
// Per 8x8 block b (raster index r = 8*row + col, zig-zag index z):
//   x[r]  = res[b][r] << 2; x[0] += (x[0] != 0) + 1; x[1] += 1; x[8] -= 1
//           (the systematic-error biases, fdct.c:134-141)
//   y     = 1-D fDCT of each column of x, written as the rows of y;
//   w     = 1-D fDCT of each column of y (fdct.c:27-120, int16 wrap of
//           every output);
//   dct[z] = i16((w[zig[z]] + 2) >> 2)
//   d     = deq[k][inter[b]][z]; v2 = 2|dct[z]|
//   q[k][z] = sign(dct[z]) * (v2 >= d ? (v2 + d) / (2d) : 0)  (enquant.c)
// The divide is exact without a divide instruction:
//   (v2 >= d ? (v2 + d) / (2d) : 0) == (|v| + (d >> 1)) / d
// (v2 + d is odd or even as d is, so halving it floors to |v| + (d >> 1);
// where v2 < d that is below d), and for d in [1, 32767] and
// n = |v| + (d >> 1) <= 49151,
//   n / d == (n * m) >> 31,  m = ceil(2^31 / d),
// since m * d - 2^31 < d and n * (m * d - 2^31) < 2^31. The reciprocals are
// computed once per CTA beside the staged dequant rows;
// tests/test_torch_encode_ops.py proves the identity over the whole domain.
// All other arithmetic is int32; products go through uint32 so a wrap is
// defined, and right shifts of negative values are arithmetic, as in JAX.
//
// Bound: memory. Per block the kernel reads 128 B of residuals and 1 B of
// flag and writes 128 B of DCT and K x 128 B of values (641 B at K = 3);
// the K x 256 B of dequant rows are read once per CTA. Design: 8 lanes per
// block, 4 blocks per warp, 8 warps per CTA; a block's work stays inside
// its warp (shared memory between __syncwarp()s). Lane c loads raster row c
// as one 16-byte vector and parks it in shared memory; pass 1 reads column
// c, pass 2 reads column c of pass 1's output (a row of 9 words keeps those
// reads on distinct banks, and a block's area of 136 words puts the 4
// blocks of a warp 8 banks apart); the DCT goes back as natural rows, lane
// c gathers zig-zag positions 8c..8c+7 from it, and stores the DCT vector
// and, for each qi row, the quantized vector, each as one 16-byte store:
// the K quantizations read the DCT from registers.
//
// Segments: a launch may cover G segments of n blocks each (the mesh
// encoder's G GOPs at one frame step: N = G n blocks of one plane), each
// with its own K dequant rows ([G][K][2][64]); block b takes segment b / n.
// The segment is blockIdx.y, so a CTA stages one segment's rows and never
// straddles two; G = 1 is the one-segment launch.
//
// Plain C interface (loaded with ctypes); launches on the caller's stream,
// allocates nothing and returns cudaGetLastError().
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxRows = 3;            // qi rows per launch
constexpr int kLanes = 8;              // lanes per 8x8 block
constexpr int kGroups = 32 / kLanes;   // blocks per warp
// Warps per CTA; tools/bench_fdct.py --warps builds other shapes.
#ifndef K2_WARPS
#define K2_WARPS 8
#endif
constexpr int kWarps = K2_WARPS;
constexpr int kBlocksPerCta = kWarps * kGroups;
constexpr int kThreads = kWarps * 32;

constexpr int C1S7 = 64277, C2S6 = 60547, C3S5 = 54491, C5S3 = 36410,
              C6S2 = 25080, C7S1 = 12785;

// Zig-zag index -> row-major coefficient index.
__constant__ int8_t kZigToNat[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// One 8x8 block's shared memory: 136 words, so the 4 blocks of a warp sit
// 8 banks apart.
struct BlockArea {
  int4 rows[8];   // raster rows of the residual, later of the DCT (int16)
  int32_t y[72];  // pass 1's output, rows of 9 words
  int32_t pad[32];
};

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

// The eight int16 of a 16-byte vector, in memory order, and back.
__device__ __forceinline__ void unpack8(int4 v, int32_t x[8]) {
  const int w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int m = 0; m < 4; m++) {
    x[2 * m] = (int16_t)(w[m] & 0xFFFF);
    x[2 * m + 1] = w[m] >> 16;
  }
}

__device__ __forceinline__ int4 pack8(const int32_t x[8]) {
  int w[4];
#pragma unroll
  for (int m = 0; m < 4; m++)
    w[m] = (x[2 * m] & 0xFFFF) | (int)((uint32_t)x[2 * m + 1] << 16);
  return make_int4(w[0], w[1], w[2], w[3]);
}

template <int K>
__global__ void __launch_bounds__(kThreads)
fdct_quant_kernel(const int16_t* __restrict__ res,
                  const int16_t* __restrict__ deq,
                  const uint8_t* __restrict__ inter,
                  int16_t* __restrict__ qout, int16_t* __restrict__ dout,
                  int64_t n) {
  __shared__ BlockArea areas[kBlocksPerCta];
  // The K qi rows [k][inter][z] and their reciprocals ceil(2^31 / d).
  __shared__ __align__(16) int16_t s_deq[K * 2 * 64];
  __shared__ __align__(16) uint32_t s_rcp[K * 2 * 64];

  const int tid = threadIdx.x;
  const int64_t seg = blockIdx.y;
  deq += seg * (K * 2 * 64);
  for (int e = tid; e < K * 2 * 64; e += kThreads) {
    const uint32_t d = (uint32_t)deq[e];
    s_deq[e] = (int16_t)d;
    s_rcp[e] = (0x80000000u + d - 1) / d;
  }
  __syncthreads();

  const int c = tid & (kLanes - 1);       // row (in), column (passes)
  const int lb = tid / kLanes;            // local block
  BlockArea& A = areas[lb];
  const int64_t local = (int64_t)blockIdx.x * kBlocksPerCta + lb;
  const bool live = local < n;
  const int64_t b = seg * n + local;  // block of the launch
  const int64_t total = n * gridDim.y;

  int32_t x[8];
  A.rows[c] = live ? reinterpret_cast<const int4*>(res)[b * 8 + c]
                   : make_int4(0, 0, 0, 0);
  __syncwarp();
  const int16_t* in = reinterpret_cast<const int16_t*>(A.rows);
#pragma unroll
  for (int k = 0; k < 8; k++) x[k] = (int32_t)in[8 * k + c] * 4;
  if (c == 0) {
    x[0] += nz(x[0]) + 1;
    x[1] -= 1;  // raster index 8
  } else if (c == 1) {
    x[0] += 1;  // raster index 1
  }
  int32_t y[8];
  fdct8(x, y);
#pragma unroll
  for (int j = 0; j < 8; j++) A.y[c * 9 + j] = y[j];
  __syncwarp();

#pragma unroll
  for (int k = 0; k < 8; k++) x[k] = A.y[k * 9 + c];
  fdct8(x, y);
  // Natural row c of the DCT.
#pragma unroll
  for (int j = 0; j < 8; j++) y[j] = i16((y[j] + 2) >> 2);
  A.rows[c] = pack8(y);
  __syncwarp();

  // Zig-zag positions 8c..8c+7.
  int32_t v[8];
#pragma unroll
  for (int t = 0; t < 8; t++) v[t] = in[kZigToNat[8 * c + t]];
  if (live) {
    reinterpret_cast<int4*>(dout)[b * 8 + c] = pack8(v);
    const int t = inter[b] ? 1 : 0;
#pragma unroll
    for (int k = 0; k < K; k++) {
      const int row = (k * 2 + t) * 64 + 8 * c;
      int32_t d[8];
      unpack8(*reinterpret_cast<const int4*>(s_deq + row), d);
      const uint4 m0 = *reinterpret_cast<const uint4*>(s_rcp + row);
      const uint4 m1 = *reinterpret_cast<const uint4*>(s_rcp + row + 4);
      const uint32_t m[8] = {m0.x, m0.y, m0.z, m0.w, m1.x, m1.y, m1.z, m1.w};
      int32_t q[8];
#pragma unroll
      for (int j = 0; j < 8; j++) {
        const uint32_t a = (uint32_t)(v[j] < 0 ? -v[j] : v[j]);
        const uint32_t qa = (uint32_t)(
            ((uint64_t)(a + ((uint32_t)d[j] >> 1)) * m[j]) >> 31);
        q[j] = v[j] < 0 ? -(int32_t)qa : (int32_t)qa;
      }
      reinterpret_cast<int4*>(qout)[((int64_t)k * total + b) * 8 + c] =
          pack8(q);
    }
  }
}

}  // namespace

// res [nseg n, 64] int16, deq [nseg, k, 2, 64] int16, inter [nseg n]
// uint8; writes qout [k, nseg n, 64] and dout [nseg n, 64] int16. n is the
// blocks of one segment.
extern "C" int th_fdct_quant(const int16_t* res, const int16_t* deq,
                             const uint8_t* inter, int16_t* qout,
                             int16_t* dout, int64_t n, int k, int nseg,
                             void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (k < 1 || k > kMaxRows || nseg < 1 || nseg > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((n + kBlocksPerCta - 1) / kBlocksPerCta),
                  (unsigned)nseg);
  cudaStream_t s = (cudaStream_t)stream;
  if (k == 1)
    fdct_quant_kernel<1><<<grid, kThreads, 0, s>>>(res, deq, inter, qout,
                                                    dout, n);
  else if (k == 2)
    fdct_quant_kernel<2><<<grid, kThreads, 0, s>>>(res, deq, inter, qout,
                                                    dout, n);
  else
    fdct_quant_kernel<3><<<grid, kThreads, 0, s>>>(res, deq, inter, qout,
                                                    dout, n);
  return (int)cudaGetLastError();
}
