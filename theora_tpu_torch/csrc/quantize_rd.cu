// Kernel KR: the encoder's R/D quantizer for NVIDIA Hopper (sm_90a).
//
// Replaces the JAX R/D quantizer theora_tpu/ops/transforms_jax.py:
// quantize_rd (:185), which the JAX encode scan runs in place of the
// trellis at speed levels 2-4 and with use_trellis=False
// (theora_tpu/encode/tpu_gop.py:230-236), once per qi row. It is not a
// Pallas kernel; XLA fuses it on the TPU. Plain PyTorch version:
// theora_tpu_torch/ops/transforms.py:quantize_rd_rows (quantize_rd_values
// behind the casts of this interface).
//
// Interface: kernel K2's outputs as K2 writes them ([K, N, 64] int16
// round-to-nearest values at K <= 3 qi rows and the [N, 64] unquantized
// DCT, zig-zag), K2's [K, 2, 64] int16 dequant rows (per qi row intra,
// inter), the [N] uint8 inter flags and the float32 lambdas lam[k][t], per
// qi row the intra and the inter one. Pair (k, n) takes the dequant row
// and the lambda of row k at t = inter[n] != 0: the lambda follows the
// block, not the frame. It writes, as kernel KT does, the values ([K, N,
// 64] int16, DC passed through), their nonzero count ([K, N] int32) and
// whether no AC value is nonzero ([K, N] bool), which kernel K1's encode
// entry reads as they are.
//
// Per AC position p of a pair, with a0 = |q[p]|, a1 = max(a0 - 1, 0),
// d = deq[p], av = |dct[p]| in float32 and bits(a) the lone-value bits
// {0, 4.5, 5.5, 6.5, 6.5, 7.5, 7.5, 8.5, 9.5}[min(a, 8)]:
//   magnitude: q[p] -> sign * a1 where
//     fma(lam, bits(a1), (a1 d - av)^2) <= fma(lam, bits(a0), (a0 d - av)^2);
//   gain[p] = fma(av, av, -(d - av)^2);
//   two isolated sweeps: a +-1 whose neighbours are zero (position 1's left
//     and 63's right count as zero) goes to 0 where gain <= lam * 11; the
//     second sweep sees the first's kills;
//   four tail sweeps: the last nonzero AC value, if +-1, goes to 0 where
//     gain <= lam * 14 (|q| * d - av is d - av at |q| = 1).
// Exact float32: XLA on the CPU fuses exactly these three multiply-adds
// (testdata/make_qrd_fma_cases.py found which), written here as
// __fmaf_rn; the file is built with -fmad=false, so nvcc contracts
// nothing else. Every product that rounds is an explicit __fmul_rn.
//
// Bound: memory. Per pair the kernel reads 128 B of values, 128 B of DCT
// (shared by the K rows) and a flag, and writes 128 B of values, a count
// and a flag; its float32 work is ~20 operations per position. Design:
// 8 lanes per pair (K2's layout), 4 pairs per warp, 16 per CTA. Lane g
// loads positions 8g..8g+7 of the value and DCT rows as one 16-byte vector
// each, decides the magnitude step and the two kill conditions of its
// positions (they depend only on the inputs), and the lanes OR their
// 8-bit masks (nonzero, |value| == 1, isolated kill, tail kill) into
// 64-bit masks with three __shfl_xor_sync steps. The sweeps then are bit
// operations on those masks, the same on every lane of the pair: the
// neighbour tests are shifts, the tail's last nonzero AC position is a
// count of leading zeros. Each lane clears its killed values and stores its
// 16-byte vector; lane 0 writes the count (a popcount) and the flag. The
// dequant rows are staged in shared memory once per CTA.
//
// Segments: a launch may cover G segments of n blocks each (the mesh
// encoder's G GOPs at one frame step: N = G n blocks of one plane), each
// with its own K dequant rows ([G][K][2][64]) and lambdas lam[g][k][t];
// block b takes segment b / n. The segment is blockIdx.y, so a CTA stages
// one segment's rows; it reads the lambdas from the device's [G][K][2]
// array.
//
// Plain C interface (loaded with ctypes); launches on the caller's stream,
// allocates nothing and returns cudaGetLastError().
#include <cstdint>
#include <cuda_runtime.h>

namespace {

using u64 = unsigned long long;
constexpr int kMaxRows = 3;                      // qi rows per launch
constexpr int kLanes = 8;                        // lanes per pair
constexpr int kThreads = 128;
constexpr int kPairsPerCta = kThreads / kLanes;  // 16

__device__ __forceinline__ void unpack8(int4 v, int32_t x[8]) {
  const uint32_t w[4] = {(uint32_t)v.x, (uint32_t)v.y, (uint32_t)v.z,
                         (uint32_t)v.w};
#pragma unroll
  for (int j = 0; j < 4; j++) {
    x[2 * j] = (int32_t)(int16_t)(w[j] & 0xFFFF);
    x[2 * j + 1] = (int32_t)(int16_t)(w[j] >> 16);
  }
}

__device__ __forceinline__ int4 pack8(const int32_t x[8]) {
  uint32_t w[4];
#pragma unroll
  for (int j = 0; j < 4; j++)
    w[j] = ((uint32_t)x[2 * j] & 0xFFFF) | ((uint32_t)x[2 * j + 1] << 16);
  return make_int4(w[0], w[1], w[2], w[3]);
}

// Bits of a lone value of magnitude a (transforms_jax._MAG_BITS_J).
__device__ __forceinline__ float mag_bits(int a) {
  return a == 0 ? 0.0f
         : a == 1 ? 4.5f
         : a == 2 ? 5.5f
         : a <= 4 ? 6.5f
         : a <= 6 ? 7.5f
         : a == 7 ? 8.5f
                  : 9.5f;
}

// OR of a 64-bit mask over the 8 lanes of a pair.
__device__ __forceinline__ u64 or8(u64 x) {
#pragma unroll
  for (int s = 1; s < kLanes; s <<= 1)
    x |= __shfl_xor_sync(0xffffffffu, x, s);
  return x;
}

__global__ void __launch_bounds__(kThreads)
qrd_kernel(const int16_t* __restrict__ qrtn, const int16_t* __restrict__ dct,
           const int16_t* __restrict__ deq, const uint8_t* __restrict__ inter,
           const float* __restrict__ lams, int16_t* __restrict__ out,
           int32_t* __restrict__ cnt, uint8_t* __restrict__ dc_only,
           int64_t n, int nrows) {
  __shared__ __align__(16) int16_t s_deq[kMaxRows * 2 * 64];
  const int seg = blockIdx.y;
  const int g = threadIdx.x & (kLanes - 1);
  // The segment's (row, block) pairs, row-major; in the launch's [K, N]
  // arrays pair (k, i) is k * N + seg * n + i.
  const int64_t p =
      (int64_t)blockIdx.x * kPairsPerCta + (threadIdx.x / kLanes);
  // Lanes past the last pair take part in the shuffles with empty masks.
  const bool live = p < n * nrows;
  const int k = live ? (int)(p / n) : 0;
  const int64_t b = live ? (int64_t)seg * n + (p - (int64_t)k * n) : 0;
  const int64_t pair = (int64_t)k * n * gridDim.y + b;
  // The row's two lambdas, loaded while the rows are staged.
  const float2 lam2 =
      reinterpret_cast<const float2*>(lams)[(int64_t)seg * nrows + k];
  deq += (int64_t)seg * nrows * 128;
  for (int i = threadIdx.x; i < nrows * 128; i += kThreads) s_deq[i] = deq[i];
  __syncthreads();

  int32_t q[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  int32_t v[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  int32_t dq[8] = {1, 1, 1, 1, 1, 1, 1, 1};
  int t = 0;
  if (live) {
    unpack8(reinterpret_cast<const int4*>(qrtn)[pair * 8 + g], q);
    unpack8(reinterpret_cast<const int4*>(dct)[b * 8 + g], v);
    t = inter[b] ? 1 : 0;
    unpack8(*reinterpret_cast<const int4*>(s_deq + (k * 2 + t) * 64 + 8 * g),
            dq);
  }
  const float lam = t ? lam2.y : lam2.x;
  const float lam11 = __fmul_rn(lam, 11.0f);
  const float lam14 = __fmul_rn(lam, 14.0f);

  // The magnitude step and the kill conditions of lane g's positions.
  int32_t o[8];
  uint32_t nz = 0, one = 0, kiso = 0, ktail = 0;
#pragma unroll
  for (int j = 0; j < 8; j++) {
    const int a0 = q[j] < 0 ? -q[j] : q[j];
    const int a1 = a0 > 0 ? a0 - 1 : 0;
    const float d = (float)dq[j];
    const float av = (float)(v[j] < 0 ? -v[j] : v[j]);
    const float t0 = __fsub_rn(__fmul_rn((float)a0, d), av);
    const float t1 = __fsub_rn(__fmul_rn((float)a1, d), av);
    const bool take1 =
        __fmaf_rn(lam, mag_bits(a1 < 8 ? a1 : 8), __fmul_rn(t1, t1)) <=
        __fmaf_rn(lam, mag_bits(a0 < 8 ? a0 : 8), __fmul_rn(t0, t0));
    // DC (position 0 of lane 0) is never degraded.
    o[j] = (take1 && (g | j)) ? (q[j] < 0 ? -a1 : a1) : q[j];
    const float tc = __fsub_rn(d, av);
    const float gain = __fmaf_rn(av, av, -__fmul_rn(tc, tc));
    nz |= (uint32_t)(o[j] != 0) << j;
    one |= (uint32_t)(o[j] == 1 || o[j] == -1) << j;
    kiso |= (uint32_t)(gain <= lam11) << j;
    ktail |= (uint32_t)(gain <= lam14) << j;
  }
  const int sh = 8 * g;
  u64 M = or8((u64)nz << sh);
  u64 ONE = or8((u64)one << sh);
  const u64 KISO = or8((u64)kiso << sh);
  const u64 KTAIL = or8((u64)ktail << sh);

  // Two isolated sweeps: bit p of M << 1 is position p - 1 (position 1's
  // left neighbour, the DC, counts as zero); of M >> 1, position p + 1.
#pragma unroll
  for (int s = 0; s < 2; s++) {
    const u64 left = (M << 1) & ~2ull;
    const u64 iso = M & ONE & ~left & ~(M >> 1) & ~1ull;
    const u64 kill = iso & KISO;
    M &= ~kill;
    ONE &= ~kill;
  }
  // Four tail sweeps; a sweep that kills nothing leaves the next ones
  // nothing new to see.
  for (int s = 0; s < 4; s++) {
    const u64 ac = M & ~1ull;
    if (ac == 0) break;
    const u64 bit = 1ull << (63 - __clzll((long long)ac));
    if (!(ONE & KTAIL & bit)) break;
    M &= ~bit;
    ONE &= ~bit;
  }

  if (live) {
    const uint32_t keep = (uint32_t)(M >> sh) & 0xFF;
#pragma unroll
    for (int j = 0; j < 8; j++)
      if (!((keep >> j) & 1)) o[j] = 0;
    reinterpret_cast<int4*>(out)[pair * 8 + g] = pack8(o);
    if (g == 0) {
      cnt[pair] = __popcll(M);
      dc_only[pair] = (M & ~1ull) == 0;
    }
  }
}

}  // namespace

// qrtn [nrows, nseg n, 64], dct [nseg n, 64], deq [nseg, nrows, 2, 64]
// int16, inter [nseg n] uint8, lam [nseg, nrows, 2] float32;
// writes out [nrows, nseg n, 64] int16, cnt [nrows, nseg n] int32, dc_only
// [nrows, nseg n] bool. n is the blocks of one segment.
extern "C" int th_quantize_rd(const int16_t* qrtn, const int16_t* dct,
                              const int16_t* deq, const uint8_t* inter,
                              const float* lam, int16_t* out, int32_t* cnt,
                              uint8_t* dc_only, int64_t n, int nrows,
                              int nseg, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (nrows < 1 || nrows > kMaxRows || nseg < 1)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(
      (unsigned)((n * nrows + kPairsPerCta - 1) / kPairsPerCta),
      (unsigned)nseg);
  qrd_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      qrtn, dct, deq, inter, lam, out, cnt, dc_only, n, nrows);
  return (int)cudaGetLastError();
}
