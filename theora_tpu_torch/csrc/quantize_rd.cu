// Kernel KR: the encoder's R/D quantizer for NVIDIA Hopper (sm_90a).
//
// Replaces the JAX R/D quantizer theora_tpu/ops/transforms_jax.py:
// quantize_rd (:185), which the JAX encode scan runs in place of the
// trellis at speed levels 2-4 and with use_trellis=False
// (theora_tpu/encode/tpu_gop.py:230-236), once per qi row. It is not a
// Pallas kernel; XLA fuses it on the TPU. Plain PyTorch version:
// theora_tpu_torch/ops/transforms.py:quantize_rd_rows (quantize_rd_values
// behind the casts of this interface); of the fused entry,
// transforms.fdct_quantize_rd (fdct_quantize, then quantize_rd_rows).
//
// Interface (the standalone entry; the fused entry takes K2's inputs in
// place of its outputs and writes the same): kernel K2's outputs as K2
// writes them ([K, N, 64] int16
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
// Three entries, one row step (rd_row below: the magnitude step, the
// kill masks and the sweeps of one (row, block) pair on 8 lanes):
//
// th_fdct_quant_rd, the main path's entry: kernel K2's fDCT and
// round-to-nearest quantization (csrc/fdct_core.cuh, K2's block core)
// with KR's row step on the quantized values while they are in registers,
// in K2's CTA shape (8 lanes per block, 4 blocks per warp, 8 warps). The
// CTA stages its segment's dequant rows, their reciprocals and the K x 2
// lambdas in shared memory; per qi row k each lane quantizes its 8
// positions, runs the row step and stores its 16-byte vector, and lane 0
// of the block stores the count and the flag. Bytes per block: 128 B of
// residuals and 1 B of flag in, K x (128 + 4 + 1) B out; K2's K x 128 B
// of values and 128 B of DCT never reach device memory. What binds on
// the card is the integer pipe (64 lanes per clock per SM, half the float
// rate): each qi row adds ~350 integer, logic, compare, select and
// byte-permute instructions per lane, against ~90 float ones (static
// counts, tools/bench_qrd.py:sass_counts). A dead block at the grid's tail
// transforms zeros and runs the row step with the live lanes (its
// shuffles take the whole warp); only its stores are skipped.
//
// th_mc_fdct_quant_rd, the encode scan's entry at speed levels 2-4:
// th_fdct_quant_rd with kernel KS's MC as its head (csrc/mc_core.cuh:
// mc_residual_row makes each lane's residual row in registers where K2's
// core would load it, as in csrc/fdct_quant.cu's th_mc_fdct_quant);
// th_fdct_quant_rd stays as the chain it replaced and its test hook.
//
// th_quantize_rd, the standalone entry, kept as the test hook: the row
// step on round-to-nearest values and DCT rows given as K2 writes them, so
// that DCT values no residual can be chosen to reach (the FMA near-ties of
// testdata/vectors/qrd_fma_cases.npz, the edge classes) reach the same
// row step. 8 lanes per pair, 4 pairs per warp, 16 per CTA; lanes past
// the last pair take part in the shuffles with empty masks.
//
// The row step: lane g holds positions 8g..8g+7 (K2's layout) and
// decides the magnitude step of its positions (the lone-value bits looked
// up with one byte permute) and which kept +-1 values each sweep may kill
// (the tests depend only on the inputs). The lanes' three 8-bit masks
// (nonzero, killable by the isolated sweeps, killable by the tail sweeps)
// become 64-bit masks on every lane of the pair in three xor-shuffle
// rounds. The sweeps then are branch-free bit operations on those masks:
// the neighbour tests are shifts, the tail's last nonzero AC position is
// a count of leading zeros. Each lane clears its killed values.
//
// Segments: a launch may cover G segments of n blocks each (the mesh
// encoder's G GOPs at one frame step: N = G n blocks of one plane), each
// with its own K dequant rows ([G][K][2][64]) and lambdas lam[g][k][t];
// block b takes segment b / n. The segment is blockIdx.y, so a CTA stages
// one segment's rows and lambdas.
//
// Plain C interface (loaded with ctypes); launches on the caller's stream,
// allocates nothing and returns cudaGetLastError().
#include <cstdint>
#include <cuda_runtime.h>

#include "fdct_core.cuh"
#include "mc_core.cuh"

namespace {

using u64 = unsigned long long;
constexpr int kQrdThreads = 128;                    // standalone entry
constexpr int kPairsPerCta = kQrdThreads / kLanes;  // 16

// Twice the bits of a lone value of magnitude a (transforms_jax.
// _MAG_BITS_J): bytes a = 0..7 of kBits2Lo, kBits2Hi, picked by one byte
// permute, and 19 from a = 8 on.
constexpr uint32_t kBits2Lo = 0x0D0B0900u;  // a = 0..3: 0, 9, 11, 13
constexpr uint32_t kBits2Hi = 0x110F0F0Du;  // a = 4..7: 13, 15, 15, 17
constexpr int kBits2Max = 19;               // a >= 8

__device__ __forceinline__ float mag_bits2(int a) {
  return (float)(a >= 8 ? kBits2Max
                        : (int)__byte_perm(kBits2Lo, kBits2Hi, (unsigned)a));
}

// The 64-bit masks of a pair from its lanes' 8-bit ones: lane g's bytes
// nz, c1, c2 become byte g of NZ, C1, C2 on every lane of the pair. An
// all-gather in three xor-shuffle rounds (1, 2, then 3 words), the bytes
// put in place by byte permutes whose selectors depend on g alone.
__device__ __forceinline__ void gather8(uint32_t nz, uint32_t c1, uint32_t c2,
                                        int g, u64& NZ, u64& C1, u64& C2) {
  constexpr unsigned kAll = 0xffffffffu;
  // Round 1, lanes g and g ^ 1: p = [nz, c1] and r = [c2] of the two, the
  // even lane's byte first.
  const uint32_t w = nz | c1 << 8 | c2 << 16;
  const uint32_t w1 = __shfl_xor_sync(kAll, w, 1);
  const bool odd = g & 1;
  const uint32_t p = __byte_perm(w, w1, odd ? 0x1504 : 0x5140);
  const uint32_t r = __byte_perm(w, w1, odd ? 0x3326 : 0x3362);
  // Round 2, lanes g and g ^ 2: the four lanes' bytes of each mask.
  const uint32_t p2 = __shfl_xor_sync(kAll, p, 2);
  const uint32_t r2 = __shfl_xor_sync(kAll, r, 2);
  const bool second = g & 2;
  const uint32_t nzq = __byte_perm(p, p2, second ? 0x1054 : 0x5410);
  const uint32_t c1q = __byte_perm(p, p2, second ? 0x3276 : 0x7632);
  const uint32_t c2q = __byte_perm(r, r2, second ? 0x1054 : 0x5410);
  // Round 3, lanes g and g ^ 4: lanes 0-3 give the low word.
  const uint32_t nzo = __shfl_xor_sync(kAll, nzq, 4);
  const uint32_t c1o = __shfl_xor_sync(kAll, c1q, 4);
  const uint32_t c2o = __shfl_xor_sync(kAll, c2q, 4);
  const bool high = g & 4;
  NZ = high ? (u64)nzo | (u64)nzq << 32 : (u64)nzq | (u64)nzo << 32;
  C1 = high ? (u64)c1o | (u64)c1q << 32 : (u64)c1q | (u64)c1o << 32;
  C2 = high ? (u64)c2o | (u64)c2q << 32 : (u64)c2q | (u64)c2o << 32;
}

// What the row step keeps of one (row, block) pair.
struct RowKept {
  u64 mask;      // bit p: position p is nonzero (the same on every lane)
  int count;     // nonzero values, DC included
  bool dc_only;  // no AC value is nonzero
};

// KR's row step on lane g's positions 8g..8g+7 of one pair: q the
// round-to-nearest values, av the DCT's magnitudes and d the dequant
// factors in float32, lam the pair's lambda. Writes the kept values to o.
// Every lane of the warp must call it (full-warp shuffles).
__device__ __forceinline__ RowKept rd_row(const int32_t q[8],
                                          const float av[8],
                                          const float d[8], float lam,
                                          int g, int32_t o[8]) {
  // fma(lam, bits, e) == fma(lam / 2, 2 bits, e): halving is exact.
  const float lamh = __fmul_rn(lam, 0.5f);
  const float lam11 = __fmul_rn(lam, 11.0f);
  const float lam14 = __fmul_rn(lam, 14.0f);

  // The magnitude step, then which kept +-1 values the isolated (c1) and
  // the tail (c2) sweeps may kill. A kill zeroes a value in both masks, so
  // each sweep's test of |value| == 1 is the same on the masks it starts
  // from.
  uint32_t nzm = 0, c1 = 0, c2 = 0;
#pragma unroll
  for (int j = 0; j < 8; j++) {
    const int a0 = q[j] < 0 ? -q[j] : q[j];
    const int a1 = a0 > 0 ? a0 - 1 : 0;
    const float t0 = __fsub_rn(__fmul_rn((float)a0, d[j]), av[j]);
    const float t1 = __fsub_rn(__fmul_rn((float)a1, d[j]), av[j]);
    const bool take1 =
        __fmaf_rn(lamh, mag_bits2(a1), __fmul_rn(t1, t1)) <=
        __fmaf_rn(lamh, mag_bits2(a0), __fmul_rn(t0, t0));
    // DC (position 0 of lane 0) is never degraded.
    o[j] = (take1 && (g | j)) ? (q[j] < 0 ? -a1 : a1) : q[j];
    const float tc = __fsub_rn(d[j], av[j]);
    const float gain = __fmaf_rn(av[j], av[j], -__fmul_rn(tc, tc));
    const bool one = (o[j] == 1 || o[j] == -1) && (g | j);
    nzm |= (uint32_t)(o[j] != 0) << j;
    c1 |= (uint32_t)(one && gain <= lam11) << j;
    c2 |= (uint32_t)(one && gain <= lam14) << j;
  }
  u64 M, C1, C2;
  gather8(nzm, c1, c2, g, M, C1, C2);

  // Two isolated sweeps: bit p of M << 1 is position p - 1 (position 1's
  // left neighbour, the DC, counts as zero); of M >> 1, position p + 1.
#pragma unroll
  for (int s = 0; s < 2; s++)
    M &= ~(C1 & ~(((M << 1) & ~2ull) | (M >> 1)));
  // Four tail sweeps: the last nonzero AC value goes where C2 allows; a
  // sweep that kills nothing leaves the next ones nothing new to see.
#pragma unroll
  for (int s = 0; s < 4; s++) {
    const u64 ac = M & ~1ull;
    const u64 top = ac ? 1ull << (63 - __clzll((long long)ac)) : 0ull;
    M &= ~(top & C2);
  }

  const uint32_t keep = (uint32_t)(M >> (8 * g)) & 0xFF;
#pragma unroll
  for (int j = 0; j < 8; j++)
    if (!((keep >> j) & 1)) o[j] = 0;
  return {M, __popcll(M), (M & ~1ull) == 0};
}

// At least 3 CTAs per SM: with no minimum ptxas held K = 2 and 3 to 64
// registers and spilled at K = 2; this way they take 72, no spill.
template <int K, bool MC>
__global__ void __launch_bounds__(kThreads, 3)
fdct_qrd_kernel(const int16_t* __restrict__ res, McSrc mc,
                const int16_t* __restrict__ deq,
                const uint8_t* __restrict__ inter,
                const float* __restrict__ lams, int16_t* __restrict__ out,
                int32_t* __restrict__ cnt, uint8_t* __restrict__ dc_only,
                int64_t n) {
  __shared__ BlockArea areas[kBlocksPerCta];
  // The segment's K qi rows [k][inter][z], their reciprocals and lambdas
  // [k][inter].
  __shared__ __align__(16) int16_t s_deq[K * 2 * 64];
  __shared__ __align__(16) uint32_t s_rcp[K * 2 * 64];
  __shared__ float s_lam[K * 2];

  const int tid = threadIdx.x;
  const int64_t seg = blockIdx.y;
  stage_rows<K>(deq + seg * (K * 2 * 64), s_deq, s_rcp);
  if (tid < K * 2) s_lam[tid] = lams[seg * (K * 2) + tid];
  __syncthreads();

  const int c = tid & (kLanes - 1);
  const int lb = tid / kLanes;
  const int64_t local = (int64_t)blockIdx.x * kBlocksPerCta + lb;
  const bool live = local < n;
  const int64_t b = seg * n + local;  // block of the launch
  const int64_t total = n * gridDim.y;

  int32_t v[8];
  if (MC)
    block_dct_row(live ? mc_residual_row(mc, seg, local, b, total, c)
                       : make_int4(0, 0, 0, 0),
                  areas[lb], c, v);
  else
    block_dct(res, areas[lb], b, c, live, v);
  const int t = (live && inter[b]) ? 1 : 0;
  float av[8];
#pragma unroll
  for (int j = 0; j < 8; j++) av[j] = (float)(v[j] < 0 ? -v[j] : v[j]);
#pragma unroll
  for (int k = 0; k < K; k++) {
    int32_t d[8], q[8], o[8];
    quantize8(v, s_deq, s_rcp, (k * 2 + t) * 64 + 8 * c, d, q);
    float df[8];
#pragma unroll
    for (int j = 0; j < 8; j++) df[j] = (float)d[j];
    const RowKept r = rd_row(q, av, df, s_lam[k * 2 + t], c, o);
    if (live) {
      const int64_t pair = (int64_t)k * total + b;
      reinterpret_cast<int4*>(out)[pair * 8 + c] = pack8(o);
      if (c == 0) {
        cnt[pair] = r.count;
        dc_only[pair] = r.dc_only;
      }
    }
  }
}

__global__ void __launch_bounds__(kQrdThreads)
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
  for (int i = threadIdx.x; i < nrows * 128; i += kQrdThreads)
    s_deq[i] = deq[i];
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
  float av[8], df[8];
#pragma unroll
  for (int j = 0; j < 8; j++) {
    av[j] = (float)(v[j] < 0 ? -v[j] : v[j]);
    df[j] = (float)dq[j];
  }
  int32_t o[8];
  const RowKept r = rd_row(q, av, df, t ? lam2.y : lam2.x, g, o);
  if (live) {
    reinterpret_cast<int4*>(out)[pair * 8 + g] = pack8(o);
    if (g == 0) {
      cnt[pair] = r.count;
      dc_only[pair] = r.dc_only;
    }
  }
}

template <bool MC>
int launch_fused(const int16_t* res, const McSrc& mc, const int16_t* deq,
                 const uint8_t* inter, const float* lam, int16_t* out,
                 int32_t* cnt, uint8_t* dc_only, int64_t n, int k, int nseg,
                 void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (k < 1 || k > kMaxRows || nseg < 1 || nseg > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((n + kBlocksPerCta - 1) / kBlocksPerCta),
                  (unsigned)nseg);
  cudaStream_t s = (cudaStream_t)stream;
  if (k == 1)
    fdct_qrd_kernel<1, MC><<<grid, kThreads, 0, s>>>(
        res, mc, deq, inter, lam, out, cnt, dc_only, n);
  else if (k == 2)
    fdct_qrd_kernel<2, MC><<<grid, kThreads, 0, s>>>(
        res, mc, deq, inter, lam, out, cnt, dc_only, n);
  else
    fdct_qrd_kernel<3, MC><<<grid, kThreads, 0, s>>>(
        res, mc, deq, inter, lam, out, cnt, dc_only, n);
  return (int)cudaGetLastError();
}

}  // namespace

// res [nseg n, 64] int16, deq [nseg, k, 2, 64] int16, inter [nseg n]
// uint8, lam [nseg, k, 2] float32; writes out [k, nseg n, 64] int16, cnt
// [k, nseg n] int32, dc_only [k, nseg n] bool: kernel K2's function
// followed by th_quantize_rd's, in one launch. n is the blocks of one
// segment.
extern "C" int th_fdct_quant_rd(const int16_t* res, const int16_t* deq,
                                const uint8_t* inter, const float* lam,
                                int16_t* out, int32_t* cnt,
                                uint8_t* dc_only, int64_t n, int k, int nseg,
                                void* stream) {
  return launch_fused<false>(res, McSrc{}, deq, inter, lam, out, cnt,
                             dc_only, n, k, nseg, stream);
}

// th_fdct_quant_rd with the residual made in the kernel by KS's MC
// (csrc/mc_core.cuh), as th_mc_residual makes it: prev, gold [nseg][Hp]
// [Wp] uint8 (8-byte aligned; may be one buffer), cur [nseg n][64] uint8
// (8-byte aligned), side [6][nseg n] int8, fid [n] int32 or null (then
// n = nv nh): block b of segment g is fragment fid[b % n] (or b % n) of
// plane g.
extern "C" int th_mc_fdct_quant_rd(const uint8_t* prev, const uint8_t* gold,
                                   const uint8_t* cur, const int8_t* side,
                                   const int32_t* fid, const int16_t* deq,
                                   const uint8_t* inter, const float* lam,
                                   int16_t* out, int32_t* cnt,
                                   uint8_t* dc_only, int64_t n, int k,
                                   int nseg, int Hp, int Wp, int nv, int nh,
                                   int pad_y, int pad_x, void* stream) {
  const Geo q{nv, nh, pad_y, pad_x, Hp, Wp};
  if (bad_geometry(nseg, q) || (!fid && n != (int64_t)nv * nh) ||
      n * nseg > (1L << 27) || misaligned(prev, 8) || misaligned(gold, 8) ||
      misaligned(cur, 8))
    return (int)cudaErrorInvalidValue;
  return launch_fused<true>(nullptr, McSrc{prev, gold, cur, side, fid, q},
                            deq, inter, lam, out, cnt, dc_only, n, k, nseg,
                            stream);
}

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
  qrd_kernel<<<grid, kQrdThreads, 0, (cudaStream_t)stream>>>(
      qrtn, dct, deq, inter, lam, out, cnt, dc_only, n, nrows);
  return (int)cudaGetLastError();
}
