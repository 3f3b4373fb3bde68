// Kernel K1: dequantization + 8x8 integer iDCT, for NVIDIA Hopper (sm_90a),
// with two entry points over one block core.
//
// Replaces the Pallas kernel theora_tpu/ops/pallas_kernels.py:idct8x8_soa
// (body _idct_kernel) together with the steps the JAX scans wrap around it.
//
// th_dequant_idct, the decode scan's step (theora_tpu/decode/tpu_batch.py:
// 85-106, transforms_jax.dequantize_idct). Per 8x8 block b (natural order
// index k = 8*row + col, zig-zag index z):
//   x[k]   = i16(qz[b][z] * tab[frame[b]][qii[b]][inter[b]][z])   (k != 0)
//   x[0]   = i16(dc[b] * dcq),  dcq = tab[frame[b]][0][inter[b]][0]
//   y      = column iDCT of row iDCT of x, i16 wrap at every butterfly
//            (idct.c:30-81, 285-296); out = i16((y + 8) >> 4)
//   dc_only blocks: out = i16((dc[b] * dcq + 15) >> 5)   (state.c:967-975)
// Plain PyTorch version: theora_tpu_torch/ops/transforms.py:
// dequantize_idct_frames.
//
// th_idct_recon_choose, the encode scan's step after the trellis
// (theora_tpu/encode/tpu_gop.py:231-285). Per block b and qi row k < K:
//   res_k  = the residual above from the row's values q[k][b] (DC slot
//            included: the DC factor deq[k][inter][0] is the base qi's in
//            every row) and its dequant row deq[k][inter[b]]
//   rec_k  = clamp(res_k + pred[b], 0, 255);  ssd_k = sum (rec_k - cur)^2
//   cost_k = 16 ssd_k + trunc(lam_b * (6 cnt[k][b] + 2 [+ 6 for k > 0]))
//            lam_b = lam * lam_sc[b] (lam alone without scales), float32,
//            one rounding per operation, in that order
// and the block keeps the row of least cost, the earlier row on a tie: its
// reconstruction, SSD, row index, values and count. A launch may cover G
// segments of n blocks (the mesh encoder's G GOPs at one frame step), each
// with its own K dequant rows and lambda: block b takes segment b / n, which
// is blockIdx.y. Plain PyTorch version: transforms.idct_recon_choose. The float32 operations are plain operators;
// the library is built with -fmad=false (ops/idct_cuda.py:NVCC_FLAGS), so
// nvcc contracts none of them, and the float-to-int conversion is
// __float2int_rz (truncation, as the CPU's cast).
//
// All integer arithmetic is int32 with an explicit 16-bit wrap; every
// product stays below 2^31 in magnitude; right shifts of negative values
// are arithmetic, as in JAX.
//
// Bound: memory. The decode entry reads per block 128 B of coefficients
// (none for a DC-only block), 2 B of DC, 4 B of frame index and 3 B of
// flags and writes 128 B of residuals; the encode entry reads K x 128 B of
// values, K x 5 B of flags and counts, 256 B of prediction and 64 B of
// source and writes 201 B at K = 3 (tools/bench_idct.py:k1_bytes); both do
// ~2,100 int32 operations per block, far below the card's operations per
// byte. Design, as kernel K2's (fdct_quant.cu): 8 lanes per block, 4 blocks
// per warp, K1_WARPS warps per CTA; a block's work stays inside its 8
// lanes (shared memory between __syncwarp()s of the group's mask, so a
// DC-only block can skip both passes). Lane c loads zig-zag positions
// 8c..8c+7 of the values and of the dequant row as one 16-byte vector
// each, dequantizes in registers and scatters to natural order (indices
// from an 8-byte vector of a global table, not a divergent __constant__
// read); the row pass and the column pass read rows of 9 words, so their
// column reads hit distinct banks, and a block's area of 168 words puts
// the 4 blocks of a warp 8 banks apart; residuals leave as 16-byte raster
// rows. The encode entry loops over the K rows in registers: the
// prediction row and source row are loaded once, the SSD is summed over
// the 8 lanes with __shfl_xor_sync, and the kept row's reconstruction
// (8 bytes a lane) and values (16 bytes a lane) are written once.
//
// th_mc_idct_recon_skip, the encode scan's entry since kernel KS was
// fused into it: the same chooser (choose_row) with KS's row core
// (csrc/mc_core.cuh) around it. Lane c makes its prediction row with KS's
// MC (8 bytes from the reference planes) in place of loading 32 B of the
// int32 prediction, loads prev's row c at zero motion and sums the
// uncoded copy's SSD over the block's 8 lanes, and after the chooser runs
// KS's skip test on the kept row (JAX tpu_gop.py:286-293: the frame's
// lambda without the per-block scale, __fmul_rn then __float2int_rz, ties
// skip, a key step codes every block), writes qout (the kept values where
// coded, else 0), coded and qii in place, and puts the kept row (the
// reconstruction, or prev's row) into a new padded plane with KS's
// put_row (the UMV borders where the step is not filtered, else zeros),
// or, over a frag group, into the all-gather's [N][65] rows. The first
// and last rows for the borders come by shuffles inside the block's
// 8-lane group mask, since a group past the launch's last block leaves
// early. It writes no reconstruction, SSD, kept values or count of its
// own: per block K x 128 B of values, K x 5 B of flags and counts, 64 B
// of source, the reference rows its MC reads and (on an inter step)
// prev's 64 B in; 128 B of qout, 2 B of flags and the plane's bytes out
// (tools/bench_mc.py:fused_bound). Plain version: ops/mc.py:mc_residual,
// transforms.idct_recon_choose, then ops/mc.py:skip_place or skip_rows.
//
// Plain C interface (loaded with ctypes); launches on the caller's stream,
// allocates nothing and returns cudaGetLastError().
#include <cstdint>
#include <cuda_runtime.h>

#include "mc_core.cuh"

namespace {

constexpr int kMaxRows = 3;            // qi rows per encode launch
constexpr int kLanes = 8;              // lanes per 8x8 block
constexpr int kGroups = 32 / kLanes;   // blocks per warp
// Warps per CTA; tools/bench_idct.py --warps builds other shapes.
#ifndef K1_WARPS
#define K1_WARPS 8
#endif
constexpr int kWarps = K1_WARPS;
constexpr int kBlocksPerCta = kWarps * kGroups;
constexpr int kThreads = kWarps * 32;

constexpr int C1S7 = 64277, C2S6 = 60547, C3S5 = 54491, C4S4 = 46341,
              C5S3 = 36410, C6S2 = 25080, C7S1 = 12785;

// Zig-zag index -> row-major coefficient index; lane c reads bytes
// 8c..8c+7 as one 8-byte vector.
__device__ __align__(16) const uint8_t kZigToNat[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// One 8x8 block's shared memory: 168 words, so the 4 blocks of a warp sit
// 8 banks apart.
struct BlockArea {
  int32_t a[72];  // natural-order coefficients, then the column pass's
                  // output; rows of 9 words
  int32_t w[72];  // the row pass's output, rows of 9 words
  int32_t pad[24];
};

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

// The 8-lane group of this thread: lane c of the block, and the mask of
// the group's lanes within the warp.
__device__ __forceinline__ unsigned group_mask(int tid) {
  return 0xFFu << (tid & 24);
}

// Block core: lane c holds the dequantized values x[0..7] of zig-zag
// positions 8c..8c+7 and gets back raster row c of the residual. Only the
// group's 8 lanes take part; the area is free again on return.
__device__ __forceinline__ void idct_block(BlockArea& A, int c,
                                           unsigned mask, const int32_t x[8],
                                           int32_t res[8]) {
  const uint2 zn = __ldg(reinterpret_cast<const uint2*>(kZigToNat) + c);
#pragma unroll
  for (int j = 0; j < 8; j++) {
    const int nat = ((j < 4 ? zn.x : zn.y) >> (8 * (j & 3))) & 0xFF;
    A.a[(nat >> 3) * 9 + (nat & 7)] = x[j];
  }
  __syncwarp(mask);
  int32_t v[8];
#pragma unroll
  for (int j = 0; j < 8; j++) v[j] = A.a[c * 9 + j];
  idct8(v);  // row c
#pragma unroll
  for (int j = 0; j < 8; j++) A.w[c * 9 + j] = v[j];
  __syncwarp(mask);
#pragma unroll
  for (int i = 0; i < 8; i++) v[i] = A.w[i * 9 + c];
  idct8(v);  // column c
#pragma unroll
  for (int i = 0; i < 8; i++) A.a[i * 9 + c] = i16((v[i] + 8) >> 4);
  __syncwarp(mask);
#pragma unroll
  for (int j = 0; j < 8; j++) res[j] = A.a[c * 9 + j];
  __syncwarp(mask);
}

__device__ __forceinline__ void fill8(int32_t res[8], int32_t v) {
#pragma unroll
  for (int j = 0; j < 8; j++) res[j] = v;
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
  __shared__ BlockArea areas[kBlocksPerCta];
  const int tid = threadIdx.x;
  const int c = tid & (kLanes - 1);
  const int lb = tid / kLanes;
  const int64_t b = (int64_t)blockIdx.x * kBlocksPerCta + lb;
  if (b >= n) return;  // the group's 8 lanes leave together
  const int64_t f = frame[b];
  const int it = inter[b] ? 1 : 0;
  const int32_t dcq = tab[(f * 6 + it) * 64];
  const int32_t dcv = dc[b];
  int32_t res[8];
  if (dc_only[b]) {
    fill8(res, i16((dcv * dcq + 15) >> 5));
  } else {
    int32_t q[8], d[8], x[8];
    unpack8(__ldg(reinterpret_cast<const int4*>(qz) + b * 8 + c), q);
    unpack8(__ldg(reinterpret_cast<const int4*>(
                tab + ((f * 3 + qii[b]) * 2 + it) * 64) + c), d);
#pragma unroll
    for (int j = 0; j < 8; j++) x[j] = i16(q[j] * d[j]);
    if (c == 0) x[0] = i16(dcv * dcq);
    idct_block(areas[lb], c, group_mask(tid), x, res);
  }
  reinterpret_cast<int4*>(out)[b * 8 + c] = pack8(res);
}

// The kept row of one block: its reconstruction (lane c's raster row c,
// 8 bytes), values (zig-zag 8c..8c+7), SSD, row index and count.
struct Kept {
  uint2 rec;
  int4 q;
  int32_t ssd, k, cnt;
};

// The chooser of block b (segment seg of the launch's total blocks) on
// lane c of its 8-lane group (mask): each of the K rows dequantized and
// transformed, reconstructed on the prediction row p and held against the
// source row s; the row of least cost, the earlier on a tie.
template <int K>
__device__ __forceinline__ Kept choose_row(
    const int16_t* __restrict__ q16, const uint8_t* __restrict__ dc_only,
    const int32_t* __restrict__ cnt, const int16_t* __restrict__ deq,
    int it, int64_t b, int64_t total, int c, unsigned mask, BlockArea& A,
    const int32_t p[8], const int32_t s[8], float lam_b) {
  // Every load of the block's rows up front: values, flags, counts and
  // dequant rows.
  int4 qv[K], dv[K];
  int32_t dco[K], ck[K];
#pragma unroll
  for (int k = 0; k < K; k++) {
    const int64_t kb = (int64_t)k * total + b;
    qv[k] = __ldg(reinterpret_cast<const int4*>(q16) + kb * 8 + c);
    dv[k] = __ldg(reinterpret_cast<const int4*>(deq + (k * 2 + it) * 64) +
                  c);
    dco[k] = dc_only[kb];
    ck[k] = cnt[kb];
  }
  int32_t best_cost = 0;
  Kept best{make_uint2(0, 0), make_int4(0, 0, 0, 0), 0, 0, 0};
#pragma unroll
  for (int k = 0; k < K; k++) {
    int32_t q[8], d[8], res[8];
    unpack8(qv[k], q);
    unpack8(dv[k], d);
    if (dco[k]) {
      // Slot 0 of lane 0 holds the row's DC value and its factor.
      const int32_t dcv = __shfl_sync(mask, q[0], 0, kLanes);
      const int32_t dcq = __shfl_sync(mask, d[0], 0, kLanes);
      fill8(res, i16((dcv * dcq + 15) >> 5));
    } else {
      int32_t x[8];
#pragma unroll
      for (int j = 0; j < 8; j++) x[j] = i16(q[j] * d[j]);
      idct_block(A, c, mask, x, res);
    }
    int32_t e2 = 0;
    uint32_t rw[2] = {0, 0};
#pragma unroll
    for (int j = 0; j < 8; j++) {
      const int32_t r = min(max(res[j] + p[j], 0), 255);
      const int32_t e = r - s[j];
      e2 += e * e;
      rw[j >> 2] |= (uint32_t)r << (8 * (j & 3));
    }
    e2 += __shfl_xor_sync(mask, e2, 1);
    e2 += __shfl_xor_sync(mask, e2, 2);
    e2 += __shfl_xor_sync(mask, e2, 4);
    const float ckf = (float)ck[k];
    const float m = k == 0 ? 6.0f * ckf + 2.0f : 6.0f * ckf + 2.0f + 6.0f;
    const int32_t cost = 16 * e2 + __float2int_rz(lam_b * m);
    if (k == 0 || cost < best_cost) {
      best_cost = cost;
      best = {make_uint2(rw[0], rw[1]), qv[k], e2, k, ck[k]};
    }
  }
  return best;
}

// The 8 bytes of a raster row as 8 int32.
__device__ __forceinline__ void bytes8(uint64_t w, int32_t s[8]) {
#pragma unroll
  for (int j = 0; j < 8; j++) s[j] = (int32_t)((w >> (8 * j)) & 0xFF);
}

template <int K>
__global__ void __launch_bounds__(kThreads)
idct_recon_choose_kernel(const int16_t* __restrict__ q16,
                         const uint8_t* __restrict__ dc_only,
                         const int32_t* __restrict__ cnt,
                         const int16_t* __restrict__ deq,
                         const uint8_t* __restrict__ inter,
                         const int32_t* __restrict__ pred,
                         const uint8_t* __restrict__ cur,
                         const float* __restrict__ lam,
                         const float* __restrict__ lam_sc,
                         uint8_t* __restrict__ recon,
                         int32_t* __restrict__ ssd,
                         uint8_t* __restrict__ qii,
                         int16_t* __restrict__ qsel,
                         int32_t* __restrict__ cnt_sel, int64_t n) {
  __shared__ BlockArea areas[kBlocksPerCta];
  const int tid = threadIdx.x;
  const int c = tid & (kLanes - 1);
  const int lb = tid / kLanes;
  const int64_t local = (int64_t)blockIdx.x * kBlocksPerCta + lb;
  if (local >= n) return;  // the group's 8 lanes leave together
  const int64_t seg = blockIdx.y;
  const int64_t b = seg * n + local;  // block of the launch
  const int64_t total = n * gridDim.y;
  const int it = inter[b] ? 1 : 0;

  // Raster row c of the prediction and of the source.
  const int4 p0 = __ldg(reinterpret_cast<const int4*>(pred) + b * 16 + 2 * c);
  const int4 p1 =
      __ldg(reinterpret_cast<const int4*>(pred) + b * 16 + 2 * c + 1);
  const uint2 cu = __ldg(reinterpret_cast<const uint2*>(cur) + b * 8 + c);
  const int32_t p[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
  int32_t s[8];
  bytes8((uint64_t)cu.x | (uint64_t)cu.y << 32, s);
  float lam_b = lam[seg];
  if (lam_sc != nullptr) lam_b = lam_b * lam_sc[b];

  const Kept kept =
      choose_row<K>(q16, dc_only, cnt, deq + seg * (K * 2 * 64), it, b, total,
                    c, group_mask(tid), areas[lb], p, s, lam_b);
  reinterpret_cast<uint2*>(recon)[b * 8 + c] = kept.rec;
  if (K > 1) reinterpret_cast<int4*>(qsel)[b * 8 + c] = kept.q;
  if (c == 0) {
    ssd[b] = kept.ssd;
    qii[b] = (uint8_t)kept.k;
    if (K > 1) cnt_sel[b] = kept.cnt;
  }
}

// The encode scan's step after the quantizer with KS's MC, skip test and
// plane assembly fused: the prediction row made by KS's MC row, the
// chooser, the uncoded copy's SSD, the skip test on the kept row and the
// kept block put into the new plane (or, over a frag group, the gather's
// rows).
template <int K>
__global__ void __launch_bounds__(kThreads)
mc_idct_recon_skip_kernel(const int16_t* __restrict__ q16,
                          const uint8_t* __restrict__ dc_only,
                          const int32_t* __restrict__ cnt,
                          const int16_t* __restrict__ deq,
                          const uint8_t* __restrict__ inter, McSrc mc,
                          const bool* __restrict__ ms,
                          const float* __restrict__ lam,
                          const float* __restrict__ lam_sc, int intra,
                          int16_t* __restrict__ qout,
                          bool* __restrict__ coded,
                          uint8_t* __restrict__ qii,
                          uint8_t* __restrict__ plane,
                          uint8_t* __restrict__ rows, int borders,
                          int64_t n) {
  __shared__ BlockArea areas[kBlocksPerCta];
  const int tid = threadIdx.x;
  const int c = tid & (kLanes - 1);
  const int lb = tid / kLanes;
  const int64_t local = (int64_t)blockIdx.x * kBlocksPerCta + lb;
  if (local >= n) return;  // the group's 8 lanes leave together
  const int64_t seg = blockIdx.y;
  const int64_t b = seg * n + local;  // block of the launch
  const int64_t total = n * gridDim.y;
  const unsigned mask = group_mask(tid);
  const int it = inter[b] ? 1 : 0;

  // Raster row c of the source, of the prediction and, on an inter step,
  // of prev's block at zero motion (the uncoded copy).
  const McFrag fr = mc_frag(mc, seg, local);
  const uint64_t cw = load8a(mc.cur + b * 64 + 8 * c);
  const uint64_t pw = predict_row(fr.prev, fr.gold, mc.side, (int)total,
                                  (int)b, mc.q, fr.r, fr.c, c);
  const uint64_t uw =
      intra ? 0
            : load8a(fr.prev + (size_t)(mc.q.pad_y + 8 * fr.r + c) * mc.q.Wp +
                     mc.q.pad_x + 8 * fr.c);
  int32_t p[8], s[8];
  bytes8(pw, p);
  bytes8(cw, s);
  float lam_b = lam[seg];
  if (lam_sc != nullptr) lam_b = lam_b * lam_sc[b];

  const Kept kept =
      choose_row<K>(q16, dc_only, cnt, deq + seg * (K * 2 * 64), it, b, total,
                    c, mask, areas[lb], p, s, lam_b);

  // The skip test (JAX tpu_gop.py:286-293): coded = intra or !(ms and
  // 16 ssd_unc <= 16 ssd_rec + lamterm), lamterm = trunc(lam * (6 cnt +
  // 2)) in float32 with the kept row's count and the frame's lambda (no
  // per-block scale); 6 cnt + 2 is exact, the product rounds once.
  bool cd = true;
  if (!intra) {
    int32_t u2 = 0;
#pragma unroll
    for (int j = 0; j < 8; j++) {
      const int32_t e = (int32_t)((uw >> (8 * j)) & 0xFF) - s[j];
      u2 += e * e;
    }
    u2 += __shfl_xor_sync(mask, u2, 1);
    u2 += __shfl_xor_sync(mask, u2, 2);
    u2 += __shfl_xor_sync(mask, u2, 4);
    const int32_t lt = __float2int_rz(
        __fmul_rn(lam[seg], __int2float_rn(6 * kept.cnt + 2)));
    cd = !(ms[b] && 16 * u2 <= 16 * kept.ssd + lt);
  }
  reinterpret_cast<int4*>(qout)[b * 8 + c] =
      cd ? kept.q : make_int4(0, 0, 0, 0);
  if (c == 0) {
    coded[b] = cd;
    qii[b] = (uint8_t)kept.k;
  }
  const uint64_t v =
      cd ? (uint64_t)kept.rec.x | (uint64_t)kept.rec.y << 32 : uw;
  if (rows) {
    put_gather_row(rows + b * 65, c, v, cd);
    return;
  }
  // The group's first and last rows for the top and bottom borders.
  const uint64_t top = __shfl_sync(mask, v, 0, kLanes);
  const uint64_t bot = __shfl_sync(mask, v, 7, kLanes);
  put_row(plane + seg * plane_bytes(mc.q), mc.q, fr.r, fr.c, c, v, top, bot,
          borders != 0);
}

unsigned grid_of(int64_t n) {
  return (unsigned)((n + kBlocksPerCta - 1) / kBlocksPerCta);
}

}  // namespace

extern "C" int th_dequant_idct(const int16_t* qz, const int16_t* dc,
                               const int16_t* tab, const int32_t* frame,
                               const uint8_t* qii, const uint8_t* inter,
                               const uint8_t* dc_only, int16_t* out,
                               int64_t n, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  dequant_idct_kernel<<<grid_of(n), kThreads, 0, (cudaStream_t)stream>>>(
      qz, dc, tab, frame, qii, inter, dc_only, out, n);
  return (int)cudaGetLastError();
}

// q16 [k, nseg n, 64] int16, dc_only [k, nseg n] bool, cnt [k, nseg n]
// int32, deq [nseg, k, 2, 64] int16, inter [nseg n] uint8, pred [nseg n,
// 64] int32, cur [nseg n, 64] uint8, lam [nseg] float32, lam_sc [nseg n]
// float32 or null; writes recon [nseg n, 64] uint8, ssd [nseg n] int32, qii
// [nseg n] uint8 and, for k > 1, qsel [nseg n, 64] int16 and cnt_sel [nseg
// n] int32 (at k = 1 they are row 0 of q16 and cnt, and may be null). n is
// the blocks of one segment.
extern "C" int th_idct_recon_choose(
    const int16_t* q16, const uint8_t* dc_only, const int32_t* cnt,
    const int16_t* deq, const uint8_t* inter, const int32_t* pred,
    const uint8_t* cur, const float* lam, const float* lam_sc,
    uint8_t* recon, int32_t* ssd, uint8_t* qii, int16_t* qsel,
    int32_t* cnt_sel, int64_t n, int k, int nseg, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (k < 1 || k > kMaxRows || nseg < 1 || nseg > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid(grid_of(n), (unsigned)nseg);
  if (k == 1)
    idct_recon_choose_kernel<1><<<grid, kThreads, 0, s>>>(
        q16, dc_only, cnt, deq, inter, pred, cur, lam, lam_sc, recon, ssd,
        qii, qsel, cnt_sel, n);
  else if (k == 2)
    idct_recon_choose_kernel<2><<<grid, kThreads, 0, s>>>(
        q16, dc_only, cnt, deq, inter, pred, cur, lam, lam_sc, recon, ssd,
        qii, qsel, cnt_sel, n);
  else
    idct_recon_choose_kernel<3><<<grid, kThreads, 0, s>>>(
        q16, dc_only, cnt, deq, inter, pred, cur, lam, lam_sc, recon, ssd,
        qii, qsel, cnt_sel, n);
  return (int)cudaGetLastError();
}

// th_idct_recon_choose with KS's MC before it and KS's skip test and plane
// assembly after it (csrc/mc_core.cuh), in one launch: the prediction made
// from prev, gold [nseg][Hp][Wp] uint8 (8-byte aligned; may be one
// buffer), cur [nseg n][64] uint8 and side [6][nseg n] int8 as
// th_mc_residual makes it; ms [nseg n] bool, lam [nseg] float32 (the
// chooser's and the skip test's), lam_sc [nseg n] float32 or null (the
// chooser's only), intra. Writes qout [nseg n, 64] int16 (the kept row's
// values where coded, else 0), coded [nseg n] bool, qii [nseg n] uint8
// and exactly one of: plane [nseg][Hp][Wp] (new, 8-byte aligned; fid
// null: n = nv nh, every fragment), its padding the UMV borders when
// borders, else zeros; rows [nseg n][65] uint8, each kept block's pixels
// and coded flag (the frag group's all-gather input; fid [n] int32 or
// null: block b of segment g is fragment fid[b % n] (or b % n)).
extern "C" int th_mc_idct_recon_skip(
    const int16_t* q16, const uint8_t* dc_only, const int32_t* cnt,
    const int16_t* deq, const uint8_t* inter, const uint8_t* prev,
    const uint8_t* gold, const uint8_t* cur, const int8_t* side,
    const int32_t* fid, const bool* ms, const float* lam,
    const float* lam_sc, int intra, int16_t* qout, bool* coded, uint8_t* qii,
    uint8_t* plane, uint8_t* rows, int borders, int64_t n, int k, int nseg,
    int Hp, int Wp, int nv, int nh, int pad_y, int pad_x, void* stream) {
  const Geo q{nv, nh, pad_y, pad_x, Hp, Wp};
  if (n <= 0 || k < 1 || k > kMaxRows || nseg < 1 || nseg > 65535 ||
      bad_geometry(nseg, q) || (!fid && n != (int64_t)nv * nh) ||
      n * nseg > (1L << 27) || (plane == nullptr) == (rows == nullptr) ||
      (plane && fid) || misaligned(prev, 8) || misaligned(gold, 8) ||
      misaligned(cur, 8) || misaligned(plane, 8) || misaligned(qout, 16))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid(grid_of(n), (unsigned)nseg);
  const McSrc mc{prev, gold, cur, side, fid, q};
  if (k == 1)
    mc_idct_recon_skip_kernel<1><<<grid, kThreads, 0, s>>>(
        q16, dc_only, cnt, deq, inter, mc, ms, lam, lam_sc, intra, qout,
        coded, qii, plane, rows, borders, n);
  else if (k == 2)
    mc_idct_recon_skip_kernel<2><<<grid, kThreads, 0, s>>>(
        q16, dc_only, cnt, deq, inter, mc, ms, lam, lam_sc, intra, qout,
        coded, qii, plane, rows, borders, n);
  else
    mc_idct_recon_skip_kernel<3><<<grid, kThreads, 0, s>>>(
        q16, dc_only, cnt, deq, inter, mc, ms, lam, lam_sc, intra, qout,
        coded, qii, plane, rows, borders, n);
  return (int)cudaGetLastError();
}
