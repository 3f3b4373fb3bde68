// Kernel KS: motion compensation, the R/D skip test and the plane's
// assembly with its UMV borders, for NVIDIA Hopper (sm_90a).
//
// Replaces the steps of the JAX scans that XLA compiles on the TPU (no
// Pallas kernel) around the transform kernels:
//   the encode scan, theora_tpu/encode/tpu_gop.py:182-200 (scope "mc":
//   ops/mc_jax.py:38 block_neighborhoods, :72 mc_select2, the half-pel
//   average, intra 128, the residual), :286-293 (scope "skip_rd") and
//   :294-313 (mc_jax.py:107 blocks_to_plane, the frag all-gather's
//   input, theora_tpu/pipeline.py:122 fill_borders);
//   the decode step, theora_tpu/decode/tpu_batch.py:114-128 (the same
//   MC, the clamp, blocks_to_plane, fill_borders).
// Plain PyTorch versions and CPU paths: theora_tpu_torch/ops/mc.py:
// mc_residual, skip_place (with skip_rows and place_rows, its split form
// over a frag group) and mc_recon, composed of mc_predict,
// blocks_to_plane and fill_borders. The outputs must equal theirs byte
// for byte.
//
// The encode scan launches none of th_mc_residual, th_skip and th_place
// on a step without a frag group: KS's row core (csrc/mc_core.cuh) runs
// inside K2's and KR's entries (th_mc_fdct_quant, th_mc_fdct_quant_rd:
// the MC row where their block core loads its residual row) and K1's
// (th_mc_idct_recon_skip: the MC row, the skip test and put_row around
// the chooser). th_mc_residual and th_skip stay as the chain those
// entries replaced and the test hooks; over a frag group the scan runs
// th_place after the all-gather; the decode runs th_mc_recon.
//
// Entries (one launch each):
//   th_mc_residual: N = G nl blocks of one plane at one frame step (block
//     b in segment g = b / nl, the mesh encoder's GOPs), fragment fid[b %
//     nl] (or b % nl without fid) of the G stacked [Hp][Wp] reference
//     planes: the prediction pred [N][64] int32 (128 where rs == 0; else
//     the pixels at full-pel offset (y1, x1) of prev (rs != 2) or gold
//     (rs == 2), averaged (p1 + p2) >> 1 with those at (y2, x2) where u2),
//     res = cur - pred [N][64] int16, and ssd_unc [N] int32, the SSD of
//     prev's block at zero motion against cur.
//   th_skip: the R/D skip test of the encode scan on K1's outputs: coded
//     = intra or !(ms && 16 ssd_unc <= 16 ssd_rec + lamterm), lamterm =
//     trunc(lam[g] * (6 cnt + 2)) in float32, one rounding of the
//     product (__fmul_rn, __float2int_rz); writes qout (q16 where coded,
//     else 0) and coded in place, and the kept block (recon where coded,
//     else prev's) either into a new padded plane (plane != null) or as
//     rows [N][65] uint8, its 64 pixels and the coded flag (rows != null:
//     the frag group's all-gather input).
//   th_place: gathered rows [G n][65] -> a new plane and coded [G n].
//   th_mc_recon: the decode step of one plane of a frame: the prediction
//     as above plus K1's residual [n][64] int16, clamped to 0..255, into a
//     new plane, and with pic != null the picture region into pic [8 nv]
//     [8 nh].
// Every plane the kernel writes gets its padding written too: with
// borders != 0 the UMV borders (fill_borders: each row's first and last
// pixel to the left and right, then the first and last padded row up and
// down, so that a corner takes the picture's corner pixel); otherwise
// zeros, as blocks_to_plane leaves them (KL then reads that plane and
// fills the borders of its output). A fragment in column 0 or nh-1 writes
// the side borders of its 8 rows, one in row 0 or nv-1 the pad_y rows
// above or below its 8 columns, a corner fragment its corner: every byte
// of the plane has one writer, and no pass runs after the launch.
//
// Design: 8 lanes per fragment, lane i its row i, 16 fragments per CTA of
// 128 threads. A lane reads its 8 bytes of each source row at any
// alignment as two aligned 8-byte words and a funnel shift; averages
// bytewise ((a & b) + ((a ^ b) & 0xfe..) >> 1); writes 32 bytes of pred,
// 16 of res or qout, 8 of the plane per store; reduces the SSD over the 8
// lanes by shuffles; and takes the first and last rows for the top and
// bottom borders from lanes 0 and 7 by shuffles. Nothing is shared
// between fragments, so there is no barrier and no shared memory. The
// planes it writes are new buffers; prev and gold may alias each other.
// An offset that would read outside its padded plane, or a fragment id
// outside 0..n-1, traps the kernel (the plain version's indexing raises).
//
// Bound: bytes (tools/bench_mc.py:ks_bound, this run's data). At 720p
// luma (14,400 blocks) th_mc_residual moves ~0.6 KB a block (cur, one or
// two reference rows and the uncoded block in; pred, res and ssd out):
// ~8.6 MB, ~2.6 us at 3.35 TB/s; th_skip ~0.34 KB a block and the padded
// plane, ~4.9 MB, ~1.5 us; th_mc_recon ~4.9 MB, ~1.5 us. The integer work
// is a few operations a pixel (~0.2 us). A launch's latency (~5 us for
// an empty kernel on this card) is of the same order, so the design keeps
// one round trip to memory per lane: its loads independent and issued
// before the arithmetic, full-width stores, and enough CTAs (900 at 720p
// luma, 225 per 4:2:0 chroma plane) to reach every SM.

#include <cstdint>

#include <cuda_runtime.h>

#include "mc_core.cuh"

namespace {

constexpr int kThreads = 128;  // 16 fragments of 8 lanes
constexpr unsigned kAll = 0xffffffffu;

__global__ void __launch_bounds__(kThreads)
mc_residual_kernel(const uint8_t* __restrict__ prev,
                   const uint8_t* __restrict__ gold,
                   const uint8_t* __restrict__ cur,
                   const int8_t* __restrict__ side,
                   const int32_t* __restrict__ fid, int nl, int N, Geo q,
                   int32_t* __restrict__ pred, int16_t* __restrict__ res,
                   int32_t* __restrict__ ssd_unc) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  const int b = t >> 3, i = t & 7;
  int ssd = 0;
  if (b < N) {
    int g, f;
    locate(b, nl, q.nv * q.nh, fid, g, f);
    const int r = f / q.nh, c = f - r * q.nh;
    const size_t off = g * plane_bytes(q);
    const uint8_t* pv = prev + off;
    const uint64_t cw = load8a(cur + (size_t)b * 64 + 8 * i);
    const uint64_t uw = load8a(
        pv + (size_t)(q.pad_y + 8 * r + i) * q.Wp + q.pad_x + 8 * c);
    const uint64_t pw = predict_row(pv, gold + off, side, N, b, q, r, c, i);
    int p[8], d[8];
#pragma unroll
    for (int j = 0; j < 8; j++) {
      const int cj = byte_at(cw, j);
      p[j] = byte_at(pw, j);
      d[j] = cj - p[j];
      const int u = byte_at(uw, j) - cj;
      ssd += u * u;
    }
    int4* po = reinterpret_cast<int4*>(pred + (size_t)b * 64 + 8 * i);
    po[0] = make_int4(p[0], p[1], p[2], p[3]);
    po[1] = make_int4(p[4], p[5], p[6], p[7]);
    uint4 ro;
    ro.x = (uint32_t)(uint16_t)d[0] | (uint32_t)d[1] << 16;
    ro.y = (uint32_t)(uint16_t)d[2] | (uint32_t)d[3] << 16;
    ro.z = (uint32_t)(uint16_t)d[4] | (uint32_t)d[5] << 16;
    ro.w = (uint32_t)(uint16_t)d[6] | (uint32_t)d[7] << 16;
    *reinterpret_cast<uint4*>(res + (size_t)b * 64 + 8 * i) = ro;
  }
  ssd += __shfl_xor_sync(kAll, ssd, 4, 8);
  ssd += __shfl_xor_sync(kAll, ssd, 2, 8);
  ssd += __shfl_xor_sync(kAll, ssd, 1, 8);
  if (b < N && i == 0) ssd_unc[b] = ssd;
}

__global__ void __launch_bounds__(kThreads)
skip_kernel(const uint8_t* __restrict__ prev,
            const uint8_t* __restrict__ recon,
            const int16_t* __restrict__ q16,
            const int32_t* __restrict__ ssd_rec,
            const int32_t* __restrict__ ssd_unc,
            const int32_t* __restrict__ cnt, const bool* __restrict__ ms,
            const float* __restrict__ lam, int intra,
            const int32_t* __restrict__ fid, int nl, int N, Geo q,
            int16_t* __restrict__ qout, bool* __restrict__ coded,
            uint8_t* __restrict__ plane, uint8_t* __restrict__ rows,
            int borders) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  const int b = t >> 3, i = t & 7;
  const bool live = b < N;
  uint64_t v = 0;
  int g = 0, r = 0, c = 0;
  bool cd = true;
  if (live) {
    int f;
    locate(b, nl, q.nv * q.nh, fid, g, f);
    r = f / q.nh;
    c = f - r * q.nh;
    if (!intra) {
      // JAX: (lam * (6.0 * cnt + 2.0)).astype(int32) in float32; 6 cnt +
      // 2 is exact, the product rounds once and truncates toward zero.
      const int lt = __float2int_rz(
          __fmul_rn(__ldg(lam + g), __int2float_rn(6 * __ldg(cnt + b) + 2)));
      cd = !(ms[b] &&
             16 * __ldg(ssd_unc + b) <= 16 * __ldg(ssd_rec + b) + lt);
    }
    v = cd ? load8a(recon + (size_t)b * 64 + 8 * i)
           : load8a(prev + g * plane_bytes(q) +
                    (size_t)(q.pad_y + 8 * r + i) * q.Wp + q.pad_x + 8 * c);
    uint4 qw = make_uint4(0, 0, 0, 0);
    if (cd)
      qw = __ldg(reinterpret_cast<const uint4*>(q16 + (size_t)b * 64 + 8 * i));
    *reinterpret_cast<uint4*>(qout + (size_t)b * 64 + 8 * i) = qw;
    if (i == 0) coded[b] = cd;
  }
  const uint64_t top = __shfl_sync(kAll, v, 0, 8);
  const uint64_t bot = __shfl_sync(kAll, v, 7, 8);
  if (!live) return;
  if (plane) put_row(plane + g * plane_bytes(q), q, r, c, i, v, top, bot,
                     borders != 0);
  if (rows) put_gather_row(rows + (size_t)b * 65, i, v, cd);
}

__global__ void __launch_bounds__(kThreads)
place_kernel(const uint8_t* __restrict__ rows, int N, Geo q,
             uint8_t* __restrict__ plane, bool* __restrict__ coded,
             int borders) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  const int b = t >> 3, i = t & 7;
  const bool live = b < N;
  const int n = q.nv * q.nh;
  uint64_t v = 0;
  if (live) {
    const uint8_t* s = rows + (size_t)b * 65 + 8 * i;
#pragma unroll
    for (int j = 0; j < 8; j++) v |= (uint64_t)__ldg(s + j) << (8 * j);
    if (i == 0) coded[b] = __ldg(rows + (size_t)b * 65 + 64) != 0;
  }
  const uint64_t top = __shfl_sync(kAll, v, 0, 8);
  const uint64_t bot = __shfl_sync(kAll, v, 7, 8);
  if (!live) return;
  const int g = b / n, f = b - g * n;
  const int r = f / q.nh, c = f - r * q.nh;
  put_row(plane + g * plane_bytes(q), q, r, c, i, v, top, bot, borders != 0);
}

__global__ void __launch_bounds__(kThreads)
mc_recon_kernel(const uint8_t* __restrict__ prev,
                const uint8_t* __restrict__ gold,
                const int16_t* __restrict__ resid,
                const int8_t* __restrict__ side, Geo q,
                uint8_t* __restrict__ plane, uint8_t* __restrict__ pic,
                int borders) {
  const int n = q.nv * q.nh;
  const int t = blockIdx.x * kThreads + threadIdx.x;
  const int b = t >> 3, i = t & 7;
  const bool live = b < n;
  const int r = b / q.nh, c = b - r * q.nh;
  uint64_t v = 0;
  if (live) {
    const uint64_t pw = predict_row(prev, gold, side, n, b, q, r, c, i);
    const uint4 rw =
        __ldg(reinterpret_cast<const uint4*>(resid + (size_t)b * 64 + 8 * i));
    const uint32_t h[4] = {rw.x, rw.y, rw.z, rw.w};
#pragma unroll
    for (int j = 0; j < 8; j++) {
      const int d = (int)(int16_t)(h[j >> 1] >> (16 * (j & 1)));
      const int o = min(max(byte_at(pw, j) + d, 0), 255);
      v |= (uint64_t)o << (8 * j);
    }
  }
  const uint64_t top = __shfl_sync(kAll, v, 0, 8);
  const uint64_t bot = __shfl_sync(kAll, v, 7, 8);
  if (!live) return;
  put_row(plane, q, r, c, i, v, top, bot, borders != 0);
  if (pic) store8(pic + (size_t)(8 * r + i) * (8 * q.nh) + 8 * c, v);
}

unsigned ctas(long lanes) {
  return (unsigned)((lanes + kThreads - 1) / kThreads);
}

}  // namespace

// prev, gold [G][Hp][Wp] uint8 (8-byte aligned; may be one buffer); cur
// [N][64] uint8; side [6][N] int8 (rs, y1, x1, y2, x2, u2); fid [nl]
// int32 or null (then nl = nv nh); N = G nl. pred [N][64] int32, res
// [N][64] int16 (16-byte aligned), ssd_unc [N] int32.
extern "C" int th_mc_residual(const uint8_t* prev, const uint8_t* gold,
                              const uint8_t* cur, const int8_t* side,
                              const int32_t* fid, int nl, int G, int Hp,
                              int Wp, int nv, int nh, int pad_y, int pad_x,
                              int32_t* pred, int16_t* res, int32_t* ssd_unc,
                              void* stream) {
  const Geo q{nv, nh, pad_y, pad_x, Hp, Wp};
  if (bad_geometry(G, q) || nl < 1 || (!fid && nl != nv * nh) ||
      (long)G * nl > (1L << 27) || misaligned(prev, 8) ||
      misaligned(gold, 8) || misaligned(cur, 8) || misaligned(pred, 16) ||
      misaligned(res, 16))
    return (int)cudaErrorInvalidValue;
  const int N = G * nl;
  mc_residual_kernel<<<ctas(8L * N), kThreads, 0, (cudaStream_t)stream>>>(
      prev, gold, cur, side, fid, nl, N, q, pred, res, ssd_unc);
  return (int)cudaGetLastError();
}

// The skip test over N = G nl blocks (as th_mc_residual's); recon [N][64]
// uint8, q16 [N][64] int16, ssd_rec, ssd_unc, cnt [N] int32, ms [N] bool,
// lam [G] float32; qout [N][64] int16 and coded [N] bool written in place;
// exactly one of plane [G][Hp][Wp] (new) and rows [N][65] uint8.
extern "C" int th_skip(const uint8_t* prev, const uint8_t* recon,
                       const int16_t* q16, const int32_t* ssd_rec,
                       const int32_t* ssd_unc, const int32_t* cnt,
                       const bool* ms, const float* lam, int intra,
                       const int32_t* fid, int nl, int G, int Hp, int Wp,
                       int nv, int nh, int pad_y, int pad_x, int16_t* qout,
                       bool* coded, uint8_t* plane, uint8_t* rows,
                       int borders, void* stream) {
  const Geo q{nv, nh, pad_y, pad_x, Hp, Wp};
  if (bad_geometry(G, q) || nl < 1 || (!fid && nl != nv * nh) ||
      (long)G * nl > (1L << 27) || (plane == nullptr) == (rows == nullptr) ||
      misaligned(prev, 8) || misaligned(recon, 8) || misaligned(q16, 16) ||
      misaligned(qout, 16) || misaligned(plane, 8))
    return (int)cudaErrorInvalidValue;
  const int N = G * nl;
  skip_kernel<<<ctas(8L * N), kThreads, 0, (cudaStream_t)stream>>>(
      prev, recon, q16, ssd_rec, ssd_unc, cnt, ms, lam, intra, fid, nl, N,
      q, qout, coded, plane, rows, borders);
  return (int)cudaGetLastError();
}

// rows [G nv nh][65] uint8 (every fragment of G planes in order) -> plane
// [G][Hp][Wp] (new, 8-byte aligned) and coded [G nv nh] bool.
extern "C" int th_place(const uint8_t* rows, int G, int Hp, int Wp, int nv,
                        int nh, int pad_y, int pad_x, uint8_t* plane,
                        bool* coded, int borders, void* stream) {
  const Geo q{nv, nh, pad_y, pad_x, Hp, Wp};
  if (bad_geometry(G, q) || (long)G * nv * nh > (1L << 27) ||
      misaligned(plane, 8))
    return (int)cudaErrorInvalidValue;
  const int N = G * nv * nh;
  place_kernel<<<ctas(8L * N), kThreads, 0, (cudaStream_t)stream>>>(
      rows, N, q, plane, coded, borders);
  return (int)cudaGetLastError();
}

// One plane of a decoded frame: prev, gold [Hp][Wp] uint8; resid [nv nh]
// [64] int16 (16-byte aligned); side [6][nv nh] int8; plane [Hp][Wp] new;
// pic [8 nv][8 nh] uint8 or null (8-byte aligned).
extern "C" int th_mc_recon(const uint8_t* prev, const uint8_t* gold,
                           const int16_t* resid, const int8_t* side, int Hp,
                           int Wp, int nv, int nh, int pad_y, int pad_x,
                           uint8_t* plane, uint8_t* pic, int borders,
                           void* stream) {
  const Geo q{nv, nh, pad_y, pad_x, Hp, Wp};
  if (bad_geometry(1, q) || (long)nv * nh > (1L << 27) ||
      misaligned(prev, 8) || misaligned(gold, 8) || misaligned(resid, 16) ||
      misaligned(plane, 8) || misaligned(pic, 8))
    return (int)cudaErrorInvalidValue;
  mc_recon_kernel<<<ctas(8L * nv * nh), kThreads, 0, (cudaStream_t)stream>>>(
      prev, gold, resid, side, q, plane, pic, borders);
  return (int)cudaGetLastError();
}
