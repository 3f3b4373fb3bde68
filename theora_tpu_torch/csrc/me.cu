// Kernel KM: the encoder's ME plan for NVIDIA Hopper (sm_90a).
//
// Replaces theora_tpu/ops/me_jax.py:_plan_impl (:527), which XLA compiles
// on the TPU (no Pallas kernel), over _me_search_impl (:257),
// _block_refine_impl (:451), _sad_intra_impl (:419), _top_cands_impl
// (:358) and _cand_sads_impl (:382). Plain PyTorch version and CPU path:
// theora_tpu_torch/ops/me.py:plan_with_gold. Its 11 int32 outputs must
// equal the plain version's bit for bit, tie order included.
//
// Interface: the luma frames ys [F][H][W] uint8 (H, W multiples of 16,
// F >= 2) and gold_idx [F-1] int64 in [0, F). Row r (B = F - 1 rows) takes
// cur = ys[r + 1], prev = ys[r] and gold = ys[gold_idx[r]], read in place.
// n = (H / 16) (W / 16) macroblocks per row, raster order; vectors are
// half-pel (dx, dy). Three launches per plan call, in this order:
//   1. th_me_search: per (MB, row, reference) the coarse, full-pel and
//      half-pel search -> mv, sad_mv, sad_nomv against prev and gmv,
//      sad_gmv, sad_gold against gold; against prev also the 4MV refine
//      (bmv [B][2 nv][2 nh][2], bsad4 [B][n]) and sad_intra;
//   2. th_me_cands: per row the 16 shared candidate vectors, by the
//      popularity of the nonzero prev vectors (cands [B][16][2]);
//   3. th_me_cand_sads: per (MB, row) the SAD of each candidate against
//      prev with the two-tap prediction (cand_sads [B][16][n]).
//
// Arithmetic, as the plain version's (every value widened to int32 first):
//   coarse: the +-7 exhaustive search on the 2x2-summed pyramid, an 8x8
//     window per MB; candidate k of kOrder (radius order, the table of
//     ops/me.py:_radius_order(7)) keyed sad * 256 + k (sad <= 65,280, so
//     the key is < 2^24 and unique); the least key wins;
//   full-pel: the 25 cells of the +-2 grid around twice the coarse vector,
//     cell k < 25 of kOrder keyed sad * 32 + k (kOrder's first 25 entries
//     are _radius_order(2), so k is ops/me.py:_refine_rank()'s rank),
//     cells past +-15 full-pel masked out;
//   half-pel: the 9 positions of kOrder's first 9 entries (the radius
//     order of me.py:_halfpel_select) around the full-pel winner f, keyed
//     sad * 16 + k, the prediction (a + b) >> 1 of two full-pel taps; a
//     diagonal's taps pair by whether 2 f + d agrees in sign on both axes;
//   sad_nomv: the 16x16 SAD at offset 0;
//   4MV (prev only): each 8x8 block's full-pel grid around the MB winner's
//     first tap sign(m) (|m| >> 1), clamped to +-13, masked past +-13,
//     then its half-pel positions; bsad4 sums the four blocks' SADs;
//   sad_intra: per 8x8 block the sum of |x - (sum >> 6)|, summed per MB;
//   candidates: the key count * 4096 + (4095 - bin) over the 63 x 63 bins
//     (dx + 31) * 63 + (dy + 31) of the nonzero prev vectors, the 16
//     largest in order; a candidate whose count is 0 is (0, 0);
//   candidate SADs: taps at o1 = sign(m) (|m| >> 1) and o2 = o1 + sign(m)
//     (|m| & 1) per axis.
// Edge replication: every read coordinate is clamped to the plane (to the
// pyramid for the coarse stage), which equals the plain version's padding
// by 16, 17 and 8 for every reach of these searches. Every cell of every
// grid is computed, masked or not, as the plain version computes it, so
// the work does not depend on the data.
//
// Bound: int32-rate instructions. A 720p row is ~190 M absolute
// differences (coarse 2 x 225 x 64 per MB, full-pel 2 x 25 x 256,
// half-pel 2 x 9 x 256, 4MV 4 x 34 x 64, candidates 16 x 256); Hopper's
// SIMD video instructions take 4 of them on packed bytes (2 on the
// pyramid's halfwords) with the accumulate in one (VABSDIFF4, __vsadu4),
// ~97 M instructions over ~1.4 MB of luma read (tools/bench_me.py:km_bound
// counts both). This kernel widens every value to int32, ~3 instructions
// per difference, so it cannot come near that bound. Design:
// one warp per (macroblock, row, reference), four per CTA. A warp stages
// its MB, the MB's pyramid and a 22 x 22 window of the reference in shared
// memory as int32 (clamped reads through L1/L2), spreads the candidates of
// each stage over its lanes, and takes each stage's winner as the minimum
// of its integer keys with __reduce_min_sync: no tie is ever left to the
// order of a reduction. The histogram of kernel 2 lives in shared memory
// (3,969 int32); kernel 3 keeps each lane's 8 pixels of the MB in registers
// across the 16 candidates.
//
// Plain C interface (loaded with ctypes); each entry launches on the
// caller's stream, allocates nothing and returns cudaGetLastError().
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 4;            // macroblocks per CTA
constexpr int kWin = 22;             // staged window side
constexpr int kCoarse = 225;         // +-7 candidates
constexpr int kRefine = 25;          // +-2 cells
constexpr int kHalf = 9;             // half-pel positions
constexpr int kCands = 16;           // shared candidates per row
constexpr int kBins = 63 * 63;       // candidate histogram
constexpr int kMvMax = 15;           // full-pel MB vector limit
constexpr int kBlockMax = 13;        // full-pel 4MV block vector limit

// ops/me.py:_radius_order(7): (dy, dx) sorted by dy^2 + dx^2, then (dy,
// dx). Its first 25 entries are _radius_order(2), its first 9
// _radius_order(1).
__constant__ int8_t kOrder[kCoarse][2] = {
    {0, 0}, {-1, 0}, {0, -1}, {0, 1}, {1, 0}, {-1, -1}, {-1, 1}, {1, -1},
    {1, 1}, {-2, 0}, {0, -2}, {0, 2}, {2, 0}, {-2, -1}, {-2, 1}, {-1, -2},
    {-1, 2}, {1, -2}, {1, 2}, {2, -1}, {2, 1}, {-2, -2}, {-2, 2}, {2, -2},
    {2, 2}, {-3, 0}, {0, -3}, {0, 3}, {3, 0}, {-3, -1}, {-3, 1}, {-1, -3},
    {-1, 3}, {1, -3}, {1, 3}, {3, -1}, {3, 1}, {-3, -2}, {-3, 2}, {-2, -3},
    {-2, 3}, {2, -3}, {2, 3}, {3, -2}, {3, 2}, {-4, 0}, {0, -4}, {0, 4},
    {4, 0}, {-4, -1}, {-4, 1}, {-1, -4}, {-1, 4}, {1, -4}, {1, 4}, {4, -1},
    {4, 1}, {-3, -3}, {-3, 3}, {3, -3}, {3, 3}, {-4, -2}, {-4, 2}, {-2, -4},
    {-2, 4}, {2, -4}, {2, 4}, {4, -2}, {4, 2}, {-5, 0}, {-4, -3}, {-4, 3},
    {-3, -4}, {-3, 4}, {0, -5}, {0, 5}, {3, -4}, {3, 4}, {4, -3}, {4, 3},
    {5, 0}, {-5, -1}, {-5, 1}, {-1, -5}, {-1, 5}, {1, -5}, {1, 5}, {5, -1},
    {5, 1}, {-5, -2}, {-5, 2}, {-2, -5}, {-2, 5}, {2, -5}, {2, 5}, {5, -2},
    {5, 2}, {-4, -4}, {-4, 4}, {4, -4}, {4, 4}, {-5, -3}, {-5, 3}, {-3, -5},
    {-3, 5}, {3, -5}, {3, 5}, {5, -3}, {5, 3}, {-6, 0}, {0, -6}, {0, 6},
    {6, 0}, {-6, -1}, {-6, 1}, {-1, -6}, {-1, 6}, {1, -6}, {1, 6}, {6, -1},
    {6, 1}, {-6, -2}, {-6, 2}, {-2, -6}, {-2, 6}, {2, -6}, {2, 6}, {6, -2},
    {6, 2}, {-5, -4}, {-5, 4}, {-4, -5}, {-4, 5}, {4, -5}, {4, 5}, {5, -4},
    {5, 4}, {-6, -3}, {-6, 3}, {-3, -6}, {-3, 6}, {3, -6}, {3, 6}, {6, -3},
    {6, 3}, {-7, 0}, {0, -7}, {0, 7}, {7, 0}, {-7, -1}, {-7, 1}, {-5, -5},
    {-5, 5}, {-1, -7}, {-1, 7}, {1, -7}, {1, 7}, {5, -5}, {5, 5}, {7, -1},
    {7, 1}, {-6, -4}, {-6, 4}, {-4, -6}, {-4, 6}, {4, -6}, {4, 6}, {6, -4},
    {6, 4}, {-7, -2}, {-7, 2}, {-2, -7}, {-2, 7}, {2, -7}, {2, 7}, {7, -2},
    {7, 2}, {-7, -3}, {-7, 3}, {-3, -7}, {-3, 7}, {3, -7}, {3, 7}, {7, -3},
    {7, 3}, {-6, -5}, {-6, 5}, {-5, -6}, {-5, 6}, {5, -6}, {5, 6}, {6, -5},
    {6, 5}, {-7, -4}, {-7, 4}, {-4, -7}, {-4, 7}, {4, -7}, {4, 7}, {7, -4},
    {7, 4}, {-6, -6}, {-6, 6}, {6, -6}, {6, 6}, {-7, -5}, {-7, 5}, {-5, -7},
    {-5, 7}, {5, -7}, {5, 7}, {7, -5}, {7, 5}, {-7, -6}, {-7, 6}, {-6, -7},
    {-6, 7}, {6, -7}, {6, 7}, {7, -6}, {7, 6}, {-7, -7}, {-7, 7}, {7, -7},
    {7, 7},
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

__device__ __forceinline__ int sgn(int v) { return (v > 0) - (v < 0); }

// sign(m) * (|m| >> 1): a half-pel component's first full-pel tap.
__device__ __forceinline__ int first_tap(int m) {
  return sgn(m) * (abs(m) >> 1);
}

// A 22 x 22 window of plane ref (H x W) whose corner is (y0, x0), each
// coordinate clamped to the plane.
__device__ void stage_window(int* s, const uint8_t* ref, int H, int W,
                             int y0, int x0, int lane) {
  for (int t = lane; t < kWin * kWin; t += 32) {
    const int i = t / kWin, j = t - i * kWin;
    const int y = clampi(y0 + i, 0, H - 1), x = clampi(x0 + j, 0, W - 1);
    s[t] = ref[(size_t)y * W + x];
  }
}

// SAD of an S x S block of cur (row stride CS) against win (stride kWin)
// from (oy, ox).
template <int S, int CS>
__device__ __forceinline__ int fullpel_sad(const int* win, int oy, int ox,
                                           const int* cur) {
  const int* w = win + oy * kWin + ox;
  int s = 0;
  for (int y = 0; y < S; y++)
#pragma unroll
    for (int x = 0; x < S; x++) s += abs(cur[y * CS + x] - w[y * kWin + x]);
  return s;
}

// SAD of an S x S block of cur (row stride 16) against half-pel position
// p (kOrder[p], p < 9) around the full-pel winner (fy, fx), whose tap grid
// (offset f - 1) starts at (ty, tx) of win.
template <int S>
__device__ int halfpel_sad(const int* win, int ty, int tx, const int* cur,
                           int p, int fy, int fx) {
  const int dy = kOrder[p][0], dx = kOrder[p][1];
  const int ay = 1 + min(dy, 0), by = 1 + max(dy, 0);
  int ax = 1 + min(dx, 0), bx = 1 + max(dx, 0);
  if (dy != 0 && dx != 0 && ((2 * fy + dy >= 0) != (2 * fx + dx >= 0))) {
    const int t = ax;  // the taps pair across the diagonal
    ax = bx;
    bx = t;
  }
  const int* pa = win + (ty + ay) * kWin + tx + ax;
  const int* pb = win + (ty + by) * kWin + tx + bx;
  int s = 0;
  for (int y = 0; y < S; y++)
#pragma unroll
    for (int x = 0; x < S; x++)
      s += abs(cur[y * 16 + x] -
               ((pa[y * kWin + x] + pb[y * kWin + x]) >> 1));
  return s;
}

// The +-2 full-pel grid around (cy, cx) (the window's corner is at offset
// (cy - 3, cx - 3), so cell d is at window (3 + dy, 3 + dx)), cells past
// +-lim masked, then the 9 half-pel positions around the winner. The S x S
// block of cur sits at (oy, ox) of the MB; returns (sad, my, mx) with the
// vector in half-pel units.
template <int S>
__device__ void refine(const int* win, const int* cur, int oy, int ox, int cy,
                       int cx, int lim, int lane, int* sad, int* my, int* mx) {
  const int* c = cur + oy * 16 + ox;
  unsigned key = 0xffffffffu;
  if (lane < kRefine) {
    const int dy = kOrder[lane][0], dx = kOrder[lane][1];
    const int s = fullpel_sad<S, 16>(win, oy + 3 + dy, ox + 3 + dx, c);
    if (abs(cy + dy) <= lim && abs(cx + dx) <= lim)
      key = (unsigned)s * 32u + (unsigned)lane;
  }
  key = __reduce_min_sync(kFull, key);
  const int k = key & 31;
  const int fy = cy + kOrder[k][0], fx = cx + kOrder[k][1];
  // The tap grid of (fy, fx) starts at offset f - 1: window f - c + 2.
  const int ty = oy + fy - cy + 2, tx = ox + fx - cx + 2;
  key = 0xffffffffu;
  if (lane < kHalf)
    key = (unsigned)halfpel_sad<S>(win, ty, tx, c, lane, fy, fx) * 16u +
          (unsigned)lane;
  key = __reduce_min_sync(kFull, key);
  const int p = key & 15;
  *sad = (int)(key >> 4);
  *my = 2 * fy + kOrder[p][0];
  *mx = 2 * fx + kOrder[p][1];
}

struct SearchOut {
  int32_t *mv, *sad_mv, *sad_nomv;   // [B][n][2], [B][n], [B][n]
  int32_t *gmv, *sad_gmv, *sad_gold;
  int32_t *sad_intra, *bmv, *bsad4;  // [B][n], [B][2nv][2nh][2], [B][n]
};

__global__ void __launch_bounds__(kWarps * 32)
me_search_kernel(const uint8_t* __restrict__ ys,
                 const int64_t* __restrict__ gold_idx, int H, int W,
                 SearchOut out) {
  __shared__ int smem[kWarps][256 + 64 + 2 * kWin * kWin];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int nh = W >> 4, nv = H >> 4, n = nh * nv;
  const int mb = blockIdx.x * kWarps + w;
  if (mb >= n) return;
  const int r = blockIdx.y, z = blockIdx.z;
  const int mby = mb / nh, mbx = mb - mby * nh;
  const size_t plane = (size_t)H * W;
  const uint8_t* cur = ys + (size_t)(r + 1) * plane;
  // gold_idx must lie in [0, F) (F = gridDim.y + 1 frames); an index
  // outside traps, as PyTorch's indexing raises a device-side assert.
  const int64_t g = z ? gold_idx[r] : r;
  if (g < 0 || g > (int64_t)gridDim.y) __trap();
  const uint8_t* ref = ys + (size_t)g * plane;
  int* s_cur = smem[w];           // [16][16]
  int* s_cur2 = s_cur + 256;      // [8][8] 2x2 sums
  int* s_pyr = s_cur2 + 64;       // [22][22] pyramid window
  int* s_win = s_pyr + kWin * kWin;  // [22][22] reference window
  const int y0 = mby * 16, x0 = mbx * 16;

  for (int t = lane; t < 256; t += 32)
    s_cur[t] = cur[(size_t)(y0 + (t >> 4)) * W + x0 + (t & 15)];
  // The pyramid window: pyramid rows mby * 8 - 7 .. + 21, clamped.
  const int H2 = H >> 1, W2 = W >> 1;
  for (int t = lane; t < kWin * kWin; t += 32) {
    const int i = t / kWin, j = t - i * kWin;
    const int py = clampi(mby * 8 - 7 + i, 0, H2 - 1);
    const int px = clampi(mbx * 8 - 7 + j, 0, W2 - 1);
    const uint8_t* p = ref + (size_t)(2 * py) * W + 2 * px;
    s_pyr[t] = p[0] + p[1] + p[W] + p[W + 1];
  }
  __syncwarp();
  for (int t = lane; t < 64; t += 32) {
    const int* p = s_cur + (t >> 3) * 32 + (t & 7) * 2;
    s_cur2[t] = p[0] + p[1] + p[16] + p[17];
  }
  __syncwarp();

  // (a) coarse: candidate k at pyramid window (7 + dy, 7 + dx).
  unsigned key = 0xffffffffu;
  for (int k = lane; k < kCoarse; k += 32) {
    const int s = fullpel_sad<8, 8>(s_pyr, 7 + kOrder[k][0],
                                    7 + kOrder[k][1], s_cur2);
    key = min(key, (unsigned)s * 256u + (unsigned)k);
  }
  key = __reduce_min_sync(kFull, key);
  const int cy = 2 * kOrder[key & 255][0], cx = 2 * kOrder[key & 255][1];

  // (b, c) full-pel and half-pel refine around twice the coarse vector.
  stage_window(s_win, ref, H, W, y0 + cy - 3, x0 + cx - 3, lane);
  __syncwarp();
  int sad, my, mx;
  refine<16>(s_win, s_cur, 0, 0, cy, cx, kMvMax, lane, &sad, &my, &mx);

  // (d) the SAD at offset 0.
  int d = 0;
  for (int t = lane; t < 256; t += 32)
    d += abs(s_cur[t] - (int)ref[(size_t)(y0 + (t >> 4)) * W + x0 + (t & 15)]);
  d = (int)__reduce_add_sync(kFull, (unsigned)d);

  const size_t o = (size_t)r * n + mb;
  if (lane == 0) {
    int32_t* mvo = z ? out.gmv : out.mv;
    mvo[2 * o] = mx;
    mvo[2 * o + 1] = my;
    (z ? out.sad_gmv : out.sad_mv)[o] = sad;
    (z ? out.sad_gold : out.sad_nomv)[o] = d;
  }
  if (z) return;

  // sad_intra: lane l sums row l & 7 of 8x8 block l >> 3.
  {
    const int b = lane >> 3, row = lane & 7;
    const int* p = s_cur + ((b >> 1) * 8 + row) * 16 + (b & 1) * 8;
    int sum = 0;
    for (int x = 0; x < 8; x++) sum += p[x];
    sum += __shfl_xor_sync(kFull, sum, 1);
    sum += __shfl_xor_sync(kFull, sum, 2);
    sum += __shfl_xor_sync(kFull, sum, 4);
    const int mean = sum >> 6;
    int dev = 0;
    for (int x = 0; x < 8; x++) dev += abs(p[x] - mean);
    dev = (int)__reduce_add_sync(kFull, (unsigned)dev);
    if (lane == 0) out.sad_intra[o] = dev;
  }

  // (e) 4MV: the four 8x8 blocks around the winner's first tap.
  const int by = clampi(first_tap(my), -kBlockMax, kBlockMax);
  const int bx = clampi(first_tap(mx), -kBlockMax, kBlockMax);
  __syncwarp();
  stage_window(s_win, ref, H, W, y0 + by - 3, x0 + bx - 3, lane);
  __syncwarp();
  int bsum = 0;
  for (int j = 0; j < 4; j++) {
    const int jy = j >> 1, jx = j & 1;
    int bs, bmy, bmx;
    refine<8>(s_win, s_cur, 8 * jy, 8 * jx, by, bx, kBlockMax, lane, &bs,
              &bmy, &bmx);
    bsum += bs;
    if (lane == 0) {
      const size_t q = ((size_t)r * 2 * nv + 2 * mby + jy) * (2 * nh) +
                       2 * mbx + jx;
      out.bmv[2 * q] = bmx;
      out.bmv[2 * q + 1] = bmy;
    }
  }
  if (lane == 0) out.bsad4[o] = bsum;
}

__global__ void __launch_bounds__(256)
me_cands_kernel(const int32_t* __restrict__ mv, int n,
                int32_t* __restrict__ cands) {
  __shared__ int hist[kBins];
  __shared__ int part[8];
  const int r = blockIdx.x, tid = threadIdx.x;
  for (int i = tid; i < kBins; i += 256) hist[i] = 0;
  __syncthreads();
  const int32_t* m = mv + (size_t)r * n * 2;
  for (int i = tid; i < n; i += 256) {
    const int dx = m[2 * i], dy = m[2 * i + 1];
    if (dx != 0 || dy != 0) atomicAdd(&hist[(dx + 31) * 63 + dy + 31], 1);
  }
  __syncthreads();
  // 16 rounds of a block-wide maximum of the unique keys; a taken bin is
  // set to -1, below every key.
  for (int k = 0; k < kCands; k++) {
    int best = -1;
    for (int i = tid; i < kBins; i += 256)
      if (hist[i] >= 0) best = max(best, hist[i] * 4096 + (4095 - i));
    best = __reduce_max_sync(kFull, best);
    if ((tid & 31) == 0) part[tid >> 5] = best;
    __syncthreads();
    if (tid == 0) {
      for (int i = 1; i < 8; i++) best = max(best, part[i]);
      const int bin = 4095 - (best & 4095);
      const bool used = (best >> 12) > 0;
      int32_t* c = cands + ((size_t)r * kCands + k) * 2;
      c[0] = used ? bin / 63 - 31 : 0;
      c[1] = used ? bin % 63 - 31 : 0;
      hist[bin] = -1;
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kWarps * 32)
me_cand_sads_kernel(const uint8_t* __restrict__ ys,
                    const int32_t* __restrict__ cands, int H, int W,
                    int32_t* __restrict__ cand_sads) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int nh = W >> 4, n = nh * (H >> 4);
  const int mb = blockIdx.x * kWarps + w;
  if (mb >= n) return;
  const int r = blockIdx.y;
  const int mby = mb / nh, mbx = mb - mby * nh;
  const size_t plane = (size_t)H * W;
  const uint8_t* cur = ys + (size_t)(r + 1) * plane;
  const uint8_t* ref = ys + (size_t)r * plane;
  // Lane l: row l >> 1 of the MB, columns (l & 1) * 8 .. + 7.
  const int y = mby * 16 + (lane >> 1), x0 = mbx * 16 + (lane & 1) * 8;
  int c[8];
#pragma unroll
  for (int x = 0; x < 8; x++) c[x] = cur[(size_t)y * W + x0 + x];
  for (int k = 0; k < kCands; k++) {
    const int32_t* cv = cands + ((size_t)r * kCands + k) * 2;
    const int mx = cv[0], my = cv[1];
    const int o1y = first_tap(my), o1x = first_tap(mx);
    const int o2y = o1y + sgn(my) * (abs(my) & 1);
    const int o2x = o1x + sgn(mx) * (abs(mx) & 1);
    const uint8_t* r1 = ref + (size_t)clampi(y + o1y, 0, H - 1) * W;
    const uint8_t* r2 = ref + (size_t)clampi(y + o2y, 0, H - 1) * W;
    int s = 0;
#pragma unroll
    for (int x = 0; x < 8; x++) {
      const int p = r1[clampi(x0 + x + o1x, 0, W - 1)] +
                    r2[clampi(x0 + x + o2x, 0, W - 1)];
      s += abs(c[x] - (p >> 1));
    }
    s = (int)__reduce_add_sync(kFull, (unsigned)s);
    if (lane == 0) cand_sads[((size_t)r * kCands + k) * n + mb] = s;
  }
}

}  // namespace

extern "C" int th_me_search(const uint8_t* ys, const int64_t* gold_idx,
                            int nrows, int H, int W, int32_t* mv,
                            int32_t* sad_mv, int32_t* sad_nomv, int32_t* gmv,
                            int32_t* sad_gmv, int32_t* sad_gold,
                            int32_t* sad_intra, int32_t* bmv, int32_t* bsad4,
                            void* stream) {
  if (nrows < 1 || H < 16 || W < 16 || (H & 15) || (W & 15))
    return (int)cudaErrorInvalidValue;
  const int n = (H >> 4) * (W >> 4);
  const SearchOut out = {mv, sad_mv, sad_nomv, gmv, sad_gmv, sad_gold,
                         sad_intra, bmv, bsad4};
  const dim3 grid((unsigned)((n + kWarps - 1) / kWarps), (unsigned)nrows, 2);
  me_search_kernel<<<grid, kWarps * 32, 0, (cudaStream_t)stream>>>(
      ys, gold_idx, H, W, out);
  return (int)cudaGetLastError();
}

extern "C" int th_me_cands(const int32_t* mv, int nrows, int n,
                           int32_t* cands, void* stream) {
  if (nrows < 1 || n < 1) return (int)cudaErrorInvalidValue;
  me_cands_kernel<<<nrows, 256, 0, (cudaStream_t)stream>>>(mv, n, cands);
  return (int)cudaGetLastError();
}

extern "C" int th_me_cand_sads(const uint8_t* ys, const int32_t* cands,
                               int nrows, int H, int W, int32_t* cand_sads,
                               void* stream) {
  if (nrows < 1 || H < 16 || W < 16 || (H & 15) || (W & 15))
    return (int)cudaErrorInvalidValue;
  const int n = (H >> 4) * (W >> 4);
  const dim3 grid((unsigned)((n + kWarps - 1) / kWarps), (unsigned)nrows);
  me_cand_sads_kernel<<<grid, kWarps * 32, 0, (cudaStream_t)stream>>>(
      ys, cands, H, W, cand_sads);
  return (int)cudaGetLastError();
}
