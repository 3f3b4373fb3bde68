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
// Arithmetic, as the plain version's:
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
// Every minimum is the least of unique integer keys (the rank comes from
// kOrder through the inverse table s_rank), reduced with
// __reduce_min_sync or min-shuffles: no tie is left to a reduction order.
// Edge replication: the plain version pads the plane by 16 and 17 and the
// 2x2-summed pyramid by 8 at the pyramid's own resolution. Here the luma
// window is clamped pixel by pixel, and each pyramid pixel's coordinate is
// clamped to the half-size plane before its 2x2 block is read, which
// equals both paddings for every reach of these searches.
//
// Bound: instructions at the int32 rate. A 720p row is ~190 M absolute
// differences (coarse 2 x 225 x 64 per MB, full-pel 2 x 25 x 256,
// half-pel 2 x 9 x 256, 4MV 4 x 34 x 64, candidates 16 x 256); Hopper's
// SIMD video instructions take 4 of them on packed bytes (2 on the
// pyramid's halfwords) with the accumulate in one (VABSDIFF4, __vsadu4),
// ~97 M instructions over ~1.4 MB of luma read (tools/bench_me.py:km_bound
// counts both). Measured on the card (bench_me.simd_rates), VABSDIFF4 and
// min.u16x2 issue at the int32 rate, but ptxas expands __vsadu2 into ~8
// instructions and __vhaddu4 is ~3; bench_me.km_bound_at gives the bound
// at those rates.
//
// Design (what it does about the bound):
// - Packed bytes. Each search reads one window of its reference, luma
//   -16 .. +31 around the MB corner, which every reach of the full-pel,
//   half-pel and 4MV stages lies in; the 4 warps of a CTA search 4
//   neighbouring MBs of one row against one reference and stage one
//   shared 48 x 96-byte window, half the bytes of 4 windows, with 16-byte
//   vector loads where it lies in the plane and a clamp per byte only at
//   the edge. The coarse pyramid is formed from it as packed 16-bit pairs
//   (2x2 sums reach 1,020). Every byte SAD is __vsadu4 on 4 bytes with its
//   accumulate (one VABSDIFF4); the half-pel prediction is __vhaddu4, the
//   per-byte truncating (a + b) >> 1 of the plain version. A word at an
//   unaligned column is a __funnelshift_r of two aligned words; the shift
//   depends only on the column. The pyramid's SADs, whose SIMD form
//   __vsadu2 the card lacks, are sum a + sum b - 2 sum min(a, b) with one
//   min.u16x2 per pair and the window's sums from packed prefix sums of
//   its rows.
// - Full warps. Lane (y = lane >> 1, h = lane & 1) holds bytes 8h .. 8h+7
//   of MB row y in two registers and scores every cell of a stage on
//   them, the 25 full-pel cells and the 9 half-pel positions alike, so
//   the four 8x8 blocks of the 4MV refine are four groups of 8 lanes
//   searched at once. Partial SADs are packed two to a word (an MB's SAD
//   is at most 65,280 < 2^16) and summed with xor-shuffles that halve the
//   words at each step, so each lane ends with its own cells' sums. The
//   coarse stage puts lane (dx, dy half) over 15 columns and 2 halves of
//   the 15 rows of candidates, the pyramid of cur in its registers, each
//   pyramid row loaded once for the 8 candidates that read it.
// - Balance. One reference per CTA (grid z), so a CTA's warps carry equal
//   work; the heavier prev CTAs (4MV, sad_intra) are issued first.
// - Candidate SADs: one warp per MB, 8 neighbouring MBs of a row per CTA
//   on one staged 48 x 160-byte window of prev that holds the candidates'
//   whole reach (taps within +-16 full-pel); cur stays in registers, the
//   taps' offsets are formed once per CTA, and the 16 sums of the 8 MBs
//   go out through shared memory, so neighbouring threads store
//   neighbouring MBs of one candidate.
// The histogram of kernel 2 lives in shared memory (3,969 int32).
//
// Plain C interface (loaded with ctypes); each entry launches on the
// caller's stream, allocates nothing and returns cudaGetLastError().
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 4;            // searches per CTA (one reference)
constexpr int kCandWarps = 8;        // macroblocks per candidate-SAD CTA
constexpr int kSide = 48;            // window rows: luma -16 .. +31
// A CTA's warps search kWarps neighbouring MBs of one MB row and share one
// window of kWarps * 16 + 32 columns; the rows' strides (in words) leave
// a pad that keeps a warp's lanes on distinct banks but for 2-way sets.
constexpr int kChunks = (kWarps * 16 + 32) / 16;  // 16-byte chunks a row
constexpr int kRowW = 28;            // window row stride (24 used)
constexpr int kWinW = kSide * kRowW + 4;  // +4: the last row's over-read
constexpr int kPyrRows = 22;         // pyramid window rows
constexpr int kPyrW = 24;            // pyramid row: kWarps * 8 + 16 columns
constexpr int kCandChunks = (kCandWarps * 16 + 32) / 16;
constexpr int kCandRowW = 44;        // candidate-SAD window stride (40)
constexpr int kCoarse = 225;         // +-7 candidates
constexpr int kCands = 16;           // shared candidates per row
constexpr int kBins = 63 * 63;       // candidate histogram
constexpr int kMvMax = 15;           // full-pel MB vector limit
constexpr int kBlockMax = 13;        // full-pel 4MV block vector limit
static_assert(kRowW >= 4 * kChunks && kRowW % 4 == 0 &&
                  kPyrW >= 4 * kChunks && kPyrW % 4 == 0 &&
                  kCandRowW >= 4 * kCandChunks + 1 &&
                  kCandRowW % 4 == 0 && kWinW % 4 == 0,
              "16-byte aligned rows that hold the chunks");

// ops/me.py:_radius_order(7): (dy, dx) sorted by dy^2 + dx^2, then (dy,
// dx). Its first 25 entries are _radius_order(2), its first 9
// _radius_order(1). In global memory: each CTA copies it once, its
// threads reading neighbouring entries (the constant cache would serve
// those reads one address at a time).
__device__ const int8_t kOrder[kCoarse][2] = {
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

// __vsadu4(a, b) + acc in one VABSDIFF4: the PTX of __vsadu4 with acc as
// its accumulate operand (the sum of the 4 bytes' absolute differences).
__device__ __forceinline__ uint32_t sad4(uint32_t a, uint32_t b,
                                         uint32_t acc) {
  uint32_t r;
  asm("vabsdiff4.u32.u32.u32.add %0, %1, %2, %3;"
      : "=r"(r) : "r"(a), "r"(b), "r"(acc));
  return r;
}

// 16-bit half e of w.
__device__ __forceinline__ uint32_t half16(uint32_t w, int e) {
  return (w >> (16 * e)) & 0xffffu;
}

// The per-half minimum of two pairs of 16-bit values (min.u16x2, one
// instruction on sm_90). The pyramid's SADs are taken as sum|a - b| =
// sum a + sum b - 2 sum min(a, b): ptxas expands __vsadu2 (vabsdiff2) into
// several instructions on this card (tools/bench_me.py:simd_rates).
__device__ __forceinline__ uint32_t min_u16x2(uint32_t a, uint32_t b) {
  uint32_t r;
  asm("min.u16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

// Bytes s .. s + 3 of the byte string held by the words lo, hi, where
// sh = 8 (s & 3).
__device__ __forceinline__ uint32_t bytes_at(uint32_t lo, uint32_t hi,
                                             unsigned sh) {
  return __funnelshift_r(lo, hi, sh);
}

// The 2x2 sums of the words a, b of two consecutive rows: 16-bit half i
// holds a's bytes 2i, 2i + 1 plus b's.
__device__ __forceinline__ uint32_t pair_sums(uint32_t a, uint32_t b) {
  const uint32_t m = 0x00ff00ffu;
  return (a & m) + ((a >> 8) & m) + (b & m) + ((b >> 8) & m);
}

// 16 bytes of plane row y (clamped) from column x, a multiple of 16: one
// vector load where they lie in the plane and the frames are 16-byte
// aligned (vec), else byte by byte with the column clamped.
__device__ __forceinline__ uint4 load16(const uint8_t* plane, int H, int W,
                                        int y, int x, bool vec) {
  const uint8_t* row = plane + (size_t)clampi(y, 0, H - 1) * W;
  if (vec && x >= 0 && x < W)
    return __ldg(reinterpret_cast<const uint4*>(row + x));
  uint32_t v[4];
#pragma unroll
  for (int q = 0; q < 4; q++) {
    uint32_t word = 0;
#pragma unroll
    for (int b = 0; b < 4; b++)
      word |= (uint32_t)row[clampi(x + 4 * q + b, 0, W - 1)] << (8 * b);
    v[q] = word;
  }
  return make_uint4(v[0], v[1], v[2], v[3]);
}

// The window of plane ref, kSide rows of `chunks` 16-byte chunks at a
// stride of row_w words, whose byte (i, j) is the plane's pixel (16 mby -
// 16 + i, 16 mbx0 - 16 + j), coordinates clamped; threads tid of nt.
__device__ void stage_window(uint32_t* win, const uint8_t* ref, int H,
                             int W, int mby, int mbx0, int chunks,
                             int row_w, bool vec, int tid, int nt) {
  for (int t = tid; t < kSide * chunks; t += nt) {
    const int i = t / chunks, c = t - chunks * i;
    *reinterpret_cast<uint4*>(win + i * row_w + 4 * c) =
        load16(ref, H, W, 16 * mby - 16 + i, 16 * mbx0 - 16 + 16 * c, vec);
  }
}

// The search CTA's window (stage_window, kChunks) and its pyramid window:
// word u of pyramid row i holds, as 16-bit halves, the 2x2 sums of the
// pyramid pixels (8 mby - 7 + i, 8 mbx0 - 8 + 2u + e), e = 0, 1, each
// coordinate clamped to the half-size plane (the plain version's padding
// of the pyramid), so warp w's pyramid column j (pixel 8 (mbx0 + w) - 7 +
// j) is half j + 1 from word 4w. Inside the plane (fast), pyramid row i is
// window rows 2i + 2, 2i + 3 word u, formed as the rows arrive.
__device__ void stage_reference(uint32_t* win, uint32_t* pyr,
                                const uint8_t* ref, int H, int W, int mby,
                                int mbx0, bool vec, bool fast) {
  const int tid = threadIdx.x, nt = blockDim.x;
  if (fast) {
    const uint8_t* corner = ref + (size_t)(16 * mby - 16) * W + 16 * mbx0 -
                            16;
    for (int t = tid; t < kSide / 2 * kChunks; t += nt) {
      const int k = t / kChunks, c = t - kChunks * k;
      const uint8_t* p = corner + (size_t)(2 * k) * W + 16 * c;
      const uint4 a = __ldg(reinterpret_cast<const uint4*>(p));
      const uint4 b = __ldg(reinterpret_cast<const uint4*>(p + W));
      *reinterpret_cast<uint4*>(win + 2 * k * kRowW + 4 * c) = a;
      *reinterpret_cast<uint4*>(win + (2 * k + 1) * kRowW + 4 * c) = b;
      if (k >= 1 && k <= kPyrRows)
        *reinterpret_cast<uint4*>(pyr + (k - 1) * kPyrW + 4 * c) =
            make_uint4(pair_sums(a.x, b.x), pair_sums(a.y, b.y),
                       pair_sums(a.z, b.z), pair_sums(a.w, b.w));
    }
    return;
  }
  stage_window(win, ref, H, W, mby, mbx0, kChunks, kRowW, vec, tid, nt);
  __syncthreads();
  // A clamped pyramid pixel's luma rows and columns lie in the plane, so
  // the window holds them as they are.
  const uint8_t* wb = reinterpret_cast<const uint8_t*>(win);
  const int H2 = H >> 1, W2 = W >> 1;
  for (int t = tid; t < kPyrRows * 4 * kChunks; t += nt) {
    const int i = t / (4 * kChunks), u = t - i * 4 * kChunks;
    const int ry = 2 * clampi(8 * mby - 7 + i, 0, H2 - 1) - 16 * mby + 16;
    uint32_t word = 0;
#pragma unroll
    for (int e = 0; e < 2; e++) {
      const int px = clampi(8 * mbx0 - 8 + 2 * u + e, 0, W2 - 1);
      const uint8_t* q = wb + ry * 4 * kRowW + 2 * px - 16 * mbx0 + 16;
      word |= (uint32_t)(q[0] + q[1] + q[4 * kRowW] + q[4 * kRowW + 1])
              << (16 * e);
    }
    pyr[i * kPyrW + u] = word;
  }
}

// The coarse stage: lane (dx = (lane & 15) - 7, lanes 15 and 31 repeating
// dx = 7; half = lane >> 4) scores the candidates (dy, dx), dy in -7 .. 0
// (half 0) or 0 .. 7 (half 1), on the pyramid window, cur's 2x2 sums in
// c2 (row y, words of columns 2q, 2q + 1) and their total csum. Each
// candidate's SAD is csum + its window's sum - 2 sum min(cur, window),
// the sums of 16-bit pairs kept packed (a half's sum stays below 2^16).
// Returns the least key sad * 256 + k over the warp.
__device__ __forceinline__ unsigned coarse_search(const uint32_t* pyr,
                                                  const uint32_t (&c2)[8][4],
                                                  uint32_t csum,
                                                  const uint8_t* rank,
                                                  int lane) {
  const int dx = min(lane & 15, 14) - 7, half = lane >> 4;
  const int hs = 8 + dx;  // pyramid window column 7 + dx is half hs
  const uint32_t* p = pyr + 7 * half * kPyrW + (hs >> 1);
  const unsigned sh = (hs & 1) * 16;
  uint32_t mins[8], pre[16];  // pre[r]: the window's rows 0 .. r - 1
#pragma unroll
  for (int d = 0; d < 8; d++) mins[d] = 0;
  pre[0] = 0;
  // Row r of this half meets candidate d (dy = d - 7 + 7 half) at cur
  // row r - d.
#pragma unroll
  for (int r = 0; r < 15; r++) {
    const uint32_t* row = p + r * kPyrW;
    uint32_t w[5], a[4];
#pragma unroll
    for (int q = 0; q < 5; q++) w[q] = row[q];
#pragma unroll
    for (int q = 0; q < 4; q++) a[q] = __funnelshift_r(w[q], w[q + 1], sh);
    pre[r + 1] = pre[r] + a[0] + a[1] + a[2] + a[3];
#pragma unroll
    for (int d = 0; d < 8; d++) {
      const int y = r - d;
      if (y >= 0 && y < 8)
        mins[d] += min_u16x2(c2[y][0], a[0]) + min_u16x2(c2[y][1], a[1]) +
                   min_u16x2(c2[y][2], a[2]) + min_u16x2(c2[y][3], a[3]);
    }
  }
  unsigned key = 0xffffffffu;
#pragma unroll
  for (int d = 0; d < 8; d++) {
    const uint32_t box = pre[d + 8] - pre[d];
    const uint32_t sad = csum + half16(box, 0) + half16(box, 1) -
                         2 * (half16(mins[d], 0) + half16(mins[d], 1));
    const int dy = d - 7 + 7 * half;
    key = min(key, sad * 256u + rank[(dy + 7) * 15 + dx + 7]);
  }
  return __reduce_min_sync(kFull, key);
}

// The lane's partial SADs (its 8 bytes c0, c1 of MB row y, columns 8h ..
// 8h + 7) against the 25 full-pel cells (cy + dy, cx + dx), |dy|, |dx| <=
// 2, in grid order (dy + 2) * 5 + dx + 2. Window byte (16 + v, 16 + u) is
// offset (v, u) from the MB corner.
__device__ __forceinline__ void fullpel_parts(const uint32_t* win, int y,
                                              int h, int cy, int cx,
                                              uint32_t c0, uint32_t c1,
                                              uint32_t (&part)[25]) {
  const int s = 14 + 8 * h + cx;  // window column of cell dx = -2
  const unsigned sh = (s & 3) * 8;
  const uint32_t* base = win + (14 + y + cy) * kRowW + (s >> 2);
#pragma unroll
  for (int dy = 0; dy < 5; dy++) {
    const uint32_t* row = base + dy * kRowW;
    const uint32_t w0 = row[0], w1 = row[1], w2 = row[2], w3 = row[3];
    const uint32_t u0 = bytes_at(w0, w1, sh), u1 = bytes_at(w1, w2, sh),
                   u2 = bytes_at(w2, w3, sh);
#pragma unroll
    for (int dx = 0; dx < 5; dx++) {
      const uint32_t a0 = dx == 0 ? u0 : dx == 4 ? u1
                                       : __funnelshift_r(u0, u1, 8 * dx);
      const uint32_t a1 = dx == 0 ? u1 : dx == 4 ? u2
                                       : __funnelshift_r(u1, u2, 8 * dx);
      part[dy * 5 + dx] = sad4(c1, a1, sad4(c0, a0, 0));
    }
  }
}

// The lane's partial SADs against the 9 half-pel positions (dy, dx) around
// the full-pel vector (fy, fx), grid order (dy + 1) * 3 + dx + 1: the
// truncating average (__vhaddu4) of two taps t[ry][rx] at full-pel (fy -
// 1 + ry, fx - 1 + rx), paired as the plain version pairs them.
__device__ __forceinline__ void halfpel_parts(const uint32_t* win, int y,
                                              int h, int fy, int fx,
                                              uint32_t c0, uint32_t c1,
                                              uint32_t (&part)[9]) {
  const int s = 15 + 8 * h + fx;  // window column of tap rx = 0
  const unsigned sh = (s & 3) * 8;
  const uint32_t* base = win + (15 + y + fy) * kRowW + (s >> 2);
  uint32_t t[3][3][2];
#pragma unroll
  for (int ry = 0; ry < 3; ry++) {
    const uint32_t* row = base + ry * kRowW;
    const uint32_t w0 = row[0], w1 = row[1], w2 = row[2], w3 = row[3];
    const uint32_t u0 = bytes_at(w0, w1, sh), u1 = bytes_at(w1, w2, sh),
                   u2 = bytes_at(w2, w3, sh);
    t[ry][0][0] = u0;
    t[ry][0][1] = u1;
#pragma unroll
    for (int rx = 1; rx < 3; rx++) {
      t[ry][rx][0] = __funnelshift_r(u0, u1, 8 * rx);
      t[ry][rx][1] = __funnelshift_r(u1, u2, 8 * rx);
    }
  }
#pragma unroll
  for (int dy = -1; dy <= 1; dy++) {
#pragma unroll
    for (int dx = -1; dx <= 1; dx++) {
      // Taps (0, 1) for d = -1, (1, 1) for 0, (1, 2) for 1 on each axis.
      const int ya = dy < 0 ? 0 : 1, yb = dy > 0 ? 2 : 1;
      const int xa = dx < 0 ? 0 : 1, xb = dx > 0 ? 2 : 1;
      uint32_t p0, p1;
      if (dy == 0 && dx == 0) {
        p0 = t[1][1][0];
        p1 = t[1][1][1];
      } else {
        // A diagonal's taps pair across it where 2 f + d disagrees in
        // sign between the axes.
        const bool cross = dy != 0 && dx != 0 &&
                           ((2 * fy + dy >= 0) != (2 * fx + dx >= 0));
        p0 = __vhaddu4(cross ? t[ya][xb][0] : t[ya][xa][0],
                       cross ? t[yb][xa][0] : t[yb][xb][0]);
        p1 = __vhaddu4(cross ? t[ya][xb][1] : t[ya][xa][1],
                       cross ? t[yb][xa][1] : t[yb][xb][1]);
      }
      part[(dy + 1) * 3 + dx + 1] = sad4(c1, p1, sad4(c0, p0, 0));
    }
  }
}

// Sum the packed words p over the lane pairs of xor mask `mask`, keeping
// half of them: the lane with the mask bit set keeps the upper half.
template <int N>
__device__ __forceinline__ void fold(const uint32_t (&p)[N],
                                     uint32_t (&q)[N / 2], int mask,
                                     int lane) {
  const bool hi = lane & mask;
#pragma unroll
  for (int i = 0; i < N / 2; i++) {
    const uint32_t send = hi ? p[i] : p[i + N / 2];
    const uint32_t keep = hi ? p[i + N / 2] : p[i];
    q[i] = keep + __shfl_xor_sync(kFull, send, mask);
  }
}

// Two 16-bit cell sums per word: word i holds cells 2i and 2i + 1.
template <int C, int N>
__device__ __forceinline__ void pack(const uint32_t (&part)[C],
                                     uint32_t (&w)[N]) {
#pragma unroll
  for (int i = 0; i < N; i++) {
    const uint32_t lo = 2 * i < C ? part[2 * i] : 0u;
    const uint32_t hi = 2 * i + 1 < C ? part[2 * i + 1] : 0u;
    w[i] = lo | (hi << 16);
  }
}

// The full-pel stage of the lanes' 8x8 blocks (block = lanes whose bits
// 1-3 vary) or, with whole_mb, of the MB: the grid around (cy, cx), cells
// past +-lim masked. Returns the least key sad * 32 + k of the block (or
// MB), each lane's cells summed by folds over the block's lanes (and, for
// the MB, across the blocks).
__device__ __forceinline__ unsigned fullpel_key(const uint32_t* win, int y,
                                                int h, int cy, int cx,
                                                int lim, uint32_t c0,
                                                uint32_t c1,
                                                const uint8_t* rank,
                                                int lane, bool whole_mb) {
  uint32_t part[25], w16[16], w8[8], w4[4], w2[2];
  fullpel_parts(win, y, h, cy, cx, c0, c1, part);
  pack(part, w16);
  fold(w16, w8, 2, lane);
  fold(w8, w4, 4, lane);
  fold(w4, w2, 8, lane);
  // The lane now holds words 8 a + 4 b + 2 c + j (a, b, c: lane bits 1-3)
  // of its block: cells 16 a + 8 b + 4 c + 2 j + e.
  const int g0 = ((lane >> 1) & 1) * 16 + ((lane >> 2) & 1) * 8 +
                 ((lane >> 3) & 1) * 4;
  unsigned key = 0xffffffffu;
  if (whole_mb) {
    uint32_t w1[1];
    fold(w2, w1, 16, lane);
    const uint32_t v = w1[0] + __shfl_xor_sync(kFull, w1[0], 1);
    const int g = g0 + 2 * ((lane >> 4) & 1) + (lane & 1);
    const int dy = g / 5 - 2, dx = g % 5 - 2;
    if (g < 25 && abs(cy + dy) <= lim && abs(cx + dx) <= lim)
      key = half16(v, lane & 1) * 32u + rank[(dy + 7) * 15 + dx + 7];
    return __reduce_min_sync(kFull, key);
  }
#pragma unroll
  for (int c = 0; c < 4; c++) {
    const int g = g0 + c, dy = g / 5 - 2, dx = g % 5 - 2;
    if (g < 25 && abs(cy + dy) <= lim && abs(cx + dx) <= lim)
      key = min(key, half16(w2[c >> 1], c & 1) * 32u +
                         rank[(dy + 7) * 15 + dx + 7]);
  }
#pragma unroll
  for (int m = 2; m <= 8; m <<= 1)
    key = min(key, __shfl_xor_sync(kFull, key, m));
  return key;
}

// The half-pel stage around the full-pel vector (fy, fx) (the lane's
// block's or the MB's); returns the least key sad * 16 + k as
// fullpel_key does.
__device__ __forceinline__ unsigned halfpel_key(const uint32_t* win, int y,
                                                int h, int fy, int fx,
                                                uint32_t c0, uint32_t c1,
                                                const uint8_t* rank,
                                                int lane, bool whole_mb) {
  uint32_t part[9], w8[8], w4[4], w2[2], w1[1];
  halfpel_parts(win, y, h, fy, fx, c0, c1, part);
  pack(part, w8);
  fold(w8, w4, 2, lane);
  fold(w4, w2, 4, lane);
  fold(w2, w1, 8, lane);
  // Word 4 a + 2 b + c of the block: cells 8 a + 4 b + 2 c + e.
  uint32_t v = w1[0];
  if (whole_mb) {
    v += __shfl_xor_sync(kFull, v, 16);
    v += __shfl_xor_sync(kFull, v, 1);
  }
  const int g0 = ((lane >> 1) & 1) * 8 + ((lane >> 2) & 1) * 4 +
                 ((lane >> 3) & 1) * 2;
  unsigned key = 0xffffffffu;
#pragma unroll
  for (int e = 0; e < 2; e++) {
    const int g = g0 + e;
    if (g < 9)
      key = min(key, half16(v, e) * 16u +
                         rank[(g / 3 + 6) * 15 + g % 3 + 6]);
  }
  if (whole_mb) return __reduce_min_sync(kFull, key);
#pragma unroll
  for (int m = 2; m <= 8; m <<= 1)
    key = min(key, __shfl_xor_sync(kFull, key, m));
  return key;
}

struct SearchOut {
  int32_t *mv, *sad_mv, *sad_nomv;   // [B][n][2], [B][n], [B][n]
  int32_t *gmv, *sad_gmv, *sad_gold;
  int32_t *sad_intra, *bmv, *bsad4;  // [B][n], [B][2nv][2nh][2], [B][n]
};

// kOrder in shared memory, and its inverse: rank[(dy + 7) * 15 + dx + 7]
// = k.
__device__ __forceinline__ void build_order(int8_t (*order)[2],
                                            uint8_t* rank) {
  for (int t = threadIdx.x; t < kCoarse; t += blockDim.x) {
    const int dy = kOrder[t][0], dx = kOrder[t][1];
    order[t][0] = (int8_t)dy;
    order[t][1] = (int8_t)dx;
    rank[(dy + 7) * 15 + dx + 7] = (uint8_t)t;
  }
}

__global__ void __launch_bounds__(kWarps * 32)
me_search_kernel(const uint8_t* __restrict__ ys,
                 const int64_t* __restrict__ gold_idx, int H, int W,
                 SearchOut out) {
  __shared__ __align__(16) uint32_t s_win[kWinW];
  __shared__ __align__(16) uint32_t s_pyr[kPyrRows * kPyrW];
  // Per warp: cur [16][4] words, then its 2x2 sums [8][4].
  __shared__ __align__(16) uint32_t s_curs[kWarps][64 + 32];
  __shared__ int8_t s_order[kCoarse][2];
  __shared__ uint8_t s_rank[kCoarse];
  build_order(s_order, s_rank);  // read after the staging's barrier
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int nh = W >> 4, nv = H >> 4, n = nh * nv;
  const int nq = (nh + kWarps - 1) / kWarps;  // CTAs per MB row
  const int mby = blockIdx.x / nq, mbx0 = (blockIdx.x - mby * nq) * kWarps;
  const int mbx = mbx0 + w, mb = mby * nh + mbx;
  const int r = blockIdx.y, z = blockIdx.z;
  const size_t plane = (size_t)H * W;
  const uint8_t* cur = ys + (size_t)(r + 1) * plane;
  // gold_idx must lie in [0, F) (F = gridDim.y + 1 frames); an index
  // outside traps, as PyTorch's indexing raises a device-side assert.
  const int64_t g = z ? gold_idx[r] : r;
  if (g < 0 || g > (int64_t)gridDim.y) __trap();
  const uint8_t* ref = ys + (size_t)g * plane;
  const bool vec = (reinterpret_cast<uintptr_t>(ys) & 15) == 0;
  const bool fast = vec && mby >= 1 && mby <= nv - 2 && mbx0 >= 1 &&
                    mbx0 + kWarps <= nh - 1;
  uint32_t* s_cur = s_curs[w];
  uint32_t* s_cur2 = s_cur + 64;
  // Lane (y, h): bytes 8h .. 8h + 7 of MB row y, loaded before the window
  // so that both loads are in flight together.
  const int y = lane >> 1, h = lane & 1;
  uint32_t c0 = 0, c1 = 0;
  if (mbx < nh) {
    const uint8_t* p = cur + (size_t)(16 * mby + y) * W + 16 * mbx + 8 * h;
    if (vec) {
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
      c0 = v.x;
      c1 = v.y;
    } else {
      c0 = p[0] | (p[1] << 8) | (p[2] << 16) | ((uint32_t)p[3] << 24);
      c1 = p[4] | (p[5] << 8) | (p[6] << 16) | ((uint32_t)p[7] << 24);
    }
    s_cur[4 * y + 2 * h] = c0;
    s_cur[4 * y + 2 * h + 1] = c1;
  }
  stage_reference(s_win, s_pyr, ref, H, W, mby, mbx0, vec, fast);
  __syncthreads();
  if (mbx >= nh) return;
  // This warp's MB: window word 4w is its column -16, pyramid word 4w its
  // pyramid column -1.
  const uint32_t* win = s_win + 4 * w;
  const uint32_t* pyr = s_pyr + 4 * w;
  s_cur2[lane] = pair_sums(s_cur[8 * (lane >> 2) + (lane & 3)],
                           s_cur[8 * (lane >> 2) + 4 + (lane & 3)]);
  __syncwarp();
  uint32_t c2[8][4];
#pragma unroll
  for (int i = 0; i < 8; i++) {
    const uint4 v = reinterpret_cast<const uint4*>(s_cur2)[i];
    c2[i][0] = v.x;
    c2[i][1] = v.y;
    c2[i][2] = v.z;
    c2[i][3] = v.w;
  }

  // (a) coarse, (b) full-pel around twice its vector, (c) half-pel.
  const uint32_t csum = __reduce_add_sync(kFull,
                                          sad4(c1, 0u, sad4(c0, 0u, 0u)));
  unsigned key = coarse_search(pyr, c2, csum, s_rank, lane);
  const int cy = 2 * s_order[key & 255][0], cx = 2 * s_order[key & 255][1];
  key = fullpel_key(win, y, h, cy, cx, kMvMax, c0, c1, s_rank, lane, true);
  const int fy = cy + s_order[key & 31][0], fx = cx + s_order[key & 31][1];
  key = halfpel_key(win, y, h, fy, fx, c0, c1, s_rank, lane, true);
  const int sad = (int)(key >> 4);
  const int my = 2 * fy + s_order[key & 15][0];
  const int mx = 2 * fx + s_order[key & 15][1];

  // (d) the SAD at offset 0.
  const uint32_t* row0 = win + (16 + y) * kRowW + 4 + 2 * h;
  const int d = (int)__reduce_add_sync(kFull,
                                       sad4(c1, row0[1], sad4(c0, row0[0],
                                                              0)));

  const size_t o = (size_t)r * n + mb;
  if (lane == 0) {
    int32_t* mvo = z ? out.gmv : out.mv;
    mvo[2 * o] = mx;
    mvo[2 * o + 1] = my;
    (z ? out.sad_gmv : out.sad_mv)[o] = sad;
    (z ? out.sad_gold : out.sad_nomv)[o] = d;
  }
  if (z) return;

  // sad_intra: the lane's block (y >> 3, h) is the 8 lanes whose bits 1-3
  // vary.
  {
    uint32_t s = sad4(c1, 0u, sad4(c0, 0u, 0u));
    s += __shfl_xor_sync(kFull, s, 2);
    s += __shfl_xor_sync(kFull, s, 4);
    s += __shfl_xor_sync(kFull, s, 8);
    const uint32_t mean = (s >> 6) * 0x01010101u;
    const uint32_t dev = __reduce_add_sync(kFull,
                                           sad4(c1, mean, sad4(c0, mean,
                                                               0u)));
    if (lane == 0) out.sad_intra[o] = (int)dev;
  }

  // (e) 4MV: the four 8x8 blocks, searched at once, around the winner's
  // first tap.
  const int by = clampi(first_tap(my), -kBlockMax, kBlockMax);
  const int bx = clampi(first_tap(mx), -kBlockMax, kBlockMax);
  key = fullpel_key(win, y, h, by, bx, kBlockMax, c0, c1, s_rank, lane,
                    false);
  const int gy = by + s_order[key & 31][0], gx = bx + s_order[key & 31][1];
  key = halfpel_key(win, y, h, gy, gx, c0, c1, s_rank, lane, false);
  const int jy = y >> 3;
  if ((lane & 14) == 0) {
    const size_t q = ((size_t)r * 2 * nv + 2 * mby + jy) * (2 * nh) +
                     2 * mbx + h;
    out.bmv[2 * q] = 2 * gx + s_order[key & 15][1];
    out.bmv[2 * q + 1] = 2 * gy + s_order[key & 15][0];
  }
  unsigned bsum = key >> 4;
  bsum += __shfl_xor_sync(kFull, bsum, 1);
  bsum += __shfl_xor_sync(kFull, bsum, 16);
  if (lane == 0) out.bsad4[o] = (int)bsum;
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

__global__ void __launch_bounds__(kCandWarps * 32)
me_cand_sads_kernel(const uint8_t* __restrict__ ys,
                    const int32_t* __restrict__ cands, int H, int W,
                    int32_t* __restrict__ cand_sads) {
  // One window of prev for the CTA's kCandWarps MBs of one MB row.
  __shared__ __align__(16) uint32_t s_win[kSide * kCandRowW + 4];
  __shared__ uint32_t s_out[kCandWarps][kCands / 2];
  // Per candidate, its two taps' word offsets in the window and byte
  // shifts: (o1y kCandRowW + o1x >> 2, 8 (o1x & 3), the same for o2).
  __shared__ int4 s_tap[kCands];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int nh = W >> 4, n = nh * (H >> 4);
  const int nq = (nh + kCandWarps - 1) / kCandWarps;  // CTAs per MB row
  const int mby = blockIdx.x / nq;
  const int mbx0 = (blockIdx.x - mby * nq) * kCandWarps, mbx = mbx0 + w;
  const int r = blockIdx.y;
  const size_t plane = (size_t)H * W;
  const bool vec = (reinterpret_cast<uintptr_t>(ys) & 15) == 0;
  if (threadIdx.x < kCands) {
    const int32_t* cv = cands + ((size_t)r * kCands + threadIdx.x) * 2;
    const int mx = cv[0], my = cv[1];
    const int o1y = first_tap(my), o1x = first_tap(mx);
    const int o2y = o1y + sgn(my) * (abs(my) & 1);
    const int o2x = o1x + sgn(mx) * (abs(mx) & 1);
    s_tap[threadIdx.x] = make_int4(o1y * kCandRowW + (o1x >> 2),
                                   8 * (o1x & 3),
                                   o2y * kCandRowW + (o2x >> 2),
                                   8 * (o2x & 3));
  }
  // Lane (y, h): bytes 8h .. 8h + 7 of MB row y of cur.
  const int y = lane >> 1, h = lane & 1;
  uint32_t c0 = 0, c1 = 0;
  if (mbx < nh) {
    const uint8_t* p = ys + (size_t)(r + 1) * plane +
                       (size_t)(16 * mby + y) * W + 16 * mbx + 8 * h;
    if (vec) {
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
      c0 = v.x;
      c1 = v.y;
    } else {
      c0 = p[0] | (p[1] << 8) | (p[2] << 16) | ((uint32_t)p[3] << 24);
      c1 = p[4] | (p[5] << 8) | (p[6] << 16) | ((uint32_t)p[7] << 24);
    }
  }
  stage_window(s_win, ys + (size_t)r * plane, H, W, mby, mbx0, kCandChunks,
               kCandRowW, vec, threadIdx.x, blockDim.x);
  __syncthreads();
  if (mbx < nh) {
    // The lane's bytes at offset (0, 0): window row 16 + y, word 4 + 2h
    // from the MB's column -16 (word 4w).
    const uint32_t* base = s_win + (16 + y) * kCandRowW + 4 * w + 4 + 2 * h;
    uint32_t part[kCands];
#pragma unroll
    for (int k = 0; k < kCands; k++) {
      const int4 t = s_tap[k];
      const uint32_t* p1 = base + t.x;
      const uint32_t* p2 = base + t.z;
      const uint32_t a0 = bytes_at(p1[0], p1[1], t.y);
      const uint32_t a1 = bytes_at(p1[1], p1[2], t.y);
      const uint32_t b0 = bytes_at(p2[0], p2[1], t.w);
      const uint32_t b1 = bytes_at(p2[1], p2[2], t.w);
      part[k] = sad4(c1, __vhaddu4(a1, b1), sad4(c0, __vhaddu4(a0, b0), 0));
    }
    uint32_t w8[8], w4[4], w2[2], w1[1];
    pack(part, w8);
    fold(w8, w4, 16, lane);
    fold(w4, w2, 8, lane);
    fold(w2, w1, 4, lane);
    uint32_t v = w1[0];
    v += __shfl_xor_sync(kFull, v, 2);
    v += __shfl_xor_sync(kFull, v, 1);
    // Word 4 (lane bit 4) + 2 (bit 3) + (bit 2): candidates 2 word + e.
    if ((lane & 3) == 0)
      s_out[w][((lane >> 4) & 1) * 4 + ((lane >> 3) & 1) * 2 +
               ((lane >> 2) & 1)] = v;
  }
  __syncthreads();
  // Neighbouring threads store neighbouring MBs of one candidate.
  const int t = threadIdx.x;
  if (t < kCands * kCandWarps) {
    const int k = t / kCandWarps, m = t - k * kCandWarps;
    if (mbx0 + m < nh)
      cand_sads[((size_t)r * kCands + k) * n + mby * nh + mbx0 + m] =
          (int32_t)half16(s_out[m][k >> 1], k & 1);
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
  const SearchOut out = {mv, sad_mv, sad_nomv, gmv, sad_gmv, sad_gold,
                         sad_intra, bmv, bsad4};
  const int nv = H >> 4, nq = ((W >> 4) + kWarps - 1) / kWarps;
  const dim3 grid((unsigned)(nv * nq), (unsigned)nrows, 2);
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
  const int nq = ((W >> 4) + kCandWarps - 1) / kCandWarps;
  const dim3 grid((unsigned)((H >> 4) * nq), (unsigned)nrows);
  me_cand_sads_kernel<<<grid, kCandWarps * 32, 0, (cudaStream_t)stream>>>(
      ys, cands, H, W, cand_sads);
  return (int)cudaGetLastError();
}
