// Kernel KL: the in-loop deblocking filter and the UMV borders after it,
// for NVIDIA Hopper (sm_90a).
//
// Replaces theora_tpu/ops/loopfilter_jax.py:loop_filter_plane_jax (:71),
// which XLA compiles on the TPU (no Pallas kernel), and the border
// replication that follows it (theora_tpu/pipeline.py:122 fill_borders).
// Plain PyTorch version and CPU path: theora_tpu_torch/ops/loopfilter.py:
// loop_filter_plane, the JAX function's three globally batched phases
// (P1: the h filters of rows 1-6 of every fragment row; B: the
// bottom-edge chains, which write row 7 of a fragment row and row 0 of
// the next; A: the top-edge chains, which write row 7 of the fragment row
// above and row 0), whose result is libtheora's raster edge order
// (state.c:1055-1105), then ops/loopfilter.py:fill_borders (state.c:
// 770-835). The output must equal theirs byte for byte.
//
// Interface: G planes in [G][Hp][Wp] uint8, coded flags [G][nv][nh] (one
// byte each, 0 or 1), the filter limit of each plane (limits[G] int32 on
// the card, or one limit by value when limits is null), the fragment grid
// nv x nh and the padding pad_y, pad_x (the image's first pixel is (pad_y,
// pad_x)), with Hp = 8 nv + 2 pad_y, Wp = 8 nh + 2 pad_x, pad_x a multiple
// of 8 from 8 on, pad_y >= 2. The filtered planes, their borders filled,
// go to out, never in place: lane (r, c) reads the pre-filter rows 6 and 7
// of fragment row r - 1, which lane (r - 1, c) writes.
//
// One launch, no barrier, no shared memory. Take y0 = pad_y + 8 r. From
// the phases' dependencies:
//   rows y0+1 .. y0+6 end as P1 left them (B and A write rows 7 and 0);
//   rows y0-1 and y0 end as A(r) leaves them, after B(r-1). B(r-1) reads
//     the pre-filter rows y0-2, y0-1, y0, y0+1, row y0-2 after P1, and the
//     flags of rows r-1 and r; A(r) reads row y0-2 after P1, B(r-1)'s
//     rows y0-1 and y0, row y0+1 before and after P1, and the flags of r;
//   row y0+7 of the last fragment row ends as B(nv-1) leaves it; its vE is
//     masked, so that is the plain h filters of the pre-filter row.
// Lane (r, c) owns block column c of fragment row r: it loads the
// pre-filter rows y0-2 .. y0+7 of its 8 pixels as ten 8-byte words, all
// issued before the first use, and its flags of rows r-1 and r, runs
// B(r-1) and A(r) in registers, and writes its rows y0-1 .. y0+6 as 8-byte
// words (y0+7 too in the last fragment row). Across columns the phases
// reach only the neighbouring block columns: pixels 6-7 of c-1 and 0-1 of
// c+1 of each row, c-1's vE outputs (ve6/ve7, B's step 1) and vL outputs
// (vb6/vb7, A's step 1), c+1's corner h outputs (h7m1, B's step 2; h0m1,
// A's step 2), and the flags of c-1 and c+1. Each is one shuffle up or
// down the warp. None of the values lane c takes from a neighbour depends
// on the neighbour's own neighbour on the far side. So a warp of 32 lanes
// holds block columns c0-1 .. c0+30 of one fragment row, c0 = 30 t: lanes
// 0 and 31 are a halo that computes from the same pixels and flags as the
// lanes that own those columns, and writes nothing; lanes 1-30 write
// columns c0 .. c0+29 (tiles overlap by two columns). A lane off the grid
// (column -1, or nh and beyond) reads the padding column beside the grid,
// has flags 0, and writes nothing; the h edge of column 0 and of column
// nh never fires. The borders: the warps of fragment row 0 write the pad_y
// rows above (row y0 replicated), those of row nv-1 the pad_y rows below
// (row y0+7), each lane its own 8 bytes; the warps of the first and the
// last tile write the left and right pad_x bytes of their rows and of
// those pad rows (the corners), the row's first or last image pixel
// replicated, which the lane of column 0 or nh-1 hands the whole warp by
// shuffles, so that one store of the warp covers up to 32 words, not one
// lane row by row. Every byte of out has one writer. Per-lane
// names follow the plain version's (ve6/ve7 = ve6_row7/ve7_row7, h7m1/h70
// = h7_m1/h7_0, vb6/vb7 = vb6_row0/vb7_row0, h0m1/h00 = h0_m1/h0_0).
//
// Arithmetic, as the plain version's: f = p0 - p3 + 3 (p2 - p1), the
// response to f at twice the limit L2 sign(R) max(0, min(|R|, L2 - |R|))
// with R = (f + 4) >> 3 (the bounding table of state.c:1036-1045 in
// closed form), pixels clamped to [0, 255]. Integer only. A limit <= 0
// gives a response of 0 everywhere, so such a plane is copied, its
// borders filled.
//
// Bound: bytes. A 720p frame's three padded planes are 1,479,936 B, read
// and written once ~0.9 us at 3.35 TB/s; the filter's integer work is a
// few million operations (~0.1 us). Both are far below one launch's
// latency (~9 us on this card), so latency binds KL at these sizes: a
// lane's chain of dependent steps, not the bytes. The design keeps that
// chain short: one round trip to memory per lane (ten independent 8-byte
// loads), every phase in registers with shuffles for the neighbours in
// place of shared memory and barriers, 8-byte stores, and enough warps to
// reach every SM (540 at 720p luma, 135 per 4:2:0 chroma plane). The
// borders ride in the same launch, so the callers run no border pass
// after a filtered step.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;   // warps per CTA
constexpr int kTile = 30;   // block columns a warp writes
constexpr int kRows = 10;   // pre-filter rows y0-2 .. y0+7
constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ int resp(int f, int lim2) {
  const int r = (f + 4) >> 3;
  const int a = abs(r);
  const int m = max(min(a, lim2 - a), 0);
  return r < 0 ? -m : m;
}

__device__ __forceinline__ int f4(int p0, int p1, int p2, int p3) {
  return p0 - p3 + 3 * (p2 - p1);
}

__device__ __forceinline__ int clamp255(int v) { return min(max(v, 0), 255); }

// One pre-filter row as a lane holds it: its own pixels 0-3 (a) and 4-7
// (b), the left neighbour's pixels 4-7 (l) and the right neighbour's 0-3
// (r).
struct Row {
  uint32_t l, a, b, r;
};

// Pixel i of the row, i in [-4, 12): below 0 the left neighbour's, from 8
// the right neighbour's.
__device__ __forceinline__ int px(const Row& w, int i) {
  const uint32_t v = i < 0 ? w.l : i < 4 ? w.a : i < 8 ? w.b : w.r;
  return (v >> (8 * (i & 3))) & 0xff;
}

// The response of the vertical edge left of pixel i.
__device__ __forceinline__ int hresp(const Row& w, int i, int lim2) {
  return resp(f4(px(w, i - 2), px(w, i - 1), px(w, i), px(w, i + 1)), lim2);
}

// Pixel j of the row after its own h filters (phase P1): hl, hr say that
// the h edge left, right of this block column fires.
__device__ __forceinline__ int p1(const Row& w, int j, bool hl, bool hr,
                                  int lim2) {
  if (j == 0 && hl) return clamp255(px(w, 0) - hresp(w, 0, lim2));
  if (j == 7 && hr) return clamp255(px(w, 7) + hresp(w, 8, lim2));
  return px(w, j);
}

__device__ __forceinline__ uint32_t bytes4(int a, int b, int c, int d) {
  return (uint32_t)a | (uint32_t)b << 8 | (uint32_t)c << 16 |
         (uint32_t)d << 24;
}

__device__ __forceinline__ uint2 pack(const int (&v)[8]) {
  return make_uint2(bytes4(v[0], v[1], v[2], v[3]),
                    bytes4(v[4], v[5], v[6], v[7]));
}

// Row w after P1: pixels 0 and 7 replaced.
__device__ __forceinline__ uint2 p1_row(const Row& w, bool hl, bool hr,
                                        int lim2) {
  return make_uint2((w.a & 0xffffff00u) | p1(w, 0, hl, hr, lim2),
                    (w.b & 0x00ffffffu) | (uint32_t)p1(w, 7, hl, hr, lim2)
                                              << 24);
}

__device__ __forceinline__ uint2 splat(int v) {
  const uint32_t s = 0x01010101u * (uint32_t)v;
  return make_uint2(s, s);
}

__global__ void __launch_bounds__(32 * kWarps)
loop_filter_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                   const uint8_t* __restrict__ coded,
                   const int32_t* __restrict__ limits, int limit, int Wp,
                   int nv, int nh, int pad_y, int pad_x, int tiles) {
  const int warp = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (warp >= nv * tiles) return;  // the whole warp
  const int lane = threadIdx.x & 31;
  const int r = warp / tiles;
  const int c = kTile * (warp - r * tiles) - 1 + lane;
  const int g = blockIdx.y;
  const size_t plane = (size_t)(8 * nv + 2 * pad_y) * Wp;
  const uint8_t* src = in + g * plane;
  uint8_t* dst = out + g * plane;
  const int y0 = pad_y + 8 * r;
  const bool on_grid = c >= 0 && c < nh;
  // This lane's pixel column; off the grid, the padding column beside it.
  const int x = pad_x + 8 * min(max(c, -1), nh);

  Row w[kRows];
#pragma unroll
  for (int k = 0; k < kRows; k++) {
    const uint2 v = __ldg(
        reinterpret_cast<const uint2*>(src + (size_t)(y0 - 2 + k) * Wp + x));
    w[k].a = v.x;
    w[k].b = v.y;
  }
  const uint8_t* cg = coded + (size_t)g * nv * nh;
  const bool fa = on_grid && r > 0 && cg[(size_t)(r - 1) * nh + c];
  const bool fb = on_grid && cg[(size_t)r * nh + c];
  const int lim2 = 2 * (limits ? __ldg(limits + g) : limit);

#pragma unroll
  for (int k = 0; k < kRows; k++) {
    w[k].l = __shfl_up_sync(kAll, w[k].b, 1);
    w[k].r = __shfl_down_sync(kAll, w[k].a, 1);
  }
  const Row& S6 = w[0];   // y0-2
  const Row& S7 = w[1];   // y0-1
  const Row& B10 = w[2];  // y0
  const Row& B11 = w[3];  // y0+1
  // Flags are 0 off the grid (and fa in fragment row 0).
  const int fl = fa | fb << 1;
  const int fl_l = __shfl_up_sync(kAll, fl, 1);
  const int fl_r = __shfl_down_sync(kAll, fl, 1);
  const bool fa_l = fl_l & 1, fb_l = fl_l >> 1;
  const bool nxt = fl_r & 1;  // fa of column c+1
  // The h edges left of this column (hfire; never at columns 0 and nh)
  // and right of it.
  const bool inner = c > 0 && c < nh;
  const bool hfa = inner && (fa || fa_l);
  const bool hfb = inner && (fb || fb_l);
  const int hf_r = __shfl_down_sync(kAll, hfa | hfb << 1, 1);
  const bool hfa_r = hf_r & 1, hfb_r = hf_r >> 1;

  // B(r-1), step 1: the vE filters of columns 6 and 7 on row y0-1.
  const int ve6 = clamp255(
      px(S7, 6) + resp(f4(px(S6, 6), px(S7, 6), px(B10, 6), px(B11, 6)),
                       lim2));
  const int in6 = nxt ? px(S6, 7) : p1(S6, 7, hfa, hfa_r, lim2);
  const int in7 = nxt || c + 1 == nh
                      ? px(S7, 7)
                      : clamp255(px(S7, 7) + hresp(S7, 8, lim2));
  const int ve7 =
      clamp255(in7 + resp(f4(in6, in7, px(B10, 7), px(B11, 7)), lim2));
  // Step 2: the h filter of row y0-1 left of column c, on the left
  // neighbour's vE outputs where that edge fired before this one.
  const int ve_l = __shfl_up_sync(kAll, ve6 | ve7 << 8, 1);
  const bool use_post = fa && fa_l && !fb_l;
  const int m2b = use_post ? ve_l & 0xff : px(S7, -2);
  const int m1b = use_post ? ve_l >> 8 : px(S7, -1);
  const int rp = resp(f4(m2b, m1b, px(S7, 0), px(S7, 1)), lim2);
  const int h7m1 = clamp255(m1b + rp);
  const int h70 = clamp255(px(S7, 0) - rp);
  const int h7m1_r = __shfl_down_sync(kAll, h7m1, 1);
  // Step 3: rows y0-1 and y0 after B(r-1), pixel by pixel (the pre-filter
  // rows in fragment row 0, whose flags fa are 0).
  const bool ve = fa && !fb;
  int b1[8], s0[8];
#pragma unroll
  for (int j = 0; j < 8; j++) {
    int r6 = px(S6, j), r7 = px(S7, j);
    if (j == 0) {
      r6 = p1(S6, 0, hfa, hfa_r, lim2);
      if (hfa) r7 = h70;
    } else if (j == 7 && !nxt) {
      r6 = p1(S6, 7, hfa, hfa_r, lim2);
      if (hfa_r) r7 = h7m1_r;
    }
    int m1 = px(S7, j), z0 = px(B10, j);
    if (ve) {
      const int re = resp(f4(r6, r7, px(B10, j), px(B11, j)), lim2);
      m1 = clamp255(r7 + re);
      z0 = clamp255(px(B10, j) - re);
    }
    // The corner h writes: column 7 by the next column's edge unless that
    // edge ran before this column's vE; column 0 by its own edge where no
    // vE overwrote it.
    if (j == 7 && hfa_r && !(ve && !nxt)) m1 = h7m1_r;
    if (j == 0 && hfa && !ve) m1 = h70;
    b1[j] = m1;
    s0[j] = z0;
  }

  // A(r), step 1: the vL filters of columns 6 and 7 on row y0. Row y0-2
  // is the post-P1 row of fragment row r-1 (the padding for r = 0).
  const int vb6 = clamp255(
      s0[6] - resp(f4(px(S6, 6), b1[6], s0[6], px(B11, 6)), lim2));
  const int vb7 = clamp255(
      s0[7] - resp(f4(p1(S6, 7, hfa, hfa_r, lim2), b1[7], s0[7], px(B11, 7)),
                   lim2));
  // Step 2: the h filter of row y0 left of column c, on the left
  // neighbour's vL outputs where that edge fired before this one.
  const uint32_t a_l =
      __shfl_up_sync(kAll, bytes4(vb6, vb7, s0[6], s0[7]), 1);
  const bool prev_vl = r > 0 && fb_l;
  const int m2 = prev_vl ? a_l & 0xff : (a_l >> 16) & 0xff;
  const int m1 = prev_vl ? (a_l >> 8) & 0xff : a_l >> 24;
  const int rh = resp(f4(m2, m1, s0[0], s0[1]), lim2);
  const int h0m1 = clamp255(m1 + rh);
  const int h00 = clamp255(s0[0] - rh);
  const int h0m1_r = __shfl_down_sync(kAll, h0m1, 1);

  // Rows y0-1 and y0 as A(r) leaves them.
  const bool vl = r > 0 && fb;
  int om1[8], o0[8];
#pragma unroll
  for (int j = 0; j < 8; j++) {
    int m = b1[j], z0 = s0[j];
    if (vl) {
      const int rm2 = p1(S6, j, hfa, hfa_r, lim2);
      const int r0 = j == 0 && hfb ? h00 : s0[j];
      const int r1 = j == 0 ? p1(B11, 0, hfb, hfb_r, lim2) : px(B11, j);
      const int rv = resp(f4(rm2, m, r0, r1), lim2);
      m = clamp255(m + rv);
      z0 = clamp255(r0 - rv);
    }
    if (j == 7 && hfb_r) z0 = h0m1_r;
    if (j == 0 && hfb && !vl) z0 = h00;
    om1[j] = m;
    o0[j] = z0;
  }

  // The output rows y0-1+k, k = 0 .. 8, as this lane's 8 bytes: k = 0 and
  // 1 from A(r), 2 .. 8 after P1 (k = 8 is written in the last fragment
  // row only). Rows [klo, khi) are this warp's image rows.
  uint2 out_k[9];
  out_k[0] = pack(om1);
  out_k[1] = pack(o0);
#pragma unroll
  for (int k = 2; k < 9; k++) out_k[k] = p1_row(w[k + 1], hfb, hfb_r, lim2);
  const int klo = r > 0 ? 0 : 1, khi = r == nv - 1 ? 9 : 8;
  auto put = [&](int y, int xb, uint2 v) {
    *reinterpret_cast<uint2*>(dst + (size_t)y * Wp + xb) = v;
  };
  if (on_grid && lane > 0 && lane < 31) {
#pragma unroll
    for (int k = 0; k < 9; k++)
      if (k >= klo && k < khi) put(y0 - 1 + k, x, out_k[k]);
    // The pad_y rows above and below the image: its first, last row.
    if (r == 0)
      for (int y = 0; y < pad_y; y++) put(y, x, out_k[1]);
    if (r == nv - 1)
      for (int y = y0 + 8; y < y0 + 8 + pad_y; y++) put(y, x, out_k[8]);
  }
  // A side border, pad_x bytes at xb of each row of this warp and of the
  // pad rows it writes (the corners): the first (or last) pixel of the
  // row, taken from lane src (the lane of column 0 or nh-1), written by
  // the whole warp, one 8-byte word per lane.
  const int t = warp - r * tiles;
  const int nw = pad_x / 8;
  auto side = [&](int src, int xb, bool last) {
    uint32_t e[3] = {0, 0, 0};
#pragma unroll
    for (int k = 0; k < 9; k++)
      e[k / 4] |= (last ? out_k[k].y >> 24 : out_k[k].x & 0xff)
                  << (8 * (k % 4));
#pragma unroll
    for (int q = 0; q < 3; q++) e[q] = __shfl_sync(kAll, e[q], src);
    auto edge = [&](int k) {
      return (int)((k < 4 ? e[0] : k < 8 ? e[1] : e[2]) >> (8 * (k & 3))) &
             0xff;
    };
    for (int i = lane; i < 9 * nw; i += 32) {
      const int k = i / nw;
      if (k >= klo && k < khi) put(y0 - 1 + k, xb + 8 * (i % nw),
                                   splat(edge(k)));
    }
    if (r == 0)
      for (int i = lane; i < pad_y * nw; i += 32)
        put(i / nw, xb + 8 * (i % nw), splat(edge(1)));
    if (r == nv - 1)
      for (int i = lane; i < pad_y * nw; i += 32)
        put(y0 + 8 + i / nw, xb + 8 * (i % nw), splat(edge(8)));
  };
  if (t == 0) side(1, 0, false);  // warp-uniform branches
  if (t == tiles - 1) side(nh - kTile * t, pad_x + 8 * nh, true);
}

}  // namespace

// in, out [G][Hp][Wp] uint8 (distinct buffers, 8-byte aligned); coded
// [G][nv][nh] uint8 or bool; limits [G] int32 or null (then limit for
// every plane). Hp = 8 nv + 2 pad_y, Wp = 8 nh + 2 pad_x, pad_y >= 2,
// pad_x a multiple of 8 from 8 on.
extern "C" int th_loop_filter(const uint8_t* in, uint8_t* out,
                              const uint8_t* coded, const int32_t* limits,
                              int limit, int G, int Hp, int Wp, int nv,
                              int nh, int pad_y, int pad_x, void* stream) {
  if (G < 1 || G > 65535 || nv < 1 || nh < 1 || pad_y < 2 || pad_x < 8 ||
      pad_x % 8 || Hp != 8 * nv + 2 * pad_y || Wp != 8 * nh + 2 * pad_x ||
      (uintptr_t)in % 8 || (uintptr_t)out % 8)
    return (int)cudaErrorInvalidValue;
  const int tiles = (nh + kTile - 1) / kTile;
  const long warps = (long)nv * tiles;
  loop_filter_kernel<<<dim3((unsigned)((warps + kWarps - 1) / kWarps),
                            (unsigned)G),
                       32 * kWarps, 0, (cudaStream_t)stream>>>(
      in, out, coded, limits, limit, Wp, nv, nh, pad_y, pad_x, tiles);
  return (int)cudaGetLastError();
}
