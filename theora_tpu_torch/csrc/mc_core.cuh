// Kernel KS's row core: motion compensation of one fragment row and the
// plane's assembly with its UMV borders, on the layout every encode-side
// kernel shares (8 lanes per fragment or block, lane i holding raster row
// i). Shared by KS's own entries (csrc/mc.cu), by K2's and KR's fused
// entries (csrc/fdct_quant.cu: th_mc_fdct_quant, csrc/quantize_rd.cu:
// th_mc_fdct_quant_rd), which make the residual row where K2's block core
// loads it, and by K1's fused encode entry (csrc/idct.cu:
// th_mc_idct_recon_skip), which makes the prediction row where the
// chooser reads it and runs the skip test and the plane's assembly on the
// kept row.
//
// The functions are integer only (the file builds alike with and without
// -fmad=false). An offset that would read outside its padded plane, or a
// fragment id outside 0..n-1, traps the kernel (the plain version's
// indexing raises).
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr uint64_t kLow7 = 0xfefefefefefefefeull;

struct Geo {
  int nv, nh, pad_y, pad_x, Hp, Wp;
};

__device__ __forceinline__ size_t plane_bytes(const Geo& q) {
  return (size_t)q.Hp * q.Wp;
}

// The 8 bytes at p, any alignment, inside a buffer whose size is a
// multiple of 8: the aligned word around p and, off alignment, the next.
__device__ __forceinline__ uint64_t load8(const uint8_t* p) {
  const uintptr_t a = (uintptr_t)p;
  const unsigned long long* w =
      reinterpret_cast<const unsigned long long*>(a & ~(uintptr_t)7);
  const int s = (int)(a & 7) * 8;
  const uint64_t lo = __ldg(w);
  return s == 0 ? lo : (lo >> s) | ((uint64_t)__ldg(w + 1) << (64 - s));
}

__device__ __forceinline__ uint64_t load8a(const uint8_t* p) {
  return __ldg(reinterpret_cast<const unsigned long long*>(p));
}

__device__ __forceinline__ void store8(uint8_t* p, uint64_t v) {
  *reinterpret_cast<unsigned long long*>(p) = v;
}

__device__ __forceinline__ int byte_at(uint64_t v, int j) {
  return (int)((v >> (8 * j)) & 0xff);
}

__device__ __forceinline__ uint64_t splat(uint64_t byte) {
  return byte * 0x0101010101010101ull;
}

// Row i of fragment (r, c)'s prediction as 8 bytes: 128 where rs == 0,
// else from ref (prev's or gold's plane) at (y1, x1), averaged with (y2,
// x2) where u2. side holds the six int8 rows rs, y1, x1, y2, x2, u2 of
// `stride` entries each, entry e for this fragment.
__device__ __forceinline__ uint64_t predict_row(
    const uint8_t* prev, const uint8_t* gold, const int8_t* side,
    int stride, int e, const Geo& q, int r, int c, int i) {
  const int rs = side[e];
  if (rs == 0) return splat(128);
  const int y1 = side[stride + e], x1 = side[2 * stride + e];
  const int y2 = side[3 * stride + e], x2 = side[4 * stride + e];
  const bool u2 = side[5 * stride + e] != 0;
  const uint8_t* ref = rs == 2 ? gold : prev;
  const int y = q.pad_y + 8 * r, x = q.pad_x + 8 * c;
  const int ya = y + y1, xa = x + x1, yb = y + y2, xb = x + x2;
  if (ya < 0 || ya + 8 > q.Hp || xa < 0 || xa + 8 > q.Wp ||
      (u2 && (yb < 0 || yb + 8 > q.Hp || xb < 0 || xb + 8 > q.Wp)))
    __trap();
  const uint64_t a = load8(ref + (size_t)(ya + i) * q.Wp + xa);
  if (!u2) return a;
  const uint64_t b = load8(ref + (size_t)(yb + i) * q.Wp + xb);
  return (a & b) + (((a ^ b) & kLow7) >> 1);
}

// Row i of fragment (r, c) into the padded plane pl, and the padding this
// lane owns: the side borders of its row where c is 0 or nh-1, and where
// r is 0 or nv-1 the padding rows i, i + 8, ... above or below its
// columns (top: row 0 of the fragment; bot: its row 7), with the corners.
// With borders 0 the padding is zeros.
__device__ __forceinline__ void put_row(uint8_t* pl, const Geo& q, int r,
                                        int c, int i, uint64_t v,
                                        uint64_t top, uint64_t bot,
                                        bool borders) {
  const int Wp = q.Wp;
  const int x = q.pad_x + 8 * c;
  const int xr = q.pad_x + 8 * q.nh;  // the right border's first byte
  const int nw = q.pad_x / 8;
  const bool left = c == 0, right = c == q.nh - 1;
  auto side_words = [&](uint8_t* row, uint64_t w) {
    if (left) {
      const uint64_t s = borders ? splat(w & 0xff) : 0;
      for (int k = 0; k < nw; k++) store8(row + 8 * k, s);
    }
    if (right) {
      const uint64_t s = borders ? splat(w >> 56) : 0;
      for (int k = 0; k < nw; k++) store8(row + xr + 8 * k, s);
    }
  };
  uint8_t* row = pl + (size_t)(q.pad_y + 8 * r + i) * Wp;
  store8(row + x, v);
  side_words(row, v);
  if (r == 0) {
    const uint64_t w = borders ? top : 0;
    for (int y = i; y < q.pad_y; y += 8) {
      uint8_t* pr = pl + (size_t)y * Wp;
      store8(pr + x, w);
      side_words(pr, top);
    }
  }
  if (r == q.nv - 1) {
    const uint64_t w = borders ? bot : 0;
    for (int y = i; y < q.pad_y; y += 8) {
      uint8_t* pr = pl + (size_t)(q.pad_y + 8 * q.nv + y) * Wp;
      store8(pr + x, w);
      side_words(pr, bot);
    }
  }
}

// Row i of a kept block as the frag group's all-gather input: its 8
// pixels at 8 i of the block's 65-byte row, and the coded flag at 64.
__device__ __forceinline__ void put_gather_row(uint8_t* o, int i, uint64_t v,
                                               bool cd) {
#pragma unroll
  for (int j = 0; j < 8; j++) o[8 * i + j] = (uint8_t)byte_at(v, j);
  if (i == 0) o[64] = cd;
}

// The fragment of block b: (segment g, fragment index f), checked.
__device__ __forceinline__ void locate(int b, int nl, int n,
                                       const int32_t* fid, int& g, int& f) {
  g = b / nl;
  const int j = b - g * nl;
  f = fid ? __ldg(fid + j) : j;
  if (f < 0 || f >= n) __trap();
}

// The inputs of the encode scan's MC over N = G nl blocks: G stacked
// [Hp][Wp] reference planes prev and gold (may be one buffer), the source
// blocks cur [N][64], the side rows [6][N] and the fragment ids fid [nl]
// (or null: nl = nv nh).
struct McSrc {
  const uint8_t* prev;
  const uint8_t* gold;
  const uint8_t* cur;
  const int8_t* side;
  const int32_t* fid;
  Geo q;
};

// Block `local` of segment seg (block b = seg nl + local of N): its
// fragment (r, c), checked, and its segment's reference planes.
struct McFrag {
  int r, c;
  const uint8_t* prev;
  const uint8_t* gold;
};

__device__ __forceinline__ McFrag mc_frag(const McSrc& s, int64_t seg,
                                          int64_t local) {
  const int n = s.q.nv * s.q.nh;
  const int f = s.fid ? __ldg(s.fid + local) : (int)local;
  if (f < 0 || f >= n) __trap();
  const int r = f / s.q.nh;
  const size_t off = (size_t)seg * plane_bytes(s.q);
  return {r, f - r * s.q.nh, s.prev + off, s.gold + off};
}

// A residual row as K2's block core loads it (8 int16 in memory order):
// the source row cw minus the prediction row pw, bytewise.
__device__ __forceinline__ int4 residual_row(uint64_t cw, uint64_t pw) {
  uint32_t w[4];
#pragma unroll
  for (int m = 0; m < 4; m++) {
    const int lo = byte_at(cw, 2 * m) - byte_at(pw, 2 * m);
    const int hi = byte_at(cw, 2 * m + 1) - byte_at(pw, 2 * m + 1);
    w[m] = (uint32_t)(uint16_t)lo | (uint32_t)hi << 16;
  }
  return make_int4((int)w[0], (int)w[1], (int)w[2], (int)w[3]);
}

// Raster row i of block b = seg nl + local's residual (source minus
// prediction) of the N = total blocks of s, made in registers: the row
// K2's block core would load from mc_residual's res.
__device__ __forceinline__ int4 mc_residual_row(const McSrc& s, int64_t seg,
                                                int64_t local, int64_t b,
                                                int64_t total, int i) {
  const McFrag fr = mc_frag(s, seg, local);
  const uint64_t cw = load8a(s.cur + b * 64 + 8 * i);
  const uint64_t pw = predict_row(fr.prev, fr.gold, s.side, (int)total,
                                  (int)b, s.q, fr.r, fr.c, i);
  return residual_row(cw, pw);
}

// Host side: the geometry every KS entry checks.
inline bool bad_geometry(int G, const Geo& q) {
  return G < 1 || q.nv < 1 || q.nh < 1 || q.pad_y < 2 || q.pad_x < 8 ||
         q.pad_x % 8 || q.Hp != 8 * q.nv + 2 * q.pad_y ||
         q.Wp != 8 * q.nh + 2 * q.pad_x;
}

inline bool misaligned(const void* p, int n) {
  return (uintptr_t)p % n != 0;
}

}  // namespace
