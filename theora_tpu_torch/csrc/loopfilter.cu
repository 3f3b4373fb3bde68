// Kernel KL: the in-loop deblocking filter for NVIDIA Hopper (sm_90a).
//
// Replaces theora_tpu/ops/loopfilter_jax.py:loop_filter_plane_jax (:71),
// which XLA compiles on the TPU (no Pallas kernel). Plain PyTorch version
// and CPU path: theora_tpu_torch/ops/loopfilter.py:loop_filter_plane, the
// JAX function's three globally batched phases (P1: the h filters of
// rows 1-6 of every fragment row; B: the bottom-edge chains, which write
// row 7 of a fragment row and row 0 of the next; A: the top-edge chains,
// which write row 7 of the fragment row above and row 0), whose result is
// libtheora's raster edge order (state.c:1055-1105). The output must equal
// the plain version's byte for byte.
//
// Interface: G planes in [G][Hp][Wp] uint8, coded flags [G][nv][nh] (one
// byte each, 0 or 1), the filter limit of each plane (limits[G] int32 on
// the card, or one limit by value when limits is null), the fragment grid
// nv x nh and the padding pad_y, pad_x (the image's first pixel is (pad_y,
// pad_x)). The filtered planes go to out, never in place: CTA r reads the
// pre-filter rows 6 and 7 of fragment row r - 1, which CTA r - 1 writes.
//
// One launch, no grid-wide barrier: one CTA per (fragment row r, plane
// g). Take y0 = pad_y + 8 r. From the phases' dependencies:
//   rows y0+1 .. y0+6 end as P1 left them (B and A write rows 7 and 0);
//   rows y0-1 and y0 end as A(r) leaves them, after B(r-1). B(r-1) reads
//     the pre-filter rows y0-2, y0-1, y0, y0+1, row y0-2 after P1, and the
//     flags of rows r-1 and r; A(r) reads row y0-2 after P1, B(r-1)'s
//     rows y0-1 and y0, row y0+1 before and after P1, and the flags of r;
//   row y0+7 of the last fragment row ends as B(nv-1) leaves it; its vE is
//     masked, so that is the plain h filters of the pre-filter row.
// So CTA r stages the pre-filter rows y0-2 .. y0+7 and the two flag rows
// in shared memory, runs B(r-1) and A(r) there column by column (each
// phase's per-column chain values in shared memory, a barrier between
// the steps that read a neighbour's), and writes rows y0-1 .. y0+6 (the
// first CTA from row 0, the last down to row Hp - 1, padding copied). The
// CTAs' output rows partition the plane. Per-column names follow the
// plain version's (ve6/ve7 = ve6_row7/ve7_row7, h7m1/h70 = h7_m1/h7_0,
// vb6/vb7 = vb6_row0/vb7_row0, h0m1/h00 = h0_m1/h0_0).
//
// Arithmetic, as the plain version's: f = p0 - p3 + 3 (p2 - p1), the
// response to f at twice the limit L2 sign(R) max(0, min(|R|, L2 - |R|))
// with R = (f + 4) >> 3 (the bounding table of state.c:1036-1045 in
// closed form), pixels clamped to [0, 255]. Integer only. A limit <= 0
// gives a response of 0 everywhere, so such a plane is copied.
//
// Bound: bytes. A 720p frame's three padded planes are 1,479,936 B, read
// and written once ~0.9 us at 3.35 TB/s; the filter's integer work is a
// few million operations (~0.1 us). Both are far below one launch's
// latency (~9 us on this card), so a launch's latency binds KL at these
// sizes: the design is one launch per plane (stack) per frame step in
// place of the plain chain's ~260 PyTorch launches, and a simple CTA of
// 1,024 threads (256 took twice as long: each thread's serial loads and
// stores are the latency) that copies rows as 4-byte words.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWinRows = 10;  // pre-filter rows y0-2 .. y0+7
constexpr int kSmemDefault = 48 * 1024;

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

// The response of the vertical edge left of pixel x in row.
__device__ __forceinline__ int hresp(const uint8_t* row, int x, int lim2) {
  return resp(f4(row[x - 2], row[x - 1], row[x], row[x + 1]), lim2);
}

// The h edge left of block column c fires (column 0's never does).
__device__ __forceinline__ bool hfire(const uint8_t* f, int c) {
  return c > 0 && (f[c] | f[c - 1]);
}

// Pixel (c, j) of row after the row's own h filters (phase P1), x =
// pad_x + 8 c + j; f holds the row's fragment flags.
__device__ __forceinline__ int p1(const uint8_t* row, const uint8_t* f,
                                  int c, int j, int x, int nh, int lim2) {
  if (j == 0 && hfire(f, c)) return clamp255(row[x] - hresp(row, x, lim2));
  if (j == 7 && c + 1 < nh && hfire(f, c + 1))
    return clamp255(row[x] + hresp(row, x + 1, lim2));
  return row[x];
}

__device__ __forceinline__ void copy_words(uint32_t* dst, const uint32_t* src,
                                           int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
}

__global__ void __launch_bounds__(kThreads)
loop_filter_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                   const uint8_t* __restrict__ coded,
                   const int32_t* __restrict__ limits, int limit, int Hp,
                   int Wp, int nv, int nh, int pad_y, int pad_x) {
  extern __shared__ __align__(16) uint8_t sm[];
  const int r = blockIdx.x, g = blockIdx.y;
  const size_t plane = (size_t)Hp * Wp;
  const uint8_t* src = in + g * plane;
  uint8_t* dst = out + g * plane;
  const int y0 = pad_y + 8 * r;
  // This CTA's output rows [lo, hi), computed rows [clo, chi).
  const int lo = r == 0 ? 0 : y0 - 1;
  const int hi = r == nv - 1 ? Hp : y0 + 7;
  const int clo = r == 0 ? y0 : y0 - 1;
  const int chi = r == nv - 1 ? y0 + 8 : y0 + 7;
  const int wq = Wp / 4;
  const int lim = limits ? limits[g] : limit;
  if (lim <= 0) {
    copy_words((uint32_t*)(dst + (size_t)lo * Wp),
               (const uint32_t*)(src + (size_t)lo * Wp), (hi - lo) * wq);
    return;
  }
  const int lim2 = 2 * lim;

  uint8_t* win = sm;                      // [kWinRows][Wp]
  uint8_t* pbm1 = win + kWinRows * Wp;    // row y0-1 after B(r-1)
  uint8_t* pb0 = pbm1 + Wp;               // row y0 after B(r-1)
  uint8_t* fa = pb0 + Wp;                 // flags of row r-1 (r > 0)
  uint8_t* fb = fa + nh;                  // flags of row r
  uint8_t* ve6 = fb + nh;
  uint8_t* ve7 = ve6 + nh;
  uint8_t* h7m1 = ve7 + nh;
  uint8_t* h70 = h7m1 + nh;
  uint8_t* vb6 = h70 + nh;
  uint8_t* vb7 = vb6 + nh;
  uint8_t* h0m1 = vb7 + nh;
  uint8_t* h00 = h0m1 + nh;
  const uint8_t* S6 = win;                // y0-2
  const uint8_t* S7 = win + Wp;           // y0-1
  const uint8_t* B10 = win + 2 * Wp;      // y0
  const uint8_t* B11 = win + 3 * Wp;      // y0+1

  copy_words((uint32_t*)win, (const uint32_t*)(src + (size_t)(y0 - 2) * Wp),
             kWinRows * wq);
  const uint8_t* cg = coded + (size_t)g * nv * nh;
  for (int c = threadIdx.x; c < nh; c += blockDim.x) {
    fa[c] = r > 0 ? cg[(size_t)(r - 1) * nh + c] != 0 : 0;
    fb[c] = cg[(size_t)r * nh + c] != 0;
  }
  // Rows outside [clo, chi) are padding: copied.
  copy_words((uint32_t*)(dst + (size_t)lo * Wp),
             (const uint32_t*)(src + (size_t)lo * Wp), (clo - lo) * wq);
  copy_words((uint32_t*)(dst + (size_t)chi * Wp),
             (const uint32_t*)(src + (size_t)chi * Wp), (hi - chi) * wq);
  __syncthreads();

  // Rows y0-1 and y0 as A(r) finds them: B(r-1)'s output, or for r = 0
  // the pre-filter rows.
  const uint8_t* b1 = S7;
  const uint8_t* s0 = B10;
  if (r > 0) {
    // B(r-1), step 1: the vE filters of columns 6 and 7 on row y0-1.
    for (int c = threadIdx.x; c < nh; c += blockDim.x) {
      const int x = pad_x + 8 * c;
      const bool nxt = c + 1 < nh && fa[c + 1];
      ve6[c] = clamp255(S7[x + 6] + resp(f4(S6[x + 6], S7[x + 6], B10[x + 6],
                                            B11[x + 6]), lim2));
      const int in6 = nxt ? S6[x + 7] : p1(S6, fa, c, 7, x + 7, nh, lim2);
      const int in7 = nxt || c + 1 == nh
                          ? S7[x + 7]
                          : clamp255(S7[x + 7] + hresp(S7, x + 8, lim2));
      ve7[c] = clamp255(in7 + resp(f4(in6, in7, B10[x + 7], B11[x + 7]),
                                   lim2));
    }
    __syncthreads();
    // Step 2: the h filter of row y0-1 left of column c, on the left
    // neighbour's vE outputs where that edge fired before this one.
    for (int c = threadIdx.x; c < nh; c += blockDim.x) {
      const int x = pad_x + 8 * c;
      const bool use_post = c > 0 && fa[c] && fa[c - 1] && !fb[c - 1];
      const int m2 = use_post ? ve6[c - 1] : S7[x - 2];
      const int m1 = use_post ? ve7[c - 1] : S7[x - 1];
      const int rp = resp(f4(m2, m1, S7[x], S7[x + 1]), lim2);
      h7m1[c] = clamp255(m1 + rp);
      h70[c] = clamp255(S7[x] - rp);
    }
    __syncthreads();
    // Step 3: rows y0-1 and y0 after B(r-1), pixel by pixel.
    for (int x = threadIdx.x; x < Wp; x += blockDim.x) {
      const int i = x - pad_x;
      if (i < 0 || i >= 8 * nh) {
        pbm1[x] = S7[x];
        pb0[x] = B10[x];
        continue;
      }
      const int c = i >> 3, j = i & 7;
      const bool nxt = c + 1 < nh && fa[c + 1];
      int r6 = S6[x], r7 = S7[x];
      if (j == 0) {
        r6 = p1(S6, fa, c, 0, x, nh, lim2);
        if (hfire(fa, c)) r7 = h70[c];
      } else if (j == 7) {
        if (!nxt) r6 = p1(S6, fa, c, 7, x, nh, lim2);
        if (!nxt && c + 1 < nh && hfire(fa, c + 1)) r7 = h7m1[c + 1];
      }
      const bool ve = fa[c] && !fb[c];
      int m1 = S7[x], z0 = B10[x];
      if (ve) {
        const int re = resp(f4(r6, r7, B10[x], B11[x]), lim2);
        m1 = clamp255(r7 + re);
        z0 = clamp255(B10[x] - re);
      }
      // The corner h writes: column 7 by the next column's edge unless
      // that edge ran before this column's vE; column 0 by its own edge
      // where no vE overwrote it.
      if (j == 7 && c + 1 < nh && hfire(fa, c + 1) &&
          !(ve && !fa[c + 1]))
        m1 = h7m1[c + 1];
      if (j == 0 && hfire(fa, c) && !ve) m1 = h70[c];
      pbm1[x] = (uint8_t)m1;
      pb0[x] = (uint8_t)z0;
    }
    __syncthreads();
    b1 = pbm1;
    s0 = pb0;
  }

  // A(r), step 1: the vL filters of columns 6 and 7 on row y0. Row y0-2
  // is the post-P1 row of fragment row r-1 (the padding for r = 0).
  for (int c = threadIdx.x; c < nh; c += blockDim.x) {
    const int x = pad_x + 8 * c;
    const int b07 = r > 0 ? p1(S6, fa, c, 7, x + 7, nh, lim2) : S6[x + 7];
    vb6[c] = clamp255(s0[x + 6] - resp(f4(S6[x + 6], b1[x + 6], s0[x + 6],
                                          B11[x + 6]), lim2));
    vb7[c] = clamp255(s0[x + 7] - resp(f4(b07, b1[x + 7], s0[x + 7],
                                          B11[x + 7]), lim2));
  }
  __syncthreads();
  // Step 2: the h filter of row y0 left of column c, on the left
  // neighbour's vL outputs where that edge fired before this one.
  for (int c = threadIdx.x; c < nh; c += blockDim.x) {
    const int x = pad_x + 8 * c;
    const bool prev_vl = r > 0 && c > 0 && fb[c - 1];
    const int m2 = prev_vl ? vb6[c - 1] : s0[x - 2];
    const int m1 = prev_vl ? vb7[c - 1] : s0[x - 1];
    const int rh = resp(f4(m2, m1, s0[x], s0[x + 1]), lim2);
    h0m1[c] = clamp255(m1 + rh);
    h00[c] = clamp255(s0[x] - rh);
  }
  __syncthreads();

  // The computed rows, pixel by pixel.
  for (int y = clo; y < chi; y++) {
    const uint8_t* row = win + (y - y0 + 2) * Wp;
    for (int x = threadIdx.x; x < Wp; x += blockDim.x) {
      const int i = x - pad_x;
      int v;
      if (i < 0 || i >= 8 * nh) {
        v = row[x];
      } else if (y > y0) {
        v = p1(row, fb, i >> 3, i & 7, x, nh, lim2);
      } else {
        const int c = i >> 3, j = i & 7;
        const bool vl = r > 0 && fb[c];
        int m1 = b1[x], z0 = s0[x];
        if (vl) {
          const int rm2 = r > 0 ? p1(S6, fa, c, j, x, nh, lim2) : S6[x];
          const int r0 = j == 0 && hfire(fb, c) ? h00[c] : s0[x];
          const int r1 = j == 0 ? p1(B11, fb, c, 0, x, nh, lim2) : B11[x];
          const int rv = resp(f4(rm2, m1, r0, r1), lim2);
          m1 = clamp255(m1 + rv);
          z0 = clamp255(r0 - rv);
        }
        if (y == y0) {
          if (j == 7 && c + 1 < nh && hfire(fb, c + 1)) z0 = h0m1[c + 1];
          if (j == 0 && hfire(fb, c) && !vl) z0 = h00[c];
        }
        v = y == y0 ? z0 : m1;
      }
      dst[(size_t)y * Wp + x] = (uint8_t)v;
    }
  }
}

}  // namespace

// Shared memory of one CTA: the window, rows y0-1 and y0 after B, two
// flag rows and eight per-column chain values.
static size_t smem_bytes(int Wp, int nh) {
  return (size_t)(kWinRows + 2) * Wp + 10 * (size_t)nh;
}

// in, out [G][Hp][Wp] uint8 (distinct buffers, 4-byte aligned); coded
// [G][nv][nh] uint8 or bool; limits [G] int32 or null (then limit for
// every plane). Hp >= pad_y + 8 nv, Wp >= pad_x + 8 nh, pad_y >= 2,
// pad_x >= 2, Wp a multiple of 4.
extern "C" int th_loop_filter(const uint8_t* in, uint8_t* out,
                              const uint8_t* coded, const int32_t* limits,
                              int limit, int G, int Hp, int Wp, int nv,
                              int nh, int pad_y, int pad_x, void* stream) {
  if (G < 1 || G > 65535 || nv < 1 || nh < 1 || pad_y < 2 || pad_x < 2 ||
      Wp % 4 || Hp < pad_y + 8 * nv || Wp < pad_x + 8 * nh)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(Wp, nh);
  if (smem > kSmemDefault) {
    const cudaError_t e = cudaFuncSetAttribute(
        loop_filter_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  loop_filter_kernel<<<dim3((unsigned)nv, (unsigned)G), kThreads, smem,
                       (cudaStream_t)stream>>>(in, out, coded, limits, limit,
                                               Hp, Wp, nv, nh, pad_y, pad_x);
  return (int)cudaGetLastError();
}
