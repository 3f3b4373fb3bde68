// Kernel KP: the decoder's out-of-loop postprocessor (deblock + dering),
// for NVIDIA Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package runs the postprocessor on the
// host, theora_tpu/ops/postproc_np.py:273 postprocess_plane (deblock_plane
// :67, dering_plane :179; its native twin theora_tpu/native/entropy.cpp:
// 792), the reference's decode.c:1610-1957. In the port every decoded frame
// is already on the card, so the filter runs there on the decode's output
// planes. Plain PyTorch version and CPU path: theora_tpu_torch/ops/
// postproc.py:postprocess_plane; the output must equal it byte for byte.
//
// Interface (bitstream orientation, row 0 = display bottom; h = 8 nv,
// w = 8 nh, w <= 16384): uint8 planes addressed by a base pointer and a
// row stride in bytes; dc_qis and qi [nv][nh] uint8 (values 0..63; an
// index outside traps, as the plain version's indexing raises);
// dc_scale[64] and sharp[64] int32; var [nv][nh] int32 and counters
// [1 + nv] int32 scratch. Two launches:
//
// th_pp_deblock: one CTA of 256 threads per block row r, which owns the
// output rows 8r .. 8r+7 and the variance sums var[r][*]. Phase H: rows
// 8r .. 8r+3 are the lower half of horizontal boundary r-1's output
// (window rows 8r-5 .. 8r+4), rows 8r+4 .. 8r+7 the upper half of
// boundary r's (window rows 8r+3 .. 8r+12); a thread per (half, column)
// reads its 10-sample window from src, adds boundary r-1's inner or
// boundary r's outer activity to var[r][x >> 3], and writes its 4 output
// pixels (rows outside both, at the plane's top and bottom, are copied).
// Phase V, after a barrier: thread t < 8 walks pixel row 8r+t across the
// vertical boundaries left to right, in place; boundary x reads columns
// x-5 .. x+4, of which only x-5 was written by boundary x-8, so the thread
// carries that byte in a register and loads the other nine, which phase H
// wrote. Block rows are independent: no CTA reads another's rows. The
// variances go out after a last barrier, with the plane copied to dst2
// when dering follows (dering reads the deblocked plane from dst and
// writes the dering output over dst2, which then holds every unfiltered
// block already). The launch also zeroes the dering's counters.
//
// th_pp_dering: one warp per block row, rows handed out by an atomic
// ticket (counters[0]) so that a row's predecessor has always started.
// A block reads the final pixels of its north and west neighbours and the
// pre-dering (deblocked) pixels of its south and east ones: S and E come
// from `in`, N and W from `out`. A warp walks its row left to right, so
// W is done; for N it waits, only when the block above is filtered, until
// the row above has published (counters[1 + row], written after a fence)
// that block. Rows never wait on later rows, so the ticket order cannot
// deadlock. Inside a block the warp stages the 10x10 neighbourhood in
// shared memory; per pass it computes the 144 edge weights from the pass's
// input, then lane y < 8 runs block row y along the 15 pixel
// anti-diagonals (pixel (y, d - y) at step d: N and W from the pass's new
// values, S, E and the centre from its input), and the plane-edge
// replicated borders are refreshed from the block's own pixels between
// passes. Filtered blocks only are written (dst2 of the deblock holds the
// rest).
//
// Bound (tools/bench_pp.py:kp_bound): the larger of the call's own bytes
// (src read and out written once, the qi grids and the [64] tables; not
// the deblocked plane and variances that pass between the two launches)
// over the memory rate, and the dering's dependency chain: the longest
// path of pixel updates that each need the one before (N and W final,
// the previous pass's neighbourhood through the weights), from this
// call's plan, times one update's latency as th_pp_step_probe measures
// it.
#include <cstdint>
#include <cuda_runtime.h>

#define KP_T1 384
#define KP_T2 (4 * KP_T1)
#define KP_T3 (5 * KP_T1)
#define KP_T4 (10 * KP_T1)
#define KP_MAX_NH 2048

__device__ __forceinline__ int kp_abs(int v) { return v < 0 ? -v : v; }

__device__ __forceinline__ int kp_clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// The 7-tap [1,1,1,2,1,1,1] smoother over the edge-replicated 10-sample
// window: output t (window sample t + 1), rounded, >> 3.
__device__ __forceinline__ int kp_tap7(const int* win, int t) {
  return (2 * win[t + 1] + win[kp_clampi(t - 2, 0, 9)]
          + win[kp_clampi(t - 1, 0, 9)] + win[t] + win[t + 2]
          + win[kp_clampi(t + 3, 0, 9)] + win[kp_clampi(t + 4, 0, 9)] + 4)
         >> 3;
}

__device__ __forceinline__ int kp_qstep(const uint8_t* dcq, const int* scale,
                                        int i) {
  const int q = dcq[i];
  if (q >= 64) __trap();
  return scale[q];
}

__global__ void __launch_bounds__(256) th_pp_deblock_kernel(
    const uint8_t* __restrict__ src, int ss, uint8_t* dst, int ds,
    uint8_t* dst2, int ds2, const uint8_t* __restrict__ dcq,
    const int* __restrict__ scale, int* __restrict__ var,
    int* __restrict__ counters, int w, int nv, int nh) {
  __shared__ int vs[KP_MAX_NH];
  const int r = blockIdx.x;
  const int tid = threadIdx.x;
  if (tid == 0) {
    counters[1 + r] = 0;
    if (r == 0) counters[0] = 0;
  }
  for (int i = tid; i < nh; i += blockDim.x) vs[i] = 0;
  __syncthreads();

  // Phase H: (half, column) pairs; half 0 = boundary r-1's lower half,
  // half 1 = boundary r's upper half.
  for (int idx = tid; idx < 2 * w; idx += blockDim.x) {
    const int half = idx >= w;
    const int x = idx - half * w;
    const int k = r - 1 + half;
    const int y_out = 8 * r + 4 * half;
    if (k < 0 || k > nv - 2) {
      for (int j = 0; j < 4; j++)
        dst[(int64_t)(y_out + j) * ds + x] = src[(int64_t)(y_out + j) * ss + x];
      continue;
    }
    int win[10];
    const uint8_t* col = src + (int64_t)(8 * k + 3) * ss + x;
#pragma unroll
    for (int t = 0; t < 10; t++) win[t] = col[(int64_t)t * ss];
    int outer = 0, inner = 0;
#pragma unroll
    for (int t = 0; t < 4; t++) {
      outer += kp_abs(win[t + 1] - win[t]);
      inner += kp_abs(win[t + 6] - win[t + 5]);
    }
    atomicAdd(&vs[x >> 3], min(half ? outer : inner, 255));
    const int q = kp_qstep(dcq, scale, k * nh + (x >> 3));  // block above
    const int lim = (q * 3) >> 2;
    const bool ok = outer < lim && inner < lim && kp_abs(win[5] - win[4]) < q;
#pragma unroll
    for (int j = 0; j < 4; j++) {
      const int t = half ? j : 4 + j;
      dst[(int64_t)(y_out + j) * ds + x] =
          (uint8_t)(ok ? kp_tap7(win, t) : win[t + 1]);
    }
  }
  __syncthreads();

  // Phase V: a thread per pixel row, boundaries left to right, in place.
  if (tid < 8) {
    uint8_t* row = dst + (int64_t)(8 * r + tid) * ds;
    int carry = row[3];  // column x-5 of boundary x = 8
    for (int bx = 1; bx < nh; bx++) {
      const int x = bx << 3;
      int win[10];
      win[0] = carry;
#pragma unroll
      for (int t = 1; t < 10; t++) win[t] = row[x - 5 + t];
      int outer = 0, inner = 0;
#pragma unroll
      for (int t = 0; t < 4; t++) {
        outer += kp_abs(win[t + 1] - win[t]);
        inner += kp_abs(win[t + 6] - win[t + 5]);
      }
      atomicAdd(&vs[bx - 1], min(outer, 255));
      atomicAdd(&vs[bx], min(inner, 255));
      const int q = kp_qstep(dcq, scale, r * nh + bx);  // block right of it
      const int lim = (q * 3) >> 2;
      // Column x+3 (output 7, window sample 8) is the next boundary's x-5.
      carry = win[8];
      if (outer < lim && inner < lim && kp_abs(win[5] - win[4]) < q) {
        int o[8];
#pragma unroll
        for (int t = 0; t < 8; t++) o[t] = kp_tap7(win, t);
#pragma unroll
        for (int t = 0; t < 8; t++) row[x - 4 + t] = (uint8_t)o[t];
        carry = o[7];
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < nh; i += blockDim.x) var[r * nh + i] = vs[i];
  if (dst2 != nullptr) {
    for (int idx = tid; idx < 8 * w; idx += blockDim.x) {
      const int y = 8 * r + idx / w, x = idx % w;
      dst2[(int64_t)y * ds2 + x] = dst[(int64_t)y * ds + x];
    }
  }
}

// Passes (0, 1 or 3) of block (by, bx) and whether it derings strongly.
__device__ __forceinline__ int kp_plan(const int* var, int nv, int nh, int by,
                                       int bx, int strong_level, int pli,
                                       int* strong) {
  const int v = var[by * nh + bx];
  if (strong_level && v > (pli ? KP_T4 : KP_T3)) {
    *strong = 1;
    if (pli) return 3;
    const bool ring = (bx > 0 && var[by * nh + bx - 1] > KP_T4)
                      || (bx < nh - 1 && var[by * nh + bx + 1] > KP_T4)
                      || (by > 0 && var[(by - 1) * nh + bx] > KP_T4)
                      || (by < nv - 1 && var[(by + 1) * nh + bx] > KP_T4);
    return ring ? 3 : 1;
  }
  *strong = v > KP_T2;
  return v > KP_T1 ? 1 : 0;
}

__device__ __forceinline__ int kp_weight(int d, int dc, int sharp, int mod_hi,
                                         int shift) {
  const int m = 32 + dc - (d << shift);
  return m < -64 ? sharp : kp_clampi(m, 0, mod_hi);
}

// One dering pixel update: the centre c and its N, S, W and E neighbours
// weighted, rounded, >> 7, clamped to 0..255.
__device__ __forceinline__ int kp_pixel(int c, int n, int s, int w, int e,
                                        int wn, int ws, int ww, int we) {
  const int acc = (128 - wn - ws - ww - we) * c + 64 + wn * n + ww * w
                  + ws * s + we * e;
  return kp_clampi(acc >> 7, 0, 255);
}

__global__ void __launch_bounds__(32) th_pp_dering_kernel(
    const uint8_t* __restrict__ in, int is, uint8_t* out, int os,
    const int* __restrict__ var, const uint8_t* __restrict__ qi,
    const int* __restrict__ scale, const int* __restrict__ sharp_t,
    int* counters, int nv, int nh, int strong_level, int pli) {
  __shared__ int cur[10][10];
  __shared__ int nxt[10][10];
  __shared__ int vw[9][8];
  __shared__ int hw[8][9];
  __shared__ int s_row;
  const int lane = threadIdx.x;
  if (lane == 0) s_row = atomicAdd(&counters[0], 1);
  __syncwarp();
  const int by = s_row;
  if (by >= nv) return;
  volatile int* progress = counters + 1;
  const int y0 = by * 8;
  for (int bx = 0; bx < nh; bx++) {
    int strong;
    const int np = kp_plan(var, nv, nh, by, bx, strong_level, pli, &strong);
    if (np == 0) continue;
    const int x0 = bx * 8;
    int unused;
    const bool n_filtered =
        by > 0 && kp_plan(var, nv, nh, by - 1, bx, strong_level, pli, &unused);
    if (n_filtered) {
      if (lane == 0) {
        while (progress[by - 1] <= bx) {
        }
      }
      __syncwarp();
      __threadfence();
    }
    // The 10x10 neighbourhood (corners are never read).
    for (int i = lane; i < 100; i += 32) {
      const int rr = i / 10, cc = i % 10;
      const bool row_in = rr >= 1 && rr <= 8, col_in = cc >= 1 && cc <= 8;
      int v = 0;
      if (row_in && col_in) {
        v = in[(int64_t)(y0 + rr - 1) * is + x0 + cc - 1];
      } else if (col_in && rr == 0) {
        v = by == 0 ? in[(int64_t)y0 * is + x0 + cc - 1]
                    : __ldcg(out + (int64_t)(y0 - 1) * os + x0 + cc - 1);
      } else if (col_in && rr == 9) {
        v = in[(int64_t)(by == nv - 1 ? y0 + 7 : y0 + 8) * is + x0 + cc - 1];
      } else if (row_in && cc == 0) {
        v = bx == 0 ? in[(int64_t)(y0 + rr - 1) * is + x0]
                    : __ldcg(out + (int64_t)(y0 + rr - 1) * os + x0 - 1);
      } else if (row_in && cc == 9) {
        v = in[(int64_t)(y0 + rr - 1) * is + (bx == nh - 1 ? x0 + 7 : x0 + 8)];
      }
      cur[rr][cc] = v;
    }
    const int q = qi[by * nh + bx];
    if (q >= 64) __trap();
    const int dc = scale[q], sharp = sharp_t[q];
    const int mod_hi = min(3 * dc, strong ? 32 : 24), shift = strong ? 0 : 1;
    __syncwarp();
    for (int p = 0; p < np; p++) {
      for (int i = lane; i < 72; i += 32) {
        const int a = i >> 3, b = i & 7;
        vw[a][b] = kp_weight(kp_abs(cur[a + 1][b + 1] - cur[a][b + 1]), dc,
                             sharp, mod_hi, shift);
        const int a2 = i / 9, b2 = i % 9;
        hw[a2][b2] = kp_weight(kp_abs(cur[a2 + 1][b2 + 1] - cur[a2 + 1][b2]),
                               dc, sharp, mod_hi, shift);
      }
      for (int i = lane; i < 100; i += 32) nxt[i / 10][i % 10] = cur[i / 10][i % 10];
      __syncwarp();
      for (int d = 0; d < 15; d++) {
        const int y = lane, x = d - lane;
        if (lane < 8 && x >= 0 && x < 8) {
          const int wn = vw[y][x], ws = vw[y + 1][x];
          const int ww = hw[y][x], we = hw[y][x + 1];
          nxt[y + 1][x + 1] = kp_pixel(cur[y + 1][x + 1], nxt[y][x + 1],
                                       cur[y + 2][x + 1], nxt[y + 1][x],
                                       cur[y + 1][x + 2], wn, ws, ww, we);
        }
        __syncwarp();
      }
      for (int i = lane; i < 100; i += 32) cur[i / 10][i % 10] = nxt[i / 10][i % 10];
      __syncwarp();
      if (lane < 10) {
        if (by == 0) cur[0][lane] = cur[1][lane];
        if (by == nv - 1) cur[9][lane] = cur[8][lane];
      }
      __syncwarp();
      if (lane < 10) {
        if (bx == 0) cur[lane][0] = cur[lane][1];
        if (bx == nh - 1) cur[lane][9] = cur[lane][8];
      }
      __syncwarp();
    }
    for (int i = lane; i < 64; i += 32)
      out[(int64_t)(y0 + (i >> 3)) * os + x0 + (i & 7)] =
          (uint8_t)cur[(i >> 3) + 1][(i & 7) + 1];
    __threadfence();
    __syncwarp();
    if (lane == 0) progress[by] = bx + 1;
    __syncwarp();
  }
}

// The latency of one pixel update on the dering's dependency chain: one
// thread runs `steps` updates of two neighbouring pixels, each the
// other's N or W and its own W or N, from operands loaded at run time
// (in[0..8]: the two pixels, centre, S, E, then the weights N, S, W, E),
// in registers; out[0..1] keeps the result live.
__global__ void th_pp_step_probe_kernel(const int* __restrict__ in,
                                        int* __restrict__ out, int steps) {
  int a = in[0], b = in[1];
  const int c = in[2], s = in[3], e = in[4];
  const int wn = in[5], ws = in[6], ww = in[7], we = in[8];
  for (int k = 0; k < steps; k++) {
    const int a2 = kp_pixel(c, a, s, b, e, wn, ws, ww, we);
    const int b2 = kp_pixel(s, b, c, a, e, wn, ws, ww, we);
    a = a2;
    b = b2;
  }
  out[0] = a;
  out[1] = b;
}

extern "C" int th_pp_step_probe(const int* in, int* out, int steps,
                                void* stream) {
  th_pp_step_probe_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(in, out, steps);
  return (int)cudaGetLastError();
}

extern "C" int th_pp_deblock(const uint8_t* src, int ss, uint8_t* dst, int ds,
                             uint8_t* dst2, int ds2, const uint8_t* dcq,
                             const int* scale, int* var, int* counters, int h,
                             int w, void* stream) {
  const int nv = h >> 3, nh = w >> 3;
  if (nv < 1 || nh < 1 || nh > KP_MAX_NH) return (int)cudaErrorInvalidValue;
  th_pp_deblock_kernel<<<nv, 256, 0, (cudaStream_t)stream>>>(
      src, ss, dst, ds, dst2, ds2, dcq, scale, var, counters, w, nv, nh);
  return (int)cudaGetLastError();
}

extern "C" int th_pp_dering(const uint8_t* in, int is, uint8_t* out, int os,
                            const int* var, const uint8_t* qi,
                            const int* scale, const int* sharp, int* counters,
                            int nv, int nh, int strong_level, int pli,
                            void* stream) {
  if (nv < 1 || nh < 1) return (int)cudaErrorInvalidValue;
  th_pp_dering_kernel<<<nv, 32, 0, (cudaStream_t)stream>>>(
      in, is, out, os, var, qi, scale, sharp, counters, nv, nh, strong_level,
      pli);
  return (int)cudaGetLastError();
}
