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
// w = 8 nh, w <= 16384): a batch of up to KP_MAX_FRAMES frames of one
// plane, each described by a KPFrame (its source plane: a base pointer and
// a row stride in bytes; its index into out, dcq and qi; whether it
// derings and strongly; its dering slot), handed to the kernels by value.
// KPPlanes holds what the frames share: out (frame f at out + f out_fs,
// row stride out_rs), dcq and qi ([nv][nh] uint8 per frame, values 0..63;
// an index outside traps, as the plain version's indexing raises),
// dc_scale[64] and sharp[64] int32, and the dering frames' scratch: the
// deblocked planes deb [nd][h][w], the variances var [nd][nv][nh] int32,
// the ticket counters[0] and the mailboxes mail [nd][nv][nh][2] uint64.
// KP is out of loop (no reference reads its output), so the decoder
// launches it once per plane per decoded batch. Two launches:
//
// th_pp_deblock: a CTA of 256 threads per (block row r, frame), grid
// (nv, F). It owns the output rows 8r .. 8r+7 and var[r][*], and keeps the
// rows in shared memory (8 w bytes) until they go out once, into out, or
// into deb and out when the frame derings (dering then writes filtered
// blocks only). Phase H: a thread per 4 columns loads their 18 source rows
// at once (one round trip, not one per window) and writes the 4 output
// pixels of each column's two horizontal-boundary halves. Phase V walks
// the vertical boundaries of each pixel row left to right, in place:
// boundary x reads columns x-5 .. x+4, of which only x-5 (the carry) was
// written by boundary x-8, and only its output 7 becomes the next carry,
// which does not read the carry. So all 256 threads first compute every
// boundary's carry-free terms (output 7, the inner activity, |w5 - w4|,
// the step q and limit, and the outer activity less its carry term,
// folded into one threshold), then one thread per pixel row runs the
// one-byte chain (c' = |w1 - c| < threshold ? output 7 : w8; ~3 dependent
// operations per boundary), then all threads write outputs 0-7 of the
// boundaries that filter and add the outer activities. The launch also
// zeroes the dering's ticket and its frames' mailboxes.
//
// th_pp_dering: one warp per (frame, block row), rows handed out by an
// atomic ticket, frame-major, so that a row's predecessor in its own frame
// has always started; rows never wait on later tickets, so the order
// cannot deadlock. A block reads the final pixels of its north and west
// neighbours and the pre-dering (deblocked) pixels of its south and east
// ones. The warp walks its row's filtered blocks left to right: W is the
// previous block's final column, kept on chip; N, where the block above is
// filtered, is that block's final row 7, which its warp stores as two
// 64-bit mailbox words of 4 pixels and a 1 (cuda::atomic_ref, device
// scope): each word is written once, atomically, and carries its own
// validity, so relaxed stores and polls need no fence. Every lane polls,
// so the warp never diverges there (a two-lane spin cost 3x: the warp ran
// on diverged). The centre, S and E (and N and W where those blocks are
// unfiltered) come from deb, which is ready at launch: they are loaded for
// the row's next filtered block while the current one runs. Inside a
// block, lane y of 8-lane group g holds pixel row y of pass g + 1 in
// registers and updates pixel x at step y + x + 2g: N comes from lane y-1
// by a shuffle, W from the lane's own last step, and pass g + 1's input
// (the pixel, S and E, and its weights' operands) from group g's output
// two steps before, by shuffles. A three-pass block takes 19 steps and a
// one-pass block 15, with no barrier between steps; the edge weights come
// from a table of the block's 256 differences in shared memory. The
// plane-edge borders replicate the pass's own input.
//
// What binds it (tools/bench_pp.py:kp_bound): the larger of the call's own
// bytes (each source read and each output written once, the qi grids and
// the [64] tables; not the deblocked planes and variances between the
// launches) over the memory rate, and the dering's dependency chain: the
// longest path of pixel updates that each need the one before (N and W
// final, the previous pass's neighbourhood through the weights) in the
// longest frame's plan, times one update's latency as th_pp_step_probe
// measures it. The deblock is bound by its bytes and its launch; its
// chain is one byte wide. The dering's own path is longer than the chain:
// a row's blocks run one after another (15 or 19 steps of one warp's
// issue each, plus the block's staging), and each row trails the one
// above by a block and a mailbox's round trip.
#include <cstdint>
#include <cuda/atomic>
#include <cuda_runtime.h>

#define KP_T1 384
#define KP_T2 (4 * KP_T1)
#define KP_T3 (5 * KP_T1)
#define KP_T4 (10 * KP_T1)
#define KP_MAX_NH 2048
#define KP_MAX_FRAMES 32
#define KP_FULL 0xffffffffu

struct KPFrame {
  const uint8_t* src;  // the frame's source plane
  long long ss;        // its row stride in bytes
  int frame;           // index into out, dcq and qi
  int slot;            // index into deb, var and mail; -1: no dering
  int flags;           // 1: dering, 2: strong dering
};

struct KPFrames {
  KPFrame f[KP_MAX_FRAMES];
};

struct KPPlanes {
  uint8_t* out;
  long long out_fs;
  const uint8_t* dcq;
  long long dcq_fs;
  const uint8_t* qi;
  long long qi_fs;
  const int* scale;
  const int* sharp;
  uint8_t* deb;
  int* var;
  int* counters;
  unsigned long long* mail;
  int out_rs, h, w, nv, nh, pli;
};

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

// Dynamic shared memory of a deblock CTA for nh blocks: the variance row
// (int32), the boundaries' thresholds (int16 [8][nh]), the CTA's 8 pixel
// rows (8 w bytes), and per boundary its output 7, window sample 9 and the
// carry that entered it (uint8 [8][nh] each).
__host__ __device__ inline int kp_deblock_smem(int nh) { return 108 * nh; }

__global__ void __launch_bounds__(256) th_pp_deblock_kernel(KPFrames fr,
                                                            KPPlanes p) {
  extern __shared__ int4 kp_smem4[];
  const int r = blockIdx.x;
  const KPFrame d = fr.f[blockIdx.y];
  const int nv = p.nv, nh = p.nh, w = p.w, nb = nh - 1;
  const int tid = threadIdx.x, nt = blockDim.x;
  int* vs = reinterpret_cast<int*>(kp_smem4);
  int16_t* thr = reinterpret_cast<int16_t*>(vs + nh);
  uint8_t* rows = reinterpret_cast<uint8_t*>(thr + 8 * nh);
  uint8_t* o7 = rows + 8 * w;
  uint8_t* w9 = o7 + 8 * nh;
  uint8_t* cin = w9 + 8 * nh;
  const uint8_t* dcq = p.dcq + d.frame * p.dcq_fs;
  const int* scale = p.scale;
  if (tid == 0 && r == 0 && blockIdx.y == 0) p.counters[0] = 0;
  if (d.slot >= 0) {
    unsigned long long* mail = p.mail + ((int64_t)d.slot * nv + r) * 2 * nh;
    for (int i = tid; i < 2 * nh; i += nt) mail[i] = 0;
  }
  for (int i = tid; i < nh; i += nt) vs[i] = 0;
  __syncthreads();

  // Phase H: a thread per 4 columns loads their 18 source rows 8r-5 ..
  // 8r+12 at once (words where the rows are 4-byte aligned) and writes
  // both halves: half 0 = boundary r-1's lower half (window rows 0-9),
  // half 1 = boundary r's upper half (rows 8-17); a half without its
  // boundary, at the plane's top or bottom, is a copy.
  const bool src_words =
      ((reinterpret_cast<uintptr_t>(d.src) | (uintptr_t)d.ss) & 3) == 0;
  for (int x4 = tid * 4; x4 < w; x4 += nt * 4) {
    uint32_t col4[18];
#pragma unroll
    for (int t = 0; t < 18; t++) {
      const int y = 8 * r - 5 + t;
      const uint8_t* sp = d.src + (int64_t)y * d.ss + x4;
      uint32_t v = 0;
      if (y >= 0 && y < 8 * nv) {
        if (src_words) {
          v = *reinterpret_cast<const uint32_t*>(sp);
        } else {
          v = sp[0] | sp[1] << 8 | sp[2] << 16 | (uint32_t)sp[3] << 24;
        }
      }
      col4[t] = v;
    }
    int act[2] = {0, 0};
#pragma unroll
    for (int half = 0; half < 2; half++) {
      const int k = r - 1 + half;
      uint8_t* o = rows + 4 * half * w + x4;
      if (k < 0 || k > nv - 2) {
#pragma unroll
        for (int j = 0; j < 4; j++)
          *reinterpret_cast<uint32_t*>(o + j * w) = col4[5 + 4 * half + j];
        continue;
      }
      const int q = kp_qstep(dcq, scale, k * nh + (x4 >> 3));  // block above
      const int lim = (q * 3) >> 2;
      uint32_t res[4] = {0, 0, 0, 0};
#pragma unroll
      for (int b = 0; b < 4; b++) {
        int win[10];
#pragma unroll
        for (int t = 0; t < 10; t++)
          win[t] = (col4[8 * half + t] >> (8 * b)) & 0xff;
        int outer = 0, inner = 0;
#pragma unroll
        for (int t = 0; t < 4; t++) {
          outer += kp_abs(win[t + 1] - win[t]);
          inner += kp_abs(win[t + 6] - win[t + 5]);
        }
        act[half] += min(half ? outer : inner, 255);
        const bool ok =
            outer < lim && inner < lim && kp_abs(win[5] - win[4]) < q;
#pragma unroll
        for (int j = 0; j < 4; j++) {
          const int t = half ? j : 4 + j;
          res[j] |= (uint32_t)(ok ? kp_tap7(win, t) : win[t + 1]) << (8 * b);
        }
      }
#pragma unroll
      for (int j = 0; j < 4; j++)
        *reinterpret_cast<uint32_t*>(o + j * w) = res[j];
    }
    if (act[0] | act[1]) atomicAdd(&vs[x4 >> 3], act[0] + act[1]);
  }
  __syncthreads();

  // Phase V, carry-free terms of boundary x = 8 bx of pixel row j (window
  // samples 1-9 are phase H's output; sample 0, column x-5, is the carry):
  // it filters iff |w1 - carry| < thr.
  for (int idx = tid; idx < 8 * nb; idx += nt) {
    const int j = idx / nb, bx = 1 + idx - j * nb;
    const uint8_t* row = rows + j * w + 8 * bx - 5;
    int win[10];
    win[0] = 0;
#pragma unroll
    for (int t = 1; t < 10; t++) win[t] = row[t];
    int inner = 0;
#pragma unroll
    for (int t = 0; t < 4; t++) inner += kp_abs(win[t + 6] - win[t + 5]);
    const int rest = kp_abs(win[2] - win[1]) + kp_abs(win[3] - win[2])
                     + kp_abs(win[4] - win[3]);
    atomicAdd(&vs[bx], min(inner, 255));
    const int q = kp_qstep(dcq, scale, r * nh + bx);  // block right of it
    const int lim = (q * 3) >> 2;
    const bool pre = inner < lim && kp_abs(win[5] - win[4]) < q;
    thr[j * nh + bx] = (int16_t)(pre ? kp_clampi(lim - rest, 0, 256) : 0);
    o7[j * nh + bx] = (uint8_t)kp_tap7(win, 7);
    w9[j * nh + bx] = (uint8_t)win[9];
  }
  __syncthreads();

  // The chain: thread j < 8 carries column x-5 of its pixel row across the
  // boundaries.
  if (tid < 8) {
    const uint8_t* row = rows + tid * w;
    const int16_t* th = thr + tid * nh;
    const uint8_t* o = o7 + tid * nh;
    uint8_t* ci = cin + tid * nh;
    int c = row[3];
#pragma unroll 8
    for (int bx = 1; bx < nh; bx++) {
      ci[bx] = (uint8_t)c;
      const int x = bx << 3;
      c = kp_abs(row[x - 4] - c) < th[bx] ? o[bx] : row[x + 3];
    }
  }
  __syncthreads();

  // Outputs 0-7 of each filtered boundary, in place: boundary x owns
  // columns x-4 .. x+3 (window sample 9 was kept before its neighbour
  // rewrote it); its outer activity goes to the block on its left.
  for (int idx = tid; idx < 8 * nb; idx += nt) {
    const int j = idx / nb, bx = 1 + idx - j * nb;
    uint8_t* row = rows + j * w + 8 * bx - 5;
    int win[10];
    win[0] = cin[j * nh + bx];
#pragma unroll
    for (int t = 1; t < 9; t++) win[t] = row[t];
    win[9] = w9[j * nh + bx];
    int outer = 0;
#pragma unroll
    for (int t = 0; t < 4; t++) outer += kp_abs(win[t + 1] - win[t]);
    atomicAdd(&vs[bx - 1], min(outer, 255));
    if (kp_abs(win[1] - win[0]) < thr[j * nh + bx]) {
      int o[8];
#pragma unroll
      for (int t = 0; t < 8; t++) o[t] = kp_tap7(win, t);
#pragma unroll
      for (int t = 0; t < 8; t++) row[1 + t] = (uint8_t)o[t];
    }
  }
  __syncthreads();

  // The rows go out once (twice when the frame derings: its input and the
  // output's unfiltered blocks).
  uint8_t* out = p.out + d.frame * p.out_fs + (int64_t)8 * r * p.out_rs;
  uint8_t* deb = d.slot >= 0
                     ? p.deb + ((int64_t)d.slot * p.h + 8 * r) * w
                     : nullptr;
  const bool words = ((reinterpret_cast<uintptr_t>(out) | p.out_rs) & 3) == 0;
  const int w4 = w >> 2;
  for (int idx = tid; idx < 8 * w4; idx += nt) {
    const int j = idx / w4, x = (idx - j * w4) << 2;
    const uint32_t v = *reinterpret_cast<const uint32_t*>(rows + j * w + x);
    uint8_t* o = out + (int64_t)j * p.out_rs + x;
    if (words) {
      *reinterpret_cast<uint32_t*>(o) = v;
    } else {
#pragma unroll
      for (int b = 0; b < 4; b++) o[b] = (uint8_t)(v >> (8 * b));
    }
    if (deb != nullptr)
      *reinterpret_cast<uint32_t*>(deb + (int64_t)j * w + x) = v;
  }
  if (d.slot >= 0) {
    int* var = p.var + ((int64_t)d.slot * nv + r) * nh;
    for (int i = tid; i < nh; i += nt) var[i] = vs[i];
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
  const int acc = (128 - wn - ws - ww - we) * c + 64 + ws * s + we * e
                  + ww * w + wn * n;
  return kp_clampi(acc >> 7, 0, 255);
}

// The row's first filtered block at or after `from` (nh: none), from the
// plan bytes (passes in bits 0-1).
__device__ __forceinline__ int kp_next(const uint8_t* plan, int from, int nh,
                                       int lane) {
  for (int base = from; base < nh; base += 32) {
    const int b = base + lane;
    const unsigned m = __ballot_sync(KP_FULL, b < nh && (plan[b] & 3));
    if (m) return base + __ffs(m) - 1;
  }
  return nh;
}

// What lane L loads ahead for block (by, bx) from the deblocked plane:
// interior cells L and L + 32 (pixel rows L >> 3 and 4 + (L >> 3), column
// L & 7), then one border cell: S (L < 8), E (L < 16), W (L < 24), N,
// edge-replicated at the plane's edges; and the block's qi.
struct KPAhead {
  int a, b, c, q;
};

__device__ __forceinline__ KPAhead kp_ahead(const uint8_t* in, int w,
                                            const uint8_t* qi, int nv, int nh,
                                            int by, int bx, int lane) {
  const int y0 = by * 8, x0 = bx * 8, i = lane & 7;
  KPAhead v;
  v.a = __ldg(in + (int64_t)(y0 + (lane >> 3)) * w + x0 + i);
  v.b = __ldg(in + (int64_t)(y0 + 4 + (lane >> 3)) * w + x0 + i);
  int y, x;
  if (lane < 8) {
    y = by == nv - 1 ? y0 + 7 : y0 + 8;
    x = x0 + i;
  } else if (lane < 16) {
    y = y0 + i;
    x = bx == nh - 1 ? x0 + 7 : x0 + 8;
  } else if (lane < 24) {
    y = y0 + i;
    x = bx == 0 ? x0 : x0 - 1;
  } else {
    y = by == 0 ? y0 : y0 - 1;
    x = x0 + i;
  }
  v.c = __ldg(in + (int64_t)y * w + x);
  v.q = __ldg(qi + by * nh + bx);
  return v;
}

// One block's NP passes (1 or 3) from its 10x10 neighbourhood g (g[0] N,
// g[9] S, column 0 W, column 9 E; corners unused): lane y of group gr
// (s = y + 2 gr) updates pixel (y, x) of pass gr + 1 at step s + x. Its
// arrays hold, for x = -1 .. 8, the pass input C (index x + s + 1), and
// for x = 0 .. 7 the input rows above U and below D (index x + s); group 0
// reads them from g, group gr > 0 takes the interior from group gr - 1's
// output by shuffles (C two steps before, D one, U three) and the borders
// from g. wt[d] is the block's edge weight of a difference d. The final
// group's lanes leave the block's pixels in ob.
template <int NP>
__device__ __forceinline__ void kp_block(const uint8_t (*g)[10],
                                         const int16_t* wt, uint8_t* ob,
                                         int lane, bool top, bool bottom,
                                         bool left, bool right) {
  constexpr int NT = 15 + 2 * (NP - 1);
  const int y = lane & 7, gr = lane >> 3, s = y + 2 * gr;
  int C[NT + 3], U[NT + 3], D[NT + 2];
#pragma unroll
  for (int i = 0; i < NT + 3; i++) C[i] = g[y + 1][kp_clampi(i - s, 0, 9)];
#pragma unroll
  for (int i = 0; i < NT + 3; i++) U[i] = g[y][kp_clampi(i - s + 1, 1, 8)];
#pragma unroll
  for (int i = 0; i < NT + 2; i++) D[i] = g[y + 2][kp_clampi(i - s + 1, 1, 8)];
  // The W weight of pixel x is the E weight of pixel x - 1 (at x = 0 that
  // of the step before, or of the lane's border at step -1), except where
  // the plane's left edge replicates the pixel itself.
  const int w_flat = wt[0];
  int oprev = 0, nrecv = 0;
  int weprev = wt[kp_abs(C[1] - C[0])];
  // Pixel x of the final pass goes to ob[8 y + x] at step s + x.
  uint8_t* mine = ob + 8 * y - s;
  const bool fin = gr == NP - 1;
#pragma unroll
  for (int T = 0; T < NT; T++) {
    const int x = T - s;
    const int c = C[T + 1];
    const int cw = (x == 0 && left) ? c : C[T];
    const int ce = (x == 7 && right) ? c : C[T + 2];
    const int u = (y == 0 && top) ? c : U[T];
    const int dd = (y == 7 && bottom) ? c : D[T];
    const int wn = wt[kp_abs(c - u)];
    const int ws = wt[kp_abs(dd - c)];
    const int ww = (x == 0 && left) ? w_flat : weprev;
    const int we = wt[kp_abs(ce - c)];
    const int n = y == 0 ? u : nrecv;
    const int wv = x == 0 ? cw : oprev;
    const int o = kp_pixel(c, n, dd, wv, ce, wn, ws, ww, we);
    if (fin && (unsigned)x < 8u) mine[T] = (uint8_t)o;
    const int r1 = __shfl_up_sync(KP_FULL, o, 1);
    if (NP > 1) {
      const int r7 = __shfl_up_sync(KP_FULL, o, 7);
      const int r8 = __shfl_up_sync(KP_FULL, o, 8);
      const int r9 = __shfl_up_sync(KP_FULL, o, 9);
      if (gr > 0) {
        if ((unsigned)(x + 2) < 8u) C[T + 3] = r8;
        if (y > 0 && (unsigned)(x + 3) < 8u) U[T + 3] = r9;
        if (y < 7 && (unsigned)(x + 1) < 8u) D[T + 1] = r7;
      }
    }
    nrecv = r1;
    oprev = o;
    weprev = we;
  }
}

__global__ void __launch_bounds__(32) th_pp_dering_kernel(KPFrames fr,
                                                          KPPlanes p) {
  __shared__ uint8_t g[10][10];
  __shared__ uint8_t plan[KP_MAX_NH];
  __shared__ int tabs[128];
  __shared__ int16_t wt[256];
  __shared__ unsigned long long ob8[8];
  uint8_t* ob = reinterpret_cast<uint8_t*>(ob8);
  const int lane = threadIdx.x;
  const int nv = p.nv, nh = p.nh, w = p.w;
  int t = 0;
  if (lane == 0) t = atomicAdd(&p.counters[0], 1);
  t = __shfl_sync(KP_FULL, t, 0);
  const KPFrame d = fr.f[t / nv];
  const int by = t - (t / nv) * nv, y0 = by * 8;
  const int* var = p.var + (int64_t)d.slot * nv * nh;
  const uint8_t* in = p.deb + (int64_t)d.slot * p.h * w;
  uint8_t* out = p.out + d.frame * p.out_fs;
  const int os = p.out_rs;
  const uint8_t* qi = p.qi + d.frame * p.qi_fs;
  // Each filtered block's final pixel row 7, the N border of the block
  // below: two words of 4 pixels and a 1 in the high half, zeroed by the
  // deblock launch.
  unsigned long long* mail = p.mail + (int64_t)d.slot * nv * nh * 2;
  const int strong_level = (d.flags >> 1) & 1;
  for (int i = lane; i < 64; i += 32) {
    tabs[i] = p.scale[i];
    tabs[64 + i] = p.sharp[i];
  }
  for (int bx = lane; bx < nh; bx += 32) {
    int st, unused;
    const int np = kp_plan(var, nv, nh, by, bx, strong_level, p.pli, &st);
    const bool nf = by > 0 && np
                    && kp_plan(var, nv, nh, by - 1, bx, strong_level, p.pli,
                               &unused);
    plan[bx] = (uint8_t)(np | st << 2 | nf << 3);
  }
  __syncwarp();
  int bx = kp_next(plan, 0, nh, lane);
  KPAhead ahead = {0, 0, 0, 0};
  if (bx < nh) ahead = kp_ahead(in, w, qi, nv, nh, by, bx, lane);
  int wcol = 0, prev = -2, wkey = -1;
  while (bx < nh) {
    const int next = kp_next(plan, bx + 1, nh, lane);
    const int pb = plan[bx], x0 = bx * 8;
    const bool w_final = prev == bx - 1, n_wait = (pb >> 3) & 1;
    // Stage the neighbourhood: the loads ahead, W from the previous block's
    // final column, N from the row above once it has published the block.
    g[1 + (lane >> 3)][1 + (lane & 7)] = (uint8_t)ahead.a;
    g[5 + (lane >> 3)][1 + (lane & 7)] = (uint8_t)ahead.b;
    if (lane < 8) {
      g[9][1 + lane] = (uint8_t)ahead.c;
    } else if (lane < 16) {
      g[1 + (lane & 7)][9] = (uint8_t)ahead.c;
    } else if (lane < 24) {
      if (!w_final) g[1 + (lane & 7)][0] = (uint8_t)ahead.c;
    } else if (!n_wait) {
      g[0][1 + (lane & 7)] = (uint8_t)ahead.c;
    }
    if (w_final && lane < 8) g[1 + lane][0] = (uint8_t)wcol;
    if (n_wait) {
      // Every lane polls (lanes 0 and 1 keep the words): no divergence. A
      // row above that never publishes is a fault: trap after ~2^26 polls
      // (seconds) rather than hang the card.
      cuda::atomic_ref<unsigned long long, cuda::thread_scope_device> box(
          mail[((by - 1) * nh + bx) * 2 + (lane & 1)]);
      unsigned long long v;
      for (int spins = 0;
           ((v = box.load(cuda::memory_order_relaxed)) >> 32) == 0;)
        if (++spins == 1 << 26) __trap();
      if (lane < 2) {
#pragma unroll
        for (int i = 0; i < 4; i++)
          g[0][1 + 4 * lane + i] = (uint8_t)(v >> (8 * i));
      }
    }
    // The block's weight of each difference, rebuilt when its qi or
    // strength differs from the last block's.
    const int q = ahead.q;
    if (q >= 64) __trap();
    const int strong = (pb >> 2) & 1;
    if ((q | strong << 6) != wkey) {
      wkey = q | strong << 6;
      const int dc = tabs[q], sharp = tabs[64 + q];
      const int mod_hi = min(3 * dc, strong ? 32 : 24), shift = strong ? 0 : 1;
      for (int i = lane; i < 256; i += 32)
        wt[i] = (int16_t)kp_weight(i, dc, sharp, mod_hi, shift);
    }
    __syncwarp();
    if (next < nh) ahead = kp_ahead(in, w, qi, nv, nh, by, next, lane);
    const bool top = by == 0, bottom = by == nv - 1;
    const bool left = bx == 0, right = bx == nh - 1;
    if ((pb & 3) == 3) {
      kp_block<3>(g, wt, ob, lane, top, bottom, left, right);
    } else {
      kp_block<1>(g, wt, ob, lane, top, bottom, left, right);
    }
    __syncwarp();
    // Out go the block's rows, its column 7 (the next block's W) and its
    // row 7 (the N border of the block below, into its mailbox).
    if (lane < 8) {
      const unsigned long long bits = ob8[lane];
      wcol = (int)(bits >> 56);
      uint8_t* row = out + (int64_t)(y0 + lane) * os + x0;
      if ((reinterpret_cast<uintptr_t>(row) & 7) == 0) {
        *reinterpret_cast<unsigned long long*>(row) = bits;
      } else {
#pragma unroll
        for (int i = 0; i < 8; i++) row[i] = (uint8_t)(bits >> (8 * i));
      }
      if (lane == 7 && by < nv - 1) {
        unsigned long long* box = mail + ((int64_t)by * nh + bx) * 2;
        cuda::atomic_ref<unsigned long long, cuda::thread_scope_device>(
            box[0]).store((bits & 0xffffffffull) | 1ull << 32,
                          cuda::memory_order_relaxed);
        cuda::atomic_ref<unsigned long long, cuda::thread_scope_device>(
            box[1]).store((bits >> 32) | 1ull << 32,
                          cuda::memory_order_relaxed);
      }
    }
    __syncwarp();
    prev = bx;
    bx = next;
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

// The frames' descriptors as the launches take them: the deblock's n in
// order, each dering frame given the next slot; returns the number of
// dering frames, whose descriptors go to *dering in slot order.
static int kp_frames(const KPFrame* frames, int n, KPFrames* all,
                     KPFrames* dering) {
  int nd = 0;
  for (int k = 0; k < n; k++) {
    all->f[k] = frames[k];
    all->f[k].slot = (frames[k].flags & 1) ? nd : -1;
    if (frames[k].flags & 1) dering->f[nd++] = all->f[k];
  }
  return nd;
}

extern "C" int th_pp_step_probe(const int* in, int* out, int steps,
                                void* stream) {
  th_pp_step_probe_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(in, out, steps);
  return (int)cudaGetLastError();
}

// The deblock launch over n frames; the dering frames' scratch in planes.
extern "C" int th_pp_deblock(const KPFrame* frames, int n,
                             const KPPlanes* planes, void* stream) {
  const KPPlanes p = *planes;
  if (n < 1 || n > KP_MAX_FRAMES || p.nv < 1 || p.nh < 1
      || p.nh > KP_MAX_NH || p.h != 8 * p.nv || p.w != 8 * p.nh)
    return (int)cudaErrorInvalidValue;
  KPFrames all, dering;
  kp_frames(frames, n, &all, &dering);
  const int smem = kp_deblock_smem(p.nh);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        th_pp_deblock_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
  }
  th_pp_deblock_kernel<<<dim3(p.nv, n), 256, smem, (cudaStream_t)stream>>>(
      all, p);
  return (int)cudaGetLastError();
}

// The dering launch over the dering frames among the n (none: nothing is
// launched and 0 returned); after th_pp_deblock on the same frames.
extern "C" int th_pp_dering(const KPFrame* frames, int n,
                            const KPPlanes* planes, void* stream) {
  const KPPlanes p = *planes;
  if (n < 1 || n > KP_MAX_FRAMES || p.nv < 1 || p.nh < 1
      || p.nh > KP_MAX_NH)
    return (int)cudaErrorInvalidValue;
  KPFrames all, dering;
  const int nd = kp_frames(frames, n, &all, &dering);
  if (nd == 0) return 0;
  th_pp_dering_kernel<<<nd * p.nv, 32, 0, (cudaStream_t)stream>>>(dering, p);
  return (int)cudaGetLastError();
}
