// Kernel KT: the encoder's trellis quantizer for NVIDIA Hopper (sm_90a).
//
// Replaces the JAX trellis theora_tpu/ops/transforms_jax.py:trellis_values
// (:300): a forward dynamic program over the 63 AC positions of each 8x8
// block (a 63-step lax.scan, :471) and a backtrack sweep (a second 63-step
// lax.scan, :527). It is not a Pallas kernel; XLA fuses the scans on the
// TPU. Plain PyTorch version: theora_tpu_torch/ops/transforms.py:
// trellis_quantize (trellis_values behind the casts of this interface).
//
// Interface: kernel K2's outputs as K2 writes them ([K, N, 64] int16
// round-to-nearest values at K <= 3 qi rows and the [N, 64] unquantized
// DCT, zig-zag), K2's [K, 2, 64] int16 dequant rows (per qi row intra,
// inter) and [N] uint8 inter flags, the frame's float32 lambda per qi row,
// an optional [N] float32 lambda scale per block (adaptive quantization's
// activity masking) and the [64, 32] float32 token bit table. One launch
// covers the K x N (row, block) pairs. Pair (k, n) takes the dequant row
// deq[k][inter[n]], acmin (0 for an inter block, 3 for an intra one) and
// the lambda lam[k] * lam_sc[n] (one float32 product, in the order of
// theora_tpu/encode/tpu_gop.py:228; lam[k] without scales). It writes the
// chosen values ([K, N, 64] int16, DC passed through), their nonzero count
// ([K, N] int32) and whether no AC value is nonzero ([K, N] bool), which
// kernel K1 and the chooser read as they are.
//
// Exact float32. The decisions must equal the JAX package's, which are what
// XLA on the CPU computes, and so the plain version's:
//   - the prefix sum of c^2 is taken in XLA's chunk-16 order: sequential
//     inside each chunk of 16 positions, the chunk totals summed
//     sequentially and added to each chunk (transforms.py:_xla_cumsum16);
//   - XLA, in the JAX encoder's scan, contracts the three cost sums that
//     take a lambda into fused multiply-adds of lam * bits: the value's
//     and the next-lower value's token costs __fmaf_rn(lam, bits, e * e)
//     and the EOB cost __fmaf_rn(lam, bits, P[64] - P[i]) (transforms.py,
//     the note above trellis_values);
//   - every other product and sum is a separate IEEE operation in the
//     Python's left-to-right order, parenthesised as the Python groups it:
//     the file is built with -fmad=false, so nvcc contracts nothing but the
//     explicit __fmaf_rn (and never with --use_fast_math). lam * bits is
//     formed where it is used, from the block's own lambda;
//   - the "infinite" cost is the finite float32 1e30, as in the reference;
//   - ties take the first position (jnp.argmin).
//
// Only the candidates the inputs need. At DP step i a run may end at any
// position j; the plain version weighs all 64. A position j <= i carries a
// 1e30 mask, and a position whose round-to-nearest value is 0 has a 1e30
// node-1 cost and 1e30 combo errors, so its cost is at least ~1e30, while
// the EOB cost is finite (below 64 * 2^30 + lam * bits): such a candidate
// neither wins nor ties. The kernel weighs only the nonzero positions
// j > i, the +-1 combo only at |q| 1-2 within run length 17 (16 at i = 1)
// and the +-2/3 combo only at |q| 2-4 within run length 3 (2 at i = 1),
// where the plain version's masks are 0. Steps above the block group's last
// nonzero AC position have no candidate: their node-0 cost is the EOB cost
// and the DP starts below them. A block with no nonzero AC value keeps its
// DC and 63 zeros.
//
// Bound: memory, ~390 B per block (two [64] int16 rows and a flag in; a
// [64] int16 row, a count and a flag out), against the float32 work its
// inputs need (tools/bench_trellis.py:kt_float_ops counts both). The DP is
// a chain of 63 dependent steps per block, so the design keeps many blocks
// in flight and each step short.
// Design: 8 lanes per block, 4 blocks per warp, 4 warps per CTA; a grid of
// the CTAs the card holds at once, whose warps walk over the (row, block)
// pairs. A CTA stages the bit table [64][32] and the dequant rows in shared
// memory once; a block's lambda multiplies the bits where they are used. Lane g loads positions 8g..8g+7 of each input row as
// one 16-byte vector, derives their constants and sums c^2 in chunk order
// (a chunk is two lanes, which chain their partial sums). The nonzero AC
// positions of the block are compacted, in ascending order, into a list in
// shared memory. At step i the list's entries past i are e0, e0 + 1, ...;
// lane g weighs e0 + g, e0 + g + 8, ... and keeps its first minimum, and a
// 3-level butterfly over the block's lanes orders (cost, position) pairs to
// give the first minimum.
// The decision is packed beside the position's node-1 value; then one lane
// walks the path from position 1, visiting only the positions where an
// event happens, into a zeroed row, and the lanes store it as 16-byte
// vectors.
//
// Segments: a launch may cover G segments of n blocks each (the mesh
// encoder's G GOPs at one frame step: N = G n blocks of one plane), each
// with its own K dequant rows ([G][K][2][64]) and K lambdas; block b takes
// segment b / n. The segment is blockIdx.y: a CTA walks over the (row,
// block) pairs of one segment only, so it stages that segment's rows once,
// as the one-segment launch does, and reads its lambdas from the device's
// [G][K] array.
//
// Plain C interface (loaded with ctypes); launches on the caller's stream,
// allocates nothing and returns the first CUDA error.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 8;                 // lanes per 8x8 block
constexpr int kGroups = 32 / kLanes;      // blocks per warp
constexpr int kWarps = 4;                 // warps per CTA
constexpr int kThreads = kWarps * 32;
constexpr int kBlocksPerCta = kWarps * kGroups;
constexpr unsigned kFull = 0xffffffffu;
// transforms_jax._BIG: large, but finite.
constexpr float kBig = 1e30f;

// pos[i].w, an int: bits 0-15 node-1 value v1 (int16), 16 "q != 0"; dec[i]
// adds the step's decision: 17 node-1 successor, 18-19 node-0 ending (0 EOB,
// 1 run + coded value, 2 +-1 combo, 3 +-2/3 combo), 20-25 its run end,
// 26-28 the combo value + 4.
constexpr int kNz = 1 << 16;
constexpr int kDecShift = 17;
// ent[e].w, an int: bits 0-5 position, 6 a +-1 combo may end here, 7 a
// +-2/3 combo may, 8-10 sign + 4, 11-13 the +-2/3 combo value + 4.
constexpr int kHas1 = 1 << 6;
constexpr int kHas23 = 1 << 7;

// A block's shared memory.
struct BlockArea {
  float4 pos[64];  // position i: P[i], EOB cost, node-1 cost, bits
  float4 ent[64];  // e-th nonzero AC position j: P[j], +-1 and +-2/3 combo
                   // errors, bits; after the DP, the output row
  float2 dyn[64];  // e-th nonzero AC position j: node-1 cost, best cost at
                   // j + 1
  int dec[64];     // position i: pos[i].w with the step's decision
  // 2,880 B: the next block's dyn row starts 16 banks on, so the 8-byte
  // loads of two blocks in a half-warp meet no bank conflict.
  float4 pad[4];
};

constexpr int kNb = 64 * 32;  // bit table entries
constexpr int kMaxRows = 3;  // qi rows per launch
constexpr size_t kSmemBytes = kBlocksPerCta * sizeof(BlockArea) +
                              kNb * sizeof(float) + 64 * sizeof(float4) +
                              kMaxRows * 2 * 64 * sizeof(int16_t);

// Token id of a lone coefficient of magnitude mag >= 1 (tokenize.c).
__device__ __forceinline__ int value_token(int mag, int neg) {
  if (mag <= 2) return 9 + (mag - 1) * 2 + neg;
  if (mag <= 6) return 10 + mag;
  if (mag <= 8) return 17;
  if (mag <= 12) return 18;
  if (mag <= 20) return 19;
  if (mag <= 36) return 20;
  if (mag <= 68) return 21;
  return 22;
}

// Top of the next-lower value-token category.
__device__ __forceinline__ int alt_mag(int mag) {
  if (mag <= 6) return mag - 1;
  if (mag <= 8) return 6;
  if (mag <= 12) return 8;
  if (mag <= 20) return 12;
  if (mag <= 36) return 20;
  if (mag <= 68) return 36;
  return 68;
}

// The eight int16 of a 16-byte vector, in memory order.
__device__ __forceinline__ void unpack8(int4 v, int x[8]) {
  const int w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int m = 0; m < 4; m++) {
    x[2 * m] = (int16_t)(w[m] & 0xFFFF);
    x[2 * m + 1] = w[m] >> 16;
  }
}

__global__ void __launch_bounds__(kThreads, 4)
trellis_kernel(const int16_t* __restrict__ qrtn,
               const int16_t* __restrict__ dct,
               const int16_t* __restrict__ deq_in,
               const uint8_t* __restrict__ inter_in,
               const float* __restrict__ lams,
               const float* __restrict__ lam_sc,
               const float* __restrict__ nb_full, int16_t* __restrict__ out,
               int32_t* __restrict__ cnt_out, uint8_t* __restrict__ dc_only,
               int64_t n, int nrows) {
  extern __shared__ float4 smem[];
  BlockArea* areas = reinterpret_cast<BlockArea*>(smem);
  float* s_nb = reinterpret_cast<float*>(areas + kBlocksPerCta);
  // Per step i: the bits of the zero runs up to 8 and longer (tokens 7, 8)
  // and of the +-2/3 combo after a run of 1 and of 2 (tokens 30, 31).
  float4* s_step = reinterpret_cast<float4*>(s_nb + kNb);
  int16_t* s_deq = reinterpret_cast<int16_t*>(s_step + 64);
  const int seg = blockIdx.y;
  deq_in += (int64_t)seg * nrows * 2 * 64;
  {
    const float4* nb4 = reinterpret_cast<const float4*>(nb_full);
    float4* snb4 = reinterpret_cast<float4*>(s_nb);
#pragma unroll
    for (int k = 0; k < kNb / 4 / kThreads; k++)
      snb4[threadIdx.x + k * kThreads] = nb4[threadIdx.x + k * kThreads];
    const int t = threadIdx.x;
    if (t < 64)
      s_step[t] = make_float4(nb_full[t * 32 + 7], nb_full[t * 32 + 8],
                              nb_full[t * 32 + 30], nb_full[t * 32 + 31]);
    for (int e = t; e < nrows * 2 * 64; e += kThreads) s_deq[e] = deq_in[e];
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane & (kLanes - 1);  // lane within the block's group
  BlockArea& A = areas[warp * kGroups + lane / kLanes];
  const float inf = __int_as_float(0x7f800000);
  // The segment's (row, block) pairs, row-major; in the launch's [K, N]
  // arrays pair (row, i) is row * N + seg * n + i.
  const int64_t total = n * nrows;
  const int64_t N = n * gridDim.y;
  const int64_t ngroups = (total + kGroups - 1) / kGroups;
  for (int64_t wg = (int64_t)blockIdx.x * kWarps + warp; wg < ngroups;
       wg += (int64_t)gridDim.x * kWarps) {
    const int64_t p = wg * kGroups + lane / kLanes;
    const bool live = p < total;
    // The pair's qi row, block and place in [K, N].
    const int row = (int)(p >= n) + (int)(p >= 2 * n);
    const int64_t blk = (int64_t)seg * n + (p - row * n);
    const int64_t b = row * N + blk;
    __syncwarp();  // the previous block's reads of A are done
    int q[8], cd[8];
    int inter = 0;
    float lam = 0.f;
    {
      int4 qv = make_int4(0, 0, 0, 0), dv = qv;
      if (live) {
        qv = reinterpret_cast<const int4*>(qrtn)[b * 8 + g];
        dv = reinterpret_cast<const int4*>(dct)[blk * 8 + g];
        inter = inter_in[blk] != 0;
        lam = lams[seg * nrows + row];
        if (lam_sc != nullptr) lam = lam * lam_sc[blk];
      }
      unpack8(qv, q);
      unpack8(dv, cd);
    }

    // ---- prefix sum of z = (q != 0) c^2 in chunk-16 order ----
    float loc[8];
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < 8; k++) {
      const float cf = (float)cd[k];
      acc = acc + (q[k] != 0 ? cf * cf : 0.f);
      loc[k] = acc;
    }
    // A chunk is lanes 2c and 2c + 1: the odd lane continues the even
    // lane's sequential sum.
    const float carry = __shfl_up_sync(kFull, acc, 1, kLanes);
    if (g & 1) {
      acc = carry;
#pragma unroll
      for (int k = 0; k < 8; k++) {
        const float cf = (float)cd[k];
        acc = acc + (q[k] != 0 ? cf * cf : 0.f);
        loc[k] = acc;
      }
    }
    const float t0 = __shfl_sync(kFull, acc, 1, kLanes);
    const float t1 = __shfl_sync(kFull, acc, 3, kLanes);
    const float t2 = __shfl_sync(kFull, acc, 5, kLanes);
    const float pr1 = 0.f + t0;
    const float pr2 = pr1 + t1;
    const float pr3 = pr2 + t2;
    const int ch = g >> 1;
    const float pre = ch == 0 ? 0.f : (ch == 1 ? pr1 : (ch == 2 ? pr2 : pr3));
    float P[8];  // P[j], the sum below position j
    float last = 0.f;
#pragma unroll
    for (int k = 0; k < 8; k++) {
      const float incl = loc[k] + pre;
      if (k < 7) P[k + 1] = incl;
      last = incl;
    }
    const float before = __shfl_up_sync(kFull, last, 1, kLanes);
    P[0] = g == 0 ? 0.f : before;
    const float P64 = __shfl_sync(kFull, last, kLanes - 1, kLanes);

    // ---- the nonzero AC positions, compacted in ascending order ----
    unsigned nzm = 0;
#pragma unroll
    for (int k = 0; k < 8; k++)
      if (q[k] != 0 && (g | k) != 0) nzm |= 1u << k;
    int below = __popc(nzm);  // inclusive prefix count over the lanes
#pragma unroll
    for (int o = 1; o < kLanes; o <<= 1) {
      const int t = __shfl_up_sync(kFull, below, o, kLanes);
      if (g >= o) below += t;
    }
    const int K = __shfl_sync(kFull, below, kLanes - 1, kLanes);
    int e = below - __popc(nzm);
    int L = nzm ? 8 * g + 31 - __clz(nzm) : 0;  // last nonzero AC position
#pragma unroll
    for (int o = kLanes / 2; o > 0; o >>= 1)
      L = max(L, __shfl_xor_sync(kFull, L, o));

    // ---- per-position constants (transforms.py:285-314) ----
    const int16_t* drow = s_deq + (live ? (row * 2 + inter) * 64 : 0);
    const int acmin = inter ? 0 : 3;
#pragma unroll
    for (int k = 0; k < 8; k++) {
      const int j = 8 * g + k;
      const int qk = q[k];
      const float cf = (float)cd[k];
      const float df = (float)drow[j];
      const float* nbj = s_nb + j * 32;
      const int aj = qk < 0 ? -qk : qk;
      const int sj = qk < 0 ? -1 : 1;
      const int cv23 = sj * (aj > 2 ? 3 : 2);
      const int a_cl = min(aj, 580);
      const int neg = qk < 0;
      const int altm = alt_mag(a_cl);
      // Positions below acmin code values rate-free (lam 0).
      const float lamv = j < acmin ? 0.f : lam;
      const float eA = (float)(a_cl * sj) * df - cf;
      const float eB = (float)(altm * sj) * df - cf;
      const float cA =
          __fmaf_rn(lamv, nbj[value_token(max(a_cl, 1), neg)], eA * eA);
      const float cB =
          __fmaf_rn(lamv, nbj[value_token(max(altm, 1), neg)], eB * eB);
      const bool useB = altm >= 1 && cB < cA;
      const float c1s = aj >= 1 ? (useB ? cB : cA) : kBig;
      const int v1 = aj >= 1 ? (useB ? altm * sj : a_cl * sj) : 0;
      const float costc = __fmaf_rn(lam, nbj[0], P64 - P[k]);
      const bool nz = (nzm >> k) & 1;
      A.pos[j] = make_float4(P[k], costc, c1s,
                             __int_as_float((v1 & 0xFFFF) | (nz ? kNz : 0)));
      if (nz) {
        const float e1 = cf - (float)sj * df;
        const float e23 = cf - (float)cv23 * df;
        const bool has1 = aj <= 2;
        const bool has23 = aj >= 2 && aj <= 4;
        const int meta = j | (has1 ? kHas1 : 0) | (has23 ? kHas23 : 0) |
                         ((sj + 4) << 8) | ((cv23 + 4) << 11);
        A.ent[e++] = make_float4(P[k], has1 ? e1 * e1 : kBig,
                                 has23 ? e23 * e23 : kBig,
                                 __int_as_float(meta));
      }
    }
    __syncwarp();

    // ---- forward DP over positions Lmax..1 (transforms.py:343-381) ----
    const int Lmax = (int)__reduce_max_sync(kFull, (unsigned)L);
    // The costs at i + 1: above every nonzero position, node 0 is the EOB
    // and node 1 costs 1e30; position 64 wraps to 0, whose best cost is 0.
    float c0p = Lmax < 63 ? A.pos[Lmax + 1].y : 0.f;
    float c1p = kBig;
    int e0 = K;  // entries e0.. lie above the step
    for (int i = Lmax; i >= 1; i--) {
      const float4 s = A.pos[i];
      const float Pi = s.x;
      const float* nbi = s_nb + i * 32;
      const float4 st = s_step[i];  // bits of tokens 7, 8, 30, 31
      const float4 ls =
          make_float4(lam * st.x, lam * st.y, lam * st.z, lam * st.w);
      // The i == 1 step keeps one slot of headroom for a zero DC.
      const int lim1 = i == 1 ? 16 : 17;
      const int lim23 = i == 1 ? 2 : 3;
      float best = inf;
      int bf = 0x7FFFFFFF;  // run end << 8 | ending << 3 | combo value + 4
      for (int ee = e0 + g; ee < K; ee += kLanes) {
        const float4 a = A.ent[ee];
        const float2 d = A.dyn[ee];
        const int meta = __float_as_int(a.w);
        const int j = meta & 63;
        const int r = j - i;
        const float D2 = a.x - Pi;
        const float costa = (D2 + (r <= 8 ? ls.x : ls.y)) + d.x;
        float b1 = inf, b23 = inf;
        if ((meta & kHas1) && r <= lim1)
          b1 = ((a.y + D2) + lam * nbi[r <= 5 ? 22 + r : (r <= 9 ? 28 : 29)]) +
               d.y;
        if ((meta & kHas23) && r <= lim23)
          b23 = ((a.z + D2) + (r == 1 ? ls.z : ls.w)) + d.y;
        const float mb = fminf(b1, b23);
        const float m = fminf(costa, mb);
        if (m < best) {  // entries ascend: the lane keeps its first minimum
          const int typ = costa <= mb ? 1 : (b1 <= b23 ? 2 : 3);
          best = m;
          bf = (j << 8) | (typ << 3) |
               ((typ == 3 ? meta >> 11 : meta >> 8) & 7);
        }
      }
#pragma unroll
      for (int o = kLanes / 2; o > 0; o >>= 1) {
        const float ob = __shfl_xor_sync(kFull, best, o);
        const int of = __shfl_xor_sync(kFull, bf, o);
        if (ob < best || (ob == best && of < bf)) {
          best = ob;
          bf = of;
        }
      }
      const bool use_eob = s.y <= best;
      const float c0 = use_eob ? s.y : best;
      const float bn_next = fminf(c0p, c1p);
      const int next1 = c1p < c0p;
      const int bits = __float_as_int(s.w);
      const bool nzi = bits & kNz;
      const float c1 = nzi ? s.z + bn_next : kBig;
      if (g == 0) {
        const int dec =
            next1 | (use_eob ? 0
                             : (((bf >> 3) & 3) << 1) | ((bf >> 8) << 3) |
                                   ((bf & 7) << 9));
        A.dec[i] = bits | (dec << kDecShift);
        if (nzi) A.dyn[e0 - 1] = make_float2(c1, bn_next);
      }
      if (nzi) e0--;
      c0p = c0;
      c1p = c1;
      __syncwarp();
    }

    // ---- backtrack along the path (transforms.py:383-413) ----
    int16_t* orow = reinterpret_cast<int16_t*>(A.ent);
    reinterpret_cast<int4*>(orow)[g] = make_int4(0, 0, 0, 0);
    __syncwarp();
    if (g == 0 && live) {
      orow[0] = (int16_t)q[0];  // DC passes through
      int nac = 0;
      int ep = 1;
      int nd = c1p < c0p;  // node at position 1
      // Above L every node is an EOB; each event moves past its position.
      for (int guard = 0; ep <= L && guard < 63; guard++) {
        const int w = A.dec[ep];
        int at, v, wn;
        if (nd) {  // coded value at ep
          at = ep;
          v = (int16_t)(w & 0xFFFF);
          wn = w;
        } else {
          const int typ = (w >> (kDecShift + 1)) & 3;
          if (typ == 0) break;  // EOB
          at = (w >> (kDecShift + 3)) & 63;  // the run's end
          wn = A.dec[at];
          v = typ == 1 ? (int16_t)(wn & 0xFFFF)
                       : ((w >> (kDecShift + 9)) & 7) - 4;
        }
        orow[at] = (int16_t)v;
        nac += v != 0;
        nd = (wn >> kDecShift) & 1;
        ep = at + 1;
      }
      cnt_out[b] = nac + (q[0] != 0);
      dc_only[b] = nac == 0;
    }
    __syncwarp();
    if (live)
      reinterpret_cast<int4*>(out)[b * 8 + g] =
          reinterpret_cast<const int4*>(orow)[g];
  }
}

}  // namespace

// qrtn [nrows, nseg n, 64], dct [nseg n, 64], deq [nseg, nrows, 2, 64]
// int16, inter [nseg n] uint8, lam [nseg, nrows] float32,
// lam_sc [nseg n] float32 or null; writes out [nrows, nseg n, 64] int16,
// cnt [nrows, nseg n] int32, dc_only [nrows, nseg n] bool. n is the blocks
// of one segment.
extern "C" int th_trellis(const int16_t* qrtn, const int16_t* dct,
                          const int16_t* deq, const uint8_t* inter,
                          const float* lam, const float* lam_sc,
                          const float* nb_full, int16_t* out, int32_t* cnt,
                          uint8_t* dc_only, int64_t n, int nrows, int nseg,
                          void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (nrows < 1 || nrows > kMaxRows || nseg < 1)
    return (int)cudaErrorInvalidValue;
  // The CTAs the card holds at once (its first use sets the shared memory
  // limit and reads the SM count).
  static int resident = 0;
  if (resident == 0) {
    cudaError_t err = cudaFuncSetAttribute(
        trellis_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)kSmemBytes);
    int dev = 0, sms = 0, per_sm = 0;
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, trellis_kernel, kThreads, kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    resident = sms * per_sm;
  }
  // Each segment takes an equal share of the resident CTAs.
  const int64_t need = (n * nrows + kBlocksPerCta - 1) / kBlocksPerCta;
  const int64_t share = resident / nseg > 0 ? resident / nseg : 1;
  const dim3 grid((unsigned)(need < share ? need : share), (unsigned)nseg);
  trellis_kernel<<<grid, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
      qrtn, dct, deq, inter, lam, lam_sc, nb_full, out, cnt, dc_only, n,
      nrows);
  return (int)cudaGetLastError();
}
