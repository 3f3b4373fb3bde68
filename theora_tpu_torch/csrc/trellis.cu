// Kernel KT: the encoder's trellis quantizer for NVIDIA Hopper (sm_90a).
//
// Replaces the JAX trellis theora_tpu/ops/transforms_jax.py:trellis_values
// (:300): a forward dynamic program over the 63 AC positions of each 8x8
// block (a 63-step lax.scan, :471) and a backtrack sweep (a second 63-step
// lax.scan, :527). It is not a Pallas kernel; XLA fuses the scans on the
// TPU. Plain PyTorch version: theora_tpu_torch/ops/transforms.py:
// trellis_quantize (trellis_values behind the casts of this interface).
//
// Interface: kernel K2's outputs as K2 writes them ([N, 64] int16 round-to-
// nearest values and unquantized DCT, zig-zag), K2's [2, 64] int16 dequant
// rows (intra, inter) and [N] uint8 inter flags, the frame's float32 lambda
// and the [64, 32] float32 token bit table. Per block the kernel takes the
// dequant row deq[inter] and acmin (0 for an inter block, 3 for an intra
// one). It writes the chosen values ([N, 64] int16, DC passed through),
// their nonzero count ([N] int32) and whether no AC value is nonzero ([N]
// bool), which kernel K1 and the skip test read as they are.
//
// Exact float32. The decisions must equal the JAX package's, which are what
// XLA on the CPU computes, and so the plain version's:
//   - the prefix sum of c^2 is taken in XLA's chunk-16 order: sequential
//     inside each chunk of 16 positions, the chunk totals summed
//     sequentially and added to each chunk (transforms.py:_xla_cumsum16);
//   - the token costs e*e + lam*bits round once (XLA contracts them into a
//     fused multiply-add): __fmaf_rn(e, e, lam * bits);
//   - every other product and sum is a separate IEEE operation in the
//     Python's left-to-right order, parenthesised as the Python groups it:
//     the file is built with -fmad=false, so nvcc contracts nothing but the
//     explicit __fmaf_rn (and never with --use_fast_math). lam * bits is
//     the same product whether formed per use or once per table entry;
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
// the CTAs the card holds at once, whose warps walk over the blocks. A CTA
// computes the table lam * bits [64][32] and stages the dequant rows in
// shared memory once. Lane g loads positions 8g..8g+7 of each input row as
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
constexpr size_t kSmemBytes = kBlocksPerCta * sizeof(BlockArea) +
                              kNb * sizeof(float) + 64 * sizeof(float4) +
                              2 * 64 * sizeof(int16_t);

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
               const uint8_t* __restrict__ inter_in, float lam,
               const float* __restrict__ nb_full, int16_t* __restrict__ out,
               int32_t* __restrict__ cnt_out, uint8_t* __restrict__ dc_only,
               int64_t n) {
  extern __shared__ float4 smem[];
  BlockArea* areas = reinterpret_cast<BlockArea*>(smem);
  float* s_lnb = reinterpret_cast<float*>(areas + kBlocksPerCta);
  // Per step i: lam * bits of the zero runs up to 8 and longer (tokens 7,
  // 8) and of the +-2/3 combo after a run of 1 and of 2 (tokens 30, 31).
  float4* s_step = reinterpret_cast<float4*>(s_lnb + kNb);
  int16_t* s_deq = reinterpret_cast<int16_t*>(s_step + 64);
  {
    const float4* nb4 = reinterpret_cast<const float4*>(nb_full);
    float4* lnb4 = reinterpret_cast<float4*>(s_lnb);
#pragma unroll
    for (int k = 0; k < kNb / 4 / kThreads; k++) {
      const float4 v = nb4[threadIdx.x + k * kThreads];
      lnb4[threadIdx.x + k * kThreads] =
          make_float4(lam * v.x, lam * v.y, lam * v.z, lam * v.w);
    }
    const int t = threadIdx.x;
    if (t < 64)
      s_step[t] = make_float4(lam * nb_full[t * 32 + 7],
                              lam * nb_full[t * 32 + 8],
                              lam * nb_full[t * 32 + 30],
                              lam * nb_full[t * 32 + 31]);
    if (t < 2 * 64) s_deq[t] = deq_in[t];
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane & (kLanes - 1);  // lane within the block's group
  BlockArea& A = areas[warp * kGroups + lane / kLanes];
  const float inf = __int_as_float(0x7f800000);
  const int64_t ngroups = (n + kGroups - 1) / kGroups;
  for (int64_t wg = (int64_t)blockIdx.x * kWarps + warp; wg < ngroups;
       wg += (int64_t)gridDim.x * kWarps) {
    const int64_t b = wg * kGroups + lane / kLanes;
    const bool live = b < n;
    __syncwarp();  // the previous block's reads of A are done
    int q[8], cd[8];
    int inter = 0;
    {
      int4 qv = make_int4(0, 0, 0, 0), dv = qv;
      if (live) {
        qv = reinterpret_cast<const int4*>(qrtn)[b * 8 + g];
        dv = reinterpret_cast<const int4*>(dct)[b * 8 + g];
        inter = inter_in[b] != 0;
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
    const int16_t* drow = s_deq + (inter ? 64 : 0);
    const int acmin = inter ? 0 : 3;
#pragma unroll
    for (int k = 0; k < 8; k++) {
      const int j = 8 * g + k;
      const int qk = q[k];
      const float cf = (float)cd[k];
      const float df = (float)drow[j];
      const float* lnb = s_lnb + j * 32;
      const int aj = qk < 0 ? -qk : qk;
      const int sj = qk < 0 ? -1 : 1;
      const int cv23 = sj * (aj > 2 ? 3 : 2);
      const int a_cl = min(aj, 580);
      const int neg = qk < 0;
      const int altm = alt_mag(a_cl);
      // Positions below acmin code values rate-free (lam 0).
      const float lnA = j < acmin ? 0.f : lnb[value_token(max(a_cl, 1), neg)];
      const float lnB = j < acmin ? 0.f : lnb[value_token(max(altm, 1), neg)];
      const float eA = (float)(a_cl * sj) * df - cf;
      const float eB = (float)(altm * sj) * df - cf;
      const float cA = __fmaf_rn(eA, eA, lnA);
      const float cB = __fmaf_rn(eB, eB, lnB);
      const bool useB = altm >= 1 && cB < cA;
      const float c1s = aj >= 1 ? (useB ? cB : cA) : kBig;
      const int v1 = aj >= 1 ? (useB ? altm * sj : a_cl * sj) : 0;
      const float costc = (P64 - P[k]) + lnb[0];
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
      const float* lnb = s_lnb + i * 32;
      const float4 ls = s_step[i];  // lam * bits of tokens 7, 8, 30, 31
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
          b1 = ((a.y + D2) + lnb[r <= 5 ? 22 + r : (r <= 9 ? 28 : 29)]) + d.y;
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

extern "C" int th_trellis(const int16_t* qrtn, const int16_t* dct,
                          const int16_t* deq, const uint8_t* inter,
                          float lam, const float* nb_full, int16_t* out,
                          int32_t* cnt, uint8_t* dc_only, int64_t n,
                          void* stream) {
  if (n <= 0) return (int)cudaSuccess;
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
  const int64_t need = (n + kBlocksPerCta - 1) / kBlocksPerCta;
  const int grid = (int)(need < resident ? need : resident);
  trellis_kernel<<<grid, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
      qrtn, dct, deq, inter, lam, nb_full, out, cnt, dc_only, n);
  return (int)cudaGetLastError();
}
