// Kernel KT: the encoder's trellis quantizer for NVIDIA Hopper (sm_90a).
//
// Replaces the JAX trellis theora_tpu/ops/transforms_jax.py:trellis_values
// (:300): a forward dynamic program over the 63 AC positions of each 8x8
// block (a 63-step lax.scan, :471) and a backtrack sweep (a second 63-step
// lax.scan, :527). It is not a Pallas kernel; XLA fuses the scans on the
// TPU. Its plain PyTorch version, theora_tpu_torch/ops/transforms.py:
// trellis_values, runs the same program as ~6,300 small launches per call;
// this kernel runs it for [N] independent blocks in one launch.
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
//     explicit __fmaf_rn (and never with --use_fast_math);
//   - the "infinite" cost is the finite float32 1e30, as in the reference:
//     many comparisons are between sums that contain it;
//   - ties take the first position (jnp.argmin): a float min over the warp,
//     then an integer min over the positions that reach it.
//
// Bound: the memory traffic, ~1 KB per block (three [64] int32 rows and
// two scalars in, one [64] int32 row out). The float32 work the function
// needs takes less at the card's peak rate: step i weighs a run ending at
// each later nonzero position j (about 5 operations, the combos within
// their run limits more), at most 1,953 (i, j) pairs per block;
// chip_smoke.py counts both for its inputs. This kernel is far from that
// bound: every lane evaluates both its positions at every step, needed or
// not, and each step's first-minimum reduction is a chain of dependent
// warp shuffles.
// Design: one warp per block, so the DP's 64-wide steps need no block-wide
// barrier. Lane l holds positions 2l and 2l+1: their prefix sums, error
// bases and the DP's cost0/cost1 columns live in registers; the next
// position's best cost is the lane's own second slot or one shuffle from
// lane l+1 (lane 31 wraps to position 0, as torch.roll does, whose best cost
// is 0). The token bit table nb_full [64, 32] is staged once per thread
// block in shared memory; the per-position constants of the step's start
// (c1_s, v1_s, costc_s, P) are broadcast reads of a per-warp shared row.
// Each step's decision word goes to shared memory; one lane then runs the
// backtrack sweep over them, and the warp stores the block's row.
//
// Plain C interface (loaded with ctypes); launches on the caller's stream,
// allocates nothing and returns cudaGetLastError().
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;  // 8x8 blocks per thread block, one per warp
constexpr int kThreads = kWarps * 32;
constexpr unsigned kFull = 0xffffffffu;
// transforms_jax._BIG: large, but finite.
constexpr float kBig = 1e30f;

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

// One position j of a lane: its constants and its DP columns.
struct Slot {
  float p;      // P[j], the prefix sum of c^2 below j
  float pre1;   // squared error of a +-1 combo ending at j (or kBig)
  float pre23;  // squared error of a +-2/3 combo ending at j (or kBig)
  float cost0;  // best cost from j with node0 (zero run / EOB) at j
  float cost1;  // best cost from j with node1 (coded value) at j
  int sj;       // sign of the round-to-nearest value
  int cv23;     // the +-2/3 combo value
};

// Node0 starting at i with its run ending at j = slot's position: the
// minimum of the three endings (run + value, combo +-1, combo +-2/3), and
// in *fld the decision word's bits 12-30 for that end (ending type, j, the
// combo value). bnn is the best cost at j + 1.
__device__ __forceinline__ float node0_end(int j, int i, int dc_allow,
                                           float lam, float Pi,
                                           const float* nbi, const Slot& s,
                                           float bnn, int* fld) {
  const int r = j - i;
  const float D2 = s.p - Pi;
  const float zb = r <= 8 ? nbi[7] : nbi[8];
  const float amask = r > 0 ? 0.f : kBig;
  const float costa = (D2 + (lam * zb + amask)) + s.cost1;
  const int t1 = r <= 0 ? 22 : (r <= 5 ? 22 + r : (r <= 9 ? 28 : 29));
  const float b1mask = (r > 0 && r <= 16 + dc_allow) ? 0.f : kBig;
  const float b23mask = (r > 0 && r <= 2 + dc_allow) ? 0.f : kBig;
  const float cb23 = r == 1 ? nbi[30] : nbi[31];
  const float cost_b1 = ((s.pre1 + D2) + (lam * nbi[t1] + b1mask)) + bnn;
  const float cost_b23 = ((s.pre23 + D2) + (lam * cb23 + b23mask)) + bnn;
  const float m_b = fminf(cost_b1, cost_b23);
  const int typ = costa <= m_b ? 1 : (cost_b1 <= cost_b23 ? 2 : 3);
  const int cv = typ == 3 ? s.cv23 : s.sj;
  *fld = (typ << 12) | (j << 14) | ((cv + 1024) << 20);
  return fminf(costa, m_b);
}

__global__ void __launch_bounds__(kThreads)
trellis_kernel(const int32_t* __restrict__ dct,
               const int32_t* __restrict__ qrtn,
               const int32_t* __restrict__ deq,
               const float* __restrict__ lam_in,
               const float* __restrict__ nb_full,
               const int32_t* __restrict__ acmin_in,
               int32_t* __restrict__ out, int64_t n) {
  __shared__ float s_nb[64 * 32];
  __shared__ float s_P[kWarps][68];
  __shared__ float s_c1[kWarps][64];
  __shared__ float s_costc[kWarps][64];
  __shared__ int32_t s_v1[kWarps][64];
  __shared__ int32_t s_word[kWarps][64];
  __shared__ int32_t s_out[kWarps][64];

  for (int k = threadIdx.x; k < 64 * 32; k += kThreads) s_nb[k] = nb_full[k];
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t b = (int64_t)blockIdx.x * kWarps + warp;
  if (b >= n) return;
  float* P = s_P[warp];
  float* c1_s = s_c1[warp];
  float* costc_s = s_costc[warp];
  int32_t* v1_s = s_v1[warp];
  int32_t* word = s_word[warp];
  const float lam = lam_in[b];
  const int acmin = acmin_in[b];

  // ---- per-position constants (transforms.py:285-313) ----
  Slot s[2];
  int q0 = 0;
#pragma unroll
  for (int h = 0; h < 2; h++) {
    const int j = 2 * lane + h;
    const int64_t at = b * 64 + j;
    const int q = qrtn[at];
    const float cf = (float)dct[at];
    const float df = (float)deq[at];
    const int aj = q < 0 ? -q : q;
    const int sj = q < 0 ? -1 : 1;
    const int cv23 = sj * (aj > 2 ? 3 : 2);
    const float lamv = j < acmin ? 0.f : lam;
    const int a_cl = min(aj, 580);
    const int neg = q < 0;
    const int altm = alt_mag(a_cl);
    const float nbA = s_nb[j * 32 + value_token(max(a_cl, 1), neg)];
    const float nbB = s_nb[j * 32 + value_token(max(altm, 1), neg)];
    const float eA = (float)(a_cl * sj) * df - cf;
    const float eB = (float)(altm * sj) * df - cf;
    const float cA = __fmaf_rn(eA, eA, lamv * nbA);
    const float cB = __fmaf_rn(eB, eB, lamv * nbB);
    const bool useB = altm >= 1 && cB < cA;
    c1_s[j] = aj >= 1 ? (useB ? cB : cA) : kBig;
    v1_s[j] = aj >= 1 ? (useB ? altm * sj : a_cl * sj) : 0;
    const float e1 = cf - (float)sj * df;
    const float e23 = cf - (float)cv23 * df;
    s[h].pre1 = (aj >= 1 && aj <= 2) ? e1 * e1 : kBig;
    s[h].pre23 = (aj >= 2 && aj <= 4) ? e23 * e23 : kBig;
    s[h].sj = sj;
    s[h].cv23 = cv23;
    s[h].cost0 = j == 0 ? 0.f : kBig;
    s[h].cost1 = kBig;
    P[j + 1] = q != 0 ? cf * cf : 0.f;  // z, summed in place below
    if (j == 0) q0 = q;
  }
  __syncwarp();
  // Prefix sum in XLA's order: sequential inside each chunk of 16...
  if (lane < 4) {
    float* c = P + 1 + 16 * lane;
    for (int k = 1; k < 16; k++) c[k] = c[k - 1] + c[k];
  }
  __syncwarp();
  // ...then the chunk totals, sequentially, added to each chunk.
  float pre[4];
  pre[0] = 0.f;
  pre[1] = pre[0] + P[16];
  pre[2] = pre[1] + P[32];
  pre[3] = pre[2] + P[48];
  __syncwarp();
#pragma unroll
  for (int h = 0; h < 2; h++) {
    const int j = 2 * lane + h;
    P[j + 1] = P[j + 1] + pre[j >> 4];
  }
  if (lane == 0) P[0] = 0.f;
  __syncwarp();
  const float P64 = P[64];
#pragma unroll
  for (int h = 0; h < 2; h++) {
    const int j = 2 * lane + h;
    s[h].p = P[j];
    costc_s[j] = (P64 - P[j]) + lam * s_nb[j * 32];
  }
  __syncwarp();

  // ---- forward DP over positions 63..1 (transforms.py:334-380) ----
  float c0p = 0.f, c1p = kBig;  // the costs at i + 1 (63 wraps to 0)
  for (int i = 63; i >= 1; i--) {
    const float bn_next = fminf(c0p, c1p);
    const int next1 = c1p < c0p;
    const float c1 = c1_s[i] + bn_next;
    const float Pi = P[i];
    const float* nbi = s_nb + i * 32;
    const int dc_allow = i == 1 ? 0 : 1;  // the i == 1 step's headroom
    const float bn0 = fminf(s[0].cost0, s[0].cost1);
    const float bn1 = fminf(s[1].cost0, s[1].cost1);
    const float bn2 = __shfl_sync(kFull, bn0, (lane + 1) & 31);
    int f0, f1;
    const float m0 =
        node0_end(2 * lane, i, dc_allow, lam, Pi, nbi, s[0], bn1, &f0);
    const float m1 =
        node0_end(2 * lane + 1, i, dc_allow, lam, Pi, nbi, s[1], bn2, &f1);
    float cbest = fminf(m0, m1);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      cbest = fminf(cbest, __shfl_xor_sync(kFull, cbest, o));
    const unsigned cand =
        m0 == cbest ? 2 * lane : (m1 == cbest ? 2 * lane + 1 : 64);
    const int jbest = (int)__reduce_min_sync(kFull, cand);
    const int fld = __shfl_sync(kFull, (jbest & 1) ? f1 : f0, jbest >> 1);
    const float costc = costc_s[i];
    const bool use_eob = costc <= cbest;
    const float c0 = use_eob ? costc : cbest;
    // Decision word: bits 0-10 node1 value + 1024, 11 node1 successor,
    // 12-13 node0 ending, 14-19 node0 run end, 20-30 combo value + 1024.
    if (lane == 0)
      word[i] = (v1_s[i] + 1024) | (next1 << 11) |
                (use_eob ? (fld & ~0xFF000) : fld);
    if (lane == (i >> 1)) {
      if (i & 1) {
        s[1].cost0 = c0;
        s[1].cost1 = c1;
      } else {
        s[0].cost0 = c0;
        s[0].cost1 = c1;
      }
    }
    c0p = c0;
    c1p = c1;
  }

  // ---- backtrack over positions 1..63 (transforms.py:384-412) ----
  int32_t* o = s_out[warp];
  if (lane == 0) {
    // Position 1 is lane 0's second slot.
    int ep = 1, nd = s[1].cost1 < s[1].cost0;
    bool runend = false, take = false;
    int pend = 0;
    o[0] = q0;  // DC passes through
    for (int p = 1; p < 64; p++) {
      const int w = word[p];
      const int v1 = (w & 0x7FF) - 1024;
      const int nxt1 = (w >> 11) & 1;
      const int er = (w >> 12) & 3;
      const int jr = (w >> 14) & 63;
      const int cv = ((w >> 20) & 0x7FF) - 1024;
      const bool at = ep == p;
      const bool isn = at && !runend;
      const bool isr = at && runend;
      const bool n1 = isn && nd == 1;
      const bool run = isn && nd == 0 && er != 0;
      o[p] = n1 ? v1 : (isr ? (take ? v1 : pend) : 0);
      const bool adv = n1 || isr;
      if (at) ep = adv ? p + 1 : (run ? jr : 0);
      if (adv) nd = nxt1;
      if (at) runend = run;
      if (run) {
        pend = cv;
        take = er == 1;
      }
    }
  }
  __syncwarp();
#pragma unroll
  for (int h = 0; h < 2; h++) out[b * 64 + 2 * lane + h] = o[2 * lane + h];
}

}  // namespace

extern "C" int th_trellis(const int32_t* dct, const int32_t* qrtn,
                          const int32_t* deq, const float* lam,
                          const float* nb_full, const int32_t* acmin,
                          int32_t* out, int64_t n, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const int64_t grid = (n + kWarps - 1) / kWarps;
  trellis_kernel<<<(unsigned)grid, kThreads, 0, (cudaStream_t)stream>>>(
      dct, qrtn, deq, lam, nb_full, acmin, out, n);
  return (int)cudaGetLastError();
}
