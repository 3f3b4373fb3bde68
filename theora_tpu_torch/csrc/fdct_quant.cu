// Kernel K2: 8x8 integer forward DCT + round-to-nearest quantization of the
// encode scan at K quantizer rows, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas kernel theora_tpu/ops/pallas_kernels.py:
// fdct_quantize_soa (body _fdct_quant_kernel), which computes the function
// of `fdct8x8` + `quantize` in the JAX encode scan
// (theora_tpu/encode/tpu_gop.py:203-218); with adaptive quantization the
// scan quantizes one fDCT with each of its K <= 3 qi rows
// (tpu_gop.py:249-264). Besides the K quantized rows it writes the
// unquantized zig-zag DCT, which the trellis reads. Plain PyTorch version:
// theora_tpu_torch/ops/transforms.py:fdct_quantize. The arithmetic and the
// block layout are csrc/fdct_core.cuh's, which kernel KR's fused entry
// (csrc/quantize_rd.cu) shares.
//
// Bound: memory. Per block the kernel reads 128 B of residuals and 1 B of
// flag and writes 128 B of DCT and K x 128 B of values (641 B at K = 3);
// the K x 256 B of dequant rows are read once per CTA. Design: 8 lanes per
// block, 4 blocks per warp, 8 warps per CTA (fdct_core.cuh); lane c
// stores zig-zag positions 8c..8c+7 of the DCT and, for each qi row, of
// the quantized values, each as one 16-byte store: the K quantizations
// read the DCT from registers.
//
// Segments: a launch may cover G segments of n blocks each (the mesh
// encoder's G GOPs at one frame step: N = G n blocks of one plane), each
// with its own K dequant rows ([G][K][2][64]); block b takes segment b / n.
// The segment is blockIdx.y, so a CTA stages one segment's rows and never
// straddles two; G = 1 is the one-segment launch.
//
// th_mc_fdct_quant, the encode scan's entry: the same kernel with kernel
// KS's MC as its head (csrc/mc_core.cuh: mc_residual_row). Lane c makes
// raster row c of the block's residual in registers, the source row
// minus the prediction row (8 bytes from the reference planes: one or two
// rows, averaged where the motion is half-pel, 128 for an intra block),
// where K2's core would load it; nothing after that load changes. The
// prediction and the residual never reach device memory: per block 64 B
// of source, 6 B of side rows and the reference rows in, in place of
// 128 B of residual (tools/bench_mc.py:fused_bound). Plain version:
// ops/mc.py:mc_residual, then transforms.fdct_quantize.
//
// Plain C interface (loaded with ctypes); launches on the caller's stream,
// allocates nothing and returns cudaGetLastError().
#include <cstdint>
#include <cuda_runtime.h>

#include "fdct_core.cuh"
#include "mc_core.cuh"

namespace {

// MC: the residual rows made by KS's MC row from mc (res unused);
// otherwise loaded from res.
template <int K, bool MC>
__global__ void __launch_bounds__(kThreads)
fdct_quant_kernel(const int16_t* __restrict__ res, McSrc mc,
                  const int16_t* __restrict__ deq,
                  const uint8_t* __restrict__ inter,
                  int16_t* __restrict__ qout, int16_t* __restrict__ dout,
                  int64_t n) {
  __shared__ BlockArea areas[kBlocksPerCta];
  // The K qi rows [k][inter][z] and their reciprocals ceil(2^31 / d).
  __shared__ __align__(16) int16_t s_deq[K * 2 * 64];
  __shared__ __align__(16) uint32_t s_rcp[K * 2 * 64];

  const int tid = threadIdx.x;
  const int64_t seg = blockIdx.y;
  stage_rows<K>(deq + seg * (K * 2 * 64), s_deq, s_rcp);
  __syncthreads();

  const int c = tid & (kLanes - 1);       // row (in), column (passes)
  const int lb = tid / kLanes;            // local block
  const int64_t local = (int64_t)blockIdx.x * kBlocksPerCta + lb;
  const bool live = local < n;
  const int64_t b = seg * n + local;  // block of the launch
  const int64_t total = n * gridDim.y;

  // Zig-zag positions 8c..8c+7.
  int32_t v[8];
  if (MC)
    block_dct_row(live ? mc_residual_row(mc, seg, local, b, total, c)
                       : make_int4(0, 0, 0, 0),
                  areas[lb], c, v);
  else
    block_dct(res, areas[lb], b, c, live, v);
  if (live) {
    reinterpret_cast<int4*>(dout)[b * 8 + c] = pack8(v);
    const int t = inter[b] ? 1 : 0;
#pragma unroll
    for (int k = 0; k < K; k++) {
      int32_t d[8], q[8];
      quantize8(v, s_deq, s_rcp, (k * 2 + t) * 64 + 8 * c, d, q);
      reinterpret_cast<int4*>(qout)[((int64_t)k * total + b) * 8 + c] =
          pack8(q);
    }
  }
}

template <bool MC>
int launch(const int16_t* res, const McSrc& mc, const int16_t* deq,
           const uint8_t* inter, int16_t* qout, int16_t* dout, int64_t n,
           int k, int nseg, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (k < 1 || k > kMaxRows || nseg < 1 || nseg > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((n + kBlocksPerCta - 1) / kBlocksPerCta),
                  (unsigned)nseg);
  cudaStream_t s = (cudaStream_t)stream;
  if (k == 1)
    fdct_quant_kernel<1, MC><<<grid, kThreads, 0, s>>>(res, mc, deq, inter,
                                                        qout, dout, n);
  else if (k == 2)
    fdct_quant_kernel<2, MC><<<grid, kThreads, 0, s>>>(res, mc, deq, inter,
                                                        qout, dout, n);
  else
    fdct_quant_kernel<3, MC><<<grid, kThreads, 0, s>>>(res, mc, deq, inter,
                                                        qout, dout, n);
  return (int)cudaGetLastError();
}

}  // namespace

// res [nseg n, 64] int16, deq [nseg, k, 2, 64] int16, inter [nseg n]
// uint8; writes qout [k, nseg n, 64] and dout [nseg n, 64] int16. n is the
// blocks of one segment.
extern "C" int th_fdct_quant(const int16_t* res, const int16_t* deq,
                             const uint8_t* inter, int16_t* qout,
                             int16_t* dout, int64_t n, int k, int nseg,
                             void* stream) {
  return launch<false>(res, McSrc{}, deq, inter, qout, dout, n, k, nseg,
                       stream);
}

// th_fdct_quant with the residual made in the kernel by KS's MC
// (csrc/mc_core.cuh), as th_mc_residual makes it: prev, gold [nseg][Hp]
// [Wp] uint8 (8-byte aligned; may be one buffer), cur [nseg n][64] uint8
// (8-byte aligned), side [6][nseg n] int8, fid [n] int32 or null (then
// n = nv nh): block b of segment g is fragment fid[b % n] (or b % n) of
// plane g. Nothing but qout and dout is written.
extern "C" int th_mc_fdct_quant(const uint8_t* prev, const uint8_t* gold,
                                const uint8_t* cur, const int8_t* side,
                                const int32_t* fid, const int16_t* deq,
                                const uint8_t* inter, int16_t* qout,
                                int16_t* dout, int64_t n, int k, int nseg,
                                int Hp, int Wp, int nv, int nh, int pad_y,
                                int pad_x, void* stream) {
  const Geo q{nv, nh, pad_y, pad_x, Hp, Wp};
  if (bad_geometry(nseg, q) || (!fid && n != (int64_t)nv * nh) ||
      n * nseg > (1L << 27) || misaligned(prev, 8) || misaligned(gold, 8) ||
      misaligned(cur, 8))
    return (int)cudaErrorInvalidValue;
  return launch<true>(nullptr, McSrc{prev, gold, cur, side, fid, q}, deq,
                      inter, qout, dout, n, k, nseg, stream);
}
