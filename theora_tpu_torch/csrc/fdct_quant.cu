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
// Plain C interface (loaded with ctypes); launches on the caller's stream,
// allocates nothing and returns cudaGetLastError().
#include <cstdint>
#include <cuda_runtime.h>

#include "fdct_core.cuh"

namespace {

template <int K>
__global__ void __launch_bounds__(kThreads)
fdct_quant_kernel(const int16_t* __restrict__ res,
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

}  // namespace

// res [nseg n, 64] int16, deq [nseg, k, 2, 64] int16, inter [nseg n]
// uint8; writes qout [k, nseg n, 64] and dout [nseg n, 64] int16. n is the
// blocks of one segment.
extern "C" int th_fdct_quant(const int16_t* res, const int16_t* deq,
                             const uint8_t* inter, int16_t* qout,
                             int16_t* dout, int64_t n, int k, int nseg,
                             void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (k < 1 || k > kMaxRows || nseg < 1 || nseg > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((n + kBlocksPerCta - 1) / kBlocksPerCta),
                  (unsigned)nseg);
  cudaStream_t s = (cudaStream_t)stream;
  if (k == 1)
    fdct_quant_kernel<1><<<grid, kThreads, 0, s>>>(res, deq, inter, qout,
                                                    dout, n);
  else if (k == 2)
    fdct_quant_kernel<2><<<grid, kThreads, 0, s>>>(res, deq, inter, qout,
                                                    dout, n);
  else
    fdct_quant_kernel<3><<<grid, kThreads, 0, s>>>(res, deq, inter, qout,
                                                    dout, n);
  return (int)cudaGetLastError();
}
