// Fused-wire kernels of the ring exchanges for Hopper (sm_90a), plain C
// interface.
//
// A ring exchange (parallel/transpose.py ring_transpose) under the bf16
// wire sends each travelling block as a planar (real, imag) bfloat16 pair
// and decodes it on arrival. These kernels replace the three Pallas TPU
// kernels of distributedfft_tpu/ops/pallas_fft.py that do that:
//
//   enc_pack_kernel                    <- _enc_pack_kernel   (kernel 9)
//   dec_unpack_kernel                  <- _dec_unpack_kernel (kernel 10)
//   stage_tile_kernel<CMATMUL_BF16>    <- _dec_cmatmul_kernel (kernel 11)
//
// Kernel 9 reads the travelling block of complex64 straight from the
// plan's array as a strided 3D view (a chunk of the split axis), so the
// block is never copied to a contiguous buffer first, and writes the two
// bfloat16 planes contiguously, rounded to nearest even
// (__float2bfloat16_rn, what Tensor.to(torch.bfloat16) does on the card).
// Kernel 10 widens the planes back to interleaved complex64: exact.
// Kernel 11 is the tile loop of the per-axis stage (stage_tile.cuh) with an
// A-loader that widens the bfloat16 planes to float32 on their way into
// shared memory, so the decoded block never reaches device memory; the
// product with the (n, n) DFT planes is written as interleaved complex64.
//
// Bound on an H100 SXM (float32 outside the tensor cores 67 TFLOP/s, HBM3
// 3.35 TB/s; bytes each input read once and each output written once) at
// the per-rank shapes of a 1024^3 plan over four ranks:
//
//   kernels 9, 10: a (256, 256, 513) block, 33,619,968 elements of 8 bytes
//       in and 4 bytes out: 403.4 MB -> 0.120 ms              (bytes)
//   kernel 11: the c2c inverse arrival, M 65,536 rows of n = 1024:
//       8 M n^2 = 5.50e11 FLOP -> 8.2 ms; 0.81 GB -> 0.24 ms  (operations)
//
// What the design does about those bounds: kernels 9 and 10 move memory
// and do no arithmetic; neighbouring threads take neighbouring elements, so
// loads and stores coalesce along the block's last axis (no vector loads
// yet). Kernel 11 shares the float32 FFMA tile loop of kernels 1-5; tensor
// cores and TMA are later work.
//
// Every extern "C" entry point returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "stage_tile.cuh"

namespace {

constexpr int PASS_THREADS = 256;
constexpr unsigned PASS_MAX_BLOCKS = 1u << 16;

unsigned pass_blocks(unsigned n) {
  const unsigned b = (n + PASS_THREADS - 1) / PASS_THREADS;
  return b < PASS_MAX_BLOCKS ? b : PASS_MAX_BLOCKS;
}

// x: complex64 elements at x[i0 * s0 + i1 * s1 + i2 * s2] for the block
// (d0, d1, d2), strides in complex elements; y: (2, d0, d1, d2) bfloat16.
__global__ void __launch_bounds__(PASS_THREADS)
enc_pack_kernel(const float2* __restrict__ x, __nv_bfloat16* __restrict__ y,
                unsigned d1, unsigned d2, long long s0, long long s1,
                long long s2, unsigned n) {
  const unsigned step = gridDim.x * blockDim.x;
  for (unsigned i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += step) {
    const unsigned i2 = i % d2, row = i / d2;
    const unsigned i1 = row % d1, i0 = row / d1;
    const float2 v = x[i0 * s0 + i1 * s1 + i2 * s2];
    y[i] = __float2bfloat16_rn(v.x);
    y[(size_t)n + i] = __float2bfloat16_rn(v.y);
  }
}

// y: (2, n) bfloat16 planes; out: n interleaved complex64.
__global__ void __launch_bounds__(PASS_THREADS)
dec_unpack_kernel(const __nv_bfloat16* __restrict__ y,
                  float2* __restrict__ out, unsigned n) {
  const unsigned step = gridDim.x * blockDim.x;
  for (unsigned i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += step)
    out[i] = make_float2(__bfloat162float(y[i]),
                         __bfloat162float(y[(size_t)n + i]));
}

}  // namespace

extern "C" {

const char* dfft_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// Kernel 9. x: complex64 block (d0, d1, d2) at element strides (s0, s1,
// s2); y: contiguous (2, d0, d1, d2) bfloat16.
int dfft_enc_pack(const void* x, void* y, int d0, int d1, int d2, int s0,
                  int s1, int s2, void* stream) {
  if (d0 < 1 || d1 < 1 || d2 < 1 || s0 < 0 || s1 < 0 || s2 < 0)
    return cudaErrorInvalidValue;
  const long long n = (long long)d0 * d1 * d2;
  if (n > 0x7fffffffLL) return cudaErrorInvalidValue;
  const unsigned un = (unsigned)n;
  enc_pack_kernel<<<pass_blocks(un), PASS_THREADS, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(x), static_cast<__nv_bfloat16*>(y),
      (unsigned)d1, (unsigned)d2, s0, s1, s2, un);
  return cudaGetLastError();
}

// Kernel 10. y: (2, n) bfloat16; out: n complex64.
int dfft_dec_unpack(const void* y, void* out, int n, void* stream) {
  if (n < 1) return cudaErrorInvalidValue;
  dec_unpack_kernel<<<pass_blocks((unsigned)n), PASS_THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(y), static_cast<float2*>(out),
      (unsigned)n);
  return cudaGetLastError();
}

// Kernel 11. y: (2, M, n) bfloat16 planes; fr, fi: (n, n) float32 DFT
// planes; out: (M, n) complex64 = decode(y) @ (fr + i fi).
int dfft_dec_cmatmul(const void* y, const float* fr, const float* fi,
                     float* out, int M, int n, void* stream) {
  if (M < 1 || n < 1) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)(((long long)M + BM - 1) / BM), (n + BN - 1) / BN);
  stage_tile_kernel<MODE_CMATMUL_BF16, false>
      <<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float*>(y), fr, fi, nullptr, nullptr, out, M, n,
          n, 1);
  return cudaGetLastError();
}

}  // extern "C"
