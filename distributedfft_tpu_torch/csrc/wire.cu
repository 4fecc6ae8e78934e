// Fused-wire kernels of the ring exchanges for Hopper (sm_90a), plain C
// interface.
//
// A ring exchange (parallel/transpose.py ring_transpose) under the bf16
// wire sends each travelling block as a planar (real, imag) bfloat16 pair
// and decodes it on arrival. These kernels replace the three Pallas TPU
// kernels of distributedfft_tpu/ops/pallas_fft.py that do that:
//
//   enc_pack_kernel                  <- _enc_pack_kernel    (kernel 9)
//   dec_unpack_kernel                <- _dec_unpack_kernel  (kernel 10)
//   fft_rows_kernel<L, DecodeRows>   <- _dec_cmatmul_kernel (kernel 11),
//     power-of-two rows of 8 to 1024 points (the FFT body)
//   stage_tile_kernel<CMATMUL_BF16>  <- _dec_cmatmul_kernel (kernel 11),
//     any other length (the tile body)
//
// Kernel 9 reads the travelling block of complex64 straight from the
// plan's array as a strided 3D view (a chunk of the split axis), so the
// block is never copied to a contiguous buffer first, and writes the two
// bfloat16 planes contiguously, rounded to nearest even
// (__float2bfloat16_rn, what Tensor.to(torch.bfloat16) does on the card).
// Kernel 10 widens the planes back to interleaved complex64: exact.
// Kernel 11 decodes an arrived block and runs the DFT of each of its rows,
// so the decoded block never reaches device memory. Its FFT body is the
// row engine of fft_rows.cuh: the batch's rows of both bfloat16 planes
// arrive by bulk copy, the first pass widens them to float32 as it reads
// them, and the epilogue stores interleaved complex64. Its tile body (any
// length that is not a power of two in [8, 1024], e.g. the 257- or
// 520-point axes of uneven grids) is the dense tile loop of the per-axis
// stage (stage_tile.cuh) with an A-loader that widens the planes on their
// way into shared memory.
//
// Bound on an H100 SXM (3.35 TB/s HBM3, float32 outside the tensor cores
// 67 TFLOP/s; bytes each input read once and each output written once,
// flop the FFT's nominal 5 n log2 n a complex row) at the per-rank shapes
// of a 1024^3 plan over four ranks:
//
//   kernels 9, 10: a (256, 256, 513) block, 33,619,968 elements of 8 bytes
//       in and 4 bytes out: 403.4 MB -> 0.120 ms              (bytes)
//   kernel 11: the c2c inverse arrival, M 65,536 rows of n = 1024:
//       12 M n bytes = 805 MB -> 0.240 ms; 3.4e9 flop -> 0.05 ms (bytes)
//
// What the design does about those bounds: kernels 9 and 10 move memory
// and do no arithmetic; neighbouring threads take neighbouring elements, so
// loads and stores coalesce along the block's last axis. Kernel 11's FFT
// body reads each input byte once, keeps the batches in flight with bulk
// copies, and does 5 n log2 n flop a row instead of the dense product's
// 8 n^2 (fft_rows.cuh).
//
// Every extern "C" entry point returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "fft_rows.cuh"
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

// Kernel 11's rows for the FFT engine: (2, M, n) bfloat16 planes in,
// (M, n) interleaved complex64 out.
struct DecodeRows {
  const __nv_bfloat16* y;
  float* out;
  int M;
  static constexpr int ISSUERS = 1;

  template <int L>
  __host__ __device__ int batches() const {
    return (M + fft_rows::Geometry<L>::ROWS - 1) / fft_rows::Geometry<L>::ROWS;
  }
  // The real plane's rows, then the imaginary plane's.
  template <int L>
  __host__ __device__ static constexpr int stage_bytes() {
    return 4 * fft_rows::Geometry<L>::POINTS;
  }
  template <int L>
  __device__ int rows_in(int b) const {
    constexpr int ROWS = fft_rows::Geometry<L>::ROWS;
    const int left = M - b * ROWS;
    return left < ROWS ? left : ROWS;
  }
  template <int L>
  __device__ void issue(unsigned char* buf, int b, uint64_t* bar) const {
    using G = fft_rows::Geometry<L>;
    const uint32_t bytes = 2u * rows_in<L>(b) * G::N;
    const size_t first = (size_t)b * G::POINTS;
    fft_rows::mbar_expect_tx(bar, 2 * bytes);
    fft_rows::bulk_load(buf, y + first, bytes, bar);
    fft_rows::bulk_load(buf + 2 * G::POINTS, y + (size_t)M * G::N + first,
                        bytes, bar);
  }
  template <int L>
  __device__ float2 load(const unsigned char* buf, int, int row,
                         int i) const {
    using G = fft_rows::Geometry<L>;
    const __nv_bfloat16* p = reinterpret_cast<const __nv_bfloat16*>(buf);
    const int e = row * G::N + i;
    return make_float2(__bfloat162float(p[e]),
                       __bfloat162float(p[G::POINTS + e]));
  }
  template <int L>
  __device__ void store(const float* re, const float* im, int b) const {
    using G = fft_rows::Geometry<L>;
    const int count = rows_in<L>(b) * G::N;
    float4* o = reinterpret_cast<float4*>(out + (size_t)b * G::POINTS * 2);
    for (int e = 2 * threadIdx.x; e < count; e += 2 * fft_rows::THREADS) {
      const int i = fft_rows::pad(e);  // e even: e + 1 pads to i + 1
      o[e / 2] = make_float4(re[i], im[i], re[i + 1], im[i + 1]);
    }
  }
};

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

// Kernel 11, tile body. y: (2, M, n) bfloat16 planes; fr, fi: (n, n)
// float32 DFT planes; out: (M, n) complex64 = decode(y) @ (fr + i fi).
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

// Kernel 11, FFT body. y: (2, M, n) bfloat16 planes, n a power of two in
// [8, 1024], 16-byte aligned; table: the (2, n - r0) float32 twiddles of
// ops/hopper_fft.fft_plan(n, inverse) and schedule its packed radices;
// out: (M, n) complex64, unnormalized.
int dfft_dec_fft(const void* y, const float* table, float* out, int M, int n,
                 int schedule, int inverse, void* stream) {
  if (M < 1) return cudaErrorInvalidValue;
  if (fft_rows::misaligned(y) || fft_rows::misaligned(out))
    return cudaErrorMisalignedAddress;
  const DecodeRows body{static_cast<const __nv_bfloat16*>(y), out, M};
  return fft_rows::launch(n, schedule, body, table, inverse,
                          static_cast<cudaStream_t>(stream));
}

}  // extern "C"
