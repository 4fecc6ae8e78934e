// Per-axis DFT stage kernels for Hopper (sm_90a), plain C interface.
//
// One DFT stage along the last axis of a batch of rows is a matrix product
//
//   Y (M x k) = X (M x n) @ F (n x k)          [then Y[r, :] *= T[r % n1, :]]
//
// with F a (partial) DFT matrix and T the four-step twiddle, built on the
// host (ops/mxu_fft.py) and passed as float32 (real, imag) planes. X and Y
// are read and written interleaved (the memory of a complex64 tensor), not
// as split planes: on the card a split would cost two extra passes over the
// data per stage. Computed in float32 FFMA on the CUDA cores; no tensor
// cores yet.
//
// Each instantiation replaces one Pallas TPU kernel of
// distributedfft_tpu/ops/pallas_fft.py, all reached through _call_stage /
// _c2r_stage:
//
//   MODE_CMATMUL             <- _cmatmul_kernel     (kernel 2, complex rows)
//   MODE_RMATMUL             <- _rmatmul_kernel     (kernel 1, real rows)
//   MODE_C2R                 <- _c2r_kernel         (kernel 3, real output)
//   MODE_CMATMUL + twiddle   <- _cmatmul_tw_kernel  (kernel 4)
//   MODE_RMATMUL + twiddle   <- _rmatmul_tw_kernel  (kernel 5)
//
// Kernel 3 computes y = Re(c) @ CR - Im(c) @ CI. Read as real numbers, a row
// of interleaved complex input is [re0, im0, re1, im1, ...], so the C2R is
// one real product of depth 2 * n_in whose B operand row 2j is CR[j] and row
// 2j + 1 is -CI[j]: the same tile loop as kernel 1, with a real output.
//
// Bound on an H100 SXM (float32 outside the tensor cores 67 TFLOP/s, HBM3
// 3.35 TB/s; FLOP as the JAX wrappers' pl.CostEstimate counts them, bytes
// each input read once and each output written once):
//
//   kernel 1, 512^3 over 2 ranks (M 131072, n 512, k 257):
//       6.90e10 FLOP -> 1.03 ms;   0.54 GB -> 0.16 ms   (operations)
//   kernel 2, same plan (M 65792, n = k = 512):
//       1.38e11 FLOP -> 2.06 ms;   0.54 GB -> 0.16 ms   (operations)
//   kernel 2, second four-step stage at 1024^3 (M 5.37e8, n = k = 2):
//       1.72e10 FLOP -> 0.26 ms;   17.2 GB -> 5.1 ms    (bytes)
//   kernel 3, 512^3 over 2 ranks (M 131072, n_in 257, n 512):
//       6.90e10 FLOP -> 1.03 ms;   0.54 GB -> 0.16 ms   (operations)
//   kernel 4, 1024^3 x/y forward (M 1050624, n = k = 512):
//       2.20e12 FLOP -> 32.9 ms;   8.6 GB -> 2.6 ms     (operations)
//   kernel 5, 1024^3 z forward (M 2097152, n = k = 512):
//       2.20e12 FLOP -> 32.8 ms;   12.9 GB -> 3.8 ms    (operations)
//
// What the design does about those bounds:
// - Wide stages (operations bound) take the tile path of stage_tile.cuh:
//   64 x 64 output tiles, depth 16, 256 threads each holding a 4 x 4
//   complex register tile, as x_c2c_kernel in fused3d.cu does; an operand
//   fetched from shared memory feeds 4 (real) to 16 (complex) FMAs. The
//   twiddle is applied in registers before the store, so a four-step first
//   stage costs no extra pass.
// - Narrow stages (n and k of a few points: the 2-point second stage of the
//   1024 four-step, bound by bytes) take the row path: one thread per row,
//   the row held in registers, F in shared memory, so each byte of X and Y
//   crosses HBM once and no lane of a 64-wide tile idles.
// - Ragged edges (k = 257, n_in = 257, any M) are masked element by
//   element; no vector load crosses a row.
// - Offsets are 64-bit: one interleaved plane at 1024^3 holds 2.15e9
//   floats, above INT_MAX.
//
// Every extern "C" entry point returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>

#include "stage_tile.cuh"

namespace {

// ---------------------------------------------------------------------------
// Row path: one thread per row, for stages a few points wide.
// ---------------------------------------------------------------------------

constexpr int ROW_D = 32;        // largest depth (elements of an A row)
constexpr int ROW_K = 16;        // largest output width
constexpr int ROW_THREADS = 256;

template <int MODE, bool TW>
__global__ void __launch_bounds__(ROW_THREADS)
stage_row_kernel(const float* __restrict__ x, const float* __restrict__ fr,
                 const float* __restrict__ fi, const float* __restrict__ tr,
                 const float* __restrict__ ti, float* __restrict__ y, int M,
                 int n, int k, int n1) {
  __shared__ float Fs_r[ROW_D * ROW_K];
  __shared__ float Fs_i[ROW_D * ROW_K];
  const int D = MODE == MODE_C2R ? 2 * n : n;
  for (int e = threadIdx.x; e < D * k; e += ROW_THREADS) {
    if constexpr (MODE == MODE_C2R) {
      const int d = e / k, c = e % k;
      const size_t off = (size_t)(d >> 1) * k + c;
      Fs_r[e] = (d & 1) ? -fi[off] : fr[off];
    } else {
      Fs_r[e] = fr[e];
      Fs_i[e] = fi[e];
    }
  }
  __syncthreads();
  const long long row = (long long)blockIdx.x * ROW_THREADS + threadIdx.x;
  if (row >= M) return;

  float a_r[ROW_D], a_i[ROW_D];
#pragma unroll
  for (int d = 0; d < ROW_D; ++d) {
    a_r[d] = a_i[d] = 0.f;
    if (d < D) {
      if constexpr (MODE == MODE_CMATMUL) {
        const float2 v = reinterpret_cast<const float2*>(x)[row * n + d];
        a_r[d] = v.x;
        a_i[d] = v.y;
      } else {
        a_r[d] = x[row * D + d];
      }
    }
  }
  const int trow = TW ? (int)(row % n1) : 0;
  float2* y2 = reinterpret_cast<float2*>(y);
  for (int j = 0; j < k; ++j) {
    float vr = 0.f, vi = 0.f;
#pragma unroll
    for (int d = 0; d < ROW_D; ++d) {
      if (d < D) {
        const float br = Fs_r[d * k + j];
        if constexpr (MODE == MODE_CMATMUL) {
          const float bi = Fs_i[d * k + j];
          vr = fmaf(a_r[d], br, vr);
          vr = fmaf(-a_i[d], bi, vr);
          vi = fmaf(a_r[d], bi, vi);
          vi = fmaf(a_i[d], br, vi);
        } else if constexpr (MODE == MODE_RMATMUL) {
          vr = fmaf(a_r[d], br, vr);
          vi = fmaf(a_r[d], Fs_i[d * k + j], vi);
        } else {
          vr = fmaf(a_r[d], br, vr);
        }
      }
    }
    if constexpr (MODE == MODE_C2R) {
      y[row * k + j] = vr;
    } else {
      if constexpr (TW) {
        const size_t t = (size_t)trow * k + j;
        const float wr = tr[t], wi = ti[t];
        const float pr = vr * wr - vi * wi;
        vi = vr * wi + vi * wr;
        vr = pr;
      }
      y2[row * k + j] = make_float2(vr, vi);
    }
  }
}

template <int MODE, bool TW>
cudaError_t launch(const float* x, const float* fr, const float* fi,
                   const float* tr, const float* ti, float* y, int M, int n,
                   int k, int n1, cudaStream_t stream) {
  const int D = MODE == MODE_C2R ? 2 * n : n;
  if (D <= ROW_D && k <= ROW_K) {
    const unsigned blocks =
        (unsigned)(((long long)M + ROW_THREADS - 1) / ROW_THREADS);
    stage_row_kernel<MODE, TW><<<blocks, ROW_THREADS, 0, stream>>>(
        x, fr, fi, tr, ti, y, M, n, k, n1);
  } else {
    const dim3 grid((unsigned)(((long long)M + BM - 1) / BM),
                    (k + BN - 1) / BN);
    stage_tile_kernel<MODE, TW><<<grid, THREADS, 0, stream>>>(
        x, fr, fi, tr, ti, y, M, n, k, n1);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* dfft_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// x: (M, n) complex64 (mode 0), (M, n) float32 (mode 1) or (M, n) complex64
//    half spectra (mode 2, n = n_in);
// fr, fi: (n, k) float32 planes of F (modes 0, 1) or CR, CI (mode 2);
// tr, ti: (n1, k) float32 twiddle planes when twiddle != 0 (modes 0, 1);
// y: (M, k) complex64 (modes 0, 1) or (M, k) float32 (mode 2).
int dfft_stage(const float* x, const float* fr, const float* fi,
               const float* tr, const float* ti, float* y, int M, int n,
               int k, int n1, int mode, int twiddle, void* stream) {
  if (M < 1 || n < 1 || k < 1) return cudaErrorInvalidValue;
  if (twiddle && (mode == MODE_C2R || n1 < 1 || !tr || !ti))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode * 2 + (twiddle ? 1 : 0)) {
    case MODE_CMATMUL * 2:
      return launch<MODE_CMATMUL, false>(x, fr, fi, tr, ti, y, M, n, k, n1, s);
    case MODE_CMATMUL * 2 + 1:
      return launch<MODE_CMATMUL, true>(x, fr, fi, tr, ti, y, M, n, k, n1, s);
    case MODE_RMATMUL * 2:
      return launch<MODE_RMATMUL, false>(x, fr, fi, tr, ti, y, M, n, k, n1, s);
    case MODE_RMATMUL * 2 + 1:
      return launch<MODE_RMATMUL, true>(x, fr, fi, tr, ti, y, M, n, k, n1, s);
    case MODE_C2R * 2:
      return launch<MODE_C2R, false>(x, fr, fi, tr, ti, y, M, n, k, n1, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
