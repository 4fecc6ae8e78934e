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
// Each body replaces one Pallas TPU kernel of
// distributedfft_tpu/ops/pallas_fft.py, all reached through _call_stage /
// _c2r_stage:
//
//   fft_rows_kernel<L, ComplexTwiddleRows<false>>
//                            <- _cmatmul_kernel     (kernel 2, FFT body:
//                               power-of-two n in [8, 1024])
//   fft_mixed_kernel<ComplexTwiddleRows<false>>
//                            <- _cmatmul_kernel     (kernel 2, FFT body on
//                               the engine's mixed-radix kernel: 13-smooth
//                               n in [9, 507], e.g. 20, 440, 448, 480)
//   fft_cols_kernel<L, Columns>
//                            <- _cmatmul_kernel     (kernel 2, column body:
//                               the same n along a non-last axis, in place
//                               in the layout)
//   fft_short_kernel<N1>     <- _cmatmul_kernel     (kernel 2, short-stage
//                               body: the n1 = 2..16-point second stage of
//                               a split axis, where the first stage's
//                               output lies, its bins stored in the
//                               four-step's order)
//   MODE_CMATMUL             <- _cmatmul_kernel     (kernel 2, tile or row
//                               body: any other n, e.g. 442, 257, or a
//                               direct axis of a few points)
//   fft_rows_kernel<L, RealRows>
//                            <- _rmatmul_kernel     (kernel 1, FFT body:
//                               power-of-two n in [8, 1024])
//   fft_mixed_kernel<RealRows>
//                            <- _rmatmul_kernel     (kernel 1, FFT body on
//                               the engine's mixed-radix kernel: 13-smooth
//                               n in [9, 507], e.g. 375, 440, 480)
//   MODE_RMATMUL             <- _rmatmul_kernel     (kernel 1, tile or row
//                               body: any other n, e.g. 442 or 520)
//   fft_rows_kernel<L, HalfRows>
//                            <- _c2r_kernel         (kernel 3, FFT body:
//                               power-of-two n in [8, 1024])
//   fft_mixed_kernel<HalfRows>
//                            <- _c2r_kernel         (kernel 3, FFT body on
//                               the engine's mixed-radix kernel: 13-smooth
//                               n in [9, 507], e.g. 375, 440, 480)
//   MODE_C2R                 <- _c2r_kernel         (kernel 3, tile or row
//                               body: any other n, e.g. 442 or 257)
//   fft_rows_kernel<L, PackedHalfRows>
//   fft_mixed_kernel<PackedHalfRows>
//                            <- _c2r_kernel         (kernel 3, packed body:
//                               an even n past the direct lengths whose
//                               half m = n/2 the engine takes, e.g. 2048,
//                               896, 832: the m-point inverse of a packed
//                               spectrum)
//   c2r_pack_kernel          <- _c2r_kernel         (kernel 3, pack pass:
//                               any other even n past them, e.g. 4096,
//                               4320, 1042: the packed spectrum stored in
//                               the four-step's first-stage layout of m,
//                               which kernels 4 and 2 then invert)
//   fft_rows_kernel<L, ComplexTwiddleRows<true>>
//                            <- _cmatmul_tw_kernel  (kernel 4, FFT body:
//                               power-of-two n2 in [8, 1024])
//   fft_mixed_kernel<ComplexTwiddleRows<true>>
//                            <- _cmatmul_tw_kernel  (kernel 4, FFT body on
//                               the engine's mixed-radix kernel: 13-smooth
//                               n2 in [9, 507], e.g. 320, 416, 448, 480)
//   fft_cols_kernel<L, TwiddleColumns>
//                            <- _cmatmul_tw_kernel  (kernel 4, column body:
//                               the same n2 up to 512 on a non-last split
//                               axis, where the axis lies)
//   MODE_CMATMUL + twiddle   <- _cmatmul_tw_kernel  (kernel 4, tile body:
//                               any other n2, e.g. 408 or 206)
//   fft_rows_kernel<L, RealTwiddleRows>
//                            <- _rmatmul_tw_kernel  (kernel 5, FFT body:
//                               power-of-two n2 in [8, 1024])
//   fft_mixed_kernel<RealTwiddleRows>
//                            <- _rmatmul_tw_kernel  (kernel 5, FFT body on
//                               the engine's mixed-radix kernel: 13-smooth
//                               n2 in [9, 507], e.g. 320, 416, 448, 480)
//   MODE_RMATMUL + twiddle   <- _rmatmul_tw_kernel  (kernel 5, tile body:
//                               any other n2, e.g. 408 or 171)
//
// Kernel 3 computes y = Re(c) @ CR - Im(c) @ CI. Its dense body reads a row
// of interleaved complex input as real numbers [re0, im0, re1, im1, ...], so
// the C2R is one real product of depth 2 * n_in whose B operand row 2j is
// CR[j] and row 2j + 1 is -CI[j]: the same tile loop as kernel 1, with a
// real output.
//
// Bound on an H100 SXM (HBM3 3.35 TB/s, float32 outside the tensor cores
// 67 TFLOP/s): bytes each input read once and each output written once
// (the F planes included for the dense bodies); flop the function's work,
// the FFT's nominal 5 n log2 n a complex row (2.5 for real input or output)
// plus 6 a point for a twiddle. Every stage is bound by bytes:
//
//   kernel 1, 512^3 over 2 ranks (M 131072, n 512, k 257):   0.54 GB -> 0.16 ms
//   kernel 2, same plan (M 65792, n = k = 512):              0.54 GB -> 0.16 ms
//   kernel 3, same plan (M 131072, n_in 257, n 512):         0.54 GB -> 0.16 ms
//   kernel 1, 1024^3 z forward (M 1048576, n 1024, k 513):    8.6 GB -> 2.57 ms
//   kernel 3, 1024^3 z inverse (M 1048576, n_in 513, n 1024): 8.6 GB -> 2.57 ms
//   kernel 2, 1024^3 x/y forward (M 525312, n = k = 1024):    8.6 GB -> 2.57 ms
//   kernel 4, 2048 x 256 x 2048 x forward (M 1049600, n = k = 512):
//                                                             8.6 GB -> 2.57 ms
//   kernel 4, same x axis where it lies ((1, 512, 1049600) columns):
//                                                             8.6 GB -> 2.57 ms
//   kernel 2, same x axis, 4-point second stage ((512, 4, 262400) columns,
//     bins stored in the axis's layout):                      8.6 GB -> 2.57 ms
//   kernel 2, same plan, z forward second stage ((524288, 4, 512) columns,
//     bins 0..1024 stored, the crop):                        12.9 GB -> 3.85 ms
//   kernel 2, same plan, z inverse second stage ((524288, 4, 512)):
//                                                            17.2 GB -> 5.13 ms
//   kernel 5, same plan, z forward (M 2097152, n = k = 512): 12.9 GB -> 3.85 ms
//   kernel 3, packed body, same plan, z inverse (M 524288, m 1024 -> n
//     2048; (m + 1) 8 bytes in, 4 n out a row):               8.6 GB -> 2.57 ms
//   kernel 3, pack pass, 64 x 4096^2 y inverse (M 262144, m 2048; (m + 1)
//     8 bytes in, 8 m out a row):                             8.6 GB -> 2.57 ms
//
// The dense bodies do 8 n k flop a complex row, 8 n / (5 log2 n) times an
// FFT's work at k = n, which makes them bound by operations as written.
//
// What the design does about those bounds:
// - Kernels 2 and 4 have an FFT body on the row engine of fft_rows.cuh on
//   complex rows (ComplexTwiddleRows<TW>): each batch of interleaved
//   complex64 rows arrives by one bulk copy, the first pass reads it as it
//   lies, and the epilogue stores interleaved complex64, times the twiddle
//   row T[r % n1] for kernel 4. It reads and writes each byte once and does
//   5 n log2 n flop a row where the dense product did 8 n^2.
// - Kernel 2 also has a column body (fft_rows::Columns): the C2C along
//   axis 1 of an (outer, n, inner) complex64 array, where the TPU kernel
//   could read only contiguous rows and so needed the axis moved last and
//   back, two copies of the tensor. The column kernel reads W = 16 columns
//   of every point-row a batch (128-byte strips; at n = 1024 the split
//   kernel, two 512-point halves) and writes them back in the same layout:
//   each byte moved once, bound by bytes as the row body (8.6 GB -> 2.57 ms
//   at each non-last axis of the 1024^3 spectrum).
// - Kernel 4 also has a column body (TwiddleColumns): on a non-last split
//   axis j = s n1 + r of a contiguous (outer, n, inner) tensor, viewed as
//   (outer, n2, n1 inner), the column kernel's n2-point DFT over s where it
//   lies, its epilogue times T[r][k2], r = column / inner. The TPU kernel
//   read contiguous rows only, so the axis moved last and swapped twice
//   around it (four copies of the tensor).
// - Kernel 2's short-stage body (fft_short_kernel, fft_rows.cuh) runs the
//   four-step's second stage, n1 = 2..16 points, on columns where the first
//   stage left them: strips of n2 elements or more loaded by the column
//   kernel's cp.async ring, the DFT in registers, every bin stored straight
//   to its place in the axis's natural order (or the R2C crop), so neither
//   the swap before it nor the transpose after it exists.
// - Kernels 1 and 5 have an FFT body on the same engine on real rows
//   (RealRowPairs): each batch of real rows arrives by one bulk copy, the
//   first pass packs rows 2c and 2c + 1 as one complex row (an odd last row
//   paired with zeros), and the epilogue splits the spectrum,
//   X_a[k] = (Z[k] + conj Z[n-k]) / 2 and X_b[k] = (Z[k] - conj Z[n-k]) / 2i.
//   Kernel 5 keeps every bin and multiplies by T[r % n1]; kernel 1 keeps
//   bins 0..n/2 (RealRows), whose rows of 8 (n/2 + 1) bytes are written as
//   one contiguous span a batch, not row by row. Each input byte is read
//   once, and 2.5 n log2 n flop a row are done where the dense product did
//   4 n (n/2 + 1). Kernels 1 and 5 run on both of the engine's kernels: on
//   the mixed-radix one (13-smooth n, e.g. kernel 1's 480 and 440 y rows
//   of the batched stacks, kernel 5's 320, 416, 448 and 480 of the 640,
//   832, 896 and 4320 axes) their epilogues walk the batch's bins as one
//   span with DivWalk, two a thread across row ends (an odd n).
// - Kernel 3 has an FFT body on the same engine (HalfRows), the mirror of
//   kernel 1's: each batch of half spectra arrives by one bulk copy, the
//   first pass packs half rows 2c and 2c + 1 as one complex row extended by
//   Hermitian symmetry (fft_rows::hermitian_pair: for an odd n the last
//   bin (n - 1)/2 keeps its imaginary part, there being no Nyquist bin),
//   the engine runs its inverse passes, and the epilogue writes the real
//   and imaginary planes as the two real rows, 16-byte stores over the
//   batch's one contiguous span of rows. It reads each input byte once and
//   does 2.5 n log2 n flop a row where the dense product did 4 n (n/2 +
//   1). It runs on both of the engine's kernels (on the mixed-radix one a
//   buffer holds 16 rows (n/2 + 1) bytes, stage_bytes(g)). At 1024 points
//   it also replaces, on the per-axis path, the Hermitian extension and a
//   complex inverse of twice the bytes.
// - Past the direct lengths an even-n C2R is an m = n/2-point complex
//   inverse: Z[k] = E[k] + i O[k] with E[k] = X[k] + conj X[m - k] and
//   O[k] = (X[k] - conj X[m - k]) e^{+2 pi i k / n} (packed_point; the
//   imaginary parts of bins 0 and m dropped, as the C2R ignores them),
//   whose unnormalized inverse is z[j] = x[2j] + i x[2j + 1]. The complex64
//   (M, m) tensor of z is the float32 (M, n) tensor of x, so the result
//   needs no copy. The TPU kernel had no such route: pallas_fft.irfft
//   extends the spectrum by Hermitian symmetry (a flip, a conj and a cat)
//   and runs a complex n-point inverse, which on the card was the
//   extension, a swap, kernel 4 and the short stage on twice the bins, and
//   a copy of the real part. Two bodies:
//   - PackedHalfRows, where the engine takes m: one launch. Each row's
//     m + 1 bins land by one bulk copy a batch (an even row count a
//     batch, so every batch starts 16-byte aligned; an odd count of bins
//     ends it 8 bytes off 16: bulk_load_tail), the first pass forms Z[i]
//     from bins i and m - i of the landed row and the half-step twiddle
//     table (ops/hopper_fft.half_roots, (2, m) planes read through L1),
//     and ComplexTwiddleRows' epilogue stores the complex row. It reads
//     8 (m + 1) and writes 4 n bytes a row, 5 m log2 m flop.
//   - c2r_pack_kernel, for any other m: one pass from the half spectra to
//     Z, each stored where the four-step's first stage reads it, a[r, s]
//     = Z[s n1 + r] at r n2 + s (n1 = 1: natural order), through a
//     shared-memory tile of ts s by tr <= 32 r (about 2048 points) whose
//     pitch is odd: the reads run along k = s n1 + r and its mirror m - k,
//     the stores along s, both coalesced, the tile's transposed reads free
//     of bank conflicts. It reads 8 (m + 1) and writes 8 m bytes a row;
//     the complex inverse after it is kernels 4 and 2's (or kernel 2's
//     alone for an m that does not split), on half the bins of the
//     extension.
// - Wide dense stages take the tile path of stage_tile.cuh:
//   64 x 64 output tiles, depth 16, 256 threads each holding a 4 x 4
//   complex register tile, as x_c2c_kernel in fused3d.cu does; an operand
//   fetched from shared memory feeds 4 (real) to 16 (complex) FMAs. The
//   twiddle is applied in registers before the store, so a four-step first
//   stage costs no extra pass.
// - Narrow stages (n and k of a few points: a direct axis below 8 points)
//   take the row path: one thread per row, the row held in registers, F in
//   shared memory, so each byte of X and Y crosses HBM once and no lane of
//   a 64-wide tile idles.
// - Ragged edges (k = 257, n_in = 257, any M) are masked element by
//   element; no vector load crosses a row.
// - Offsets are 64-bit: one interleaved plane at 1024^3 holds 2.15e9
//   floats, above INT_MAX.
//
// Every extern "C" entry point returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>

#include "fft_rows.cuh"
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

// Real rows for the FFT engine, two to a complex row: (M, n) float32 in,
// rows 2c and 2c + 1 of a batch packed as complex row c (an odd last row
// paired with zeros). The loader of kernels 5 and 1; each adds its epilogue.
struct RealRowPairs {
  const float* x;
  float* out;
  int M;
  static constexpr int ISSUERS = 1;

  template <int L>
  __host__ __device__ int batches() const {
    constexpr int ROWS2 = 2 * fft_rows::Geometry<L>::ROWS;
    return (M + ROWS2 - 1) / ROWS2;
  }
  template <int L>
  __host__ __device__ static constexpr int stage_bytes() {
    return 8 * fft_rows::Geometry<L>::POINTS;
  }
  // Real rows in batch b.
  template <int L>
  __device__ int rows_in(int b) const {
    constexpr int ROWS2 = 2 * fft_rows::Geometry<L>::ROWS;
    const int left = M - b * ROWS2;
    return left < ROWS2 ? left : ROWS2;
  }
  template <int L>
  __device__ void issue(unsigned char* buf, int b, uint64_t* bar) const {
    using G = fft_rows::Geometry<L>;
    const uint32_t bytes = 4u * rows_in<L>(b) * G::N;
    fft_rows::mbar_expect_tx(bar, bytes);
    fft_rows::bulk_load(buf, x + (size_t)b * 2 * G::POINTS, bytes, bar);
  }
  // Point i of complex row c: real rows 2c and 2c + 1 (zero past the end).
  template <int L>
  __device__ float2 load(const unsigned char* buf, int b, int c,
                         int i) const {
    using G = fft_rows::Geometry<L>;
    const float* p = reinterpret_cast<const float*>(buf) + 2 * c * G::N + i;
    return make_float2(p[0], 2 * c + 1 < rows_in<L>(b) ? p[G::N] : 0.f);
  }
  // Bin k of real row q of the batch, from the spectrum Z of complex row
  // q / 2: X_a[k] = (Z[k] + conj Z[n-k]) / 2 for even q, X_b[k] = (Z[k] -
  // conj Z[n-k]) / 2i for odd q.
  __device__ static float2 split(int n, const float* re, const float* im,
                                 int q, int k) {
    const int z = (q >> 1) * n;
    const int i = fft_rows::pad(z + k);
    const int i2 = fft_rows::pad(z + (k ? n - k : 0));
    const float zr = re[i], zi = im[i], nr = re[i2], ni = im[i2];
    return (q & 1) ? make_float2(0.5f * (zi + ni), 0.5f * (nr - zr))
                   : make_float2(0.5f * (zr + nr), 0.5f * (zi - ni));
  }
  template <int L>
  __device__ static float2 split(const float* re, const float* im, int q,
                                 int k) {
    return split(fft_rows::Geometry<L>::N, re, im, q, k);
  }

  // The same on the mixed-radix kernel (2 g.rows real rows a batch, n =
  // g.n): a batch's rows_in n floats from 8 g.points b bytes on (16-byte
  // aligned, g.points being even), by one bulk copy and, where an odd n
  // and rows_in end it off 16 bytes, the issuing thread's loads of its
  // last 4 to 12 bytes.
  __host__ __device__ long long batches(const fft_rows::MixedPlan& g) const {
    const int r2 = 2 * g.rows;
    return ((long long)M + r2 - 1) / r2;
  }
  __host__ __device__ static int stage_bytes(const fft_rows::MixedPlan& g) {
    return 8 * g.points;
  }
  __device__ int rows_in(const fft_rows::MixedPlan& g, int b) const {
    const int r2 = 2 * g.rows, left = M - b * r2;
    return left < r2 ? left : r2;
  }
  __device__ void issue(const fft_rows::MixedPlan& g, unsigned char* buf,
                        int b, uint64_t* bar) const {
    fft_rows::bulk_load_tail(buf, x + (size_t)b * 2 * g.points,
                             4u * rows_in(g, b) * g.n, bar);
  }
  __device__ float2 load(const fft_rows::MixedPlan& g,
                         const unsigned char* buf, int b, int c,
                         int i) const {
    const float* p = reinterpret_cast<const float*>(buf) + 2 * c * g.n + i;
    return make_float2(p[0], 2 * c + 1 < rows_in(g, b) ? p[g.n] : 0.f);
  }
};

// Kernel 5's rows: (M, n) interleaved complex64 out, the full spectrum of
// each row times the four-step twiddle row T[r % n1] ((n1, n) float32
// planes).
struct RealTwiddleRows : RealRowPairs {
  const float* tr;
  const float* ti;
  int n1;

  template <int L>
  __device__ void store(const float* re, const float* im, int b) const {
    using G = fft_rows::Geometry<L>;
    constexpr int N = G::N;
    const int count = rows_in<L>(b) * N;
    const int row0 = b * 2 * G::ROWS;
    float4* o = reinterpret_cast<float4*>(out + (size_t)b * G::POINTS * 4);
    for (int e = 2 * threadIdx.x; e < count; e += 2 * fft_rows::THREADS) {
      const int q = e >> L, k = e & (N - 1);
      const size_t t = (size_t)((row0 + q) % n1) * N + k;
      float v[4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float2 s = split<L>(re, im, q, k + h);
        const float wr = __ldg(tr + t + h), wi = __ldg(ti + t + h);
        v[2 * h] = s.x * wr - s.y * wi;
        v[2 * h + 1] = s.x * wi + s.y * wr;
      }
      o[e / 2] = make_float4(v[0], v[1], v[2], v[3]);
    }
  }

  // The same on the mixed-radix kernel: the batch's rows_in n bins from 16
  // g.points b bytes on, two neighbouring bins a thread, of one row or
  // across two (an odd n), as one 16-byte store; an odd last bin as 8
  // bytes. Bin e of the span is bin k of real row q, (q, k) = divmod(e,
  // n), walked with DivWalk, and its twiddle row (row0 + q) mod n1 with
  // it, as ComplexTwiddleRows<true>'s store does.
  __device__ void store(const fft_rows::MixedPlan& g, const float* re,
                        const float* im, int b) const {
    const int n = g.n, count = rows_in(g, b) * n, row0 = b * 2 * g.rows;
    float* o = out + (size_t)b * g.points * 4;
    fft_rows::DivWalk w(2 * threadIdx.x, n, 2 * fft_rows::THREADS);
    int rq = (row0 + w.q) % n1;
    const int dq1 = w.dq % n1;
    for (int e = 2 * threadIdx.x; e < count; e += 2 * fft_rows::THREADS) {
      float v[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (h == 1 && e + 1 == count) break;
        const bool next_row = w.r + h == n;  // an odd n's pair
        const int q = w.q + next_row, k = next_row ? 0 : w.r + h;
        const int row = !next_row ? rq : rq + 1 < n1 ? rq + 1 : 0;
        const float2 s = split(n, re, im, q, k);
        const size_t t = (size_t)row * n + k;
        const float wr = __ldg(tr + t), wi = __ldg(ti + t);
        v[2 * h] = s.x * wr - s.y * wi;
        v[2 * h + 1] = s.x * wi + s.y * wr;
      }
      if (e + 1 < count)
        reinterpret_cast<float4*>(o)[e / 2] = make_float4(v[0], v[1], v[2],
                                                          v[3]);
      else
        reinterpret_cast<float2*>(o)[e] = make_float2(v[0], v[1]);
      const int q0 = w.q;
      w.next();
      rq += dq1 + (w.q - q0 - w.dq);  // dq or dq + 1 rows on
      if (rq >= n1) rq -= n1;
    }
  }
};

// Kernel 1's rows: (M, n/2 + 1) interleaved complex64 out, bins 0..n/2 of
// each row's spectrum. A row is 8 (n/2 + 1) bytes, not a multiple of 16, so
// the epilogue walks the batch's output as one contiguous span of
// rows_in * (n/2 + 1) bins (16 ROWS (n/2 + 1) bytes a full batch, so every
// batch starts 16-byte aligned): thread by thread two neighbouring bins, of
// one row or across a row boundary, as one coalesced 16-byte store, and a
// last odd bin as 8 bytes.
struct RealRows : RealRowPairs {
  template <int L>
  __device__ void store(const float* re, const float* im, int b) const {
    using G = fft_rows::Geometry<L>;
    constexpr int K = G::N / 2 + 1;  // bins a row
    const int count = rows_in<L>(b) * K;
    float2* o = reinterpret_cast<float2*>(out) + (size_t)b * 2 * G::ROWS * K;
    for (int e = 2 * threadIdx.x; e < count; e += 2 * fft_rows::THREADS) {
      const int q = e / K, k = e - q * K;  // K a compile-time constant
      const float2 v = split<L>(re, im, q, k);
      if (e + 1 < count) {
        const float2 w = k + 1 < K ? split<L>(re, im, q, k + 1)
                                   : split<L>(re, im, q + 1, 0);
        reinterpret_cast<float4*>(o)[e / 2] = make_float4(v.x, v.y, w.x, w.y);
      } else {
        o[e] = v;
      }
    }
  }

  // The same on the mixed-radix kernel (n = g.n any engine length, K = n/2
  // + 1 bins a row, 2 g.rows real rows a batch): a full batch is 16 g.rows
  // K bytes, a multiple of 16, so every batch starts 16-byte aligned. Its
  // rows_in K bins are one span, two neighbouring bins a thread, of one row
  // or across two, as one 16-byte store, an odd last bin as 8 bytes. Bin e
  // of the span is bin k of real row q, (q, k) = divmod(e, K), walked with
  // DivWalk (as RealTwiddleRows' mixed store walks n); split holds for an
  // odd n.
  __device__ void store(const fft_rows::MixedPlan& g, const float* re,
                        const float* im, int b) const {
    const int n = g.n, K = n / 2 + 1, count = rows_in(g, b) * K;
    float2* o = reinterpret_cast<float2*>(out) + (size_t)b * 2 * g.rows * K;
    fft_rows::DivWalk w(2 * threadIdx.x, K, 2 * fft_rows::THREADS);
    for (int e = 2 * threadIdx.x; e < count;
         e += 2 * fft_rows::THREADS, w.next()) {
      const float2 v = split(n, re, im, w.q, w.r);
      if (e + 1 < count) {
        const float2 u = w.r + 1 < K ? split(n, re, im, w.q, w.r + 1)
                                     : split(n, re, im, w.q + 1, 0);
        reinterpret_cast<float4*>(o)[e / 2] = make_float4(v.x, v.y, u.x, u.y);
      } else {
        o[e] = v;
      }
    }
  }
};

// Kernel 3's rows: (M, n/2 + 1) complex64 half spectra in, the
// unnormalized C2R of each row out as (M, n) float32 (fft_rows::
// RealPairsOut): half rows 2c and 2c + 1 of a batch become complex row c
// (an odd last row paired with zeros). Rows of 8 (n/2 + 1) bytes have no
// 16-byte pitch, but a full batch, 16 ROWS (n/2 + 1) bytes, does: every
// batch starts 16-byte aligned and arrives by one bulk copy. A last batch
// of an odd row count is 8 bytes off a multiple of 16: its copy stops 8
// bytes short, so nothing past the tensor's end is read, and the issuing
// thread reads that last bin from global memory into the buffer itself
// before its arrive on the barrier, which releases the store to the
// threads that wait on it.
struct HalfRows : fft_rows::RealPairsOut {
  const float* x;
  static constexpr int ISSUERS = 1;

  template <int L>
  __host__ __device__ static constexpr int stage_bytes() {
    using G = fft_rows::Geometry<L>;
    return 16 * G::ROWS * (G::N / 2 + 1);
  }
  template <int L>
  __device__ void issue(unsigned char* buf, int b, uint64_t* bar) const {
    using G = fft_rows::Geometry<L>;
    const int count = rows_in<L>(b) * (G::N / 2 + 1);  // bins
    const float2* src =
        reinterpret_cast<const float2*>(x) + (size_t)b * G::ROWS * (G::N + 2);
    if (count & 1)
      reinterpret_cast<float2*>(buf)[count - 1] = __ldg(src + count - 1);
    const uint32_t bytes = 8u * (count & ~1);
    fft_rows::mbar_expect_tx(bar, bytes);
    fft_rows::bulk_load(buf, src, bytes, bar);
  }
  template <int L>
  __device__ float2 load(const unsigned char* buf, int b, int c,
                         int i) const {
    constexpr int N = fft_rows::Geometry<L>::N, K = N / 2 + 1;
    const int k = i <= N / 2 ? i : N - i;
    const float2* p = reinterpret_cast<const float2*>(buf) + 2 * c * K + k;
    const float2 v = 2 * c + 1 < rows_in<L>(b) ? p[K] : make_float2(0.f, 0.f);
    return fft_rows::hermitian_pair<L>(p[0], v, i);
  }

  // The same on the mixed-radix kernel (n = g.n any length, K = n/2 + 1
  // bins a half row, 2 g.rows half rows a batch): a full batch is 16 g.rows
  // K bytes, a multiple of 16, so every batch starts 16-byte aligned; its
  // bins come by one bulk copy and, for an odd count, the issuing thread's
  // load of the last one (bulk_load_tail), as above.
  __host__ __device__ static int stage_bytes(const fft_rows::MixedPlan& g) {
    return 16 * g.rows * (g.n / 2 + 1);
  }
  __device__ void issue(const fft_rows::MixedPlan& g, unsigned char* buf,
                        int b, uint64_t* bar) const {
    const int K = g.n / 2 + 1;
    fft_rows::bulk_load_tail(
        buf, reinterpret_cast<const float2*>(x) + (size_t)b * 2 * g.rows * K,
        8u * rows_in(g, b) * K, bar);
  }
  __device__ float2 load(const fft_rows::MixedPlan& g,
                         const unsigned char* buf, int b, int c,
                         int i) const {
    const int n = g.n, K = n / 2 + 1;
    const int k = 2 * i <= n ? i : n - i;
    const float2* p = reinterpret_cast<const float2*>(buf) + 2 * c * K + k;
    const float2 v =
        2 * c + 1 < rows_in(g, b) ? p[K] : make_float2(0.f, 0.f);
    return fft_rows::hermitian_pair(n, p[0], v, i);
  }
};

// Point i of the packed spectrum Z of one half row x of m + 1 bins (n =
// 2m): E + i O, E = x[i] + conj x[m - i], O = (x[i] - conj x[m - i]) w_i,
// w_i = e^{+2 pi i i / n} from the (2, m) planes tw. Bins 0 and m count
// their real parts only.
__device__ __forceinline__ float2 packed_point(const float2* x, int m, int i,
                                               const float* tw) {
  float2 a = x[i], b = x[m - i];
  if (i == 0) {
    a.y = 0.f;
    b.y = 0.f;
  }
  const float2 e = make_float2(a.x + b.x, a.y - b.y);
  const float2 o = fft_rows::cmul(make_float2(a.x - b.x, a.y + b.y),
                                  make_float2(__ldg(tw + i), __ldg(tw + m + i)));
  return make_float2(e.x - o.y, e.y + o.x);
}

// Kernel 3's packed body: (M, m + 1) complex64 half spectra of real rows of
// n = 2m in, the m-point inverse of each row's packed spectrum out as (M,
// m) complex64 in natural order (ComplexTwiddleRows' rows and epilogue, no
// twiddle), which is the (M, n) float32 C2R. A batch is ROWS (or g.rows,
// even) half rows of m + 1 bins, 8 ROWS (m + 1) bytes from 8 b ROWS (m + 1)
// on: 16-byte aligned, by one bulk copy, and where an odd row count ends
// the last batch 8 bytes off 16, the issuing thread's load of the last bin
// (bulk_load_tail).
struct PackedHalfRows : fft_rows::ComplexTwiddleRows<false> {
  const float* tw;  // (2, m) float32: e^{+2 pi i k / n}

  template <int L>
  __host__ __device__ static constexpr int stage_bytes() {
    using G = fft_rows::Geometry<L>;
    return 8 * G::ROWS * (G::N + 1);
  }
  template <int L>
  __device__ void issue(unsigned char* buf, int b, uint64_t* bar) const {
    using G = fft_rows::Geometry<L>;
    constexpr int K = G::N + 1;
    fft_rows::bulk_load_tail(
        buf, reinterpret_cast<const float2*>(x) + (size_t)b * G::ROWS * K,
        8u * rows_in<L>(b) * K, bar);
  }
  template <int L>
  __device__ float2 load(const unsigned char* buf, int, int row,
                         int i) const {
    constexpr int N = fft_rows::Geometry<L>::N;
    return packed_point(reinterpret_cast<const float2*>(buf) + row * (N + 1),
                        N, i, tw);
  }

  // The same on the mixed-radix kernel (n = g.n = m, g.rows even).
  __host__ __device__ static int stage_bytes(const fft_rows::MixedPlan& g) {
    return 8 * g.rows * (g.n + 1);
  }
  __device__ void issue(const fft_rows::MixedPlan& g, unsigned char* buf,
                        int b, uint64_t* bar) const {
    const int K = g.n + 1;
    fft_rows::bulk_load_tail(
        buf, reinterpret_cast<const float2*>(x) + (size_t)b * g.rows * K,
        8u * rows_in(g, b) * K, bar);
  }
  __device__ float2 load(const fft_rows::MixedPlan& g,
                         const unsigned char* buf, int, int row,
                         int i) const {
    return packed_point(
        reinterpret_cast<const float2*>(buf) + row * (g.n + 1), g.n, i, tw);
  }
};

// Kernel 3's pack pass. A tile is ts values of s by tr of r of one row
// (tiles_s by tiles_r tiles a row); its points Z[s n1 + r] are formed
// along k (neighbouring threads on neighbouring r, then s: contiguous runs
// of the row and of its mirror), kept at [s - s0][r - r0] of a shared tile
// of odd pitch, and stored along s, r n2 + s of the row's output.
struct PackTiles {
  int m, n1, n2;
  int tr, ts, pitch;  // r and s a tile, floats2 a tile row (odd)
  int tiles_r, tiles_s;
};

constexpr int PACK_THREADS = 256;
constexpr int PACK_POINTS = 2048;  // about this many points a tile

PackTiles pack_tiles(int m, int n1) {
  PackTiles p;
  p.m = m;
  p.n1 = n1;
  p.n2 = m / n1;
  p.tr = n1 < 32 ? n1 : 32;
  p.tiles_r = (n1 + p.tr - 1) / p.tr;
  const long long pts = (long long)p.n2 * p.tr;
  p.tiles_s = (int)((pts + PACK_POINTS - 1) / PACK_POINTS);
  p.ts = (p.n2 + p.tiles_s - 1) / p.tiles_s;
  p.pitch = p.tr | 1;
  return p;
}

__global__ void __launch_bounds__(PACK_THREADS)
c2r_pack_kernel(const float2* __restrict__ c, const float* __restrict__ tw,
                float2* __restrict__ out, long long tiles, PackTiles p) {
  extern __shared__ float2 tile[];
  const int per_row = p.tiles_r * p.tiles_s;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long row = t / per_row;
    const int rest = (int)(t - row * per_row);
    const int s0 = (rest % p.tiles_s) * p.ts, r0 = (rest / p.tiles_s) * p.tr;
    const int ns = p.n2 - s0 < p.ts ? p.n2 - s0 : p.ts;
    const int nr = p.n1 - r0 < p.tr ? p.n1 - r0 : p.tr;
    const float2* x = c + row * (p.m + 1);
    fft_rows::DivWalk w(threadIdx.x, nr, PACK_THREADS);  // (s - s0, r - r0)
    for (int e = threadIdx.x; e < ns * nr; e += PACK_THREADS, w.next())
      tile[w.q * p.pitch + w.r] =
          packed_point(x, p.m, (s0 + w.q) * p.n1 + r0 + w.r, tw);
    __syncthreads();
    float2* y = out + row * p.m;
    fft_rows::DivWalk v(threadIdx.x, ns, PACK_THREADS);  // (r - r0, s - s0)
    for (int e = threadIdx.x; e < ns * nr; e += PACK_THREADS, v.next())
      y[(r0 + v.q) * p.n2 + s0 + v.r] = tile[v.r * p.pitch + v.q];
    __syncthreads();
  }
}

// Kernel 4's columns: the column kernel's n-point DFT of every column of an
// (outer, n, inner) complex64 array (fft_rows::Columns, interleaved in and
// out), times the four-step twiddle in the epilogue: work row k2 (bin k2)
// of column c by T[c / span][k2] ((n1, n) float32 planes). On a non-last
// split axis j = s n1 + r viewed as (outer, n2, n1 span), column c = r span
// + b takes twiddle row r.
struct TwiddleColumns : fft_rows::Columns {
  const float* tr;
  const float* ti;
  int span;

  template <int L>
  __device__ void store(const float2* w, int b) const {
    using G = fft_rows::ColGeometry<L>;
    const int g = groups<L>(), o = b / g, c0 = (b - o * g) * G::W;
    const int valid = inner - c0 < G::W ? inner - c0 : G::W;
    float* dst = out_r + 2 * ((size_t)o * n * inner + c0);
    const size_t pitch = 2 * (size_t)inner;  // floats
    // Bin i of column c0 + c times its twiddle.
    auto twiddled = [&](float2 v, int i, int c) {
      const size_t t = (size_t)((c0 + c) / span) * G::N + i;
      return fft_rows::cmul(v, make_float2(__ldg(tr + t), __ldg(ti + t)));
    };
    const unsigned a = static_cast<unsigned>(
        reinterpret_cast<uintptr_t>(dst) | 4 * pitch | 8 * valid);
    if (!(a & 15)) {
      fft_rows::for_parts(G::N, valid / 2, [&](int i, int k) {
        const float4 p = reinterpret_cast<const float4*>(w)[(i * G::W) / 2 + k];
        const float2 u = twiddled(make_float2(p.x, p.y), i, 2 * k);
        const float2 v = twiddled(make_float2(p.z, p.w), i, 2 * k + 1);
        *reinterpret_cast<float4*>(dst + i * pitch + 4 * k) =
            make_float4(u.x, u.y, v.x, v.y);
      });
    } else {
      fft_rows::for_parts(G::N, valid, [&](int i, int k) {
        *reinterpret_cast<float2*>(dst + i * pitch + 2 * k) =
            twiddled(w[i * G::W + k], i, k);
      });
    }
  }
};

// The column kernel on columns of n points, a power of two in [8, 512]
// (no split kernel: its halves store through Columns' own epilogue).
template <class Body>
cudaError_t launch_cols_direct(int n, int schedule, const Body& body,
                               const float* table, int inverse,
                               cudaStream_t s) {
  using fft_rows::launch_cols_log2;
  switch (n) {
    case 8: return launch_cols_log2<3>(schedule, body, table, inverse, s);
    case 16: return launch_cols_log2<4>(schedule, body, table, inverse, s);
    case 32: return launch_cols_log2<5>(schedule, body, table, inverse, s);
    case 64: return launch_cols_log2<6>(schedule, body, table, inverse, s);
    case 128: return launch_cols_log2<7>(schedule, body, table, inverse, s);
    case 256: return launch_cols_log2<8>(schedule, body, table, inverse, s);
    case 512: return launch_cols_log2<9>(schedule, body, table, inverse, s);
    default: return cudaErrorInvalidValue;
  }
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

// Kernel 5, FFT body. x: (M, n) float32, n a power of two in [8, 1024]
// (the engine's power-of-two kernel) or 13-smooth in [8, 512] (its
// mixed-radix kernel), 16-byte aligned; table: ops/hopper_fft.fft_plan(n,
// False).table; schedule: ops/hopper_fft._engine_schedule(n, False); tr,
// ti: (n1, n) float32 twiddle planes; out: (M, n) complex64.
int dfft_rdft_tw(const float* x, const float* table, const float* tr,
                 const float* ti, float* out, int M, int n, int n1,
                 int schedule, void* stream) {
  if (M < 1 || n1 < 1 || !tr || !ti) return cudaErrorInvalidValue;
  if (fft_rows::misaligned(x) || fft_rows::misaligned(out))
    return cudaErrorMisalignedAddress;
  const RealTwiddleRows body{{x, out, M}, tr, ti, n1};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (n & (n - 1)) == 0
             ? fft_rows::launch(n, schedule, body, table, 0, st)
             : fft_rows::launch_mixed(n, schedule, body, table, 0, st);
}

// Kernel 4, FFT body. x: (M, n) complex64, n a power of two in [8, 1024]
// (the engine's power-of-two kernel) or 13-smooth in [8, 512] (its
// mixed-radix kernel), 16-byte aligned; table, schedule:
// ops/hopper_fft.fft_plan(n, inverse); tr, ti: (n1, n) float32 twiddle
// planes; out: (M, n) complex64.
int dfft_cdft_tw(const float* x, const float* table, const float* tr,
                 const float* ti, float* out, int M, int n, int n1,
                 int schedule, int inverse, void* stream) {
  if (M < 1 || n1 < 1 || !tr || !ti) return cudaErrorInvalidValue;
  if (fft_rows::misaligned(x) || fft_rows::misaligned(out))
    return cudaErrorMisalignedAddress;
  const fft_rows::ComplexTwiddleRows<true> body{x, tr, ti, out, M, n1};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (n & (n - 1)) == 0
             ? fft_rows::launch(n, schedule, body, table, inverse, st)
             : fft_rows::launch_mixed(n, schedule, body, table, inverse, st);
}

// Kernel 2, FFT body. x: (M, n) complex64, n a power of two in [8, 1024]
// (the engine's power-of-two kernel) or 13-smooth in [8, 512] (its
// mixed-radix kernel), 16-byte aligned; table: ops/hopper_fft.fft_plan(n,
// inverse).table; schedule: its .schedule for a power of two, else
// ops/hopper_fft.mixed_schedule(n, inverse); out: (M, n) complex64,
// 16-byte aligned.
int dfft_cdft(const float* x, const float* table, float* out, int M, int n,
              int schedule, int inverse, void* stream) {
  if (M < 1) return cudaErrorInvalidValue;
  if (fft_rows::misaligned(x) || fft_rows::misaligned(out))
    return cudaErrorMisalignedAddress;
  const fft_rows::ComplexTwiddleRows<false> body{x, nullptr, nullptr, out, M,
                                                 1};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (n & (n - 1)) == 0
             ? fft_rows::launch(n, schedule, body, table, inverse, st)
             : fft_rows::launch_mixed(n, schedule, body, table, inverse, st);
}

// Kernel 2, column body: the n-point C2C (inverse when inverse != 0) along
// axis 1 of an (outer, n, inner) complex64 array x, into out of the same
// layout; n a power of two in [8, 1024]; table, schedule, split:
// ops/hopper_fft.cols_plan(n, inverse) (split null below 1024). No
// alignment beyond complex64's.
int dfft_cdft_cols(const float* x, const float* table, const float* split,
                   float* out, int outer, int n, int inner, int schedule,
                   int inverse, void* stream) {
  if (outer < 1 || inner < 1) return cudaErrorInvalidValue;
  const fft_rows::Columns body{x, nullptr, out, nullptr, outer, n, inner};
  return fft_rows::launch_cols(n, schedule, body, table, split, inverse,
                               static_cast<cudaStream_t>(stream));
}

// Kernel 4, column body: the n-point DFT (inverse when inverse != 0) along
// axis 1 of an (outer, n, inner) complex64 array x, times the twiddle
// T[c / (inner / n1)][k2] of column c, bin k2, into out of the same layout
// (not overlapping x); n a power of two in [8, 512], n1 dividing inner;
// table, schedule: ops/hopper_fft.fft_plan(n, inverse); tr, ti: (n1, n)
// float32 twiddle planes. x and out 8-byte aligned.
int dfft_cdft_tw_cols(const float* x, const float* table, const float* tr,
                      const float* ti, float* out, int outer, int n,
                      int inner, int n1, int schedule, int inverse,
                      void* stream) {
  if (outer < 1 || inner < 1 || n1 < 1 || inner % n1 || !tr || !ti)
    return cudaErrorInvalidValue;
  if (fft_rows::misaligned(x, 8) || fft_rows::misaligned(out, 8))
    return cudaErrorMisalignedAddress;
  const TwiddleColumns body{{x, nullptr, out, nullptr, outer, n, inner},
                            tr, ti, inner / n1};
  return launch_cols_direct(n, schedule, body, table, inverse,
                            static_cast<cudaStream_t>(stream));
}

// Kernel 2, short-stage body: the n1-point DFT (inverse when inverse != 0),
// 2 <= n1 <= 16, along axis 1 of an (outer, n1, inner) complex64 array x;
// bin k1 of column c of outer index q stored to out at (q / group) s1 + (q
// % group) s2 + k1 row + c (complex64 elements) when k1 row + c < limit;
// outer a multiple of group; roots: ops/hopper_fft.short_roots(n1,
// inverse). x and out 8-byte aligned, not overlapping.
int dfft_cdft_short(const float* x, const float* roots, float* out,
                    int outer, int n1, int inner, int group, int inverse,
                    long long s1, long long s2, long long row,
                    long long limit, void* stream) {
  if (outer < 1 || inner < 1 || n1 < 2 || n1 > fft_rows::SHORT_MAX ||
      group < 1 || outer % group || s1 < 0 || s2 < 0 || row < 1 ||
      limit < 1 || !roots)
    return cudaErrorInvalidValue;
  if (fft_rows::misaligned(x, 8) || fft_rows::misaligned(out, 8))
    return cudaErrorMisalignedAddress;
  const fft_rows::ShortColumns body{x,  out, outer, n1, inner, group, s1,
                                    s2, row, limit, 0,  0,     0};
  return fft_rows::launch_short(body, roots, inverse,
                                static_cast<cudaStream_t>(stream));
}

// Kernel 1, FFT body. x: (M, n) float32, n a power of two in [8, 1024]
// (the engine's power-of-two kernel) or 13-smooth in [8, 512] (its
// mixed-radix kernel), 16-byte aligned; table: ops/hopper_fft.fft_plan(n,
// False).table; schedule: ops/hopper_fft._engine_schedule(n, False); out:
// (M, n/2 + 1) complex64, 16-byte aligned.
int dfft_rdft(const float* x, const float* table, float* out, int M, int n,
              int schedule, void* stream) {
  if (M < 1) return cudaErrorInvalidValue;
  if (fft_rows::misaligned(x) || fft_rows::misaligned(out))
    return cudaErrorMisalignedAddress;
  const RealRows body{{x, out, M}};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (n & (n - 1)) == 0
             ? fft_rows::launch(n, schedule, body, table, 0, st)
             : fft_rows::launch_mixed(n, schedule, body, table, 0, st);
}

// Kernel 3, packed body. c: (M, m + 1) complex64 half spectra of real rows
// of n = 2m, m a power of two in [8, 1024] (the engine's power-of-two
// kernel) or 13-smooth in [9, 507] (its mixed-radix kernel, an even row
// count a batch), 16-byte aligned; table: ops/hopper_fft.fft_plan(m,
// True).table; tw: ops/hopper_fft.half_roots(n), (2, m) float32; schedule:
// ops/hopper_fft._engine_schedule(m, True, packed=True); out: (M, m)
// complex64, the (M, n) float32 C2R, 16-byte aligned.
int dfft_c2r_packed(const float* c, const float* table, const float* tw,
                    float* out, int M, int m, int schedule, void* stream) {
  if (M < 1 || !tw) return cudaErrorInvalidValue;
  if (fft_rows::misaligned(c) || fft_rows::misaligned(out))
    return cudaErrorMisalignedAddress;
  const bool pow2 = (m & (m - 1)) == 0;
  if (!pow2 && ((schedule >> fft_rows::MIXED_ROWS_SHIFT) & 1))
    return cudaErrorInvalidValue;  // an odd row count a batch
  const PackedHalfRows body{{c, nullptr, nullptr, out, M, 1}, tw};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return pow2 ? fft_rows::launch(m, schedule, body, table, 1, st)
              : fft_rows::launch_mixed(m, schedule, body, table, 1, st);
}

// Kernel 3, pack pass. c: (M, m + 1) complex64 half spectra of real rows of
// n = 2m; tw: ops/hopper_fft.half_roots(n), (2, m) float32; out: (M, m)
// complex64, the packed spectrum Z of each row with Z[s n1 + r] at r n2 +
// s (n2 = m / n1; n1 = 1: natural order). c and out 8-byte aligned.
int dfft_c2r_pack(const float* c, const float* tw, float* out, int M, int m,
                  int n1, void* stream) {
  if (M < 1 || m < 1 || n1 < 1 || m % n1 || !tw) return cudaErrorInvalidValue;
  if (fft_rows::misaligned(c, 8) || fft_rows::misaligned(out, 8))
    return cudaErrorMisalignedAddress;
  const PackTiles p = pack_tiles(m, n1);
  const long long tiles = (long long)M * p.tiles_r * p.tiles_s;
  return fft_rows::launch_persistent(
      c2r_pack_kernel, PACK_THREADS, (size_t)8 * p.ts * p.pitch, tiles,
      static_cast<cudaStream_t>(stream), reinterpret_cast<const float2*>(c),
      tw, reinterpret_cast<float2*>(out), tiles, p);
}

// Kernel 3, FFT body. c: (M, n/2 + 1) complex64, n a power of two in [8,
// 1024] (the engine's power-of-two kernel) or 13-smooth in [8, 512] (its
// mixed-radix kernel), 16-byte aligned; table: ops/hopper_fft.fft_plan(n,
// True).table; schedule: ops/hopper_fft._engine_schedule(n, True, half=
// True); out: (M, n) float32, 16-byte aligned.
int dfft_c2r(const float* c, const float* table, float* out, int M, int n,
             int schedule, void* stream) {
  if (M < 1) return cudaErrorInvalidValue;
  if (fft_rows::misaligned(c) || fft_rows::misaligned(out))
    return cudaErrorMisalignedAddress;
  const HalfRows body{{out, M}, c};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (n & (n - 1)) == 0
             ? fft_rows::launch(n, schedule, body, table, 1, st)
             : fft_rows::launch_mixed(n, schedule, body, table, 1, st);
}

}  // extern "C"
