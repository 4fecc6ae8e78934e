// Fused single-device 3D FFT kernels for Hopper (sm_90a), plain C interface.
//
// Complex data between the kernels travels as split float32 (real, imag)
// planes, as in the JAX package's Pallas kernels; kernel 7's FFT body also
// reads or writes the interleaved complex64 spectrum. The dense bodies
// compute every DFT as a matrix product with the DFT matrices built on the
// host (ops/mxu_fft.py), in float32 FFMA on the CUDA cores through
// shared-memory tiles; the FFT bodies run the row FFT engine of
// fft_rows.cuh.
//
// Three kernels, each replacing one Pallas TPU kernel of
// distributedfft_tpu/ops/pallas_fft.py:
//
//   zy_fwd_kernel  <- _zy_fwd_kernel  (z-R2C, then y-C2C, per x-row; the
//                                      dense body, for a Y or Z that is no
//                                      13-smooth length in [8, 512], or an
//                                      odd Y)
//   fft_rows_kernel<L, ZRows>, fft_rows_kernel<L, ComplexTwiddleRows<false>>
//   then zy_planes_kernel
//                  <- _zy_fwd_kernel  (the FFT body: three launches; Y and
//                                      Z powers of two)
//   fft_mixed_kernel<ZRows>, fft_mixed_kernel<ComplexTwiddleRows<false>>
//   then zy_planes_kernel
//                  <- _zy_fwd_kernel  (the FFT body on the engine's
//                                      mixed-radix kernel: Y and Z
//                                      13-smooth in [8, 512], Y even, not
//                                      both powers of two)
//   fft_cols_kernel<L, Columns>
//                  <- _x_c2c_kernel   (C2C along x, both directions; the FFT
//                                      body, X a power of two in [8, 512])
//   fft_mixed_cols_kernel<Columns>
//                  <- _x_c2c_kernel   (the FFT body on the engine's
//                                      mixed-radix column kernel: X
//                                      13-smooth in [9, 507], not a power
//                                      of two)
//   x_c2c_kernel   <- _x_c2c_kernel   (the dense body, an X with a prime
//                                      factor past 13, or X < 8)
//   yz_inv_kernel  <- _yz_inv_kernel  (y-C2C inverse, then half-spectrum C2R;
//                                      the dense body, for a Y or Z that is
//                                      no 13-smooth length in [8, 512], or
//                                      an odd Y)
//   yz_scratch_kernel, fft_rows_kernel<L, ComplexTwiddleRows<false>>
//   then fft_rows_kernel<L, YZRows>
//                  <- _yz_inv_kernel  (the FFT body: three launches; Y and
//                                      Z powers of two)
//   yz_scratch_kernel, fft_mixed_kernel<ComplexTwiddleRows<false>>
//   then fft_mixed_kernel<YZRows>
//                  <- _yz_inv_kernel  (the FFT body on the engine's
//                                      mixed-radix kernel: Y and Z
//                                      13-smooth in [8, 512], Y even, not
//                                      both powers of two)
//
// Bound on an H100 SXM at X = Y = Z = 512 (Zo = 257), float32 outside the
// tensor cores (67 TFLOP/s) and 3.35 TB/s of HBM:
//
//   zy_fwd  4.14e11 FLOP -> 6.2 ms;  1.08 GB -> 0.32 ms   (operations bound)
//   x_c2c   2.76e11 FLOP -> 4.1 ms;  1.08 GB -> 0.32 ms   (operations bound)
//   yz_inv  4.14e11 FLOP -> 6.2 ms;  1.08 GB -> 0.32 ms   (operations bound)
//
// (the dense bodies' counts). A DFT done as a dense product is about 20x
// the arithmetic of an FFT, so all three are bound by operations, not
// bytes. What the dense designs do about it: each keeps its inter-stage
// intermediate in shared memory (one HBM read of the input, one HBM write
// of the output), and each thread holds a register tile of 16 to 32
// complex sums so that an operand fetched from shared memory feeds 4 to 16
// FMAs. The DFT matrices are re-read per block from L2.
//
// zy_fwd's FFT body (Y and Z powers of two in [8, 512], or 13-smooth
// there with Y even: the engine's mixed-radix kernel on both passes) does
// no dense product: it runs the row FFT engine of fft_rows.cuh twice and a
// transpose. Its bound at 512^3 is the function's bytes, one read of x and
// one write of the two planes, 1.08 GB -> 0.32 ms. One fused pass does
// not fit: an FFT needs whole rows and whole columns, and one x-plane's
// half spectrum (512 x 257 x 8 B = 1.05 MB) does not fit in 227 KB of
// shared memory. What sets the pace instead is how the planes are
// written: their rows are Zo = 257 floats, so a pass whose blocks each
// hold a few zo-columns (a y-FFT batch of the engine holds 4 at Y = 512)
// writes 16-byte strips of rows 1028 bytes apart, which on the H100 costs
// several times a write of whole rows. So no pass writes such strips:
//
// - Pass A (ZRows): the z-R2C of every (x, y) row, two real rows packed as
//   one complex row exactly as kernel 5's body in stage.cu does, the
//   spectrum split in the epilogue and k in [0, Z/2] kept, no twiddle,
//   into a complex64 scratch laid out (X, Zo, Y): column zo of plane x is
//   one contiguous row. A batch holds consecutive y, so the epilogue
//   writes aligned 64-byte pieces (8 y at Z = 512), whole sectors.
// - Pass B (ComplexTwiddleRows<false>): the y-C2C of each scratch row, in
//   place: contiguous rows in, contiguous rows out.
// - Pass C (zy_planes_kernel): the transpose into the two (X, Y, Zo)
//   planes through shared memory, 8 whole plane rows per block, read as
//   aligned 64-byte pieces of 8 y and written as contiguous runs.
//
// The three passes move three times the function's bytes (3.2 GB at
// 512^3), so their ceiling is about a third of the bound (~0.97 ms).
//
// yz_inv's FFT body (Y and Z powers of two in [8, 512], or 13-smooth there
// with Y even: the engine's mixed-radix kernel on both FFT passes) runs
// kernel 6's passes backwards, through the same (X, Zo, Y) complex64
// scratch, with the same bound (1.08 GB -> 0.32 ms at 512^3) and the same
// ceiling:
//
// - Pass 1 (yz_scratch_kernel): the two (X, Y, Zo) planes transposed into
//   the scratch through shared memory, 8 whole plane rows per block, read
//   as contiguous runs and written as aligned 64-byte pieces of 8 y.
// - Pass 2 (ComplexTwiddleRows<false>, the inverse table): the y-C2C
//   inverse of each scratch row, in place.
// - Pass 3 (YZRows): the z-C2R of every (x, y) row, kernel 3's C2R Body
//   (fft_rows::hermitian_pair, fft_rows::RealPairsOut) with a loader that
//   gathers a batch's half rows from the scratch, for each zo one aligned
//   piece of consecutive y (64 bytes at Z = 512), copied in 16-byte parts
//   by every thread with cp.async; the epilogue writes whole (X, Y, Z)
//   rows. On the mixed-radix kernel a batch's pairs of rows may cross
//   x-planes anywhere: each pair's bin is one 16-byte part, gathered the
//   same way (YZRows' mixed overloads).
//
// x_c2c's FFT body (X a power of two in [8, 512], or 13-smooth there: the
// engine's mixed-radix column kernel) is the column kernel of fft_rows.cuh
// (fft_rows::Columns): the (X, Ky, Zo) data is one (1, X, Ky * Zo) array of
// columns, W = 16 columns a batch at X = 512 and at every X past 256,
// every point-row of a batch a 64-byte strip of each float plane or a
// 128-byte strip of complex64. It reads the planes kernel 6 writes and
// writes the complex64 spectrum straight away (the forward), or reads the
// spectrum and writes the planes kernel 8 reads (the inverse), so neither
// direction spends a pass on interleaving or splitting. The dense product
// did 8 X flop a point, about 11x an FFT's 5 log2 X at X = 512; this body
// does the FFT's and moves each byte once: bound by bytes, 1.08 GB -> 0.32
// ms at 512^3.
//
// Every extern "C" entry point returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>

#include "fft_rows.cuh"

namespace {

constexpr int AXIS_MAX = 512;  // largest axis of the fused path

// ---------------------------------------------------------------------------
// zy_fwd: out[b, ky, zo] = sum_y Fy[ky, y] * (sum_z x[b, y, z] * Fz[z, zo])
//
// The y stage contracts only y, so zo-columns are independent: a block owns
// (x-row b, a tile of ZY_TZ zo-columns). Stage 1 computes c = x_b @ Fz[:, tile]
// (Y x ZY_TZ complex) into shared memory, stage 2 writes Fy @ c for the tile.
// Thread t owns rows t and t + 256 of both stages. Fy is symmetric, so the
// stage-2 tile Fy[:, y0:y0+ZY_KY] is read as rows y0.. of Fy (coalesced).
// ---------------------------------------------------------------------------

constexpr int ZY_THREADS = 256;
constexpr int ZY_RPT = AXIS_MAX / ZY_THREADS;  // rows per thread
constexpr int ZY_TZ = 16;                      // zo-columns per block
constexpr int ZY_KZ = 16;                      // z depth of a stage-1 tile
constexpr int ZY_KY = 8;                       // y depth of a stage-2 tile
static_assert(ZY_KZ * ZY_TZ == ZY_THREADS, "one Fz tile element per thread");

__host__ __device__ inline int round_up(int a, int m) { return (a + m - 1) / m * m; }

__host__ __device__ inline int zy_xs_floats(int Y) {
  return (ZY_KZ * (Y + 1) + 3) & ~3;  // 16-byte aligned end
}

size_t zy_smem_bytes(int Y) {
  const int Yp = round_up(Y, ZY_KY);
  const int s1 = zy_xs_floats(Y) + 2 * ZY_KZ * ZY_TZ;
  const int s2 = 2 * ZY_KY * Y;
  return sizeof(float) * (2 * Yp * ZY_TZ + (s1 > s2 ? s1 : s2));
}

__global__ void __launch_bounds__(ZY_THREADS, 2)
zy_fwd_kernel(const float* __restrict__ x, const float* __restrict__ fzr,
              const float* __restrict__ fzi, const float* __restrict__ fyr,
              const float* __restrict__ fyi, float* __restrict__ yr,
              float* __restrict__ yi, int Y, int Z) {
  extern __shared__ __align__(16) float smem[];
  const int Zo = Z / 2 + 1;
  const int Yp = round_up(Y, ZY_KY);
  float* cs_r = smem;               // [Yp][ZY_TZ]
  float* cs_i = cs_r + Yp * ZY_TZ;  // [Yp][ZY_TZ]
  float* stage = cs_i + Yp * ZY_TZ;
  // stage-1 view of the staging area
  const int xs_ld = Y + 1;
  float* xs = stage;                        // [ZY_KZ][Y + 1], x tile transposed
  float* fz_r = stage + zy_xs_floats(Y);    // [ZY_KZ][ZY_TZ]
  float* fz_i = fz_r + ZY_KZ * ZY_TZ;
  // stage-2 view of the staging area
  float* fy_r = stage;                      // [ZY_KY][Y]
  float* fy_i = stage + ZY_KY * Y;

  const int tid = threadIdx.x;
  const int j0 = blockIdx.x * ZY_TZ;
  const int b = blockIdx.y;
  const float* xb = x + (size_t)b * Y * Z;

  // Rows past Y read a valid row and are never stored.
  int row[ZY_RPT];
#pragma unroll
  for (int i = 0; i < ZY_RPT; ++i) row[i] = min(tid + i * ZY_THREADS, Y - 1);

  float acc_r[ZY_RPT][ZY_TZ], acc_i[ZY_RPT][ZY_TZ];
#pragma unroll
  for (int i = 0; i < ZY_RPT; ++i)
#pragma unroll
    for (int j = 0; j < ZY_TZ; ++j) acc_r[i][j] = acc_i[i][j] = 0.f;

  // Stage 1: c[y, j] = sum_z x[b, y, z] * Fz[z, j0 + j]   (real x complex)
  for (int z0 = 0; z0 < Z; z0 += ZY_KZ) {
    for (int e = tid; e < Y * ZY_KZ; e += ZY_THREADS) {
      const int y = e / ZY_KZ, k = e % ZY_KZ, z = z0 + k;
      xs[k * xs_ld + y] = z < Z ? xb[(size_t)y * Z + z] : 0.f;
    }
    {
      const int k = tid / ZY_TZ, j = tid % ZY_TZ, z = z0 + k, col = j0 + j;
      const bool ok = z < Z && col < Zo;
      fz_r[tid] = ok ? fzr[(size_t)z * Zo + col] : 0.f;
      fz_i[tid] = ok ? fzi[(size_t)z * Zo + col] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < ZY_KZ; ++k) {
      float a[ZY_RPT];
#pragma unroll
      for (int i = 0; i < ZY_RPT; ++i) a[i] = xs[k * xs_ld + row[i]];
      const float4* fr4 = reinterpret_cast<const float4*>(fz_r + k * ZY_TZ);
      const float4* fi4 = reinterpret_cast<const float4*>(fz_i + k * ZY_TZ);
#pragma unroll
      for (int q = 0; q < ZY_TZ / 4; ++q) {
        const float4 r = fr4[q], m = fi4[q];
        const float rv[4] = {r.x, r.y, r.z, r.w}, mv[4] = {m.x, m.y, m.z, m.w};
#pragma unroll
        for (int i = 0; i < ZY_RPT; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            acc_r[i][4 * q + c] = fmaf(a[i], rv[c], acc_r[i][4 * q + c]);
            acc_i[i][4 * q + c] = fmaf(a[i], mv[c], acc_i[i][4 * q + c]);
          }
      }
    }
    __syncthreads();
  }

  // c to shared memory; rows Y..Yp-1 are zero so stage 2 needs no mask.
#pragma unroll
  for (int i = 0; i < ZY_RPT; ++i) {
    const int r = tid + i * ZY_THREADS;
    if (r < Yp) {
      const bool v = r < Y;
#pragma unroll
      for (int j = 0; j < ZY_TZ; ++j) {
        cs_r[r * ZY_TZ + j] = v ? acc_r[i][j] : 0.f;
        cs_i[r * ZY_TZ + j] = v ? acc_i[i][j] : 0.f;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < ZY_RPT; ++i)
#pragma unroll
    for (int j = 0; j < ZY_TZ; ++j) acc_r[i][j] = acc_i[i][j] = 0.f;

  // Stage 2: out[ky, j] = sum_y Fy[ky, y] * c[y, j]   (complex x complex)
  for (int y0 = 0; y0 < Yp; y0 += ZY_KY) {
    for (int e = tid; e < ZY_KY * Y; e += ZY_THREADS) {
      const int k = e / Y, col = e % Y, y = y0 + k;
      const bool ok = y < Y;
      fy_r[e] = ok ? fyr[(size_t)y * Y + col] : 0.f;  // Fy[col, y] = Fy[y, col]
      fy_i[e] = ok ? fyi[(size_t)y * Y + col] : 0.f;
    }
    __syncthreads();
#pragma unroll 2
    for (int k = 0; k < ZY_KY; ++k) {
      float fr[ZY_RPT], fi[ZY_RPT];
#pragma unroll
      for (int i = 0; i < ZY_RPT; ++i) {
        fr[i] = fy_r[k * Y + row[i]];
        fi[i] = fy_i[k * Y + row[i]];
      }
      const float4* cr4 = reinterpret_cast<const float4*>(cs_r + (y0 + k) * ZY_TZ);
      const float4* ci4 = reinterpret_cast<const float4*>(cs_i + (y0 + k) * ZY_TZ);
#pragma unroll
      for (int q = 0; q < ZY_TZ / 4; ++q) {
        const float4 r = cr4[q], m = ci4[q];
        const float rv[4] = {r.x, r.y, r.z, r.w}, mv[4] = {m.x, m.y, m.z, m.w};
#pragma unroll
        for (int i = 0; i < ZY_RPT; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            float& o_r = acc_r[i][4 * q + c];
            float& o_i = acc_i[i][4 * q + c];
            o_r = fmaf(fr[i], rv[c], o_r);
            o_r = fmaf(-fi[i], mv[c], o_r);
            o_i = fmaf(fr[i], mv[c], o_i);
            o_i = fmaf(fi[i], rv[c], o_i);
          }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < ZY_RPT; ++i) {
    const int r = tid + i * ZY_THREADS;
    if (r < Y) {
      const size_t base = ((size_t)b * Y + r) * Zo + j0;
#pragma unroll
      for (int j = 0; j < ZY_TZ; ++j)
        if (j0 + j < Zo) {
          yr[base + j] = acc_r[i][j];
          yi[base + j] = acc_i[i][j];
        }
    }
  }
}

// ---------------------------------------------------------------------------
// x_c2c: out[m, n] = sum_k F[m, k] * a[k, n], F square (M x M) and symmetric.
//
// (y, zo) is contiguous, so the x transform of an (X, Ky, Zo) array is one
// complex GEMM of F (X x X) with A viewed as (X, Ky*Zo). Conventional tiling:
// 64 x 64 output tiles, depth 16, 256 threads each holding a 4 x 4 complex
// register tile; As is loaded as rows of F (symmetric), so both operand loads
// are coalesced and both shared-memory reads are 16-byte vectors.
// ---------------------------------------------------------------------------

constexpr int XC_BM = 64, XC_BN = 64, XC_BK = 16, XC_THREADS = 256;

__global__ void __launch_bounds__(XC_THREADS)
x_c2c_kernel(const float* __restrict__ ar, const float* __restrict__ ai,
             const float* __restrict__ fr, const float* __restrict__ fi,
             float* __restrict__ zr, float* __restrict__ zi, int M, int N) {
  __shared__ __align__(16) float As_r[XC_BK][XC_BM];
  __shared__ __align__(16) float As_i[XC_BK][XC_BM];
  __shared__ __align__(16) float Bs_r[XC_BK][XC_BN];
  __shared__ __align__(16) float Bs_i[XC_BK][XC_BN];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * XC_BM, n0 = blockIdx.x * XC_BN;

  float acc_r[4][4], acc_i[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc_r[i][j] = acc_i[i][j] = 0.f;

  for (int k0 = 0; k0 < M; k0 += XC_BK) {
#pragma unroll
    for (int l = 0; l < (XC_BK * XC_BM) / XC_THREADS; ++l) {
      const int e = tid + l * XC_THREADS;
      const int k = e / XC_BM, c = e % XC_BM, kk = k0 + k;
      const int m = m0 + c, n = n0 + c;
      const bool oka = kk < M && m < M, okb = kk < M && n < N;
      As_r[k][c] = oka ? fr[(size_t)kk * M + m] : 0.f;  // F[m, kk] = F[kk, m]
      As_i[k][c] = oka ? fi[(size_t)kk * M + m] : 0.f;
      Bs_r[k][c] = okb ? ar[(size_t)kk * N + n] : 0.f;
      Bs_i[k][c] = okb ? ai[(size_t)kk * N + n] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < XC_BK; ++k) {
      const float4 a4r = *reinterpret_cast<const float4*>(&As_r[k][ty * 4]);
      const float4 a4i = *reinterpret_cast<const float4*>(&As_i[k][ty * 4]);
      const float4 b4r = *reinterpret_cast<const float4*>(&Bs_r[k][tx * 4]);
      const float4 b4i = *reinterpret_cast<const float4*>(&Bs_i[k][tx * 4]);
      const float a_r[4] = {a4r.x, a4r.y, a4r.z, a4r.w};
      const float a_i[4] = {a4i.x, a4i.y, a4i.z, a4i.w};
      const float b_r[4] = {b4r.x, b4r.y, b4r.z, b4r.w};
      const float b_i[4] = {b4i.x, b4i.y, b4i.z, b4i.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc_r[i][j] = fmaf(a_r[i], b_r[j], acc_r[i][j]);
          acc_r[i][j] = fmaf(-a_i[i], b_i[j], acc_r[i][j]);
          acc_i[i][j] = fmaf(a_r[i], b_i[j], acc_i[i][j]);
          acc_i[i][j] = fmaf(a_i[i], b_r[j], acc_i[i][j]);
        }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < N) {
        zr[(size_t)m * N + n] = acc_r[i][j];
        zi[(size_t)m * N + n] = acc_i[i][j];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// yz_inv: out[b, y, z] = sum_n Er[y, n] CR[n, z] - Ei[y, n] CI[n, z],
//         E = FyInv @ in_b                       (in_b: Y x Zo complex)
//
// The z stage contracts zo, so y-rows are independent: a block owns (x-row b,
// a tile of YZ_TY y-rows). Stage 1 computes E for those rows into shared
// memory (YZ_TY x Zo complex), thread t owning zo-column t for all YZ_TY rows;
// stage 2 writes the rows' C2R, thread t owning z-columns 2t and 2t+1. The
// block has 32 * ceil(Zo / 32) threads, so both stages take one pass.
// ---------------------------------------------------------------------------

constexpr int YZ_TY = 16;   // y-rows per block
constexpr int YZ_KY = 16;   // y depth of a stage-1 tile
constexpr int YZ_MAX_THREADS = 32 * ((AXIS_MAX / 2 + 1 + 31) / 32);  // 288

int yz_threads(int Zo) { return 32 * ((Zo + 31) / 32); }

size_t yz_smem_bytes(int Zo) {
  return sizeof(float) * (2 * Zo * YZ_TY + 2 * YZ_KY * YZ_TY);
}

__global__ void __launch_bounds__(YZ_MAX_THREADS, 2)
yz_inv_kernel(const float* __restrict__ er, const float* __restrict__ ei,
              const float* __restrict__ fyr, const float* __restrict__ fyi,
              const float* __restrict__ cr, const float* __restrict__ ci,
              float* __restrict__ out, int Y, int Z) {
  extern __shared__ __align__(16) float smem[];
  const int Zo = Z / 2 + 1;
  float* es_r = smem;                 // [Zo][YZ_TY]
  float* es_i = es_r + Zo * YZ_TY;
  float* ft_r = es_i + Zo * YZ_TY;    // [YZ_KY][YZ_TY]: FyInv[r0 + r, y0 + k]
  float* ft_i = ft_r + YZ_KY * YZ_TY;

  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int r0 = blockIdx.x * YZ_TY;
  const int b = blockIdx.y;
  const float* erb = er + (size_t)b * Y * Zo;
  const float* eib = ei + (size_t)b * Y * Zo;

  // Stage 1: E[r, n] = sum_y FyInv[r0 + r, y] * in[y, n]
  const int n = tid;
  const int nc = min(n, Zo - 1);  // columns past Zo are computed, not stored
  float acc_r[YZ_TY], acc_i[YZ_TY];
#pragma unroll
  for (int r = 0; r < YZ_TY; ++r) acc_r[r] = acc_i[r] = 0.f;

  for (int y0 = 0; y0 < Y; y0 += YZ_KY) {
    for (int e = tid; e < YZ_KY * YZ_TY; e += nthreads) {
      const int k = e / YZ_TY, r = e % YZ_TY, y = y0 + k, rr = r0 + r;
      const bool ok = y < Y && rr < Y;
      ft_r[e] = ok ? fyr[(size_t)y * Y + rr] : 0.f;  // FyInv symmetric
      ft_i[e] = ok ? fyi[(size_t)y * Y + rr] : 0.f;
    }
    float b_r[YZ_KY], b_i[YZ_KY];
#pragma unroll
    for (int k = 0; k < YZ_KY; ++k) {
      const int y = y0 + k;
      b_r[k] = y < Y ? erb[(size_t)y * Zo + nc] : 0.f;
      b_i[k] = y < Y ? eib[(size_t)y * Zo + nc] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < YZ_KY; ++k) {
      const float4* f4r = reinterpret_cast<const float4*>(ft_r + k * YZ_TY);
      const float4* f4i = reinterpret_cast<const float4*>(ft_i + k * YZ_TY);
#pragma unroll
      for (int q = 0; q < YZ_TY / 4; ++q) {
        const float4 r = f4r[q], m = f4i[q];
        const float rv[4] = {r.x, r.y, r.z, r.w}, mv[4] = {m.x, m.y, m.z, m.w};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float& o_r = acc_r[4 * q + c];
          float& o_i = acc_i[4 * q + c];
          o_r = fmaf(rv[c], b_r[k], o_r);
          o_r = fmaf(-mv[c], b_i[k], o_r);
          o_i = fmaf(rv[c], b_i[k], o_i);
          o_i = fmaf(mv[c], b_r[k], o_i);
        }
      }
    }
    __syncthreads();
  }
  if (n < Zo) {
    float4* dr = reinterpret_cast<float4*>(es_r + n * YZ_TY);
    float4* di = reinterpret_cast<float4*>(es_i + n * YZ_TY);
#pragma unroll
    for (int q = 0; q < YZ_TY / 4; ++q) {
      dr[q] = make_float4(acc_r[4 * q], acc_r[4 * q + 1], acc_r[4 * q + 2],
                          acc_r[4 * q + 3]);
      di[q] = make_float4(acc_i[4 * q], acc_i[4 * q + 1], acc_i[4 * q + 2],
                          acc_i[4 * q + 3]);
    }
  }
  __syncthreads();

  // Stage 2: out[r0 + r, z] = sum_n Er[r, n] CR[n, z] - Ei[r, n] CI[n, z]
  const int z0 = 2 * tid;
  if (z0 >= Z) return;
  const bool has1 = z0 + 1 < Z;
  const int z1 = has1 ? z0 + 1 : z0;
  float o0[YZ_TY], o1[YZ_TY];
#pragma unroll
  for (int r = 0; r < YZ_TY; ++r) o0[r] = o1[r] = 0.f;
#pragma unroll 2
  for (int k = 0; k < Zo; ++k) {
    const float c0r = cr[(size_t)k * Z + z0], c0i = ci[(size_t)k * Z + z0];
    const float c1r = cr[(size_t)k * Z + z1], c1i = ci[(size_t)k * Z + z1];
    const float4* e4r = reinterpret_cast<const float4*>(es_r + k * YZ_TY);
    const float4* e4i = reinterpret_cast<const float4*>(es_i + k * YZ_TY);
#pragma unroll
    for (int q = 0; q < YZ_TY / 4; ++q) {
      const float4 r = e4r[q], m = e4i[q];
      const float rv[4] = {r.x, r.y, r.z, r.w}, mv[4] = {m.x, m.y, m.z, m.w};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        o0[4 * q + c] = fmaf(rv[c], c0r, o0[4 * q + c]);
        o0[4 * q + c] = fmaf(-mv[c], c0i, o0[4 * q + c]);
        o1[4 * q + c] = fmaf(rv[c], c1r, o1[4 * q + c]);
        o1[4 * q + c] = fmaf(-mv[c], c1i, o1[4 * q + c]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < YZ_TY; ++r) {
    const int rr = r0 + r;
    if (rr < Y) {
      const size_t base = ((size_t)b * Y + rr) * Z;
      out[base + z0] = o0[r];
      if (has1) out[base + z0 + 1] = o1[r];
    }
  }
}

// ---------------------------------------------------------------------------
// zy_fwd, FFT body: pass A (ZRows), pass B (the engine on the scratch's
// rows) and pass C (zy_planes_kernel)
// ---------------------------------------------------------------------------

// Pass A: (X * Y, Z) float32 rows in, two to a complex row; the half
// spectrum of each row out into the (X, Zo, Y) complex64 scratch.
struct ZRows {
  const float* x;
  float* s;
  int M;     // X * Y real rows (even: Y is)
  int ylog;  // log2 Y (the power-of-two kernel)
  int Y;     // (the mixed-radix kernel)
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
  // Point i of complex row c: real rows 2c and 2c + 1 (M is even, so a
  // batch never ends inside a pair).
  template <int L>
  __device__ float2 load(const unsigned char* buf, int, int c, int i) const {
    const float* p =
        reinterpret_cast<const float*>(buf) + 2 * c * fft_rows::Geometry<L>::N;
    return make_float2(p[i], p[fft_rows::Geometry<L>::N + i]);
  }
  // Thread e writes bin k = e / ROWS of complex row c = e mod ROWS, that is
  // real rows 2c and 2c + 1: neighbouring y, one 16-byte vector; the
  // batch's vectors of one k are consecutive in the scratch.
  template <int L>
  __device__ void store(const float* re, const float* im, int b) const {
    using G = fft_rows::Geometry<L>;
    constexpr int N = G::N, ROWS = G::ROWS, ZO = N / 2 + 1;
    const int pairs = rows_in<L>(b) / 2;
    const int ymask = (1 << ylog) - 1;
    float4* o = reinterpret_cast<float4*>(s);
    for (int e = threadIdx.x; e < ZO * ROWS; e += fft_rows::THREADS) {
      const int c = e & (ROWS - 1), k = e / ROWS;
      if (c >= pairs) continue;
      const int i = fft_rows::pad(c * N + k);
      const int i2 = fft_rows::pad(c * N + ((N - k) & (N - 1)));
      const float zr = re[i], zi = im[i], nr = re[i2], ni = im[i2];
      // X_a = (Z[k] + conj Z[n-k]) / 2, X_b = (Z[k] - conj Z[n-k]) / 2i.
      const float4 v = make_float4(0.5f * (zr + nr), 0.5f * (zi - ni),
                                   0.5f * (zi + ni), 0.5f * (nr - zr));
      const int r = b * 2 * ROWS + 2 * c;  // even: r + 1 is the next y
      o[(((size_t)(r >> ylog) * ZO + k) << (ylog - 1)) + ((r & ymask) >> 1)] =
          v;
    }
  }

  // The same on the mixed-radix kernel (2 g.rows real rows a batch, Z =
  // g.n, Y even, neither a power of two as such).
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
                         const unsigned char* buf, int, int c, int i) const {
    const float* p = reinterpret_cast<const float*>(buf) + 2 * c * g.n;
    return make_float2(p[i], p[g.n + i]);
  }
  __device__ void store(const fft_rows::MixedPlan& g, const float* re,
                        const float* im, int b) const {
    const int n = g.n, rows = g.rows, zo = n / 2 + 1;
    const int pairs = rows_in(g, b) / 2;
    float4* o = reinterpret_cast<float4*>(s);
    // The batch's first real row r0 = (x0, y0): a pair 2c on is (x0, y0 +
    // 2c) while that stays below Y, so the division runs only across a
    // plane's end.
    const int r0 = b * 2 * rows, x0 = r0 / Y, y0 = r0 - x0 * Y;
    fft_rows::DivWalk w(threadIdx.x, rows, fft_rows::THREADS);  // (k, c)
    for (int e = threadIdx.x; e < zo * rows;
         e += fft_rows::THREADS, w.next()) {
      const int k = w.q, c = w.r;
      if (c >= pairs) continue;
      const int i = fft_rows::pad(c * n + k);
      const int i2 = fft_rows::pad(c * n + (k ? n - k : 0));
      const float zr = re[i], zi = im[i], nr = re[i2], ni = im[i2];
      const float4 v = make_float4(0.5f * (zr + nr), 0.5f * (zi - ni),
                                   0.5f * (zi + ni), 0.5f * (nr - zr));
      int xq = x0, y = y0 + 2 * c;  // even: y + 1 is the next y
      if (y >= Y) {
        const int planes = y / Y;
        xq += planes;
        y -= planes * Y;
      }
      o[(((size_t)xq * zo + k) * Y + y) / 2] = v;
    }
  }
};

// Pass C: the (X, Zo, Y) complex64 scratch, transposed into the two
// (X, Y, Zo) float32 planes. Block (ky-tile, x) stages PLANE_ROWS rows of
// both planes in shared memory (the last tile of a Y that is not a
// multiple of 8 fewer: Y is even, so 2, 4 or 6); LD makes the staging
// writes of 4 threads a zo (one 64-byte piece of 8 y) land in 32 distinct
// banks.
constexpr int PLANE_ROWS = 8;
constexpr int PLANE_THREADS = 256;
constexpr int PLANE_LD = AXIS_MAX / 2 + 4;  // >= Zo, = 4 (mod 16)

// The R rows of a tile: row (x, zo) of the scratch holds Y / 2 vectors of
// two y, R / 2 of them the tile's; then the tile's rows of each plane, one
// contiguous run from o.
template <int R>
__device__ __forceinline__ void planes_tile(const float4* __restrict__ src,
                                            float* __restrict__ yr,
                                            float* __restrict__ yi, float* tr,
                                            float* ti, size_t o, int Y,
                                            int Zo) {
  for (int e = threadIdx.x; e < Zo * R / 2; e += PLANE_THREADS) {
    const int zo = e / (R / 2), h = e % (R / 2);
    const float4 v = src[(size_t)zo * (Y / 2) + h];
    tr[2 * h * PLANE_LD + zo] = v.x;
    ti[2 * h * PLANE_LD + zo] = v.y;
    tr[(2 * h + 1) * PLANE_LD + zo] = v.z;
    ti[(2 * h + 1) * PLANE_LD + zo] = v.w;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < R * Zo; e += PLANE_THREADS) {
    const int r = e / Zo, zo = e - r * Zo;
    yr[o + e] = tr[r * PLANE_LD + zo];
    yi[o + e] = ti[r * PLANE_LD + zo];
  }
}

__global__ void __launch_bounds__(PLANE_THREADS)
zy_planes_kernel(const float4* __restrict__ s, float* __restrict__ yr,
                 float* __restrict__ yi, int Y, int Zo) {
  __shared__ float tr[PLANE_ROWS * PLANE_LD];
  __shared__ float ti[PLANE_ROWS * PLANE_LD];
  const int ky0 = blockIdx.x * PLANE_ROWS;
  const size_t x = blockIdx.y;
  const float4* src = s + (x * Zo * Y + ky0) / 2;
  const size_t o = (x * Y + ky0) * Zo;
  switch (Y - ky0 < PLANE_ROWS ? Y - ky0 : PLANE_ROWS) {
    case 8: planes_tile<8>(src, yr, yi, tr, ti, o, Y, Zo); break;
    case 6: planes_tile<6>(src, yr, yi, tr, ti, o, Y, Zo); break;
    case 4: planes_tile<4>(src, yr, yi, tr, ti, o, Y, Zo); break;
    default: planes_tile<2>(src, yr, yi, tr, ti, o, Y, Zo); break;
  }
}

// ---------------------------------------------------------------------------
// yz_inv, FFT body: pass 1 (yz_scratch_kernel), pass 2 (the engine on the
// scratch's rows, inverse) and pass 3 (YZRows)
// ---------------------------------------------------------------------------

// Pass 1: zy_planes_kernel backwards. Block (y-tile, x) stages PLANE_ROWS
// rows of both planes (one contiguous run each; the last tile of a Y that
// is not a multiple of 8 fewer: Y is even, so 2, 4 or 6) in shared memory,
// then writes, for each zo, the tile's rows as one aligned piece of the
// scratch row (x, zo), 64 bytes for a whole tile; the staging reads of 4
// threads a zo land in 32 distinct banks.
template <int R>
__device__ __forceinline__ void scratch_tile(const float* __restrict__ er,
                                             const float* __restrict__ ei,
                                             float4* __restrict__ dst,
                                             float* tr, float* ti, size_t o,
                                             int Y, int Zo) {
  for (int e = threadIdx.x; e < R * Zo; e += PLANE_THREADS) {
    const int r = e / Zo, zo = e - r * Zo;
    tr[r * PLANE_LD + zo] = er[o + e];
    ti[r * PLANE_LD + zo] = ei[o + e];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < Zo * R / 2; e += PLANE_THREADS) {
    const int zo = e / (R / 2), h = e % (R / 2);
    dst[(size_t)zo * (Y / 2) + h] =
        make_float4(tr[2 * h * PLANE_LD + zo], ti[2 * h * PLANE_LD + zo],
                    tr[(2 * h + 1) * PLANE_LD + zo],
                    ti[(2 * h + 1) * PLANE_LD + zo]);
  }
}

__global__ void __launch_bounds__(PLANE_THREADS)
yz_scratch_kernel(const float* __restrict__ er, const float* __restrict__ ei,
                  float4* __restrict__ s, int Y, int Zo) {
  __shared__ float tr[PLANE_ROWS * PLANE_LD];
  __shared__ float ti[PLANE_ROWS * PLANE_LD];
  const int y0 = blockIdx.x * PLANE_ROWS;
  const size_t x = blockIdx.y;
  const size_t o = (x * Y + y0) * Zo;
  float4* dst = s + (x * Zo * Y + y0) / 2;
  switch (Y - y0 < PLANE_ROWS ? Y - y0 : PLANE_ROWS) {
    case 8: scratch_tile<8>(er, ei, dst, tr, ti, o, Y, Zo); break;
    case 6: scratch_tile<6>(er, ei, dst, tr, ti, o, Y, Zo); break;
    case 4: scratch_tile<4>(er, ei, dst, tr, ti, o, Y, Zo); break;
    default: scratch_tile<2>(er, ei, dst, tr, ti, o, Y, Zo); break;
  }
}

__host__ __device__ constexpr int ilog2(int n) {
  return n > 1 ? 1 + ilog2(n / 2) : 0;
}

// Pass 3: the z-C2R of the X * Y rows (x, y), their half spectra gathered
// from pass 2's (X, Zo, Y) scratch, (X, Y, Z) float32 out. A batch's 2 ROWS
// consecutive rows take, for every zo, W = min(2 ROWS, Y) consecutive y of
// each of its P = rows / W planes: P Zo aligned pieces of 8 W bytes (64 at
// Z = 512) from rows 8 Y bytes apart. One bulk copy a piece, 257 a batch
// at Z = 512, set this pass's pace (PERF.md section 6), and so did plain
// loads in the first pass (half of each sector used, no prefetch). Instead
// every thread copies a share of the pieces' 16-byte parts with cp.async
// (a warp's 32 parts are 8 whole 64-byte pieces, every sector used) and
// arrives on the buffer's barrier when its own have landed. Piece
// (p, zo) lands in slot p Zo + zo, 8 W + 16 bytes apart: the padding puts
// the first pass's 16-byte reads of neighbouring zo on distinct banks. Row
// counts are multiples of W (>= 8), so rows pair up.
struct YZRows : fft_rows::RealPairsOut {
  const float* s;
  int ylog;  // log2 Y (the power-of-two kernel)
  int Y;     // (the mixed-radix kernel)
  static constexpr int ISSUERS = fft_rows::THREADS;

  // log2 W.
  template <int L>
  __device__ int wlog() const {
    constexpr int R = ilog2(2 * fft_rows::Geometry<L>::ROWS);
    return ylog < R ? ylog : R;
  }
  // At most 2 ROWS / 8 planes a batch: P (8 W + 16) <= 20 ROWS bytes a zo.
  template <int L>
  __host__ __device__ static constexpr int stage_bytes() {
    using G = fft_rows::Geometry<L>;
    return 20 * G::ROWS * (G::N / 2 + 1);
  }
  template <int L>
  __device__ void issue(unsigned char* buf, int b, uint64_t* bar) const {
    using G = fft_rows::Geometry<L>;
    constexpr int ZO = G::N / 2 + 1;
    const int wl = wlog<L>(), rows = rows_in<L>(b);
    const int r0 = b * 2 * G::ROWS;
    const size_t x0 = r0 >> ylog;
    const int y0 = r0 & ((1 << ylog) - 1), slot = (8 << wl) + 16;
    // Part e: 16 bytes (two y) j of piece q = (p, zo), W / 2 parts a piece.
    for (int e = threadIdx.x; e < rows / 2 * ZO; e += fft_rows::THREADS) {
      const int q = e >> (wl - 1), j = e & ((1 << (wl - 1)) - 1);
      const int p = q / ZO, k = q - p * ZO;
      const float* src = s + 2 * ((((x0 + p) * ZO + k) << ylog) + y0 + 2 * j);
      fft_rows::copy16_async(buf + q * slot + 16 * j, src);
    }
    fft_rows::arrive_when_copied(bar);
  }
  // Point i of complex row c: bin k of rows 2c and 2c + 1, two neighbouring
  // y of one piece, as one 16-byte read.
  template <int L>
  __device__ float2 load(const unsigned char* buf, int, int c, int i) const {
    constexpr int N = fft_rows::Geometry<L>::N, ZO = N / 2 + 1;
    const int k = i <= N / 2 ? i : N - i;
    const int wl = wlog<L>(), q = 2 * c;
    const int slot = (8 << wl) + 16, p = q >> wl, w = q & ((1 << wl) - 1);
    const float4 v =
        *reinterpret_cast<const float4*>(buf + (p * ZO + k) * slot + 8 * w);
    return fft_rows::hermitian_pair<L>(make_float2(v.x, v.y),
                                       make_float2(v.z, v.w), i);
  }

  // The same on the mixed-radix kernel (Z = g.n any engine length up to
  // 512, Zo = Z / 2 + 1, Y even; 2 g.rows real rows a batch, the rows of
  // mixed_schedule(Z, True, half=True)). Y need not be a multiple of 2
  // g.rows, so a batch's rows may cross x-planes anywhere; but a batch
  // starts at an even row and Y is even, so complex row c, real rows (x, y)
  // and (x, y + 1) with y even, never straddles two planes, and its bin k
  // is one aligned 16-byte part of the scratch, (x Zo + k) Y + y complex64
  // elements in. Part (k, c) lands in slot k P + c of the buffer: every
  // thread copies a share with cp.async, c fastest, so a warp's copies of
  // one zo are consecutive in the scratch (a run of up to g.rows parts
  // within a plane) and in the buffer; the first pass's reads of
  // neighbouring k, one row's 16-byte parts P apart, fall on distinct
  // banks when P is odd: P = g.rows | 1 where three such buffers fit
  // MIXED_SMEM, else g.rows (one length, 420 at 6 rows).
  __host__ __device__ static int pitch(const fft_rows::MixedPlan& g) {
    const int odd = g.rows | 1;
    return fft_rows::mixed_smem(g, 16 * odd * (g.n / 2 + 1)) <=
                   (size_t)fft_rows::MIXED_SMEM
               ? odd
               : g.rows;
  }
  __host__ __device__ static int stage_bytes(const fft_rows::MixedPlan& g) {
    return 16 * pitch(g) * (g.n / 2 + 1);
  }
  __device__ void issue(const fft_rows::MixedPlan& g, unsigned char* buf,
                        int b, uint64_t* bar) const {
    const int zo = g.n / 2 + 1, pairs = rows_in(g, b) / 2, P = pitch(g);
    // The batch's first real row r0 = (x0, y0): pair c is (x0, y0 + 2c)
    // while that stays below Y, so the division runs only across a plane's
    // end (as ZRows' store).
    const int r0 = b * 2 * g.rows, x0 = r0 / Y, y0 = r0 - x0 * Y;
    fft_rows::DivWalk w(threadIdx.x, pairs, fft_rows::THREADS);  // (k, c)
    for (int e = threadIdx.x; e < pairs * zo;
         e += fft_rows::THREADS, w.next()) {
      const int k = w.q, c = w.r;
      int xq = x0, y = y0 + 2 * c;
      if (y >= Y) {
        const int planes = y / Y;
        xq += planes;
        y -= planes * Y;
      }
      fft_rows::copy16_async(buf + 16 * (k * P + c),
                             s + 2 * (((size_t)xq * zo + k) * Y + y));
    }
    fft_rows::arrive_when_copied(bar);
  }
  // Point i of complex row c: bin k of rows (x, y) and (x, y + 1), one
  // 16-byte read; hermitian_pair keeps an odd Z's last imaginary bin.
  __device__ float2 load(const fft_rows::MixedPlan& g,
                         const unsigned char* buf, int, int c, int i) const {
    const int n = g.n, k = 2 * i <= n ? i : n - i;
    const float4 v =
        *reinterpret_cast<const float4*>(buf + 16 * (k * pitch(g) + c));
    return fft_rows::hermitian_pair(n, make_float2(v.x, v.y),
                                    make_float2(v.z, v.w), i);
  }
};

// Y and Z powers of two in [8, AXIS_MAX]: the FFT body's shapes.
bool zy_fft_ok(int X, int Y, int Z) {
  auto pow2 = [](int n) { return n >= 8 && n <= AXIS_MAX && !(n & (n - 1)); };
  return X >= 2 && X <= AXIS_MAX && pow2(Y) && pow2(Z);
}

// Y and Z lengths of the engine's mixed-radix kernel (13-smooth in [8,
// AXIS_MAX], ops/hopper_fft._engine_length), Y even, not both powers of
// two: the FFT bodies of kernels 6 and 8 on that kernel (their z passes
// store or gather two neighbouring y as one vector, so a pair of rows
// never straddles two x-planes).
bool zy_mixed_ok(int X, int Y, int Z) {
  auto smooth = [](int n) {
    if (n < 8 || n > AXIS_MAX) return false;
    const int primes[6] = {2, 3, 5, 7, 11, 13};
    for (int i = 0; i < 6; ++i)
      while (n % primes[i] == 0) n /= primes[i];
    return n == 1;
  };
  return X >= 2 && X <= AXIS_MAX && smooth(Y) && smooth(Z) && Y % 2 == 0 &&
         !zy_fft_ok(X, Y, Z);
}

int log2i(int n) {
  int l = 0;
  while ((1 << l) < n) ++l;
  return l;
}

bool axes_ok(int X, int Y, int Z) {
  return X >= 2 && Y >= 2 && Z >= 2 && X <= AXIS_MAX && Y <= AXIS_MAX &&
         Z <= AXIS_MAX;
}

// The y-C2C (inverse when inverse != 0) of every row of the (X, Z/2 + 1,
// Y) scratch, in place: kernel 6's pass B and kernel 8's pass 2.
int scratch_cols(float* s, const float* table, int X, int Y, int Z,
                 int schedule, int inverse, void* stream) {
  const bool pow2 = zy_fft_ok(X, Y, Z);
  if (!pow2 && !zy_mixed_ok(X, Y, Z)) return cudaErrorInvalidValue;
  if (fft_rows::misaligned(s)) return cudaErrorMisalignedAddress;
  const fft_rows::ComplexTwiddleRows<false> body{s, nullptr, nullptr, s,
                                                 X * (Z / 2 + 1), 1};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return pow2 ? fft_rows::launch(Y, schedule, body, table, inverse, st)
              : fft_rows::launch_mixed(Y, schedule, body, table, inverse, st);
}

}  // namespace

extern "C" {

const char* dfft_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// x (X, Y, Z) f32; fz (Z, Zo) planes; fy (Y, Y) planes -> y (X, Y, Zo) planes
int dfft_zy_fwd(const float* x, const float* fzr, const float* fzi,
                const float* fyr, const float* fyi, float* yr, float* yi,
                int X, int Y, int Z, void* stream) {
  if (!axes_ok(X, Y, Z)) return cudaErrorInvalidValue;
  const size_t smem = zy_smem_bytes(Y);
  cudaError_t e = cudaFuncSetAttribute(
      zy_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const int Zo = Z / 2 + 1;
  const dim3 grid((Zo + ZY_TZ - 1) / ZY_TZ, X);
  zy_fwd_kernel<<<grid, ZY_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      x, fzr, fzi, fyr, fyi, yr, yi, Y, Z);
  return cudaGetLastError();
}

// zy_fwd FFT body, pass A. x: (X, Y, Z) float32, 16-byte aligned; table,
// schedule: ops/hopper_fft.fft_plan(Z, False); s: (X, Z/2 + 1, Y)
// complex64 scratch, 16-byte aligned.
int dfft_zy_rows(const float* x, const float* table, float* s, int X, int Y,
                 int Z, int schedule, void* stream) {
  const bool pow2 = zy_fft_ok(X, Y, Z);
  if (!pow2 && !zy_mixed_ok(X, Y, Z)) return cudaErrorInvalidValue;
  if (fft_rows::misaligned(x) || fft_rows::misaligned(s))
    return cudaErrorMisalignedAddress;
  const ZRows body{x, s, X * Y, log2i(Y), Y};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return pow2 ? fft_rows::launch(Z, schedule, body, table, 0, st)
              : fft_rows::launch_mixed(Z, schedule, body, table, 0, st);
}

// zy_fwd FFT body, pass B. s: pass A's scratch, transformed in place along
// y; table, schedule: ops/hopper_fft.fft_plan(Y, False).
int dfft_zy_cols(float* s, const float* table, int X, int Y, int Z,
                 int schedule, void* stream) {
  return scratch_cols(s, table, X, Y, Z, schedule, 0, stream);
}

// zy_fwd FFT body, pass C. s: pass B's (X, Z/2 + 1, Y) complex64 result,
// 16-byte aligned; yr, yi: (X, Y, Z/2 + 1) float32 planes.
int dfft_zy_planes(const float* s, float* yr, float* yi, int X, int Y, int Z,
                   void* stream) {
  if (!zy_fft_ok(X, Y, Z) && !zy_mixed_ok(X, Y, Z))
    return cudaErrorInvalidValue;
  if (fft_rows::misaligned(s)) return cudaErrorMisalignedAddress;
  const dim3 grid((Y + PLANE_ROWS - 1) / PLANE_ROWS, X);
  zy_planes_kernel<<<grid, PLANE_THREADS, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(s), yr, yi, Y, Z / 2 + 1);
  return cudaGetLastError();
}

// a (M, N) planes; f (M, M) symmetric planes -> z (M, N) planes
int dfft_x_c2c(const float* ar, const float* ai, const float* fr,
               const float* fi, float* zr, float* zi, int M, int N,
               void* stream) {
  if (M < 2 || M > AXIS_MAX || N < 1) return cudaErrorInvalidValue;
  const dim3 grid((N + XC_BN - 1) / XC_BN, (M + XC_BM - 1) / XC_BM);
  x_c2c_kernel<<<grid, XC_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      ar, ai, fr, fi, zr, zi, M, N);
  return cudaGetLastError();
}

// x_c2c FFT body: the X-point C2C (inverse when inverse != 0) of every
// column of an (X, inner) array, inner = Ky * Zo. In: float32 planes ar, ai,
// or complex64 at ar when ai is null; out: planes zr, zi, or complex64 at zr
// when zi is null. table, schedule: ops/hopper_fft.fft_plan(X, inverse).
int dfft_x_cols(const float* ar, const float* ai, const float* table,
                float* zr, float* zi, int X, int inner, int schedule,
                int inverse, void* stream) {
  if (X < 8 || X > AXIS_MAX || inner < 1) return cudaErrorInvalidValue;
  const fft_rows::Columns body{ar, ai, zr, zi, 1, X, inner};
  return fft_rows::launch_cols(X, schedule, body, table, nullptr, inverse,
                               static_cast<cudaStream_t>(stream));
}

// x_c2c FFT body on the mixed-radix column kernel: as dfft_x_cols, X one
// of ops/hopper_fft.MIXED_LENGTHS (13-smooth, not a power of two). table:
// ops/hopper_fft.fft_plan(X, inverse).table; schedule:
// ops/hopper_fft.mixed_cols_schedule(X, inverse).
int dfft_x_mixed(const float* ar, const float* ai, const float* table,
                 float* zr, float* zi, int X, int inner, int schedule,
                 int inverse, void* stream) {
  if (X < 8 || X > AXIS_MAX || inner < 1) return cudaErrorInvalidValue;
  const fft_rows::Columns body{ar, ai, zr, zi, 1, X, inner};
  return fft_rows::launch_mixed_cols(X, schedule, body, table, inverse,
                                     static_cast<cudaStream_t>(stream));
}

// e (X, Y, Zo) planes; fy (Y, Y) planes; c2r (Zo, Z) f32 x2 -> out (X, Y, Z)
int dfft_yz_inv(const float* er, const float* ei, const float* fyr,
                const float* fyi, const float* cr, const float* ci, float* out,
                int X, int Y, int Z, void* stream) {
  if (!axes_ok(X, Y, Z)) return cudaErrorInvalidValue;
  const int Zo = Z / 2 + 1;
  const dim3 grid((Y + YZ_TY - 1) / YZ_TY, X);
  yz_inv_kernel<<<grid, yz_threads(Zo), yz_smem_bytes(Zo),
                  static_cast<cudaStream_t>(stream)>>>(er, ei, fyr, fyi, cr,
                                                       ci, out, Y, Z);
  return cudaGetLastError();
}

// yz_inv FFT body, pass 1. er, ei: (X, Y, Z/2 + 1) float32 planes; s:
// (X, Z/2 + 1, Y) complex64 scratch, 16-byte aligned.
int dfft_yz_scratch(const float* er, const float* ei, float* s, int X, int Y,
                    int Z, void* stream) {
  if (!zy_fft_ok(X, Y, Z) && !zy_mixed_ok(X, Y, Z))
    return cudaErrorInvalidValue;
  if (fft_rows::misaligned(s)) return cudaErrorMisalignedAddress;
  const dim3 grid((Y + PLANE_ROWS - 1) / PLANE_ROWS, X);
  yz_scratch_kernel<<<grid, PLANE_THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      er, ei, reinterpret_cast<float4*>(s), Y, Z / 2 + 1);
  return cudaGetLastError();
}

// yz_inv FFT body, pass 2. s: pass 1's scratch, inverse-transformed in
// place along y; table: ops/hopper_fft.fft_plan(Y, True).table; schedule:
// its .schedule when Y and Z are powers of two, else
// ops/hopper_fft.mixed_schedule(Y, True).
int dfft_yz_cols(float* s, const float* table, int X, int Y, int Z,
                 int schedule, void* stream) {
  return scratch_cols(s, table, X, Y, Z, schedule, 1, stream);
}

// yz_inv FFT body, pass 3. s: pass 2's (X, Z/2 + 1, Y) complex64 result,
// 16-byte aligned; table: ops/hopper_fft.fft_plan(Z, True).table;
// schedule: its .schedule when Y and Z are powers of two, else
// ops/hopper_fft.mixed_schedule(Z, True, half=True); out: (X, Y, Z)
// float32, 16-byte aligned.
int dfft_yz_rows(const float* s, const float* table, float* out, int X,
                 int Y, int Z, int schedule, void* stream) {
  const bool pow2 = zy_fft_ok(X, Y, Z);
  if (!pow2 && !zy_mixed_ok(X, Y, Z)) return cudaErrorInvalidValue;
  if (fft_rows::misaligned(s) || fft_rows::misaligned(out))
    return cudaErrorMisalignedAddress;
  const YZRows body{{out, X * Y}, s, log2i(Y), Y};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return pow2 ? fft_rows::launch(Z, schedule, body, table, 1, st)
              : fft_rows::launch_mixed(Z, schedule, body, table, 1, st);
}

}  // extern "C"
