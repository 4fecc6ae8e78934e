// The tile loop of one DFT stage on rows, shared by stage.cu (kernels 1-5)
// and wire.cu (kernel 11):
//
//   Y (M x k) = A (M x depth) @ B (depth x k)     [then Y[r, :] *= T[r % n1, :]]
//
// 64 x 64 output tiles, depth 16 per step, 256 threads each holding a
// 4 x 4 (complex) register tile, float32 FFMA on the CUDA cores. The modes
// differ only in how A and B are loaded and what is stored:
//
//   MODE_CMATMUL       A interleaved complex64 rows, B complex F
//   MODE_RMATMUL       A float32 rows, B complex F
//   MODE_C2R           A interleaved complex rows read as 2n floats, B the
//                      interleaved pair (CR[j], -CI[j]); real output
//   MODE_CMATMUL_BF16  A two planar bfloat16 planes (real at x, imag at
//                      x + M * n, in bfloat16 elements), widened to float32
//                      as they are stored to shared memory; B complex F
//
// Offsets are 64-bit; ragged edges are masked element by element.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

enum Mode {
  MODE_CMATMUL = 0,
  MODE_RMATMUL = 1,
  MODE_C2R = 2,
  MODE_CMATMUL_BF16 = 3
};

constexpr int BM = 64, BN = 64, BK = 16, THREADS = 256;
constexpr int APAD = 4;  // A rows padded to keep the transposed stores spread
                         // over banks and the float4 reads 16-byte aligned

template <int MODE, bool TW>
__global__ void __launch_bounds__(THREADS)
stage_tile_kernel(const float* __restrict__ x, const float* __restrict__ fr,
                  const float* __restrict__ fi, const float* __restrict__ tr,
                  const float* __restrict__ ti, float* __restrict__ y, int M,
                  int n, int k, int n1) {
  constexpr bool CPLX_A = MODE == MODE_CMATMUL || MODE == MODE_CMATMUL_BF16;
  constexpr bool CPLX_B = MODE != MODE_C2R;
  __shared__ __align__(16) float As_r[BK][BM + APAD];
  __shared__ __align__(16) float As_i[CPLX_A ? BK : 1][BM + APAD];
  __shared__ __align__(16) float Bs_r[BK][BN];
  __shared__ __align__(16) float Bs_i[CPLX_B ? BK : 1][BN];

  // Contraction depth, counted in elements of an A row: complex elements
  // for the complex modes, floats for kernels 1 and 3 (for kernel 3 a row
  // of n complex inputs is 2n floats).
  const int D = MODE == MODE_C2R ? 2 * n : n;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const float2* x2 = reinterpret_cast<const float2*>(x);
  const __nv_bfloat16* xb = reinterpret_cast<const __nv_bfloat16*>(x);
  const size_t plane = (size_t)M * n;  // MODE_CMATMUL_BF16 only

  float acc_r[4][4], acc_i[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc_r[i][j] = acc_i[i][j] = 0.f;

  for (int k0 = 0; k0 < D; k0 += BK) {
    // A tile: 64 rows x 16 depth, stored transposed (depth-major).
#pragma unroll
    for (int l = 0; l < (BM * BK) / THREADS; ++l) {
      const int e = tid + l * THREADS;
      const int r = e / BK, d = e % BK;
      const long long row = m0 + r;
      const int dd = k0 + d;
      const bool ok = row < M && dd < D;
      if constexpr (MODE == MODE_CMATMUL_BF16) {
        const size_t off = (size_t)row * n + dd;
        As_r[d][r] = ok ? __bfloat162float(xb[off]) : 0.f;
        As_i[d][r] = ok ? __bfloat162float(xb[plane + off]) : 0.f;
      } else if constexpr (CPLX_A) {
        const float2 v = ok ? x2[row * n + dd] : make_float2(0.f, 0.f);
        As_r[d][r] = v.x;
        As_i[d][r] = v.y;
      } else {
        As_r[d][r] = ok ? x[row * D + dd] : 0.f;
      }
    }
    // B tile: 16 depth x 64 columns of F (or of the interleaved C2R pair).
#pragma unroll
    for (int l = 0; l < (BK * BN) / THREADS; ++l) {
      const int e = tid + l * THREADS;
      const int d = e / BN, c = e % BN;
      const int dd = k0 + d, col = n0 + c;
      const bool ok = dd < D && col < k;
      if constexpr (MODE == MODE_C2R) {
        const size_t off = (size_t)(dd >> 1) * k + col;
        Bs_r[d][c] = ok ? ((dd & 1) ? -fi[off] : fr[off]) : 0.f;
      } else {
        const size_t off = (size_t)dd * k + col;
        Bs_r[d][c] = ok ? fr[off] : 0.f;
        Bs_i[d][c] = ok ? fi[off] : 0.f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int d = 0; d < BK; ++d) {
      const float4 a4r = *reinterpret_cast<const float4*>(&As_r[d][ty * 4]);
      const float4 b4r = *reinterpret_cast<const float4*>(&Bs_r[d][tx * 4]);
      const float a_r[4] = {a4r.x, a4r.y, a4r.z, a4r.w};
      const float b_r[4] = {b4r.x, b4r.y, b4r.z, b4r.w};
      if constexpr (CPLX_A) {
        const float4 a4i = *reinterpret_cast<const float4*>(&As_i[d][ty * 4]);
        const float4 b4i = *reinterpret_cast<const float4*>(&Bs_i[d][tx * 4]);
        const float a_i[4] = {a4i.x, a4i.y, a4i.z, a4i.w};
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
      } else if constexpr (MODE == MODE_RMATMUL) {
        const float4 b4i = *reinterpret_cast<const float4*>(&Bs_i[d][tx * 4]);
        const float b_i[4] = {b4i.x, b4i.y, b4i.z, b4i.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            acc_r[i][j] = fmaf(a_r[i], b_r[j], acc_r[i][j]);
            acc_i[i][j] = fmaf(a_r[i], b_i[j], acc_i[i][j]);
          }
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc_r[i][j] = fmaf(a_r[i], b_r[j], acc_r[i][j]);
      }
    }
    __syncthreads();
  }

  // Epilogue: twiddle in registers, then one store per element.
  float2* y2 = reinterpret_cast<float2*>(y);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long row = m0 + ty * 4 + i;
    if (row >= M) continue;
    const int trow = TW ? (int)(row % n1) : 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx * 4 + j;
      if (col >= k) continue;
      if constexpr (MODE == MODE_C2R) {
        y[row * k + col] = acc_r[i][j];
      } else {
        float vr = acc_r[i][j], vi = acc_i[i][j];
        if constexpr (TW) {
          const size_t t = (size_t)trow * k + col;
          const float wr = tr[t], wi = ti[t];
          const float pr = vr * wr - vi * wi;
          vi = vr * wi + vi * wr;
          vr = pr;
        }
        y2[row * k + col] = make_float2(vr, vi);
      }
    }
  }
}

}  // namespace
