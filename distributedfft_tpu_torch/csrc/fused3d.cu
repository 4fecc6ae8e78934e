// Fused single-device 3D FFT kernels for Hopper (sm_90a), plain C interface.
//
// Complex data travels as split float32 (real, imag) planes, as in the JAX
// package's Pallas kernels. Every DFT is a dense matrix product with the DFT
// matrices built on the host (ops/mxu_fft.py), computed in float32 FFMA on
// the CUDA cores through shared-memory tiles; no tensor cores yet.
//
// Three kernels, each replacing one Pallas TPU kernel of
// distributedfft_tpu/ops/pallas_fft.py:
//
//   zy_fwd_kernel  <- _zy_fwd_kernel  (z-R2C, then y-C2C, per x-row)
//   x_c2c_kernel   <- _x_c2c_kernel   (C2C along x, both directions)
//   yz_inv_kernel  <- _yz_inv_kernel  (y-C2C inverse, then half-spectrum C2R)
//
// Bound on an H100 SXM at X = Y = Z = 512 (Zo = 257), float32 outside the
// tensor cores (67 TFLOP/s) and 3.35 TB/s of HBM:
//
//   zy_fwd  4.14e11 FLOP -> 6.2 ms;  1.08 GB -> 0.32 ms   (operations bound)
//   x_c2c   2.76e11 FLOP -> 4.1 ms;  1.08 GB -> 0.32 ms   (operations bound)
//   yz_inv  4.14e11 FLOP -> 6.2 ms;  1.08 GB -> 0.32 ms   (operations bound)
//
// A DFT done as a dense product is about 20x the arithmetic of an FFT, so
// all three are bound by operations, not bytes. What the designs do about it:
// each keeps its inter-stage intermediate in shared memory (one HBM read of
// the input, one HBM write of the output), and each thread holds a register
// tile of 16 to 32 complex sums so that an operand fetched from shared memory
// feeds 4 to 16 FMAs. The DFT matrices are re-read per block from L2. Tensor
// cores (3xTF32 or split bf16) and TMA pipelines are the later steps.
//
// Every extern "C" entry point returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>

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

bool axes_ok(int X, int Y, int Z) {
  return X >= 2 && Y >= 2 && Z >= 2 && X <= AXIS_MAX && Y <= AXIS_MAX &&
         Z <= AXIS_MAX;
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

}  // extern "C"
