// The row FFT engine for Hopper (sm_90a), shared by wire.cu (kernel 11),
// stage.cu (kernels 1, 2, 3, 4 and 5) and fused3d.cu (kernels 6 and 8): the
// DFT of every row of a batch of power-of-two rows, 8 <= n <= 1024, in
// shared memory and registers.
//
// It replaces the dense DFT product of eight Pallas TPU kernels of
// distributedfft_tpu/ops/pallas_fft.py (_dec_cmatmul_kernel :737, kernel
// 11, _cmatmul_kernel :164, kernel 2, _rmatmul_kernel :182, kernel 1,
// _c2r_kernel :156, kernel 3, _cmatmul_tw_kernel :171, kernel 4,
// _rmatmul_tw_kernel :188, kernel 5, and _zy_fwd_kernel :427, kernel 6, and
// _yz_inv_kernel :452, kernel 8, as two passes each). The TPU had only a
// matrix unit, so there a row DFT is a product with the (n, n) DFT matrix:
// n / (5 log2 n) times an FFT's arithmetic (20x at n = 1024). Here the
// function is bound by bytes: an FFT costs 5 n log2 n flop per row, 50 flop
// per point at n = 1024, against 12 bytes per point moved (kernel 11: 4 in
// as bfloat16, 8 out as complex64; kernel 5: 4 in as float32, 8 out), ~4
// flop/byte under the float32 ridge of 67e12 / 3.35e12 = 20 flop/byte. On
// an H100 SXM (3.35 TB/s) that bounds kernel 11 at 65,536 rows of 1024 to
// 0.240 ms and kernel 5 at 2,097,152 rows of 512 to 3.85 ms.
//
// Design:
// - A persistent grid (sized from the SM count and the kernel's occupancy)
//   walks over batches of whole rows, 256 threads and THREADS * RMAX points
//   a batch. Each batch's input arrives in shared memory by one-dimensional
//   bulk copies (cp.async.bulk, the TMA's plain form: the rows of a batch are
//   contiguous) into a ring of STAGES buffers, each with an mbarrier that
//   counts the bytes in. Thread 0 refills a buffer as soon as every thread
//   has read it, so STAGES - 1 batches (32 KB or more a block, two or three
//   blocks an SM) stay in flight while one is transformed. A Body whose
//   batch is many small pieces has every thread copy a share of them with
//   16-byte cp.async instead, each thread arriving on the buffer's barrier
//   once its own have landed.
// - Stockham passes of radix 8 or 16 (the schedule of fft_plan in
//   ops/hopper_fft.py: ceil(log2 n / 4) passes, larger radices first, e.g.
//   1024 = 16 * 8 * 8, 512 = 8 * 8 * 8). A thread holds RMAX points (the
//   first radix) in registers and runs RMAX / r butterflies of each pass as
//   unrolled radix-2 networks; points cross threads through one shared
//   buffer of split (real, imag) float planes, padded by one float every 32
//   against bank conflicts. The first pass reads straight from the input
//   buffer, widening bfloat16, packing real rows or extending half spectra as
//   it goes.
// - The twiddles are a float32 table built on the host in float64, laid out
//   pass by pass so that neighbouring threads read neighbouring entries; it
//   is copied to shared memory once per block. Arithmetic is float32.
// - The epilogue reads the finished rows back from shared memory and stores
//   16-byte vectors of two complex64 values, coalesced.
//
// The host side of the engine is ops/hopper_fft.py: fft_plan(n, inverse)
// gives the schedule (radices in order) and the twiddle table; the entry
// points check that the packed schedule they are given is the one they were
// compiled for.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace fft_rows {

constexpr int THREADS = 256;
constexpr int STAGES = 3;  // depth of the ring of input buffers

// ---------------------------------------------------------------------------
// The pass schedule (ops/hopper_fft.fft_plan): L = log2 n bits split into
// ceil(L / 4) passes as evenly as possible, the larger radices first.
// ---------------------------------------------------------------------------

__host__ __device__ constexpr int num_passes(int L) { return (L + 3) / 4; }

__host__ __device__ constexpr int pass_bits(int L, int p) {
  return L / num_passes(L) + (p < L % num_passes(L) ? 1 : 0);
}

__host__ __device__ constexpr int bits_before(int L, int p) {
  int s = 0;
  for (int q = 0; q < p; ++q) s += pass_bits(L, q);
  return s;
}

// log2 of each radix in 4 bits, pass 0 in the lowest: what the wrapper
// passes, from fft_plan(n, inverse).schedule.
__host__ __device__ constexpr int packed_schedule(int L) {
  int s = 0;
  for (int p = num_passes(L) - 1; p >= 0; --p) s = s * 16 + pass_bits(L, p);
  return s;
}

template <int L>
struct Geometry {
  static constexpr int N = 1 << L;
  static constexpr int PASSES = num_passes(L);
  static constexpr int RMAX = 1 << pass_bits(L, 0);  // points a thread holds
  static constexpr int T = N / RMAX;                 // threads per row
  static constexpr int ROWS = THREADS / T;           // rows per batch
  static constexpr int POINTS = ROWS * N;            // = THREADS * RMAX
  static constexpr int PADDED = POINTS + POINTS / 32;
  static constexpr int TABLE = N - RMAX;  // twiddles of passes 1, 2, ...
};

__device__ __forceinline__ int pad(int i) { return i + (i >> 5); }

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// cos and sin of 2 pi m / 16 for m in [0, 8).
__host__ __device__ constexpr float cos16(int m) {
  return m == 0   ? 1.f
         : m == 1 ? 0.92387953251128674f
         : m == 2 ? 0.70710678118654752f
         : m == 3 ? 0.38268343236508978f
         : m == 4 ? 0.f
         : m == 5 ? -0.38268343236508978f
         : m == 6 ? -0.70710678118654752f
                  : -0.92387953251128674f;
}

__host__ __device__ constexpr float sin16(int m) {
  return cos16(m >= 4 ? m - 4 : 4 - m);
}

__host__ __device__ constexpr int bitrev(int i, int bits) {
  int r = 0;
  for (int b = 0; b < bits; ++b) r |= ((i >> b) & 1) << (bits - 1 - b);
  return r;
}

// b[I] = a[bitrev(I)] for every I < 2^B, each index a compile-time
// constant so that both arrays stay in registers.
template <int B, int I = 0>
__device__ __forceinline__ void gather_bitrev(float2* b, const float2* a) {
  if constexpr (I < (1 << B)) {
    constexpr int SRC = bitrev(I, B);
    b[I] = a[SRC];
    gather_bitrev<B, I + 1>(b, a);
  }
}

// Stage S of the radix-2 network: butterflies of span 2 * 2^S, twiddles
// exp(sgn 2 pi i k / 2^(S+1)) = the 16th roots cos16 / sin16.
template <int B, int S>
__device__ __forceinline__ void radix2_stage(float2* b, float sgn) {
  constexpr int r = 1 << B, half = 1 << S;
#pragma unroll
  for (int i = 0; i < r; i += 2 * half) {
#pragma unroll
    for (int k = 0; k < half; ++k) {
      const int m = k * (8 / half);  // 2 pi k / (2 half) = 2 pi m / 16
      float2 v = b[i + k + half];
      if (m != 0) v = cmul(v, make_float2(cos16(m), sgn * sin16(m)));
      const float2 u = b[i + k];
      b[i + k] = make_float2(u.x + v.x, u.y + v.y);
      b[i + k + half] = make_float2(u.x - v.x, u.y - v.y);
    }
  }
  if constexpr (S + 1 < B) radix2_stage<B, S + 1>(b, sgn);
}

// In-place DFT of 2^B <= 16 points in registers, exp(sgn 2 pi i jk / r):
// a radix-2 network on bit-reversed input, fully unrolled, its twiddles
// compile-time constants (sgn is -1 forward, +1 inverse).
template <int B>
__device__ __forceinline__ void dft_regs(float2* a, float sgn) {
  constexpr int r = 1 << B;
  float2 b[r];
  gather_bitrev<B>(b, a);
  radix2_stage<B, 0>(b, sgn);
#pragma unroll
  for (int i = 0; i < r; ++i) a[i] = b[i];
}

// Pass P on the butterfly whose inputs are points j + m n / r of a row
// (a[m], m < r): twiddle by the table entry [m - 1][j mod NS] of the pass,
// then the radix-r DFT.
template <int L, int P>
__device__ __forceinline__ void twiddle_dft(float2* a, int j, const float* wr,
                                            const float* wi, float sgn) {
  constexpr int B = pass_bits(L, P), r = 1 << B;
  constexpr int NS = 1 << bits_before(L, P);
  if constexpr (P > 0) {
    const int k = j & (NS - 1);
    const int off = NS - Geometry<L>::RMAX + k;
#pragma unroll
    for (int m = 1; m < r; ++m) {
      const int t = off + (m - 1) * NS;
      a[m] = cmul(a[m], make_float2(wr[t], wi[t]));
    }
  }
  dft_regs<B>(a, sgn);
}

// Write the thread's butterflies of pass P: output m of butterfly j goes to
// point (j - k) r + k + m NS of the row, k = j mod NS (Stockham order).
template <int L, int P>
__device__ __forceinline__ void store_pass(float* re, float* im, int base,
                                           int jl, const float2* a) {
  using G = Geometry<L>;
  constexpr int B = pass_bits(L, P), r = 1 << B;
  constexpr int NS = 1 << bits_before(L, P);
#pragma unroll
  for (int q = 0; q < G::RMAX / r; ++q) {
    const int j = jl + q * G::T;
    const int k = j & (NS - 1);
    const int o = base + (j - k) * r + k;
#pragma unroll
    for (int m = 0; m < r; ++m) {
      const int i = pad(o + m * NS);
      re[i] = a[q * r + m].x;
      im[i] = a[q * r + m].y;
    }
  }
}

// A pass after the first: read, sync, write, sync.
template <int L, int P>
__device__ __forceinline__ void work_pass(float* re, float* im, int base,
                                          int jl, const float* wr,
                                          const float* wi, float sgn) {
  using G = Geometry<L>;
  constexpr int r = 1 << pass_bits(L, P);
  float2 a[G::RMAX];
#pragma unroll
  for (int q = 0; q < G::RMAX / r; ++q) {
    const int j = jl + q * G::T;
#pragma unroll
    for (int m = 0; m < r; ++m) {
      const int i = pad(base + j + m * (G::N / r));
      a[q * r + m] = make_float2(re[i], im[i]);
    }
    twiddle_dft<L, P>(a + q * r, j, wr, wi, sgn);
  }
  __syncthreads();
  store_pass<L, P>(re, im, base, jl, a);
  __syncthreads();
}

// ---------------------------------------------------------------------------
// Bulk copies and barriers (PTX)
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// bytes (a multiple of 16) from global src to shared dst, both 16-byte
// aligned, counted in to bar.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// 16 bytes from global src to shared dst, both 16-byte aligned, without
// waiting (cp.async, through L2 only).
__device__ __forceinline__ void copy16_async(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

// Arrive on bar once every cp.async this thread has issued has landed.
__device__ __forceinline__ void arrive_when_copied(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// ---------------------------------------------------------------------------
// The kernel. Body gives the rows' loader and epilogue:
//   ISSUERS                           threads that call issue, each
//                                     arriving once on the buffer's barrier:
//                                     1 (a bulk copy and its expect_tx) or
//                                     THREADS (cp.async pieces)
//   batches<L>()                      number of row batches
//   stage_bytes<L>()                  bytes of one input buffer
//   issue<L>(buffer, b, bar)          bulk copies of batch b
//   load<L>(buffer, b, row, i)        point i of the batch's complex row
//   store<L>(re, im, b)               the epilogue, all threads
// ---------------------------------------------------------------------------

template <int L, class Body>
constexpr size_t smem_bytes() {
  using G = Geometry<L>;
  return 128 + 8 * G::TABLE + STAGES * Body::template stage_bytes<L>() +
         8 * G::PADDED;
}

template <int L, class Body>
__global__ void __launch_bounds__(THREADS, 2)
fft_rows_kernel(const Body body, const float* __restrict__ table,
                int inverse) {
  using G = Geometry<L>;
  constexpr int SB = Body::template stage_bytes<L>();
  constexpr int ISSUERS = Body::ISSUERS;
  static_assert(ISSUERS == 1 || ISSUERS == THREADS, "one thread or all");
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  float* wr = reinterpret_cast<float*>(smem + 128);
  float* wi = wr + G::TABLE;
  unsigned char* stages = reinterpret_cast<unsigned char*>(wi + G::TABLE);
  float* re = reinterpret_cast<float*>(stages + STAGES * SB);
  float* im = re + G::PADDED;

  const int tid = threadIdx.x;
  const int nb = body.template batches<L>();
  for (int i = tid; i < G::TABLE; i += THREADS) {
    wr[i] = table[i];
    wi[i] = table[G::TABLE + i];
  }
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(&full[s], ISSUERS);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid < ISSUERS) {
    for (int s = 0; s < STAGES; ++s) {
      const int b = blockIdx.x + s * gridDim.x;
      if (b < nb) body.template issue<L>(stages + s * SB, b, &full[s]);
    }
  }

  const float sgn = inverse ? 1.f : -1.f;
  const int rowl = tid / G::T, jl = tid % G::T, base = rowl * G::N;
  constexpr int R0 = G::RMAX;  // the first pass: one butterfly a thread
  int it = 0;
  for (int b = blockIdx.x; b < nb; b += gridDim.x, ++it) {
    const int s = it % STAGES;
    unsigned char* buf = stages + s * SB;
    mbar_wait(&full[s], (it / STAGES) & 1);
    float2 a[R0];
#pragma unroll
    for (int m = 0; m < R0; ++m)
      a[m] = body.template load<L>(buf, b, rowl, jl + m * G::T);
    twiddle_dft<L, 0>(a, jl, wr, wi, sgn);
    // Every thread has read buffer s, and the last epilogue has read the
    // work planes: refill s with the batch STAGES steps ahead.
    __syncthreads();
    if (tid < ISSUERS) {
      const int next = b + STAGES * gridDim.x;
      if (next < nb) {
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        body.template issue<L>(buf, next, &full[s]);
      }
    }
    store_pass<L, 0>(re, im, base, jl, a);
    __syncthreads();
    if constexpr (G::PASSES > 1) work_pass<L, 1>(re, im, base, jl, wr, wi, sgn);
    if constexpr (G::PASSES > 2) work_pass<L, 2>(re, im, base, jl, wr, wi, sgn);
    body.template store<L>(re, im, b);
  }
}

template <int L, class Body>
cudaError_t launch_log2(int schedule, const Body& body, const float* table,
                        int inverse, cudaStream_t stream) {
  if (schedule != packed_schedule(L)) return cudaErrorInvalidValue;
  auto kernel = fft_rows_kernel<L, Body>;
  constexpr size_t smem = smem_bytes<L, Body>();
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      THREADS, smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int nb = body.template batches<L>();
  const int grid = nb < sms * per_sm ? nb : sms * per_sm;
  kernel<<<grid, THREADS, smem, stream>>>(body, table, inverse);
  return cudaGetLastError();
}

// Launch the engine on rows of n points (a power of two in [8, 1024]).
template <class Body>
cudaError_t launch(int n, int schedule, const Body& body, const float* table,
                   int inverse, cudaStream_t stream) {
  switch (n) {
    case 8: return launch_log2<3>(schedule, body, table, inverse, stream);
    case 16: return launch_log2<4>(schedule, body, table, inverse, stream);
    case 32: return launch_log2<5>(schedule, body, table, inverse, stream);
    case 64: return launch_log2<6>(schedule, body, table, inverse, stream);
    case 128: return launch_log2<7>(schedule, body, table, inverse, stream);
    case 256: return launch_log2<8>(schedule, body, table, inverse, stream);
    case 512: return launch_log2<9>(schedule, body, table, inverse, stream);
    case 1024: return launch_log2<10>(schedule, body, table, inverse, stream);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// A Body on complex rows, shared by stage.cu (kernel 4, TW; kernel 2, no
// twiddle) and fused3d.cu (kernel 6's y pass, no twiddle): (M, n)
// interleaved complex64 in and out, the n-point DFT of each row, times the
// four-step twiddle row T[r % n1] ((n1, n) float32 planes) when TW. out may
// be x: each batch's rows are read whole (its bulk copy has landed) before
// they are written, and no other batch reads them.
// ---------------------------------------------------------------------------
template <bool TW>
struct ComplexTwiddleRows {
  const float* x;
  const float* tr;
  const float* ti;
  float* out;
  int M;
  int n1;
  static constexpr int ISSUERS = 1;

  template <int L>
  __host__ __device__ int batches() const {
    constexpr int ROWS = Geometry<L>::ROWS;
    return (M + ROWS - 1) / ROWS;
  }
  template <int L>
  __host__ __device__ static constexpr int stage_bytes() {
    return 8 * Geometry<L>::POINTS;
  }
  template <int L>
  __device__ int rows_in(int b) const {
    constexpr int ROWS = Geometry<L>::ROWS;
    const int left = M - b * ROWS;
    return left < ROWS ? left : ROWS;
  }
  template <int L>
  __device__ void issue(unsigned char* buf, int b, uint64_t* bar) const {
    using G = Geometry<L>;
    const uint32_t bytes = 8u * rows_in<L>(b) * G::N;
    mbar_expect_tx(bar, bytes);
    bulk_load(buf, x + (size_t)b * 2 * G::POINTS, bytes, bar);
  }
  template <int L>
  __device__ float2 load(const unsigned char* buf, int, int row,
                         int i) const {
    return reinterpret_cast<const float2*>(buf)[row * Geometry<L>::N + i];
  }
  template <int L>
  __device__ void store(const float* re, const float* im, int b) const {
    using G = Geometry<L>;
    constexpr int N = G::N;
    const int count = rows_in<L>(b) * N;
    const int row0 = b * G::ROWS;
    float4* o = reinterpret_cast<float4*>(out + (size_t)b * G::POINTS * 2);
    for (int e = 2 * threadIdx.x; e < count; e += 2 * THREADS) {
      const int i = pad(e);  // e even: e + 1 pads to i + 1
      float v[4] = {re[i], im[i], re[i + 1], im[i + 1]};
      if constexpr (TW) {
        const size_t t = (size_t)((row0 + (e >> L)) % n1) * N + (e & (N - 1));
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float wr = __ldg(tr + t + h), wi = __ldg(ti + t + h);
          const float xr = v[2 * h], xi = v[2 * h + 1];
          v[2 * h] = xr * wr - xi * wi;
          v[2 * h + 1] = xr * wi + xi * wr;
        }
      }
      o[e / 2] = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
};

// ---------------------------------------------------------------------------
// The two halves of a C2R Body, shared by stage.cu (kernel 3, HalfRows) and
// fused3d.cu (kernel 8's z pass, YZRows). Half spectra A and B (n/2 + 1
// bins each) of two real rows are packed as one complex row Z = A + iB,
// extended by Hermitian symmetry; its unnormalized inverse DFT is a + ib,
// a and b the two real rows. Each Body gives issue and load; this gives
// the packing and the epilogue.
// ---------------------------------------------------------------------------

// Point i of Z from bin k of A and bin k of B, k = i for i <= n/2, else
// n - i (then conjugated). The imaginary parts of the DC and Nyquist bins
// are dropped: the C2R ignores them (mxu_fft._c2r_np's CI rows 0 and n/2
// are sin 0 and sin pi j), and in the packed pair they would leak into the
// partner row.
template <int L>
__device__ __forceinline__ float2 hermitian_pair(float2 a, float2 b, int i) {
  constexpr int N = 1 << L;
  if (i == 0 || i == N / 2) {
    a.y = 0.f;
    b.y = 0.f;
  } else if (i > N / 2) {
    a.y = -a.y;
    b.y = -b.y;
  }
  return make_float2(a.x - b.y, a.y + b.x);
}

// (M, n) float32 rows out, 2 ROWS real rows a batch: row 2c is the real
// plane of complex row c, row 2c + 1 its imaginary plane. A batch's rows
// are one contiguous run of whole rows (4 n bytes each, a multiple of 16):
// thread by thread four neighbouring points of one row as one coalesced
// 16-byte store (the padding of the work planes puts the four reads of a
// warp's store on distinct banks). The partner of an odd last row is not
// stored.
struct RealPairsOut {
  float* out;
  int M;  // real rows

  template <int L>
  __host__ __device__ int batches() const {
    constexpr int ROWS2 = 2 * Geometry<L>::ROWS;
    return (M + ROWS2 - 1) / ROWS2;
  }
  template <int L>
  __device__ int rows_in(int b) const {
    constexpr int ROWS2 = 2 * Geometry<L>::ROWS;
    const int left = M - b * ROWS2;
    return left < ROWS2 ? left : ROWS2;
  }
  template <int L>
  __device__ void store(const float* re, const float* im, int b) const {
    using G = Geometry<L>;
    const int count = rows_in<L>(b) * G::N;
    float4* o = reinterpret_cast<float4*>(out + (size_t)b * 2 * G::POINTS);
    for (int e = 4 * threadIdx.x; e < count; e += 4 * THREADS) {
      const int q = e >> L;
      const float* p = (q & 1) ? im : re;
      // A multiple of 4: its four points lie in one padded group of 32.
      const int i = pad((q >> 1) * G::N + (e & (G::N - 1)));
      o[e / 4] = make_float4(p[i], p[i + 1], p[i + 2], p[i + 3]);
    }
  }
};

inline bool misaligned(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) != 0;
}

}  // namespace fft_rows
