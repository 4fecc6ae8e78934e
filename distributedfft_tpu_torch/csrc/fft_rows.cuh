// The row FFT engine for Hopper (sm_90a), shared by wire.cu (kernel 11),
// stage.cu (kernels 1, 2, 3, 4 and 5) and fused3d.cu (kernels 6, 7 and 8):
// the DFT of every row of a batch of power-of-two rows, 8 <= n <= 1024, in
// shared memory and registers; on the same design its mixed-radix kernel
// (fft_mixed_kernel below), rows of the 155 13-smooth lengths 2^a 3^b 5^c
// 7^d 11^e 13^f in [9, 507] that are not powers of two (the rows of
// kernels 1-5; both passes of kernels 6 and 8, powers of two beside them
// included); and, on the same passes and twiddle table, the column kernel
// (kernel 7, kernel 2 on a non-last axis, kernel 4 on a non-last split
// axis), the DFT of every column of an (outer, n, inner) array, and its
// mixed-radix form (fft_mixed_cols_kernel: kernel 7 on a 13-smooth X);
// and, on the column kernel's loader, the short-stage kernel (the end of
// this file: kernel 2 on the 2..16-point second stage of a split axis).
//
// Which kernel runs which body (ops/hopper_fft.py): the power-of-two
// kernel carries kernel 11 (_fft_body), kernels 1-5 on a power of two
// (_cdft_body) and kernels 6 and 8 when Y and Z are both powers of two
// (_zy_body); the mixed-radix kernel carries kernels 1-5 on a 13-smooth
// length and kernels 6 and 8 on 13-smooth Y and Z, Y even
// (_zy_engine_body); the column kernel carries kernel 7 on a power of two
// and the mixed-radix column kernel on a 13-smooth X (_x_body). Both row
// kernels also carry kernel 3's packed body (stage.cu's PackedHalfRows:
// the C2R of an even n past the direct lengths as the m = n/2-point
// inverse of a packed spectrum, irdft_packed, on rows of an m either
// kernel takes). Every other length keeps its dense or tile body. The
// mixed-radix kernels are one instantiation a Body (n and the radices are
// runtime values), so they add ten kernels to the build (kernels 1-5 and
// kernel 3's packed body in stage.cu; kernel 6's two passes, kernel 8's z
// pass, whose y pass is kernel 6's, and kernel 7 in fused3d.cu), not one a
// length.
//
// It replaces the dense DFT product of nine Pallas TPU kernels of
// distributedfft_tpu/ops/pallas_fft.py (_dec_cmatmul_kernel :737, kernel
// 11, _cmatmul_kernel :164, kernel 2, _rmatmul_kernel :182, kernel 1,
// _c2r_kernel :156, kernel 3, _cmatmul_tw_kernel :171, kernel 4,
// _rmatmul_tw_kernel :188, kernel 5, _zy_fwd_kernel :427, kernel 6, and
// _yz_inv_kernel :452, kernel 8, as two passes each, and _x_c2c_kernel
// :443, kernel 7, as the column kernel). The TPU had only a
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
// - Stockham passes of radix 4, 8 or 16 (the schedule of fft_plan in
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

// Each radix in 5 bits, pass 0 in the lowest: what the wrapper passes,
// from fft_plan(n, inverse).schedule (the mixed-radix kernel reads its
// radices from the same packing, and the rows of a batch above them:
// ops/hopper_fft.mixed_schedule, mixed_plan).
__host__ __device__ constexpr int packed_schedule(int L) {
  int s = 0;
  for (int p = num_passes(L) - 1; p >= 0; --p)
    s = s * 32 + (1 << pass_bits(L, p));
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

__host__ __device__ constexpr int log2_of(int n) {
  return n <= 1 ? 0 : 1 + log2_of(n / 2);
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

// bytes (a multiple of 4) from global src to shared dst, both 16-byte
// aligned, counted in to bar, by the one issuing thread: the largest
// multiple of 16 by one bulk copy, the last 4 to 12 bytes (where rows of
// an odd length end a batch off a 16-byte boundary) by plain loads before
// its arrive on bar, which releases those stores to the threads that wait
// on it.
__device__ __forceinline__ void bulk_load_tail(void* dst, const void* src,
                                               uint32_t bytes, uint64_t* bar) {
  const uint32_t whole = bytes & ~15u;
  for (uint32_t o = whole; o < bytes; o += 4)
    *reinterpret_cast<float*>(static_cast<unsigned char*>(dst) + o) =
        __ldg(reinterpret_cast<const float*>(
            static_cast<const unsigned char*>(src) + o));
  mbar_expect_tx(bar, whole);
  if (whole) bulk_load(dst, src, whole, bar);
}

// Arrive on bar once every cp.async this thread has issued has landed.
__device__ __forceinline__ void arrive_when_copied(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// ---------------------------------------------------------------------------
// What every persistent kernel of the engine does first and how it is
// launched.
// ---------------------------------------------------------------------------

// All NT threads of the block: (2, entries) float32 planes from global src
// to shared re, im.
template <int NT>
__device__ __forceinline__ void load_planes(const float* src, int entries,
                                            float* re, float* im) {
  for (int i = threadIdx.x; i < entries; i += NT) {
    re[i] = src[i];
    im[i] = src[entries + i];
  }
}

// Thread 0: the ring's stages barriers at full, each completing after
// arrivals arrives. The block syncs before it uses them.
__device__ __forceinline__ void init_ring(uint64_t* full, int stages,
                                          uint32_t arrivals) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(&full[s], arrivals);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
}

// Launch kernel(args...) on a persistent grid of blocks of threads threads
// and smem bytes of dynamic shared memory: as many blocks as the card holds
// at once, at most nb (the batches they walk, nb >= 1).
template <class K, class... A>
cudaError_t launch_persistent(K kernel, int threads, size_t smem, long long nb,
                              cudaStream_t stream, A... args) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  if (nb < 1 || nb > 0x7fffffffLL) return cudaErrorInvalidValue;
  const long long most = (long long)sms * per_sm;
  kernel<<<(int)(nb < most ? nb : most), threads, smem, stream>>>(args...);
  return cudaGetLastError();
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
  load_planes<THREADS>(table, G::TABLE, wr, wi);
  init_ring(full, STAGES, ISSUERS);
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
  return launch_persistent(fft_rows_kernel<L, Body>, THREADS,
                           smem_bytes<L, Body>(), body.template batches<L>(),
                           stream, body, table, inverse);
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
// The mixed-radix kernel: the engine on rows of any length n <= MIXED_MAX
// whose factors are radices it has: the 13-smooth lengths 2^a 3^b 5^c 7^d
// 11^e 13^f that are not powers of two (ops/hopper_fft.MIXED_LENGTHS: 9
// .. 507, 155 of them), and the powers of two of kernel 6's passes that
// run beside them. Its Bodies: complex rows (ComplexTwiddleRows: kernel 2,
// kernel 4 with the twiddle, the y passes of kernels 6 and 8), real rows
// two to a complex row (stage.cu's RealRows and RealTwiddleRows: kernels
// 1 and 5; fused3d.cu's ZRows: kernel 6's z pass), half spectra two to
// a complex row (stage.cu's HalfRows and fused3d.cu's YZRows, kernel 8's z
// pass gathering them by every thread's cp.async, both with RealPairsOut's
// store: kernels 3 and 8) and one half spectrum of m + 1 bins packed as a
// complex row of m points (stage.cu's PackedHalfRows, kernel 3's packed
// body, with ComplexTwiddleRows' store).
//
// The power-of-two kernel gives every thread the same RMAX points of one
// row in every pass: T = n / RMAX threads a row, RMAX / r butterflies of a
// radix-r pass, THREADS / T rows a batch. With a factor of 3 or 5 that
// cannot hold (at 480 = 12 x 10 x 4, T = 40 threads a row divide neither
// the 256 threads nor the 48 butterflies of the radix-10 pass). So this
// kernel deals each pass's butterflies out over the whole block: a batch
// is `rows` rows (points = rows n <= MIXED_POINTS, even), and the rows n /
// r butterflies of a radix-r pass go to the THREADS threads round by
// round, butterfly u = tid + q THREADS in round q. A pass reads one pair
// of work planes and writes the other (the first reads the ring buffer),
// so a butterfly's points leave the registers as soon as it is done and a
// pass needs one barrier, not two. The last round's lanes past the
// butterflies idle; the host (ops/hopper_fft._batch_rows) picks the row
// count that idles the fewest lane slots and packs it into the schedule
// (mixed_plan): 0 to 42% of them, 18% on average over the 155 lengths
// (ops/hopper_fft.mixed_geometry), 17% at 480, 25% at 416, 22% at 440.
// - n, rows and the radices are runtime values (MixedPlan), so one
//   instantiation a Body serves every length and the build grows by one
//   kernel a Body, not one a length: each pass dispatches on its radix
//   (with_radix) to an unrolled register network with compile-time
//   constants (dft_small): the radix-2 network (dft_regs) for 2, 4, 8 and
//   16, the odd prime butterflies (dft3, dft5, dft7, dft11, dft13), and 6,
//   9, 10, 12, 14 and 15 as two of those with their twiddles between them
//   (dft_ct). No composite holds 11 or 13: every 13-smooth length up to
//   MIXED_MAX already takes at most three passes.
// - The rest is the power-of-two kernel's: a persistent grid, the ring of
//   STAGES buffers filled by bulk copies (a batch of rows of an odd length
//   ends off a 16-byte boundary: its last bytes come by bulk_load_tail) or,
//   for a Body of many small pieces (ISSUERS = THREADS), by every thread's
//   cp.async,
//   Stockham passes through the padded split planes, the twiddle table of
//   fft_plan (the same layout: pass p's block at NS - radix[0]), float32
//   arithmetic, the Body's epilogue. A batch holds at most MIXED_POINTS =
//   2560 points: a 20 KB buffer of complex64 (stage_bytes(g) = 8 points;
//   kernel 3's half spectra take 16 rows (n/2 + 1), up to 16 bytes a row
//   more), at most MIXED_SMEM bytes a block with the table and the two
//   pairs of planes, so that two blocks share an SM. launch_mixed refuses
//   a plan past it; the host (ops/hopper_fft._batch_rows) caps kernel 3's
//   rows where its larger buffers would pass it (the shortest rows: 256
//   rows of 10 points).
// - Bound by bytes, as the power-of-two kernel. The index arithmetic on a
//   runtime n walks each thread's butterflies by additions (DivWalk: its
//   divisions once a pass), and the idle lanes cost issue slots, not
//   bytes.
// ---------------------------------------------------------------------------

constexpr int MIXED_MAX = 512;      // longest row
constexpr int MIXED_POINTS = 2560;  // most points a batch
constexpr int MIXED_PASSES = 4;     // most passes
constexpr int MIXED_ROWS_SHIFT = 20;  // the schedule's rows field
// Most shared memory a block: two blocks an SM of an H100 (233,472 bytes an
// SM, 1,024 of them reserved a block).
constexpr int MIXED_SMEM = 115712;
static_assert(MIXED_ROWS_SHIFT == 5 * MIXED_PASSES, "past the radices");

// The plan of a launch: built on the host by mixed_plan from the packed
// schedule, passed by value.
struct MixedPlan {
  int n;                     // points a row
  int passes;
  int radix[MIXED_PASSES];   // pass p's radix, 1 past the last pass
  int rows;                  // rows a batch
  int points;                // rows n, even (16-byte aligned batches)
  int padded;                // floats of a work plane: points + points / 32
  int tld;                   // floats of a table plane: n - radix[0],
                             // rounded up to 4 (16-byte aligned buffers)
};

inline bool mixed_radix(int r) {
  switch (r) {
    case 2: case 3: case 4: case 5: case 6: case 7: case 8: case 9:
    case 10: case 11: case 12: case 13: case 14: case 15: case 16:
      return true;
    default: return false;
  }
}

// The radices of a packed schedule's low MIXED_ROWS_SHIFT bits into radix
// (1 past the last pass) and passes: false unless they are the kernel's,
// at most MIXED_PASSES of them, and multiply to n.
inline bool unpack_radices(int n, int schedule, int (&radix)[MIXED_PASSES],
                           int& passes) {
  int p = 0, prod = 1;
  for (int s = schedule & ((1 << MIXED_ROWS_SHIFT) - 1); s != 0;
       s >>= 5, ++p) {
    if (p == MIXED_PASSES || !mixed_radix(s & 31)) return false;
    radix[p] = s & 31;
    prod *= s & 31;
  }
  passes = p;
  for (int q = p; q < MIXED_PASSES; ++q) radix[q] = 1;
  return prod == n;
}

// The plan on rows of n points from the packed schedule (fft_plan(n,
// inverse).schedule: the radix of pass p in bits 5p .. 5p + 4, the rows of
// a batch from bit MIXED_ROWS_SHIFT on, both chosen on the host:
// ops/hopper_fft.mixed_schedule); false unless its radices are the kernel's and
// multiply to n in [8, MIXED_MAX] and its batch of rows n points is even
// and at most MIXED_POINTS.
inline bool mixed_plan(int n, int schedule, MixedPlan& g) {
  if (n < 8 || n > MIXED_MAX || schedule <= 0) return false;
  const int rows = schedule >> MIXED_ROWS_SHIFT;
  if (rows < 1 || rows * n > MIXED_POINTS || rows * n % 2) return false;
  if (!unpack_radices(n, schedule, g.radix, g.passes)) return false;
  g.n = n;
  g.rows = rows;
  g.points = g.rows * n;
  g.padded = g.points + g.points / 32;
  g.tld = (n - g.radix[0] + 3) & ~3;
  return true;
}

template <int R>
struct Radix {
  static constexpr int value = R;
};

// f(Radix<r>()) for a runtime radix r of the kernel's.
template <class F>
__device__ __forceinline__ void with_radix(int r, F&& f) {
  switch (r) {
    case 2: f(Radix<2>()); break;
    case 3: f(Radix<3>()); break;
    case 4: f(Radix<4>()); break;
    case 5: f(Radix<5>()); break;
    case 6: f(Radix<6>()); break;
    case 7: f(Radix<7>()); break;
    case 8: f(Radix<8>()); break;
    case 9: f(Radix<9>()); break;
    case 10: f(Radix<10>()); break;
    case 11: f(Radix<11>()); break;
    case 12: f(Radix<12>()); break;
    case 13: f(Radix<13>()); break;
    case 14: f(Radix<14>()); break;
    case 15: f(Radix<15>()); break;
    case 16: f(Radix<16>()); break;
    default: break;  // mixed_plan admits no other
  }
}

// f(Radix<I>()), f(Radix<I + 1>()), ..., f(Radix<N - 1>()).
template <int I, int N, class F>
__device__ __forceinline__ void static_for(F&& f) {
  if constexpr (I < N) {
    f(Radix<I>());
    static_for<I + 1, N>(f);
  }
}

// cos and sin of t by their series, for the compile-time roots below.
__host__ __device__ constexpr double series_cos(double t) {
  double term = 1.0, sum = 1.0;
  for (int k = 1; k < 30; ++k) {
    term *= -t * t / ((2 * k - 1) * (2 * k));
    sum += term;
  }
  return sum;
}

__host__ __device__ constexpr double series_sin(double t) {
  double term = t, sum = t;
  for (int k = 1; k < 30; ++k) {
    term *= -t * t / ((2 * k) * (2 * k + 1));
    sum += term;
  }
  return sum;
}

// cos and sin of 2 pi M / R, float32 constants rounded from float64.
template <int R, int M>
struct Root {
  static constexpr double x = 2.0 * (M % R) / R;  // in [0, 2)
  static constexpr double t = 3.14159265358979323846 * (x > 1.0 ? x - 2.0 : x);
  static constexpr float c = static_cast<float>(series_cos(t));
  static constexpr float s = static_cast<float>(series_sin(t));
};

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}

// In-place 3-point DFT, exp(sgn 2 pi i jk / 3).
__device__ __forceinline__ void dft3(float2* a, float sgn) {
  constexpr float S3 = 0.86602540378443864676f;  // sin 2 pi / 3
  const float2 t1 = cadd(a[1], a[2]), d = csub(a[1], a[2]);
  const float2 t2 = make_float2(a[0].x - 0.5f * t1.x, a[0].y - 0.5f * t1.y);
  const float2 r = make_float2(-sgn * S3 * d.y, sgn * S3 * d.x);
  a[0] = cadd(a[0], t1);
  a[1] = cadd(t2, r);
  a[2] = csub(t2, r);
}

// In-place DFT of an odd prime R, exp(sgn 2 pi i jk / R): the pairs b_k =
// a_k + a_(R-k) and d_k = a_k - a_(R-k), k = 1 .. H = (R - 1) / 2, then
// for m = 1 .. H the real combination u_m = a0 + sum_k cos(2 pi mk / R)
// b_k and the imaginary one w_m = sum_k sin(2 pi mk / R) d_k, bins m and
// R - m being u_m +- i sgn w_m. c[j - 1], s[j - 1]: cos and sin of 2 pi j
// / R, j = 1 .. H (mk folds onto them), float32 constants rounded from
// float64. The bins are formed one pair (m, R - m) at a time, so only the
// pairs, a0 and one (u, w) stay live (radix 13: 26 floats of pairs
// against radix 16's 32 points).
template <int R>
__device__ __forceinline__ void dft_odd(float2* a, float sgn,
                                        const float (&c)[R / 2],
                                        const float (&s)[R / 2]) {
  constexpr int H = R / 2;
  float2 b[H], d[H];
#pragma unroll
  for (int k = 1; k <= H; ++k) {
    b[k - 1] = cadd(a[k], a[R - k]);
    d[k - 1] = csub(a[k], a[R - k]);
  }
  const float2 a0 = a[0];
  float2 sum = a0;
#pragma unroll
  for (int k = 0; k < H; ++k) sum = cadd(sum, b[k]);
  a[0] = sum;
#pragma unroll
  for (int m = 1; m <= H; ++m) {
    float2 u = a0, w = make_float2(0.f, 0.f);
#pragma unroll
    for (int k = 1; k <= H; ++k) {
      const int j = m * k % R;  // cos and sin of 2 pi j / R
      const float cj = j <= H ? c[j - 1] : c[R - j - 1];
      const float sj = j <= H ? s[j - 1] : -s[R - j - 1];
      u.x += cj * b[k - 1].x;
      u.y += cj * b[k - 1].y;
      w.x += sj * d[k - 1].x;
      w.y += sj * d[k - 1].y;
    }
    const float2 v = make_float2(-sgn * w.y, sgn * w.x);  // i sgn w_m
    a[m] = cadd(u, v);
    a[R - m] = csub(u, v);
  }
}

// In-place 5-point DFT, exp(sgn 2 pi i jk / 5) (dft_odd).
__device__ __forceinline__ void dft5(float2* a, float sgn) {
  constexpr float C1 = 0.30901699437494742410f;   // cos 2 pi / 5
  constexpr float C2 = -0.80901699437494742410f;  // cos 4 pi / 5
  constexpr float S1 = 0.95105651629515357212f;   // sin 2 pi / 5
  constexpr float S2 = 0.58778525229247312917f;   // sin 4 pi / 5
  const float c[2] = {C1, C2};
  const float s[2] = {S1, S2};
  dft_odd<5>(a, sgn, c, s);
}

// In-place 7-point DFT, exp(sgn 2 pi i jk / 7) (dft_odd).
__device__ __forceinline__ void dft7(float2* a, float sgn) {
  constexpr float C1 = 0.62348980185873353053f;   // cos 2 pi / 7
  constexpr float C2 = -0.22252093395631440429f;  // cos 4 pi / 7
  constexpr float C3 = -0.90096886790241912624f;  // cos 6 pi / 7
  constexpr float S1 = 0.78183148246802980871f;   // sin 2 pi / 7
  constexpr float S2 = 0.97492791218182360702f;   // sin 4 pi / 7
  constexpr float S3 = 0.43388373911755812048f;   // sin 6 pi / 7
  const float c[3] = {C1, C2, C3};
  const float s[3] = {S1, S2, S3};
  dft_odd<7>(a, sgn, c, s);
}

// In-place 11-point DFT, exp(sgn 2 pi i jk / 11) (dft_odd).
__device__ __forceinline__ void dft11(float2* a, float sgn) {
  constexpr float C1 = 0.84125353283118116886f;   // cos 2 pi / 11
  constexpr float C2 = 0.41541501300188642553f;   // cos 4 pi / 11
  constexpr float C3 = -0.14231483827328514044f;  // cos 6 pi / 11
  constexpr float C4 = -0.65486073394528506406f;  // cos 8 pi / 11
  constexpr float C5 = -0.95949297361449738989f;  // cos 10 pi / 11
  constexpr float S1 = 0.54064081745559758211f;   // sin 2 pi / 11
  constexpr float S2 = 0.90963199535451837141f;   // sin 4 pi / 11
  constexpr float S3 = 0.98982144188093273238f;   // sin 6 pi / 11
  constexpr float S4 = 0.75574957435425828377f;   // sin 8 pi / 11
  constexpr float S5 = 0.28173255684142969771f;   // sin 10 pi / 11
  const float c[5] = {C1, C2, C3, C4, C5};
  const float s[5] = {S1, S2, S3, S4, S5};
  dft_odd<11>(a, sgn, c, s);
}

// In-place 13-point DFT, exp(sgn 2 pi i jk / 13) (dft_odd).
__device__ __forceinline__ void dft13(float2* a, float sgn) {
  constexpr float C1 = 0.88545602565320989590f;   // cos 2 pi / 13
  constexpr float C2 = 0.56806474673115580251f;   // cos 4 pi / 13
  constexpr float C3 = 0.12053668025532305335f;   // cos 6 pi / 13
  constexpr float C4 = -0.35460488704253562597f;  // cos 8 pi / 13
  constexpr float C5 = -0.74851074817110109863f;  // cos 10 pi / 13
  constexpr float C6 = -0.97094181742605202716f;  // cos 12 pi / 13
  constexpr float S1 = 0.46472317204376854566f;   // sin 2 pi / 13
  constexpr float S2 = 0.82298386589365639458f;   // sin 4 pi / 13
  constexpr float S3 = 0.99270887409805399280f;   // sin 6 pi / 13
  constexpr float S4 = 0.93501624268541482344f;   // sin 8 pi / 13
  constexpr float S5 = 0.66312265824079520238f;   // sin 10 pi / 13
  constexpr float S6 = 0.23931566428755776715f;   // sin 12 pi / 13
  const float c[6] = {C1, C2, C3, C4, C5, C6};
  const float s[6] = {S1, S2, S3, S4, S5, S6};
  dft_odd<13>(a, sgn, c, s);
}

template <int R>
__device__ __forceinline__ void dft_small(float2* a, float sgn);

// In-place DFT of R = P Q points: the P-point DFTs of a[Q j1 + j2] over j1,
// the twiddles exp(sgn 2 pi i j2 k1 / R), the Q-point DFTs over j2; bin k1
// + P k2 out.
template <int P, int Q>
__device__ __forceinline__ void dft_ct(float2* a, float sgn) {
  float2 t[P * Q];  // t[k1 Q + j2]
#pragma unroll
  for (int j2 = 0; j2 < Q; ++j2) {
    float2 c[P];
#pragma unroll
    for (int j1 = 0; j1 < P; ++j1) c[j1] = a[Q * j1 + j2];
    dft_small<P>(c, sgn);
#pragma unroll
    for (int k1 = 0; k1 < P; ++k1) t[k1 * Q + j2] = c[k1];
  }
  static_for<1, Q>([&](auto J2) {
    static_for<1, P>([&](auto K1) {
      constexpr int j2 = decltype(J2)::value, k1 = decltype(K1)::value;
      using W = Root<P * Q, j2 * k1>;
      t[k1 * Q + j2] = cmul(t[k1 * Q + j2], make_float2(W::c, sgn * W::s));
    });
  });
#pragma unroll
  for (int k1 = 0; k1 < P; ++k1) {
    dft_small<Q>(t + k1 * Q, sgn);
#pragma unroll
    for (int k2 = 0; k2 < Q; ++k2) a[k1 + P * k2] = t[k1 * Q + k2];
  }
}

// In-place DFT of R points in registers, exp(sgn 2 pi i jk / R), for every
// radix of the mixed-radix kernel (ops/hopper_fft._dft_small_mirror).
template <int R>
__device__ __forceinline__ void dft_small(float2* a, float sgn) {
  if constexpr ((R & (R - 1)) == 0) {
    dft_regs<log2_of(R)>(a, sgn);
  } else if constexpr (R == 3) {
    dft3(a, sgn);
  } else if constexpr (R == 5) {
    dft5(a, sgn);
  } else if constexpr (R == 7) {
    dft7(a, sgn);
  } else if constexpr (R == 11) {
    dft11(a, sgn);
  } else if constexpr (R == 13) {
    dft13(a, sgn);
  } else if constexpr (R == 6) {
    dft_ct<2, 3>(a, sgn);
  } else if constexpr (R == 9) {
    dft_ct<3, 3>(a, sgn);
  } else if constexpr (R == 10) {
    dft_ct<2, 5>(a, sgn);
  } else if constexpr (R == 12) {
    dft_ct<4, 3>(a, sgn);
  } else if constexpr (R == 14) {
    dft_ct<2, 7>(a, sgn);
  } else {
    static_assert(R == 15, "not a radix of the mixed-radix kernel");
    dft_ct<3, 5>(a, sgn);
  }
}

// (q, r) = divmod(e, d) for e = e0, e0 + step, e0 + 2 step, ...: the
// divisions at the start only.
struct DivWalk {
  int q, r, dq, dr, d;
  __device__ DivWalk(int e0, int d_, int step)
      : q(e0 / d_), r(e0 % d_), dq(step / d_), dr(step % d_), d(d_) {}
  __device__ void next() {
    q += dq;
    r += dr;
    if (r >= d) {
      r -= d;
      ++q;
    }
  }
};

// One radix-R pass of a batch of points = rows n points, NS the product
// of the radices before it and r0 the first, into the work planes (re,
// im): butterfly u = (row, j), u = tid + q THREADS, takes points j + m n /
// R of its row from load(row, i), twiddled by the table's [m - 1][k] of
// the pass (at NS - r0), k = j mod NS, when NS > 1, runs the R-point DFT
// and writes output m to point (j - k) R + k + m NS of its row (Stockham
// order, as store_pass). Everything it indexes by is a register: no
// stack copy of the plan for the planes' stores to alias.
template <int R, class Load>
__device__ __forceinline__ void mixed_pass(int n, int points, int r0, int ns,
                                           float* __restrict__ re,
                                           float* __restrict__ im,
                                           const float* __restrict__ wr,
                                           const float* __restrict__ wi,
                                           float sgn, Load load) {
  const int S = n / R, B = points / R, off = ns - r0;
  DivWalk w(threadIdx.x, S, THREADS);  // (row, j) of butterfly u
  // k = j mod NS: S is a multiple of NS, so k steps by dr mod NS.
  int k = w.r % ns;
  const int dk = w.dr % ns;
  for (int u = threadIdx.x; u < B; u += THREADS) {
    float2 a[R];
#pragma unroll
    for (int m = 0; m < R; ++m) a[m] = load(w.q, w.r + m * S);
    if (ns > 1) {
#pragma unroll
      for (int m = 1; m < R; ++m) {
        const int t = off + (m - 1) * ns + k;
        a[m] = cmul(a[m], make_float2(wr[t], wi[t]));
      }
    }
    dft_small<R>(a, sgn);
    const int o = w.q * n + (w.r - k) * R + k;
#pragma unroll
    for (int m = 0; m < R; ++m) {
      const int i = pad(o + m * ns);
      re[i] = a[m].x;
      im[i] = a[m].y;
    }
    w.next();
    k += dk;
    if (k >= ns) k -= ns;
  }
}

// The kernel. Body gives, besides its power-of-two methods, the same ones
// on a MixedPlan, and ISSUERS as the power-of-two kernel reads it (one
// thread, a bulk copy and its expect_tx; or every thread, cp.async pieces,
// each arriving once on the buffer's barrier):
//   batches(g)                     number of row batches
//   stage_bytes(g)                 bytes of one input buffer, a multiple
//                                  of 16
//   issue(g, buffer, b, bar)       the copies of batch b
//   load(g, buffer, b, row, i)     point i of the batch's complex row
//   store(g, re, im, b)            the epilogue, all threads
// Pass p writes work planes p mod 2; a barrier ends each pass, and one
// after the epilogue lets the next batch's first pass write. The passes
// are unrolled over MIXED_PASSES, so the plan's fields are read at fixed
// offsets and never copied to the stack.
template <class Body>
__global__ void __launch_bounds__(THREADS, 2)
fft_mixed_kernel(const Body body, const MixedPlan g,
                 const float* __restrict__ table, int inverse) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int ISSUERS = Body::ISSUERS;
  static_assert(ISSUERS == 1 || ISSUERS == THREADS, "one thread or all");
  const int n = g.n, points = g.points, r0 = g.radix[0];
  const int SB = body.stage_bytes(g);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  float* wr = reinterpret_cast<float*>(smem + 128);
  float* wi = wr + g.tld;
  unsigned char* stages = reinterpret_cast<unsigned char*>(wi + g.tld);
  // Work planes 0 and 1: (re, im) each, one plane pair after the other.
  float* planes = reinterpret_cast<float*>(stages + STAGES * SB);
  const int pair = 2 * g.padded;

  const int tid = threadIdx.x;
  const bool issuer = ISSUERS == 1 ? tid == 0 : true;
  const int nb = (int)body.batches(g);
  load_planes<THREADS>(table, n - r0, wr, wi);
  init_ring(full, STAGES, ISSUERS);
  __syncthreads();
  if (issuer) {
    for (int s = 0; s < STAGES; ++s) {
      const int b = blockIdx.x + s * gridDim.x;
      if (b < nb) body.issue(g, stages + s * SB, b, &full[s]);
    }
  }

  const float sgn = inverse ? 1.f : -1.f;
  int it = 0;
  for (int b = blockIdx.x; b < nb; b += gridDim.x, ++it) {
    const int s = it % STAGES;
    unsigned char* buf = stages + s * SB;
    mbar_wait(&full[s], (it / STAGES) & 1);
    with_radix(r0, [&](auto R) {
      mixed_pass<decltype(R)::value>(
          n, points, r0, 1, planes, planes + g.padded, wr, wi, sgn,
          [&body, &g, buf, b](int row, int i) {
            return body.load(g, buf, b, row, i);
          });
    });
    __syncthreads();
    // Every thread has read buffer s: refill it with the batch STAGES
    // steps ahead.
    const int next = b + STAGES * gridDim.x;
    if (issuer && next < nb) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      body.issue(g, buf, next, &full[s]);
    }
    int ns = r0;
#pragma unroll
    for (int p = 1; p < MIXED_PASSES; ++p) {
      if (p < g.passes) {
        const float* sr = planes + ((p - 1) & 1) * pair;
        const float* si = sr + g.padded;
        float* dr = planes + (p & 1) * pair;
        with_radix(g.radix[p], [&](auto R) {
          mixed_pass<decltype(R)::value>(
              n, points, r0, ns, dr, dr + g.padded, wr, wi, sgn,
              [sr, si, n](int row, int i) {
                const int x = pad(row * n + i);
                return make_float2(sr[x], si[x]);
              });
        });
        __syncthreads();
        ns *= g.radix[p];
      }
    }
    const float* fr = planes + ((g.passes - 1) & 1) * pair;
    body.store(g, fr, fr + g.padded, b);
    __syncthreads();
  }
}

// The mixed-radix kernel's shared memory a block on plan g with input
// buffers of stage bytes (ops/hopper_fft.mixed_smem).
__host__ __device__ inline size_t mixed_smem(const MixedPlan& g, int stage) {
  return 128 + 8 * (size_t)g.tld + STAGES * (size_t)stage +
         16 * (size_t)g.padded;
}

// Launch the mixed-radix kernel on rows of n points; table, schedule:
// ops/hopper_fft.fft_plan(n, inverse)'s, the rows of a batch
// ops/hopper_fft.mixed_schedule's (at most MIXED_SMEM bytes a block).
template <class Body>
cudaError_t launch_mixed(int n, int schedule, const Body& body,
                         const float* table, int inverse,
                         cudaStream_t stream) {
  MixedPlan g;
  if (!mixed_plan(n, schedule, g)) return cudaErrorInvalidValue;
  const size_t smem = mixed_smem(g, body.stage_bytes(g));
  if (smem > MIXED_SMEM) return cudaErrorInvalidValue;
  return launch_persistent(fft_mixed_kernel<Body>, THREADS, smem,
                           body.batches(g), stream, body, g, table, inverse);
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

  // The same on the mixed-radix kernel (g.rows rows a batch, n = g.n).
  __host__ __device__ long long batches(const MixedPlan& g) const {
    return ((long long)M + g.rows - 1) / g.rows;
  }
  __host__ __device__ static int stage_bytes(const MixedPlan& g) {
    return 8 * g.points;
  }
  __device__ int rows_in(const MixedPlan& g, int b) const {
    const int left = M - b * g.rows;
    return left < g.rows ? left : g.rows;
  }
  __device__ void issue(const MixedPlan& g, unsigned char* buf, int b,
                        uint64_t* bar) const {
    bulk_load_tail(buf, x + (size_t)b * 2 * g.points,
                   8u * rows_in(g, b) * g.n, bar);
  }
  __device__ float2 load(const MixedPlan& g, const unsigned char* buf, int,
                         int row, int i) const {
    return reinterpret_cast<const float2*>(buf)[row * g.n + i];
  }
  // Two neighbouring points a thread, of one row or across two, as one
  // 16-byte store (rows are even a batch, so every batch starts 16-byte
  // aligned); an odd last point as 8 bytes.
  __device__ void store(const MixedPlan& g, const float* re, const float* im,
                        int b) const {
    const int n = g.n, count = rows_in(g, b) * n, row0 = b * g.rows;
    float* o = out + (size_t)b * g.points * 2;
    DivWalk w(2 * threadIdx.x, n, 2 * THREADS);  // (row, point) of e
    // The twiddle row (row0 + w.q) mod n1, stepped with w.
    int rq = TW ? (row0 + w.q) % n1 : 0;
    const int dq1 = TW ? w.dq % n1 : 0;
    for (int e = 2 * threadIdx.x; e < count; e += 2 * THREADS) {
      const int i = pad(e);  // e even: e + 1 pads to i + 1
      float v[4] = {re[i], im[i], re[i + 1], im[i + 1]};
      if constexpr (TW) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const bool next_row = w.r + h == n;  // an odd n's pair
          const int row = !next_row ? rq : rq + 1 < n1 ? rq + 1 : 0;
          const size_t t = (size_t)row * n + (next_row ? 0 : w.r + h);
          const float wr = __ldg(tr + t), wi = __ldg(ti + t);
          const float xr = v[2 * h], xi = v[2 * h + 1];
          v[2 * h] = xr * wr - xi * wi;
          v[2 * h + 1] = xr * wi + xi * wr;
        }
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

// ---------------------------------------------------------------------------
// The two halves of a C2R Body, shared by stage.cu (kernel 3, HalfRows) and
// fused3d.cu (kernel 8's z pass, YZRows). Half spectra A and B (n/2 + 1
// bins each) of two real rows are packed as one complex row Z = A + iB,
// extended by Hermitian symmetry; its unnormalized inverse DFT is a + ib,
// a and b the two real rows. Each Body gives issue and load; this gives
// the packing and the epilogue.
// ---------------------------------------------------------------------------

// Point i of Z from bin k of A and bin k of B, k = i for i <= n/2, else
// n - i (then conjugated). The imaginary parts of the DC bin and, for an
// even n, of the Nyquist bin n/2 are dropped: the C2R ignores them
// (mxu_fft._c2r_np's CI rows 0 and n/2 are sin 0 and sin pi j), and in the
// packed pair they would leak into the partner row. An odd n has no
// Nyquist bin: its last bin (n - 1)/2 is an ordinary one, whose imaginary
// part counts (its CI row is 2 sin(2 pi j (n - 1)/2n)).
__device__ __forceinline__ float2 hermitian_pair(int n, float2 a, float2 b,
                                                 int i) {
  if (i == 0 || 2 * i == n) {
    a.y = 0.f;
    b.y = 0.f;
  } else if (2 * i > n) {
    a.y = -a.y;
    b.y = -b.y;
  }
  return make_float2(a.x - b.y, a.y + b.x);
}

template <int L>
__device__ __forceinline__ float2 hermitian_pair(float2 a, float2 b, int i) {
  return hermitian_pair(1 << L, a, b, i);
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

  // The same on the mixed-radix kernel (2 g.rows real rows a batch, n =
  // g.n any length): the batch's rows_in n floats are one contiguous span
  // from 8 g.points b bytes on (16-byte aligned, g.points being even),
  // walked four floats a thread, each float4 store possibly across a row
  // end (n >= 9, so across one at most); a tail of 1 to 3 floats (n or
  // rows_in odd) by single stores. Float e of the span is point i of real
  // row q, (q, i) = divmod(e, n), which reads plane q & 1 at work row q /
  // 2.
  __host__ __device__ long long batches(const MixedPlan& g) const {
    const int r2 = 2 * g.rows;
    return ((long long)M + r2 - 1) / r2;
  }
  __device__ int rows_in(const MixedPlan& g, int b) const {
    const int r2 = 2 * g.rows, left = M - b * r2;
    return left < r2 ? left : r2;
  }
  __device__ void store(const MixedPlan& g, const float* re, const float* im,
                        int b) const {
    const int n = g.n, count = rows_in(g, b) * n;
    float* o = out + (size_t)b * 2 * g.points;
    DivWalk w(4 * threadIdx.x, n, 4 * THREADS);  // (row, point) of e
    for (int e = 4 * threadIdx.x; e < count; e += 4 * THREADS, w.next()) {
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      int q = w.q, i = w.r;
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        if (e + h < count)
          v[h] = ((q & 1) ? im : re)[pad((q >> 1) * n + i)];
        if (++i == n) {
          i = 0;
          ++q;
        }
      }
      if (e + 4 <= count) {
        reinterpret_cast<float4*>(o)[e / 4] = make_float4(v[0], v[1], v[2],
                                                          v[3]);
      } else {
#pragma unroll
        for (int h = 0; h < 3; ++h)
          if (e + h < count) o[e + h] = v[h];
      }
    }
  }
};

inline bool misaligned(const void* p, uintptr_t to = 16) {
  return (reinterpret_cast<uintptr_t>(p) & (to - 1)) != 0;
}

// ---------------------------------------------------------------------------
// The column kernel: the engine's passes on W columns of an (outer, n, inner)
// array at once, each column an n-point C2C whose points lie inner elements
// apart (fused3d.cu, kernel 7; stage.cu, kernel 2 on a non-last axis).
//
// A batch is W consecutive columns (o, c0 .. c0 + W) of one outer index o,
// each of its n point-rows a strip of W contiguous elements. The row
// kernel's batch of ROWS rows would make that strip 4 columns at n = 512,
// 32 bytes of complex64, and narrow strips are what set the pace of a
// store (csrc/probes/store_strips.cu, PERF.md section 6). So the column
// kernel has its own geometry: COL_THREADS threads a block, PT = 16 points
// a thread (PT / r butterflies of each radix-r pass), W = COL_THREADS * PT
// / n columns a batch: 16 at n = 512 (128-byte strips of complex64, 64 of
// a float plane), 512 at n <= 16; n = 1024 takes the split kernel below
// (16 columns, each half of their rows in one buffer). A batch is 8 n W = 64 KB (32 at n = 8) as
// complex64, and COL_STAGES of them fill 192 KB of shared memory: one
// block an SM, 16 warps, two batches in flight while one is transformed.
//
// - Loads: every thread cp.asyncs a share of the batch's strips into the
//   buffer, in parts of 16, 8 or 4 bytes, the widest that the strip's start
//   and length allow (a complex64 row of 513 elements is 4104 bytes, so
//   every other row of the 1024^3 y axis starts 8 bytes off a 16-byte
//   boundary: 8-byte parts), and arrives on the buffer's barrier when they
//   have landed. A strip is the columns that exist: the last group of a
//   ragged inner extent is a partial batch, its other columns transformed
//   from stale data and never stored.
// - Work layout: float2 w[i W + c], point i of column c, in the batch's own
//   buffer (the first pass reads the strips, every thread syncs, then
//   writes). Thread t takes column c = t mod W, so a half warp's 16 lanes
//   read or write 16 columns of one point, 128 bytes, without a bank
//   conflict (W >= 16).
// - Epilogue: the strips stored from the buffer in parts as wide as the
//   destination allows; then the buffer is refilled with the batch
//   COL_STAGES steps ahead.
// - The grid is persistent and walks batches column group first, so
//   neighbouring blocks hold neighbouring strips of the same point-rows at
//   the same time and share the 32-byte sectors of a misaligned strip.
// ---------------------------------------------------------------------------

constexpr int COL_THREADS = 512;
constexpr int COL_STAGES = 3;

template <int L>
struct ColGeometry {
  static constexpr int N = 1 << L;
  static constexpr int PT = N < 16 ? N : 16;  // points a thread holds
  static constexpr int T = N / PT;            // threads a column
  static constexpr int W = COL_THREADS / T;   // columns a batch
  static constexpr int POINTS = W * N;        // = COL_THREADS * PT
};

template <int L>
constexpr size_t cols_smem_bytes() {
  return 128 + 8 * Geometry<L>::TABLE + COL_STAGES * 8 * ColGeometry<L>::POINTS;
}

// Write the thread's butterflies of pass P to the work layout (Stockham
// order, as store_pass): output m of butterfly j to point (j - k) r + k +
// m NS, k = j mod NS.
template <int L, int P>
__device__ __forceinline__ void col_store(float2* w, int c, int jl,
                                          const float2* a) {
  using G = ColGeometry<L>;
  constexpr int r = 1 << pass_bits(L, P), NS = 1 << bits_before(L, P);
#pragma unroll
  for (int q = 0; q < G::PT / r; ++q) {
    const int j = jl + q * G::T, k = j & (NS - 1), o = (j - k) * r + k;
#pragma unroll
    for (int m = 0; m < r; ++m) w[(o + m * NS) * G::W + c] = a[q * r + m];
  }
}

// A pass after the first: butterflies j = jl + q T read, twiddled and
// transformed, sync, written, sync.
template <int L, int P>
__device__ __forceinline__ void col_pass(float2* w, int c, int jl,
                                         const float* wr, const float* wi,
                                         float sgn) {
  using G = ColGeometry<L>;
  constexpr int r = 1 << pass_bits(L, P);
  float2 a[G::PT];
#pragma unroll
  for (int q = 0; q < G::PT / r; ++q) {
    const int j = jl + q * G::T;
#pragma unroll
    for (int m = 0; m < r; ++m)
      a[q * r + m] = w[(j + m * (G::N / r)) * G::W + c];
    twiddle_dft<L, P>(a + q * r, j, wr, wi, sgn);
  }
  __syncthreads();
  col_store<L, P>(w, c, jl, a);
  __syncthreads();
}

// cp.async of PS bytes (4, 8 or 16; both addresses PS-aligned) without
// waiting.
template <int PS>
__device__ __forceinline__ void copy_async(void* dst, const void* src) {
  if constexpr (PS == 16)
    copy16_async(dst, src);
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "n"(PS)
                 : "memory");
}

// f(i, k) for every part k < per of every row i < rows, shared among the
// block's threads, neighbouring threads on neighbouring parts.
template <class F>
__device__ __forceinline__ void for_parts(int rows, int per, F f) {
  for (int e = threadIdx.x; e < rows * per; e += COL_THREADS) {
    const int i = e / per;
    f(i, e - i * per);
  }
}

template <int PS>
__device__ __forceinline__ void copy_strips_by(unsigned char* dst,
                                               const unsigned char* src,
                                               size_t pitch, int bytes,
                                               int rows, int spitch) {
  for_parts(rows, bytes / PS, [&](int i, int k) {
    copy_async<PS>(dst + i * spitch + k * PS, src + i * pitch + k * PS);
  });
}

// rows strips of bytes bytes, pitch bytes apart from src, to dst, spitch
// bytes apart: every thread cp.asyncs a share, in the widest parts that
// the strips' starts and length allow.
__device__ __forceinline__ void copy_strips(unsigned char* dst,
                                           const void* src, size_t pitch,
                                           int bytes, int rows, int spitch) {
  const unsigned char* s = static_cast<const unsigned char*>(src);
  const unsigned a =
      static_cast<unsigned>(reinterpret_cast<uintptr_t>(s) | pitch | bytes);
  if (!(a & 15))
    copy_strips_by<16>(dst, s, pitch, bytes, rows, spitch);
  else if (!(a & 7))
    copy_strips_by<8>(dst, s, pitch, bytes, rows, spitch);
  else
    copy_strips_by<4>(dst, s, pitch, bytes, rows, spitch);
}

// The kernel. Body gives the columns' loader and epilogue:
//   batches<L>()               number of batches
//   issue<L>(buffer, b, bar)   every thread: its cp.async parts of batch b,
//                              then its arrive on bar
//   load<L>(buffer, c, i)      point i of column c of the landed batch
//   store<L>(w, b)             the epilogue from the work layout, all threads
template <int L, class Body>
__global__ void __launch_bounds__(COL_THREADS, 1)
fft_cols_kernel(const Body body, const float* __restrict__ table,
                int inverse) {
  using G = ColGeometry<L>;
  constexpr int TABLE = Geometry<L>::TABLE, R0 = Geometry<L>::RMAX;
  constexpr int SB = 8 * G::POINTS;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  float* wr = reinterpret_cast<float*>(smem + 128);
  float* wi = wr + TABLE;
  unsigned char* stages = reinterpret_cast<unsigned char*>(wi + TABLE);

  const int tid = threadIdx.x;
  const int nb = body.template batches<L>();
  load_planes<COL_THREADS>(table, TABLE, wr, wi);
  init_ring(full, COL_STAGES, COL_THREADS);
  __syncthreads();
  for (int s = 0; s < COL_STAGES; ++s) {
    const int b = blockIdx.x + s * gridDim.x;
    if (b < nb) body.template issue<L>(stages + s * SB, b, &full[s]);
  }

  const float sgn = inverse ? 1.f : -1.f;
  const int c = tid % G::W, jl = tid / G::W;
  int it = 0;
  for (int b = blockIdx.x; b < nb; b += gridDim.x, ++it) {
    const int s = it % COL_STAGES;
    unsigned char* buf = stages + s * SB;
    float2* w = reinterpret_cast<float2*>(buf);
    mbar_wait(&full[s], (it / COL_STAGES) & 1);
    float2 a[G::PT];
#pragma unroll
    for (int q = 0; q < G::PT / R0; ++q) {
      const int j = jl + q * G::T;
#pragma unroll
      for (int m = 0; m < R0; ++m)
        a[q * R0 + m] = body.template load<L>(buf, c, j + m * (G::N / R0));
      twiddle_dft<L, 0>(a + q * R0, j, wr, wi, sgn);
    }
    __syncthreads();
    col_store<L, 0>(w, c, jl, a);
    __syncthreads();
    if constexpr (Geometry<L>::PASSES > 1) col_pass<L, 1>(w, c, jl, wr, wi, sgn);
    if constexpr (Geometry<L>::PASSES > 2) col_pass<L, 2>(w, c, jl, wr, wi, sgn);
    body.template store<L>(w, b);
    // Every thread has read buffer s: refill it STAGES batches ahead.
    __syncthreads();
    const int next = b + COL_STAGES * gridDim.x;
    if (next < nb) body.template issue<L>(buf, next, &full[s]);
  }
}

template <int L, class Body>
cudaError_t launch_cols_log2(int schedule, const Body& body,
                             const float* table, int inverse,
                             cudaStream_t stream) {
  if (schedule != packed_schedule(L)) return cudaErrorInvalidValue;
  return launch_persistent(fft_cols_kernel<L, Body>, COL_THREADS,
                           cols_smem_bytes<L>(), body.template batches_ll<L>(),
                           stream, body, table, inverse);
}

// The column Body of kernels 7 and 2: the n-point C2C of every column of an
// (outer, n, inner) array. Its input is interleaved complex64 at in_r (in_i
// null) or split float32 planes in_r, in_i, and so is its output (out_r,
// out_i), which must not overlap the input unless it is the input. A batch
// moves the kernel's point-rows of W columns (ColShape: the power-of-two
// column kernel's ColGeometry<L>, the mixed-radix column kernel's plan):
// all n of them, or (the split kernel at n = 1024) the rows row0 + step *
// i, i < N. The methods on a ColShape are the Body; the ones on L pass
// ColGeometry<L>'s constants to them.
struct ColShape {
  int rows;   // point-rows a batch moves
  int width;  // columns a batch, W
};

struct Columns {
  const float* in_r;
  const float* in_i;
  float* out_r;
  float* out_i;
  int outer;
  int n;
  int inner;

  template <int L>
  __host__ __device__ static constexpr ColShape shape() {
    return ColShape{ColGeometry<L>::N, ColGeometry<L>::W};
  }
  __host__ __device__ int groups(int W) const { return (inner + W - 1) / W; }
  __host__ __device__ long long batches(const ColShape& s) const {
    return (long long)outer * groups(s.width);
  }
  template <int L>
  __host__ __device__ int groups() const {
    return groups(ColGeometry<L>::W);
  }
  template <int L>
  __host__ __device__ long long batches_ll() const {
    return batches(shape<L>());
  }
  template <int L>
  __device__ int batches() const {
    return outer * groups<L>();
  }
  // Batch b: element offset of its first strip (point 0 of column c0 of
  // outer index o, in elements of its array) and its column count.
  __device__ __forceinline__ size_t locate(int W, int b, int& valid) const {
    const int g = groups(W), o = b / g, c0 = (b - o * g) * W;
    valid = inner - c0 < W ? inner - c0 : W;
    return (size_t)o * n * inner + c0;
  }
  // Every thread: its cp.async parts of rows row0 .. row0 + s.rows of
  // batch b, then its arrive on bar.
  __device__ __forceinline__ void issue(const ColShape s, unsigned char* buf,
                                        int b, uint64_t* bar,
                                        int row0 = 0) const {
    int valid;
    const size_t off = locate(s.width, b, valid) + (size_t)row0 * inner;
    if (in_i == nullptr) {
      copy_strips(buf, in_r + 2 * off, 8 * (size_t)inner, 8 * valid, s.rows,
                  8 * s.width);
    } else {
      copy_strips(buf, in_r + off, 4 * (size_t)inner, 4 * valid, s.rows,
                  4 * s.width);
      copy_strips(buf + 4 * s.rows * s.width, in_i + off, 4 * (size_t)inner,
                  4 * valid, s.rows, 4 * s.width);
    }
    arrive_when_copied(bar);
  }
  template <int L>
  __device__ void issue(unsigned char* buf, int b, uint64_t* bar,
                        int row0 = 0) const {
    issue(shape<L>(), buf, b, bar, row0);
  }
  // Point i of column c of the landed batch.
  __device__ __forceinline__ float2 load(const ColShape s,
                                         const unsigned char* buf, int c,
                                         int i) const {
    if (in_i == nullptr)
      return reinterpret_cast<const float2*>(buf)[i * s.width + c];
    const float* p = reinterpret_cast<const float*>(buf);
    return make_float2(p[i * s.width + c],
                       p[s.rows * s.width + i * s.width + c]);
  }
  template <int L>
  __device__ float2 load(const unsigned char* buf, int c, int i) const {
    return load(shape<L>(), buf, c, i);
  }
  // All threads: work row i of batch b to row row0 + step * i.
  __device__ __forceinline__ void store(const ColShape s, const float2* w,
                                        int b, int row0 = 0,
                                        int step = 1) const {
    int valid;
    const size_t off = locate(s.width, b, valid) + (size_t)row0 * inner;
    const size_t pitch = (size_t)step * inner;
    if (out_i == nullptr) {
      store_complex(s, out_r + 2 * off, 2 * pitch, w, valid);
    } else {
      store_plane<0>(s, out_r + off, pitch, w, valid);
      store_plane<1>(s, out_i + off, pitch, w, valid);
    }
  }
  template <int L>
  __device__ void store(const float2* w, int b, int row0 = 0,
                        int step = 1) const {
    store(shape<L>(), w, b, row0, step);
  }

  // valid complex64 columns of every work row to dst, rows pitch floats
  // apart: 16-byte parts of two columns where the rows allow, else 8.
  __device__ __forceinline__ void store_complex(const ColShape s, float* dst,
                                                size_t pitch, const float2* w,
                                                int valid) const {
    const unsigned a = static_cast<unsigned>(
        reinterpret_cast<uintptr_t>(dst) | 4 * pitch | 8 * valid);
    if (!(a & 15)) {
      for_parts(s.rows, valid / 2, [&](int i, int k) {
        *reinterpret_cast<float4*>(dst + i * pitch + 4 * k) =
            reinterpret_cast<const float4*>(w)[(i * s.width) / 2 + k];
      });
    } else {
      for_parts(s.rows, valid, [&](int i, int k) {
        *reinterpret_cast<float2*>(dst + i * pitch + 2 * k) =
            w[i * s.width + k];
      });
    }
  }
  // The real (H = 0) or imaginary (H = 1) parts of valid columns of every
  // work row to the float32 plane dst, rows pitch floats apart: parts of
  // 4, 2 or 1 columns.
  template <int H>
  __device__ __forceinline__ void store_plane(const ColShape s, float* dst,
                                              size_t pitch, const float2* w,
                                              int valid) const {
    const unsigned a = static_cast<unsigned>(
        reinterpret_cast<uintptr_t>(dst) | 4 * pitch | 4 * valid);
    if (!(a & 15))
      store_plane_by<H, 4>(s, dst, pitch, w, valid);
    else if (!(a & 7))
      store_plane_by<H, 2>(s, dst, pitch, w, valid);
    else
      store_plane_by<H, 1>(s, dst, pitch, w, valid);
  }
  template <int H, int K>
  __device__ __forceinline__ void store_plane_by(const ColShape s, float* dst,
                                                 size_t pitch,
                                                 const float2* w,
                                                 int valid) const {
    for_parts(s.rows, valid / K, [&](int i, int k) {
      const float2* p = w + i * s.width + K * k;
      float v[K];
#pragma unroll
      for (int h = 0; h < K; ++h) v[h] = H ? p[h].y : p[h].x;
      float* o = dst + i * pitch + K * k;
      if constexpr (K == 4)
        *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
      else if constexpr (K == 2)
        *reinterpret_cast<float2*>(o) = make_float2(v[0], v[1]);
      else
        *o = v[0];
    });
  }
};

// ---------------------------------------------------------------------------
// The split kernel: columns of n = 1024 points, W = 16 a batch.
//
// The column kernel's batch at 1024 points would hold W = 8 columns in its
// 64 KB buffer, and 64-byte strips cost it 4.65 ms on the 1024^3 x axis
// where 128-byte strips of the same bytes cost 3.26 and a plain copy of
// them 2.84 (csrc/probes/col_strips.cu, PERF.md section 6): the strips,
// not the FFT, set its pace. So at 1024 points a batch is W = 16 columns
// in two buffers of the ring, its halves a (rows 0 .. 512) and b (rows 512
// .. 1024), each loaded as 128-byte strips. A radix-2 split across the
// halves, u_i = a_i + b_i and v_i = (a_i - b_i) w^i, w = exp(-+ 2 pi i /
// 1024), is formed as each thread loads its first pass (a thread reads a_i
// and b_i of the same points of both buffers); the 512-point FFT of u is
// the even bins of the column, that of v the odd ones: the engine's passes
// (fft_plan(512), ColGeometry<9>) on each buffer in turn, u's output k
// stored to row 2 k and v's to row 2 k + 1, 128-byte strips again. The
// ring turns by half batches: a buffer is refilled as soon as its half is
// stored, so one half-batch load stays in flight while a batch is
// transformed.
// ---------------------------------------------------------------------------

constexpr int SPLIT_L = 9;  // each half's FFT: 512 points

constexpr size_t split_smem_bytes() {
  return cols_smem_bytes<SPLIT_L>() + 8 * 512;
}

template <class Body>
__global__ void __launch_bounds__(COL_THREADS, 1)
fft_cols_split_kernel(const Body body, const float* __restrict__ table,
                      const float* __restrict__ split, int inverse) {
  constexpr int L = SPLIT_L;
  using G = ColGeometry<L>;
  constexpr int TABLE = Geometry<L>::TABLE, R0 = Geometry<L>::RMAX;
  constexpr int SB = 8 * G::POINTS;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  float* wr = reinterpret_cast<float*>(smem + 128);
  float* wi = wr + TABLE;
  unsigned char* stages = reinterpret_cast<unsigned char*>(wi + TABLE);
  float* sr = reinterpret_cast<float*>(stages + COL_STAGES * SB);
  float* si = sr + G::N;

  const int tid = threadIdx.x;
  const int nb = body.template batches<L>();
  load_planes<COL_THREADS>(table, TABLE, wr, wi);
  load_planes<COL_THREADS>(split, G::N, sr, si);
  init_ring(full, COL_STAGES, COL_THREADS);
  __syncthreads();
  // Half h of the block's sequence: half h % 2 of its batch h / 2, in
  // buffer h % COL_STAGES.
  auto issue = [&](int h) {
    const int b = blockIdx.x + (h >> 1) * gridDim.x;
    if (b < nb)
      body.template issue<L>(stages + (h % COL_STAGES) * SB, b,
                             &full[h % COL_STAGES], (h & 1) * G::N);
  };
  for (int h = 0; h < COL_STAGES; ++h) issue(h);

  const float sgn = inverse ? 1.f : -1.f;
  const int c = tid % G::W, jl = tid / G::W;
  int h = 0;
  for (int b = blockIdx.x; b < nb; b += gridDim.x, h += 2) {
    unsigned char* bufa = stages + (h % COL_STAGES) * SB;
    unsigned char* bufb = stages + ((h + 1) % COL_STAGES) * SB;
    float2* wa = reinterpret_cast<float2*>(bufa);
    float2* wb = reinterpret_cast<float2*>(bufb);
    mbar_wait(&full[h % COL_STAGES], (h / COL_STAGES) & 1);
    mbar_wait(&full[(h + 1) % COL_STAGES], ((h + 1) / COL_STAGES) & 1);
    float2 u[G::PT], v[G::PT];
#pragma unroll
    for (int q = 0; q < G::PT / R0; ++q) {
      const int j = jl + q * G::T;
#pragma unroll
      for (int m = 0; m < R0; ++m) {
        const int i = j + m * (G::N / R0);
        const float2 x0 = body.template load<L>(bufa, c, i);
        const float2 x1 = body.template load<L>(bufb, c, i);
        u[q * R0 + m] = make_float2(x0.x + x1.x, x0.y + x1.y);
        v[q * R0 + m] = cmul(make_float2(x0.x - x1.x, x0.y - x1.y),
                             make_float2(sr[i], si[i]));
      }
      twiddle_dft<L, 0>(u + q * R0, j, wr, wi, sgn);
      twiddle_dft<L, 0>(v + q * R0, j, wr, wi, sgn);
    }
    __syncthreads();
    col_store<L, 0>(wa, c, jl, u);
    col_store<L, 0>(wb, c, jl, v);
    __syncthreads();
    if constexpr (Geometry<L>::PASSES > 1) col_pass<L, 1>(wa, c, jl, wr, wi, sgn);
    if constexpr (Geometry<L>::PASSES > 2) col_pass<L, 2>(wa, c, jl, wr, wi, sgn);
    body.template store<L>(wa, b, 0, 2);
    __syncthreads();
    issue(h + COL_STAGES);
    if constexpr (Geometry<L>::PASSES > 1) col_pass<L, 1>(wb, c, jl, wr, wi, sgn);
    if constexpr (Geometry<L>::PASSES > 2) col_pass<L, 2>(wb, c, jl, wr, wi, sgn);
    body.template store<L>(wb, b, 1, 2);
    __syncthreads();
    issue(h + 1 + COL_STAGES);
  }
}

// Launch the split kernel on columns of 1024 points; table, schedule: the
// 512-point engine's (ops/hopper_fft.fft_plan(512, inverse)); split: (2,
// 512) float32 planes of w^i.
template <class Body>
cudaError_t launch_cols_split(int schedule, const Body& body,
                              const float* table, const float* split,
                              int inverse, cudaStream_t stream) {
  if (schedule != packed_schedule(SPLIT_L) || split == nullptr)
    return cudaErrorInvalidValue;
  return launch_persistent(fft_cols_split_kernel<Body>, COL_THREADS,
                           split_smem_bytes(),
                           body.template batches_ll<SPLIT_L>(), stream, body,
                           table, split, inverse);
}

// Launch the column kernel on columns of n points (a power of two in [8,
// 1024]): table and schedule are fft_plan(n, inverse)'s up to 512 points;
// at 1024 those of 512, with split (see launch_cols_split).
template <class Body>
cudaError_t launch_cols(int n, int schedule, const Body& body,
                        const float* table, const float* split, int inverse,
                        cudaStream_t stream) {
  switch (n) {
    case 8: return launch_cols_log2<3>(schedule, body, table, inverse, stream);
    case 16: return launch_cols_log2<4>(schedule, body, table, inverse, stream);
    case 32: return launch_cols_log2<5>(schedule, body, table, inverse, stream);
    case 64: return launch_cols_log2<6>(schedule, body, table, inverse, stream);
    case 128: return launch_cols_log2<7>(schedule, body, table, inverse, stream);
    case 256: return launch_cols_log2<8>(schedule, body, table, inverse, stream);
    case 512: return launch_cols_log2<9>(schedule, body, table, inverse, stream);
    case 1024:
      return launch_cols_split(schedule, body, table, split, inverse, stream);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// The mixed-radix column kernel: the column kernel on columns of a mixed
// length n (ops/hopper_fft.MIXED_LENGTHS, 13-smooth, not a power of two),
// kernel 7 (_x_c2c_kernel) at X = 480, 448, 375, ... (fused3d.cu's
// dfft_x_mixed), where its dense body computed each column's X-point DFT as
// a product with the (X, X) DFT matrix: 8 X flop a point, 15x an FFT's at
// 480, 7.6x cuFFT's time on (480, 512, 257) (PERF.md section 6).
//
// It joins the column kernel's batch to the mixed-radix kernel's passes:
// - The batch and loads of fft_cols_kernel: W columns of one outer index a
//   batch, each of their n point-rows a strip of W contiguous elements,
//   copied by every thread's cp.async in the widest parts the strip allows
//   (Columns::issue), one block of COL_THREADS threads an SM. W is the
//   host's choice (ops/hopper_fft.mixed_cols_width, packed in the schedule
//   above the radices): the largest power of two with W n <= COL_POINTS,
//   so 16 at n > 256 (128-byte strips of complex64; strips of the
//   mixed-radix kernel's rows would be 5 columns at 480, 40 bytes), up to
//   COL_THREADS at n <= 16.
// - The passes of fft_mixed_kernel: the plan's radices at runtime
//   (ColPlan: one instantiation a Body serves every length), each pass
//   dispatched on its radix to the unrolled butterflies of dft_small,
//   twiddled from fft_plan's table, Stockham order. Butterfly (column c,
//   j) of a radix-R pass, S = n / R of them a column, belongs to thread c
//   + W jl with j = jl + q T, T = COL_THREADS / W threads a column: a half
//   warp's 16 lanes read or write 16 neighbouring columns of one point,
//   128 bytes without a bank conflict, and share each twiddle (one k).
// - Ping-pong, not in place: each pass reads one buffer and writes another
//   (the first reads the landed strips into a work buffer, the next ones
//   back and forth between the work buffer and the batch's own), so a
//   butterfly's R points leave the registers as soon as it is done and a
//   pass needs one barrier. In place, as col_pass works, a thread would
//   hold all its butterflies of a pass across two barriers, up to 2 x 15
//   points: each pass alone fits 128 registers (113 at radix 15), the
//   kernel with every radix did not (1.5 KB of stack and 3.3 KB of spill
//   code, 0.87 ms on (480, 480, 241) against a bound of 0.265). The work
//   buffer takes the third buffer of the ring: MIXED_COL_STAGES = 2 input
//   buffers, one batch landing while one is transformed; three buffers of
//   8 n W <= 64 KB and the table fit the 227 KB a block may take, four do
//   not at 480.
// - The epilogue and the ragged last group are Columns's: the strips
//   stored in parts as wide as the destination allows, the columns past
//   inner transformed from stale data and never stored.
// Bound by bytes, as the column kernel: 16 bytes a point in and out,
// (480, 480, 241) 0.89 GB -> 0.265 ms on an H100 SXM.
// ---------------------------------------------------------------------------

constexpr int COL_POINTS = 16 * COL_THREADS;  // most points a batch: 8192
constexpr int MIXED_COL_STAGES = 2;           // input buffers of the ring

// The plan of a launch: built on the host by col_plan from the packed
// schedule, passed by value.
struct ColPlan {
  int n;        // points a column
  int passes;
  int radices;  // pass p's radix in bits 5p .. 5p + 4, as the schedule's
  int width;    // columns a batch, W
  int tld;      // floats of a table plane: n - the first radix, rounded
                // up to 4 (16-byte aligned buffers)
};

// The plan on columns of n points from the packed schedule
// (ops/hopper_fft.mixed_cols_schedule: fft_plan(n, inverse).schedule's
// radices, the columns of a batch from bit MIXED_ROWS_SHIFT on); false
// unless its radices are the mixed-radix kernel's and multiply to n in [8,
// MIXED_MAX] and W is a power of two in [16, COL_THREADS] with W n <=
// COL_POINTS.
inline bool col_plan(int n, int schedule, ColPlan& g) {
  if (n < 8 || n > MIXED_MAX || schedule <= 0) return false;
  const int w = schedule >> MIXED_ROWS_SHIFT;
  if (w < 16 || w > COL_THREADS || (w & (w - 1)) || w * n > COL_POINTS)
    return false;
  int radix[MIXED_PASSES];
  if (!unpack_radices(n, schedule, radix, g.passes)) return false;
  g.n = n;
  g.radices = schedule & ((1 << MIXED_ROWS_SHIFT) - 1);
  g.width = w;
  g.tld = (n - radix[0] + 3) & ~3;
  return true;
}

// The mixed-radix column kernel's shared memory a block on plan g: the
// ring's barriers, the table's two planes, MIXED_COL_STAGES input buffers
// and the work buffer of 8 n W bytes each (at most 200,832 bytes: W n <=
// COL_POINTS).
__host__ __device__ inline size_t mixed_cols_smem(const ColPlan& g) {
  return 128 + 8 * (size_t)g.tld +
         (MIXED_COL_STAGES + 1) * 8 * (size_t)g.n * g.width;
}

// One radix-R pass of a batch (point i of column c at out[i W + c]): the
// thread's butterflies j = jl + q T < S = n / R of column c take points j
// + m S from load(i), twiddled by the table's [m - 1][k] of the pass (at ns
// - r0), k = j mod ns, when ns > 1, run the R-point DFT and write output m
// to point (j - k) R + k + m ns of out (Stockham order, as mixed_pass).
template <int R, class Load>
__device__ __forceinline__ void mixed_col_pass(int n, int W, int T, int c,
                                               int jl, int r0, int ns,
                                               float2* __restrict__ out,
                                               const float* __restrict__ wr,
                                               const float* __restrict__ wi,
                                               float sgn, Load load) {
  const int S = n / R, off = ns - r0, dk = T % ns;
  int k = jl % ns;
  for (int j = jl; j < S; j += T) {
    float2 a[R];
#pragma unroll
    for (int m = 0; m < R; ++m) a[m] = load(j + m * S);
    if (ns > 1) {
#pragma unroll
      for (int m = 1; m < R; ++m) {
        const int t = off + (m - 1) * ns + k;
        a[m] = cmul(a[m], make_float2(wr[t], wi[t]));
      }
    }
    dft_small<R>(a, sgn);
    const int o = (j - k) * R + k;
#pragma unroll
    for (int m = 0; m < R; ++m) out[(o + m * ns) * W + c] = a[m];
    k += dk;
    if (k >= ns) k -= ns;
  }
}

// The kernel. Body gives the Columns methods on a ColShape (n point-rows,
// W columns): batches, issue (every thread's cp.async parts and its
// arrive), load (point i of column c of the landed batch), store (the
// epilogue from the work layout, all threads). Each pass dispatches on its
// radix (with_radix), its radix read from the packed radices.
template <class Body>
__global__ void __launch_bounds__(COL_THREADS, 1)
fft_mixed_cols_kernel(const Body body, const ColPlan g,
                      const float* __restrict__ table, int inverse) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int NS = MIXED_COL_STAGES;
  const int n = g.n, W = g.width, r0 = g.radices & 31;
  const ColShape sh{n, W};
  const int SB = 8 * n * W;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  float* wr = reinterpret_cast<float*>(smem + 128);
  float* wi = wr + g.tld;
  unsigned char* stages = reinterpret_cast<unsigned char*>(wi + g.tld);
  float2* work = reinterpret_cast<float2*>(stages + NS * SB);

  const int tid = threadIdx.x;
  const int nb = (int)body.batches(sh);
  load_planes<COL_THREADS>(table, n - r0, wr, wi);
  init_ring(full, NS, COL_THREADS);
  __syncthreads();
  for (int s = 0; s < NS; ++s) {
    const int b = blockIdx.x + s * gridDim.x;
    if (b < nb) body.issue(sh, stages + s * SB, b, &full[s]);
  }

  const float sgn = inverse ? 1.f : -1.f;
  const int c = tid & (W - 1), jl = tid / W, T = COL_THREADS / W;
  int it = 0;
  for (int b = blockIdx.x; b < nb; b += gridDim.x, ++it) {
    const int s = it % NS;
    unsigned char* buf = stages + s * SB;
    mbar_wait(&full[s], (it / NS) & 1);
    with_radix(r0, [&](auto R) {
      mixed_col_pass<decltype(R)::value>(
          n, W, T, c, jl, r0, 1, work, wr, wi, sgn,
          [&body, sh, buf, c](int i) { return body.load(sh, buf, c, i); });
    });
    __syncthreads();
    // Pass p reads in and writes out: the work buffer and the batch's own,
    // in turn.
    float2* in = work;
    float2* out = reinterpret_cast<float2*>(buf);
    int ns = r0;
    for (int p = 1; p < g.passes; ++p) {
      const int r = (g.radices >> (5 * p)) & 31;
      with_radix(r, [&](auto R) {
        mixed_col_pass<decltype(R)::value>(
            n, W, T, c, jl, r0, ns, out, wr, wi, sgn,
            [in, W, c](int i) { return in[i * W + c]; });
      });
      __syncthreads();
      float2* t = in;
      in = out;
      out = t;
      ns *= r;
    }
    body.store(sh, in, b);
    // Every thread has read buffer s and the work buffer: refill s with
    // the batch NS steps ahead.
    __syncthreads();
    const int next = b + NS * gridDim.x;
    if (next < nb) body.issue(sh, buf, next, &full[s]);
  }
}

// Launch the mixed-radix column kernel on columns of n points; table:
// ops/hopper_fft.fft_plan(n, inverse)'s, schedule
// ops/hopper_fft.mixed_cols_schedule(n, inverse)'s.
template <class Body>
cudaError_t launch_mixed_cols(int n, int schedule, const Body& body,
                              const float* table, int inverse,
                              cudaStream_t stream) {
  ColPlan g;
  if (!col_plan(n, schedule, g)) return cudaErrorInvalidValue;
  return launch_persistent(fft_mixed_cols_kernel<Body>, COL_THREADS,
                           mixed_cols_smem(g),
                           body.batches(ColShape{g.n, g.width}), stream, body,
                           g, table, inverse);
}

// ---------------------------------------------------------------------------
// The short-stage kernel: the n1-point DFT, 2 <= n1 <= SHORT_MAX, of every
// column of an (outer, n1, inner) complex64 array, stored where the
// four-step wants its bins. It is kernel 2 (_cmatmul_kernel) on the second
// stage of a split axis (n = n1 n2, _split_for: 1536 = 3 x 512, 2048 = 4 x
// 512, ..., 8192 = 16 x 512, 640 = 2 x 320), which the JAX package runs on
// contiguous rows of n1 points after a swap, and which the row body of
// stage.cu ran as one thread a row: strips of 32 bytes, 42% of its bound
// at 4 points. Here the rows of n1 points are columns of the first stage's
// output as it lies, inner = n2 (or n2's columns times the axis's inner
// extent) elements apart, so a point-row is a strip of thousands of
// contiguous elements.
//
// - Loads: the column kernel's (copy_strips: every thread cp.asyncs a share
//   of the batch's strips, in the widest parts their alignment allows, and
//   arrives on the buffer's barrier), a ring of COL_STAGES 64 KB buffers, a
//   persistent grid of one 512-thread block an SM. A batch is SHORT_POINTS
//   complex64: W = CAP columns of one outer index (inner >= CAP), or all
//   inner columns of per = CAP / inner outer indices, whose n1 per point-rows
//   lie one after another.
// - The DFT: a thread takes whole columns (neighbouring threads neighbouring
//   columns), reads its n1 points from the buffer and runs the DFT in
//   registers: the engine's radix-2 network (dft_regs) for a power of two,
//   a dense product with the n1 roots of unity (a float32 table built in
//   float64 on the host) otherwise.
// - Stores: straight from registers, bin k1 of column c of outer index q to
//       (q / group) s1 + (q % group) s2 + k1 row + c
//   if k1 row + c < limit, neighbouring threads on neighbouring elements,
//   coalesced. One geometry serves the three callers: the natural order of
//   a last split axis (group 1, s1 = n, row = n2, limit n), the R2C crop
//   (s1 = limit = n/2 + 1: bins past n/2 never stored) and a non-last split
//   axis, where outer index q = o n2 + k2 and bin k1 n2 + k2 lies at (o, k1
//   n2 + k2, b) of the axis's (outer, n, inner) layout (group n2, s1 = n
//   inner, s2 = inner, row = n2 inner).
// Each byte is read once and written once: bound by bytes, 16 a point (12
// at the crop).
// ---------------------------------------------------------------------------

constexpr int SHORT_MAX = 16;
constexpr int SHORT_POINTS = 8192;  // complex64 a batch: one 64 KB buffer

// Columns a batch at most: a multiple of 32, so a warp's columns lie
// side by side.
template <int N1>
constexpr int short_cap() {
  return (SHORT_POINTS / N1) & ~31;
}

// In-place DFT of the N1 points a[] in registers, exp(sgn 2 pi i jk / N1):
// the radix-2 network for a power of two; else the dense product with the
// roots (wr, wi)[m] = exp(sgn 2 pi i m / N1).
template <int N1>
__device__ __forceinline__ void dft_short(float2* a, const float* wr,
                                          const float* wi, float sgn) {
  if constexpr ((N1 & (N1 - 1)) == 0) {
    dft_regs<log2_of(N1)>(a, sgn);
  } else {
    float2 y[N1];
#pragma unroll
    for (int k = 0; k < N1; ++k) {
      float2 s = a[0];
#pragma unroll
      for (int j = 1; j < N1; ++j) {
        const int m = (j * k) % N1;
        if (m == 0) {
          s.x += a[j].x;
          s.y += a[j].y;
        } else {
          const float c = wr[m], d = wi[m];
          s.x = fmaf(a[j].x, c, fmaf(-a[j].y, d, s.x));
          s.y = fmaf(a[j].x, d, fmaf(a[j].y, c, s.y));
        }
      }
      y[k] = s;
    }
#pragma unroll
    for (int k = 0; k < N1; ++k) a[k] = y[k];
  }
}

// The short-stage kernel's columns: x (outer, n1, inner) complex64 in, out
// complex64 in the geometry above. w, per and groups are set by
// launch_short.
struct ShortColumns {
  const float* x;
  float* out;
  int outer;
  int n1;
  int inner;
  int group;
  long long s1;
  long long s2;
  long long row;
  long long limit;
  int w;       // columns a strip
  int per;     // outer indices a batch
  int groups;  // batches across inner

  __host__ __device__ long long batches() const {
    return ((long long)outer + per - 1) / per * groups;
  }
  // Batch b: its first outer index and column, and how many of each exist.
  __device__ void locate(int b, int& q0, int& c0, int& pv, int& wv) const {
    const int ob = b / groups;
    q0 = ob * per;
    c0 = (b - ob * groups) * w;
    pv = outer - q0 < per ? outer - q0 : per;
    wv = inner - c0 < w ? inner - c0 : w;
  }
  // Every thread: its cp.async parts of batch b (pv n1 strips of wv
  // columns, inner apart in x, w apart in the buffer), then its arrive.
  __device__ void issue(unsigned char* buf, int b, uint64_t* bar) const {
    int q0, c0, pv, wv;
    locate(b, q0, c0, pv, wv);
    const size_t off = (size_t)q0 * n1 * inner + c0;
    copy_strips(buf, x + 2 * off, 8 * (size_t)inner, 8 * wv, pv * n1, 8 * w);
    arrive_when_copied(bar);
  }
  // Every thread: the DFT of its columns of the landed batch b, stored.
  template <int N1>
  __device__ void transform(const unsigned char* buf, int b, const float* wr,
                            const float* wi, float sgn) const {
    int q0, c0, pv, wv;
    locate(b, q0, c0, pv, wv);
    const float2* v = reinterpret_cast<const float2*>(buf);
    float2* o = reinterpret_cast<float2*>(out);
    for (int e = threadIdx.x; e < pv * w; e += COL_THREADS) {
      const int p = e / w, c = e - p * w;
      if (c >= wv) continue;
      float2 a[N1];
#pragma unroll
      for (int i = 0; i < N1; ++i) a[i] = v[(p * N1 + i) * w + c];
      dft_short<N1>(a, wr, wi, sgn);
      const int q = q0 + p;
      const long long col = (long long)c0 + c;
      float2* dst = o + (long long)(q / group) * s1 +
                    (long long)(q % group) * s2 + col;
#pragma unroll
      for (int i = 0; i < N1; ++i)
        if (i * row + col < limit) dst[i * row] = a[i];
    }
  }
};

constexpr size_t short_smem_bytes() {
  return 256 + (size_t)COL_STAGES * 8 * SHORT_POINTS;
}

template <int N1>
__global__ void __launch_bounds__(COL_THREADS, 1)
fft_short_kernel(const ShortColumns body, const float* __restrict__ roots,
                 int inverse) {
  constexpr int SB = 8 * SHORT_POINTS;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  float* wr = reinterpret_cast<float*>(smem + 128);
  float* wi = wr + SHORT_MAX;
  unsigned char* stages = smem + 256;

  const int nb = (int)body.batches();
  load_planes<COL_THREADS>(roots, N1, wr, wi);
  init_ring(full, COL_STAGES, COL_THREADS);
  __syncthreads();
  for (int s = 0; s < COL_STAGES; ++s) {
    const int b = blockIdx.x + s * gridDim.x;
    if (b < nb) body.issue(stages + s * SB, b, &full[s]);
  }

  const float sgn = inverse ? 1.f : -1.f;
  int it = 0;
  for (int b = blockIdx.x; b < nb; b += gridDim.x, ++it) {
    const int s = it % COL_STAGES;
    unsigned char* buf = stages + s * SB;
    mbar_wait(&full[s], (it / COL_STAGES) & 1);
    body.template transform<N1>(buf, b, wr, wi, sgn);
    // Every thread has read buffer s: refill it STAGES batches ahead.
    __syncthreads();
    const int next = b + COL_STAGES * gridDim.x;
    if (next < nb) body.issue(buf, next, &full[s]);
  }
}

template <int N1>
cudaError_t launch_short_n(ShortColumns body, const float* roots, int inverse,
                           cudaStream_t stream) {
  constexpr int CAP = short_cap<N1>();
  if (body.inner >= CAP) {
    body.w = CAP;
    body.per = 1;
    body.groups = (body.inner + CAP - 1) / CAP;
  } else {
    body.w = body.inner;
    body.per = CAP / body.inner;
    body.groups = 1;
  }
  return launch_persistent(fft_short_kernel<N1>, COL_THREADS,
                           short_smem_bytes(), body.batches(), stream, body,
                           roots, inverse);
}

// Launch the short-stage kernel on columns of body.n1 points; roots: (2,
// n1) float32 planes of exp(-+ 2 pi i m / n1) (ops/hopper_fft.short_roots).
inline cudaError_t launch_short(const ShortColumns& body, const float* roots,
                                int inverse, cudaStream_t stream) {
  switch (body.n1) {
    case 2: return launch_short_n<2>(body, roots, inverse, stream);
    case 3: return launch_short_n<3>(body, roots, inverse, stream);
    case 4: return launch_short_n<4>(body, roots, inverse, stream);
    case 5: return launch_short_n<5>(body, roots, inverse, stream);
    case 6: return launch_short_n<6>(body, roots, inverse, stream);
    case 7: return launch_short_n<7>(body, roots, inverse, stream);
    case 8: return launch_short_n<8>(body, roots, inverse, stream);
    case 9: return launch_short_n<9>(body, roots, inverse, stream);
    case 10: return launch_short_n<10>(body, roots, inverse, stream);
    case 11: return launch_short_n<11>(body, roots, inverse, stream);
    case 12: return launch_short_n<12>(body, roots, inverse, stream);
    case 13: return launch_short_n<13>(body, roots, inverse, stream);
    case 14: return launch_short_n<14>(body, roots, inverse, stream);
    case 15: return launch_short_n<15>(body, roots, inverse, stream);
    case 16: return launch_short_n<16>(body, roots, inverse, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace fft_rows
