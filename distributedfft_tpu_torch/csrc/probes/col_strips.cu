// Access-pattern probe for the column kernel of fft_rows.cuh (kernel 7 and
// kernel 2 on a non-last axis): how much of its time on the 1024^3
// spectrum, (1024, 1024, 513) complex64, is the strip pattern of its loads
// and stores and how much the FFT. Not part of the library: a standalone
// program, built and run by hand on a GPU machine:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//       -o col_strips distributedfft_tpu_torch/csrc/probes/col_strips.cu
//   ./col_strips
//
// For each view of the spectrum it times (CUDA events, mean of 5 after 2
// warm-ups) a copy kernel that runs the column kernel's persistent grid,
// ring of buffers, Columns loader and epilogue with the FFT passes
// replaced by one pass through the work layout, at the geometry a plain
// column kernel would have at 1024 points (W = 8, 64-byte strips), and
// the split kernel the library runs there (W = 16, each half of the rows
// in one buffer, 128-byte strips):
//
//   y       (1024, 1024, 513)   the y axis: rows 4104 bytes apart (8-byte
//                               parts)
//   x       (1, 1024, 525312)   the x axis: 16-byte parts
//   x_w16   (2, 512, 525312)    the same bytes as 512-point columns, one
//                               block a batch of 128-byte strips (W = 16):
//                               the column kernel and the copy
//
// and a cudaMemcpyAsync of the same 4.3 GB, device to device.

#include <cstdio>

#include <cuda_runtime.h>

#include "../fft_rows.cuh"

using fft_rows::COL_STAGES;
using fft_rows::COL_THREADS;
using fft_rows::ColGeometry;
using fft_rows::Columns;

// The column kernel's loop without its FFT: load, one pass into the work
// layout, store.
template <int L>
__global__ void __launch_bounds__(COL_THREADS, 1)
copy_cols_kernel(const Columns body) {
  using G = ColGeometry<L>;
  constexpr int SB = 8 * G::POINTS;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  unsigned char* stages = smem + 128;
  const int tid = threadIdx.x, nb = body.batches<L>();
  fft_rows::init_ring(full, COL_STAGES, COL_THREADS);
  __syncthreads();
  for (int s = 0; s < COL_STAGES; ++s) {
    const int b = blockIdx.x + s * gridDim.x;
    if (b < nb) body.issue<L>(stages + s * SB, b, &full[s]);
  }
  const int c = tid % G::W, jl = tid / G::W;
  int it = 0;
  for (int b = blockIdx.x; b < nb; b += gridDim.x, ++it) {
    const int s = it % COL_STAGES;
    unsigned char* buf = stages + s * SB;
    float2* w = reinterpret_cast<float2*>(buf);
    fft_rows::mbar_wait(&full[s], (it / COL_STAGES) & 1);
    float2 a[G::PT];
#pragma unroll
    for (int m = 0; m < G::PT; ++m) a[m] = body.load<L>(buf, c, jl + m * G::T);
    __syncthreads();
#pragma unroll
    for (int m = 0; m < G::PT; ++m) w[(jl + m * G::T) * G::W + c] = a[m];
    __syncthreads();
    body.store<L>(w, b);
    __syncthreads();
    const int next = b + COL_STAGES * gridDim.x;
    if (next < nb) body.issue<L>(buf, next, &full[s]);
  }
}

template <int L>
cudaError_t launch_copy(const Columns& body) {
  return fft_rows::launch_persistent(
      copy_cols_kernel<L>, COL_THREADS,
      128 + COL_STAGES * 8 * ColGeometry<L>::POINTS, body.batches_ll<L>(), 0,
      body);
}

template <class F>
float mean_ms(F f) {
  cudaEvent_t s, e;
  cudaEventCreate(&s);
  cudaEventCreate(&e);
  for (int i = 0; i < 2; ++i) f();
  float total = 0.f;
  for (int i = 0; i < 5; ++i) {
    cudaEventRecord(s);
    f();
    cudaEventRecord(e);
    cudaEventSynchronize(e);
    float ms;
    cudaEventElapsedTime(&ms, s, e);
    total += ms;
  }
  return total / 5;
}

// The engine's twiddle table (ops/hopper_fft.fft_plan) is not needed for
// timing: any finite table runs the same instructions.
float* zero_table() {
  float* t;
  cudaMalloc(&t, 2 * 1024 * sizeof(float));
  cudaMemset(t, 0, 2 * 1024 * sizeof(float));
  return t;
}

int main() {
  const size_t n = (size_t)1024 * 1024 * 513;
  float *x, *y;
  cudaMalloc(&x, 8 * n);
  cudaMalloc(&y, 8 * n);
  cudaMemset(x, 0, 8 * n);
  float* table = zero_table();
  const Columns ycols{x, nullptr, y, nullptr, 1024, 1024, 513};
  const Columns xcols{x, nullptr, y, nullptr, 1, 1024, 1024 * 513};
  const Columns x16{x, nullptr, y, nullptr, 2, 512, 1024 * 513};
  const int s9 = fft_rows::packed_schedule(9);
  printf("GB moved %.3f\n", 16.0 * n / 1e9);
  printf("memcpy d2d     %.4f ms\n", mean_ms([&] {
           cudaMemcpyAsync(y, x, 8 * n, cudaMemcpyDeviceToDevice);
         }));
  const Columns views[2] = {ycols, xcols};
  const char* names[2] = {"y", "x"};
  for (int v = 0; v < 2; ++v) {
    const Columns cols = views[v];
    const float copy8 = mean_ms([&] { launch_copy<10>(cols); });
    const float split = mean_ms([&] {
      fft_rows::launch_cols(1024, s9, cols, table, table, 0, 0);
    });
    printf("%s    copy W8 %.4f ms  split W16 %.4f ms\n", names[v], copy8,
           split);
  }
  printf("x_w16 fft %.4f ms  copy %.4f ms\n", mean_ms([&] {
           fft_rows::launch_cols(512, s9, x16, table, nullptr, 0, 0);
         }), mean_ms([&] { launch_copy<9>(x16); }));
  const cudaError_t err = cudaDeviceSynchronize();
  printf("%s\n", cudaGetErrorString(err));
  return err == cudaSuccess ? 0 : 1;
}
