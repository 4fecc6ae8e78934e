// Store-pattern probe for kernel 6 (zy_fwd): the cost of writing the two
// (X, Y, Zo) float32 output planes at 512^3 (Zo = 257, rows 1028 bytes
// apart) when each block writes a strip of W zo-columns by Y rows, as a
// pass whose blocks each hold W columns must. W = 4 is what a y-FFT batch
// of the row engine holds at Y = 512; W = 256 writes nearly whole rows.
// Not part of the library: a standalone program, built and run by hand on
// a GPU machine:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o store_strips \
//       distributedfft_tpu_torch/csrc/probes/store_strips.cu
//   ./store_strips
//
// It prints, for three grid sizes, the mean of 10 timed launches (CUDA
// events, after 3 warm-ups) for each W.

#include <cstdio>

#include <cuda_runtime.h>

template <int W>
__global__ void __launch_bounds__(256)
strips(float* yr, float* yi, int X, int Y, int Zo, int zp) {
  const int cols = X * zp, nb = (cols + W - 1) / W;
  for (int b = blockIdx.x; b < nb; b += gridDim.x) {
    const int c = threadIdx.x % W, col = b * W + c;
    if (col >= cols) continue;
    const int x = col / zp, z = col - x * zp;
    if (z >= Zo) continue;
    for (int ky = threadIdx.x / W; ky < Y; ky += 256 / W) {
      const size_t o = ((size_t)x * Y + ky) * Zo + z;
      yr[o] = 1.f;
      yi[o] = 2.f;
    }
  }
}

template <int W>
float mean_ms(float* a, float* b, int X, int Y, int Zo, int zp, int grid) {
  cudaEvent_t s, e;
  cudaEventCreate(&s);
  cudaEventCreate(&e);
  for (int i = 0; i < 3; ++i) strips<W><<<grid, 256>>>(a, b, X, Y, Zo, zp);
  float total = 0.f;
  for (int i = 0; i < 10; ++i) {
    cudaEventRecord(s);
    strips<W><<<grid, 256>>>(a, b, X, Y, Zo, zp);
    cudaEventRecord(e);
    cudaEventSynchronize(e);
    float ms;
    cudaEventElapsedTime(&ms, s, e);
    total += ms;
  }
  return total / 10;
}

int main() {
  const int X = 512, Y = 512, Zo = 257, zp = 258;
  const size_t n = (size_t)X * Y * Zo;
  float *a, *b;
  cudaMalloc(&a, n * 4);
  cudaMalloc(&b, n * 4);
  int sms;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  for (int per : {2, 3, 8}) {
    const int g = sms * per;
    printf("grid %d: W4 %.4f W8 %.4f W16 %.4f W32 %.4f W64 %.4f W256 %.4f ms\n",
           g, mean_ms<4>(a, b, X, Y, Zo, zp, g),
           mean_ms<8>(a, b, X, Y, Zo, zp, g),
           mean_ms<16>(a, b, X, Y, Zo, zp, g),
           mean_ms<32>(a, b, X, Y, Zo, zp, g),
           mean_ms<64>(a, b, X, Y, Zo, zp, g),
           mean_ms<256>(a, b, X, Y, Zo, zp, g));
  }
  const cudaError_t err = cudaGetLastError();
  printf("%s\n", cudaGetErrorString(err));
  return err == cudaSuccess ? 0 : 1;
}
