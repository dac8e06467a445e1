// 256-bin magnitude histogram of a [rows, n] f32 batch, one histogram per row.
//
// Replaces: src/repro/kernels/topk_threshold.py:_hist_kernel (reached through
// magnitude_histogram), the TPU kernel that binned one (8x128) VMEM tile per
// grid step with a one-hot x matmul reduction.
//
// Bound on the card: memory bytes. Each element is read once (4 bytes) and
// costs a handful of integer/float operations, far below the 295 ops/byte the
// card needs before arithmetic would limit it.
//
// Design: a 2-D grid, blockIdx.y = row, blockIdx.x = a contiguous slice of the
// row. Each block builds a private 256-bin histogram in shared memory with
// integer atomicAdd (exact in any order), then adds its non-zero bins into the
// row's global [256] int32 counts with one atomicAdd each. The ragged tail is
// masked by the loop bound, not padded, so nothing is subtracted afterwards.
// Bin arithmetic mirrors the reference exactly: scale = f32(256 / max(m,
// 1e-30)) with IEEE division, bin = clip(int(|x| * scale), 0, 255) with
// truncation of the rounded f32 product (no fast-math, no contraction: the
// product feeds a conversion, not an add).
#include <cuda_runtime.h>
#include <stdint.h>

#define N_BINS 256
#define THREADS 256
#define ELEMS_PER_BLOCK 4096

__global__ void magnitude_histogram_kernel(const float* __restrict__ x,
                                           const float* __restrict__ max_abs,
                                           int* __restrict__ hist,
                                           long long n) {
  __shared__ int bins[N_BINS];
  const int row = blockIdx.y;
  for (int b = threadIdx.x; b < N_BINS; b += blockDim.x) bins[b] = 0;
  __syncthreads();

  const float scale = __fdiv_rn(256.0f, fmaxf(max_abs[row], 1e-30f));
  const float* xr = x + (long long)row * n;
  const long long start = (long long)blockIdx.x * ELEMS_PER_BLOCK;
  long long stop = start + ELEMS_PER_BLOCK;
  if (stop > n) stop = n;
  for (long long i = start + threadIdx.x; i < stop; i += blockDim.x) {
    const float prod = __fmul_rn(fabsf(xr[i]), scale);
    int idx = __float2int_rz(prod);
    idx = idx < 0 ? 0 : (idx > N_BINS - 1 ? N_BINS - 1 : idx);
    atomicAdd(&bins[idx], 1);
  }
  __syncthreads();

  int* hr = hist + (long long)row * N_BINS;
  for (int b = threadIdx.x; b < N_BINS; b += blockDim.x) {
    const int c = bins[b];
    if (c) atomicAdd(&hr[b], c);
  }
}

// x [rows, n] f32 contiguous, max_abs [rows] f32, hist [rows, 256] int32
// (zeroed by the caller). Returns cudaGetLastError() after the launch.
extern "C" int magnitude_histogram(const void* x, const void* max_abs,
                                   void* hist, int rows, long long n,
                                   void* stream) {
  if (rows <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  const long long blocks_x = (n + ELEMS_PER_BLOCK - 1) / ELEMS_PER_BLOCK;
  dim3 grid((unsigned)blocks_x, (unsigned)rows);
  magnitude_histogram_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)max_abs, (int*)hist, n);
  return (int)cudaGetLastError();
}
