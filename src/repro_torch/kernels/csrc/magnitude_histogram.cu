// 256-bin magnitude histogram of a [rows, n] f32 batch, one histogram per row.
//
// Replaces: src/repro/kernels/topk_threshold.py:_hist_kernel (reached through
// magnitude_histogram), the TPU kernel that binned one (8x128) VMEM tile per
// grid step with a one-hot x matmul reduction.
//
// Bound on the card: memory bytes. Each element is read once (4 bytes) and
// costs a handful of integer/float operations, far below the 295 ops/byte the
// card needs before arithmetic would limit it. The round's shapes are small
// (the global model [1, 164134] is 656 KB, 0.2 us at 3.35 TB/s; a tier
// chunk's deltas [25, 164134] 16 MB, 4.9 us), so latency sets the time:
// the launch, one memory round trip, and the merge of the blocks' counts.
//
// Design, and why:
// * Fill the card: the wrapper sizes the grid from rows, n and the SM count
//   (blockIdx.y = row, blockIdx.x = a slice of per_block elements), so a
//   single row is spread over ~2 blocks per SM, not n / 4096 blocks.
// * Loads in flight: 16-byte (float4) loads, UNROLL per thread in flight
//   before any of them is binned. A slice's first elements up to a 16-byte boundary
//   (rows of an odd n start misaligned) and its last n % 4 are binned by a
//   scalar head and tail, so every element is read exactly once.
// * Bins: one private 256-bin histogram per warp in shared memory, filled
//   with integer atomicAdd (exact in any order, and eight copies cut the
//   contention on the few bins a peaked distribution fills).
// * One launch, no fill kernel: the output is written with plain stores. A
//   row served by one block writes its counts directly. Otherwise each
//   block adds its non-zero bins into a per-row int32 accumulator with
//   integer atomics, fences, and takes a ticket from the row's counter; the
//   last block of the row copies the accumulator to the output and zeroes
//   accumulator and counter again. Both live in a scratch buffer the wrapper
//   zeroes once when it allocates it, so no call pays a memset.
// * Bin arithmetic mirrors the reference exactly: scale = f32(256 / max(m,
//   1e-30)) with IEEE division, bin = clip(int(|x| * scale), 0, 255) with
//   truncation of the rounded f32 product (no fast-math, no contraction: the
//   product feeds a conversion, not an add).
#include <cuda_runtime.h>
#include <stdint.h>

#define N_BINS 256
#define THREADS 256
#define NWARP (THREADS / 32)
#define UNROLL 8                  // float4 loads per thread in flight

__device__ __forceinline__ void bin1(int* wb, float x, float scale) {
  const float prod = __fmul_rn(fabsf(x), scale);
  int idx = __float2int_rz(prod);
  idx = idx < 0 ? 0 : (idx > N_BINS - 1 ? N_BINS - 1 : idx);
  atomicAdd(wb + idx, 1);
}

// grid (blocks_per_row, rows), THREADS threads. scratch: [rows][N_BINS]
// accumulators then [rows] tickets, all zero on entry and on exit.
__global__ void __launch_bounds__(THREADS)
magnitude_histogram_kernel(const float* __restrict__ x,
                           const float* __restrict__ max_abs,
                           int* __restrict__ hist, int* __restrict__ scratch,
                           long long n, long long per_block) {
  __shared__ int bins[NWARP][N_BINS];
  __shared__ int s_last;
  const int row = blockIdx.y;
  const int tid = threadIdx.x;
  for (int i = tid; i < NWARP * N_BINS; i += THREADS) (&bins[0][0])[i] = 0;

  const float scale = __fdiv_rn(256.0f, fmaxf(max_abs[row], 1e-30f));
  const float* xr = x + (long long)row * n;
  const long long start = (long long)blockIdx.x * per_block;
  const long long stop = start + per_block < n ? start + per_block : n;
  // scalar head up to the first 16-byte boundary, float4 body, scalar tail
  long long head = (long long)(((16u - ((uintptr_t)(xr + start) & 15u)) & 15u)
                               >> 2);
  if (head > stop - start) head = stop - start;
  const long long nv = (stop - start - head) >> 2;
  const float4* xv = reinterpret_cast<const float4*>(xr + start + head);
  const long long tail = start + head + 4 * nv;
  __syncthreads();

  int* wb = bins[tid >> 5];
  for (long long base = 0; base < nv; base += UNROLL * THREADS) {
    float4 t[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long i = base + u * THREADS + tid;
      if (i < nv) t[u] = __ldg(xv + i);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (base + u * THREADS + tid < nv) {
        bin1(wb, t[u].x, scale);
        bin1(wb, t[u].y, scale);
        bin1(wb, t[u].z, scale);
        bin1(wb, t[u].w, scale);
      }
    }
  }
  if (tid < head) bin1(wb, xr[start + tid], scale);
  if (tid < stop - tail) bin1(wb, xr[tail + tid], scale);
  __syncthreads();

  int* hr = hist + (long long)row * N_BINS;
  int* acc = scratch + (long long)row * N_BINS;
  for (int b = tid; b < N_BINS; b += THREADS) {
    int c = 0;
#pragma unroll
    for (int w = 0; w < NWARP; ++w) c += bins[w][b];
    if (gridDim.x == 1)
      hr[b] = c;
    else if (c)
      atomicAdd(acc + b, c);
  }
  if (gridDim.x == 1) return;

  // the last block of the row to arrive writes the row's counts
  __threadfence();
  __syncthreads();
  int* ticket = scratch + (long long)gridDim.y * N_BINS + row;
  if (tid == 0) s_last = atomicAdd(ticket, 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  for (int b = tid; b < N_BINS; b += THREADS) {
    hr[b] = __ldcg(acc + b);
    acc[b] = 0;
  }
  if (tid == 0) *ticket = 0;
}

// x [rows, n] f32 contiguous (4-byte aligned), max_abs [rows] f32, hist
// [rows, 256] int32 (any contents; every count is stored). Rows are cut in
// slices of per_block elements (a multiple of 4), blocks_per_row of them.
// With blocks_per_row > 1, scratch holds rows * 257 int32 that are zero on
// entry (and left zero). Returns cudaGetLastError() after the launch.
extern "C" int magnitude_histogram(const void* x, const void* max_abs,
                                   void* hist, void* scratch, int rows,
                                   long long n, long long per_block,
                                   int blocks_per_row, void* stream) {
  if (rows <= 0 || rows > 65535 || n <= 0 || per_block <= 0 ||
      per_block % 4 != 0 || blocks_per_row <= 0 ||
      (long long)blocks_per_row * per_block < n ||
      (long long)(blocks_per_row - 1) * per_block >= n ||
      (blocks_per_row > 1 && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)blocks_per_row, (unsigned)rows);
  magnitude_histogram_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)max_abs, (int*)hist, (int*)scratch, n,
      per_block);
  return (int)cudaGetLastError();
}
