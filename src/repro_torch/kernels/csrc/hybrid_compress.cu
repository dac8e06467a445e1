// Fig.-3 sender (hybrid compress) over a [rows, n] batch, one threshold per row.
//
// Replaces: src/repro/kernels/hybrid_compress.py:_compress_kernel (reached
// through hybrid_compress), the TPU kernel that made one pass over +inf-padded
// (8x128) tiles and left [n_blocks, 3] partials for XLA to fold.
//
// Bound on the card: memory bytes. Per element it reads 4 bytes of x (once per
// row; x may be one shared [n] vector, row stride 0) and writes 4 bytes of
// `kept` and 1 byte of `sign`, with a compare and two selects in between.
//
// Design: pass 1 runs a 2-D grid (blockIdx.y = row, blockIdx.x = a slice of
// the row), writes kept/sign elementwise, and reduces the slice's count,
// sum|x| and max|x| over the compressed set (|x| < thr) inside the block:
// each thread accumulates its strided elements in order, then a warp-shuffle
// tree and a fixed walk over the warps. The block's partials go to scratch.
// Pass 2 (one block per row) folds the row's partials in a fixed order. No
// float atomics: the sum is the same on every run, so same-seed runs of the
// simulator stay bit-identical on the card. count and max are exact in any
// order; the sum's order differs from the plain PyTorch version (stated rtol
// 1e-5). The ragged tail is masked by the loop bound, not padded with +inf.
#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 256
#define WARPS (THREADS / 32)
#define ELEMS_PER_BLOCK 4096

__device__ __forceinline__ void block_reduce(int& cnt, float& sum, float& mx) {
  __shared__ int s_cnt[WARPS];
  __shared__ float s_sum[WARPS];
  __shared__ float s_max[WARPS];
  for (int off = 16; off > 0; off >>= 1) {
    cnt += __shfl_down_sync(0xffffffffu, cnt, off);
    sum = __fadd_rn(sum, __shfl_down_sync(0xffffffffu, sum, off));
    mx = fmaxf(mx, __shfl_down_sync(0xffffffffu, mx, off));
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    s_cnt[warp] = cnt;
    s_sum[warp] = sum;
    s_max[warp] = mx;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    cnt = 0;
    sum = 0.0f;
    mx = 0.0f;
    for (int w = 0; w < WARPS; ++w) {
      cnt += s_cnt[w];
      sum = __fadd_rn(sum, s_sum[w]);
      mx = fmaxf(mx, s_max[w]);
    }
  }
}

__global__ void hybrid_compress_pass1(const float* __restrict__ x,
                                      long long x_row_stride,
                                      const float* __restrict__ thr,
                                      float* __restrict__ kept,
                                      int8_t* __restrict__ sign,
                                      int* __restrict__ part_cnt,
                                      float* __restrict__ part_sum,
                                      float* __restrict__ part_max,
                                      long long n) {
  const int row = blockIdx.y;
  const float t = thr[row];
  const float* xr = x + (long long)row * x_row_stride;
  float* kr = kept + (long long)row * n;
  int8_t* sr = sign + (long long)row * n;
  const long long start = (long long)blockIdx.x * ELEMS_PER_BLOCK;
  long long stop = start + ELEMS_PER_BLOCK;
  if (stop > n) stop = n;

  int cnt = 0;
  float sum = 0.0f, mx = 0.0f;
  for (long long i = start + threadIdx.x; i < stop; i += blockDim.x) {
    const float v = xr[i];
    const float a = fabsf(v);
    const bool small = a < t;
    kr[i] = small ? 0.0f : v;
    sr[i] = small ? (int8_t)((v > 0.0f) - (v < 0.0f)) : (int8_t)0;
    if (small) {
      cnt += 1;
      sum = __fadd_rn(sum, a);
      mx = fmaxf(mx, a);
    }
  }
  block_reduce(cnt, sum, mx);
  if (threadIdx.x == 0) {
    const long long p = (long long)row * gridDim.x + blockIdx.x;
    part_cnt[p] = cnt;
    part_sum[p] = sum;
    part_max[p] = mx;
  }
}

__global__ void hybrid_compress_pass2(const int* __restrict__ part_cnt,
                                      const float* __restrict__ part_sum,
                                      const float* __restrict__ part_max,
                                      int n_parts, int* __restrict__ count,
                                      float* __restrict__ sum_abs,
                                      float* __restrict__ max_abs) {
  const int row = blockIdx.x;
  const long long base = (long long)row * n_parts;
  int cnt = 0;
  float sum = 0.0f, mx = 0.0f;
  for (int j = threadIdx.x; j < n_parts; j += blockDim.x) {
    cnt += part_cnt[base + j];
    sum = __fadd_rn(sum, part_sum[base + j]);
    mx = fmaxf(mx, part_max[base + j]);
  }
  block_reduce(cnt, sum, mx);
  if (threadIdx.x == 0) {
    count[row] = cnt;
    sum_abs[row] = sum;
    max_abs[row] = mx;
  }
}

static long long n_parts_of(long long n) {
  return (n + ELEMS_PER_BLOCK - 1) / ELEMS_PER_BLOCK;
}

// Bytes of scratch hybrid_compress needs for a [rows, n] batch.
extern "C" long long hybrid_compress_scratch_bytes(int rows, long long n) {
  return (long long)rows * n_parts_of(n) * 12;
}

// x: [n] (x_row_stride 0, shared by every row) or [rows, n] (stride n) f32;
// thr [rows] f32; kept [rows, n] f32; sign [rows, n] int8; count [rows]
// int32; sum_abs, max_abs [rows] f32; scratch of
// hybrid_compress_scratch_bytes(rows, n) bytes. Returns cudaGetLastError().
extern "C" int hybrid_compress(const void* x, long long x_row_stride,
                               const void* thr, void* kept, void* sign,
                               void* count, void* sum_abs, void* max_abs,
                               void* scratch, int rows, long long n,
                               void* stream) {
  if (rows <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  const long long parts = n_parts_of(n);
  const long long total = (long long)rows * parts;
  int* p_cnt = (int*)scratch;
  float* p_sum = (float*)(p_cnt + total);
  float* p_max = p_sum + total;
  cudaStream_t s = (cudaStream_t)stream;
  dim3 grid((unsigned)parts, (unsigned)rows);
  hybrid_compress_pass1<<<grid, THREADS, 0, s>>>(
      (const float*)x, x_row_stride, (const float*)thr, (float*)kept,
      (int8_t*)sign, p_cnt, p_sum, p_max, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  hybrid_compress_pass2<<<rows, THREADS, 0, s>>>(
      p_cnt, p_sum, p_max, (int)parts, (int*)count, (float*)sum_abs,
      (float*)max_abs);
  return (int)cudaGetLastError();
}
