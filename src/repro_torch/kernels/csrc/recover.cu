// Fig.-3 receiver (model recovery) over a [rows, n] batch, scalars per row.
//
// Replaces: src/repro/kernels/recover.py:_recover_kernel (reached through
// recover), the TPU kernel that fused the ~6-op XLA chain over padded (8x128)
// tiles.
//
// Bound on the card: memory bytes. Per element it reads 4 bytes of `kept`,
// 1 byte of `sign` and 4 bytes of `local`, and writes 4 bytes, with two
// compares and two selects in between.
//
// Design: a 2-D grid (blockIdx.y = row, blockIdx.x = a slice of the row),
// one element per thread per loop step, neighbouring threads on neighbouring
// addresses; the row's mean_abs/max_abs are loaded once per block. The ragged
// tail is masked by the loop bound. The arithmetic is the reference's: where
// sign != 0 the output is sign*mean_abs if sign(local)*sign < 0 or
// |local| > max_abs, else local; where sign == 0 it is kept. sign*mean_abs is
// an exact negation or copy, so the result matches the plain version exactly.
#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 256
#define ELEMS_PER_BLOCK 4096

__global__ void recover_kernel(const float* __restrict__ kept,
                               const int8_t* __restrict__ sign,
                               const float* __restrict__ local,
                               const float* __restrict__ mean_abs,
                               const float* __restrict__ max_abs,
                               float* __restrict__ out, long long n) {
  const int row = blockIdx.y;
  const float mean = mean_abs[row];
  const float mx = max_abs[row];
  const long long off = (long long)row * n;
  const long long start = (long long)blockIdx.x * ELEMS_PER_BLOCK;
  long long stop = start + ELEMS_PER_BLOCK;
  if (stop > n) stop = n;
  for (long long i = start + threadIdx.x; i < stop; i += blockDim.x) {
    const float s = (float)sign[off + i];
    const float l = local[off + i];
    float o;
    if (s != 0.0f) {
      const float sl = (float)((l > 0.0f) - (l < 0.0f));
      const bool bad = (sl * s < 0.0f) || (fabsf(l) > mx);
      o = bad ? s * mean : l;
    } else {
      o = kept[off + i];
    }
    out[off + i] = o;
  }
}

// kept, local, out [rows, n] f32; sign [rows, n] int8; mean_abs, max_abs
// [rows] f32. Returns cudaGetLastError() after the launch.
extern "C" int recover(const void* kept, const void* sign, const void* local,
                       const void* mean_abs, const void* max_abs, void* out,
                       int rows, long long n, void* stream) {
  if (rows <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  const long long blocks_x = (n + ELEMS_PER_BLOCK - 1) / ELEMS_PER_BLOCK;
  dim3 grid((unsigned)blocks_x, (unsigned)rows);
  recover_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)kept, (const int8_t*)sign, (const float*)local,
      (const float*)mean_abs, (const float*)max_abs, (float*)out, n);
  return (int)cudaGetLastError();
}
