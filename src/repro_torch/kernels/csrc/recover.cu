// Fig.-3 receiver (model recovery) over a [rows, n] batch, scalars per row.
//
// Replaces: src/repro/kernels/recover.py:_recover_kernel (reached through
// recover), the TPU kernel that fused the ~6-op XLA chain over padded (8x128)
// tiles.
//
// Bound on the card: memory bytes. Per element it reads 4 bytes of `kept`,
// 1 byte of `sign` and 4 bytes of `local`, and writes 4 bytes of `out` (13
// bytes), with two compares and two selects in between: far below the ops
// per byte at which arithmetic would limit it. A tier chunk [25, 164134]
// moves 53 MB, 16 us at 3.35 TB/s; one row 2.1 MB, 0.6 us, where latency
// (the launch, one memory round trip) sets the time.
//
// Design, and why:
// * Bytes in flight: 16-byte loads of kept and local and the matching
//   4-byte load of sign, UNROLL of each per thread issued before any is
//   used, and a 16-byte store of out. (The first version made one 4-byte,
//   4-byte and 1-byte load per thread per dependent step and streamed at
//   about half the HBM rate.)
// * Fill the card: the wrapper sizes the grid from rows, n and the SM count
//   (blockIdx.y = row, blockIdx.x = a slice of per_block elements, a
//   multiple of 4; recover_plan in recover.py mirrors this index math), so
//   one row runs on ~161 blocks, not n / 4096 = 41.
// * Row alignment: the four streams are contiguous [rows, n] batches whose
//   base pointers are 16-byte (f32) and 4-byte (int8) aligned, so element
//   (row, i) of every stream is on a vector boundary exactly when
//   (row * n + i) % 4 == 0. n = 164134 is 2 mod 4, so every odd row starts 8
//   bytes off a boundary: each slice's elements up to the first boundary
//   (head) and after the last whole vector (tail) take scalar accesses, so
//   every element is read and written exactly once.
// * The row's mean_abs / max_abs are loaded once per block.
// * The arithmetic is the reference's, unchanged: where sign != 0 the output
//   is sign * mean_abs if sign(local) * sign < 0 or |local| > max_abs, else
//   local; where sign == 0 it is kept. sign * mean_abs is an exact negation
//   or copy, so the result equals the plain version bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 256
#define UNROLL 4                  // vectors per thread in flight

__device__ __forceinline__ float recover1(float k, int s, float l, float mean,
                                          float mx) {
  if (s == 0) return k;
  const float sf = (float)s;
  const float sl = (float)((l > 0.0f) - (l < 0.0f));
  const bool bad = (sl * sf < 0.0f) || (fabsf(l) > mx);
  return bad ? sf * mean : l;
}

// byte j (0..3, lowest address first) of a packed int8 quad, sign-extended
__device__ __forceinline__ int sbyte(int quad, int j) {
  return (quad << (24 - 8 * j)) >> 24;
}

// grid (blocks_per_row, rows), THREADS threads
__global__ void __launch_bounds__(THREADS)
recover_kernel(const float* __restrict__ kept, const int8_t* __restrict__ sign,
               const float* __restrict__ local,
               const float* __restrict__ mean_abs,
               const float* __restrict__ max_abs, float* __restrict__ out,
               long long n, long long per_block) {
  const int row = blockIdx.y;
  const int tid = threadIdx.x;
  const float mean = __ldg(mean_abs + row);
  const float mx = __ldg(max_abs + row);
  const long long start = (long long)blockIdx.x * per_block;
  const long long stop = start + per_block < n ? start + per_block : n;
  const long long g0 = (long long)row * n + start;   // flat index of start
  // scalar head up to the first vector boundary, vector body, scalar tail
  long long head = (-g0) & 3;
  if (head > stop - start) head = stop - start;
  const long long nv = (stop - start - head) >> 2;
  const long long b0 = g0 + head;                    // a multiple of 4
  const float4* kv = reinterpret_cast<const float4*>(kept + b0);
  const float4* lv = reinterpret_cast<const float4*>(local + b0);
  const int* sv = reinterpret_cast<const int*>(sign + b0);
  float4* ov = reinterpret_cast<float4*>(out + b0);

  for (long long base = 0; base < nv; base += UNROLL * THREADS) {
    float4 k[UNROLL], l[UNROLL];
    int s[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long i = base + u * THREADS + tid;
      if (i < nv) {
        k[u] = __ldg(kv + i);
        s[u] = __ldg(sv + i);
        l[u] = __ldg(lv + i);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long i = base + u * THREADS + tid;
      if (i < nv) {
        float4 o;
        o.x = recover1(k[u].x, sbyte(s[u], 0), l[u].x, mean, mx);
        o.y = recover1(k[u].y, sbyte(s[u], 1), l[u].y, mean, mx);
        o.z = recover1(k[u].z, sbyte(s[u], 2), l[u].z, mean, mx);
        o.w = recover1(k[u].w, sbyte(s[u], 3), l[u].w, mean, mx);
        ov[i] = o;
      }
    }
  }
  long long g = -1;
  if (tid < head)
    g = g0 + tid;
  else if (tid - head < stop - start - head - 4 * nv)
    g = b0 + 4 * nv + (tid - head);
  if (g >= 0)
    out[g] = recover1(kept[g], sign[g], local[g], mean, mx);
}

// kept, local, out [rows, n] f32 (16-byte aligned); sign [rows, n] int8
// (4-byte aligned); mean_abs, max_abs [rows] f32. Rows are cut in slices of
// per_block elements (a multiple of 4), blocks_per_row of them. Returns
// cudaGetLastError() after the launch.
extern "C" int recover(const void* kept, const void* sign, const void* local,
                       const void* mean_abs, const void* max_abs, void* out,
                       int rows, long long n, long long per_block,
                       int blocks_per_row, void* stream) {
  if (rows <= 0 || rows > 65535 || n <= 0 || per_block <= 0 ||
      per_block % 4 != 0 || blocks_per_row <= 0 ||
      (long long)blocks_per_row * per_block < n ||
      (long long)(blocks_per_row - 1) * per_block >= n)
    return (int)cudaErrorInvalidValue;
  if ((((uintptr_t)kept | (uintptr_t)local | (uintptr_t)out) & 15u) != 0 ||
      ((uintptr_t)sign & 3u) != 0)
    return (int)cudaErrorMisalignedAddress;
  dim3 grid((unsigned)blocks_per_row, (unsigned)rows);
  recover_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)kept, (const int8_t*)sign, (const float*)local,
      (const float*)mean_abs, (const float*)max_abs, (float*)out, n,
      per_block);
  return (int)cudaGetLastError();
}
