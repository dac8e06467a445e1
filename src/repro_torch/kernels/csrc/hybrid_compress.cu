// Fig.-3 sender (hybrid compress) over a [rows, n] batch, one threshold per row.
//
// Replaces: src/repro/kernels/hybrid_compress.py:_compress_kernel (reached
// through hybrid_compress), the TPU kernel that made one pass over +inf-padded
// (8x128) tiles and left [n_blocks, 3] partials for XLA to fold.
//
// Bound on the card: memory bytes. Per element and row it writes 4 bytes of
// `kept` and 1 byte of `sign`, with a compare and two selects in between; x
// is read once (4 bytes per element) when it is one [n] vector shared by
// every row (x_row_stride 0: the global model against each participant's
// threshold, the main path), or once per row. A tier chunk [25, 164134] of
// the shared vector moves 21 MB, 6.3 us at 3.35 TB/s; one row 0.44 us, where
// the launch, one memory round trip and the fold of the blocks' partials set
// the time.
//
// Design, and why:
// * One launch. Blocks cover a column slice of per_block elements (a multiple
//   of 4) for a group of rows; each writes its per-row count, sum|x| and
//   max|x| over the compressed set (|x| < thr) to a partials buffer, then
//   one thread takes a ticket from the row group's counter with an
//   acquire-release atomic after the block barrier (the pattern of CUTLASS's
//   grid barrier; no __threadfence). The last block of the group folds the
//   partials of every row of the group in a fixed order (L lanes per row,
//   all rows at once; lane q takes the slices q, q + L, ... in order with 8
//   loads in flight, then a fixed shuffle tree), writes count / sum_abs /
//   max_abs and re-zeroes the counter, which lives in a scratch buffer the
//   wrapper zeroes once when it allocates it. No float atomics: the sum's
//   order is fixed by the grid, so same-seed runs on the card are
//   bit-identical. (The first version launched a second kernel for the
//   fold.)
// * The shared x is read once: a block stages its column slice of x in
//   shared memory (16-byte loads) and emits every row of its group from
//   there, instead of each row's blocks reading x again. With x per row
//   (stride n), a group is one row. A warp emits one (row, sub-slice) unit
//   at a time, writing kept / sign and adding to the unit's stats in the
//   same pass, and folds the stats once per unit. A row's slice is cut in
//   `split` sub-slices, which compress_plan chooses so that the warps share
//   the units evenly (25 rows: halves, 50 units on 8 warps; fewer rows than
//   warps: enough for all 8 warps to work).
// * Vector stores: `kept` as float4 and `sign` as a packed 4-byte quad. The
//   outputs are contiguous [rows, n] batches with 16-byte / 4-byte aligned
//   bases, so element (row, i) sits on a vector boundary exactly when
//   (row * n + i) % 4 == 0; n = 164134 is 2 mod 4, so odd rows start 8 bytes
//   off one. Each unit stores a scalar head up to the first boundary, whole
//   vectors, and a scalar tail; shared memory serves x at any offset (one
//   16-byte, two 8-byte or four 4-byte reads). x itself is staged the same
//   way, on its own address's boundaries.
// * Fill the card: compress_plan in hybrid_compress.py sizes the slices from
//   rows, n and the SM count: about one block per SM (one row of n = 164134
//   on 132 blocks, not 41). Two per SM made the 25-row call slower on the
//   H100: twice the partials to fold at the end of the launch.
// * Where the time goes at [25, 164134] on an H100: the stores run at the
//   rate of PyTorch's own fills of the same two outputs
//   (tools/ab_kernels.py); the rest is serial around them in one launch:
//   staging x (one cold round trip), the ticket (its release waits for the
//   block's stores) and the last block's fold of 25 x 132 partials.
// * Reductions: each lane adds its elements in order, a warp-shuffle tree
//   folds the unit, and a row's units are folded in order. count and max
//   are exact in any order; the sum differs from the plain PyTorch version's
//   order (stated rtol 1e-5). The ragged tail is masked by the slice bounds,
//   not padded with +inf.
#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 256
#define NWARP (THREADS / 32)
#define MAX_PER_BLOCK 4096        // floats of x staged in shared memory
#define MAX_GROUP 32              // rows emitted from one staged slice
#define FOLD_UNROLL 8             // partial loads per lane in flight

__device__ __forceinline__ void warp_fold(int& cnt, float& sum, float& mx) {
  for (int off = 16; off > 0; off >>= 1) {
    cnt += __shfl_down_sync(0xffffffffu, cnt, off);
    sum = __fadd_rn(sum, __shfl_down_sync(0xffffffffu, sum, off));
    mx = fmaxf(mx, __shfl_down_sync(0xffffffffu, mx, off));
  }
}

// four floats of shared memory at p, where p is (phase * 4) bytes past a
// 16-byte boundary: one 16-byte, two 8-byte or four 4-byte loads
__device__ __forceinline__ float4 lds4(const float* p, long long phase) {
  if (phase == 0) return *reinterpret_cast<const float4*>(p);
  if (phase == 2) {
    const float2 a = reinterpret_cast<const float2*>(p)[0];
    const float2 b = reinterpret_cast<const float2*>(p)[1];
    return make_float4(a.x, a.y, b.x, b.y);
  }
  return make_float4(p[0], p[1], p[2], p[3]);
}

// one element's kept / sign values
__device__ __forceinline__ void emit1(float v, float t, float& k, int& s) {
  const bool small = fabsf(v) < t;
  k = small ? 0.0f : v;
  s = small ? (v > 0.0f) - (v < 0.0f) : 0;
}

// one element into the compressed set's running count, sum|x|, max|x|
__device__ __forceinline__ void stat1(float v, float t, int& cnt, float& sum,
                                      float& mx) {
  const float a = fabsf(v);
  if (a < t) {
    cnt += 1;
    sum = __fadd_rn(sum, a);
    mx = fmaxf(mx, a);
  }
}

// A warp's unit of work: row j of the block's group, sub-slice k of its
// column slice. Columns [lo, hi) are relative to the slice's start: a
// scalar head up to the first vector boundary of the flat index, nv whole
// vectors, a scalar tail.
struct Unit {
  int j, k;
  long long lo, hi, head, nv;
  long long g0;                     // flat index of (row, start)
};

__device__ __forceinline__ Unit unit_of(int u, int S, long long sw,
                                        long long len, int r0, long long n,
                                        long long start) {
  Unit U;
  U.j = u / S;
  U.k = u - U.j * S;
  U.lo = U.k * sw < len ? U.k * sw : len;          // a multiple of 4
  U.hi = U.lo + sw < len ? U.lo + sw : len;
  U.g0 = (long long)(r0 + U.j) * n + start;
  U.head = (-(U.g0 + U.lo)) & 3;
  if (U.head > U.hi - U.lo) U.head = U.hi - U.lo;
  U.nv = (U.hi - U.lo - U.head) >> 2;
  return U;
}

// the head or tail column a lane takes in a unit, or -1
__device__ __forceinline__ long long edge_col(const Unit& U, int lane) {
  if (lane < U.head) return U.lo + lane;
  if (lane - U.head < U.hi - U.lo - U.head - 4 * U.nv)
    return U.lo + 4 * U.nv + lane;
  return -1;
}

// old value of *p, incremented with acquire-release semantics at gpu scope
__device__ __forceinline__ int ticket_acq_rel(int* p) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;"
               : "=r"(old) : "l"(p) : "memory");
  return old;
}

// grid (col_blocks, row_groups), THREADS threads; each row of a block's
// group in `split` sub-slices (1..NWARP). partials: [rows][col_blocks]
// int count, then float sums, then float maxima. tickets: [row_groups] int,
// zero on entry and on exit (unused when col_blocks == 1).
__global__ void __launch_bounds__(THREADS)
hybrid_compress_kernel(const float* __restrict__ x, long long x_row_stride,
                       const float* __restrict__ thr, float* __restrict__ kept,
                       int8_t* __restrict__ sign, int* __restrict__ count,
                       float* __restrict__ sum_abs,
                       float* __restrict__ max_abs, int* __restrict__ partials,
                       int* __restrict__ tickets, int rows, long long n,
                       long long per_block, int group, int split) {
  __shared__ __align__(16) float xs[MAX_PER_BLOCK];
  __shared__ float s_thr[MAX_GROUP];
  __shared__ int w_cnt[MAX_GROUP][NWARP];
  __shared__ float w_sum[MAX_GROUP][NWARP];
  __shared__ float w_max[MAX_GROUP][NWARP];
  __shared__ int s_last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r0 = blockIdx.y * group;
  const int nr = rows - r0 < group ? rows - r0 : group;
  const long long start = (long long)blockIdx.x * per_block;
  const long long stop = start + per_block < n ? start + per_block : n;
  const long long len = stop - start;

  // stage x[start, stop) of the group's vector, on x's own 16-byte bounds
  {
    const float* xr = x + (long long)r0 * x_row_stride + start;
    long long head = (long long)(((16u - ((uintptr_t)xr & 15u)) & 15u) >> 2);
    if (head > len) head = len;
    const long long nv = (len - head) >> 2;
    const float4* xv = reinterpret_cast<const float4*>(xr + head);
    for (long long i = tid; i < nv; i += THREADS) {
      const float4 v = __ldg(xv + i);
      float* d = xs + head + 4 * i;
      if (head == 0) {
        *reinterpret_cast<float4*>(d) = v;
      } else {
        d[0] = v.x;
        d[1] = v.y;
        d[2] = v.z;
        d[3] = v.w;
      }
    }
    if (tid < head) xs[tid] = __ldg(xr + tid);
    const long long t0 = head + 4 * nv;
    if (tid < len - t0) xs[t0 + tid] = __ldg(xr + t0 + tid);
    if (tid < nr) s_thr[tid] = __ldg(thr + r0 + tid);
  }
  __syncthreads();

  // emit: units (row j of the group, sub-slice k), one warp each; the slice
  // is cut in S sub-slices so that the warps share the units evenly. Each
  // lane writes kept / sign and adds its elements to the unit's stats in
  // order; a shuffle tree folds the unit's stats.
  const int S = split;
  const long long sw = (((len + S - 1) / S) + 3) & ~3LL;
  for (int u = warp; u < nr * S; u += NWARP) {
    const Unit U = unit_of(u, S, sw, len, r0, n, start);
    const float t = s_thr[U.j];
    float4* kv = reinterpret_cast<float4*>(kept + U.g0 + U.lo + U.head);
    int* sv = reinterpret_cast<int*>(sign + U.g0 + U.lo + U.head);
    int cnt = 0;
    float sum = 0.0f, mx = 0.0f;
    for (long long i = lane; i < U.nv; i += 32) {
      const float4 v = lds4(xs + U.lo + U.head + 4 * i, U.head);
      float4 kq;
      int s0, s1, s2, s3;
      emit1(v.x, t, kq.x, s0);
      emit1(v.y, t, kq.y, s1);
      emit1(v.z, t, kq.z, s2);
      emit1(v.w, t, kq.w, s3);
      kv[i] = kq;
      sv[i] = (s0 & 0xff) | ((s1 & 0xff) << 8) | ((s2 & 0xff) << 16) |
              ((s3 & 0xff) << 24);
      stat1(v.x, t, cnt, sum, mx);
      stat1(v.y, t, cnt, sum, mx);
      stat1(v.z, t, cnt, sum, mx);
      stat1(v.w, t, cnt, sum, mx);
    }
    const long long c = edge_col(U, lane);
    if (c >= 0) {
      float kq;
      int sq;
      emit1(xs[c], t, kq, sq);
      kept[U.g0 + c] = kq;
      sign[U.g0 + c] = (int8_t)sq;
      stat1(xs[c], t, cnt, sum, mx);
    }
    warp_fold(cnt, sum, mx);
    if (lane == 0) {
      w_cnt[U.j][U.k] = cnt;
      w_sum[U.j][U.k] = sum;
      w_max[U.j][U.k] = mx;
    }
  }
  __syncthreads();

  // this block's partial per row: its units folded in order
  const int cb = gridDim.x;
  if (tid < nr) {
    int cnt = 0;
    float sum = 0.0f, mx = 0.0f;
    for (int k = 0; k < S; ++k) {
      cnt += w_cnt[tid][k];
      sum = __fadd_rn(sum, w_sum[tid][k]);
      mx = fmaxf(mx, w_max[tid][k]);
    }
    const int row = r0 + tid;
    if (cb == 1) {
      count[row] = cnt;
      sum_abs[row] = sum;
      max_abs[row] = mx;
    } else {
      const long long p = (long long)row * cb + blockIdx.x;
      const long long total = (long long)rows * cb;
      partials[p] = cnt;
      reinterpret_cast<float*>(partials)[total + p] = sum;
      reinterpret_cast<float*>(partials)[2 * total + p] = mx;
    }
  }
  if (cb == 1) return;

  // the last block of the row group to take a ticket folds the group's
  // partials: L lanes per row (all rows at once), each lane taking every
  // L-th slice in order, FOLD_UNROLL loads in flight, then a fixed shuffle
  // tree. The ticket is one thread's acquire-release atomic after the block
  // barrier (the pattern of CUTLASS's grid barrier): it publishes this
  // block's partials and, in the last block, acquires everyone else's.
  __syncthreads();
  if (tid == 0) s_last = ticket_acq_rel(tickets + blockIdx.y) == cb - 1;
  __syncthreads();
  if (!s_last) return;
  const long long total = (long long)rows * cb;
  const float* psum = reinterpret_cast<const float*>(partials) + total;
  const float* pmax = psum + total;
  const int L = nr <= NWARP ? 32 : (nr <= 2 * NWARP ? 16 : 8);
  const int j = tid / L, q = tid % L;
  int cnt = 0;
  float sum = 0.0f, mx = 0.0f;
  if (j < nr) {
    const long long base = (long long)(r0 + j) * cb;
    for (long long b0 = q; b0 < cb; b0 += (long long)L * FOLD_UNROLL) {
      int pc[FOLD_UNROLL];
      float ps[FOLD_UNROLL], pm[FOLD_UNROLL];
#pragma unroll
      for (int u = 0; u < FOLD_UNROLL; ++u) {
        const long long b = b0 + (long long)u * L;
        pc[u] = b < cb ? __ldcg(partials + base + b) : 0;
        ps[u] = b < cb ? __ldcg(psum + base + b) : 0.0f;
        pm[u] = b < cb ? __ldcg(pmax + base + b) : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < FOLD_UNROLL; ++u) {
        cnt += pc[u];
        sum = __fadd_rn(sum, ps[u]);
        mx = fmaxf(mx, pm[u]);
      }
    }
  }
  for (int off = L / 2; off > 0; off >>= 1) {
    cnt += __shfl_down_sync(0xffffffffu, cnt, off, L);
    sum = __fadd_rn(sum, __shfl_down_sync(0xffffffffu, sum, off, L));
    mx = fmaxf(mx, __shfl_down_sync(0xffffffffu, mx, off, L));
  }
  if (q == 0 && j < nr) {
    count[r0 + j] = cnt;
    sum_abs[r0 + j] = sum;
    max_abs[r0 + j] = mx;
  }
  if (tid == 0) tickets[blockIdx.y] = 0;
}

// x: [n] (x_row_stride 0, shared by every row) or [rows, n] (stride n) f32,
// 4-byte aligned; thr [rows] f32; kept [rows, n] f32 (16-byte aligned);
// sign [rows, n] int8 (4-byte aligned); count [rows] int32; sum_abs, max_abs
// [rows] f32. Columns are cut in col_blocks slices of per_block elements (a
// multiple of 4, at most MAX_PER_BLOCK), rows in groups of `group` (at most
// MAX_GROUP; 1 unless x is shared), each row of a group in `split`
// sub-slices (1..NWARP) for the warps to share. With col_blocks > 1:
// partials holds 3 * rows * col_blocks words, and tickets one int32 per row
// group, zero on entry (and left zero). Returns cudaGetLastError() after the
// launch.
extern "C" int hybrid_compress(const void* x, long long x_row_stride,
                               const void* thr, void* kept, void* sign,
                               void* count, void* sum_abs, void* max_abs,
                               void* partials, void* tickets, int rows,
                               long long n, long long per_block,
                               int col_blocks, int group, int split,
                               void* stream) {
  const long long row_groups = group > 0 ? (rows + group - 1) / group : 0;
  if (rows <= 0 || n <= 0 || per_block <= 0 || per_block % 4 != 0 ||
      per_block > MAX_PER_BLOCK || col_blocks <= 0 ||
      (long long)col_blocks * per_block < n ||
      (long long)(col_blocks - 1) * per_block >= n || group <= 0 ||
      group > MAX_GROUP || row_groups > 65535 || split < 1 ||
      split > NWARP ||
      (x_row_stride != 0 && group != 1) ||
      (col_blocks > 1 && (partials == nullptr || tickets == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)x & 3u) != 0 || ((uintptr_t)kept & 15u) != 0 ||
      ((uintptr_t)sign & 3u) != 0)
    return (int)cudaErrorMisalignedAddress;
  dim3 grid((unsigned)col_blocks, (unsigned)row_groups);
  hybrid_compress_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)x, x_row_stride, (const float*)thr, (float*)kept,
      (int8_t*)sign, (int*)count, (float*)sum_abs, (float*)max_abs,
      (int*)partials, (int*)tickets, rows, n, per_block, group, split);
  return (int)cudaGetLastError();
}
