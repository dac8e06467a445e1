// Single-query GQA flash-decode attention over a KV cache with a length mask.
//
// Replaces: src/repro/kernels/flash_attention.py:_decode_kernel (reached
// through decode_attention), the TPU kernel that streamed the cache through
// VMEM in 512-position blocks along a sequential grid axis, carrying the
// online-softmax state (running max m, normaliser l, accumulator acc) in
// scratch from one block to the next, and asserted S % 512 == 0.
//
// Computes, for every batch row b and query head h (kv head h / G, G = H/Hkv,
// the reference's contiguous `reshape(b, hkv, g, d)` grouping):
//   out[b,h] = softmax_{s < length[b]}(q[b,h] . k[b,s,h/G] / sqrt(D)) @ v[b,:,h/G]
// with f32 logits, f32 online softmax and f32 accumulation, the final divide
// by max(l, 1e-30), and the output rounded to q's dtype. The softmax runs in
// base 2 (q scaled once by log2(e)/sqrt(D), exp2f), which moves a logit by
// an ulp or so against the plain version's divide and exp: inside its 3e-5
// f32 tolerance. q [B,H,D],
// k/v [B,S,Hkv,D], out [B,H,D]: all f32 or all bf16 (or bf16 inputs and
// an f32 out); length [B] int32.
//
// Bound on the card: memory bytes. Each valid cache position is read once
// (K and V rows of D elements per kv head) and used for at most G = H/Hkv
// dot products of length D: ~G flops per byte in bf16, far below the
// card's ~295 operations per byte. At Qwen1.5-4B's 4096-position cache
// (batch 4) that is 168 MB, 50 us at 3.35 TB/s; at the serve loop's 48
// positions it is 2 MB, so there the launch and one memory round trip set
// the time.
//
// Design, and why:
// * Memory-level parallelism. An SM needs ~3.35 TB/s x ~0.7 us / 132 ~ 18 KB
//   of loads in flight at all times. Each block streams its positions through
//   a STAGES-deep ring in shared memory with 16-byte `cp.async.cg` copies
//   (commit/wait groups): while a warp computes on tile i, its rows of tiles
//   i+1..i+3 are in flight (3 x 16 KB per block, 3 blocks per SM). Each warp
//   copies exactly the rows it later reads, so a warp waits for its own
//   copies and syncs with __syncwarp only: no block-wide barrier per tile.
//   cp.async was chosen over TMA because the rows of one kv head are D
//   elements at a stride of Hkv*D, which 16-byte copies cover with no tensor
//   map (no cuTensorMapEncodeTiled per shape), and a row past length[b] is
//   zero-filled by the copy itself (src-size 0) without touching memory.
//   Deeper or shallower rings, 8-warp blocks, 8 or 32 KB tiles, a
//   split-major grid and L2 prefetch hints all measured within ~2% of this
//   on the H100 (PERF.md).
// * Registers. The block serves one kv head and GT query heads of its group,
//   with GT a template parameter (1, 2, 4 or 8): it holds only the GT query
//   rows and accumulators it needs (Qwen1.5-4B has G = 1). Other group sizes
//   round GT up (G = 3 runs as GT = 4 with one head idle); G > GT spreads the
//   group over several blocks.
// * 16-byte accesses and short reductions. A row is CPR 16-byte chunks (8
//   bf16 or 4 f32). A sub-warp of LPR lanes (the largest power of two <= CPR,
//   at most 32) owns one row at a time, each lane one or two chunks, so a
//   warp works on 32/LPR rows at once and the dot product is reduced in
//   log2(LPR) shuffle rounds inside the sub-warp (4 for bf16 D = 128). Each
//   sub-warp keeps its own (m, l, acc) over PP positions per tile; sub-warps
//   merge by shuffles in a fixed tree, warps in shared memory in warp order.
// * Fill the card where it pays, in one launch. The wrapper splits S so the
//   grid has several blocks per SM, but only while every split streams
//   enough bytes to outweigh the merge below (long cache: 4 splits of 1024,
//   320 blocks; the serve loop's 48 positions: one split, 80 blocks, where
//   the merge would cost more than the stream it shortens). A split writes
//   its (m, l, acc) partial to scratch, fences, and takes a ticket from its
//   (b, kv-head group) counter; the last block to arrive merges all
//   partials in split order, writes the output and resets the counter to 0,
//   so the counters stay zero between launches and no memset is needed. No
//   float atomics: the same input gives the same bits.
// * No tensor cores: one query row per head gives them nothing to do at
//   G = 1 (a lever for G >= 8 only).
// * Partials across ranks. A cache whose positions are split over ranks
//   needs each rank's softmax state to merge with the others': given an lse
//   pointer, the block that writes a row's output (the unsplit block or the
//   merging one) also writes its log-sum-exp, (m + log2 l) * ln 2 of the
//   base-2 state it already holds, -inf for an empty row. The output's
//   arithmetic is the same with or without it, in the same one launch.
//   A bf16 launch may write its output in f32 (dtype 2, a flag uniform
//   over the launch, not another instantiation): the partial keeps its f32
//   value until the ranks' merge rounds once, as the in-launch merge of
//   splits does; rounded to bf16 it is the bf16 launch's output.
// * bf16 is converted with __bfloat1622float2 / __float2bfloat16 (round to
//   nearest even, as PyTorch's cast).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#define NW 4                      // warps per block
#define NT (NW * 32)
#define STAGES 4                  // ring depth
#define STAGE_BYTES 16384         // K and V of one tile
#define MAX_GROUP_REGS 64         // q and acc f32 per lane, each
#define FULL_MASK 0xffffffffu

template <typename T, int D>
struct Plan {
  static constexpr int ES = (int)sizeof(T);
  static constexpr int VEC = 16 / ES;                 // elements per chunk
  static constexpr int CPR = D / VEC;                 // chunks per row
  static constexpr int LPR =
      CPR >= 32 ? 32 : (CPR >= 16 ? 16 : (CPR >= 8 ? 8 : 4));
  static constexpr int CPL = (CPR + LPR - 1) / LPR;   // chunks per lane
  static constexpr int EPL = CPL * VEC;               // elements per lane
  static constexpr int RPW = 32 / LPR;                // rows per warp at once
  static constexpr int SLOTS = NW * RPW;              // rows per block at once
  static constexpr int TP_RAW = STAGE_BYTES / (2 * D * ES);
  static constexpr int TP_CAP = TP_RAW > 64 ? 64 : TP_RAW;
  static constexpr int TP =                           // positions per tile
      TP_CAP < SLOTS ? SLOTS : (TP_CAP / SLOTS) * SLOTS;
  static constexpr int PP = TP / SLOTS;               // per sub-warp per tile
  static constexpr int RING = STAGES * 2 * TP * D * ES;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  const int n = valid ? 16 : 0;                     // 0: zero-fill, no read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// one 16-byte chunk into f32
__device__ __forceinline__ void cvt16(const uint4 t, float* x,
                                      const float*) {
  x[0] = __uint_as_float(t.x);
  x[1] = __uint_as_float(t.y);
  x[2] = __uint_as_float(t.z);
  x[3] = __uint_as_float(t.w);
}
__device__ __forceinline__ void cvt16(const uint4 t, float* x,
                                      const __nv_bfloat16*) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&t);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    x[2 * j] = f.x;
    x[2 * j + 1] = f.y;
  }
}

__device__ __forceinline__ void store_out(float x, float* p) { *p = x; }
__device__ __forceinline__ void store_out(float x, __nv_bfloat16* p) {
  *p = __float2bfloat16(x);
}
// element i of the output: in T, or in f32 where out_f32 is set (bf16
// inputs whose partial stays f32; uniform over the launch)
template <typename T>
__device__ __forceinline__ void store_row(float x, void* out, int out_f32,
                                          size_t i, const T*) {
  if (out_f32)
    static_cast<float*>(out)[i] = x;
  else
    store_out(x, static_cast<T*>(out) + i);
}

// the lane's chunks of a row at p (global or shared, 16-byte aligned)
template <typename T, int D>
__device__ __forceinline__ void load_row(const T* p, int lr,
                                         float (&x)[Plan<T, D>::EPL]) {
  using P = Plan<T, D>;
#pragma unroll
  for (int c = 0; c < P::CPL; ++c) {
    const int ci = c * P::LPR + lr;
    if (P::CPL == 1 || ci < P::CPR) {
      cvt16(*reinterpret_cast<const uint4*>(p + ci * P::VEC),
            x + c * P::VEC, (const T*)nullptr);
    } else {
#pragma unroll
      for (int e = 0; e < P::VEC; ++e) x[c * P::VEC + e] = 0.0f;
    }
  }
}

// (m, l, acc) <- merge of (m, l, acc) and (mo, lo, ao); -inf m means empty
__device__ __forceinline__ void merge_scale(float m, float mo, float& c,
                                            float& co, float& mx) {
  mx = fmaxf(m, mo);
  c = m == -INFINITY ? 0.0f : exp2f(m - mx);
  co = mo == -INFINITY ? 0.0f : exp2f(mo - mx);
}

// the natural log-sum-exp of a row's logits from its base-2 running max
// and normaliser; -inf for a row with no valid position
__device__ __forceinline__ float lse_of(float mx, float lsum) {
  return mx == -INFINITY ? -INFINITY
                         : (mx + log2f(lsum)) * 0.6931471805599453f;
}

// grid (Hkv * n_gblk, n_split, B), NT threads, Plan::RING (or the merge
// area, if larger) bytes of dynamic shared memory.
template <typename T, int D, int GT>
__global__ void __launch_bounds__(NT)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const int* __restrict__ length,
              void* __restrict__ out, int out_f32, float* __restrict__ lse,
              float* __restrict__ part, int* __restrict__ ticket, int H,
              int Hkv, int S, int chunk, int n_gblk) {
  using P = Plan<T, D>;
  constexpr int EPL = P::EPL;
  constexpr int PS = GT * (D + 2);          // floats of one split's partial
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_last;

  const int n_split = gridDim.y;
  const int split = blockIdx.y;
  const int b = blockIdx.z;
  const int pair = b * gridDim.x + blockIdx.x;
  const int kvh = blockIdx.x / n_gblk;
  const int gblk = blockIdx.x - kvh * n_gblk;
  const int G = H / Hkv;
  const int h0 = kvh * G + gblk * GT;
  const int ng = min(GT, G - gblk * GT);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int lr = lane % P::LPR;             // lane within its row
  const int sw = lane / P::LPR;             // sub-warp within the warp
  constexpr int TPW = P::TP / NW;           // a warp's rows of each tile

  int len = length[b];
  len = len < 0 ? 0 : (len > S ? S : len);
  const int start = split * chunk;
  const int end = min(start + chunk, len);
  const int n_tiles = end > start ? (end - start + P::TP - 1) / P::TP : 0;

  const size_t pos_stride = (size_t)Hkv * D;
  const T* kb = k + ((size_t)b * S * Hkv + kvh) * D;
  const T* vb = v + ((size_t)b * S * Hkv + kvh) * D;
  T* ring = reinterpret_cast<T*>(smem);

  // this warp's rows of tile t (positions start + t*TP + warp*TPW ...)
  // into stage t % STAGES: each warp copies and reads only its own rows
  auto load_tile = [&](int t) {
    const int base = start + t * P::TP;
    T* sk = ring + (size_t)(t % STAGES) * 2 * P::TP * D;
    T* sv = sk + P::TP * D;
    for (int i = lane; i < TPW * P::CPR; i += 32) {
      const int r = warp * TPW + i / P::CPR;
      const int c = i % P::CPR;
      const bool ok = base + r < end;
      const size_t off = (size_t)(ok ? base + r : start) * pos_stride +
                         c * P::VEC;
      cp_async16(sk + r * D + c * P::VEC, kb + off, ok);
      cp_async16(sv + r * D + c * P::VEC, vb + off, ok);
    }
  };
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < n_tiles) load_tile(t);
    cp_async_commit();
  }

  float qf[GT][EPL];
  float m[GT], l[GT], acc[GT][EPL];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    if (g < ng) {
      load_row<T, D>(q + ((size_t)b * H + h0 + g) * D, lr, qf[g]);
    } else {
#pragma unroll
      for (int e = 0; e < EPL; ++e) qf[g][e] = 0.0f;
    }
    m[g] = -INFINITY;
    l[g] = 0.0f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[g][e] = 0.0f;
  }
  // logits in base 2: q scaled once by log2(e)/sqrt(D), then exp2
  const float qscale = 1.4426950408889634f / sqrtf((float)D);
#pragma unroll
  for (int g = 0; g < GT; ++g) {
#pragma unroll
    for (int e = 0; e < EPL; ++e) qf[g][e] *= qscale;
  }

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<STAGES - 2>();            // tile t has landed, and
    __syncwarp();                           // the warp is done with t - 1
    if (t + STAGES - 1 < n_tiles) load_tile(t + STAGES - 1);
    cp_async_commit();

    const int base = start + t * P::TP;
    const T* sk = ring + (size_t)(t % STAGES) * 2 * P::TP * D;
    const T* sv = sk + P::TP * D;
    float s[GT][P::PP];
#pragma unroll
    for (int j = 0; j < P::PP; ++j) {
      float kf[EPL];                        // zero-filled past the end
      load_row<T, D>(sk + (warp * TPW + j * P::RPW + sw) * D, lr, kf);
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        float d = 0.0f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) d = fmaf(qf[g][e], kf[e], d);
        s[g][j] = d;
      }
    }
#pragma unroll
    for (int off = P::LPR / 2; off > 0; off >>= 1) {
#pragma unroll
      for (int g = 0; g < GT; ++g) {
#pragma unroll
        for (int j = 0; j < P::PP; ++j)
          s[g][j] += __shfl_xor_sync(FULL_MASK, s[g][j], off);
      }
    }
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      float mt = m[g];
#pragma unroll
      for (int j = 0; j < P::PP; ++j) {
        s[g][j] = base + warp * TPW + j * P::RPW + sw < end ? s[g][j]
                                                             : -INFINITY;
        mt = fmaxf(mt, s[g][j]);
      }
      // all of this sub-warp's positions so far masked: nothing to add
      const float alpha = mt == -INFINITY ? 1.0f : exp2f(m[g] - mt);
      float psum = 0.0f;
#pragma unroll
      for (int j = 0; j < P::PP; ++j) {
        s[g][j] = s[g][j] == -INFINITY ? 0.0f : exp2f(s[g][j] - mt);
        psum += s[g][j];
      }
      l[g] = l[g] * alpha + psum;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[g][e] *= alpha;
      m[g] = mt;
    }
#pragma unroll
    for (int j = 0; j < P::PP; ++j) {
      float vf[EPL];                        // zero-filled past the end
      load_row<T, D>(sv + (warp * TPW + j * P::RPW + sw) * D, lr, vf);
#pragma unroll
      for (int g = 0; g < GT; ++g) {
#pragma unroll
        for (int e = 0; e < EPL; ++e)
          acc[g][e] = fmaf(s[g][j], vf[e], acc[g][e]);
      }
    }
  }
  cp_async_wait<0>();

  // sub-warps of a warp: fixed tree, sub-warp 0 ends with the warp's state
#pragma unroll
  for (int off = P::LPR; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      const float mo = __shfl_down_sync(FULL_MASK, m[g], off);
      const float lo = __shfl_down_sync(FULL_MASK, l[g], off);
      float c, co, mx;
      merge_scale(m[g], mo, c, co, mx);
      l[g] = fmaf(lo, co, l[g] * c);
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        const float ao = __shfl_down_sync(FULL_MASK, acc[g][e], off);
        acc[g][e] = fmaf(ao, co, acc[g][e] * c);
      }
      m[g] = mx;
    }
  }

  // warps: through shared memory (the ring is free now), in warp order
  __syncthreads();
  float* sm_acc = reinterpret_cast<float*>(smem);   // [NW][GT][D]
  float* sm_ml = sm_acc + NW * GT * D;              // [NW][GT][2]
  if (lane < P::LPR) {
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      if (lr == 0) {
        sm_ml[(warp * GT + g) * 2] = m[g];
        sm_ml[(warp * GT + g) * 2 + 1] = l[g];
      }
#pragma unroll
      for (int c = 0; c < P::CPL; ++c) {
        const int ci = c * P::LPR + lr;
        if (P::CPL == 1 || ci < P::CPR) {
#pragma unroll
          for (int e = 0; e < P::VEC; ++e)
            sm_acc[(warp * GT + g) * D + ci * P::VEC + e] =
                acc[g][c * P::VEC + e];
        }
      }
    }
  }
  __syncthreads();

  float* pp = n_split == 1 ? nullptr : part + (size_t)pair * n_split * PS;
  for (int idx = threadIdx.x; idx < ng * D; idx += NT) {
    const int g = idx / D;
    const int d = idx - g * D;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < NW; ++w) mx = fmaxf(mx, sm_ml[(w * GT + g) * 2]);
    float lsum = 0.0f, asum = 0.0f;
    if (mx != -INFINITY) {
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        const float mw = sm_ml[(w * GT + g) * 2];
        if (mw != -INFINITY) {
          const float c = exp2f(mw - mx);
          lsum = fmaf(sm_ml[(w * GT + g) * 2 + 1], c, lsum);
          asum = fmaf(sm_acc[(w * GT + g) * D + d], c, asum);
        }
      }
    }
    if (n_split == 1) {
      store_row(asum / fmaxf(lsum, 1e-30f), out, out_f32,
                ((size_t)b * H + h0 + g) * D + d, (const T*)nullptr);
      if (lse != nullptr && d == 0)
        lse[(size_t)b * H + h0 + g] = lse_of(mx, lsum);
    } else {
      float* ps = pp + (size_t)split * PS;
      ps[g * D + d] = asum;
      if (d == 0) {
        ps[GT * D + g] = mx;
        ps[GT * D + GT + g] = lsum;
      }
    }
  }
  if (n_split == 1) return;

  // the last split of this (b, kv-head group) to arrive merges them all
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    s_last = atomicAdd(ticket + pair, 1) == n_split - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  for (int idx = threadIdx.x; idx < ng * D; idx += NT) {
    const int g = idx / D;
    const int d = idx - g * D;
    float mx = -INFINITY;
    for (int sp = 0; sp < n_split; ++sp)
      mx = fmaxf(mx, __ldcg(pp + (size_t)sp * PS + GT * D + g));
    float lsum = 0.0f, asum = 0.0f;
    if (mx != -INFINITY) {
      for (int sp = 0; sp < n_split; ++sp) {
        const float* ps = pp + (size_t)sp * PS;
        const float ms = __ldcg(ps + GT * D + g);
        if (ms != -INFINITY) {
          const float c = exp2f(ms - mx);
          lsum = fmaf(__ldcg(ps + GT * D + GT + g), c, lsum);
          asum = fmaf(__ldcg(ps + g * D + d), c, asum);
        }
      }
    }
    store_row(asum / fmaxf(lsum, 1e-30f), out, out_f32,
              ((size_t)b * H + h0 + g) * D + d, (const T*)nullptr);
    if (lse != nullptr && d == 0)
      lse[(size_t)b * H + h0 + g] = lse_of(mx, lsum);
  }
  if (threadIdx.x == 0) ticket[pair] = 0;
}

template <typename T, int D, int GT>
static int launch(const void* q, const void* k, const void* v,
                  const void* length, void* out, int out_f32, void* lse,
                  void* part,
                  void* ticket,
                  int B, int H, int Hkv, int S, int chunk, int n_split,
                  int n_gblk, cudaStream_t st) {
  using P = Plan<T, D>;
  constexpr int MERGE = NW * GT * (D + 2) * (int)sizeof(float);
  constexpr int SMEM = P::RING > MERGE ? P::RING : MERGE;
  auto kern = decode_kernel<T, D, GT>;
  static unsigned long long sized = 0;      // per device, bit = ordinal
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 64 && !((sized >> dev) & 1ull)) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM);
    if (e != cudaSuccess) return (int)e;
    sized |= 1ull << dev;
  }
  dim3 grid((unsigned)(Hkv * n_gblk), (unsigned)n_split, (unsigned)B);
  kern<<<grid, NT, SMEM, st>>>((const T*)q, (const T*)k, (const T*)v,
                               (const int*)length, out, out_f32, (float*)lse,
                               (float*)part, (int*)ticket, H, Hkv, S, chunk,
                               n_gblk);
  return (int)cudaGetLastError();
}

template <typename T, int D>
static int by_group(int gt, const void* q, const void* k, const void* v,
                    const void* length, void* out, int out_f32, void* lse,
                    void* part,
                    void* ticket,
                    int B, int H, int Hkv, int S, int chunk, int n_split,
                    int n_gblk, cudaStream_t st) {
  // only the groups whose q and acc fit in registers are built (the
  // wrapper's group_plan never asks for another)
  switch (gt) {
#define CASE(G)                                                            \
  case G:                                                                  \
    if constexpr (G * Plan<T, D>::EPL <= MAX_GROUP_REGS)                   \
      return launch<T, D, G>(q, k, v, length, out, out_f32, lse, part,     \
                             ticket, B, H, Hkv, S, chunk, n_split, n_gblk, \
                             st);                                          \
    break;
    CASE(1) CASE(2) CASE(4) CASE(8)
#undef CASE
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T>
static int by_dim(int D, int gt, const void* q, const void* k, const void* v,
                  const void* length, void* out, int out_f32, void* lse,
                  void* part,
                  void* ticket,
                  int B, int H, int Hkv, int S, int chunk, int n_split,
                  int n_gblk, cudaStream_t st) {
  switch (D) {
#define CASE(DD)                                                          \
  case DD:                                                                \
    return by_group<T, DD>(gt, q, k, v, length, out, out_f32, lse, part,  \
                           ticket, B, H, Hkv, S, chunk, n_split, n_gblk, st);
    CASE(32) CASE(64) CASE(96) CASE(128) CASE(160) CASE(192) CASE(224)
    CASE(256)
#undef CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// q, out [B,H,D]; k, v [B,S,Hkv,D]; length [B] int32; lse [B,H] f32 or
// null (when given, each row's log-sum-exp of its scaled logits, -inf for
// a row of length 0; the output is the same either way); dtype 0 = f32,
// 1 = bf16, 2 = bf16 inputs and an f32 output. D is a multiple of 32 up to 256 and H a multiple of Hkv. Each
// kv head's G = H/Hkv query heads are served n_gblk blocks of gt heads
// (gt in 1, 2, 4, 8; gt * n_gblk >= G > gt * (n_gblk - 1)). Positions
// [i*chunk, (i+1)*chunk) go to split i. With n_split > 1, part holds
// B*Hkv*n_gblk*n_split*gt*(D+2) f32 of scratch and ticket B*Hkv*n_gblk
// int32 counters that are zero on entry (and left zero). Returns
// cudaGetLastError() after the launch.
extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const void* length, void* out, void* lse,
                                void* part, void* ticket, int B, int H,
                                int Hkv, int S, int D, int gt, int n_gblk,
                                int chunk, int n_split, int dtype,
                                void* stream) {
  if (B <= 0 || H <= 0 || Hkv <= 0 || S <= 0 || H % Hkv != 0 ||
      chunk <= 0 || n_split <= 0 || n_split > 65535 || B > 65535 ||
      n_gblk <= 0 || (long long)chunk * n_split < S ||
      (long long)gt * n_gblk < H / Hkv || gt * (n_gblk - 1) >= H / Hkv ||
      (n_split > 1 && (part == nullptr || ticket == nullptr)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return by_dim<float>(D, gt, q, k, v, length, out, 0, lse, part, ticket,
                         B, H, Hkv, S, chunk, n_split, n_gblk, st);
  if (dtype == 1 || dtype == 2)
    return by_dim<__nv_bfloat16>(D, gt, q, k, v, length, out, dtype == 2,
                                 lse, part, ticket, B, H, Hkv, S, chunk,
                                 n_split, n_gblk, st);
  return (int)cudaErrorInvalidValue;
}
