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
// by max(l, 1e-30), and the output rounded to q's dtype. q [B,H,D],
// k/v [B,S,Hkv,D], out [B,H,D]: all f32 or all bf16; length [B] int32.
//
// Bound on the card: memory bytes. Each valid cache position is read once
// (K and V rows of D elements per kv head) and used for at most G = H/Hkv
// dot products of length D: ~2G flops per byte in bf16, far below the
// card's ratio of operations to bytes.
//
// Design:
// * Blocks run in parallel and in no order, so nothing carries across
//   blocks: a loop inside the block walks the cache instead of the TPU's
//   sequential kv grid axis. One block serves one (b, kv head, split of S)
//   and up to GMAX query heads of that kv head, so each K/V row is read
//   once for its whole group.
// * The loop stops at length[b]: positions past it are neither read nor
//   counted, which also handles a ragged tail (S need not be a multiple of
//   any block size; the serve path's cache is prompt + new tokens long).
// * Four warps split the block's positions in tiles of TILE positions; a
//   lane holds D/32 contiguous elements of q, of each K/V row and of the
//   accumulator (vector loads of 8 or 16 bytes for D = 128), the dot product
//   is reduced with an xor butterfly so every lane holds the same logit, and
//   each warp keeps its own (m, l, acc). The tile's K and V rows are loaded
//   together before any arithmetic, so 2*TILE row loads are in flight per
//   warp.
// * The warps' states are merged in shared memory in fixed warp order.
// * When B*Hkv blocks would leave the SMs idle (long caches), the wrapper
//   splits S across blocks; each split writes its (m, l, acc) partial to
//   scratch and a second kernel merges the splits in fixed order. There are
//   no float atomics, so same-input runs are bit-identical on the card.
// * bf16 is converted with __bfloat162float / __float2bfloat16 (round to
//   nearest even, as PyTorch's cast). No wgmma and no TMA: a single query
//   row gives the tensor cores nothing to do, and the byte stream is
//   served by plain vector loads.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#define NW 4
#define NT (NW * 32)
#define GMAX 4
#define FULL_MASK 0xffffffffu

__device__ __forceinline__ void store_out(float x, float* p) { *p = x; }
__device__ __forceinline__ void store_out(float x, __nv_bfloat16* p) {
  *p = __float2bfloat16(x);
}

// EPL contiguous elements at p (aligned to their size) into f32 registers.
template <int EPL>
__device__ __forceinline__ void load_vec(const float* __restrict__ p,
                                         float (&x)[EPL]) {
  if constexpr (EPL % 4 == 0) {
#pragma unroll
    for (int i = 0; i < EPL / 4; ++i) {
      const float4 t = reinterpret_cast<const float4*>(p)[i];
      x[4 * i] = t.x;
      x[4 * i + 1] = t.y;
      x[4 * i + 2] = t.z;
      x[4 * i + 3] = t.w;
    }
  } else if constexpr (EPL % 2 == 0) {
#pragma unroll
    for (int i = 0; i < EPL / 2; ++i) {
      const float2 t = reinterpret_cast<const float2*>(p)[i];
      x[2 * i] = t.x;
      x[2 * i + 1] = t.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < EPL; ++i) x[i] = p[i];
  }
}

template <int EPL>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* __restrict__ p,
                                         float (&x)[EPL]) {
  if constexpr (EPL % 8 == 0) {
#pragma unroll
    for (int i = 0; i < EPL / 8; ++i) {
      const uint4 t = reinterpret_cast<const uint4*>(p)[i];
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&t);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(h[j]);
        x[8 * i + 2 * j] = f.x;
        x[8 * i + 2 * j + 1] = f.y;
      }
    }
  } else if constexpr (EPL % 4 == 0) {
#pragma unroll
    for (int i = 0; i < EPL / 4; ++i) {
      const uint2 t = reinterpret_cast<const uint2*>(p)[i];
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&t);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float2 f = __bfloat1622float2(h[j]);
        x[4 * i + 2 * j] = f.x;
        x[4 * i + 2 * j + 1] = f.y;
      }
    }
  } else if constexpr (EPL % 2 == 0) {
#pragma unroll
    for (int i = 0; i < EPL / 2; ++i) {
      const float2 f = __bfloat1622float2(
          reinterpret_cast<const __nv_bfloat162*>(p)[i]);
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < EPL; ++i) x[i] = __bfloat162float(p[i]);
  }
}

// grid (n_split, Hkv * n_gblk, B), NT threads. D = 32 * EPL.
template <typename T, int EPL>
__global__ void __launch_bounds__(NT)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ length,
                    T* __restrict__ out, float* __restrict__ part_m,
                    float* __restrict__ part_l, float* __restrict__ part_acc,
                    int H, int Hkv, int S, int chunk, int n_gblk) {
  constexpr int D = 32 * EPL;
  constexpr int TILE = EPL >= 8 ? 4 : 8;
  const int split = blockIdx.x;
  const int n_split = gridDim.x;
  const int kvh = blockIdx.y / n_gblk;
  const int gblk = blockIdx.y % n_gblk;
  const int b = blockIdx.z;
  const int G = H / Hkv;
  const int h0 = kvh * G + gblk * GMAX;
  const int ng = min(GMAX, G - gblk * GMAX);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  int len = length[b];
  len = len < 0 ? 0 : (len > S ? S : len);
  const int start = split * chunk;
  const int end = min(start + chunk, len);
  const float sqrt_d = sqrtf((float)D);

  float qf[GMAX][EPL];
  float m[GMAX], l[GMAX], acc[GMAX][EPL];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    if (g < ng) {
      load_vec<EPL>(q + ((size_t)b * H + h0 + g) * D + lane * EPL, qf[g]);
    } else {
#pragma unroll
      for (int e = 0; e < EPL; ++e) qf[g][e] = 0.0f;
    }
    m[g] = -INFINITY;
    l[g] = 0.0f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[g][e] = 0.0f;
  }

  const size_t pos_stride = (size_t)Hkv * D;
  const T* kb = k + ((size_t)b * S * Hkv + kvh) * D + lane * EPL;
  const T* vb = v + ((size_t)b * S * Hkv + kvh) * D + lane * EPL;

  for (int base = start + warp * TILE; base < end; base += NW * TILE) {
    float kf[TILE][EPL], vf[TILE][EPL];
#pragma unroll
    for (int t = 0; t < TILE; ++t) {
      if (base + t < end) {
        load_vec<EPL>(kb + (size_t)(base + t) * pos_stride, kf[t]);
        load_vec<EPL>(vb + (size_t)(base + t) * pos_stride, vf[t]);
      } else {
#pragma unroll
        for (int e = 0; e < EPL; ++e) kf[t][e] = vf[t][e] = 0.0f;
      }
    }
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      if (g >= ng) break;
      float s[TILE];
#pragma unroll
      for (int t = 0; t < TILE; ++t) {
        float d = 0.0f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) d = fmaf(qf[g][e], kf[t][e], d);
        s[t] = d;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
        for (int t = 0; t < TILE; ++t)
          s[t] += __shfl_xor_sync(FULL_MASK, s[t], off);
      }
      // base < end, so position base is valid and mt is finite
      float mt = m[g];
#pragma unroll
      for (int t = 0; t < TILE; ++t) {
        s[t] = (base + t < end) ? s[t] / sqrt_d : -INFINITY;
        mt = fmaxf(mt, s[t]);
      }
      const float alpha = expf(m[g] - mt);       // 0 while m is -inf
      float p[TILE];
      float psum = 0.0f;
#pragma unroll
      for (int t = 0; t < TILE; ++t) {
        p[t] = expf(s[t] - mt);                   // 0 for masked slots
        psum += p[t];
      }
      l[g] = l[g] * alpha + psum;
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        float a = acc[g][e] * alpha;
#pragma unroll
        for (int t = 0; t < TILE; ++t) a = fmaf(p[t], vf[t][e], a);
        acc[g][e] = a;
      }
      m[g] = mt;
    }
  }

  // merge the warps' states in fixed warp order
  __shared__ float sm_m[NW][GMAX];
  __shared__ float sm_l[NW][GMAX];
  __shared__ float sm_acc[NW][GMAX][D];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    if (lane == 0) {
      sm_m[warp][g] = m[g];
      sm_l[warp][g] = l[g];
    }
#pragma unroll
    for (int e = 0; e < EPL; ++e) sm_acc[warp][g][lane * EPL + e] = acc[g][e];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < ng * D; idx += NT) {
    const int g = idx / D;
    const int d = idx - g * D;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < NW; ++w) mx = fmaxf(mx, sm_m[w][g]);
    float lsum = 0.0f, asum = 0.0f;
    if (mx != -INFINITY) {
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        const float mw = sm_m[w][g];
        if (mw != -INFINITY) {
          const float c = expf(mw - mx);
          lsum = fmaf(sm_l[w][g], c, lsum);
          asum = fmaf(sm_acc[w][g][d], c, asum);
        }
      }
    }
    const size_t bh = (size_t)b * H + h0 + g;
    if (n_split == 1) {
      store_out(asum / fmaxf(lsum, 1e-30f), out + bh * D + d);
    } else {
      const size_t pi = bh * n_split + split;
      if (d == 0) {
        part_m[pi] = mx;
        part_l[pi] = lsum;
      }
      part_acc[pi * D + d] = asum;
    }
  }
}

// grid (B*H), D threads: merge the n_split partials of each (b, h) in
// fixed split order and write the output.
template <typename T>
__global__ void decode_combine_kernel(const float* __restrict__ part_m,
                                      const float* __restrict__ part_l,
                                      const float* __restrict__ part_acc,
                                      T* __restrict__ out, int n_split,
                                      int D) {
  const size_t bh = blockIdx.x;
  const size_t p0 = bh * n_split;
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float mx = -INFINITY;
    for (int s = 0; s < n_split; ++s) mx = fmaxf(mx, part_m[p0 + s]);
    float lsum = 0.0f, asum = 0.0f;
    if (mx != -INFINITY) {
      for (int s = 0; s < n_split; ++s) {
        const float ms = part_m[p0 + s];
        if (ms != -INFINITY) {
          const float c = expf(ms - mx);
          lsum = fmaf(part_l[p0 + s], c, lsum);
          asum = fmaf(part_acc[(p0 + s) * D + d], c, asum);
        }
      }
    }
    store_out(asum / fmaxf(lsum, 1e-30f), out + bh * D + d);
  }
}

template <typename T, int EPL>
static int launch(const void* q, const void* k, const void* v,
                  const void* length, void* out, void* part_m, void* part_l,
                  void* part_acc, int B, int H, int Hkv, int S, int chunk,
                  int n_split, cudaStream_t st) {
  const int G = H / Hkv;
  const int n_gblk = (G + GMAX - 1) / GMAX;
  dim3 grid((unsigned)n_split, (unsigned)(Hkv * n_gblk), (unsigned)B);
  decode_split_kernel<T, EPL><<<grid, NT, 0, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const int*)length, (T*)out,
      (float*)part_m, (float*)part_l, (float*)part_acc, H, Hkv, S, chunk,
      n_gblk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return (int)err;
  decode_combine_kernel<T><<<(unsigned)(B * H), 32 * EPL, 0, st>>>(
      (const float*)part_m, (const float*)part_l, (const float*)part_acc,
      (T*)out, n_split, 32 * EPL);
  return (int)cudaGetLastError();
}

template <typename T>
static int dispatch(int epl, const void* q, const void* k, const void* v,
                    const void* length, void* out, void* pm, void* pl,
                    void* pa, int B, int H, int Hkv, int S, int chunk,
                    int n_split, cudaStream_t st) {
  switch (epl) {
#define CASE(E)                                                           \
  case E:                                                                 \
    return launch<T, E>(q, k, v, length, out, pm, pl, pa, B, H, Hkv, S,   \
                        chunk, n_split, st);
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
#undef CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// q, out [B,H,D]; k, v [B,S,Hkv,D]; length [B] int32; dtype 0 = f32,
// 1 = bf16. D is a multiple of 32 up to 256 and H a multiple of Hkv. With
// n_split > 1, part_m / part_l [B,H,n_split] and part_acc [B,H,n_split,D]
// f32 are scratch; positions [i*chunk, (i+1)*chunk) go to split i.
// Returns cudaGetLastError() after the launches.
extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const void* length, void* out, void* part_m,
                                void* part_l, void* part_acc, int B, int H,
                                int Hkv, int S, int D, int chunk, int n_split,
                                int dtype, void* stream) {
  if (B <= 0 || H <= 0 || Hkv <= 0 || S <= 0 || H % Hkv != 0 ||
      D % 32 != 0 || D < 32 || D > 256 || chunk <= 0 || n_split <= 0 ||
      (long long)chunk * n_split < S)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return dispatch<float>(D / 32, q, k, v, length, out, part_m, part_l,
                           part_acc, B, H, Hkv, S, chunk, n_split, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(D / 32, q, k, v, length, out, part_m,
                                   part_l, part_acc, B, H, Hkv, S, chunk,
                                   n_split, st);
  return (int)cudaErrorInvalidValue;
}
