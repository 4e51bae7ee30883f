// Decode attention over a contiguous KV cache for Hopper: one query per
// slot, attended to the slot's live prefix, as an online-softmax state.
//
// Replaces src/repro/kernels/decode_attn.py::decode_attn_pallas (kernel body
// _decode_attn_kernel, wrapper ops.decode_attention_state). For every slot b
// and KV head h it attends the slot's grouped queries q[b, h] (R = rep rows,
// pre-scaled, in the cache dtype) to the cache rows k/v[b, 0:len, h] of the
// contiguous (B, S_max, KV, Dh) caches, len = min(lengths[b], S_max), and
// returns the unnormalised state: acc (B,KV,R,Dh), m and l (B,KV,R), all
// f32. An empty slot gives m=-inf, l=0, acc=0, which the self-term merge
// (models/common._merge_self_term) needs.
//
// What bounds it on the H100: the bytes of the live K/V rows (2 * len * Dh
// elements per slot and head), read once; the MACs are 4*R*Dh per row, far
// below the card's rate at R <= 8.
//
// Design. The TPU kernel walks a (slot, S_max / block_s) grid sequentially,
// carrying the state in revisited output blocks and visiting every block up
// to S_max. Here the blocks run in parallel, so the walk is split
// (flash-decoding style): thread block (h, b, s) owns rows
// [s*split, (s+1)*split) of slot b, exits at once if they hold no live row,
// and walks only the live ones, TILE rows at a time:
//   * scores: each warp takes a cache row, its lanes read the row's Dh
//     elements (coalesced, kept in registers) and a warp reduction gives
//     the f32 sum of products for each of the R queries;
//   * online softmax: one warp per query row, one lane per tile row; p is
//     rounded to the cache dtype (a no-op for f32) before the PV product,
//     and l sums the unrounded p;
//   * PV: thread (t, d) walks the tile's V rows (coalesced across d) and
//     rescales its f32 accumulator, kept in shared memory.
// Each split writes its partial state; a second kernel merges the live
// splits of every (slot, head) in split order (deterministic). Tensor-core
// MMAs and TMA are later work. The wrapper (kernels/decode_attn.py)
// allocates the outputs and the partials; this file allocates nothing and
// launches on the caller's stream.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
// rows per online-softmax update, one per lane; kernels/decode_attn.py's
// TILE_ROWS models the same walk
constexpr int TILE = 32;
constexpr int MAX_DW = 8;       // Dh / 32 at most: Dh <= 256

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
// p rounded to the cache dtype, as the reference's p.astype(v.dtype)
__device__ __forceinline__ float round_as(float p, const float*) { return p; }
__device__ __forceinline__ float round_as(float p, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(p));
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}
__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ int live_len(const int* lengths, int b, int S) {
  const int n = lengths[b];
  return n < 0 ? 0 : (n < S ? n : S);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
decode_attn_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v,
                         const int* __restrict__ lengths,
                         float* __restrict__ acc_p, float* __restrict__ m_p,
                         float* __restrict__ l_p, int B, int S, int KV, int R,
                         int Dh, int split) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int s = blockIdx.z;
  const int len = live_len(lengths, b, S);
  const int r0 = s * split;
  if (r0 >= len) return;                 // no live row here (block-uniform)
  const int r1 = r0 + split < len ? r0 + split : len;

  extern __shared__ float smem[];
  float* q_s = smem;                     // R x Dh
  float* acc_s = q_s + R * Dh;           // R x Dh
  float* p_s = acc_s + R * Dh;           // R x TILE
  float* m_s = p_s + R * TILE;           // R
  float* l_s = m_s + R;                  // R
  float* alpha_s = l_s + R;              // R
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_dw = Dh >> 5;

  const size_t q_base = ((size_t)b * KV + h) * R * Dh;
  for (int i = tid; i < R * Dh; i += THREADS) {
    q_s[i] = to_f32(q[q_base + i]);
    acc_s[i] = 0.f;
  }
  for (int t = tid; t < R; t += THREADS) {
    m_s[t] = -INFINITY;
    l_s[t] = 0.f;
  }
  __syncthreads();

  const size_t row_stride = (size_t)KV * Dh;          // one cache row
  const size_t slot_base = (size_t)b * S * row_stride + (size_t)h * Dh;
  for (int t0 = r0; t0 < r1; t0 += TILE) {
    const int rows = r1 - t0 < TILE ? r1 - t0 : TILE;
    // scores (R, TILE): contract Dh; rows past the live prefix are -inf
    for (int r = warp; r < TILE; r += WARPS) {
      if (r >= rows) {
        for (int t = lane; t < R; t += 32) p_s[t * TILE + r] = -INFINITY;
        continue;
      }
      const T* kr = k + slot_base + (size_t)(t0 + r) * row_stride;
      float kv[MAX_DW];
#pragma unroll
      for (int j = 0; j < MAX_DW; ++j)
        kv[j] = j < n_dw ? to_f32(kr[lane + 32 * j]) : 0.f;
      for (int t = 0; t < R; ++t) {
        const float* qr = q_s + t * Dh;
        float part = 0.f;
#pragma unroll
        for (int j = 0; j < MAX_DW; ++j)
          if (j < n_dw) part = fmaf(qr[lane + 32 * j], kv[j], part);
        part = warp_sum(part);
        if (lane == 0) p_s[t * TILE + r] = part;
      }
    }
    __syncthreads();
    // online-softmax row update; p_s becomes the rounded probabilities
    for (int t = warp; t < R; t += WARPS) {
      const float sc = p_s[t * TILE + lane];
      const float m_prev = m_s[t];
      const float m_new = fmaxf(m_prev, warp_max(sc));
      const float m_safe = isfinite(m_new) ? m_new : 0.f;  // all masked
      const float p = lane < rows ? expf(sc - m_safe) : 0.f;
      const float sum = warp_sum(p);
      p_s[t * TILE + lane] = round_as(p, k);
      if (lane == 0) {
        const float alpha = isfinite(m_prev) ? expf(m_prev - m_safe) : 0.f;
        l_s[t] = l_s[t] * alpha + sum;
        alpha_s[t] = alpha;
        m_s[t] = m_new;
      }
    }
    __syncthreads();
    // acc = acc * alpha + p @ v
    const T* vt = v + slot_base + (size_t)t0 * row_stride;
    for (int i = tid; i < R * Dh; i += THREADS) {
      const int t = i / Dh, d = i % Dh;
      const float* pr = p_s + t * TILE;
      float s0 = 0.f, s1 = 0.f;
      int r = 0;
      for (; r + 1 < rows; r += 2) {
        s0 = fmaf(pr[r], to_f32(vt[(size_t)r * row_stride + d]), s0);
        s1 = fmaf(pr[r + 1], to_f32(vt[(size_t)(r + 1) * row_stride + d]),
                  s1);
      }
      if (r < rows) s0 = fmaf(pr[r], to_f32(vt[(size_t)r * row_stride + d]),
                              s0);
      acc_s[i] = acc_s[i] * alpha_s[t] + (s0 + s1);
    }
    __syncthreads();
  }

  const size_t part = ((size_t)s * B + b) * KV + h;
  for (int i = tid; i < R * Dh; i += THREADS)
    acc_p[part * R * Dh + i] = acc_s[i];
  for (int t = tid; t < R; t += THREADS) {
    m_p[part * R + t] = m_s[t];
    l_p[part * R + t] = l_s[t];
  }
}

// Merge the live splits of each (slot, head), in split order. A slot with
// no live row has no split: m = -inf, l = 0, acc = 0.
__global__ void __launch_bounds__(THREADS)
decode_attn_merge_kernel(const float* __restrict__ acc_p,
                         const float* __restrict__ m_p,
                         const float* __restrict__ l_p,
                         const int* __restrict__ lengths,
                         float* __restrict__ acc_out,
                         float* __restrict__ m_out, float* __restrict__ l_out,
                         int B, int S, int KV, int R, int Dh, int split) {
  extern __shared__ float m_all[];        // R: the merged max per row
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int n_split = (live_len(lengths, b, S) + split - 1) / split;
  const size_t out = (size_t)b * KV + h;
  for (int t = tid; t < R; t += THREADS) {
    float mx = -INFINITY;
    for (int s = 0; s < n_split; ++s)
      mx = fmaxf(mx, m_p[(((size_t)s * B + b) * KV + h) * R + t]);
    float l = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const size_t idx = (((size_t)s * B + b) * KV + h) * R + t;
      l += l_p[idx] * expf(m_p[idx] - mx);   // live splits: m finite
    }
    m_all[t] = mx;
    m_out[out * R + t] = mx;
    l_out[out * R + t] = l;
  }
  __syncthreads();
  for (int i = tid; i < R * Dh; i += THREADS) {
    const int t = i / Dh;
    float a = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const size_t part = ((size_t)s * B + b) * KV + h;
      a += acc_p[part * R * Dh + i] * expf(m_p[part * R + t] - m_all[t]);
    }
    acc_out[out * R * Dh + i] = a;
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* lengths,
           void* acc, void* m, void* l, void* acc_p, void* m_p, void* l_p,
           int B, int S, int KV, int R, int Dh, int split,
           cudaStream_t st) {
  const long long smem =
      (long long)sizeof(float) * (2LL * R * Dh + (long long)R * TILE + 3LL * R);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        decode_attn_split_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int n_split = (S + split - 1) / split;
  decode_attn_split_kernel<T><<<dim3(KV, B, n_split), THREADS, (size_t)smem,
                                st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(lengths),
      static_cast<float*>(acc_p), static_cast<float*>(m_p),
      static_cast<float*>(l_p), B, S, KV, R, Dh, split);
  decode_attn_merge_kernel<<<dim3(KV, B), THREADS, R * sizeof(float), st>>>(
      static_cast<const float*>(acc_p), static_cast<const float*>(m_p),
      static_cast<const float*>(l_p), static_cast<const int*>(lengths),
      static_cast<float*>(acc), static_cast<float*>(m),
      static_cast<float*>(l), B, S, KV, R, Dh, split);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B,KV,R,Dh) and k/v (B,S,KV,Dh) in one dtype: bf16 (is_bf16=1) or f32;
// lengths (B,) i32; acc (B,KV,R,Dh), m, l (B,KV,R) f32. Partials: acc_p
// (n_split,B,KV,R,Dh), m_p, l_p (n_split,B,KV,R) f32 with n_split =
// ceil(S / split). B, KV, R > 0; Dh % 32 == 0 and Dh <= 256; split % 32 ==
// 0. Returns cudaGetLastError() after the launches.
extern "C" int decode_attn(const void* q, const void* k, const void* v,
                           const void* lengths, void* acc, void* m, void* l,
                           void* acc_p, void* m_p, void* l_p, int B, int S,
                           int KV, int R, int Dh, int split, int is_bf16,
                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(q, k, v, lengths, acc, m, l, acc_p, m_p, l_p,
                                 B, S, KV, R, Dh, split, st);
  return launch<float>(q, k, v, lengths, acc, m, l, acc_p, m_p, l_p, B, S,
                       KV, R, Dh, split, st);
}
