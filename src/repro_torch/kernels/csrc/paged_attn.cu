// Paged attention over the block-paged KV pool for Hopper: the context half
// of chunk attention.
//
// Replaces src/repro/kernels/paged_attn.py::paged_attn_pallas (kernel body
// _paged_attn_kernel, wrapper ops.paged_attention_state). For every slot b
// and KV head h it attends the slot's grouped chunk queries
// q[b, h] (TR = T*rep rows, pre-scaled, bf16) to the slot's cached context,
// reached through block_tables[b] into the (n_blocks, bs, KV, Dh) bf16
// pools and masked to kv_pos < ctx_lens[b], and returns the unnormalised
// online-softmax state: acc (B,KV,TR,Dh), m and l (B,KV,TR), all f32. An
// empty context gives m=-inf, l=0, acc=0, which merge_attn_states needs.
//
// What bounds it on the H100: the bytes of the live K/V rows (2 * ctx * Dh
// bf16 per slot and head), read once; the MACs are 4*TR*Dh per row, far
// below the tensor cores' rate at TR=16.
//
// Design. The TPU kernel walks a (slot, max_blocks) grid sequentially,
// carrying the state in revisited output blocks, with the table and
// lengths scalar-prefetched. On the GPU the blocks run in parallel and
// nothing carries over between them, so the walk is split (flash-decoding
// style): thread block (h, b, s) owns pool blocks [s*BPS, (s+1)*BPS) of
// slot b's table for head h, reads the table and ctx_len itself, exits at
// once if its range holds no live row, and walks only live blocks:
//   * each 16 x Dh K and V block is staged in shared memory as f32 (rows
//     padded by one float so the score loop is free of bank conflicts);
//   * scores are f32 sums of bf16 products; the TR running (m, l) and the
//     TR x Dh accumulator stay in shared memory in f32;
//   * p is rounded to bf16 before the PV product, as the reference does,
//     and l sums the unrounded p.
// Each split writes its partial state; a second kernel merges the live
// splits of every (slot, head) in a fixed order (deterministic), so a
// long context keeps many blocks busy instead of one. Tensor-core MMAs
// are later work. The wrapper (kernels/paged_attn.py) allocates the
// outputs and the partials; this file allocates nothing and launches on
// the caller's stream.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int THREADS = 128;

__device__ __forceinline__ int live_blocks(int ctx, int BS, int max_blocks) {
  int n = ctx > 0 ? (ctx + BS - 1) / BS : 0;
  return n < max_blocks ? n : max_blocks;
}

__global__ void __launch_bounds__(THREADS)
paged_attn_split_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k_pool,
                        const __nv_bfloat16* __restrict__ v_pool,
                        const int* __restrict__ tables,
                        const int* __restrict__ ctx_lens,
                        float* __restrict__ acc_p, float* __restrict__ m_p,
                        float* __restrict__ l_p, int B, int KV, int TR,
                        int Dh, int n_blocks, int BS, int max_blocks,
                        int bps) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int s = blockIdx.z;
  const int ctx = ctx_lens[b];
  const int n_live = live_blocks(ctx, BS, max_blocks);
  const int j0 = s * bps;
  if (j0 >= n_live) return;              // no live row here (block-uniform)
  const int j1 = j0 + bps < n_live ? j0 + bps : n_live;

  extern __shared__ float smem[];
  const int ld = Dh + 1;
  float* q_s = smem;                       // TR x ld
  float* k_s = q_s + TR * ld;              // BS x ld
  float* v_s = k_s + BS * ld;              // BS x Dh
  float* acc_s = v_s + BS * Dh;            // TR x Dh
  float* p_s = acc_s + TR * Dh;            // TR x BS
  float* m_s = p_s + TR * BS;              // TR
  float* l_s = m_s + TR;                   // TR
  float* alpha_s = l_s + TR;               // TR
  const int tid = threadIdx.x;

  const size_t q_base = ((size_t)b * KV + h) * TR * Dh;
  for (int i = tid; i < TR * Dh; i += THREADS) {
    const int t = i / Dh, d = i % Dh;
    q_s[t * ld + d] = __bfloat162float(q[q_base + i]);
    acc_s[i] = 0.f;
  }
  for (int t = tid; t < TR; t += THREADS) {
    m_s[t] = -INFINITY;
    l_s[t] = 0.f;
  }
  __syncthreads();

  for (int j = j0; j < j1; ++j) {
    int blk = tables[(size_t)b * max_blocks + j];
    if (blk < 0 || blk >= n_blocks) blk = 0;   // never read out of the pool
    const size_t base = (size_t)blk * BS * KV * Dh;
    for (int i = tid; i < BS * Dh; i += THREADS) {
      const int r = i / Dh, d = i % Dh;
      const size_t off = base + ((size_t)r * KV + h) * Dh + d;
      k_s[r * ld + d] = __bfloat162float(k_pool[off]);
      v_s[i] = __bfloat162float(v_pool[off]);
    }
    __syncthreads();
    // scores (TR, BS): contract Dh; masked keys are -inf
    for (int i = tid; i < TR * BS; i += THREADS) {
      const int t = i / BS, r = i % BS;
      const float* qr = q_s + t * ld;
      const float* kr = k_s + r * ld;
      float s0 = 0.f, s1 = 0.f;
      int d = 0;
      for (; d + 1 < Dh; d += 2) {
        s0 = fmaf(qr[d], kr[d], s0);
        s1 = fmaf(qr[d + 1], kr[d + 1], s1);
      }
      if (d < Dh) s0 = fmaf(qr[d], kr[d], s0);
      p_s[i] = (j * BS + r < ctx) ? s0 + s1 : -INFINITY;
    }
    __syncthreads();
    // online-softmax row update; p_s becomes bf16-rounded probabilities
    for (int t = tid; t < TR; t += THREADS) {
      float* pr = p_s + t * BS;
      float mx = -INFINITY;
      for (int r = 0; r < BS; ++r) mx = fmaxf(mx, pr[r]);
      const float m_prev = m_s[t];
      const float m_new = fmaxf(m_prev, mx);
      const float m_safe = isfinite(m_new) ? m_new : 0.f;  // all masked
      float sum = 0.f;
      for (int r = 0; r < BS; ++r) {
        const float p = (j * BS + r < ctx) ? expf(pr[r] - m_safe) : 0.f;
        sum += p;
        pr[r] = __bfloat162float(__float2bfloat16(p));
      }
      const float alpha = isfinite(m_prev) ? expf(m_prev - m_safe) : 0.f;
      l_s[t] = l_s[t] * alpha + sum;
      alpha_s[t] = alpha;
      m_s[t] = m_new;
    }
    __syncthreads();
    // acc = acc * alpha + p @ v
    for (int i = tid; i < TR * Dh; i += THREADS) {
      const int t = i / Dh, d = i % Dh;
      const float* pr = p_s + t * BS;
      float s0 = 0.f, s1 = 0.f;
      int r = 0;
      for (; r + 1 < BS; r += 2) {
        s0 = fmaf(pr[r], v_s[r * Dh + d], s0);
        s1 = fmaf(pr[r + 1], v_s[(r + 1) * Dh + d], s1);
      }
      if (r < BS) s0 = fmaf(pr[r], v_s[r * Dh + d], s0);
      acc_s[i] = acc_s[i] * alpha_s[t] + (s0 + s1);
    }
    __syncthreads();
  }

  const size_t part = ((size_t)s * B + b) * KV + h;
  for (int i = tid; i < TR * Dh; i += THREADS)
    acc_p[part * TR * Dh + i] = acc_s[i];
  for (int t = tid; t < TR; t += THREADS) {
    m_p[part * TR + t] = m_s[t];
    l_p[part * TR + t] = l_s[t];
  }
}

// Merge the live splits of each (slot, head), in split order.
__global__ void __launch_bounds__(THREADS)
paged_attn_merge_kernel(const float* __restrict__ acc_p,
                        const float* __restrict__ m_p,
                        const float* __restrict__ l_p,
                        const int* __restrict__ ctx_lens,
                        float* __restrict__ acc_out, float* __restrict__ m_out,
                        float* __restrict__ l_out, int B, int KV, int TR,
                        int Dh, int BS, int max_blocks, int bps) {
  extern __shared__ float m_all[];        // TR: the merged max per row
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int n_live = live_blocks(ctx_lens[b], BS, max_blocks);
  const int n_split = (n_live + bps - 1) / bps;
  const size_t out = (size_t)b * KV + h;
  for (int t = tid; t < TR; t += THREADS) {
    float mx = -INFINITY;
    for (int s = 0; s < n_split; ++s)
      mx = fmaxf(mx, m_p[(((size_t)s * B + b) * KV + h) * TR + t]);
    float l = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const size_t idx = (((size_t)s * B + b) * KV + h) * TR + t;
      l += l_p[idx] * expf(m_p[idx] - mx);  // live splits: m finite
    }
    m_all[t] = mx;
    m_out[out * TR + t] = mx;
    l_out[out * TR + t] = l;
  }
  __syncthreads();
  for (int i = tid; i < TR * Dh; i += THREADS) {
    const int t = i / Dh;
    float a = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const size_t part = ((size_t)s * B + b) * KV + h;
      a += acc_p[part * TR * Dh + i] * expf(m_p[part * TR + t] - m_all[t]);
    }
    acc_out[out * TR * Dh + i] = a;
  }
}

}  // namespace

// Shared memory one split block needs, in bytes (the wrapper checks it).
extern "C" long long paged_attn_smem_bytes(int TR, int Dh, int BS) {
  return (long long)sizeof(float) *
         ((long long)TR * (Dh + 1) + (long long)BS * (Dh + 1) +
          (long long)BS * Dh + (long long)TR * Dh + (long long)TR * BS +
          3LL * TR);
}

// q (B,KV,TR,Dh) bf16; k_pool/v_pool (n_blocks,BS,KV,Dh) bf16; tables
// (B,max_blocks) i32; ctx_lens (B,) i32; acc (B,KV,TR,Dh), m, l (B,KV,TR)
// f32. Partials: acc_p (S,B,KV,TR,Dh), m_p, l_p (S,B,KV,TR) f32 with
// S = ceil(max_blocks / bps). B, KV > 0. Returns cudaGetLastError().
extern "C" int paged_attn(const void* q, const void* k_pool,
                          const void* v_pool, const void* tables,
                          const void* ctx_lens, void* acc, void* m, void* l,
                          void* acc_p, void* m_p, void* l_p, int B, int KV,
                          int TR, int Dh, int n_blocks, int BS,
                          int max_blocks, int bps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long smem = paged_attn_smem_bytes(TR, Dh, BS);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_attn_split_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int n_split = (max_blocks + bps - 1) / bps;
  paged_attn_split_kernel<<<dim3(KV, B, n_split), THREADS, (size_t)smem,
                            st>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k_pool),
      static_cast<const __nv_bfloat16*>(v_pool),
      static_cast<const int*>(tables), static_cast<const int*>(ctx_lens),
      static_cast<float*>(acc_p), static_cast<float*>(m_p),
      static_cast<float*>(l_p), B, KV, TR, Dh, n_blocks, BS, max_blocks,
      bps);
  paged_attn_merge_kernel<<<dim3(KV, B), THREADS, TR * sizeof(float), st>>>(
      static_cast<const float*>(acc_p), static_cast<const float*>(m_p),
      static_cast<const float*>(l_p), static_cast<const int*>(ctx_lens),
      static_cast<float*>(acc), static_cast<float*>(m),
      static_cast<float*>(l), B, KV, TR, Dh, BS, max_blocks, bps);
  return static_cast<int>(cudaGetLastError());
}
