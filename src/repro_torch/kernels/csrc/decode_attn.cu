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
// elements per slot and head), read once; the MACs are 4*R*Dh per row, so
// at rep=1 even the m16-padded products do about 16 FLOP per byte, far
// below the ~295 at which the tensor cores would be the limit.
//
// Design. The TPU kernel walks a (slot, S_max / block_s) grid sequentially,
// carrying the state in revisited output blocks and visiting every block up
// to S_max. Here the blocks run in parallel, so the walk is split
// (flash-decoding style): a slot's rows are cut into ranges of `split`
// rows (kernels/decode_attn.py's SPLIT_ROWS), each range's state is
// written as a partial, and a second kernel merges the live ranges of
// every (slot, head) in range order (deterministic). The running max
// moves once per 32-row chunk (TILE_ROWS there) and p is rounded to the
// cache dtype against it; l sums the unrounded p
// (decode_attn_plain_ordered holds both bodies to that order).
//
// bf16 caches with Dh in {32, 64, 80, 128} (16-byte-aligned q and caches)
// take decode_attn_mma_kernel<Dh>:
//   * one warp per (slot b, KV head h, m16 query tile, range); a thread
//     block holds up to four heads of one (slot, m tile, range), with no
//     block-wide barrier; the R query rows are zero-padded to 16 (more
//     rows take more m tiles in gridDim.x); a warp whose range holds no
//     live row exits at once;
//   * Q's A fragments for mma.sync m16n8k16 stay in registers for the
//     whole walk (Dh/16 k-steps);
//   * K and V arrive through a per-warp ring of STAGES units in shared
//     memory: a unit is the K (or the V) half of one 32-row chunk, in the
//     order K0, V0, K1, V1, ...; 16-byte cp.async copies issued STAGES-1
//     units ahead, with an L2 evict-first hint (each row is read once);
//     rows padded by 16 bytes, so ldmatrix is free of bank conflicts;
//     rows past the live length are zero-filled (source size 0), not
//     read. A unit holds only K or V, so a ring of 2 units is 17,408 B a
//     warp at Dh=128 and three blocks of four warps (12 warps) share an
//     SM;
//   * S = Q K^T on the tensor cores: K is the col-major B operand as it
//     stands (ldmatrix), f32 sums of exact bf16 products; keys at or past
//     len get -inf, so their exp is 0 with no branch;
//   * online softmax in registers, rows reduced over the quad by shuffles:
//     the max moves once per chunk, over its two k16 tiles; p (bf16)
//     waits in registers as P's A fragment for the chunk's V unit;
//   * PV on the tensor cores: S's C fragments are, register for register,
//     P's A fragment; V is the B operand via ldmatrix.trans; acc (Dh/8 n8
//     tiles) is f32 in registers: acc = acc * alpha + P V per chunk.
// The f32 cache, and the other head sizes (a multiple of 16 up to 256),
// take the CUDA-core body
// decode_attn_split_kernel<T> (one 128-thread block per range, the walk
// TILE rows at a time in shared memory) with the same ranges and chunks.
// What the variants found (scripts/decode_attn_variants.py, PERF.md,
// H100 at 700 W): at lengths 144 and [0, 1, 513, 2048] the split kernel
// waits on memory (the copies are most of its time; the products and the
// exponentials cost nothing measurable); ranges of 64 rows are within
// 0.001 ms of the fastest at both (32 rows lose at the long lengths, 128
// and 256 at 144); a ring of 2 units (12 warps an SM) ties 3 (8 warps) at
// 144 and wins at the long lengths, 4 loses at both; the merge is fastest
// at one thread per output element. The wrapper (kernels/decode_attn.py)
// allocates the outputs and the partials and picks the body; this file
// allocates nothing and launches on the caller's stream.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ int live_len(const int* lengths, int b, int S) {
  const int n = lengths[b];
  return n < 0 ? 0 : (n < S ? n : S);
}

// --- the tensor-core body: bf16, Dh in {32, 64, 80, 128} ---------------------

// key rows per K (or V) unit and per max update; kernels/decode_attn.py's
// TILE_ROWS models the same walk
constexpr int CHUNK = 32;
constexpr int STAGES = 2;        // units in a warp's ring, the one in use
constexpr int MAX_HPB = 4;       // KV heads (warps) per thread block

__host__ __device__ constexpr int row_stride(int dh) { return dh + 8; }
__host__ __device__ constexpr int unit_elems(int dh) {
  return CHUNK * row_stride(dh);
}
// one warp's ring, bf16
__host__ __device__ constexpr int warp_smem_bytes(int dh) {
  return STAGES * unit_elems(dh) * 2;
}

// An L2 policy that evicts these lines first: each K/V row is read once,
// so the stream should not push out what else L2 holds.
__device__ __forceinline__ unsigned long long evict_first_policy() {
  unsigned long long p;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(p));
  return p;
}
__device__ __forceinline__ void cp16(void* dst, const void* src, bool ok,
                                     unsigned long long policy) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile(
      "cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2, %3;\n"
      ::"r"(d), "l"(src), "r"(ok ? 16 : 0), "l"(policy)
      : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int PENDING>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4],
                                              const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// {lo, hi} rounded to a bf16 pair, lo in the low half (the lower k index)
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Lane l of a warp: gid = l / 4 owns query rows gid and gid + 8 of the m
// tile, tig = l % 4 the fragment columns 2 tig, 2 tig + 1 (and + 8).
template <int DH>
__global__ void __launch_bounds__(32 * MAX_HPB)
decode_attn_mma_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       const int* __restrict__ lengths,
                       float* __restrict__ acc_p, float* __restrict__ m_p,
                       float* __restrict__ l_p, int B, int S, int KV, int R,
                       int split, int n_mt) {
  constexpr int LDS = row_stride(DH);
  constexpr int KS = DH / 16;          // k-steps of Q K^T
  constexpr int ND = DH / 8;           // n8 tiles of acc
  constexpr int CPR = DH / 8;          // 16-byte pieces of a cache row
  constexpr int LOADS = CHUNK * CPR / 32;  // copies per lane per unit
  static_assert(DH % 16 == 0 && CHUNK * CPR % 32 == 0,
                "a unit is whole k16 steps and whole warp-wide copies");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int hpb = blockDim.x >> 5;
  const int mt = blockIdx.x % n_mt;
  const int h = (blockIdx.x / n_mt) * hpb + warp;
  const int b = blockIdx.y, s = blockIdx.z;
  if (h >= KV) return;
  const int len = live_len(lengths, b, S);
  const int row0 = s * split;
  if (row0 >= len) return;               // no live row in this range
  const int rows = min(split, len - row0);
  const int n_units = 2 * ((rows + CHUNK - 1) / CHUNK);   // K, V per chunk

  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(
      smem + warp * warp_smem_bytes(DH));

  // The copy of unit u into ring stage st: piece pc = lane + 32 i of the
  // unit (16 bytes) is row pc / CPR of its chunk, column 8 (pc % CPR).
  // Where a row's pieces divide the warp, a lane keeps its column and steps
  // 32 / CPR rows a copy; at Dh 80 (ten pieces) its row and column vary. A
  // row past the live length reads nothing (source size 0, from the range's
  // first row) and writes zeros.
  const size_t pitch = (size_t)KV * DH;  // elements between cache rows
  const size_t first = ((size_t)b * S + row0) * pitch + (size_t)h * DH;
  const unsigned long long policy = evict_first_policy();
  auto load_unit = [&](int u, int st) {
    const int r0u = (u >> 1) * CHUNK;                // in the range
    const __nv_bfloat16* base = ((u & 1) ? v : k) + first;
    __nv_bfloat16* dst = ring + st * unit_elems(DH);
#pragma unroll
    for (int i = 0; i < LOADS; ++i) {
      const int pc = lane + 32 * i, row = pc / CPR, col = (pc % CPR) * 8;
      const bool ok = r0u + row < rows;
      cp16(dst + row * LDS + col,
           base + (ok ? (size_t)(r0u + row) * pitch : 0) + col, ok, policy);
    }
  };
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < n_units) load_unit(i, i);
    cp_commit();
  }

  // Q's A fragments, rows past R zero (read while the first units land)
  const int r0 = mt * 16 + gid, r1 = r0 + 8;
  const __nv_bfloat16* qh = q + ((size_t)b * KV + h) * R * DH + 2 * tig;
  unsigned qf[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const unsigned* p0 =
        reinterpret_cast<const unsigned*>(qh + (size_t)r0 * DH + 16 * ks);
    const unsigned* p1 =
        reinterpret_cast<const unsigned*>(qh + (size_t)r1 * DH + 16 * ks);
    qf[ks][0] = r0 < R ? p0[0] : 0u;
    qf[ks][1] = r1 < R ? p1[0] : 0u;
    qf[ks][2] = r0 < R ? p0[4] : 0u;
    qf[ks][3] = r1 < R ? p1[4] : 0u;
  }

  float acc[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nd][e] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  unsigned pa[2][4];       // the chunk's P, from its K unit to its V unit

  for (int u = 0; u < n_units; ++u) {
    cp_wait<STAGES - 2>();
    __syncwarp();            // unit u has landed; unit u-1's stage is free
    if (u + STAGES - 1 < n_units)
      load_unit(u + STAGES - 1, (u + STAGES - 1) % STAGES);
    cp_commit();

    const __nv_bfloat16* t_s = ring + (u % STAGES) * unit_elems(DH);
    const int c = u >> 1;                     // chunk of the range
    if ((u & 1) == 0) {
      // scores: sc[nt][hf] is the n8 tile of keys 16 nt + 8 hf ..
      float sc[2][2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[nt][0][e] = sc[nt][1][e] = 0.f;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          unsigned kb[4];
          ldsm_x4(kb, t_s + (16 * nt + ((lane >> 4) & 1) * 8 + (lane & 7))
                                * LDS
                          + 16 * ks + ((lane >> 3) & 1) * 8);
          mma_bf16(sc[nt][0], qf[ks], kb[0], kb[1]);
          mma_bf16(sc[nt][1], qf[ks], kb[2], kb[3]);
        }
      const int lim = rows - c * CHUNK;       // live keys of this chunk
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (16 * nt + 8 * hf + 2 * tig + (e & 1) >= lim)
              sc[nt][hf][e] = -INFINITY;
            mx[e >> 1] = fmaxf(mx[e >> 1], sc[nt][hf][e]);
          }
      // the chunk's max: rescale the state once
      float m_safe[2], alpha[2];
#pragma unroll
      for (int ri = 0; ri < 2; ++ri) {
        const float m_new = fmaxf(m_run[ri], quad_max(mx[ri]));
        m_safe[ri] = isfinite(m_new) ? m_new : 0.f;       // all masked
        alpha[ri] = isfinite(m_run[ri]) ? expf(m_run[ri] - m_safe[ri]) : 0.f;
        l_run[ri] *= alpha[ri];
        m_run[ri] = m_new;
      }
      // alpha = 1 (the max stayed) leaves acc as it is
      if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
        for (int nd = 0; nd < ND; ++nd) {
          acc[nd][0] *= alpha[0];
          acc[nd][1] *= alpha[0];
          acc[nd][2] *= alpha[1];
          acc[nd][3] *= alpha[1];
        }
      }
      // p against the chunk's max; l sums it unrounded, PV takes it as bf16
      float psum[2] = {0.f, 0.f};
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          float p[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {   // masked: exp(-inf) = 0
            p[e] = expf(sc[nt][hf][e] - m_safe[e >> 1]);
            psum[e >> 1] += p[e];
          }
          pa[nt][2 * hf] = pack_bf16(p[0], p[1]);
          pa[nt][2 * hf + 1] = pack_bf16(p[2], p[3]);
        }
      l_run[0] += quad_sum(psum[0]);
      l_run[1] += quad_sum(psum[1]);
    } else {
      // acc += P V
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int dp = 0; dp < DH / 16; ++dp) {
          unsigned vb[4];
          ldsm_x4_trans(vb, t_s + (16 * nt + ((lane >> 3) & 1) * 8
                                   + (lane & 7)) * LDS
                                + 16 * dp + (lane >> 4) * 8);
          mma_bf16(acc[2 * dp], pa[nt], vb[0], vb[1]);
          mma_bf16(acc[2 * dp + 1], pa[nt], vb[2], vb[3]);
        }
    }
  }

  const size_t part = ((size_t)s * B + b) * KV + h;
  float* ap = acc_p + part * R * DH + 2 * tig;
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) {
    if (r0 < R)
      *reinterpret_cast<float2*>(ap + (size_t)r0 * DH + 8 * nd) =
          make_float2(acc[nd][0], acc[nd][1]);
    if (r1 < R)
      *reinterpret_cast<float2*>(ap + (size_t)r1 * DH + 8 * nd) =
          make_float2(acc[nd][2], acc[nd][3]);
  }
  if (tig == 0) {
    if (r0 < R) {
      m_p[part * R + r0] = m_run[0];
      l_p[part * R + r0] = l_run[0];
    }
    if (r1 < R) {
      m_p[part * R + r1] = m_run[1];
      l_p[part * R + r1] = l_run[1];
    }
  }
}

// --- the CUDA-core body: f32 caches, and the other head sizes -------------

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

// Thread block (h, b, s) walks range s of slot b, TILE rows at a time:
// scores (a warp per cache row, a warp reduction per query row), the
// online softmax (a warp per query row), PV (a thread per (row, d)
// element, the accumulator in shared memory).
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

  extern __shared__ float smem_f[];
  float* q_s = smem_f;                   // R x Dh
  float* acc_s = q_s + R * Dh;           // R x Dh
  float* p_s = acc_s + R * Dh;           // R x TILE
  float* m_s = p_s + R * TILE;           // R
  float* l_s = m_s + R;                  // R
  float* alpha_s = l_s + R;              // R
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  // 32-column steps of a row; in a partial last one (Dh 80: 16 columns)
  // the lanes past Dh idle (zeros, no reads)
  const int n_dw = (Dh + 31) >> 5;

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
        kv[j] = lane + 32 * j < Dh ? to_f32(kr[lane + 32 * j]) : 0.f;
      for (int t = 0; t < R; ++t) {
        const float* qr = q_s + t * Dh;
        float part = 0.f;
#pragma unroll
        for (int j = 0; j < MAX_DW; ++j)
          if (j < n_dw)
            part = fmaf(lane + 32 * j < Dh ? qr[lane + 32 * j] : 0.f, kv[j],
                        part);
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

// --- the merge, shared by both bodies ---------------------------------------

// Merge the live ranges of each (slot, head), in range order: one thread
// per MERGE_VEC consecutive output elements of a row (and the row's m and
// l in its first thread). The loads of MERGE_U ranges are issued together,
// so a slot of up to MERGE_U ranges costs one round trip to the partials;
// the sums stay in range order. A slot with no live row has no range:
// m = -inf, l = 0, acc = 0.
constexpr int MERGE_THREADS = 256;
constexpr int MERGE_U = 16;
constexpr int MERGE_VEC = 1;     // faster than 4 in the variants

// V = 4 (one 16-byte access) or 1
template <int V>
__device__ __forceinline__ void ld_vec(float (&x)[V], const float* p) {
  if constexpr (V == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    x[0] = t.x; x[1] = t.y; x[2] = t.z; x[3] = t.w;
  } else {
    x[0] = *p;
  }
}
template <int V>
__device__ __forceinline__ void st_vec(float* p, const float (&x)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else {
    *p = x[0];
  }
}

__global__ void __launch_bounds__(MERGE_THREADS)
decode_attn_merge_kernel(const float* __restrict__ acc_p,
                         const float* __restrict__ m_p,
                         const float* __restrict__ l_p,
                         const int* __restrict__ lengths,
                         float* __restrict__ acc_out,
                         float* __restrict__ m_out, float* __restrict__ l_out,
                         int B, int S, int KV, int R, int Dh, int split) {
  const int rows = B * KV * R;               // rows between ranges
  const int per_row = Dh / MERGE_VEC;        // threads per row
  const int i = blockIdx.x * MERGE_THREADS + threadIdx.x;
  if (i >= rows * per_row) return;
  const int row = i / per_row;               // (b * KV + h) * R + t
  const int dv = i - row * per_row;
  const int b = row / (KV * R);
  const int n_split = (live_len(lengths, b, S) + split - 1) / split;
  const float* ap = acc_p + (size_t)row * Dh + dv * MERGE_VEC;
  float mv[MERGE_U], lv[MERGE_U], av[MERGE_U][MERGE_VEC];
  // ranges s0 .. s0 + MERGE_U - 1 into registers (past n_split: m -inf)
  auto load = [&](int s0, bool with_partials) {
#pragma unroll
    for (int k = 0; k < MERGE_U; ++k) {
      const bool live = s0 + k < n_split;
      const size_t r = (size_t)(s0 + k) * rows + row;
      mv[k] = live ? m_p[r] : -INFINITY;
      if (with_partials) {
        if (live) {
          ld_vec(av[k], ap + (size_t)(s0 + k) * rows * Dh);
        } else {
#pragma unroll
          for (int e = 0; e < MERGE_VEC; ++e) av[k][e] = 0.f;
        }
        lv[k] = live && dv == 0 ? l_p[r] : 0.f;
      }
    }
  };
  load(0, true);
  float mx = -INFINITY;
#pragma unroll
  for (int k = 0; k < MERGE_U; ++k) mx = fmaxf(mx, mv[k]);
  for (int s0 = MERGE_U; s0 < n_split; s0 += MERGE_U) {
    float keep[MERGE_U];
#pragma unroll
    for (int k = 0; k < MERGE_U; ++k) keep[k] = mv[k];
    load(s0, false);
#pragma unroll
    for (int k = 0; k < MERGE_U; ++k) {
      mx = fmaxf(mx, mv[k]);
      mv[k] = keep[k];
    }
  }
  // live ranges: m finite
  float a[MERGE_VEC] = {};
  float l = 0.f;
  for (int s0 = 0; s0 < n_split; s0 += MERGE_U) {
    if (s0 > 0) load(s0, true);
#pragma unroll
    for (int k = 0; k < MERGE_U; ++k) {
      if (s0 + k < n_split) {
        const float w = expf(mv[k] - mx);
#pragma unroll
        for (int e = 0; e < MERGE_VEC; ++e) a[e] += av[k][e] * w;
        l += lv[k] * w;
      }
    }
  }
  st_vec(acc_out + (size_t)i * MERGE_VEC, a);
  if (dv == 0) {
    m_out[row] = mx;
    l_out[row] = l;
  }
}

__host__ int heads_per_block(int KV) { return KV < MAX_HPB ? KV : MAX_HPB; }

template <int DH>
int launch_mma(const void* q, const void* k, const void* v,
               const void* lengths, void* acc_p, void* m_p, void* l_p, int B,
               int S, int KV, int R, int split, int n_split,
               cudaStream_t st) {
  const int hpb = heads_per_block(KV);
  const int smem = hpb * warp_smem_bytes(DH);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        decode_attn_mma_kernel<DH>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int n_mt = (R + 15) / 16;
  const dim3 grid((KV + hpb - 1) / hpb * n_mt, B, n_split);
  decode_attn_mma_kernel<DH><<<grid, 32 * hpb, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(lengths),
      static_cast<float*>(acc_p), static_cast<float*>(m_p),
      static_cast<float*>(l_p), B, S, KV, R, split, n_mt);
  return 0;
}

template <typename T>
int launch_split(const void* q, const void* k, const void* v,
                 const void* lengths, void* acc_p, void* m_p, void* l_p,
                 int B, int S, int KV, int R, int Dh, int split, int n_split,
                 cudaStream_t st) {
  const long long smem =
      (long long)sizeof(float) * (2LL * R * Dh + (long long)R * TILE + 3LL * R);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        decode_attn_split_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  decode_attn_split_kernel<T><<<dim3(KV, B, n_split), THREADS, (size_t)smem,
                                st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(lengths),
      static_cast<float*>(acc_p), static_cast<float*>(m_p),
      static_cast<float*>(l_p), B, S, KV, R, Dh, split);
  return 0;
}

}  // namespace

// q (B,KV,R,Dh) and k/v (B,S,KV,Dh) in one dtype: bf16 (is_bf16=1) or f32;
// lengths (B,) i32; acc (B,KV,R,Dh), m, l (B,KV,R) f32. Partials: acc_p
// (n_split,B,KV,R,Dh), m_p, l_p (n_split,B,KV,R) f32 with n_split =
// ceil(S / split). B, KV, R, S > 0; Dh % 16 == 0 and Dh <= 256; split a
// positive multiple of 32; B*KV*R*Dh < 2^31. mma=1 takes the tensor-core
// body: bf16, Dh in {32, 64, 80, 128}, q, k and v on 16-byte boundaries.
// Returns cudaGetLastError() after the launches (cudaErrorInvalidValue for
// what neither body takes).
extern "C" int decode_attn(const void* q, const void* k, const void* v,
                           const void* lengths, void* acc, void* m, void* l,
                           void* acc_p, void* m_p, void* l_p, int B, int S,
                           int KV, int R, int Dh, int split, int is_bf16,
                           int mma, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || S < 1 || KV < 1 || R < 1 || Dh < 16 || Dh > 256 || Dh % 16
      || split < CHUNK || split % CHUNK
      || (long long)B * KV * R * Dh > 0x7fffffffLL || (mma && !is_bf16))
    return cudaErrorInvalidValue;
  const int n_split = (S + split - 1) / split;
  int err;
  if (mma) {
    switch (Dh) {
      case 32:
        err = launch_mma<32>(q, k, v, lengths, acc_p, m_p, l_p, B, S, KV, R,
                             split, n_split, st);
        break;
      case 64:
        err = launch_mma<64>(q, k, v, lengths, acc_p, m_p, l_p, B, S, KV, R,
                             split, n_split, st);
        break;
      case 80:
        err = launch_mma<80>(q, k, v, lengths, acc_p, m_p, l_p, B, S, KV, R,
                             split, n_split, st);
        break;
      case 128:
        err = launch_mma<128>(q, k, v, lengths, acc_p, m_p, l_p, B, S, KV, R,
                              split, n_split, st);
        break;
      default:
        return cudaErrorInvalidValue;
    }
  } else if (is_bf16) {
    err = launch_split<__nv_bfloat16>(q, k, v, lengths, acc_p, m_p, l_p, B,
                                      S, KV, R, Dh, split, n_split, st);
  } else {
    err = launch_split<float>(q, k, v, lengths, acc_p, m_p, l_p, B, S, KV, R,
                              Dh, split, n_split, st);
  }
  if (err) return err;
  const int threads = B * KV * R * (Dh / MERGE_VEC);
  decode_attn_merge_kernel<<<(threads + MERGE_THREADS - 1) / MERGE_THREADS,
                             MERGE_THREADS, 0, st>>>(
      static_cast<const float*>(acc_p), static_cast<const float*>(m_p),
      static_cast<const float*>(l_p), static_cast<const int*>(lengths),
      static_cast<float*>(acc), static_cast<float*>(m),
      static_cast<float*>(l), B, S, KV, R, Dh, split);
  return static_cast<int>(cudaGetLastError());
}
