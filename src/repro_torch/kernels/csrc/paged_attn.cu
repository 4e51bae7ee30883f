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
// style): each slot's table is cut into ranges of bps pool blocks, and a
// second kernel merges the live ranges of every (slot, head) in range
// order (deterministic).
//   * Thread block (head group, m tile, slot b, range s) holds up to four
//     warps, one per KV head of the group; each warp owns one m16 tile of
//     its head's queries (TR rows zero-padded to 16; more rows take more
//     m tiles in gridDim.x) and walks the range on its own: no block-wide
//     barrier, an empty range or head exits at once.
//   * Q's A fragments for mma.sync m16n8k16 stay in registers for the
//     whole walk (Dh/16 k-steps).
//   * K and V rows arrive in a per-warp ring of STAGES chunks in shared
//     memory through 16-byte cp.async copies, STAGES-1 chunks ahead of the
//     products; a chunk is CK = 16*NT key rows of one pool block (rows
//     padded by 16 bytes, so ldmatrix is free of bank conflicts). Each
//     lane copies fixed, unrolled 16-byte pieces, one address a step.
//     Rows past the block or past ctx are zero-filled, not read, and
//     masked; table entries out of the pool read block 0. The copies
//     carry an L2 evict-first hint (each row is read once).
//   * S = Q K^T on the tensor cores: K is the col-major B operand as it
//     stands (ldmatrix), f32 sums of exact bf16 products; keys at or past
//     ctx get -inf.
//   * Online softmax in registers, rows reduced over the quad by shuffles.
//     The running max is updated once per pool block, over all its keys
//     (the order paged_attn_plain_ordered holds the kernel to); p is
//     rounded to bf16 against that max for the PV product and l sums the
//     unrounded p. A block of at most CK keys is one chunk and one pass;
//     a larger block is walked twice, chunk by chunk: K alone for its max,
//     then K and V for p and PV.
//   * PV on the tensor cores: S's C fragments are, register for register,
//     P's A fragment; V is the B operand via ldmatrix.trans; acc (Dh/8 n8
//     tiles) is f32 in registers: acc = acc * alpha + P V per pool block.
// The wrapper (kernels/paged_attn.py) allocates the outputs and the
// partials; this file allocates nothing and launches on the caller's
// stream.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int STAGES = 3;        // chunks in the ring, the one in use included
constexpr int MAX_HPB = 4;       // KV heads (warps) per thread block
constexpr int MAX_BPS = 32;      // pool blocks per range: one table entry a lane
constexpr int MERGE_THREADS = 256;

__host__ __device__ constexpr int chunk_keys(int nt) { return 16 * nt; }
__host__ __device__ constexpr int row_stride(int dh) { return dh + 8; }
// one warp's ring: STAGES x (K and V chunk), bf16
__host__ __device__ constexpr int warp_smem_bytes(int dh, int nt) {
  return STAGES * 2 * chunk_keys(nt) * row_stride(dh) * 2;
}

__device__ __forceinline__ int live_blocks(int ctx, int BS, int max_blocks) {
  int n = ctx > 0 ? (ctx + BS - 1) / BS : 0;
  return n < max_blocks ? n : max_blocks;
}

// An L2 policy that evicts these lines first: each K/V row is read once,
// so the stream should not push out what else L2 holds (the partials the
// merge reads back, dirty lines that would have to be written first).
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
// A range of a slot's table is walked as units: a pool block of at most
// CK keys is one unit (K and V, max and PV); a larger one is nc chunks
// of K for its max, then nc chunks of K and V for PV.
template <int DH, int NT>
__global__ void __launch_bounds__(32 * MAX_HPB, 1)
paged_attn_split_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k_pool,
                        const __nv_bfloat16* __restrict__ v_pool,
                        const int* __restrict__ tables,
                        const int* __restrict__ ctx_lens,
                        float* __restrict__ acc_p, float* __restrict__ m_p,
                        float* __restrict__ l_p, int B, int KV, int TR,
                        int n_blocks, int BS, int max_blocks, int bps,
                        int n_mt) {
  constexpr int CK = chunk_keys(NT), LDS = row_stride(DH);
  constexpr int KS = DH / 16;          // k-steps of Q K^T
  constexpr int ND = DH / 8;           // n8 tiles of acc
  constexpr int CPR = DH / 8;          // 16-byte pieces of a key row
  constexpr int RPI = 32 / CPR;        // key rows one warp copy covers
  constexpr int LOADS = CK / RPI;      // copies per lane per K (or V) chunk
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int hpb = blockDim.x >> 5;
  const int mt = blockIdx.x % n_mt;
  const int h = (blockIdx.x / n_mt) * hpb + warp;
  const int b = blockIdx.y, s = blockIdx.z;
  if (h >= KV) return;
  const int j0 = s * bps;
  // the range's table entries, one a lane, read beside ctx_lens (out of
  // the pool: block 0)
  int my_blk = lane < bps && j0 + lane < max_blocks
                   ? tables[(size_t)b * max_blocks + j0 + lane] : 0;
  if (my_blk < 0 || my_blk >= n_blocks) my_blk = 0;
  // Q's A fragments, rows past TR zero (also read beside ctx_lens)
  const int r0 = mt * 16 + gid, r1 = r0 + 8;
  const __nv_bfloat16* qh = q + ((size_t)b * KV + h) * TR * DH + 2 * tig;
  unsigned qf[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const unsigned* p0 =
        reinterpret_cast<const unsigned*>(qh + (size_t)r0 * DH + 16 * ks);
    const unsigned* p1 =
        reinterpret_cast<const unsigned*>(qh + (size_t)r1 * DH + 16 * ks);
    qf[ks][0] = r0 < TR ? p0[0] : 0u;
    qf[ks][1] = r1 < TR ? p1[0] : 0u;
    qf[ks][2] = r0 < TR ? p0[4] : 0u;
    qf[ks][3] = r1 < TR ? p1[4] : 0u;
  }

  const int ctx = ctx_lens[b];
  const int n_live = live_blocks(ctx, BS, max_blocks);
  if (j0 >= n_live) return;              // no live row in this range
  const int j1 = j0 + bps < n_live ? j0 + bps : n_live;
  // chunks per pool block (the wrapper takes NT = 1 only for BS <= 16)
  const int nc = NT == 1 ? 1 : (BS + CK - 1) / CK;
  const int upb = nc == 1 ? 1 : 2 * nc;  // units per pool block
  const int n_units = (j1 - j0) * upb;

  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(
      smem + warp * warp_smem_bytes(DH, NT));

  float acc[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nd][e] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  float m_safe[2] = {0.f, 0.f}, mx_blk[2] = {-INFINITY, -INFINITY};

  // The copy of unit u into ring stage st: lane (row lrow, piece lcol)
  // copies key rows lrow + RPI i of the chunk.
  const int lrow = lane / CPR, lcol = (lane % CPR) * 8;
  const size_t pitch = (size_t)KV * DH;  // elements between key rows
  const unsigned long long policy = evict_first_policy();
  auto load_unit = [&](int u, int st) {
    const int jl = u / upb, r = u - jl * upb;
    const bool v_too = nc == 1 || r >= nc;
    const int c = r < nc ? r : r - nc;
    const int blk = __shfl_sync(0xffffffffu, my_blk, jl);
    const int jj = j0 + jl;
    const int lim = min(BS, ctx - jj * BS) - c * CK;   // live rows here
    const size_t off = ((size_t)blk * BS + c * CK + lrow) * pitch
                       + (size_t)h * DH + lcol;
    const __nv_bfloat16* ksrc = k_pool + off;
    const __nv_bfloat16* vsrc = v_pool + off;
    __nv_bfloat16* kd = ring + st * 2 * CK * LDS + lrow * LDS + lcol;
    __nv_bfloat16* vd = kd + CK * LDS;
    // a dead row's copy reads nothing (source size 0) and writes zeros
#pragma unroll
    for (int i = 0; i < LOADS; ++i) {
      const bool ok = lrow + RPI * i < lim;
      cp16(kd + RPI * i * LDS, ksrc, ok, policy);
      if (v_too) cp16(vd + RPI * i * LDS, vsrc, ok, policy);
      ksrc += RPI * pitch;
      vsrc += RPI * pitch;
    }
  };

#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < n_units) load_unit(i, i);
    cp_commit();
  }
  for (int u = 0; u < n_units; ++u) {
    cp_wait<STAGES - 2>();
    __syncwarp();            // unit u has landed; unit u-1's stage is free
    if (u + STAGES - 1 < n_units)
      load_unit(u + STAGES - 1, (u + STAGES - 1) % STAGES);
    cp_commit();

    const __nv_bfloat16* k_s = ring + (u % STAGES) * 2 * CK * LDS;
    const __nv_bfloat16* v_s = k_s + CK * LDS;
    const int jl = u / upb, r = u - jl * upb;
    const bool do_max = nc == 1 || r < nc;
    const bool do_pv = nc == 1 || r >= nc;
    const int c = r < nc ? r : r - nc;
    const int lim = min(BS, ctx - (j0 + jl) * BS) - c * CK;

    // scores: sc[nt][half] is the n8 tile of keys 16 nt + 8 half ..
    float sc[NT][2][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nt][0][e] = sc[nt][1][e] = 0.f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        unsigned kb[4];
        ldsm_x4(kb, k_s + (16 * nt + ((lane >> 4) & 1) * 8 + (lane & 7)) * LDS
                        + 16 * ks + ((lane >> 3) & 1) * 8);
        mma_bf16(sc[nt][0], qf[ks], kb[0], kb[1]);
        mma_bf16(sc[nt][1], qf[ks], kb[2], kb[3]);
      }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (16 * nt + 8 * hf + 2 * tig + (e & 1) >= lim)
            sc[nt][hf][e] = -INFINITY;

    if (do_max) {
      if (c == 0) mx_blk[0] = mx_blk[1] = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            mx_blk[e >> 1] = fmaxf(mx_blk[e >> 1], sc[nt][hf][e]);
      if (c == nc - 1) {     // the block's max: rescale the state once
        float alpha[2];
#pragma unroll
        for (int ri = 0; ri < 2; ++ri) {
          const float m_new = fmaxf(m_run[ri], quad_max(mx_blk[ri]));
          m_safe[ri] = isfinite(m_new) ? m_new : 0.f;      // all masked
          alpha[ri] = isfinite(m_run[ri]) ? expf(m_run[ri] - m_safe[ri])
                                          : 0.f;
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
      }
    }
    if (do_pv) {
      // p against the block's max; l sums it unrounded, PV takes it as bf16
      float psum[2] = {0.f, 0.f};
      unsigned pa[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
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
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int dp = 0; dp < DH / 16; ++dp) {
          unsigned vb[4];
          ldsm_x4_trans(vb, v_s + (16 * nt + ((lane >> 3) & 1) * 8
                                   + (lane & 7)) * LDS
                                + 16 * dp + (lane >> 4) * 8);
          mma_bf16(acc[2 * dp], pa[nt], vb[0], vb[1]);
          mma_bf16(acc[2 * dp + 1], pa[nt], vb[2], vb[3]);
        }
    }
  }

  const size_t part = ((size_t)s * B + b) * KV + h;
  float* ap = acc_p + part * TR * DH + 2 * tig;
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) {
    if (r0 < TR)
      *reinterpret_cast<float2*>(ap + (size_t)r0 * DH + 8 * nd) =
          make_float2(acc[nd][0], acc[nd][1]);
    if (r1 < TR)
      *reinterpret_cast<float2*>(ap + (size_t)r1 * DH + 8 * nd) =
          make_float2(acc[nd][2], acc[nd][3]);
  }
  if (tig == 0) {
    if (r0 < TR) {
      m_p[part * TR + r0] = m_run[0];
      l_p[part * TR + r0] = l_run[0];
    }
    if (r1 < TR) {
      m_p[part * TR + r1] = m_run[1];
      l_p[part * TR + r1] = l_run[1];
    }
  }
}

// Merge the live ranges of each (slot, head), in range order: one thread
// per 4 consecutive output elements of a row (and the row's m and l in
// its first thread). The loads of MERGE_U ranges are issued together, the
// first MERGE_U ranges' partials with their maxima, so a context of up to
// MERGE_U ranges costs one round trip to the partials; the sums stay in
// range order.
constexpr int MERGE_U = 16;

__global__ void __launch_bounds__(MERGE_THREADS)
paged_attn_merge_kernel(const float* __restrict__ acc_p,
                        const float* __restrict__ m_p,
                        const float* __restrict__ l_p,
                        const int* __restrict__ ctx_lens,
                        float* __restrict__ acc_out, float* __restrict__ m_out,
                        float* __restrict__ l_out, int B, int KV, int TR,
                        int Dh, int BS, int max_blocks, int bps) {
  const int rows = B * KV * TR;              // rows between ranges
  const int q4 = Dh / 4;                     // float4s per row
  const int i = blockIdx.x * MERGE_THREADS + threadIdx.x;
  if (i >= rows * q4) return;
  const int row = i / q4;                    // (b * KV + h) * TR + t
  const int d4 = i - row * q4;
  const int b = row / (KV * TR);
  const int n_live = live_blocks(ctx_lens[b], BS, max_blocks);
  const int n_split = (n_live + bps - 1) / bps;
  const float4* ap = reinterpret_cast<const float4*>(acc_p) + d4;
  float mv[MERGE_U], lv[MERGE_U];
  float4 av[MERGE_U];
  // ranges s0 .. s0 + MERGE_U - 1 into registers (past n_split: m -inf)
  auto load = [&](int s0, bool with_partials) {
#pragma unroll
    for (int k = 0; k < MERGE_U; ++k) {
      const bool live = s0 + k < n_split;
      const size_t r = (size_t)(s0 + k) * rows + row;
      mv[k] = live ? m_p[r] : -INFINITY;
      if (with_partials) {
        av[k] = live ? ap[r * q4] : make_float4(0.f, 0.f, 0.f, 0.f);
        lv[k] = live && d4 == 0 ? l_p[r] : 0.f;
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
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
  float l = 0.f;
  for (int s0 = 0; s0 < n_split; s0 += MERGE_U) {
    if (s0 > 0) load(s0, true);
#pragma unroll
    for (int k = 0; k < MERGE_U; ++k) {
      if (s0 + k < n_split) {
        const float w = expf(mv[k] - mx);
        a.x += av[k].x * w;
        a.y += av[k].y * w;
        a.z += av[k].z * w;
        a.w += av[k].w * w;
        l += lv[k] * w;
      }
    }
  }
  reinterpret_cast<float4*>(acc_out)[i] = a;
  if (d4 == 0) {
    m_out[row] = mx;
    l_out[row] = l;
  }
}

__host__ int heads_per_block(int KV) { return KV < MAX_HPB ? KV : MAX_HPB; }
__host__ int chunk_tiles(int BS) { return BS <= 16 ? 1 : 2; }

template <int DH, int NT>
int launch_split(const void* q, const void* k_pool, const void* v_pool,
                 const void* tables, const void* ctx_lens, void* acc_p,
                 void* m_p, void* l_p, int B, int KV, int TR, int n_blocks,
                 int BS, int max_blocks, int bps, int n_split,
                 cudaStream_t st) {
  const int hpb = heads_per_block(KV);
  const int smem = hpb * warp_smem_bytes(DH, NT);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_attn_split_kernel<DH, NT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int n_mt = (TR + 15) / 16;
  const dim3 grid((KV + hpb - 1) / hpb * n_mt, B, n_split);
  paged_attn_split_kernel<DH, NT><<<grid, 32 * hpb, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k_pool),
      static_cast<const __nv_bfloat16*>(v_pool),
      static_cast<const int*>(tables), static_cast<const int*>(ctx_lens),
      static_cast<float*>(acc_p), static_cast<float*>(m_p),
      static_cast<float*>(l_p), B, KV, TR, n_blocks, BS, max_blocks, bps,
      n_mt);
  return 0;
}

template <int NT>
int launch_split_dh(int Dh, const void* q, const void* k_pool,
                    const void* v_pool, const void* tables,
                    const void* ctx_lens, void* acc_p, void* m_p, void* l_p,
                    int B, int KV, int TR, int n_blocks, int BS,
                    int max_blocks, int bps, int n_split, cudaStream_t st) {
  switch (Dh) {
    case 16:
      return launch_split<16, NT>(q, k_pool, v_pool, tables, ctx_lens, acc_p,
                                  m_p, l_p, B, KV, TR, n_blocks, BS,
                                  max_blocks, bps, n_split, st);
    case 32:
      return launch_split<32, NT>(q, k_pool, v_pool, tables, ctx_lens, acc_p,
                                  m_p, l_p, B, KV, TR, n_blocks, BS,
                                  max_blocks, bps, n_split, st);
    case 64:
      return launch_split<64, NT>(q, k_pool, v_pool, tables, ctx_lens, acc_p,
                                  m_p, l_p, B, KV, TR, n_blocks, BS,
                                  max_blocks, bps, n_split, st);
    case 128:
      return launch_split<128, NT>(q, k_pool, v_pool, tables, ctx_lens,
                                   acc_p, m_p, l_p, B, KV, TR, n_blocks, BS,
                                   max_blocks, bps, n_split, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Dynamic shared memory of one split block, in bytes: heads per block x
// one warp's ring (-1 for a head size the kernel does not take).
extern "C" long long paged_attn_smem_bytes(int KV, int Dh, int BS) {
  if (Dh != 16 && Dh != 32 && Dh != 64 && Dh != 128) return -1;
  return (long long)heads_per_block(KV) * warp_smem_bytes(Dh, chunk_tiles(BS));
}

// q (B,KV,TR,Dh) bf16; k_pool/v_pool (n_blocks,BS,KV,Dh) bf16, 16-byte
// aligned, Dh in {16, 32, 64, 128}; tables (B,max_blocks) i32; ctx_lens
// (B,) i32; acc (B,KV,TR,Dh), m, l (B,KV,TR) f32. Partials: acc_p
// (S,B,KV,TR,Dh), m_p, l_p (S,B,KV,TR) f32 with S = ceil(max_blocks /
// bps), 1 <= bps <= 32. B, KV, TR, BS > 0, B*KV*TR*Dh < 2^31. Returns
// cudaGetLastError()
// (cudaErrorInvalidValue for what the kernel does not take).
extern "C" int paged_attn(const void* q, const void* k_pool,
                          const void* v_pool, const void* tables,
                          const void* ctx_lens, void* acc, void* m, void* l,
                          void* acc_p, void* m_p, void* l_p, int B, int KV,
                          int TR, int Dh, int n_blocks, int BS,
                          int max_blocks, int bps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || KV < 1 || TR < 1 || BS < 1 || bps < 1 || bps > MAX_BPS
      || (long long)B * KV * TR * Dh > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const int n_split = (max_blocks + bps - 1) / bps;
  if (n_split > 0) {
    const int err =
        chunk_tiles(BS) == 1
            ? launch_split_dh<1>(Dh, q, k_pool, v_pool, tables, ctx_lens,
                                 acc_p, m_p, l_p, B, KV, TR, n_blocks, BS,
                                 max_blocks, bps, n_split, st)
            : launch_split_dh<2>(Dh, q, k_pool, v_pool, tables, ctx_lens,
                                 acc_p, m_p, l_p, B, KV, TR, n_blocks, BS,
                                 max_blocks, bps, n_split, st);
    if (err) return err;
  }
  const int quads = B * KV * TR * (Dh / 4);
  paged_attn_merge_kernel<<<(quads + MERGE_THREADS - 1) / MERGE_THREADS,
                            MERGE_THREADS, 0, st>>>(
      static_cast<const float*>(acc_p), static_cast<const float*>(m_p),
      static_cast<const float*>(l_p), static_cast<const int*>(ctx_lens),
      static_cast<float*>(acc), static_cast<float*>(m),
      static_cast<float*>(l), B, KV, TR, Dh, BS, max_blocks, bps);
  return static_cast<int>(cudaGetLastError());
}
