// The ECDP kernel body, shared by ecdp.cu (a dense (K,N) int8 weight) and
// paged_ecdp.cu (the same weight as 16 KiB pages of the weight page pool).
//
// out = (a @ correct(w)) * scale, a (M,K) bf16 or f32, w raw int8 read as
// stored (possibly with bit errors), Hamming(72,64) SEC-DED parity per
// 8-row codeword of one column, per-column f32 scales, out (M,N) f32.
// Where the weight's bytes, parity bytes and scales live is the template
// parameter W: a struct with
//   word(k, n)        the codeword of rows k..k+7 of column n, byte r = row k+r
//   q_byte(k, n)      weight byte (k, n)
//   q_rows(k0, n0)    the address of weight byte (k0, n0), k0 % 64 == 0 and
//   q_stride()        n0 % 128 == 0; byte (k0 + r, n0 + c), r < 64 and
//                     c < 128, is at q_rows(k0, n0) + r * q_stride() + c
//   parity_byte(k, n) the parity byte of the codeword holding row k
//   p16(c, n0)        the 16 parity bytes of codeword row c, columns n0..
//   col_scale(n)      column n's scale
// q_rows and p16 are only used by the wide instantiation, which the wrapper
// picks where every such run is 16-byte aligned (N % 16 == 0, aligned
// bases). Every other instruction is the same for both weights, so with
// the same launch plan the two kernels give bit-identical outputs on the
// same bytes.
//
// bf16 activations: ecdp_mma_kernel, on the tensor cores.
//   * A block owns 128 output columns and an M tile of 16, 64 or 128 rows
//     (four warps side by side over the columns, each with 16 or 64 rows;
//     two rows of four for 128), gridDim.z walks M, so one launch covers
//     any M; the block walks its K split 64 rows at a time. Each step's raw
//     weight tile (64 x 128 int8), parity (8 x 128 u8) and activation tile
//     (M tile x 64 bf16) go to shared memory as 16-byte cp.async copies,
//     neighbouring threads on neighbouring addresses, two stages deep: the
//     next step's bytes are in flight while this one is corrected and
//     multiplied. Rows past the split, columns past N and rows past M are
//     zero-filled, so K needs only to be a multiple of 8 (an 8-row tail is
//     a zero half of a 16-deep MMA step).
//   * Correction in shared memory, before the products, once per step for
//     all the tile's rows: a thread takes 4 codewords (one codeword row of
//     4 columns: one 32-bit word per row, rows 144 bytes apart, so no bank
//     conflicts), computes their syndromes together with masked XORs and
//     byte-parity folds (syndromes4: the f32 body's syndromes, bit for bit),
//     and writes back the one byte a single error names.
//   * Products: mma.sync m16n8k16 bf16 with f32 accumulation. A weight
//     |q| <= 127 is exact in bf16 and a bf16 x bf16 product exact in f32,
//     so the products are the CUDA-core body's; only the order of the f32
//     sums differs. B fragments come from the corrected int8 tile, one
//     32-bit word (4 columns) per k row, turned into bf16 pairs with an
//     exponent-bias trick (byte into 2^23's mantissa, subtract); a warp's
//     n8 tiles take columns 4g+j, so those words are conflict-free. A
//     fragments come through ldmatrix from rows padded to 144 bytes.
//   * The output tile goes out through shared memory, whole rows at a time.
//     K is split over gridDim.y into runs of whole 64-row steps (the
//     wrapper's launch plan); each split writes f32 partial sums and
//     ecdp_reduce adds them in a fixed order (deterministic) and scales.
//
// f32 activations: ecdp_kernel, the CUDA-core body as first written.
//   * A block owns 128 output columns (one per thread) and all M rows (M
//     in runs of 64, one launch each), corrects each codeword in registers
//     and multiplies in f32 FMAs against activations staged as f32 in
//     shared memory; K split over gridDim.y as above.
// The wrappers allocate the output and the partials; nothing here
// allocates, and every launch goes to the caller's stream.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int COLS = 128;   // output columns per block (f32 body: threads)
constexpr int KT = 64;      // K rows of activations staged per tile
constexpr int MAX_M = 64;   // f32 body: rows per launch

// Logical Hamming position of physical data bit i (repro/core/ecc.py).
__constant__ int DATA_POS[64] = {
    3, 5, 6, 7, 9, 10, 11, 12, 13, 14, 15, 17, 18, 19, 20, 21,
    22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 33, 34, 35, 36, 37, 38,
    39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51, 52, 53, 54,
    55, 56, 57, 58, 59, 60, 61, 62, 63, 65, 66, 67, 68, 69, 70, 71};

// PHYS_MASK64[j]: the data bits (bit 8*r+i = bit i of row r) that feed
// Hamming parity bit j, i.e. bit i set iff DATA_POS[i] has bit j set.
__constant__ unsigned long long PHYS_MASK64[7] = {
    0xab55555556aaad5bull, 0xcd9999999b33366dull, 0xf1e1e1e1e3c3c78eull,
    0x01fe01fe03fc07f0ull, 0x01fffe0003fff800ull, 0x01fffffffc000000ull,
    0xfe00000000000000ull};

__device__ __forceinline__ void init_syn2bit(int* syn2bit) {
  for (int i = threadIdx.x; i < 128; i += blockDim.x) syn2bit[i] = -1;
  __syncthreads();
  if (threadIdx.x < 64) syn2bit[DATA_POS[threadIdx.x]] = threadIdx.x;
}

// PHYS_MASK64[j] as a compile-time value (for the 4-codeword syndromes).
__host__ __device__ constexpr unsigned long long phys_mask(int j) {
  return j == 0 ? 0xab55555556aaad5bull : j == 1 ? 0xcd9999999b33366dull
       : j == 2 ? 0xf1e1e1e1e3c3c78eull : j == 3 ? 0x01fe01fe03fc07f0ull
       : j == 4 ? 0x01fffe0003fff800ull : j == 5 ? 0x01fffffffc000000ull
       : 0xfe00000000000000ull;
}

// The syndromes of four codewords at once: rw[r] holds row r of four
// columns, column c in byte c. Byte c of the result has bit j < 7 = the
// Hamming parity bit j of column c's data and bit 7 = the parity of all
// its data bits. Each parity bit is an XOR of masked rows (one LOP3 a
// row), then each byte folds to its parity: to a nibble, two words' nibbles
// packed into one byte, each nibble to a bit. No popcounts.
__device__ __forceinline__ unsigned syndromes4(const unsigned (&rw)[8]) {
  unsigned x[8];
#pragma unroll
  for (int j = 0; j < 7; ++j) {
    unsigned acc = 0;
#pragma unroll
    for (int r = 0; r < 8; ++r)
      acc ^= rw[r] & ((unsigned)((phys_mask(j) >> (8 * r)) & 0xFFu)
                      * 0x01010101u);
    x[j] = acc;
  }
  x[7] = rw[0] ^ rw[1] ^ rw[2] ^ rw[3] ^ rw[4] ^ rw[5] ^ rw[6] ^ rw[7];
  unsigned syn = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const unsigned lo = (x[j] ^ (x[j] >> 4)) & 0x0F0F0F0Fu;
    const unsigned hi = (x[j + 4] ^ (x[j + 4] >> 4)) & 0x0F0F0F0Fu;
    unsigned q = lo | (hi << 4);
    q ^= q >> 2;
    q ^= q >> 1;          // bit 0 of a byte: parity of lo's, bit 4: hi's
    syn |= (q & 0x11111111u) << j;
  }
  return syn;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename AT, int MT, typename W>
__global__ void __launch_bounds__(COLS)
ecdp_kernel(const AT* __restrict__ a, const W w, float* __restrict__ out,
            int M, int K, int N, int k_split, int ecc) {
  __shared__ __align__(16) float a_s[MT][KT];
  __shared__ int syn2bit[128];
  const int tid = threadIdx.x;
  const int n = blockIdx.x * COLS + tid;
  const bool live = n < N;
  const int k_begin = blockIdx.y * k_split;
  const int k_end = min(K, k_begin + k_split);

  init_syn2bit(syn2bit);

  float acc[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m) acc[m] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += KT) {
    const int kt = min(KT, k_end - k0);
    __syncthreads();                 // the previous tile is consumed
    for (int i = tid; i < MT * KT; i += COLS) {
      const int m = i / KT, kk = i % KT;
      a_s[m][kk] = (m < M && kk < kt)
                       ? to_f32(a[(size_t)m * K + k0 + kk]) : 0.f;
    }
    __syncthreads();
    if (!live) continue;
    for (int c = 0; c < kt; c += 8) {
      unsigned long long word = w.word(k0 + c, n);
      if (ecc) {
        const unsigned p = w.parity_byte(k0 + c, n);
        unsigned syn = 0;
#pragma unroll
        for (int j = 0; j < 7; ++j)
          syn |= (unsigned)(__popcll(word & PHYS_MASK64[j]) & 1) << j;
        syn ^= p & 0x7Fu;
        // data parity ^ stored Hamming parity ^ received overall bit
        const unsigned dq = (unsigned)(__popcll(word) + __popc(p)) & 1u;
        const int bit = syn2bit[syn];
        if (dq && bit >= 0) word ^= 1ull << bit;
      }
      float wf[8];
#pragma unroll
      for (int r = 0; r < 8; ++r)
        wf[r] = (float)(int8_t)(uint8_t)(word >> (8 * r));
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const float4 x0 = *reinterpret_cast<const float4*>(&a_s[m][c]);
        const float4 x1 = *reinterpret_cast<const float4*>(&a_s[m][c + 4]);
        float s = acc[m];
        s = fmaf(x0.x, wf[0], s); s = fmaf(x0.y, wf[1], s);
        s = fmaf(x0.z, wf[2], s); s = fmaf(x0.w, wf[3], s);
        s = fmaf(x1.x, wf[4], s); s = fmaf(x1.y, wf[5], s);
        s = fmaf(x1.z, wf[6], s); s = fmaf(x1.w, wf[7], s);
        acc[m] = s;
      }
    }
  }
  if (!live) return;
  if (gridDim.y == 1) {
    const float s = w.col_scale(n);
#pragma unroll
    for (int m = 0; m < MT; ++m)
      if (m < M) out[(size_t)m * N + n] = acc[m] * s;
  } else {
    float* part = out + (size_t)blockIdx.y * M * N;
#pragma unroll
    for (int m = 0; m < MT; ++m)
      if (m < M) part[(size_t)m * N + n] = acc[m];
  }
}

// --- the tensor-core body (bf16 activations) --------------------------------

constexpr int WS = COLS + 16;   // weight tile row stride, bytes
constexpr int AS = KT + 8;      // activation tile row stride, bf16 elements

constexpr int CS = COLS + 1;    // output tile row stride, floats

// The tensor-core body's pipeline depth, and its threads for an M tile of
// bm rows: four warps side by side over the 128 columns, each taking 16
// rows (bm = 16) or 64 (bm = 64); bm = 128 stacks two such rows of warps.
constexpr int STAGES = 2;
__host__ __device__ constexpr int mma_threads(int bm) {
  return bm == 128 ? 256 : 128;
}

// One pipeline stage in dynamic shared memory: weight rows (raw, then
// corrected), their parity rows, activation rows.
template <int BM>
struct Stage {
  static constexpr int W_BYTES = KT * WS;
  static constexpr int P_BYTES = (KT / 8) * COLS;
  static constexpr int BYTES = W_BYTES + P_BYTES + BM * AS * 2;
  int8_t* w;
  uint8_t* p;
  __nv_bfloat16* a;
  __device__ __forceinline__ Stage(unsigned char* base, int st) {
    unsigned char* b = base + st * BYTES;
    w = reinterpret_cast<int8_t*>(b);
    p = reinterpret_cast<uint8_t*>(b + W_BYTES);
    a = reinterpret_cast<__nv_bfloat16*>(b + W_BYTES + P_BYTES);
  }
};

// Dynamic shared memory of the tensor-core body: its stages, which the
// output tile (BM x CS floats) reuses after the last step.
template <int BM>
constexpr int mma_smem_bytes() {
  return STAGES * Stage<BM>::BYTES > BM * CS * 4 ? STAGES * Stage<BM>::BYTES
                                                 : BM * CS * 4;
}

__device__ __forceinline__ void cp16(void* dst, const void* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int PENDING>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING));
}

// Stage s <- weight rows k0..k0+kt-1, their parity rows and activation
// rows m0..m0+BM-1 of the same K range; everything outside is zero. Of T
// threads, thread t copies the 16-byte chunks at weight rows t/8 + (T/8)i
// (and parity row t/8 for t < 64, activation rows t/8 + (T/8)i), byte
// (t%8)*16 of the row: a warp's copies cover whole 128-byte rows.
template <int BM, bool WIDE, typename W>
__device__ __forceinline__ void load_stage(const Stage<BM>& s,
                                           const __nv_bfloat16* a, const W& w,
                                           int M, int K, int N, int m0,
                                           int n0, int k0, int kt) {
  constexpr int RS = mma_threads(BM) / 8;   // rows between a thread's chunks
  const int tid = threadIdx.x, cr = tid >> 3, cb = (tid & 7) * 16;
  const bool col_ok = n0 + cb < N;
  if (WIDE) {
    const int8_t* q = w.q_rows(k0, n0) + cb;
    const int qs = w.q_stride();
#pragma unroll
    for (int i = 0; i < KT / RS; ++i) {
      const int r = cr + RS * i;
      const bool ok = col_ok && r < kt;
      cp16(s.w + r * WS + cb, q + (ok ? r * qs : 0), ok);
    }
    if (tid < KT) {
      const bool ok = col_ok && 8 * cr < kt;
      cp16(s.p + cr * COLS + cb,
           ok ? static_cast<const void*>(w.p16(k0 / 8 + cr, n0 + cb)) : q,
           ok);
    }
  } else {
#pragma unroll
    for (int i = 0; i < KT / RS; ++i) {
      const int r = cr + RS * i;
#pragma unroll 4
      for (int b = 0; b < 16; ++b)
        s.w[r * WS + cb + b] = (r < kt && n0 + cb + b < N)
                                   ? w.q_byte(k0 + r, n0 + cb + b) : int8_t(0);
    }
    if (tid < KT) {
#pragma unroll 4
      for (int b = 0; b < 16; ++b)
        s.p[cr * COLS + cb + b] =
            (8 * cr < kt && n0 + cb + b < N)
                ? (uint8_t)w.parity_byte(k0 + 8 * cr, n0 + cb + b) : 0;
    }
  }
  const int ce = cb / 2;                     // activation element
  const __nv_bfloat16* ar = a + (size_t)(m0 + cr) * K + k0 + ce;
#pragma unroll
  for (int i = 0; i < (BM + RS - 1) / RS; ++i) {
    const int r = cr + RS * i;
    if (r >= BM) break;
    const bool ok = m0 + r < M && ce < kt;
    const __nv_bfloat16* src = ar + (size_t)RS * i * K;
    __nv_bfloat16* dst = s.a + r * AS + ce;
    if (WIDE) {
      cp16(dst, ok ? src : a, ok);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        dst[e] = ok ? src[e] : __float2bfloat16(0.f);
    }
  }
}

// Correct stage s's codewords in place. Thread (cr, g) takes codeword row
// cr (rows 8cr..8cr+7) of columns 4g..4g+3.
template <int BM>
__device__ __forceinline__ void correct_stage(const Stage<BM>& s, int kt,
                                              const int* syn2bit) {
  constexpr int NW = mma_threads(BM) / 32;
  const int g = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < KT / 8 / NW; ++i) {
    const int cr = (threadIdx.x >> 5) + NW * i;
    if (cr >= kt / 8) break;
    int8_t* base = &s.w[8 * cr * WS + 4 * g];
    unsigned rw[8];
#pragma unroll
    for (int r = 0; r < 8; ++r)
      rw[r] = *reinterpret_cast<const unsigned*>(base + r * WS);
    const unsigned pw =
        *reinterpret_cast<const unsigned*>(&s.p[cr * COLS + 4 * g]);
    // byte c: bits 0..6 the syndrome, bit 7 data parity ^ stored overall bit
    const unsigned syn = syndromes4(rw) ^ pw;
    if (!(syn & 0x7F7F7F7Fu)) continue;   // all four clean (or parity only)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const unsigned sj = (syn >> (8 * j)) & 0xFFu;
      // data parity ^ stored Hamming parity ^ received overall bit
      const unsigned dq = ((sj >> 7) ^ __popc((pw >> (8 * j)) & 0x7Fu)) & 1u;
      const int bit = syn2bit[sj & 0x7Fu];
      if (dq && bit >= 0)
        base[(bit >> 3) * WS + j] ^= (int8_t)(1 << (bit & 7));
    }
  }
}

// Byte j of x and of y (int8) as a bf16 pair {x_j, y_j}: each byte, biased
// to unsigned, goes into the mantissa of 2^23 and 2^23 + 128 comes off
// (exact in f32), then both round to bf16 (exact, |q| <= 127).
__device__ __forceinline__ unsigned bf16_pair(unsigned xb, unsigned yb,
                                              int j) {
  const unsigned sel = 0x7650 + j;
  const float fx = __uint_as_float(__byte_perm(xb, 0x4B000000u, sel))
                   - 8388736.f;
  const float fy = __uint_as_float(__byte_perm(yb, 0x4B000000u, sel))
                   - 8388736.f;
  const __nv_bfloat162 h = __floats2bfloat162_rn(fx, fy);
  return *reinterpret_cast<const unsigned*>(&h);
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Warp w owns block rows 64(w/4).. (WM of them) and columns 32(w%4)..
// 32(w%4)+31; its n8 tile j, MMA column 0 <= c < 8, is block column
// 32(w%4) + 4c + j.
template <int BM, bool WIDE, typename W>
__global__ void __launch_bounds__(mma_threads(BM))
ecdp_mma_kernel(const __nv_bfloat16* __restrict__ a, const W w,
                float* __restrict__ out, int M, int K, int N, int k_split,
                int ecc) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int syn2bit[128];
  constexpr int S = STAGES, NT = mma_threads(BM), WM = BM < 64 ? BM : 64;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int wn = 32 * (warp & 3), wm = 64 * (warp >> 2);
  const int n0 = blockIdx.x * COLS, m0 = blockIdx.z * BM;
  const int k_begin = blockIdx.y * k_split;
  const int k_end = min(K, k_begin + k_split);
  const int n_steps = (k_end - k_begin + KT - 1) / KT;

  init_syn2bit(syn2bit);

  float acc[WM / 16][4][4];
#pragma unroll
  for (int mt = 0; mt < WM / 16; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;

  // steps 0..S-2 in flight; one commit group per step, empty past the end
#pragma unroll
  for (int i = 0; i < S - 1; ++i) {
    const int k0 = k_begin + i * KT;
    if (i < n_steps)
      load_stage<BM, WIDE>(Stage<BM>(smem, i), a, w, M, K, N, m0, n0, k0,
                           min(KT, k_end - k0));
    cp_commit();
  }
  for (int t = 0; t < n_steps; ++t) {
    const int k0 = k_begin + t * KT, kt = min(KT, k_end - k0);
    cp_wait<S - 2>();
    __syncthreads();          // step t has landed; step t-1 is consumed
    const int tn = t + S - 1;  // into step t-1's stage
    if (tn < n_steps) {
      const int kn = k_begin + tn * KT;
      load_stage<BM, WIDE>(Stage<BM>(smem, tn % S), a, w, M, K, N, m0, n0,
                           kn, min(KT, k_end - kn));
    }
    cp_commit();
    const Stage<BM> s(smem, t % S);
    if (ecc) {
      correct_stage(s, kt, syn2bit);
      __syncthreads();        // step t is corrected
    }
#pragma unroll
    for (int kb = 0; kb < KT; kb += 16) {
      if (kb >= kt) break;
      const int8_t* wb = &s.w[(kb + 2 * tig) * WS + wn + 4 * gid];
      const unsigned bias = 0x80808080u;
      const unsigned q0 = *reinterpret_cast<const unsigned*>(wb) ^ bias;
      const unsigned q1 = *reinterpret_cast<const unsigned*>(wb + WS) ^ bias;
      const unsigned q2 =
          *reinterpret_cast<const unsigned*>(wb + 8 * WS) ^ bias;
      const unsigned q3 =
          *reinterpret_cast<const unsigned*>(wb + 9 * WS) ^ bias;
      unsigned b0[4], b1[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        b0[j] = bf16_pair(q0, q1, j);
        b1[j] = bf16_pair(q2, q3, j);
      }
#pragma unroll
      for (int mt = 0; mt < WM / 16; ++mt) {
        unsigned af[4];
        ldsm_x4(af, &s.a[(wm + 16 * mt + (lane & 15)) * AS + kb
                         + (lane >> 4) * 8]);
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(acc[mt][j], af, b0[j], b1[j]);
      }
    }
  }

  // The output tile through shared memory, so each row goes out whole.
  cp_wait<0>();
  __syncthreads();            // every stage is consumed
  float* c_s = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int mt = 0; mt < WM / 16; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        c_s[(wm + 16 * mt + gid + 8 * (e >> 1)) * CS + wn
            + 4 * (2 * tig + (e & 1)) + j] = acc[mt][j][e];
  __syncthreads();
  const int c = tid % COLS, n = n0 + c;
  if (n >= N) return;
  const bool whole = gridDim.y == 1;
  const float sc = whole ? w.col_scale(n) : 1.f;
  float* dst = (whole ? out : out + (size_t)blockIdx.y * M * N) + n;
  const int rows = min(BM, M - m0);
  for (int r = tid / COLS; r < rows; r += NT / COLS) {
    const float v = c_s[r * CS + c];
    dst[(size_t)(m0 + r) * N] = whole ? v * sc : v;
  }
}

// out[m, n] = scale[n] * sum over splits of part[split, m, n]
template <typename W>
__global__ void ecdp_reduce(const float* __restrict__ part, const W w,
                            float* __restrict__ out, int M, int N,
                            int splits) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t mn = (size_t)M * N;
  if (i >= mn) return;
  float s = 0.f;
  for (int j = 0; j < splits; ++j) s += part[(size_t)j * mn + i];
  out[i] = s * w.col_scale((int)(i % N));
}

template <typename W>
void launch_f32_rows(const float* a, const W& w, float* dst, int M, int K,
                     int N, int k_split, int gy, int ecc, cudaStream_t st) {
  const dim3 grid((N + COLS - 1) / COLS, gy);
  if (M <= 8)
    ecdp_kernel<float, 8, W><<<grid, COLS, 0, st>>>(a, w, dst, M, K, N, k_split, ecc);
  else if (M <= 16)
    ecdp_kernel<float, 16, W><<<grid, COLS, 0, st>>>(a, w, dst, M, K, N, k_split, ecc);
  else if (M <= 32)
    ecdp_kernel<float, 32, W><<<grid, COLS, 0, st>>>(a, w, dst, M, K, N, k_split, ecc);
  else
    ecdp_kernel<float, 64, W><<<grid, COLS, 0, st>>>(a, w, dst, M, K, N, k_split, ecc);
}

template <int BM, bool WIDE, typename W>
int launch_mma(const __nv_bfloat16* a, const W& w, float* dst, int M, int K,
               int N, int k_split, int gy, int ecc, cudaStream_t st) {
  constexpr int smem = mma_smem_bytes<BM>();
  if (smem > 48 * 1024) {     // above the default limit: opt in
    const cudaError_t err = cudaFuncSetAttribute(
        ecdp_mma_kernel<BM, WIDE, W>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((N + COLS - 1) / COLS, gy, (M + BM - 1) / BM);
  ecdp_mma_kernel<BM, WIDE, W><<<grid, mma_threads(BM), smem, st>>>(
      a, w, dst, M, K, N, k_split, ecc);
  return 0;
}

// The launches of one product, as the wrapper's launch plan gives them: K
// cut into runs of k_split rows (a multiple of 8), a reduce when there is
// more than one.
//   bf16 a: one tensor-core launch over all M in tiles of m_tile (16, 64
//     or 128) rows; partial holds splits*M*N floats.
//   f32 a: M in runs of MAX_M rows, one CUDA-core launch and reduce each;
//     partial holds splits*min(M,64)*N floats.
// wide (bf16 only): every 16-byte run of the weight's rows, of its parity
// rows and of a's rows is 16-byte aligned.
// Returns cudaGetLastError() after the launches (cudaErrorInvalidValue for
// a plan the kernels do not take).
template <typename W>
int ecdp_launch(const void* a, int a_bf16, const W& w, void* out,
                void* partial, int M, int K, int N, int k_split, int m_tile,
                int wide, int ecc, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k_split < 8 || k_split % 8) return cudaErrorInvalidValue;
  const int gy = (K + k_split - 1) / k_split;
  if (a_bf16) {
    if ((m_tile != 16 && m_tile != 64 && m_tile != 128) || k_split % KT)
      return cudaErrorInvalidValue;
    float* dst = gy == 1 ? static_cast<float*>(out)
                         : static_cast<float*>(partial);
    const auto* ab = static_cast<const __nv_bfloat16*>(a);
    int err;
    if (m_tile == 16)
      err = wide ? launch_mma<16, true>(ab, w, dst, M, K, N, k_split, gy, ecc,
                                        st)
                 : launch_mma<16, false>(ab, w, dst, M, K, N, k_split, gy,
                                         ecc, st);
    else if (m_tile == 64)
      err = wide ? launch_mma<64, true>(ab, w, dst, M, K, N, k_split, gy, ecc,
                                        st)
                 : launch_mma<64, false>(ab, w, dst, M, K, N, k_split, gy,
                                         ecc, st);
    else
      err = wide ? launch_mma<128, true>(ab, w, dst, M, K, N, k_split, gy,
                                         ecc, st)
                 : launch_mma<128, false>(ab, w, dst, M, K, N, k_split, gy,
                                          ecc, st);
    if (err) return err;
    if (gy > 1) {
      const size_t mn = (size_t)M * N;
      ecdp_reduce<W><<<(unsigned)((mn + 255) / 256), 256, 0, st>>>(
          static_cast<const float*>(partial), w, static_cast<float*>(out), M,
          N, gy);
    }
    return static_cast<int>(cudaGetLastError());
  }
  for (int m0 = 0; m0 < M; m0 += MAX_M) {
    const int mc = M - m0 < MAX_M ? M - m0 : MAX_M;
    float* rows_out = static_cast<float*>(out) + (size_t)m0 * N;
    float* dst = gy == 1 ? rows_out : static_cast<float*>(partial);
    launch_f32_rows(static_cast<const float*>(a) + (size_t)m0 * K, w, dst,
                    mc, K, N, k_split, gy, ecc, st);
    if (gy > 1) {
      const size_t mn = (size_t)mc * N;
      ecdp_reduce<W><<<(unsigned)((mn + 255) / 256), 256, 0, st>>>(
          static_cast<const float*>(partial), w, rows_out, mc, N, gy);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
