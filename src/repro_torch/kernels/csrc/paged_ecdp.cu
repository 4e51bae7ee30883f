// Paged ECDP: the error-correcting dot-product engine reading its weight
// in place from the device weight page pool, for Hopper.
//
// Replaces src/repro/kernels/paged_ffn.py::paged_ecdp_matmul_pallas (kernel
// body _paged_ecdp_kernel, wrapper ops.paged_ecdp_matmul): out = (a @
// correct(w)) * scale with a (M,K) bf16 or f32 and the (K,N) int8 weight
// held as raw 16 KiB pages of the pool (n_pages, 16384) int8, exactly as
// the page store serialized them:
//   * q: 128x128 tiles, one per page; logical tile (kt, nt) sits in pool
//     page q_tbl[kt][nt], zero-padded past K and N. Weight byte (k, n) is
//     pool[q_tbl[k/128][n/128]] + (k%128)*128 + n%128.
//   * parity: the (K/8, N) uint8 plane as a flat byte run over the pages
//     p_slots; byte (r, n) is flat index i = r*N + n, at
//     pool[p_slots[i/16384]] + i%16384.
//   * scale: the (N,) f32 scales as a flat byte run over the pages
//     s_slots; scale n is the 4 bytes at flat index 4n (16384 % 4 == 0, so
//     a scale never straddles two pages).
// A codeword (8 consecutive K rows of one column, k a multiple of 8)
// never straddles two tiles because 128 % 8 == 0.
//
// What bounds it on the H100: the weight pages, as for the dense ECDP: on
// the serving path M is at most 64, so the least time is the (9/8)*K*N
// bytes of weights and parity read once at 3.35 TB/s.
//
// Design. The TPU kernel scalar-prefetches the page table so its weight
// BlockSpec maps a logical tile to a pool page, gathers parity dense in the
// wrapper and pads the activations to the tile grid. Here the kernel body
// is ecdp.cu's (ecdp_core.cuh) with only the addressing changed: a block's
// 128 columns are one tile column, so every thread of a block reads the
// same q_tbl entry (a broadcast) and a codeword's 8 rows are 128 bytes
// apart in one page; parity and scales are read through their page runs
// directly, and the logical (K, N) bounds every loop, so no padded copy of
// anything is made. With the same K split the result is bit-identical to
// ecdp_matmul on the dense weight with the same bytes.
#include "ecdp_core.cuh"

namespace {

constexpr int PAGE = 16384;   // bytes per pool page = one 128x128 tile
constexpr int TILE = 128;

struct PagedWeight {
  const int8_t* pool;
  const int* q_tbl;      // (kt, nt) pool slots of the q tiles
  const int* p_slots;    // pool slots of the parity run
  const int* s_slots;    // pool slots of the scale run
  int N;
  int nt;

  __device__ __forceinline__ unsigned long long word(int k, int n) const {
    const int page = __ldg(q_tbl + (k / TILE) * nt + n / TILE);
    const int8_t* wp = pool + (size_t)page * PAGE + (k % TILE) * TILE
                       + n % TILE;
    unsigned long long w = 0;
#pragma unroll
    for (int r = 0; r < 8; ++r)
      w |= (unsigned long long)(uint8_t)__ldg(wp + r * TILE) << (8 * r);
    return w;
  }
  __device__ __forceinline__ unsigned parity_byte(int k, int n) const {
    const size_t i = (size_t)(k / 8) * N + n;
    const int page = __ldg(p_slots + i / PAGE);
    return (uint8_t)__ldg(pool + (size_t)page * PAGE + i % PAGE);
  }
  __device__ __forceinline__ float col_scale(int n) const {
    const size_t i = (size_t)n * 4;
    const int page = __ldg(s_slots + i / PAGE);
    return __ldg(reinterpret_cast<const float*>(pool + (size_t)page * PAGE
                                                + i % PAGE));
  }
};

}  // namespace

// a (M,K) bf16 (a_bf16=1) or f32; pool (n_pages, 16384) int8; q_tbl
// (ceil(K/128), nt = ceil(N/128)) i32; p_slots, s_slots i32 page runs;
// out (M,N) f32. partial holds splits*min(M,64)*N floats when splits > 1
// (else unused). K % 8 == 0, M, N > 0. Returns cudaGetLastError() after
// the launches.
extern "C" int paged_ecdp_matmul(const void* a, int a_bf16, const void* pool,
                                 const void* q_tbl, const void* p_slots,
                                 const void* s_slots, void* out,
                                 void* partial, int M, int K, int N, int nt,
                                 int splits, int ecc, void* stream) {
  const PagedWeight w{static_cast<const int8_t*>(pool),
                      static_cast<const int*>(q_tbl),
                      static_cast<const int*>(p_slots),
                      static_cast<const int*>(s_slots), N, nt};
  return ecdp_launch(a, a_bf16, w, out, partial, M, K, N, splits, ecc,
                     stream);
}
