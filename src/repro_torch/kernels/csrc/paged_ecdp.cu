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
// 128 columns are one tile column, so a 64-row step of the weight is 64
// page rows of 128 bytes in one page (a 16-byte run never leaves a page
// row); parity and scales are read through their page runs directly (16
// bytes at a time where N % 16 == 0: 16384 % 16 == 0, so a run never
// straddles two pages), and the logical (K, N) bounds every loop, so no
// padded copy of anything is made. With the same launch plan the result is
// bit-identical to ecdp_matmul on the dense weight with the same bytes.
//
// The expert axis (grouped_paged_ecdp_matmul). The streamed MoE plane
// keeps each routed expert's banks as pool pages and names them through a
// per-layer SLAB: slab row e's page tables are row e of q tables stacked
// (E_slab, kt, nt) and parity / scale runs stacked (E_slab, np) and
// (E_slab, ns). Replaces the reference's per-expert paged ECDP mapped over
// the slab (src/repro/models/moe.py::_expert_matmul's
// jax.vmap(ops.paged_ecdp_matmul_xla), the XLA twin of
// paged_ecdp_matmul_pallas, ECC off there), computed on the routed rows
// only, as grouped_ecdp.cu argues for the dense bank. PagedBank maps slab
// row e to the PagedWeight above and the launch is grouped_ecdp.cu's
// (ecdp_core.cuh's grouped_ecdp_launch): a (R,K) bf16 rows sorted by slab
// row, slab row e's at row_start[e] .. row_start[e+1]-1 on the device,
// grid z over the slab rows, a row with no routed rows exits before it
// reads a page. Bounded, like the dense grouped launch, by the routed
// experts' (9/8)*K*N bytes at 3.35 TB/s. With the same launch plan and the
// same bytes its output is bit-identical to grouped_ecdp_matmul's.
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
  // a 64-row step of a 128-column block lies in one page (64 | 128)
  __device__ __forceinline__ const int8_t* q_rows(int k0, int n0) const {
    const int page = __ldg(q_tbl + (k0 / TILE) * nt + n0 / TILE);
    return pool + (size_t)page * PAGE + (k0 % TILE) * TILE + n0 % TILE;
  }
  __device__ __forceinline__ int q_stride() const { return TILE; }
  __device__ __forceinline__ int8_t q_byte(int k, int n) const {
    const int page = __ldg(q_tbl + (k / TILE) * nt + n / TILE);
    return __ldg(pool + (size_t)page * PAGE + (k % TILE) * TILE + n % TILE);
  }
  __device__ __forceinline__ const uint8_t* p16(int c, int n0) const {
    const size_t i = (size_t)c * N + n0;
    const int page = __ldg(p_slots + i / PAGE);
    return reinterpret_cast<const uint8_t*>(pool + (size_t)page * PAGE
                                            + i % PAGE);
  }
  __device__ __forceinline__ unsigned parity_byte(int k, int n) const {
    return __ldg(p16(k / 8, n));
  }
  __device__ __forceinline__ float col_scale(int n) const {
    const size_t i = (size_t)n * 4;
    const int page = __ldg(s_slots + i / PAGE);
    return __ldg(reinterpret_cast<const float*>(pool + (size_t)page * PAGE
                                                + i % PAGE));
  }
};

// A slab of paged expert weights: slab row e is the PagedWeight over row e
// of the stacked page tables.
struct PagedBank {
  const int8_t* pool;
  const int* q_tbl;      // (E_slab, kt, nt)
  const int* p_slots;    // (E_slab, np)
  const int* s_slots;    // (E_slab, ns)
  int kt, nt, np, ns, N;

  __device__ __forceinline__ PagedWeight expert(int e) const {
    return PagedWeight{pool, q_tbl + (size_t)e * kt * nt,
                       p_slots + (size_t)e * np, s_slots + (size_t)e * ns, N,
                       nt};
  }
};

}  // namespace

// a (M,K) bf16 (a_bf16=1) or f32; pool (n_pages, 16384) int8; q_tbl
// (ceil(K/128), nt = ceil(N/128)) i32; p_slots, s_slots i32 page runs;
// out (M,N) f32. k_split, m_tile, wide and partial's size as ecdp_launch
// (ecdp_core.cuh) takes them. K % 8 == 0, M, N > 0. Returns
// cudaGetLastError() after the launches.
extern "C" int paged_ecdp_matmul(const void* a, int a_bf16, const void* pool,
                                 const void* q_tbl, const void* p_slots,
                                 const void* s_slots, void* out,
                                 void* partial, int M, int K, int N, int nt,
                                 int k_split, int m_tile, int wide, int ecc,
                                 void* stream) {
  const PagedWeight w{static_cast<const int8_t*>(pool),
                      static_cast<const int*>(q_tbl),
                      static_cast<const int*>(p_slots),
                      static_cast<const int*>(s_slots), N, nt};
  return ecdp_launch(a, a_bf16, w, out, partial, M, K, N, k_split, m_tile,
                     wide, ecc, stream);
}

// a (R,K) bf16 rows sorted by slab row; row_start (E+1,) i32 on the device;
// pool (n_pages, 16384) int8; q_tbl (E, kt, nt), p_slots (E, np), s_slots
// (E, ns) i32, E = the slab's rows; out (R,N) f32. k_split, m_tile, wide
// and partial's size as grouped_ecdp_launch (ecdp_core.cuh) takes them.
// K % 8 == 0, R, N > 0. Returns cudaGetLastError() after the launches.
extern "C" int grouped_paged_ecdp_matmul(
    const void* a, const void* row_start, const void* pool, const void* q_tbl,
    const void* p_slots, const void* s_slots, void* out, void* partial, int E,
    int R, int K, int N, int kt, int nt, int np, int ns, int k_split,
    int m_tile, int wide, int ecc, void* stream) {
  const PagedBank bank{static_cast<const int8_t*>(pool),
                       static_cast<const int*>(q_tbl),
                       static_cast<const int*>(p_slots),
                       static_cast<const int*>(s_slots), kt, nt, np, ns, N};
  return grouped_ecdp_launch(a, bank, static_cast<const int*>(row_start), out,
                             partial, E, R, K, N, k_split, m_tile, wide, ecc,
                             stream);
}

// Dynamic shared memory per block of the grouped launch at M tile m_tile
// (16 or 64), in bytes; -1 for another tile.
extern "C" int grouped_paged_ecdp_smem_bytes(int m_tile) {
  return m_tile == 16 ? mma_smem_bytes<16>()
       : m_tile == 64 ? mma_smem_bytes<64>() : -1;
}
