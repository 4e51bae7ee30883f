// Expert-grouped ECDP: one launch multiplies every expert of an MoE bank
// by the rows routed to it, for Hopper.
//
// Replaces, for the expert banks, the per-expert ECDP the reference maps
// over the bank: src/repro/models/moe.py::_expert_matmul's
// jax.vmap(ops.ecdp_matmul_xla) over (E, A, K) (the XLA counterpart of
// src/repro/kernels/ecdp.py::ecdp_matmul_pallas, one product per expert
// over every column of the dispatch buffer). out = (a @ correct(wq[e])) *
// scale[e] for the rows of expert e: a (R,K) bf16 with the rows of expert
// e at row_start[e] .. row_start[e+1]-1, wq (E,K,N) raw int8, parity
// (E,K/8,N) uint8, scale (E,1,N) f32, out (R,N) f32 in a's row order.
// The reference's product of each expert with all A columns of its buffer
// reads back only the routed column of each (token, k) assignment, and
// each output row depends only on its own input row, so computing the
// routed rows alone is the same function.
//
// What bounds it on the H100: the routed experts' weights, (9/8)*K*N bytes
// each of INT8 and parity read once, at 3.35 TB/s (a serving step of
// qwen3-moe-30b-a3b routes 512 rows over up to 128 experts, a few rows
// each; an expert never gets more than slots x chunk rows, since top-k
// picks distinct experts).
//
// Design. The body is ecdp.cu's (ecdp_core.cuh: tensor-core products,
// SEC-DED correction in shared memory when ecc is set, 16-byte cp.async
// loads, two stages); the grid's z axis walks the experts and a block reads
// its expert's row range from row_start on the device, so the launch is
// static in shape and capturable in a CUDA graph, and a block whose expert
// was routed no rows exits before it reads a weight byte. An expert's rows
// run in M tiles of 16 or 64 (the wrapper picks by the most rows an expert
// can get), a warp skipping its m16 tiles past the expert's rows. K may be
// split over gridDim.y, with a per-expert fixed-order reduction.
#include "ecdp_core.cuh"

namespace {

// An (E, K, N) bank of dense weights: expert e is a DenseWeight.
struct DenseBank {
  const int8_t* wq;
  const uint8_t* parity;
  const float* scale;
  int K, N;

  __device__ __forceinline__ DenseWeight expert(int e) const {
    return DenseWeight{wq + (size_t)e * K * N,
                       parity + (size_t)e * (K / 8) * N,
                       scale + (size_t)e * N, N};
  }
};

}  // namespace

// a (R,K) bf16; row_start (E+1,) i32 on the device; wq (E,K,N) int8;
// parity (E,K/8,N) u8; scale (E,1,N) f32; out (R,N) f32. k_split, m_tile,
// wide and partial's size as grouped_ecdp_launch (ecdp_core.cuh) takes
// them. K % 8 == 0, R, N > 0. Returns cudaGetLastError() after the
// launches.
extern "C" int grouped_ecdp_matmul(const void* a, const void* row_start,
                                   const void* wq, const void* parity,
                                   const void* scale, void* out,
                                   void* partial, int E, int R, int K, int N,
                                   int k_split, int m_tile, int wide, int ecc,
                                   void* stream) {
  const DenseBank bank{static_cast<const int8_t*>(wq),
                       static_cast<const uint8_t*>(parity),
                       static_cast<const float*>(scale), K, N};
  return grouped_ecdp_launch(a, bank, static_cast<const int*>(row_start), out,
                             partial, E, R, K, N, k_split, m_tile, wide, ecc,
                             stream);
}

// Dynamic shared memory per block at M tile m_tile (16 or 64), in bytes;
// -1 for another tile.
extern "C" int grouped_ecdp_smem_bytes(int m_tile) {
  return m_tile == 16 ? mma_smem_bytes<16>()
       : m_tile == 64 ? mma_smem_bytes<64>() : -1;
}
