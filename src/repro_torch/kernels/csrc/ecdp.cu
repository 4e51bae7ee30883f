// ECDP: the error-correcting dot-product engine (paper §3.2-3.3) for Hopper.
//
// Replaces src/repro/kernels/ecdp.py::ecdp_matmul_pallas (kernel body
// _ecdp_kernel, wrapper ops.ecdp_matmul): out = (a @ correct(wq)) * scale,
// a (M,K) bf16 or f32, wq (K,N) raw int8 read as stored (possibly with bit
// errors), parity (K/8,N) uint8 Hamming(72,64) SEC-DED bytes, scale (N,)
// f32, out (M,N) f32. A codeword is 8 consecutive K rows of one column.
//
// What bounds it on the H100: on the serving and decode paths (M <= 64)
// the weights: the (9/8)*K*N bytes of weights and parity, each read once,
// at 3.35 TB/s. At prefill's M = 512 the products: 2*M*K*N at the bf16
// tensor-core rate (989 TFLOP/s with wgmma; mma.sync reaches a part of it).
//
// Design. The TPU kernel runs a dense MAC on the raw bytes and then a
// deferred correction matmul under pl.when for blocks with a dirty
// codeword. Here the correction happens before the MAC (in shared memory
// for bf16 activations, in registers for f32): it yields the same integer
// weights, so the same output, and no second pass. bf16 activations run on
// the tensor cores (mma.sync, 16-byte cp.async loads, two stages), f32
// activations on CUDA cores; see ecdp_core.cuh, shared with paged_ecdp.cu.
// This file gives the body the dense addressing (codeword rows N bytes
// apart). The card has 132 SMs but N/128 blocks can be as few as 32, so K
// is split over gridDim.y (the wrapper's launch plan) with a fixed-order
// reduction.
#include "ecdp_core.cuh"

namespace {

// The weight as a dense (K, N) int8 matrix, (K/8, N) parity, (N,) scales.
struct DenseWeight {
  const int8_t* wq;
  const uint8_t* parity;
  const float* scale;
  int N;

  __device__ __forceinline__ unsigned long long word(int k, int n) const {
    const int8_t* wp = wq + (size_t)k * N + n;
    unsigned long long w = 0;
#pragma unroll
    for (int r = 0; r < 8; ++r)
      w |= (unsigned long long)(uint8_t)__ldg(wp + (size_t)r * N) << (8 * r);
    return w;
  }
  __device__ __forceinline__ int8_t q_byte(int k, int n) const {
    return __ldg(wq + (size_t)k * N + n);
  }
  __device__ __forceinline__ const int8_t* q_rows(int k0, int n0) const {
    return wq + (size_t)k0 * N + n0;
  }
  __device__ __forceinline__ int q_stride() const { return N; }
  __device__ __forceinline__ unsigned parity_byte(int k, int n) const {
    return __ldg(parity + (size_t)(k >> 3) * N + n);
  }
  __device__ __forceinline__ const uint8_t* p16(int c, int n0) const {
    return parity + (size_t)c * N + n0;
  }
  __device__ __forceinline__ float col_scale(int n) const {
    return __ldg(scale + n);
  }
};

}  // namespace

// a (M,K) bf16 (a_bf16=1) or f32; wq (K,N) int8; parity (K/8,N) u8;
// scale (N,) f32; out (M,N) f32. k_split, m_tile, wide and partial's size
// as ecdp_launch (ecdp_core.cuh) takes them. K % 8 == 0, M, N > 0. Returns
// cudaGetLastError() after the launches.
extern "C" int ecdp_matmul(const void* a, int a_bf16, const void* wq,
                           const void* parity, const void* scale, void* out,
                           void* partial, int M, int K, int N, int k_split,
                           int m_tile, int wide, int ecc, void* stream) {
  const DenseWeight w{static_cast<const int8_t*>(wq),
                      static_cast<const uint8_t*>(parity),
                      static_cast<const float*>(scale), N};
  return ecdp_launch(a, a_bf16, w, out, partial, M, K, N, k_split, m_tile,
                     wide, ecc, stream);
}

// Dynamic shared memory per block of the tensor-core body at M tile m_tile
// (16, 64 or 128), in bytes; -1 for another tile.
extern "C" int ecdp_mma_smem_bytes(int m_tile) {
  return m_tile == 16 ? mma_smem_bytes<16>()
       : m_tile == 64 ? mma_smem_bytes<64>()
       : m_tile == 128 ? mma_smem_bytes<128>() : -1;
}
