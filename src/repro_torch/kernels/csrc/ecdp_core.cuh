// The ECDP kernel body, shared by ecdp.cu (a dense (K,N) int8 weight) and
// paged_ecdp.cu (the same weight as 16 KiB pages of the weight page pool).
//
// out = (a @ correct(w)) * scale, a (M,K) bf16 or f32, w raw int8 read as
// stored (possibly with bit errors), Hamming(72,64) SEC-DED parity per
// 8-row codeword of one column, per-column f32 scales, out (M,N) f32.
// Where the weight's bytes, parity bytes and scales live is the template
// parameter W: a struct with
//   word(k, n)        the codeword of rows k..k+7 of column n, byte r = row k+r
//   parity_byte(k, n) its parity byte
//   col_scale(n)      column n's scale
// Every other instruction is the same for both weights, so with the same
// K split the two kernels give bit-identical outputs on the same bytes.
//
// Design (see ecdp.cu for what bounds it):
//   * A block owns 128 output columns (one per thread) and all M rows, so
//     neighbouring threads load neighbouring bytes: each of a codeword's 8
//     rows is one coalesced 128-byte row segment per block.
//   * Each thread packs its codeword into a 64-bit word, computes the 7
//     Hamming bits as popcount(word & PHYS_MASK64[j]) and the overall
//     parity, and flips the one data bit a single-error syndrome names (a
//     128-entry syndrome -> bit table in shared memory, built from
//     DATA_POS). Double errors are detected and left raw, as in the
//     reference.
//   * The corrected int8 weights become f32 (exact) and multiply the
//     activations, staged as f32 in shared memory a tile of K at a time
//     and read as float4 broadcasts; sums are f32. The scale is applied in
//     the epilogue.
//   * K is split over gridDim.y; each split writes f32 partial sums and a
//     second kernel adds them in a fixed order (deterministic) and scales.
//   * Ragged N is masked per thread; K only needs to be a multiple of 8.
// The wrappers allocate the output and the partials; nothing here
// allocates, and every launch goes to the caller's stream.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int COLS = 128;   // threads per block = output columns per block
constexpr int KT = 64;      // K rows of activations staged per tile
constexpr int MAX_M = 64;   // rows per launch; larger M loops in the entry

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

  for (int i = tid; i < 128; i += COLS) syn2bit[i] = -1;
  __syncthreads();
  if (tid < 64) syn2bit[DATA_POS[tid]] = tid;

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

template <typename AT, typename W>
void launch_rows(const AT* a, const W& w, float* dst, int M, int K, int N,
                 int k_split, int gy, int ecc, cudaStream_t st) {
  const dim3 grid((N + COLS - 1) / COLS, gy);
  if (M <= 8)
    ecdp_kernel<AT, 8, W><<<grid, COLS, 0, st>>>(a, w, dst, M, K, N, k_split, ecc);
  else if (M <= 16)
    ecdp_kernel<AT, 16, W><<<grid, COLS, 0, st>>>(a, w, dst, M, K, N, k_split, ecc);
  else if (M <= 32)
    ecdp_kernel<AT, 32, W><<<grid, COLS, 0, st>>>(a, w, dst, M, K, N, k_split, ecc);
  else
    ecdp_kernel<AT, 64, W><<<grid, COLS, 0, st>>>(a, w, dst, M, K, N, k_split, ecc);
}

// The launches of one product: K cut into `splits` runs of whole
// codewords, M in runs of MAX_M rows, a reduce per run when K is split.
// partial holds splits*min(M,64)*N floats when splits > 1. Returns
// cudaGetLastError() after the launches.
template <typename W>
int ecdp_launch(const void* a, int a_bf16, const W& w, void* out,
                void* partial, int M, int K, int N, int splits, int ecc,
                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (splits < 1) splits = 1;
  const int k_split = ((K / 8 + splits - 1) / splits) * 8;
  const int gy = (K + k_split - 1) / k_split;
  for (int m0 = 0; m0 < M; m0 += MAX_M) {
    const int mc = M - m0 < MAX_M ? M - m0 : MAX_M;
    float* rows_out = static_cast<float*>(out) + (size_t)m0 * N;
    float* dst = gy == 1 ? rows_out : static_cast<float*>(partial);
    if (a_bf16)
      launch_rows(static_cast<const __nv_bfloat16*>(a) + (size_t)m0 * K, w,
                  dst, mc, K, N, k_split, gy, ecc, st);
    else
      launch_rows(static_cast<const float*>(a) + (size_t)m0 * K, w, dst,
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
