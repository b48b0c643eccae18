// Block-ELL sparse x dense product y = A . X on Hopper (sm_90a), CUDA cores.
//
// Replaces the two Pallas TPU kernels of src/repro/kernels/block_spmm.py:
// `_spmm_kernel` (all K slots) and `_spmm_kernel_rowk` (the K loop stops at
// row_k[i]; exact, because slots past it hold all-zero tiles). One kernel
// does both: `row_k == nullptr` means every row-block runs all K slots.
//
//   y[i*B + r, f] = sum_{k < row_k[i]} sum_c blocks[i, k, r, c] * x[block_cols[i, k]*B + c, f]
//
// Design. On the TPU, K is a sequential grid axis that carries the sum in
// VMEM scratch from one grid step to the next. Blocks on a GPU run in no
// order, so here a thread block owns one output tile (64 rows of row-block i
// x 64 features) and walks the slots k itself: it reads block_cols[i, k],
// stages the matching (64 x 16) chunk of the A tile and (16 x 64) chunk of the
// X tile through 8.5 KB of static shared memory (well under the 48 KB static
// limit at any B), and accumulates 4 x 4 outputs per thread in fp32
// registers. The output is written once, in x's dtype, with the ragged row
// (B < 64) and feature (F % 64) edges masked. Operands are fp32 or bf16 (a
// template on the element type); bf16 values are widened to fp32 in shared
// memory, so a bf16 x bf16 product is exact and the sum is fp32, as in the
// reference's `preferred_element_type=jnp.float32`.
//
// What bounds it. At the serving shape of ppi_sota (B = 128, K = 110 slots
// per row-block, F = 2048) one full-graph propagation is 14,630 slots x
// 2*128*128*2048 FLOP = 9.8e11 FLOP, all on the fp32 CUDA cores (TF32 is off
// by contract): about 15 ms at the H100 SXM's 67 TFLOP/s fp32 peak. Each slot
// also re-reads its X tile, 128 x 2048 x 4 B = 1 MiB, against 64 KiB of tile
// values; those re-reads mostly hit the 50 MB L2. Tensor cores, wgmma and TMA
// are not used yet.
//
// Padding. The format is padding-heavy at ppi_sota: node ids are scattered,
// so every row-block touches every column block and only ~0.16% of the tile
// entries are non-zero. The kernel multiplies the zeros all the same; a
// denser layout (reordering nodes by cluster) is a later change's lever.
//
// C interface (loaded with ctypes): pointers and the stream are void*,
// ints are int. The kernel launches on `stream`, allocates nothing, does
// not synchronise, and the entry point returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTileM = 64;     // output rows per thread block (within one row-block)
constexpr int kTileN = 64;     // output features per thread block
constexpr int kChunk = 16;     // contraction depth staged per shared-memory round
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
block_ell_spmm_kernel(const T* __restrict__ blocks, const int* __restrict__ block_cols,
                      const int* __restrict__ row_k, const T* __restrict__ x,
                      T* __restrict__ y, int K, int B, int F, int row_tiles) {
  // a_s is A's chunk transposed (contraction index first); the +4 pad keeps
  // float4 alignment and spreads the transposing stores over more banks.
  __shared__ __align__(16) float a_s[kChunk][kTileM + 4];
  __shared__ __align__(16) float x_s[kChunk][kTileN];

  const int i = blockIdx.x / row_tiles;                    // row-block
  const int r0 = (blockIdx.x - i * row_tiles) * kTileM;    // first row within it
  const int f0 = blockIdx.y * kTileN;                      // first feature
  const int t = threadIdx.x;
  const int tx = t % 16;
  const int ty = t / 16;

  int live = K;
  if (row_k != nullptr) live = min(max(row_k[i], 0), K);

  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.0f;

  const long long tile = static_cast<long long>(B) * B;
  for (int k = 0; k < live; ++k) {
    const long long slot = static_cast<long long>(i) * K + k;
    const T* a_tile = blocks + slot * tile;
    const T* x_tile = x + static_cast<long long>(block_cols[slot]) * B * F;
    for (int k0 = 0; k0 < B; k0 += kChunk) {
      for (int e = t; e < kTileM * kChunk; e += kThreads) {
        const int m = e / kChunk, kk = e % kChunk;   // 16 neighbours read one row
        const int r = r0 + m, c = k0 + kk;
        a_s[kk][m] = (r < B && c < B)
                         ? to_float(a_tile[static_cast<long long>(r) * B + c]) : 0.0f;
      }
      for (int e = t; e < kChunk * kTileN; e += kThreads) {
        const int kk = e / kTileN, n = e % kTileN;   // coalesced along features
        const int r = k0 + kk, f = f0 + n;
        x_s[kk][n] = (r < B && f < F)
                         ? to_float(x_tile[static_cast<long long>(r) * F + f]) : 0.0f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kChunk; ++kk) {
        const float4 av = *reinterpret_cast<const float4*>(&a_s[kk][ty * 4]);
        const float4 xv = *reinterpret_cast<const float4*>(&x_s[kk][tx * 4]);
        const float ar[4] = {av.x, av.y, av.z, av.w};
        const float xr[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(ar[a], xr[b], acc[a][b]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = r0 + ty * 4 + a;
    if (r >= B) continue;
    T* out = y + (static_cast<long long>(i) * B + r) * F;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int f = f0 + tx * 4 + b;
      if (f < F) store(out + f, acc[a][b]);
    }
  }
}

template <typename T>
int launch(const void* blocks, const void* block_cols, const void* row_k,
           const void* x, void* y, int nrb, int K, int B, int F, void* stream) {
  const int row_tiles = (B + kTileM - 1) / kTileM;
  const dim3 grid(static_cast<unsigned>(nrb) * row_tiles,
                  static_cast<unsigned>((F + kTileN - 1) / kTileN));
  block_ell_spmm_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(blocks), static_cast<const int*>(block_cols),
      static_cast<const int*>(row_k), static_cast<const T*>(x), static_cast<T*>(y),
      K, B, F, row_tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// y (nrb*B, F) = block-ELL(blocks (nrb, K, B, B), block_cols (nrb, K) int32) . x (ncb*B, F).
// row_k: (nrb,) int32 live-slot counts, or NULL for "all K slots".
int block_ell_spmm_f32(const void* blocks, const void* block_cols, const void* row_k,
                       const void* x, void* y, int nrb, int K, int B, int F, void* stream) {
  return launch<float>(blocks, block_cols, row_k, x, y, nrb, K, B, F, stream);
}

int block_ell_spmm_bf16(const void* blocks, const void* block_cols, const void* row_k,
                        const void* x, void* y, int nrb, int K, int B, int F, void* stream) {
  return launch<__nv_bfloat16>(blocks, block_cols, row_k, x, y, nrb, K, B, F, stream);
}

const char* block_ell_spmm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
