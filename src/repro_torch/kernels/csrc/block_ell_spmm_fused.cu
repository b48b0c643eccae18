// Fused block-ELL product y = A . (X W + 1 b^T) on Hopper (sm_90a), CUDA cores.
//
// Replaces the Pallas TPU kernel `_spmm_fused_kernel` of
// src/repro/kernels/block_spmm.py (via `spmm_fused_block_ell`). For every
// live slot k < row_k[i] of row-block i, with c = block_cols[i, k]:
//
//   xw  = X[c*B : (c+1)*B, :] . W            (fp32 accumulation)
//   xw  = round_to_T(xw + b)                 (fp32 bias, then x's dtype)
//   acc += A[i, k] . xw                      (fp32 accumulation)
//
// and y[i*B : (i+1)*B] = acc in x's dtype. The rounding of xw to the operand
// type between the two products is the reference's contract (`:287`): it
// makes the fused product equal to the unfused matmul-then-spmm under bf16.
//
// Design. On the TPU the K slots are a sequential grid axis carrying the sum
// in VMEM, and W sits resident in VMEM. On a GPU blocks run in no order, so a
// thread block owns one output tile (128 rows of row-block i x 64 features)
// and walks the live slots itself. Per slot it
//   1. computes the slot's whole (B x 64) XW tile: X's column-block rows and
//      a 16-deep panel of W are staged through static shared memory (D is
//      consumed in chunks of 16, so any width fits), 8 x 4 outputs per thread
//      in fp32 registers; the bias is added, the tile is rounded to x's dtype
//      and kept in dynamic shared memory (B x 64 fp32, 32 KB at B = 128);
//   2. multiplies the A tile into it: A is staged 16 columns at a time and
//      the 8 x 4 fp32 accumulators of each thread grow.
// B above 128 runs several 128-row output tiles per row-block (each computes
// the full XW tile); the wrapper caps B at 512 (128 KB of XW tile).
//
// What bounds it. At the ppi_sota hidden layer (nrb 3, K 3, B 128,
// D = F = 2048, fp32) the function needs 2*384*2048*2048 FLOP for XW plus
// 2*128*128*2048 per live slot: about 3.8e9 FLOP, 0.057 ms at the H100 SXM's
// 67 TFLOP/s fp32 peak (TF32 off by contract); its bytes (x, W, tiles, y,
// ~24 MB) take 0.007 ms, so it is operations-bound. As on the TPU, this
// kernel recomputes XW for every live slot of every row-block (about 1.0e10
// FLOP at that shape, 2.6x the function's), on CUDA cores only: tensor cores,
// TMA, and computing each column-block's XW once are later changes' levers.
//
// C interface (loaded with ctypes): pointers and the stream are void*, ints
// are int. The kernel launches on `stream`, allocates nothing, does not
// synchronise, and the entry point returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 128;     // output rows per thread block (within one row-block)
constexpr int kTileN = 64;     // output features per thread block
constexpr int kChunk = 16;     // contraction depth staged per shared-memory round
constexpr int kThreads = 256;  // 16 x 16 threads, 8 x 4 outputs each
constexpr int kStagePad = 4;   // keeps float4 alignment of the staged rows
constexpr int kStaticSmem =
    (kChunk * (kRows + kStagePad) + kChunk * kTileN) * static_cast<int>(sizeof(float));

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
// v rounded to T and widened back (what the unfused path's cast does)
__device__ __forceinline__ float round_to(float v, const float*) { return v; }
__device__ __forceinline__ float round_to(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
block_ell_spmm_fused_kernel(const T* __restrict__ blocks, const int* __restrict__ block_cols,
                            const int* __restrict__ row_k, const T* __restrict__ x,
                            const T* __restrict__ w, const float* __restrict__ bias,
                            T* __restrict__ y, int K, int B, int D, int F, int row_tiles) {
  // stage[kk][m]: X's (rows x 16) chunk in phase 1 and A's in phase 2, both
  // transposed so a thread reads its 8 rows as two float4.
  __shared__ __align__(16) float stage[kChunk][kRows + kStagePad];
  __shared__ __align__(16) float w_s[kChunk][kTileN];
  extern __shared__ __align__(16) float xw_s[];            // [b_pad][kTileN]

  const int i = blockIdx.x / row_tiles;                    // row-block
  const int r0 = (blockIdx.x - i * row_tiles) * kRows;     // first output row
  const int f0 = blockIdx.y * kTileN;                      // first feature
  const int t = threadIdx.x;
  const int tx = t % 16;
  const int ty = t / 16;
  const int b_pad = (B + kChunk - 1) / kChunk * kChunk;

  int live = K;
  if (row_k != nullptr) live = min(max(row_k[i], 0), K);

  float acc[8][4];
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.0f;

  const long long tile = static_cast<long long>(B) * B;
  for (int k = 0; k < live; ++k) {
    const long long slot = static_cast<long long>(i) * K + k;
    const T* xc = x + static_cast<long long>(block_cols[slot]) * B * D;

    // ---- phase 1: the slot's XW tile, rows [0, B) x features [f0, f0+64)
    for (int rb0 = 0; rb0 < B; rb0 += kRows) {
      float xa[8][4];
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) xa[a][b] = 0.0f;
      for (int d0 = 0; d0 < D; d0 += kChunk) {
        for (int e = t; e < kRows * kChunk; e += kThreads) {
          const int m = e / kChunk, kk = e % kChunk;   // 16 neighbours read one row
          const int r = rb0 + m, d = d0 + kk;
          stage[kk][m] = (r < B && d < D)
                             ? to_float(xc[static_cast<long long>(r) * D + d]) : 0.0f;
        }
        for (int e = t; e < kChunk * kTileN; e += kThreads) {
          const int kk = e / kTileN, n = e % kTileN;   // coalesced along features
          const int d = d0 + kk, f = f0 + n;
          w_s[kk][n] = (d < D && f < F)
                           ? to_float(w[static_cast<long long>(d) * F + f]) : 0.0f;
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < kChunk; ++kk) {
          const float4 a0 = *reinterpret_cast<const float4*>(&stage[kk][ty * 8]);
          const float4 a1 = *reinterpret_cast<const float4*>(&stage[kk][ty * 8 + 4]);
          const float4 wv = *reinterpret_cast<const float4*>(&w_s[kk][tx * 4]);
          const float ar[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
          const float wr[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
          for (int a = 0; a < 8; ++a)
#pragma unroll
            for (int b = 0; b < 4; ++b) xa[a][b] = fmaf(ar[a], wr[b], xa[a][b]);
        }
        __syncthreads();
      }
      // + bias in fp32, rounded to x's dtype; rows in [B, b_pad) are zero
#pragma unroll
      for (int a = 0; a < 8; ++a) {
        const int r = rb0 + ty * 8 + a;
        if (r >= b_pad) continue;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int f = f0 + tx * 4 + b;
          const float bv = (bias != nullptr && f < F) ? bias[f] : 0.0f;
          xw_s[r * kTileN + tx * 4 + b] =
              (r < B) ? round_to(xa[a][b] + bv, x) : 0.0f;
        }
      }
    }
    __syncthreads();

    // ---- phase 2: acc += A[i, k][r0 : r0+128, :] . XW
    const T* a_tile = blocks + slot * tile;
    for (int c0 = 0; c0 < B; c0 += kChunk) {
      for (int e = t; e < kRows * kChunk; e += kThreads) {
        const int m = e / kChunk, kk = e % kChunk;
        const int r = r0 + m, c = c0 + kk;
        stage[kk][m] = (r < B && c < B)
                           ? to_float(a_tile[static_cast<long long>(r) * B + c]) : 0.0f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kChunk; ++kk) {    // c0 + kk < b_pad always
        const float4 a0 = *reinterpret_cast<const float4*>(&stage[kk][ty * 8]);
        const float4 a1 = *reinterpret_cast<const float4*>(&stage[kk][ty * 8 + 4]);
        const float4 xv =
            *reinterpret_cast<const float4*>(&xw_s[(c0 + kk) * kTileN + tx * 4]);
        const float ar[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float xr[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int a = 0; a < 8; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(ar[a], xr[b], acc[a][b]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const int r = r0 + ty * 8 + a;
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
int launch(const void* blocks, const void* block_cols, const void* row_k, const void* x,
           const void* w, const void* bias, void* y, int nrb, int K, int B, int D, int F,
           void* stream) {
  const int row_tiles = (B + kRows - 1) / kRows;
  const int b_pad = (B + kChunk - 1) / kChunk * kChunk;
  const size_t dyn = static_cast<size_t>(b_pad) * kTileN * sizeof(float);
  if (dyn + kStaticSmem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        block_ell_spmm_fused_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(dyn));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(static_cast<unsigned>(nrb) * row_tiles,
                  static_cast<unsigned>((F + kTileN - 1) / kTileN));
  block_ell_spmm_fused_kernel<T><<<grid, kThreads, dyn, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(blocks), static_cast<const int*>(block_cols),
      static_cast<const int*>(row_k), static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const float*>(bias), static_cast<T*>(y), K, B, D, F, row_tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// y (nrb*B, F) = block-ELL(blocks (nrb, K, B, B), block_cols (nrb, K) int32)
//                . (x (ncb*B, D) . w (D, F) + bias (F,) fp32).
// row_k: (nrb,) int32 live-slot counts, or NULL for "all K slots";
// bias: NULL for none. blocks, x, w and y share the element type.
int block_ell_spmm_fused_f32(const void* blocks, const void* block_cols, const void* row_k,
                             const void* x, const void* w, const void* bias, void* y,
                             int nrb, int K, int B, int D, int F, void* stream) {
  return launch<float>(blocks, block_cols, row_k, x, w, bias, y, nrb, K, B, D, F, stream);
}

int block_ell_spmm_fused_bf16(const void* blocks, const void* block_cols, const void* row_k,
                              const void* x, const void* w, const void* bias, void* y,
                              int nrb, int K, int B, int D, int F, void* stream) {
  return launch<__nv_bfloat16>(blocks, block_cols, row_k, x, w, bias, y, nrb, K, B, D, F,
                               stream);
}

const char* block_ell_spmm_fused_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
