// Fused block-ELL product y = A . (X W + 1 b^T) on Hopper (sm_90a), CUDA cores.
//
// Replaces the Pallas TPU kernel `_spmm_fused_kernel` of
// src/repro/kernels/block_spmm.py (via `spmm_fused_block_ell`):
//
//   xw  = round_to_T(X . W + b)     (fp32 accumulation, fp32 bias, then x's dtype)
//   y   = A . xw                    (block-ELL, row_k skip, fp32 accumulation)
//
// The rounding of xw to the operand type between the two products is the
// reference's contract (`:287`): it makes the fused product equal to the
// unfused matmul-then-spmm under bf16.
//
// Design (block_tile.cuh). The TPU kernel keeps W resident in VMEM and
// recomputes each live slot's XW tile inside the slot loop. Here each row of
// XW is computed once, in two stages launched back to back on the caller's
// stream from one entry point:
//   (a) a GEMM on the shared tile mainloop over every row of x: 128 x 128 (or
//       64) output tiles, D in chunks of 16 through the cp.async ring, D split
//       over blockIdx.z so that the ppi_sota layers launch at least 132 CTAs.
//       With one split its epilogue adds the fp32 bias to the complete fp32
//       sum and rounds to x's dtype; with several, the fixed-order reduction
//       of the fp32 partials does (bias added after the last partial). The
//       result goes to `xw`, a scratch of x's dtype (384 x 2048 x 4 B = 3 MB
//       at the hidden layer, inside the 50 MB L2);
//   (b) the block-ELL SpMM of block_tile.cuh over that scratch.
// The wrapper plans both stages (tile width, splits, copy width) and
// provides `xw` and the fp32 partials (one buffer, reused by both stages).
//
// What bounds it. At the ppi_sota hidden layer (nrb 3, K 3, B 128,
// D = F = 2048, fp32) the function needs 2*384*2048*2048 FLOP for XW plus
// 2*128*128*2048 per live slot: 3.8e9 FLOP, 0.057 ms at the H100 SXM's
// 67 TFLOP/s fp32 peak (TF32 off by contract); its bytes (x, W, tiles, y,
// ~24 MB) take 0.007 ms, so it is operations-bound. This design does exactly
// the function's FLOP (the previous kernel, like the TPU's, did 2.7x).
//
// C interface (loaded with ctypes): pointers and the stream are void*, ints
// are int. The kernels launch on `stream`, allocate nothing, do not
// synchronise, and the entry point returns a cudaError_t (0 on success).

#include "block_tile.cuh"

namespace block_tile {
namespace {   // the header's unnamed namespace, reopened: internal linkage

template <typename T>
struct XwArgs {
  const T* x;          // (M, D)
  const T* w;          // (D, N)
  const float* bias;   // (N,) or null; added here only with one split
  T* out;              // (M, N), written when partials is null
  float* partials;     // (splits, M, N) fp32, or null for one split
  int M, D, N;
  int per_split;       // chunks of D per split
  int out_vec;
  long long split_elems;   // M * N
};

template <typename T, int BN, int MODE>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
xw_kernel(const XwArgs<T> p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int m0 = blockIdx.x * kTileM;
  const int n0 = blockIdx.y * BN;
  const int s = blockIdx.z;
  const int chunks = (p.D + kChunk - 1) / kChunk;
  const int t0 = s * p.per_split;
  const int n = max(0, min(t0 + p.per_split, chunks) - t0);
  const int rows = min(kTileM, p.M - m0);
  const int cols = min(BN, p.N - n0);

  auto chunk_of = [&](int t) {
    const int d0 = t * kChunk;
    Chunk<T> c;
    c.a = p.x + static_cast<long long>(m0) * p.D + d0;
    c.a_pitch = p.D;
    c.a_rows = rows;
    c.depth = min(kChunk, p.D - d0);
    c.b = p.w + static_cast<long long>(d0) * p.N + n0;
    c.b_pitch = p.N;
    c.b_cols = cols;
    return c;
  };
  float acc[8][BN / 8];
  mainloop<T, BN, MODE>(chunk_of, t0, n, reinterpret_cast<T*>(smem_raw), acc);

  const long long at = static_cast<long long>(m0) * p.N + n0;
  if (p.partials == nullptr)
    store_tile<T, BN>(acc, p.out + at, p.N, rows, cols,
                      p.bias != nullptr ? p.bias + n0 : nullptr, p.out_vec);
  else
    store_tile<float, BN>(acc, p.partials + s * p.split_elems + at, p.N, rows, cols,
                          nullptr, p.out_vec);
}

// xw (M, N) = round_to_T(x (M, D) . w (D, N) + bias)
template <typename T>
cudaError_t launch_xw(const T* x, const T* w, const float* bias, T* xw, float* partials,
                      int M, int D, int N, int tile_n, int splits, int copy,
                      cudaStream_t stream) {
  if (M < 1 || D < 0 || N < 1) return cudaErrorInvalidValue;
  const int chunks = ceil_div(D, kChunk);
  if (splits < 1 || splits > (chunks > 1 ? chunks : 1) || splits > 65535 ||
      (splits > 1 && partials == nullptr))
    return cudaErrorInvalidValue;
  if (!copy_mode_fits<T>(copy, {D, N}, {x, w})) return cudaErrorInvalidValue;
  const long long m_tiles = ceil_div(M, kTileM);
  const long long n_tiles = ceil_div(N, tile_n > 0 ? tile_n : 1);
  if (m_tiles >= (1LL << 31) || n_tiles > 65535) return cudaErrorInvalidValue;

  XwArgs<T> a;
  a.x = x; a.w = w; a.bias = bias; a.out = xw;
  a.partials = splits > 1 ? partials : nullptr;
  a.M = M; a.D = D; a.N = N;
  a.per_split = chunks > 0 ? ceil_div(chunks, splits) : 0;
  a.split_elems = static_cast<long long>(M) * N;
  a.out_vec = N % 4 == 0 && aligned(xw, 16) && aligned(a.partials, 16);
  const dim3 grid(static_cast<unsigned>(m_tiles), static_cast<unsigned>(n_tiles),
                  static_cast<unsigned>(splits));
  const cudaError_t err = dispatch<T>(tile_n, copy, [&](auto bn, auto mode) {
    constexpr int kBN = decltype(bn)::value;
    constexpr int kMode = decltype(mode)::value;
    constexpr int kSmem = smem_bytes<T, kBN>();
    static std::atomic<unsigned> done{0};
    const cudaError_t e = allow_smem(xw_kernel<T, kBN, kMode>, kSmem, done);
    if (e != cudaSuccess) return e;
    xw_kernel<T, kBN, kMode><<<grid, kThreads, kSmem, stream>>>(a);
    return cudaGetLastError();
  });
  if (err != cudaSuccess || splits == 1) return err;
  return launch_reduce<T>(partials, splits, M, N, bias, xw, stream);
}

template <typename T>
int launch(const void* blocks, const void* block_cols, const void* row_k, const void* x,
           const void* w, const void* bias, void* y, void* xw, void* partials, int nrb,
           int K, int B, int M, int D, int F, int xw_tile_n, int xw_splits, int xw_copy,
           int spmm_tile_n, int spmm_splits, int spmm_copy, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || M % B != 0 || xw == nullptr) return cudaErrorInvalidValue;
  cudaError_t err = launch_xw<T>(static_cast<const T*>(x), static_cast<const T*>(w),
                                 static_cast<const float*>(bias), static_cast<T*>(xw),
                                 static_cast<float*>(partials), M, D, F, xw_tile_n,
                                 xw_splits, xw_copy, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch_spmm<T>(static_cast<const T*>(blocks), static_cast<const int*>(block_cols),
                       static_cast<const int*>(row_k), static_cast<const T*>(xw),
                       static_cast<T*>(y), static_cast<float*>(partials), nrb, K, B, F,
                       spmm_tile_n, spmm_splits, spmm_copy, st);
  return static_cast<int>(err);
}

}  // namespace
}  // namespace block_tile

extern "C" {

// y (nrb*B, F) = block-ELL(blocks (nrb, K, B, B), block_cols (nrb, K) int32)
//                . (x (M = ncb*B, D) . w (D, F) + bias (F,) fp32).
// row_k: (nrb,) int32 live-slot counts, or NULL for "all K slots"; bias: NULL
// for none. blocks, x, w, y and the scratch xw (M, F) share the element type.
// partials: fp32 workspace of max(xw_splits * M, spmm_splits * nrb*B) * F
// elements, NULL when no stage splits.
// xw_* plan stage (a), spmm_* stage (b): tile width 128 or 64, splits,
// copy width 16, 4 or 0 (bf16 only).
int block_ell_spmm_fused_f32(const void* blocks, const void* block_cols, const void* row_k,
                             const void* x, const void* w, const void* bias, void* y,
                             void* xw, void* partials, int nrb, int K, int B, int M, int D,
                             int F, int xw_tile_n, int xw_splits, int xw_copy,
                             int spmm_tile_n, int spmm_splits, int spmm_copy, void* stream) {
  return block_tile::launch<float>(blocks, block_cols, row_k, x, w, bias, y, xw, partials,
                                   nrb, K, B, M, D, F, xw_tile_n, xw_splits, xw_copy,
                                   spmm_tile_n, spmm_splits, spmm_copy, stream);
}

int block_ell_spmm_fused_bf16(const void* blocks, const void* block_cols, const void* row_k,
                              const void* x, const void* w, const void* bias, void* y,
                              void* xw, void* partials, int nrb, int K, int B, int M, int D,
                              int F, int xw_tile_n, int xw_splits, int xw_copy,
                              int spmm_tile_n, int spmm_splits, int spmm_copy,
                              void* stream) {
  return block_tile::launch<__nv_bfloat16>(blocks, block_cols, row_k, x, w, bias, y, xw,
                                           partials, nrb, K, B, M, D, F, xw_tile_n,
                                           xw_splits, xw_copy, spmm_tile_n, spmm_splits,
                                           spmm_copy, stream);
}

const char* block_ell_spmm_fused_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
