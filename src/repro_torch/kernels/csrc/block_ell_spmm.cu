// Block-ELL sparse x dense product y = A . X on Hopper (sm_90a), CUDA cores.
//
// Replaces the two Pallas TPU kernels of src/repro/kernels/block_spmm.py:
// `_spmm_kernel` (all K slots) and `_spmm_kernel_rowk` (the K loop stops at
// row_k[i]; exact, because slots past it hold all-zero tiles). One kernel
// does both: `row_k == nullptr` means every row-block runs all K slots.
//
//   y[i*B + r, f] = sum_{k < row_k[i]} sum_c blocks[i, k, r, c] * x[block_cols[i, k]*B + c, f]
//
// Design (block_tile.cuh). On the TPU, K is a sequential grid axis that
// carries the sum in VMEM scratch. Here a CTA owns a 128-row x 128 (or 64)
// feature output tile of row-block i and walks its share of the slot loop:
// each slot's tile, read row-major as stored, is the A operand and x's rows
// block_cols[i, k]*B ... are the B operand, 16 contraction entries per chunk,
// through a 4-stage cp.async ring into an 8 x 16 fp32 register tile per
// thread. The slot loop is split over blockIdx.z so that the ppi_sota shapes
// launch at least 132 CTAs (48 output tiles at the serving and training
// shapes); the fp32 partials are then summed in a fixed order by a second
// kernel, so repeated calls are bitwise equal. The wrapper chooses the
// tile width, the split count and the copy width (16-byte cp.async, 4-byte
// cp.async, or synchronous loads for bf16 rows that are not 4-byte aligned)
// and provides the split workspace; the launcher re-checks them.
//
// What bounds it. At the serving shape of ppi_sota (nrb 3, K 110 slots, B 128,
// F 2048, fp32) the function is 2 * 330 * 128 * 128 * 2048 = 2.2e10 FLOP on
// the fp32 CUDA cores (TF32 is off by contract): 0.33 ms at 67 TFLOP/s, while
// its bytes (tiles 21.6 MB, x 115 MB read once) take less. It is
// operations-bound; each slot re-reads its x rows (1 MiB), mostly from L2.
// The format is padding-heavy (about 0.2% of tile entries are non-zero);
// the kernel multiplies the zeros all the same.
//
// C interface (loaded with ctypes): pointers and the stream are void*,
// ints are int. The kernels launch on `stream`, allocate nothing, do not
// synchronise, and the entry point returns a cudaError_t (0 on success).

#include "block_tile.cuh"

extern "C" {

// y (nrb*B, F) = block-ELL(blocks (nrb, K, B, B), block_cols (nrb, K) int32) . x (ncb*B, F).
// row_k: (nrb,) int32 live-slot counts, or NULL for "all K slots".
// partials: (splits, nrb*B, F) fp32 workspace, NULL when splits == 1.
// tile_n: 128 or 64; splits: ranges of the slot loop, 1 .. K*ceil(B/16);
// copy_bytes: 16, 4, or 0 (bf16 only) — see block_tile.cuh.
int block_ell_spmm_f32(const void* blocks, const void* block_cols, const void* row_k,
                       const void* x, void* y, void* partials, int nrb, int K, int B,
                       int F, int tile_n, int splits, int copy_bytes, void* stream) {
  return static_cast<int>(block_tile::launch_spmm<float>(
      static_cast<const float*>(blocks), static_cast<const int*>(block_cols),
      static_cast<const int*>(row_k), static_cast<const float*>(x), static_cast<float*>(y),
      static_cast<float*>(partials), nrb, K, B, F, tile_n, splits, copy_bytes,
      static_cast<cudaStream_t>(stream)));
}

int block_ell_spmm_bf16(const void* blocks, const void* block_cols, const void* row_k,
                        const void* x, void* y, void* partials, int nrb, int K, int B,
                        int F, int tile_n, int splits, int copy_bytes, void* stream) {
  return static_cast<int>(block_tile::launch_spmm<__nv_bfloat16>(
      static_cast<const __nv_bfloat16*>(blocks), static_cast<const int*>(block_cols),
      static_cast<const int*>(row_k), static_cast<const __nv_bfloat16*>(x),
      static_cast<__nv_bfloat16*>(y), static_cast<float*>(partials), nrb, K, B, F, tile_n,
      splits, copy_bytes, static_cast<cudaStream_t>(stream)));
}

const char* block_ell_spmm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
