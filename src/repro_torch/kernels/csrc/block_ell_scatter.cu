// The block-ELL tiles of a batch's adjacency, written on the card from its
// nonzeros: tiles[offsets[i]] = tiles_t[offsets_t[i]] = values[i].
//
// Replaces no TPU kernel. The reference builds Â's and Âᵀ's tiles on the
// host (src/repro/kernels/ops.py `block_ell_adj_from_csr`) and the TPU reads
// them from there; a training batch's tiles are about 0.1-1% nonzero, so
// building them on the host and copying them over the bus moved some 95%
// zeros. The host now ships each nonzero once with its flat offset into
// either tile array (kernels/block_spmm.py `BlockEllCoords`), the wrapper
// zeroes both arrays with torch, and this kernel puts the values in place.
//
// What bounds it: memory. Each nonzero reads 12 bytes and writes two
// scattered 4-byte words (two 32-byte sectors), so a reddit batch (15,200
// nonzeros) moves about 1.2 MB: well under a microsecond of bandwidth, so
// the launch itself sets its time. Design: one thread per nonzero, a
// grid-stride loop past the grid's cap; offsets are distinct within each
// array, so the stores never collide and no order matters.
//
// C interface (loaded with ctypes): pointers and the stream are void*,
// ints are int. The kernel launches on `stream`, allocates nothing, does
// not synchronise, and the entry point returns a cudaError_t (0 on success).

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 65535;

__global__ void __launch_bounds__(kThreads)
    block_ell_scatter(const float* __restrict__ values, const int* __restrict__ offsets,
                      const int* __restrict__ offsets_t, int nnz, float* __restrict__ tiles,
                      float* __restrict__ tiles_t) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; i < nnz;
       i += stride) {
    const float v = values[i];
    tiles[offsets[i]] = v;
    tiles_t[offsets_t[i]] = v;
  }
}

}  // namespace

extern "C" {

// values (nnz,) fp32; offsets, offsets_t (nnz,) int32, each in range of its
// tile array and distinct within it; tiles, tiles_t zeroed fp32 arrays.
int block_ell_scatter_f32(const void* values, const void* offsets, const void* offsets_t,
                          int nnz, void* tiles, void* tiles_t, void* stream) {
  if (nnz < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (nnz == 0) return 0;
  const int blocks = std::min(nnz / kThreads + (nnz % kThreads != 0), kMaxBlocks);
  block_ell_scatter<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(values), static_cast<const int*>(offsets),
      static_cast<const int*>(offsets_t), nnz, static_cast<float*>(tiles),
      static_cast<float*>(tiles_t));
  return static_cast<int>(cudaGetLastError());
}

const char* block_ell_scatter_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
