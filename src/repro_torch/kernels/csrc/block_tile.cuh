// The fp32 tile mainloop shared by the block-ELL kernels (sm_90a, CUDA cores),
// and the block-ELL SpMM built on it.
//
// One CTA of 128 threads (16 row groups x 8 column groups) owns a 128 x BN
// output tile (BN = 128, or 64 where the tile count calls for it) and keeps
// an 8 x (BN / 8) fp32 accumulator per thread: 8 x 16 at BN = 128. The
// contraction comes in chunks of kChunk = 16, each an A block (128 rows x 16,
// row-major, the contraction index last: A is read in the layout it is
// stored in) and a B block (16 rows x BN). A caller describes chunk t by a
// `Chunk` (pointers, pitches, how many rows and columns exist; the rest
// reads as zero).
//
// Pipeline. The chunks go through a ring of kStages = 4 stages in dynamic
// shared memory, filled by asynchronous copies (`cp.async`): chunks n + 1 ..
// n + 3 are in flight while chunk n is multiplied, and there is one
// __syncthreads() per chunk. Two CTAs share an SM.
//
// Reading. Per 4-deep step a thread reads its 8 A rows as one 16-byte vector
// each along the contraction and 4 B vectors per k: 24 shared loads for 512
// FMAs. A rows are padded by 16 bytes, so the 4 consecutive rows a warp reads
// start in distinct 4-bank groups; a warp's B load is 128 contiguous bytes.
//
// What paces it. On an H100 the mainloop runs at a little under 60% of the
// 67 TFLOP/s fp32 peak. A 256-thread 8 x 8 tile, a warp layout with fewer
// shared-memory wavefronts, one or two CTAs per SM and 3 or 4 stages all ran
// within a few percent of that; what stalls it is not visible without a
// profiler of the SM's stall reasons.
//
// Copies. The caller picks one copy mode per launch from the operands'
// widths and base alignment (the Python wrapper decides, the launcher
// re-checks and refuses a mode the operands do not allow):
//   16: cp.async.cg of 16 bytes (widths and bases multiples of 16 bytes);
//    4: cp.async.ca of 4 bytes (fp32 of any width; bf16 of even widths);
//    0: synchronous element loads (bf16 rows that are not 4-byte aligned).
// Out-of-range entries are zero-filled (cp.async's src-size 0).
//
// Types. bf16 operands stay bf16 in shared memory and are widened to fp32 in
// registers; a bf16 x bf16 product is exact in fp32, accumulation is fp32,
// and the output is rounded once to the output type (x's dtype).
//
// Splits. A launch splits the contraction into `splits` ranges of chunks
// (blockIdx.z), so that small outputs still fill the 132 SMs. With one split
// the tile is written in its final type; otherwise each split writes fp32
// partials and `reduce_splits` sums them in the fixed order 0, 1, ...,
// splits - 1 (no atomics: the same inputs give bitwise the same output).
// A split that owns no chunk writes zeros. Two alternatives were measured
// slower on an H100 at every ppi_sota shape and are not used: summing a
// tile's splits in a thread-block cluster through distributed shared
// memory, and letting the last split of a tile (an integer counter) sum the
// others' partials; both put the reduction on the tail of the tile's CTAs,
// where one CTA's dependent L2 or DSMEM reads are slow, instead of spreading
// it over the whole card.
//
// Everything here launches on the caller's stream, allocates nothing and
// does not synchronise; the launchers return a cudaError_t.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <initializer_list>
#include <type_traits>

namespace block_tile {
// Everything here has internal linkage: each kernel library compiles its own
// copy, so two libraries loaded into one process never share a host stub.
namespace {

constexpr int kThreads = 128;   // 16 row groups x 8 column groups
constexpr int kTileM = 128;     // output rows per CTA
constexpr int kChunk = 16;      // contraction depth per stage
constexpr int kStages = 4;      // depth of the shared-memory ring
constexpr int kMinBlocks = 2;   // CTAs per SM (launch bounds: up to 255 registers)

template <typename T>
__host__ __device__ constexpr int pitch_a() { return kChunk + 16 / static_cast<int>(sizeof(T)); }

template <typename T, int BN>
__host__ __device__ constexpr int stage_elems() { return kTileM * pitch_a<T>() + kChunk * BN; }

template <typename T, int BN>
__host__ __device__ constexpr int smem_bytes() {
  return kStages * stage_elems<T, BN>() * static_cast<int>(sizeof(T));
}

// ---------------------------------------------------------------- helpers
__device__ __forceinline__ void store_one(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_one(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// four consecutive elements (16- or 8-byte aligned), widened to fp32
__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* v) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.y));
  v[0] = lo.x; v[1] = lo.y; v[2] = hi.x; v[3] = hi.y;
}

// four consecutive global elements, rounded to the output type
__device__ __forceinline__ void stg4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void stg4(__nv_bfloat16* p, const float* v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 q;
  q.x = *reinterpret_cast<const unsigned*>(&lo);
  q.y = *reinterpret_cast<const unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = q;
}

template <typename T>
__device__ __forceinline__ T zero_of();
template <>
__device__ __forceinline__ float zero_of<float>() { return 0.0f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() {
  return __float2bfloat16_rn(0.0f);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(ok ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(ok ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// ---------------------------------------------------------------- thread layout
// A thread's place (ty, tx) in the 16 x 8 grid: a warp is 4 row groups x 8
// column groups. Its accumulator row i is tile row ty + 16 i, its columns
// g * 32 + tx * 4 + {0..3}. So a warp's A loads hit 4 consecutive rows (at
// a pitch of 20 floats: four distinct 4-bank groups) and its B loads 128
// contiguous bytes of one row.
__device__ __forceinline__ int thread_ty() { return (threadIdx.x / 32) * 4 + threadIdx.x % 32 / 8; }
__device__ __forceinline__ int thread_tx() { return threadIdx.x % 8; }

// ---------------------------------------------------------------- mainloop
// Chunk t of a CTA's contraction: A[r, k] = a[r * a_pitch + k] for r < a_rows,
// k < depth; B[k, n] = b[k * b_pitch + n] for k < depth, n < b_cols.
template <typename T>
struct Chunk {
  const T* a;
  long long a_pitch;
  int a_rows;
  int depth;
  const T* b;
  long long b_pitch;
  int b_cols;
};

// Copy a ROWS x COLS block of src (row pitch `pitch`) into dst (row pitch DP);
// entries at row >= vrows or col >= vcols become zero.
template <typename T, int ROWS, int COLS, int DP, int MODE>
__device__ __forceinline__ void copy_block(T* dst, const T* src, long long pitch,
                                           int vrows, int vcols) {
  constexpr int kVec = MODE == 0 ? 1 : MODE / static_cast<int>(sizeof(T));
  constexpr int kPerRow = COLS / kVec;
  constexpr int kTotal = ROWS * kPerRow;
#pragma unroll
  for (int j = 0; j < (kTotal + kThreads - 1) / kThreads; ++j) {
    const int e = static_cast<int>(threadIdx.x) + j * kThreads;
    if (kTotal % kThreads != 0 && e >= kTotal) break;
    const int r = e / kPerRow;
    const int c = (e - r * kPerRow) * kVec;
    const bool ok = r < vrows && c < vcols;
    const T* s = ok ? src + r * pitch + c : src;   // a valid address either way
    T* d = dst + r * DP + c;
    if constexpr (MODE == 16) {
      cp_async16(d, s, ok);
    } else if constexpr (MODE == 4) {
      cp_async4(d, s, ok);
    } else {
      *d = ok ? *s : zero_of<T>();
    }
  }
}

// acc += A_s (128 x 16) . B_s (16 x BN) for this thread's 8 x (BN/8) outputs
template <typename T, int BN>
__device__ __forceinline__ void multiply_chunk(const T* as, const T* bs,
                                               float (&acc)[8][BN / 8]) {
  constexpr int kPA = pitch_a<T>();
  constexpr int kTN = BN / 8;
  const int tx = thread_tx();
  const int ty = thread_ty();
#pragma unroll
  for (int k4 = 0; k4 < kChunk; k4 += 4) {
    float a[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i) load4(as + (ty + 16 * i) * kPA + k4, a[i]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float b[kTN];
#pragma unroll
      for (int g = 0; g < kTN / 4; ++g)
        load4(bs + (k4 + kk) * BN + g * 32 + tx * 4, b + 4 * g);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int n = 0; n < kTN; ++n) acc[i][n] = fmaf(a[i][kk], b[n], acc[i][n]);
    }
  }
}

// acc = sum over chunks t0 .. t0 + n - 1 of chunk_of(t)'s A . B
template <typename T, int BN, int MODE, class ChunkOf>
__device__ __forceinline__ void mainloop(const ChunkOf& chunk_of, int t0, int n, T* smem,
                                         float (&acc)[8][BN / 8]) {
  constexpr int kPA = pitch_a<T>();
  constexpr int kStage = stage_elems<T, BN>();
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) acc[i][j] = 0.0f;

  auto issue = [&](int j) {       // chunk t0 + j into stage j % kStages
    if (j < n) {
      const Chunk<T> c = chunk_of(t0 + j);
      T* as = smem + (j % kStages) * kStage;
      copy_block<T, kTileM, kChunk, kPA, MODE>(as, c.a, c.a_pitch, c.a_rows, c.depth);
      copy_block<T, kChunk, BN, BN, MODE>(as + kTileM * kPA, c.b, c.b_pitch, c.depth,
                                          c.b_cols);
    }
    if constexpr (MODE != 0) cp_async_commit();   // one group per chunk, maybe empty
  };
#pragma unroll 1
  for (int j = 0; j < kStages - 1; ++j) issue(j);
#pragma unroll 1
  for (int j = 0; j < n; ++j) {
    if constexpr (MODE != 0) cp_async_wait<kStages - 2>();   // chunk j has landed
    // every thread's copies of chunk j are visible, and every thread is done
    // with chunk j - 1, whose stage the next issue refills
    __syncthreads();
    issue(j + kStages - 1);
    const T* as = smem + (j % kStages) * kStage;
    multiply_chunk<T, BN>(as, as + kTileM * kPA, acc);
  }
  if constexpr (MODE != 0) cp_async_wait<0>();
}

// Write this thread's part of a tile: out[r * pitch + c] = acc (+ bias[c]),
// rounded to TO, for r < rows and c < cols. vec: 4-wide stores allowed
// (pitch a multiple of 4 and out 16-byte aligned).
template <typename TO, int BN>
__device__ __forceinline__ void store_tile(const float (&acc)[8][BN / 8], TO* out,
                                           long long pitch, int rows, int cols,
                                           const float* bias, bool vec) {
  const int tx = thread_tx();
  const int ty = thread_ty();
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = ty + 16 * i;
    if (r >= rows) continue;
    TO* o = out + r * pitch;
#pragma unroll
    for (int g = 0; g < BN / 32; ++g) {
      const int c = g * 32 + tx * 4;
      float v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        v[q] = acc[i][4 * g + q] + ((bias != nullptr && c + q < cols) ? bias[c + q] : 0.0f);
      if (vec && c + 4 <= cols) {
        stg4(o + c, v);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (c + q < cols) store_one(o + c + q, v[q]);
      }
    }
  }
}

// out[r, c] = (part[0][r, c] + part[1][r, c] + ... + part[splits-1][r, c]) (+ bias[c]),
// summed in that order and rounded once to T. A thread owns kCols consecutive
// columns (4 with 16-byte loads and 4-wide stores, else 1) and walks the rows.
template <typename T, int kCols>
__global__ void __launch_bounds__(256)
reduce_splits(const float* __restrict__ part, int splits, long long split_elems, int rows,
              int n_cols, const float* __restrict__ bias, T* __restrict__ out) {
  const int c = kCols * static_cast<int>(blockIdx.x * blockDim.x + threadIdx.x);
  if (c >= n_cols) return;
  float b[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) b[j] = bias != nullptr ? bias[c + j] : 0.0f;
  for (int r = blockIdx.y; r < rows; r += gridDim.y) {
    const long long e = static_cast<long long>(r) * n_cols + c;
    float v[kCols];
    float q[kCols];
    if constexpr (kCols == 4) load4(part + e, v); else v[0] = part[e];
    for (int s = 1; s < splits; ++s) {
      const float* ps = part + s * split_elems + e;
      if constexpr (kCols == 4) load4(ps, q); else q[0] = *ps;
#pragma unroll
      for (int j = 0; j < kCols; ++j) v[j] += q[j];
    }
#pragma unroll
    for (int j = 0; j < kCols; ++j) v[j] += b[j];
    if constexpr (kCols == 4) stg4(out + e, v); else store_one(out + e, v[0]);
  }
}

// ---------------------------------------------------------------- launch helpers
inline bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % static_cast<uintptr_t>(bytes) == 0;
}

// May `mode` copy rows of these widths (elements) from these bases?
template <typename T>
bool copy_mode_fits(int mode, std::initializer_list<long long> widths,
                    std::initializer_list<const void*> bases) {
  if (mode == 0) return std::is_same<T, __nv_bfloat16>::value;  // fp32 never needs it
  if (mode != 4 && mode != 16) return false;
  for (long long w : widths)
    if ((w * static_cast<long long>(sizeof(T))) % mode != 0) return false;
  for (const void* p : bases)
    if (!aligned(p, mode)) return false;
  return true;
}

// Call f(BN, MODE) (as integral_constant) for a runtime tile width and copy mode.
template <typename T, class F>
cudaError_t dispatch(int tile_n, int mode, F&& f) {
  using I128 = std::integral_constant<int, 128>;
  using I64 = std::integral_constant<int, 64>;
  using C16 = std::integral_constant<int, 16>;
  using C4 = std::integral_constant<int, 4>;
  using C0 = std::integral_constant<int, 0>;
  if (tile_n != 128 && tile_n != 64) return cudaErrorInvalidValue;
  if (mode == 16) return tile_n == 128 ? f(I128{}, C16{}) : f(I64{}, C16{});
  if (mode == 4) return tile_n == 128 ? f(I128{}, C4{}) : f(I64{}, C4{});
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (mode == 0) return tile_n == 128 ? f(I128{}, C0{}) : f(I64{}, C0{});
  }
  return cudaErrorInvalidValue;
}

// Opt a kernel into `bytes` of dynamic shared memory, once per device (the
// attribute persists; `done` is the kernel's own bitmask of devices).
template <class Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, std::atomic<unsigned>& done) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned bit = dev < 32 ? 1u << dev : 0u;
  if (bit != 0 && (done.load(std::memory_order_relaxed) & bit) != 0) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) done.fetch_or(bit);
  return e;
}

// Sum `splits` fp32 partials of (rows, n_cols) into out (+ bias per column).
template <typename T>
cudaError_t launch_reduce(const float* part, int splits, int rows, int n_cols,
                          const float* bias, T* out, cudaStream_t stream) {
  const bool vec = n_cols % 4 == 0 && aligned(part, 16) && aligned(out, 4 * sizeof(T));
  const int threads = vec ? n_cols / 4 : n_cols;
  const dim3 grid((threads + 255) / 256, rows < 65535 ? rows : 65535);
  const long long split_elems = static_cast<long long>(rows) * n_cols;
  if (vec)
    reduce_splits<T, 4><<<grid, 256, 0, stream>>>(part, splits, split_elems, rows, n_cols,
                                                  bias, out);
  else
    reduce_splits<T, 1><<<grid, 256, 0, stream>>>(part, splits, split_elems, rows, n_cols,
                                                  bias, out);
  return cudaGetLastError();
}

inline int ceil_div(long long a, long long b) { return static_cast<int>((a + b - 1) / b); }

// ---------------------------------------------------------------- block-ELL SpMM
// y[i*B + r, f] = sum_{k < live(i)} sum_c blocks[i, k, r, c] * x[cols[i, k]*B + c, f]
// Chunk t of row-block i is slot k = t / ceil(B/16), columns c0 = (t % ..) * 16
// of its tile; A is the slot's tile (pitch B), B is x's rows cols[i, k]*B + c0...
template <typename T>
struct SpmmArgs {
  const T* blocks;
  const int* cols;
  const int* row_k;     // live slots per row-block, or null for all K
  const T* x;
  T* y;                 // written when partials is null
  float* partials;      // (splits, nrb*B, F) fp32, or null for one split
  int K, B, F;
  int row_tiles;        // ceil(B / 128)
  int chunks_per_slot;  // ceil(B / 16)
  int per_split;        // chunks per split
  int out_vec;
  long long split_elems;   // nrb * B * F
};

template <typename T, int BN, int MODE>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
spmm_kernel(const SpmmArgs<T> p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int mt = blockIdx.x;
  const int i = mt / p.row_tiles;
  const int r0 = (mt - i * p.row_tiles) * kTileM;
  const int n0 = blockIdx.y * BN;
  const int s = blockIdx.z;
  int live = p.K;
  if (p.row_k != nullptr) live = min(max(p.row_k[i], 0), p.K);
  const int t0 = s * p.per_split;
  const int n = max(0, min(t0 + p.per_split, live * p.chunks_per_slot) - t0);
  const int rows = min(kTileM, p.B - r0);
  const int cols = min(BN, p.F - n0);
  const long long tile = static_cast<long long>(p.B) * p.B;
  // per-CTA bases, so that a chunk costs one index load and a few adds
  const T* a_base = p.blocks + static_cast<long long>(i) * p.K * tile +
                    static_cast<long long>(r0) * p.B;
  const int* slot_cols = p.cols + static_cast<long long>(i) * p.K;
  const T* b_base = p.x + n0;
  const long long col_block = static_cast<long long>(p.B) * p.F;

  auto chunk_of = [&](int t) {
    const int k = t / p.chunks_per_slot;
    const int c0 = (t - k * p.chunks_per_slot) * kChunk;
    Chunk<T> c;
    c.a = a_base + k * tile + c0;
    c.a_pitch = p.B;
    c.a_rows = rows;
    c.depth = min(kChunk, p.B - c0);
    c.b = b_base + slot_cols[k] * col_block + static_cast<long long>(c0) * p.F;
    c.b_pitch = p.F;
    c.b_cols = cols;
    return c;
  };
  float acc[8][BN / 8];
  mainloop<T, BN, MODE>(chunk_of, t0, n, reinterpret_cast<T*>(smem_raw), acc);

  const long long at = (static_cast<long long>(i) * p.B + r0) * p.F + n0;
  if (p.partials == nullptr)
    store_tile<T, BN>(acc, p.y + at, p.F, rows, cols, nullptr, p.out_vec);
  else
    store_tile<float, BN>(acc, p.partials + s * p.split_elems + at, p.F, rows, cols,
                          nullptr, p.out_vec);
}

// One block-ELL product on `stream`: the SpMM kernel, then (splits > 1) the
// fixed-order reduction of its partials (splits * nrb*B*F fp32) into y.
template <typename T>
cudaError_t launch_spmm(const T* blocks, const int* cols, const int* row_k, const T* x,
                        T* y, float* partials, int nrb, int K, int B, int F, int tile_n,
                        int splits, int copy, cudaStream_t stream) {
  if (nrb < 1 || K < 1 || B < 1 || F < 1) return cudaErrorInvalidValue;
  const int chunks_per_slot = ceil_div(B, kChunk);
  const long long chunks = static_cast<long long>(K) * chunks_per_slot;
  if (splits < 1 || splits > chunks || splits > 65535 ||
      (splits > 1 && partials == nullptr) || chunks > (1LL << 30))
    return cudaErrorInvalidValue;
  if (!copy_mode_fits<T>(copy, {B, F}, {blocks, x})) return cudaErrorInvalidValue;
  const int row_tiles = ceil_div(B, kTileM);
  const long long m_tiles = static_cast<long long>(nrb) * row_tiles;
  const long long n_tiles = ceil_div(F, tile_n > 0 ? tile_n : 1);
  if (m_tiles >= (1LL << 31) || n_tiles > 65535) return cudaErrorInvalidValue;

  SpmmArgs<T> a;
  a.blocks = blocks; a.cols = cols; a.row_k = row_k; a.x = x; a.y = y;
  a.partials = splits > 1 ? partials : nullptr;
  a.K = K; a.B = B; a.F = F;
  a.row_tiles = row_tiles;
  a.chunks_per_slot = chunks_per_slot;
  a.per_split = ceil_div(chunks, splits);
  a.split_elems = static_cast<long long>(nrb) * B * F;
  a.out_vec = F % 4 == 0 && aligned(y, 16) && aligned(a.partials, 16);
  const dim3 grid(static_cast<unsigned>(m_tiles), static_cast<unsigned>(n_tiles),
                  static_cast<unsigned>(splits));
  const cudaError_t err = dispatch<T>(tile_n, copy, [&](auto bn, auto mode) {
    constexpr int kBN = decltype(bn)::value;
    constexpr int kMode = decltype(mode)::value;
    constexpr int kSmem = smem_bytes<T, kBN>();
    static std::atomic<unsigned> done{0};
    const cudaError_t e = allow_smem(spmm_kernel<T, kBN, kMode>, kSmem, done);
    if (e != cudaSuccess) return e;
    spmm_kernel<T, kBN, kMode><<<grid, kThreads, kSmem, stream>>>(a);
    return cudaGetLastError();
  });
  if (err != cudaSuccess || splits == 1) return err;
  return launch_reduce<T>(partials, splits, nrb * B, F, nullptr, y, stream);
}

}  // namespace
}  // namespace block_tile
