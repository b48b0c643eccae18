// Flash attention forward on Hopper (sm_90a) for bf16: wgmma tensor cores,
// K/V tiles fed by TMA into a shared-memory ring, warp-specialised.
//
// Replaces the Pallas TPU kernel `_flash_kernel` of
// src/repro/kernels/flash_attention.py (called through `flash_attention`)
// for bf16 inputs; fp32 inputs keep the CUDA-core kernel of
// flash_attention.cu (`flash_attention_f32`). It computes, for every
// (batch, q head) and query row i,
//
//   s_j  = scale * <q_i, k_j>             (fp32; then softcap * tanh(s / softcap) if given)
//   s_j  = -1e30 where key j is not visible (j >= Tk; causal: j > qpos;
//          window: j <= qpos - window), with qpos = i + Tk - Tq
//   o_i  = sum_j softmax(s)_j v_j          (0 for a row that sees no key)
//
// with the running max, the denominator, S and the P.V accumulator in fp32
// and the output in bf16. P is split into a bf16 high part and the bf16 of
// what rounding left over, and P.V is the sum of the two products: 16 bits
// of each probability reach the tensor cores, where one bf16 rounding of P
// (FlashAttention-2's and SDPA's) would put the error at the prefill shape
// above half of the port's bf16 tolerance. GQA: q head h reads kv head
// h / (Hq / Hkv) in place. The softmax runs in base 2 with scale * log2(e)
// folded in; the reference's guards (m > -1e30 / 2, l = max(l, 1e-30)) give
// 0 for a row that sees no key.
//
// What bounds it. At the llama3.2-1b prefill (B 4, Hq 32 over Hkv 8, T 2048,
// D 64, causal) the function needs 4 * B*Hq * D * T(T+1)/2 = 6.9e10 FLOP and
// moves 84 MB: 0.0695 ms on the H100's bf16 tensor cores (989 TFLOP/s), so it
// is bound by operations, and only wgmma reaches that rate.
//
// Design.
//   * One CTA owns one (batch * head, 128-row q tile); q tiles are handed out
//     last first, so the longest causal rows start first.
//   * Warp roles: warpgroup 0 is the producer (one thread issues every TMA
//     load; setmaxnreg gives its registers to the consumers); warpgroups 1
//     and 2 are consumers, 64 q rows each (the M of wgmma.m64nNk16).
//   * TMA: q, k and v are 4-D tensor maps (D, T, H, B) encoded per call from
//     the views' pointers and strides, so strided (B, T, H, D) views go in
//     without a copy. A box is 64 columns (128 bytes, 128-byte swizzle) by
//     128 q rows or BK keys; D above 64 takes one box per 64 columns
//     (a "slab"), and D is padded up to its bucket (64, 128, 256) and T to
//     whole tiles by TMA's zero fill. Q is loaded once; K and V tiles go
//     through a ring of STAGES slots with full (TMA bytes) and empty (one
//     arrival per consumer warp) mbarriers, K and V with barriers of their
//     own so S = QK^T starts while V is still in flight.
//   * S = Q K^T: wgmma with both operands in shared memory, K-major (D
//     contiguous), the descriptors' 128-byte swizzle matching TMA's.
//   * Softmax on the accumulator fragment in registers: each thread holds
//     two rows (lane / 4 and lane / 4 + 8 of its warp's 16); the row max is
//     reduced across the quad with two shuffles, the row sum stays partial
//     per thread until the epilogue. Mask arithmetic runs only on kv tiles
//     that cross Tk, the causal diagonal or the window's edge; the loop
//     bounds skip tiles outside the causal / window band, as on the TPU.
//   * O += P V: P is converted to bf16 (high and low parts) in registers;
//     for 16-bit types the fp32 accumulator fragment of m64nNk16 has the
//     layout of wgmma's A-from-registers operand, so P feeds the second
//     wgmma directly. V is the B operand in its natural (keys x D) layout,
//     MN-major (transpose bit set). O is rescaled by exp2(m_old - m_new) in
//     registers and divided by the quad-reduced l in the epilogue, which
//     writes bf16 pairs straight to device memory (rows past Tq are not
//     written).
//   * Pingpong (FlashAttention-3's schedule): the two consumers take turns,
//     through two named barriers, to issue their wgmmas, and each issues S
//     of kv tile i together with P.V of tile i - 1; so one warpgroup's
//     softmax runs while the tensor cores work for the other. On the card
//     this beat a plain S -> softmax -> P.V loop at D 64 and 128 and lost
//     a little at D 256, which keeps it for one code path.
//   * Buckets (DB, BK, STAGES): D <= 64 -> (64, 128, 3), 113 KB of shared
//     memory; D <= 128 -> (128, 128, 3), 225 KB; D <= 256 -> (256, 64, 2),
//     193 KB. One CTA per SM; ptxas compiles for 168 registers a thread
//     (the launch bound) and the consumers may grow to 240.
//
// C interface (loaded with ctypes): the arguments of flash_attention.cu's
// entry points. The tensor maps need libcuda's cuTensorMapEncodeTiled;
// it is fetched with cudaGetDriverEntryPoint, so the library links only the
// runtime. The wrapper checks what TMA needs: a 16-byte aligned base and
// token, head and batch strides that are multiples of 16 bytes (dimensions
// of size 1 are exempt: their stride is never used). The kernel launches on
// `stream`, allocates nothing, does not synchronise; the entry point returns
// cudaGetLastError(), a cudaError of the set-up, or kErrEncode + the encoder's
// CUresult when a tensor map cannot be encoded.

#include <cuda.h>  // CUtensorMap and its enums (types only: nothing links libcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 128;        // q rows per CTA: two consumer warpgroups of 64
constexpr int kThreads = 384;   // a producer warpgroup and two consumer warpgroups
constexpr int kSlab = 64;       // bf16 columns in one 128-byte swizzled row
constexpr int kRowBytes = 128;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;  // (65536 - 128 * 24) / 256, a multiple of 8
constexpr int kErrNoEntryPoint = 99999;
constexpr int kErrEncode = 100000;

struct Params {
  int Hq, Hkv, Tq, Tk, D;
  float scale, softcap;
  int has_softcap, causal, has_window, window;
};

// Shared memory, from a 1024-byte aligned base (the swizzle's period):
// Q [slabs][128 rows][128 B], K [stages][slabs][BK rows][128 B], V likewise,
// then the mbarriers.
template <int DB, int BK, int STAGES>
struct Layout {
  static constexpr int kSlabs = DB / kSlab;
  static constexpr int kQSlab = kBQ * kRowBytes;
  static constexpr int kKVSlab = BK * kRowBytes;
  static constexpr int kQBytes = kSlabs * kQSlab;
  static constexpr int kKVBytes = kSlabs * kKVSlab;  // one K or V tile
  static constexpr int kK = kQBytes;
  static constexpr int kV = kK + STAGES * kKVBytes;
  static constexpr int kBar = kV + STAGES * kKVBytes;
  static constexpr int kBytes = kBar + 8 * (1 + 3 * STAGES);
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets, all in 16-byte units.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed groups of this warpgroup are pending
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of registers that an
// asynchronous wgmma owns across the points where it is issued and awaited.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// (a, b) as a bf16 pair `hi` and the pair of what rounding left over, `lo`:
// hi + lo carries 16 bits of each value's mantissa into P.V.
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(a - hf.x, b - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// wgmma.m64nNk16, bf16 in, fp32 accumulate (N = 2 x the registers of d).
// ss: A and B from shared memory, both K-major; ss_zero overwrites d.
// rs: A from registers (a bf16 m64k16 fragment), B from shared memory
// MN-major (the transpose bit), always accumulating. The operand lists are
// spelled out: inline PTX takes no arrays.

__device__ __forceinline__ void wgmma_ss_zero(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31])
      : "l"(a), "l"(b), "r"(0));
}

__device__ __forceinline__ void wgmma_ss_zero(float (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31]),
        "=f"(d[32]), "=f"(d[33]), "=f"(d[34]), "=f"(d[35]), "=f"(d[36]), "=f"(d[37]), "=f"(d[38]), "=f"(d[39]),
        "=f"(d[40]), "=f"(d[41]), "=f"(d[42]), "=f"(d[43]), "=f"(d[44]), "=f"(d[45]), "=f"(d[46]), "=f"(d[47]),
        "=f"(d[48]), "=f"(d[49]), "=f"(d[50]), "=f"(d[51]), "=f"(d[52]), "=f"(d[53]), "=f"(d[54]), "=f"(d[55]),
        "=f"(d[56]), "=f"(d[57]), "=f"(d[58]), "=f"(d[59]), "=f"(d[60]), "=f"(d[61]), "=f"(d[62]), "=f"(d[63])
      : "l"(a), "l"(b), "r"(0));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <int DB, int BK, int STAGES>
__global__ void __launch_bounds__(kThreads, 1)
flash_sm90_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                  const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ o,
                  const Params p) {
  using L = Layout<DB, BK, STAGES>;
  constexpr int kON = DB < 128 ? DB : 128;  // width of one P.V wgmma
  constexpr int kOP = DB / kON;             // P.V wgmmas per k step
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base, sk = base + L::kK, sv = base + L::kV;
  const uint32_t bar_q = base + L::kBar;
  auto k_full = [&](int s) { return bar_q + 8u * (1 + s); };
  auto v_full = [&](int s) { return bar_q + 8u * (1 + STAGES + s); };
  auto empty = [&](int s) { return bar_q + 8u * (1 + 2 * STAGES + s); };

  const int bh = blockIdx.x;
  const int b = bh / p.Hq, h = bh - b * p.Hq;
  const int hk = h / (p.Hq / p.Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const int q_offset = p.Tk - p.Tq;

  // kv tiles holding a key visible to some row of this tile
  const int qpos_first = q0 + q_offset;
  const int qpos_last = min(q0 + kBQ, p.Tq) - 1 + q_offset;
  const int k_begin = p.has_window ? max(0, qpos_first - p.window + 1) : 0;
  const int k_end = p.causal ? min(p.Tk, qpos_last + 1) : p.Tk;
  const int kt_begin = k_begin / BK;
  const int kt_end = k_end > k_begin ? (k_end + BK - 1) / BK : kt_begin;
  const int n_tiles = kt_end - kt_begin;  // visited last tile first

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp < 4) {
    // ---- producer warpgroup: one thread issues every load -------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (warp == 0 && lane == 0) {
      mbar_expect_tx(bar_q, L::kQBytes);
      for (int s = 0; s < L::kSlabs; ++s)
        tma_load(sq + s * L::kQSlab, &tm_q, bar_q, s * kSlab, q0, h, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % STAGES;
        const uint32_t round = (it / STAGES) & 1;
        const int k0 = (kt_end - 1 - it) * BK;
        mbar_wait(empty(st), round ^ 1);  // the first round finds every slot free
        mbar_expect_tx(k_full(st), L::kKVBytes);
        for (int s = 0; s < L::kSlabs; ++s)
          tma_load(sk + st * L::kKVBytes + s * L::kKVSlab, &tm_k, k_full(st), s * kSlab, k0, hk,
                   b);
        mbar_expect_tx(v_full(st), L::kKVBytes);
        for (int s = 0; s < L::kSlabs; ++s)
          tma_load(sv + st * L::kKVBytes + s * L::kKVSlab, &tm_v, v_full(st), s * kSlab, k0, hk,
                   b);
      }
    }
  } else {
    // ---- consumer warpgroups: 64 q rows each --------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int wg = warp / 4 - 1;
    const int row0 = q0 + 64 * wg + 16 * (warp % 4) + lane / 4;  // and row0 + 8
    const int col0 = 2 * (lane % 4);
    const uint32_t q_rows = sq + wg * 64 * kRowBytes;
    // s holds base-2 logits after multiplying by `unit`: raw scores times
    // scale * log2(e), or (softcap) log2(e) * softcap * tanh(scale * s / softcap)
    const float unit = p.has_softcap ? 1.0f : p.scale * kLog2e;
    const float cap_in = p.scale / p.softcap, cap_out = p.softcap * kLog2e;

    float acc[kOP][kON / 2];
#pragma unroll
    for (int c = 0; c < kOP; ++c)
#pragma unroll
      for (int i = 0; i < kON / 2; ++i) acc[c][i] = 0.0f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f}, alpha[2];
    float s[BK / 2];
    uint32_t pa[BK / 16][4], pl[BK / 16][4];  // P's bf16 high and low parts

    // S = Q K^T of tile `it` over D in k16 steps (32 bytes within a 128-byte
    // row); the first step overwrites s
    auto issue_s = [&](int it) {
      const int st = it % STAGES;
      mbar_wait(k_full(st), (it / STAGES) & 1);
      const uint32_t k_rows = sk + st * L::kKVBytes;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DB / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;
        const uint64_t qd = sw128_desc(q_rows + (kk / 4) * L::kQSlab + off, 16, 1024);
        const uint64_t kd = sw128_desc(k_rows + (kk / 4) * L::kKVSlab + off, 16, 1024);
        if (kk == 0)
          wgmma_ss_zero(s, qd, kd);
        else
          wgmma_ss(s, qd, kd);
      }
      wgmma_commit();
    };
    // O += (P_hi + P_lo) V of tile `it`: 16 keys (2048 bytes of V rows) per k
    // step; the LBO steps across V's 64-column slabs
    auto issue_pv = [&](int it) {
      const int st = it % STAGES;
      mbar_wait(v_full(st), (it / STAGES) & 1);
      const uint32_t v_rows = sv + st * L::kKVBytes;
#pragma unroll
      for (int c = 0; c < kOP; ++c) pin(acc[c]);
      pin(pa);
      pin(pl);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int c = 0; c < kOP; ++c) {
          const uint64_t vd = sw128_desc(
              v_rows + c * (kON / kSlab) * L::kKVSlab + kk * 16 * kRowBytes, L::kKVSlab, 1024);
          wgmma_rs(acc[c], pa[kk], vd);
          wgmma_rs(acc[c], pl[kk], vd);
        }
      wgmma_commit();
    };
    // P.V of tile `it` has completed: its registers are free, its slot too
    auto pv_done = [&](int it) {
#pragma unroll
      for (int c = 0; c < kOP; ++c) pin(acc[c]);
      pin(pa);
      pin(pl);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(it % STAGES));
    };
    // the online softmax of tile `it` on s (which becomes P in fp32): m, l
    // and alpha = exp2(m_old - m_new). Element 4j+e of s is row
    // row0 + 8(e/2), key k0 + 8j + col0 + e%2. A masked score is -inf here
    // (exp2 gives 0); a row whose scores were all masked keeps m = -1e30.
    auto softmax = [&](int it) {
      pin(s);
      const int k0 = (kt_end - 1 - it) * BK;
      if (p.has_softcap) {
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) s[i] = cap_out * tanhf(s[i] * cap_in);
      }
      const bool edge = k0 + BK > p.Tk || (p.causal && k0 + BK - 1 > qpos_first) ||
                        (p.has_window && k0 <= qpos_last - p.window);
      if (edge) {
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) {
          const int key = k0 + 8 * (i / 4) + col0 + (i % 2);
          const int qpos = row0 + 8 * ((i % 4) / 2) + q_offset;
          bool vis = key < p.Tk;
          if (p.causal) vis = vis && key <= qpos;
          if (p.has_window) vis = vis && key > qpos - p.window;
          if (!vis) s[i] = -INFINITY;
        }
      }
      float mx[2] = {-INFINITY, -INFINITY}, m_use[2];
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) mx[(i % 4) / 2] = fmaxf(mx[(i % 4) / 2], s[i]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r] * unit);
        alpha[r] = m[r] > kNegInf / 2 ? fast_exp2(m[r] - m_new) : 0.0f;
        m_use[r] = m_new > kNegInf / 2 ? m_new : 0.0f;
        m[r] = m_new;
      }
      float rs[2] = {0.0f, 0.0f};
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        s[i] = fast_exp2(fmaf(s[i], unit, -m_use[(i % 4) / 2]));
        rs[(i % 4) / 2] += s[i];
      }
      l[0] = l[0] * alpha[0] + rs[0];
      l[1] = l[1] * alpha[1] + rs[1];
    };
    // O *= alpha; P into the A fragments of the next P.V
    auto rescale_and_split = [&]() {
#pragma unroll
      for (int c = 0; c < kOP; ++c)
#pragma unroll
        for (int i = 0; i < kON / 2; ++i) acc[c][i] *= alpha[(i % 4) / 2];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          split_bf16(s[8 * kk + 2 * j], s[8 * kk + 2 * j + 1], pa[kk][j], pl[kk][j]);
    };

    // Pingpong: the two consumer warpgroups take turns to issue their wgmmas
    // (named barrier 1 + wg, 2 x 128 threads: the owner syncs, the other
    // arrives once it has issued), so one's softmax runs while the tensor
    // cores work for the other. Within a warpgroup S of tile i is issued
    // together with P.V of tile i - 1.
    const uint32_t my_bar = 1 + wg, other_bar = 2 - wg;
    auto my_turn = [&]() { asm volatile("bar.sync %0, 256;\n" ::"r"(my_bar) : "memory"); };
    auto pass_turn = [&]() { asm volatile("bar.arrive %0, 256;\n" ::"r"(other_bar) : "memory"); };
    if (wg == 1) pass_turn();  // warpgroup 0 goes first

    mbar_wait(bar_q, 0);
    if (n_tiles > 0) {
      my_turn();
      issue_s(0);
      pass_turn();
      wgmma_wait<0>();
      softmax(0);
      rescale_and_split();
      for (int it = 1; it < n_tiles; ++it) {
        my_turn();
        issue_s(it);
        issue_pv(it - 1);
        pass_turn();
        wgmma_wait<1>();  // S of tile it; P.V of it - 1 may still run
        softmax(it);
        wgmma_wait<0>();
        pv_done(it - 1);
        rescale_and_split();
      }
      my_turn();
      issue_pv(n_tiles - 1);
      pass_turn();
      wgmma_wait<0>();
      pv_done(n_tiles - 1);
    }

    // epilogue: O / max(l, 1e-30) as bf16 pairs; rows past Tq are not written
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float lr = l[r];
      lr += __shfl_xor_sync(0xffffffffu, lr, 1);
      lr += __shfl_xor_sync(0xffffffffu, lr, 2);
      inv[r] = 1.0f / fmaxf(lr, 1e-30f);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= p.Tq) continue;
      __nv_bfloat16* out = o + (static_cast<long long>(bh) * p.Tq + row) * p.D;
#pragma unroll
      for (int c = 0; c < kOP; ++c)
#pragma unroll
        for (int j = 0; j < kON / 8; ++j) {
          const int col = c * kON + 8 * j + col0;
          if (col < p.D)
            *reinterpret_cast<__nv_bfloat162*>(out + col) = __floats2bfloat162_rn(
                acc[c][4 * j + 2 * r] * inv[r], acc[c][4 * j + 2 * r + 1] * inv[r]);
        }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, looked up through the runtime once.
int encode_fn(EncodeTiled* fn) {
  static EncodeTiled cached = nullptr;
  if (cached == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                           cudaEnableDefault, &found);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (e != cudaSuccess) return static_cast<int>(e);
    if (found != cudaDriverEntryPointSuccess || ptr == nullptr) return kErrNoEntryPoint;
    cached = reinterpret_cast<EncodeTiled>(ptr);
  }
  *fn = cached;
  return 0;
}

// A (D, T, H, B) view with element strides st, sh, sb as a tensor map whose
// box is 64 columns x `rows` tokens. A dimension of size 1 never moves, so it
// gets the packed stride (any multiple of 16 bytes would do).
int encode_map(EncodeTiled fn, CUtensorMap* map, const void* ptr, int D, int T, int H, int B,
               long long st, long long sh, long long sb, int rows) {
  const cuuint64_t e = sizeof(__nv_bfloat16);
  const cuuint64_t bt = T > 1 ? st * e : D * e;
  const cuuint64_t bhs = H > 1 ? sh * e : bt * T;
  const cuuint64_t bbs = B > 1 ? sb * e : bhs * H;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(T),
                              static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {bt, bhs, bbs};
  const cuuint32_t box[4] = {kSlab, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                        strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);  // out of bounds reads as 0
  return r == CUDA_SUCCESS ? 0 : kErrEncode + static_cast<int>(r);
}

template <int DB, int BK, int STAGES>
int launch_bucket(const void* q, const void* k, const void* v, void* o, long long q_sb,
                  long long q_sh, long long q_st, long long k_sb, long long k_sh, long long k_st,
                  long long v_sb, long long v_sh, long long v_st, int B, const Params& p,
                  void* stream) {
  EncodeTiled fn;
  int err = encode_fn(&fn);
  if (err) return err;
  CUtensorMap tq, tk, tv;
  if ((err = encode_map(fn, &tq, q, p.D, p.Tq, p.Hq, B, q_st, q_sh, q_sb, kBQ))) return err;
  if ((err = encode_map(fn, &tk, k, p.D, p.Tk, p.Hkv, B, k_st, k_sh, k_sb, BK))) return err;
  if ((err = encode_map(fn, &tv, v, p.D, p.Tk, p.Hkv, B, v_st, v_sh, v_sb, BK))) return err;
  auto kernel = flash_sm90_kernel<DB, BK, STAGES>;
  const int smem = Layout<DB, BK, STAGES>::kBytes + 1024;  // + the 1024-byte alignment
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(static_cast<unsigned>(B) * p.Hq, static_cast<unsigned>((p.Tq + kBQ - 1) / kBQ));
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// o (B, Hq, Tq, D) contiguous bf16 = attention(q (B, Hq, Tq, D), k, v (B, Hkv,
// Tk, D)), bf16, each input addressed by its strides over (batch, head,
// token), unit stride along D. D a multiple of 8 up to 256, Hq a multiple of
// Hkv, 16-byte aligned pointers and strides (the wrapper checks).
int flash_attention_sm90_bf16(const void* q, const void* k, const void* v, void* o,
                              long long q_sb, long long q_sh, long long q_st,
                              long long k_sb, long long k_sh, long long k_st,
                              long long v_sb, long long v_sh, long long v_st,
                              int B, int Hq, int Hkv, int Tq, int Tk, int D, float scale,
                              int has_softcap, float softcap, int causal, int has_window,
                              int window, void* stream) {
  const Params p{Hq, Hkv, Tq, Tk, D, scale, softcap, has_softcap, causal, has_window, window};
  if (D <= 64)
    return launch_bucket<64, 128, 3>(q, k, v, o, q_sb, q_sh, q_st, k_sb, k_sh, k_st, v_sb, v_sh,
                                     v_st, B, p, stream);
  if (D <= 128)
    return launch_bucket<128, 128, 3>(q, k, v, o, q_sb, q_sh, q_st, k_sb, k_sh, k_st, v_sb, v_sh,
                                      v_st, B, p, stream);
  return launch_bucket<256, 64, 2>(q, k, v, o, q_sb, q_sh, q_st, k_sb, k_sh, k_st, v_sb, v_sh,
                                   v_st, B, p, stream);
}

const char* flash_attention_sm90_error_string(int code) {
  if (code == kErrNoEntryPoint) return "cuTensorMapEncodeTiled not found in libcuda";
  if (code >= kErrEncode) return "cuTensorMapEncodeTiled refused a tensor map (CUresult = code - 100000)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
