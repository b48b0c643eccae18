// Flash attention forward on Hopper (sm_90a), CUDA cores, fp32 arithmetic:
// the kernel of fp32 inputs. bf16 inputs launch flash_attention_sm90.cu
// (wgmma tensor cores, TMA); no input falls from one kernel to the other.
//
// Replaces the Pallas TPU kernel `_flash_kernel` of
// src/repro/kernels/flash_attention.py (called through `flash_attention`)
// for fp32 inputs. It computes, for every (batch, q head) and query row i,
//
//   s_j  = scale * <q_i, k_j>             (fp32; then softcap * tanh(s / softcap) if given)
//   s_j  = -1e30 where key j is not visible (j >= Tk; causal: j > qpos;
//          window: j <= qpos - window), with qpos = i + Tk - Tq
//   o_i  = sum_j softmax(s)_j v_j          (0 for a row that sees no key)
//
// with the running max, the denominator and the P.V accumulator in fp32 and
// an fp32 output, as the TPU kernel does. GQA: q head h reads kv head
// h / (Hq / Hkv), so the kv heads are never repeated in memory.
//
// Design. On the TPU the kv tiles are a sequential grid axis and m, l and acc
// live in VMEM scratch from one grid step to the next. Blocks on a GPU run in
// no order, so here one thread block owns one (batch * head, 64-row q tile)
// pair and walks the kv tiles itself in a loop, with the online softmax in
// registers:
//   * the q tile (64 x D) stays in shared memory, transposed, for the whole
//     loop; each kv tile stages K (transposed) and V (64 x D) as fp32;
//   * 256 threads as 16 x 16: thread (ty, tx) owns rows 4ty..4ty+3 of the
//     tile. It computes a 4 x 4 block of S = Q K^T (keys 4tx..4tx+3), takes
//     the row max and row sum across the 16 threads of its rows with warp
//     shuffles, writes P through shared memory, and accumulates P.V for its
//     4 rows over the column groups 4(tx + 16g)..+3 of D (g < NG, NG = D/64
//     rounded up);
//   * the loop visits only the kv tiles that hold a visible key: up to the
//     causal frontier of the tile's last row and from the window's start of
//     its first row (the TPU kernel's `pl.when` skip, done by the loop bounds);
//   * the ragged ends of Tq and Tk are masked in the kernel (rows past Tq are
//     neither read nor written, keys past Tk are zero and masked), where the
//     reference pads q, k and v to whole tiles in device memory;
//   * q tiles are handed out last first, so the longest causal rows start
//     first and the short ones fill the tail.
// Shared memory: (D (64+4) + D (64+4) + 64 D + 64 (64+4)) floats, 67 KB at
// D = 64 (three blocks per SM) and 217 KB at D = 256 (one block per SM).
//
// What bounds it. fp32 is the parity path (TF32 stays off by the port's
// contract): the products run on the fp32 CUDA cores (67 TFLOP/s peak), and
// shared-memory traffic for the 4 x 4 register tiles limits it below that.
// The served dtype, bf16, runs on the tensor cores in flash_attention_sm90.cu.
//
// C interface (loaded with ctypes): pointers and the stream are void*,
// strides (in elements) long long, the rest int or float. The kernel launches
// on `stream`, allocates nothing, does not synchronise, and the entry point
// returns cudaGetLastError() (or the error of cudaFuncSetAttribute).

#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;        // query rows per thread block
constexpr int kBK = 64;        // keys per kv tile
constexpr int kPad = 4;        // row padding of the transposed tiles (keeps float4 alignment)
constexpr int kThreads = 256;  // 16 x 16
constexpr float kNegInf = -1e30f;

struct Shape {
  long long q_sb, q_sh, q_st;  // q strides over batch, head, token (elements)
  long long k_sb, k_sh, k_st;
  long long v_sb, v_sh, v_st;
  int Hq, Hkv, Tq, Tk, D;
  float scale, softcap;
  int has_softcap, causal, has_window, window;
};

template <int NG>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o, const Shape s) {
  extern __shared__ __align__(16) float smem[];
  constexpr int ldq = kBQ + kPad;
  constexpr int ldk = kBK + kPad;
  const int D = s.D;
  float* q_s = smem;             // [D][ldq]  q tile, transposed
  float* k_s = q_s + D * ldq;    // [D][ldk]  k tile, transposed
  float* v_s = k_s + D * ldk;    // [kBK][D]  v tile
  float* p_s = v_s + kBK * D;    // [kBK][ldq] P, transposed

  const int bh = blockIdx.x;
  const int b = bh / s.Hq, h = bh - b * s.Hq;
  const int hk = h / (s.Hq / s.Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const int t = threadIdx.x, tx = t % 16, ty = t / 16;
  const int q_offset = s.Tk - s.Tq;

  const float* qb = q + b * s.q_sb + h * s.q_sh;
  const float* kb = k + b * s.k_sb + hk * s.k_sh;
  const float* vb = v + b * s.v_sb + hk * s.v_sh;

  for (int e = t; e < kBQ * D; e += kThreads) {
    const int r = e / D, d = e - r * D;      // neighbours read neighbouring d
    const int row = q0 + r;
    q_s[d * ldq + r] = row < s.Tq ? qb[row * s.q_st + d] : 0.0f;
  }

  // kv tiles holding a key visible to some row of this tile
  const int qpos_first = q0 + q_offset;
  const int qpos_last = min(q0 + kBQ, s.Tq) - 1 + q_offset;
  const int k_begin = s.has_window ? max(0, qpos_first - s.window + 1) : 0;
  const int k_end = s.causal ? min(s.Tk, qpos_last + 1) : s.Tk;
  const int kt_begin = k_begin / kBK;
  const int kt_end = k_end > k_begin ? (k_end + kBK - 1) / kBK : kt_begin;

  float m[4], l[4], acc[4][4 * NG];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m[a] = kNegInf;
    l[a] = 0.0f;
#pragma unroll
    for (int j = 0; j < 4 * NG; ++j) acc[a][j] = 0.0f;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // q_s staged; the previous tile's k_s, v_s, p_s consumed
    for (int e = t; e < kBK * D; e += kThreads) {
      const int c = e / D, d = e - c * D;
      const int key = k0 + c;
      const bool ok = key < s.Tk;
      k_s[d * ldk + c] = ok ? kb[key * s.k_st + d] : 0.0f;
      v_s[c * D + d] = ok ? vb[key * s.v_st + d] : 0.0f;
    }
    __syncthreads();

    // S = Q K^T for rows 4ty.., keys 4tx..
    float sc[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) sc[a][c] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float4 qv = *reinterpret_cast<const float4*>(&q_s[d * ldq + ty * 4]);
      const float4 kv = *reinterpret_cast<const float4*>(&k_s[d * ldk + tx * 4]);
      const float qr[4] = {qv.x, qv.y, qv.z, qv.w};
      const float kr[4] = {kv.x, kv.y, kv.z, kv.w};
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) sc[a][c] = fmaf(qr[a], kr[c], sc[a][c]);
    }

    // scale, softcap, mask; online softmax across the 16 threads of each row
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int qpos = q0 + ty * 4 + a + q_offset;
      float mc = kNegInf;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int key = k0 + tx * 4 + c;
        float x = sc[a][c] * s.scale;
        if (s.has_softcap) x = s.softcap * tanhf(x / s.softcap);
        bool vis = key < s.Tk;
        if (s.causal) vis = vis && key <= qpos;
        if (s.has_window) vis = vis && key > qpos - s.window;
        sc[a][c] = vis ? x : kNegInf;
        mc = fmaxf(mc, sc[a][c]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, off));
      const float m_new = fmaxf(m[a], mc);
      const float alpha = m[a] > kNegInf / 2 ? expf(m[a] - m_new) : 0.0f;
      const bool live = m_new > kNegInf / 2;
      float rs = 0.0f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        sc[a][c] = live ? expf(sc[a][c] - m_new) : 0.0f;
        rs += sc[a][c];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[a] = l[a] * alpha + rs;
      m[a] = m_new;
#pragma unroll
      for (int j = 0; j < 4 * NG; ++j) acc[a][j] *= alpha;
    }
#pragma unroll
    for (int c = 0; c < 4; ++c)
      *reinterpret_cast<float4*>(&p_s[(tx * 4 + c) * ldq + ty * 4]) =
          make_float4(sc[0][c], sc[1][c], sc[2][c], sc[3][c]);
    __syncthreads();

    // acc += P V over this tile's keys
    const int n_keys = min(kBK, s.Tk - k0);
    for (int c = 0; c < n_keys; ++c) {
      const float4 pv = *reinterpret_cast<const float4*>(&p_s[c * ldq + ty * 4]);
      const float pr[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        const int col = (tx + 16 * g) * 4;
        if (col < D) {
          const float4 vv = *reinterpret_cast<const float4*>(&v_s[c * D + col]);
          const float vr[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int i = 0; i < 4; ++i)
              acc[a][g * 4 + i] = fmaf(pr[a], vr[i], acc[a][g * 4 + i]);
        }
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = q0 + ty * 4 + a;
    if (row >= s.Tq) continue;
    const float denom = fmaxf(l[a], 1e-30f);
    float* out = o + (static_cast<long long>(bh) * s.Tq + row) * D;
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      const int col = (tx + 16 * g) * 4;
      if (col < D) {
#pragma unroll
        for (int i = 0; i < 4; ++i) out[col + i] = acc[a][g * 4 + i] / denom;
      }
    }
  }
}

template <int NG>
int launch_ng(const void* q, const void* k, const void* v, void* o, const Shape& s,
              int B, void* stream) {
  const size_t smem = sizeof(float) * (static_cast<size_t>(s.D) * (kBQ + kPad) +
                                       static_cast<size_t>(s.D) * (kBK + kPad) +
                                       static_cast<size_t>(kBK) * s.D +
                                       static_cast<size_t>(kBK) * (kBQ + kPad));
  auto kernel = flash_attention_kernel<NG>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(static_cast<unsigned>(B) * s.Hq, static_cast<unsigned>((s.Tq + kBQ - 1) / kBQ));
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), s);
  return static_cast<int>(cudaGetLastError());
}

int launch(const void* q, const void* k, const void* v, void* o,
           long long q_sb, long long q_sh, long long q_st,
           long long k_sb, long long k_sh, long long k_st,
           long long v_sb, long long v_sh, long long v_st,
           int B, int Hq, int Hkv, int Tq, int Tk, int D, float scale,
           int has_softcap, float softcap, int causal, int has_window, int window,
           void* stream) {
  const Shape s{q_sb, q_sh, q_st, k_sb, k_sh, k_st, v_sb, v_sh, v_st,
                Hq, Hkv, Tq, Tk, D, scale, softcap,
                has_softcap, causal, has_window, window};
  if (D <= 64) return launch_ng<1>(q, k, v, o, s, B, stream);
  if (D <= 128) return launch_ng<2>(q, k, v, o, s, B, stream);
  if (D <= 192) return launch_ng<3>(q, k, v, o, s, B, stream);
  return launch_ng<4>(q, k, v, o, s, B, stream);
}

}  // namespace

extern "C" {

// o (B, Hq, Tq, D) contiguous = attention(q (B, Hq, Tq, D), k, v (B, Hkv, Tk, D)),
// each input addressed by its strides over (batch, head, token), unit stride
// along D. D a multiple of 8 up to 256, Hq a multiple of Hkv (the wrapper checks).
int flash_attention_f32(const void* q, const void* k, const void* v, void* o,
                        long long q_sb, long long q_sh, long long q_st,
                        long long k_sb, long long k_sh, long long k_st,
                        long long v_sb, long long v_sh, long long v_st,
                        int B, int Hq, int Hkv, int Tq, int Tk, int D, float scale,
                        int has_softcap, float softcap, int causal, int has_window,
                        int window, void* stream) {
  return launch(q, k, v, o, q_sb, q_sh, q_st, k_sb, k_sh, k_st, v_sb, v_sh, v_st,
                       B, Hq, Hkv, Tq, Tk, D, scale, has_softcap, softcap, causal,
                       has_window, window, stream);
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
