// Grouped expert product for Hopper (sm_90a), bound with ctypes: K5 of the port.
//
// Replaces no TPU kernel: the JAX package has no expert layer. It computes
// the routed experts of DeepSeek-V2's MoE layers (decode/deepseek_lm.py):
// for the (token, expert) pairs sorted by expert, with group offsets,
//   h[p] = silu(gate_e x[tok p]) * (up_e x[tok p])   (moe_gate_up_kernel)
//   y[p] = w[p] * down_e h[p]                        (moe_down_kernel)
// and ops/moe.py brings y's rows back to their tokens and sums over k.
//
// What bounds it: bytes. At the rescorer's shapes (~64 tokens, 64 experts,
// top-6) nearly every expert is touched and sees ~6 rows, so each weight
// byte feeds ~6 multiply-adds: reading each touched expert's gate, up and
// down weights once (3 * F * D * 2 bytes) takes ~0.33 ms a layer at 3.35
// TB/s, against ~7 us of tensor-core work.
//
// Design: a grid of (expert, output tile) that covers any routing, so the
// routing never reaches the host. A CTA reads its expert's offsets and
// returns at once when no pair chose it. Each of its WARPS warps owns two
// 16-row tiles of the expert's weight rows (gate_up: 16 gate rows and the
// same 16 columns' up rows; down: 32 rows of the output) and walks the whole
// depth K, so a weight byte is read once for up to ROWS pairs; an expert
// with more pairs takes further passes. The product is mma.sync.m16n8k16
// with the weights as A (output columns in M) and the pairs' rows as B
// (n-tiles of 8 pairs), so 6 rows waste nothing of a 16-row tile. A warp's
// lane (g, t) takes elements [8t, 8t + 8) of a 32-deep chunk of weight rows
// g and g + 8 and of pair g, 16 bytes each, and their four 32-bit words fill
// the A and B registers of two k16 steps: that permutes k inside the chunk,
// the same way for A and B, which leaves each dot product unchanged, and
// lets every lane read back only what it copied itself (no barrier, no
// ldmatrix). Both operands stream by cp.async into a ring of STAGES chunks
// a warp, each copy asking L2 for the whole 256-byte run that the
// neighbours and the next chunks read, so nothing in the loop waits on a
// load but the ring. Rows and pairs past the edge read valid ones whose sums
// the epilogue drops, and k past K reads zeros, so the loop has no branch.
// Measured on the H100 (64 tokens, 64 experts, top-6): registers holding
// the loads reached 56-81% of the bound (the compiler kept fewer in flight
// than written); a ring of the weights alone, the pairs' rows loaded beside
// it, 77-83%, and 19% with 8 experts taking all pairs; both operands in the
// ring, 80-84%, and 30% there. Few CTAs are resident at a kernel's tail, so
// a deep ring a warp (8 chunks, 2 warps a CTA) keeps each one streaming.
// No atomics: y is written in sorted order and summed by the caller, so two
// calls give the same bits.
//
// float32 operands (the tests' full-precision forward) take the same grid
// with one warp a column on the CUDA cores, a fixed-order warp sum.
//
// The caller's contract: x (T, D), gate_up (E, 2F, D), down (E, D, F), rows
// (n,) int32 tokens of the sorted pairs, offsets int32 group bounds
// (expert e's pairs are [offsets[e], offsets[e + 1]); those at or past
// offsets[E] are skipped), wt (n,) float32, h (n,
// F) and y (n, D) float32 written for the pairs of experts 0..E-1; rows of
// one expert contiguous. bf16: D and F multiples of 8 and every pointer
// 16-byte aligned.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 2;
constexpr int THREADS = 32 * WARPS;
constexpr int NT = 4;             // n8 tiles of pairs a pass
constexpr int ROWS = 8 * NT;      // pairs a pass: weights are read once for up to 32
constexpr int STAGES = 8;         // k32 chunks in flight, a ring per warp
constexpr int SLOT = 4 + NT;      // 16-byte pieces a lane copies a chunk: 4 weight rows, NT pairs
constexpr int SMEM_BYTES = WARPS * STAGES * SLOT * 32 * 16;
constexpr int GATE_UP_COLS = 16 * WARPS;  // output columns of a gate_up CTA
constexpr int DOWN_COLS = 32 * WARPS;     // output columns of a down CTA
constexpr int SIMT_COLS = WARPS;          // float32: one column a warp

enum Mode { GATE_UP = 0, DOWN = 1 };

__device__ __forceinline__ float silu_mul(float g, float u) { return g / (1.0f + expf(-g)) * u; }

// c += a . b on the tensor cores, bf16 in, f32 sums.
__device__ __forceinline__ void mma_bf16(float c[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// 16 bytes global -> shared through L2 only, asking L2 to fetch the whole
// 256-byte run that the lane's neighbours and the next chunks read; src_bytes
// 0 fills zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global.L2::256B [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One k32 chunk of a 16-row weight tile (lo: row g, hi: row g + 8) against
// one n8 tile of pairs (b: pair g), with the chunk's permuted k order.
__device__ __forceinline__ void mma_chunk(float c[4], const uint4& lo, const uint4& hi,
                                          const uint4& b) {
  mma_bf16(c, lo.x, hi.x, lo.y, hi.y, b.x, b.y);
  mma_bf16(c, lo.z, hi.z, lo.w, hi.w, b.z, b.w);
}

// N output columns and depth K: gate_up N = F, K = D (act = x, read through
// rows); down N = D, K = F (act = h, in sorted order).
template <int MODE>
__device__ __forceinline__ void grouped_mma(const __nv_bfloat16* __restrict__ act,
                                            const int* __restrict__ rows,
                                            const int* __restrict__ offsets,
                                            const __nv_bfloat16* __restrict__ w,
                                            const float* __restrict__ wt,
                                            __nv_bfloat16* __restrict__ h,
                                            float* __restrict__ y, int N, int K,
                                            size_t stride_e) {
  const int e = blockIdx.x;
  const int start = offsets[e], end = offsets[e + 1];
  if (start >= end) return;  // no pair chose this expert
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int c0 = MODE == GATE_UP ? blockIdx.y * GATE_UP_COLS + warp * 16
                                 : blockIdx.y * DOWN_COLS + warp * 32;
  if (c0 >= N) return;  // warp-uniform; nothing below waits on other warps

  // this lane's four weight rows: tile 0 rows g, g + 8; tile 1 rows g, g + 8.
  // A row past N reads row 0 instead: its sums land in columns the epilogue
  // drops.
  const __nv_bfloat16* we = w + (size_t)e * stride_e;
  const uint4* wp[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int col = c0 + (MODE == DOWN && i >= 2 ? 16 : 0) + g + (i & 1) * 8;
    const int row = (MODE == GATE_UP && i >= 2 ? N : 0) + col;  // up rows follow gate rows
    wp[i] = reinterpret_cast<const uint4*>(we + (size_t)(col < N ? row : 0) * K);
  }
  // the warp's ring: stage s holds piece i (weight rows, then pairs) of lane
  // l at [s][i][l]; a lane reads back only what it copied itself, so no
  // barrier is needed
  extern __shared__ uint4 smem[];
  uint4* ring = smem + warp * STAGES * SLOT * 32 + lane;
  const int nk = (K + 31) / 32;

  for (int p0 = start; p0 < end; p0 += ROWS) {
    // this lane's pair of each n8 tile; a pair past the group reads pair p0
    // (its sums land in columns the epilogue drops)
    const uint4* xp[NT];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int p = p0 + j * 8 + g < end ? p0 + j * 8 + g : p0;
      xp[j] = reinterpret_cast<const uint4*>(act + (size_t)(MODE == GATE_UP ? rows[p] : p) * K);
    }
    // chunk c's pieces into stage c % STAGES, one commit group a chunk
    // (empty past the last, so that wait_group counts evenly); k past K
    // reads zeros
    auto issue = [&](int c) {
      const int k = c * 32 + 8 * t;
      const bool in = k < K;
      uint4* st = ring + (c % STAGES) * SLOT * 32;
#pragma unroll
      for (int i = 0; i < 4; ++i) cp_async16(st + i * 32, in ? wp[i] + k / 8 : wp[i], in ? 16 : 0);
#pragma unroll
      for (int j = 0; j < NT; ++j)
        cp_async16(st + (4 + j) * 32, in ? xp[j] + k / 8 : xp[j], in ? 16 : 0);
      cp_async_commit();
    };
    float acc[2][NT][4];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[m][j][q] = 0.0f;

    for (int c = 0; c < STAGES - 1; ++c) issue(c);
    for (int c = 0; c < nk; ++c) {
      issue(c + STAGES - 1);  // into the stage this lane read one chunk ago
      cp_async_wait<STAGES - 1>();  // chunk c has landed
      const uint4* st = ring + (c % STAGES) * SLOT * 32;
      uint4 a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = st[i * 32];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const uint4 b = st[(4 + j) * 32];
        mma_chunk(acc[0][j], a[0], a[1], b);
        mma_chunk(acc[1][j], a[2], a[3], b);
      }
    }
    cp_async_wait<0>();  // the empty groups past the last chunk

    // C[col][pair]: c[0], c[1] at column g, pairs 2t, 2t + 1; c[2], c[3] at g + 8
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int p = p0 + j * 8 + 2 * t + (q & 1);
        const int col = c0 + g + (q >> 1) * 8;
        if (p >= end) continue;
        if (MODE == GATE_UP) {
          if (col < N) h[(size_t)p * N + col] = __float2bfloat16(silu_mul(acc[0][j][q], acc[1][j][q]));
        } else {
          const float s = wt[p];
          if (col < N) y[(size_t)p * N + col] = s * acc[0][j][q];
          if (col + 16 < N) y[(size_t)p * N + col + 16] = s * acc[1][j][q];
        }
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS)
    moe_gate_up_kernel(const __nv_bfloat16* __restrict__ x, const int* __restrict__ rows,
                       const int* __restrict__ offsets, const __nv_bfloat16* __restrict__ w,
                       __nv_bfloat16* __restrict__ h, int F, int D, size_t stride_e) {
  grouped_mma<GATE_UP>(x, rows, offsets, w, nullptr, h, nullptr, F, D, stride_e);
}

__global__ void __launch_bounds__(THREADS)
    moe_down_kernel(const __nv_bfloat16* __restrict__ h, const int* __restrict__ offsets,
                    const __nv_bfloat16* __restrict__ w, const float* __restrict__ wt,
                    float* __restrict__ y, int D, int F, size_t stride_e) {
  grouped_mma<DOWN>(h, nullptr, offsets, w, wt, nullptr, y, D, F, stride_e);
}

// float32: column c0 + warp of the expert, one pair at a time, lanes over k.
template <int MODE>
__global__ void __launch_bounds__(THREADS)
    moe_f32_kernel(const float* __restrict__ act, const int* __restrict__ rows,
                   const int* __restrict__ offsets, const float* __restrict__ w,
                   const float* __restrict__ wt, float* __restrict__ out, int N, int K,
                   size_t stride_e) {
  const int e = blockIdx.x, lane = threadIdx.x & 31;
  const int col = blockIdx.y * SIMT_COLS + (threadIdx.x >> 5);
  const int start = offsets[e], end = offsets[e + 1];
  if (col >= N) return;
  const float* w0 = w + (size_t)e * stride_e + (size_t)col * K;
  const float* w1 = w0 + (size_t)N * K;  // gate_up: the column's up row
  for (int p = start; p < end; ++p) {
    const float* a = act + (size_t)(MODE == GATE_UP ? rows[p] : p) * K;
    float s0 = 0.0f, s1 = 0.0f;
    for (int k = lane; k < K; k += 32) {
      s0 = fmaf(w0[k], a[k], s0);
      if (MODE == GATE_UP) s1 = fmaf(w1[k], a[k], s1);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      s0 += __shfl_xor_sync(0xffffffffu, s0, o);
      if (MODE == GATE_UP) s1 += __shfl_xor_sync(0xffffffffu, s1, o);
    }
    if (lane == 0) out[(size_t)p * N + col] = MODE == GATE_UP ? silu_mul(s0, s1) : wt[p] * s0;
  }
}

}  // namespace

extern "C" {

// x (T, D), gate_up (E, 2F, D) and down (E, D, F) with expert strides
// stride_gu and stride_down (elements; rows contiguous), rows (n,) int32,
// offsets (at least E + 1) int32, wt (n,) float32, h (n, F) in x's type, y (n, D)
// float32. f32: 1 for float32 operands, 0 for bf16. Two launches on stream.
// Returns a cudaError_t (0 = launched).
int b2t_moe_experts(const void* x, const void* rows, const void* offsets, const void* gate_up,
                    const void* down, const void* wt, void* h, void* y, int E, int D, int F,
                    int stride_gu, int stride_down, int f32, void* stream) {
  if (E < 0 || D <= 0 || F <= 0) return (int)cudaErrorInvalidValue;
  if (E == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* r = static_cast<const int*>(rows);
  const int* o = static_cast<const int*>(offsets);
  const float* ws = static_cast<const float*>(wt);
  if (f32) {
    const dim3 gu(E, (F + SIMT_COLS - 1) / SIMT_COLS), dn(E, (D + SIMT_COLS - 1) / SIMT_COLS);
    moe_f32_kernel<GATE_UP><<<gu, THREADS, 0, s>>>(static_cast<const float*>(x), r, o,
                                                   static_cast<const float*>(gate_up), nullptr,
                                                   static_cast<float*>(h), F, D, stride_gu);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    moe_f32_kernel<DOWN><<<dn, THREADS, 0, s>>>(static_cast<const float*>(h), nullptr, o,
                                                static_cast<const float*>(down), ws,
                                                static_cast<float*>(y), D, F, stride_down);
    return (int)cudaGetLastError();
  }
  if (D % 8 != 0 || F % 8 != 0) return (int)cudaErrorInvalidValue;
  static const cudaError_t attr = [] {
    cudaError_t e = cudaFuncSetAttribute(moe_gate_up_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(moe_down_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_BYTES);
    return e;
  }();
  if (attr != cudaSuccess) return (int)attr;
  const dim3 gu(E, (F + GATE_UP_COLS - 1) / GATE_UP_COLS), dn(E, (D + DOWN_COLS - 1) / DOWN_COLS);
  moe_gate_up_kernel<<<gu, THREADS, SMEM_BYTES, s>>>(static_cast<const __nv_bfloat16*>(x), r, o,
                                            static_cast<const __nv_bfloat16*>(gate_up),
                                            static_cast<__nv_bfloat16*>(h), F, D, stride_gu);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  moe_down_kernel<<<dn, THREADS, SMEM_BYTES, s>>>(static_cast<const __nv_bfloat16*>(h), o,
                                         static_cast<const __nv_bfloat16*>(down), ws,
                                         static_cast<float*>(y), D, F, stride_down);
  return (int)cudaGetLastError();
}

const char* b2t_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
