// Fused augmentation + smoothing for Hopper (sm_90a), bound with ctypes.
//
// Replaces the Pallas kernel `fused_preprocess` -> `_make_kernel`
// (b2txt_tpu/ops/pallas/preprocess.py:109 / :51, launched at :166). Per batch
// row b it computes, for input rows t of (B, T, C) float32:
//   v[t] = (t < T - cut ? x[t + cut] : 0) + white*Nw[t] + offset*No + cumsum_c(walk*Nk[t])
// (the random cut read from a device integer, each add only if its std is
// > 0), then the truncated Gaussian smoothing with 'same' zero padding:
//   out[t] = sum_k tap[k] * v[t + k - K/2]   (v = 0 outside [0, T)).
// The static gain (a per-row C x C product) stays in PyTorch before the call.
//
// What bounds it: bytes. One read of x and one write of out, 8 bytes per
// element (16 with the normals passed in): 0.0407 ms at (64, 520, 512) on
// 3.35 TB/s. With the noise drawn here, the issue of a quarter of a Philox
// call and half a Box-Muller pair (logf, sqrtf, sincosf) per element and
// noise takes about as long again (chip_smoke.py times the kernel with and
// without the noise).
//
// Design:
// - A CTA owns a chunk of TT output rows (TT ~ 64, so its K - 1 halo rows add
//   <= 15% at K = 9) of one batch row and a slab of channels: 128 without the
//   walk (channels are independent), all C <= 1024 with it (the walk is a
//   cumsum along channels). Its 8 warps form 8 noisy input rows at a time,
//   one row a warp, lane l taking the 4-channel groups l, l + 32, ... (16-byte
//   loads where C % 4 == 0; each load is in flight while its lane draws the
//   noise), into a ring of shared-memory rows; then every thread applies the
//   K taps to the rows in the ring and writes each output element once. So
//   every noisy input element is formed once and its noise drawn once.
// - The ring holds the last NSLOT >= 8 + K - 1 input rows (a power of two),
//   so forming 8 new rows never overwrites a row the next 8 outputs read; two
//   __syncthreads per 8 rows.
// - The walk is a second pass over each row, scanned once: per group a 4-wide
//   prefix of the increments, a warp scan of the lanes' sums by shuffles, a
//   carry across groups. It is a function of its own (`add_walk`): inlined,
//   the row loop's registers live across sincosf's large-argument call, and
//   ptxas spills them.
// - The noise comes from a counter-based Philox4x32-10, so the plain version
//   (ops/preprocess.py `philox_noise`) reproduces it: stream s (0 white,
//   1 offset, 2 walk), element e ((b*T + t)*C + c, or b*C + c for the offset),
//   counter (j mod 2^32, j >> 32, s, 0) with j = e >> 2, key (seed, 0); the
//   normal is word e & 3 of Box-Muller on the word pairs (0, 1) and (2, 3):
//   u = (2*(w >> 9) + 1) * 2^-24, r = sqrtf(-2 logf(u_a)), theta = 6.2831855f*u_b,
//   n_a = r cos(theta), n_b = r sin(theta). The offset normals are drawn once
//   per CTA. Full-precision logf/sincosf (no fast math).
// - Or the normals are passed in, (B, 2T+1, C): white rows [row_white,
//   row_white + T), the offset row, walk rows [row_walk, row_walk + T).
// - The adds run as separate rounded products and sums (__fmul_rn, __fadd_rn)
//   and the taps as tap1*v, then fmaf(tap0, ., .), then taps 2.. K-1, each an
//   fmaf: the plain version's order, so without noise the two agree bit for
//   bit but for a double-rounding tie.
// The kernel allocates nothing and runs on the caller's stream.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int ROWS_PER_STEP = WARPS;  // input rows formed per step, one per warp
constexpr int MAX_TAPS = 16;
constexpr int SLAB = 128;             // channels per CTA without the walk
constexpr int MAX_WALK_C = 1024;      // channels per CTA with it: 8 groups a lane
constexpr int CHUNK = 64;             // output rows per CTA, at most

enum Flags { WHITE = 1, OFFSET = 2, WALK = 4, NOISE_IN = 8 };

struct Params {
  const float* x;          // (B, T, C)
  const float* noise;      // (B, NR, C) or null: Philox normals
  const long long* cut;    // 0-d device integer, or null: no cut
  float* out;              // (B, T, C)
  int T, C, NR, row_white, row_offset, row_walk, flags;
  int K, TT, n_chunks, n_slabs, cw, slot_mask;  // cw: channels a CTA holds (row stride)
  unsigned seed;
  float white_std, offset_std, walk_std;
  float taps[MAX_TAPS];
  bool vec;                // C % 4 == 0 and x, out, noise 16-byte aligned
};

__device__ __forceinline__ uint4 philox4x32_10(unsigned long long j, uint32_t stream,
                                               uint32_t seed) {
  uint32_t c0 = (uint32_t)j, c1 = (uint32_t)(j >> 32), c2 = stream, c3 = 0;
  uint32_t k0 = seed, k1 = 0;
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    if (i) k0 += 0x9E3779B9u, k1 += 0xBB67AE85u;
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
  }
  return make_uint4(c0, c1, c2, c3);
}

// An odd multiple of 2^-24 in (0, 1): exact in float32, never 0 or 1.
__device__ __forceinline__ float uniform(uint32_t w) {
  return (float)(2u * (w >> 9) + 1u) * 5.9604644775390625e-8f;
}

// The four normals of counter j.
__device__ __forceinline__ float4 normals4(unsigned long long j, uint32_t stream, uint32_t seed) {
  const uint4 w = philox4x32_10(j, stream, seed);
  const float r0 = sqrtf(-2.0f * logf(uniform(w.x))), th0 = 6.2831855f * uniform(w.y);
  const float r1 = sqrtf(-2.0f * logf(uniform(w.z))), th1 = 6.2831855f * uniform(w.w);
  float s0, c0, s1, c1;
  sincosf(th0, &s0, &c0);
  sincosf(th1, &s1, &c1);
  return make_float4(r0 * c0, r0 * s0, r1 * c1, r1 * s1);
}

__device__ __forceinline__ float lane_of(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// The normals of elements e0 .. e0 + 3 of a stream.
__device__ __forceinline__ float4 normals_at(unsigned long long e0, uint32_t stream,
                                             uint32_t seed) {
  const float4 a = normals4(e0 >> 2, stream, seed);
  const int s = (int)(e0 & 3);
  if (s == 0) return a;
  const float4 b = normals4((e0 >> 2) + 1, stream, seed);
  float n[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) n[i] = s + i < 4 ? lane_of(a, s + i) : lane_of(b, s + i - 4);
  return make_float4(n[0], n[1], n[2], n[3]);
}

// p[0 .. n), n <= 4; the rest 0.
__device__ __forceinline__ float4 load4(const float* p, int n, bool vec) {
  if (vec && n == 4) return __ldg(reinterpret_cast<const float4*>(p));
  float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (n > 0) v.x = __ldg(p);
  if (n > 1) v.y = __ldg(p + 1);
  if (n > 2) v.z = __ldg(p + 2);
  if (n > 3) v.w = __ldg(p + 3);
  return v;
}

__device__ __forceinline__ void store4(float* p, float4 v, int n, bool vec) {
  if (vec && n == 4) {
    *reinterpret_cast<float4*>(p) = v;
    return;
  }
  if (n > 0) p[0] = v.x;
  if (n > 1) p[1] = v.y;
  if (n > 2) p[2] = v.z;
  if (n > 3) p[3] = v.w;
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y), __fadd_rn(a.z, b.z),
                     __fadd_rn(a.w, b.w));
}
__device__ __forceinline__ float4 scale4(float s, float4 a) {
  return make_float4(__fmul_rn(s, a.x), __fmul_rn(s, a.y), __fmul_rn(s, a.z), __fmul_rn(s, a.w));
}

// Inclusive sum over the warp's lanes, in lane order.
__device__ __forceinline__ float warp_inclusive_sum(float v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v = __fadd_rn(v, u);
  }
  return v;
}

// Adds the walk, cumsum along channels of walk_std * N_walk, to input row r
// of this CTA (row: its ring row, G groups, cw channels from c_base; e_row:
// the element index of its first channel). A whole warp calls it.
__device__ __noinline__ void add_walk(const Params& p, float4* row, int G, int cw, int c_base,
                                      int b, int r, unsigned long long e_row, bool noise_in) {
  const int lane = threadIdx.x & 31, C = p.C;
  float carry = 0.0f;
  for (int g0 = 0; g0 < G; g0 += 32) {
    const int q = g0 + lane, n = q < G ? min(4, cw - 4 * q) : 0;
    float4 inc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (n > 0) {
      inc = noise_in
                ? load4(p.noise + ((size_t)b * p.NR + p.row_walk + r) * C + c_base + 4 * q, n, p.vec)
                : normals_at(e_row + 4 * q, 2, p.seed);
      inc = scale4(p.walk_std, inc);
      if (n < 4) inc.w = 0.0f;
      if (n < 3) inc.z = 0.0f;
      if (n < 2) inc.y = 0.0f;
    }
    inc.y = __fadd_rn(inc.x, inc.y);
    inc.z = __fadd_rn(inc.y, inc.z);
    inc.w = __fadd_rn(inc.z, inc.w);
    const float incl = warp_inclusive_sum(inc.w);
    float before = __shfl_up_sync(0xffffffffu, incl, 1);
    before = __fadd_rn(carry, lane == 0 ? 0.0f : before);
    carry = __fadd_rn(carry, __shfl_sync(0xffffffffu, incl, 31));
    if (n > 0)
      row[q] = add4(row[q], make_float4(__fadd_rn(before, inc.x), __fadd_rn(before, inc.y),
                                        __fadd_rn(before, inc.z), __fadd_rn(before, inc.w)));
  }
}

template <bool WALK_ON>
__global__ void __launch_bounds__(THREADS)
preprocess_kernel(const __grid_constant__ Params p) {
  extern __shared__ float4 smem4[];
  const int GS = (p.cw + 3) / 4;             // 4-channel groups a ring row holds
  float4* ring = smem4;                       // [slot_mask + 1][GS]
  float4* s_off = smem4 + (size_t)(p.slot_mask + 1) * GS;  // [GS]: offset_std * N_offset

  int blk = blockIdx.x;
  const int slab = blk % p.n_slabs;
  blk /= p.n_slabs;
  const int chunk = blk % p.n_chunks;
  const int b = blk / p.n_chunks;
  const int c_base = slab * p.cw;
  const int cw = min(p.cw, p.C - c_base);    // channels of this CTA (the last slab may be narrower)
  const int G = (cw + 3) / 4;
  const int T = p.T, C = p.C, K = p.K, half = K / 2;
  const int t_out0 = chunk * p.TT;
  const int n_out = min(p.TT, T - t_out0);
  const int r_begin = t_out0 - half;          // first input row of the chunk
  const int r_end = t_out0 + n_out - half + K - 1;
  const int cut = p.cut ? (int)*p.cut : 0;
  const bool noise_in = p.flags & NOISE_IN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // the offset normals of this CTA's channels, drawn once
  for (int q = tid; q < G; q += THREADS) {
    const int c = c_base + 4 * q, n = min(4, cw - 4 * q);
    float4 o = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (p.flags & OFFSET) {
      o = noise_in ? load4(p.noise + ((size_t)b * p.NR + p.row_offset) * C + c, n, p.vec)
                   : normals_at((unsigned long long)b * C + c, 1, p.seed);
      o = scale4(p.offset_std, o);
    }
    s_off[q] = o;
  }
  __syncthreads();

  int done = t_out0;  // outputs [t_out0, done) are written
  for (int base = r_begin; base < r_end; base += ROWS_PER_STEP) {
    // form input row r = base + warp into its ring slot
    const int r = base + warp;
    if (r < r_end) {
      float4* row = ring + (size_t)((r - r_begin) & p.slot_mask) * GS;
      const bool inside = r >= 0 && r < T;
      const bool has_x = r < T - cut;
      const unsigned long long e_row = ((unsigned long long)b * T + r) * C + c_base;
      for (int q = lane; q < G; q += 32) {
        const int c = c_base + 4 * q, n = min(4, cw - 4 * q);
        float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (inside) {
          if (has_x) v = load4(p.x + ((size_t)b * T + r + cut) * C + c, n, p.vec);
          if (p.flags & WHITE) {
            const float4 w =
                noise_in ? load4(p.noise + ((size_t)b * p.NR + p.row_white + r) * C + c, n, p.vec)
                         : normals_at(e_row + 4 * q, 0, p.seed);
            v = add4(v, scale4(p.white_std, w));
          }
          if (p.flags & OFFSET) v = add4(v, s_off[q]);
        }
        row[q] = v;
      }
      if (WALK_ON && inside) add_walk(p, row, G, cw, c_base, b, r, e_row, noise_in);
    }
    __syncthreads();

    // outputs whose K input rows are all in the ring
    const int upto = min(t_out0 + n_out, min(base + ROWS_PER_STEP, r_end) - K + 1 + half);
    const int n_o = upto - done;
    for (int it = tid; it < n_o * G; it += THREADS) {
      const int o = done + it / G, q = it % G;
      const int s0 = o - half - r_begin;     // ring row of tap 0
      const float4* r0 = ring + q;
      auto at = [&](int k) { return r0[(size_t)((s0 + k) & p.slot_mask) * GS]; };
      float4 acc;
      if (K == 1) {
        acc = scale4(p.taps[0], at(0));
      } else {
        acc = scale4(p.taps[1], at(1));
        float4 v = at(0);
        acc = make_float4(fmaf(p.taps[0], v.x, acc.x), fmaf(p.taps[0], v.y, acc.y),
                          fmaf(p.taps[0], v.z, acc.z), fmaf(p.taps[0], v.w, acc.w));
#pragma unroll
        for (int k = 2; k < MAX_TAPS; ++k) {
          if (k >= K) break;
          v = at(k);
          const float w = p.taps[k];
          acc = make_float4(fmaf(w, v.x, acc.x), fmaf(w, v.y, acc.y), fmaf(w, v.z, acc.z),
                            fmaf(w, v.w, acc.w));
        }
      }
      store4(p.out + ((size_t)b * T + o) * C + c_base + 4 * q, acc, min(4, cw - 4 * q), p.vec);
    }
    done = max(done, upto);
    __syncthreads();  // the next rows overwrite slots these outputs read
  }
}

}  // namespace

extern "C" {

// x, out (B, T, C) float32; noise (B, NR, C) float32 or null (Philox normals
// keyed by seed); cut a device int64 or null; flags: 1 white, 2 offset, 4 walk
// (along channels, C <= 1024), 8 normals passed in; taps: K <= 16 host floats
// (passed to the kernel by value). Returns a cudaError_t (0 = launched).
int b2t_preprocess(const void* x, const void* noise, const void* cut, void* out, const void* taps,
                   int B, int T, int C, int NR, int row_white, int row_offset, int row_walk,
                   int flags, int K, int seed, float white_std, float offset_std, float walk_std,
                   void* stream) {
  if (B < 0 || T < 0 || C < 0 || K < 1 || K > MAX_TAPS) return (int)cudaErrorInvalidValue;
  if ((flags & NOISE_IN) && !noise) return (int)cudaErrorInvalidValue;
  const bool walk = flags & WALK;
  if (walk && C > MAX_WALK_C) return (int)cudaErrorInvalidValue;
  if (B == 0 || T == 0 || C == 0) return 0;
  Params p;
  p.x = static_cast<const float*>(x);
  p.noise = static_cast<const float*>(noise);
  p.cut = static_cast<const long long*>(cut);
  p.out = static_cast<float*>(out);
  p.T = T, p.C = C, p.NR = NR;
  p.row_white = row_white, p.row_offset = row_offset, p.row_walk = row_walk, p.flags = flags;
  p.K = K;
  p.n_chunks = (T + CHUNK - 1) / CHUNK;
  p.TT = (T + p.n_chunks - 1) / p.n_chunks;
  p.cw = walk ? C : (C < SLAB ? C : SLAB);
  p.n_slabs = (C + p.cw - 1) / p.cw;
  int slots = 1;
  while (slots < ROWS_PER_STEP + K - 1) slots <<= 1;
  p.slot_mask = slots - 1;
  p.seed = (unsigned)seed;
  p.white_std = white_std, p.offset_std = offset_std, p.walk_std = walk_std;
  for (int k = 0; k < MAX_TAPS; ++k) p.taps[k] = k < K ? static_cast<const float*>(taps)[k] : 0.0f;
  auto aligned = [](const void* q) { return (reinterpret_cast<uintptr_t>(q) & 15) == 0; };
  p.vec = C % 4 == 0 && aligned(x) && aligned(out) && (!noise || aligned(noise));

  const long long grid = (long long)B * p.n_chunks * p.n_slabs;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const int G = (p.cw + 3) / 4;
  const size_t smem = (size_t)(slots + 1) * G * sizeof(float4);
  auto* kernel = walk ? preprocess_kernel<true> : preprocess_kernel<false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

const char* b2t_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
