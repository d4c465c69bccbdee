// One GRU layer's backward (reverse-time) recurrence for Hopper (sm_90a),
// bound with ctypes.
//
// Replaces the Pallas kernel `_gru_bwd_kernel` (b2txt_tpu/ops/pallas/gru.py:122,
// launched by `_gru_bwd_call`, :217). Same arithmetic, same rounding points.
// For t = T-1 down to 0, with h_{t-1} = out[:, t-1] (h0 at t = 0):
//   hh = h_{t-1} . W_hh^T + b_hh                 (products summed in f32)
//   r, z, n rematerialized as in the forward     (no gates are stored)
//   g  = g_out[:, t] + dh                        (dh carried in f32)
//   dz = g * (h_{t-1} - n) * z * (1 - z)
//   dn = g * (1 - z) * (1 - n^2),  dr = dn * hn * r * (1 - r)
//   dxp[:, t]  = [dr, dz, dn]      rounded to the compute type
//   dpre[:, t] = [dr, dz, dn * r]  rounded to the compute type
//   dh = g * z + dpre[:, t] . W_hh               (products summed in f32)
// and dh0 = dh after step 0. dW_hh and db_hh are one contraction of dpre with
// h_{t-1} over (B, T), done outside the kernel by torch.matmul, as the JAX
// package leaves it to XLA.
//
// What bounds it. As in the forward, the T steps are serially dependent, and
// each step is two (B, H) x (H, 3H)-sized products: the gate
// rematerialization and dh's product with W_hh. At the training shape
// (B=64, T=125, H=768) that is 57 GFLOP and ~90 MB of traffic per layer,
// tens of microseconds against the card's peaks; the floor is the chain of
// T steps, each with one grid-wide barrier, and the products on CUDA cores.
//
// Design: one cooperative, persistent launch per layer
// (cudaLaunchCooperativeKernel). CTA c owns hidden units [c*U, c*U+U). It
// keeps in shared memory, for the whole launch:
//   - the 3U rows of W_hh that feed its units (rows j, H+j, 2H+j), for the
//     rematerialization, as the forward kernel does;
//   - the 3H x U column slice W_hh[:, own units], for dh;
//   - dh and g*z for its units and every batch row, in f32.
// Each step has two phases around one grid barrier:
//   (1) stage h_{t-1} in tiles of BC batch rows x KC columns (read-only
//       here: `out` was written by the forward launch); thread (b, u) forms
//       its unit's three dot products, the gates, g, dr/dz/dn, and writes
//       dxp[b, t] and dpre[b, t] for its unit;
//   (2) after the barrier every CTA has written its part of dpre[:, t]; the
//       CTA stages the full rows in tiles, read through L2 only
//       (ld.global.cg: L1 is not coherent across SMs), and forms
//       dh[b, own units] = g*z + dpre[b, t] . W_hh[:, own units].
// Step t-1's phase 1 writes dpre[:, t-1], never the row that phase 2 of step
// t reads, and uses only the CTA's own dh, so one barrier per step suffices.
// At H=768, U=8 the grid is 96 CTAs of 256 threads; the host side checks
// co-residency and refuses the launch if the grid does not fit. Products run
// on the CUDA cores (f32 FMA), not the tensor cores: simple and exact first.
//
// Shared memory: (3U*S1 + U*S3 + BC*SK) elements + (2*B*U + 3U) floats,
// S1 ~ H, S3 ~ 3H, SK = KC + one 16-byte vector: 185 KB at H=768, B=64 in
// f32, 95 KB in bf16. It caps H at ~800 in f32 and ~1,600 in bf16; a larger
// request is refused (cudaFuncSetAttribute fails), never run partly.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int U = 8;             // hidden units per CTA
constexpr int BC = 32;           // batch rows per tile
constexpr int KC = 256;          // contraction columns per tile (elements)
constexpr int THREADS = U * BC;  // thread (bl, u) = (tid / U, tid % U)

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype(bfloat16)
}

// Loads that bypass L1: dpre is written by other CTAs during the launch.
__device__ __forceinline__ float load_cg(const float* p) { return __ldcg(p); }
__device__ __forceinline__ __nv_bfloat16 load_cg(const __nv_bfloat16* p) {
  return __ushort_as_bfloat16(__ldcg(reinterpret_cast<const unsigned short*>(p)));
}

// 16-byte vectors of the compute type, unpacked to f32.
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void unpack(const uint4& v, float* f) {
    f[0] = __uint_as_float(v.x); f[1] = __uint_as_float(v.y);
    f[2] = __uint_as_float(v.z); f[3] = __uint_as_float(v.w);
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void unpack(const uint4& v, float* f) {
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float2 q = __bfloat1622float2(p[i]);
      f[2 * i] = q.x;
      f[2 * i + 1] = q.y;
    }
  }
};

__device__ __forceinline__ float sigmoidf(float x) { return 1.0f / (1.0f + expf(-x)); }

// xp (B, T, 3H), w (3H, H), bias (3H), h0 (B, H), out (B, T, H),
// gout (B, T, H), ghf (B, H) f32 -> dxp, dpre (B, T, 3H), dh0 (B, H) f32.
// Hp, H3p: H and 3H rounded up to Vec<T>::N; S1, S3, SK: shared row strides.
template <typename T>
__global__ void __launch_bounds__(THREADS)
gru_bwd_kernel(const T* __restrict__ xp, const T* __restrict__ w,
               const T* __restrict__ bias, const T* __restrict__ h0,
               const T* __restrict__ out, const T* __restrict__ gout,
               const float* __restrict__ ghf, T* __restrict__ dxp, T* dpre,
               float* __restrict__ dh0, int B, int Tn, int H, int Hp, int H3p,
               int S1, int S3, int SK) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* wr = reinterpret_cast<T*>(smem_raw);              // [3U][S1] W_hh rows
  T* wc = wr + 3 * U * S1;                             // [U][S3] W_hh columns
  T* tile = wc + U * S3;                               // [BC][SK] staging
  float* bs = reinterpret_cast<float*>(tile + BC * SK);  // [3U] b_hh
  float* dhs = bs + 3 * U;                             // [B][U] dh carry
  float* gzs = dhs + (size_t)B * U;                    // [B][U] g * z

  const int tid = threadIdx.x;
  const int j0 = blockIdx.x * U;
  const int H3 = 3 * H;
  const T zero = from_f<T>(0.0f);

  for (int i = tid; i < 3 * U * S1; i += THREADS) {
    const int r = i / S1, k = i % S1;
    const int g = r / U, j = j0 + r % U;
    wr[i] = (k < H && j < H) ? w[(size_t)(g * H + j) * H + k] : zero;
  }
  for (int i = tid; i < U * S3; i += THREADS) {  // i = m * U + uu: coalesced reads
    const int m = i / U, uu = i % U, j = j0 + uu;
    wc[uu * S3 + m] = (m < H3 && j < H) ? w[(size_t)m * H + j] : zero;
  }
  if (tid < 3 * U) {
    const int g = tid / U, j = j0 + tid % U;
    bs[tid] = j < H ? to_f(bias[g * H + j]) : 0.0f;
  }
  for (int i = tid; i < B * U; i += THREADS) {
    const int b = i / U, j = j0 + i % U;
    dhs[i] = j < H ? ghf[(size_t)b * H + j] : 0.0f;
  }
  __syncthreads();

  const int u = tid % U, bl = tid / U, j = j0 + u;
  constexpr int N = Vec<T>::N;
  cg::grid_group grid = cg::this_grid();

  for (int t = Tn - 1; t >= 0; --t) {
    // h_{t-1}[b, k] = hsrc[b * hstride + k]
    const T* hsrc = t == 0 ? h0 : out + (size_t)(t - 1) * H;
    const size_t hstride = t == 0 ? (size_t)H : (size_t)Tn * H;

    // Phase 1: rematerialize the gates, write dxp[:, t] and dpre[:, t].
    for (int b0 = 0; b0 < B; b0 += BC) {
      const int nb = min(BC, B - b0);
      float ar = 0.0f, az = 0.0f, an = 0.0f;
      for (int k0 = 0; k0 < Hp; k0 += KC) {
        const int kc = min(KC, Hp - k0);
        for (int i = tid; i < nb * kc; i += THREADS) {
          const int r = i / kc, k = i % kc, kk = k0 + k;
          tile[r * SK + k] = kk < H ? hsrc[(size_t)(b0 + r) * hstride + kk] : zero;
        }
        __syncthreads();
        if (bl < nb && j < H) {
          const T* hrow = tile + bl * SK;
          const T* wrr = wr + u * S1 + k0;
          const T* wrz = wr + (U + u) * S1 + k0;
          const T* wrn = wr + (2 * U + u) * S1 + k0;
          for (int k = 0; k < kc; k += N) {
            float hv[N], vr[N], vz[N], vn[N];
            Vec<T>::unpack(*reinterpret_cast<const uint4*>(hrow + k), hv);
            Vec<T>::unpack(*reinterpret_cast<const uint4*>(wrr + k), vr);
            Vec<T>::unpack(*reinterpret_cast<const uint4*>(wrz + k), vz);
            Vec<T>::unpack(*reinterpret_cast<const uint4*>(wrn + k), vn);
#pragma unroll
            for (int q = 0; q < N; ++q) {
              ar = fmaf(hv[q], vr[q], ar);
              az = fmaf(hv[q], vz[q], az);
              an = fmaf(hv[q], vn[q], an);
            }
          }
        }
        __syncthreads();  // the next tile overwrites `tile`
      }
      if (bl < nb && j < H) {
        const int b = b0 + bl;
        const size_t row = (size_t)b * Tn + t;
        const T* xrow = xp + row * H3;
        const float hp = to_f(hsrc[(size_t)b * hstride + j]);
        const float hn = an + bs[2 * U + u];
        const float rg = sigmoidf(to_f(xrow[j]) + (ar + bs[u]));
        const float zg = sigmoidf(to_f(xrow[H + j]) + (az + bs[U + u]));
        const float ng = tanhf(to_f(xrow[2 * H + j]) + rg * hn);
        const float g = to_f(gout[row * H + j]) + dhs[b * U + u];
        const float dz = g * (hp - ng) * zg * (1.0f - zg);
        const float dn = g * (1.0f - zg) * (1.0f - ng * ng);
        const float dr = dn * hn * rg * (1.0f - rg);
        T* dxrow = dxp + row * H3;
        dxrow[j] = from_f<T>(dr);
        dxrow[H + j] = from_f<T>(dz);
        dxrow[2 * H + j] = from_f<T>(dn);
        T* dprow = dpre + row * H3;
        dprow[j] = from_f<T>(dr);
        dprow[H + j] = from_f<T>(dz);
        dprow[2 * H + j] = from_f<T>(dn * rg);
        gzs[b * U + u] = g * zg;
      }
    }
    grid.sync();  // dpre[:, t] is complete before any CTA reads it

    // Phase 2: dh[b, own units] = g*z + dpre[b, t] . W_hh[:, own units].
    for (int b0 = 0; b0 < B; b0 += BC) {
      const int nb = min(BC, B - b0);
      float acc = 0.0f;
      for (int m0 = 0; m0 < H3p; m0 += KC) {
        const int mc = min(KC, H3p - m0);
        for (int i = tid; i < nb * mc; i += THREADS) {
          const int r = i / mc, m = i % mc, mm = m0 + m;
          tile[r * SK + m] =
              mm < H3 ? load_cg(dpre + ((size_t)(b0 + r) * Tn + t) * H3 + mm) : zero;
        }
        __syncthreads();
        if (bl < nb && j < H) {
          const T* drow = tile + bl * SK;
          const T* wcu = wc + u * S3 + m0;
          for (int m = 0; m < mc; m += N) {
            float dv[N], wv[N];
            Vec<T>::unpack(*reinterpret_cast<const uint4*>(drow + m), dv);
            Vec<T>::unpack(*reinterpret_cast<const uint4*>(wcu + m), wv);
#pragma unroll
            for (int q = 0; q < N; ++q) acc = fmaf(dv[q], wv[q], acc);
          }
        }
        __syncthreads();
      }
      if (bl < nb && j < H) {
        const int b = b0 + bl;
        dhs[b * U + u] = gzs[b * U + u] + acc;
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < B * U; i += THREADS) {
    const int b = i / U, jj = j0 + i % U;
    if (jj < H) dh0[(size_t)b * H + jj] = dhs[i];
  }
}

template <typename T>
int launch(const void* xp, const void* w, const void* bias, const void* h0,
           const void* out, const void* gout, const void* ghf, void* dxp, void* dpre,
           void* dh0, int B, int Tn, int H, cudaStream_t stream) {
  constexpr int N = Vec<T>::N;
  int Hp = (H + N - 1) / N * N;
  int H3p = (3 * H + N - 1) / N * N;
  int S1 = Hp + N;  // +16 B per row: the 8 W rows a quarter-warp reads hit distinct banks
  int S3 = H3p + N;
  int SK = KC + N;
  size_t smem = (size_t)(3 * U * S1 + U * S3 + BC * SK) * sizeof(T) +
                (size_t)(2 * (size_t)B * U + 3 * U) * sizeof(float);
  auto* kernel = gru_bwd_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;

  int dev = 0, n_sm = 0, per_sm = 0, coop = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev)) != cudaSuccess)
    return (int)err;
  if (!coop) return (int)cudaErrorNotSupported;
  if ((err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem)) !=
      cudaSuccess)
    return (int)err;
  int grid = (H + U - 1) / U;
  if ((long long)per_sm * n_sm < grid) return (int)cudaErrorCooperativeLaunchTooLarge;

  const T* xp_ = static_cast<const T*>(xp);
  const T* w_ = static_cast<const T*>(w);
  const T* b_ = static_cast<const T*>(bias);
  const T* h0_ = static_cast<const T*>(h0);
  const T* out_ = static_cast<const T*>(out);
  const T* gout_ = static_cast<const T*>(gout);
  const float* ghf_ = static_cast<const float*>(ghf);
  T* dxp_ = static_cast<T*>(dxp);
  T* dpre_ = static_cast<T*>(dpre);
  float* dh0_ = static_cast<float*>(dh0);
  void* args[] = {(void*)&xp_,  (void*)&w_,    (void*)&b_,   (void*)&h0_, (void*)&out_,
                  (void*)&gout_, (void*)&ghf_, (void*)&dxp_, (void*)&dpre_, (void*)&dh0_,
                  (void*)&B,    (void*)&Tn,    (void*)&H,    (void*)&Hp,  (void*)&H3p,
                  (void*)&S1,   (void*)&S3,    (void*)&SK};
  err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(grid), dim3(THREADS), args,
                                    smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (every tensor but g_hf and dh0, which are
// float32). Returns a cudaError_t (0 = launched).
int b2t_gru_bwd(const void* xp, const void* w_hh, const void* b_hh, const void* h0,
                const void* out, const void* g_out, const void* g_hf, void* dxp,
                void* dpre, void* dh0, int B, int T, int H, int dtype, void* stream) {
  if (B < 1 || T < 1 || H < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(xp, w_hh, b_hh, h0, out, g_out, g_hf, dxp, dpre, dh0, B, T, H, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(xp, w_hh, b_hh, h0, out, g_out, g_hf, dxp, dpre, dh0, B, T,
                                 H, s);
  return (int)cudaErrorInvalidValue;
}

const char* b2t_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
