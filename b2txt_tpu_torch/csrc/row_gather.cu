// Row gather for Hopper (sm_90a), bound with ctypes: out[i, :] = table[idx[i], :].
//
// Replaces the Pallas kernel `make_dma_gather` (scripts/profile_pallas_gather.py:47,
// launched at :78): one TPU core keeping a ring of W single-row async DMAs in
// flight, indices scalar-prefetched to SMEM. It answers whether a hand-written
// gather beats the framework's on the device beam search's access pattern:
// random single rows of n-gram buckets (256 B) and trie rows.
//
// What bounds it: bytes. Each gathered row is read once and written once,
// plus the indices: g*rw*4 + g*rw*4 + g*4 bytes over 3.35 TB/s; there is no
// arithmetic. The rows are random, so each one is its own few DRAM bursts and
// latency has to be covered by many loads in flight.
//
// Design (simple and right first):
// - Rows are rw int32 with rw % 4 == 0, copied as 16-byte vectors (int4).
//   A warp walks the (row, vector) pairs of its rows in order, lane l taking
//   every 32nd vector, so a 512 B row is exactly one warp-wide load and a
//   256 B bucket row is half a warp.
// - A block first loads its rows' indices into shared memory (the TPU
//   kernel's scalar prefetch), then each warp copies its own rows.
// - Each lane issues W independent 16-byte loads into registers before it
//   stores any of them: W * 512 B in flight per warp, i.e. W rows of 512 B
//   (the TPU ring's W DMAs) or 2W bucket rows of 256 B. W is a template
//   parameter, 1, 8, 32 or 128 (the values the gather profile and the
//   checks use); at 128 ptxas spills the register array to local memory,
//   which the build report shows.
// - No bounds check inside the kernel, as in the TPU kernel. The caller's
//   contract: 0 <= idx[i] < rows for every i; table, idx and out are
//   contiguous, 16-byte aligned and on the current device.
// cp.async or TMA rings that stage rows through shared memory are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;  // warps per block

template <int W>
__global__ void __launch_bounds__(WARPS * 32)
row_gather_kernel(const int4* __restrict__ table, const int* __restrict__ idx,
                  int4* __restrict__ out, long long g, int vpr, int rows_per_warp) {
  extern __shared__ int s_idx[];  // this block's row indices
  const int rows_per_block = rows_per_warp * WARPS;
  const long long r0 = (long long)blockIdx.x * rows_per_block;
  const int n_rows = (int)min((long long)rows_per_block, g - r0);
  for (int i = threadIdx.x; i < n_rows; i += blockDim.x) s_idx[i] = idx[r0 + i];
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wr0 = warp * rows_per_warp;  // the warp's first row within the block
  const int w_rows = max(0, min(rows_per_warp, n_rows - wr0));
  const int n_vec = w_rows * vpr;        // 16-byte vectors this warp copies
  for (int base = 0; base < n_vec; base += 32 * W) {
    int4 v[W];
#pragma unroll
    for (int j = 0; j < W; ++j) {
      const int c = base + j * 32 + lane;
      if (c < n_vec) {
        const int r = c / vpr;
        v[j] = __ldg(table + (size_t)s_idx[wr0 + r] * vpr + (c - r * vpr));
      }
    }
#pragma unroll
    for (int j = 0; j < W; ++j) {
      const int c = base + j * 32 + lane;
      if (c < n_vec) out[(size_t)(r0 + wr0) * vpr + c] = v[j];
    }
  }
}

template <int W>
int launch(const void* table, const void* idx, void* out, long long g, int vpr,
           cudaStream_t stream) {
  // one pass of W loads per lane covers a warp's rows when a row is at most
  // 32 vectors (512 B); longer rows take several passes
  const int rows_per_warp = (32 * W >= vpr) ? (32 * W) / vpr : 1;
  const int rows_per_block = rows_per_warp * WARPS;
  const size_t smem = (size_t)rows_per_block * sizeof(int);
  auto* kernel = row_gather_kernel<W>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long grid = (g + rows_per_block - 1) / rows_per_block;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  kernel<<<(unsigned)grid, WARPS * 32, smem, stream>>>(
      static_cast<const int4*>(table), static_cast<const int*>(idx),
      static_cast<int4*>(out), g, vpr, rows_per_warp);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// table (rows, rw) int32, idx (g,) int32, out (g, rw) int32; rw % 4 == 0;
// in_flight: 16-byte loads each lane keeps in flight, 1, 8, 32 or 128.
// Returns a cudaError_t (0 = launched).
int b2t_row_gather(const void* table, const void* idx, void* out, int g, int rw,
                   int in_flight, void* stream) {
  if (g < 0 || rw < 4 || rw % 4 != 0) return (int)cudaErrorInvalidValue;
  if (g == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int vpr = rw / 4;
  switch (in_flight) {
    case 1: return launch<1>(table, idx, out, g, vpr, s);
    case 8: return launch<8>(table, idx, out, g, vpr, s);
    case 32: return launch<32>(table, idx, out, g, vpr, s);
    case 128: return launch<128>(table, idx, out, g, vpr, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* b2t_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
