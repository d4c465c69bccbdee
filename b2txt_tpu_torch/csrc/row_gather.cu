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
// latency has to be covered by many rows in flight.
//
// Design: the TPU's DMA ring moves into shared memory, filled and drained by
// the tensor memory accelerator's 1-D bulk copies, so no row passes through
// registers and W costs shared memory (W x row bytes), not registers.
// - The grid does not follow W: rows are split evenly over max(number of
//   SMs, ceil(g / W)) CTAs, at most g, so every SM works at every W and W
//   bounds only what one CTA keeps in flight (at most W rows a CTA).
// - A CTA first loads its rows' indices into shared memory (the TPU kernel's
//   scalar prefetch), then keeps a ring of S = min(W, its rows) row slots.
//   One thread owns each slot and its mbarrier, and walks rows s, s + S, ...:
//   a bulk load `cp.async.bulk.shared::cluster.global.mbarrier::complete_tx`
//   of the row into the slot, a wait on the slot's mbarrier, a bulk store
//   `cp.async.bulk.global.shared::cta.bulk_group` of the slot to the output
//   row, and `cp.async.bulk.wait_group.read` before the slot is refilled. One
//   thread a slot, so the S copies are issued in parallel; the slots are
//   dealt over up to 4 warps (slot s to lane s / warps of warp s % warps),
//   which issue side by side: one warp issuing all of a CTA's slots was
//   slower than `table[idx]` at W >= 32 on the H100.
// - No bounds check inside the kernel, as in the TPU kernel. The caller's
//   contract: 0 <= idx[i] < rows for every i; rw % 4 == 0 (rows of a 16-byte
//   multiple, which bulk copies need); table, idx and out contiguous, 16-byte
//   aligned and on the current device; W x (row bytes + 12) within a CTA's
//   shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int MAX_SMEM = 232448;  // a CTA's shared memory on Hopper (227 KB)

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__global__ void row_gather_kernel(const char* __restrict__ table, const int* __restrict__ idx,
                                  char* __restrict__ out, long long g, int grid, int row_bytes,
                                  int slots) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + (size_t)slots * row_bytes);
  int* s_idx = reinterpret_cast<int*>(bars + slots);
  const long long r0 = (long long)blockIdx.x * g / grid;
  const int n_rows = (int)((long long)(blockIdx.x + 1) * g / grid - r0);
  const int s = (threadIdx.x & 31) * (blockDim.x / 32) + (threadIdx.x >> 5);  // slot

  for (int i = threadIdx.x; i < n_rows; i += blockDim.x) s_idx[i] = idx[r0 + i];
  if (s < slots) asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(&bars[s])));
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  __syncthreads();
  if (s >= slots) return;

  const unsigned slot = smem_addr(smem + (size_t)s * row_bytes), bar = smem_addr(&bars[s]);
  uint32_t phase = 0;
  for (int k = s; k < n_rows; k += slots, phase ^= 1) {
    if (k != s) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
                 "r"(row_bytes)
                 : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
            "r"(slot),
        "l"(table + (size_t)s_idx[k] * row_bytes), "r"(row_bytes), "r"(bar)
        : "memory");
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "WAIT:\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
        "@!p bra WAIT;\n"
        "}\n" ::"r"(bar),
        "r"(phase)
        : "memory");
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
                     out + (size_t)(r0 + k) * row_bytes),
                 "r"(slot), "r"(row_bytes)
                 : "memory");
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  }
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

}  // namespace

extern "C" {

// table (rows, rw) int32, idx (g,) int32, out (g, rw) int32; rw % 4 == 0;
// in_flight: rows each CTA keeps in flight, 1, 8, 32 or 128.
// Returns a cudaError_t (0 = launched).
int b2t_row_gather(const void* table, const void* idx, void* out, int g, int rw, int in_flight,
                   void* stream) {
  if (g < 0 || rw < 4 || rw % 4 != 0) return (int)cudaErrorInvalidValue;
  if (in_flight != 1 && in_flight != 8 && in_flight != 32 && in_flight != 128)
    return (int)cudaErrorInvalidValue;
  const long long row_bytes = 4LL * rw;
  if ((long long)in_flight * (row_bytes + 12) > MAX_SMEM) return (int)cudaErrorInvalidValue;
  if (g == 0) return 0;
  int dev = 0, n_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long by_ring = ((long long)g + in_flight - 1) / in_flight;
  const int grid = (int)std::min<long long>(g, std::max<long long>(n_sm, by_ring));
  const int rows_max = (int)(((long long)g + grid - 1) / grid);  // rows of the largest CTA
  const int slots = std::min(in_flight, rows_max);
  const size_t smem = (size_t)slots * (row_bytes + 8) + (size_t)rows_max * 4;
  err = cudaFuncSetAttribute(row_gather_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = 32 * std::min(4, slots);
  row_gather_kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const char*>(table), static_cast<const int*>(idx), static_cast<char*>(out), g,
      grid, (int)row_bytes, slots);
  return (int)cudaGetLastError();
}

const char* b2t_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
