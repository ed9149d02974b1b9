// scaled_sum on Hopper: int32 sum(x * scale) with int32 wraparound.
//
// Replaces the Pallas TPU kernel alluxio_tpu/ops/reduce_kernel.py:51
// (scaled_sum, body _kernel at :38), the warm-tier scan of the device data
// plane. The TPU kernel streams (rows, 1024) tiles through VMEM on a
// sequential grid and accumulates into one SMEM scalar. Hopper's blocks
// run in parallel and in no order, so here every thread keeps its own
// partial, the block reduces its partials, and one atomicAdd per block
// lands in the output.
//
// Bound: memory. The kernel reads 4*n bytes once and does ~2 integer ops
// per 4 bytes, so the card's device-memory rate is the limit (H100 SXM:
// 3.35 TB/s). The design does what a streaming read needs: 16-byte loads
// (int4) with neighbouring threads on neighbouring addresses, UNROLL
// independent loads in flight per thread, a grid-stride loop over a grid
// sized to a few blocks per SM, and no second pass over the data.
//
// Exactness: arithmetic is in uint32_t, where overflow wraps (no signed
// overflow UB). Addition and multiplication mod 2^32 are associative and
// commutative, so the result is bit-exact int32 wraparound whatever the
// order in which blocks finish.
//
// `scale` is a DEVICE pointer: the caller's chain computes the next scale
// on the device, and a host scalar would force a sync per call.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;

__device__ __forceinline__ uint32_t warp_sum(uint32_t v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

__global__ void __launch_bounds__(kThreads)
scaled_sum_kernel(const int4* __restrict__ x4, long long n4,
                  const int32_t* __restrict__ x, long long n,
                  const int32_t* __restrict__ scale,
                  uint32_t* __restrict__ out) {
  const uint32_t s = static_cast<uint32_t>(__ldg(scale));
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  uint32_t acc = 0;

  // vector body: kUnroll independent 16-byte loads in flight per thread
  for (long long base = tid; base < n4; base += stride * kUnroll) {
    int4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long j = base + u * stride;
      v[u] = j < n4 ? __ldg(x4 + j) : make_int4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      acc += static_cast<uint32_t>(v[u].x) * s;
      acc += static_cast<uint32_t>(v[u].y) * s;
      acc += static_cast<uint32_t>(v[u].z) * s;
      acc += static_cast<uint32_t>(v[u].w) * s;
    }
  }
  // scalar tail (elements past the last full int4, or all of x when the
  // pointer is not 16-byte aligned and n4 is 0)
  for (long long j = n4 * 4 + tid; j < n; j += stride) {
    acc += static_cast<uint32_t>(__ldg(x + j)) * s;
  }

  // warp -> block -> one atomic per block
  __shared__ uint32_t warp_part[kThreads / 32];
  acc = warp_sum(acc);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_part[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    acc = lane < kThreads / 32 ? warp_part[lane] : 0u;
    acc = warp_sum(acc);
    if (lane == 0) atomicAdd(out, acc);
  }
}

}  // namespace

// C entry point bound with ctypes. `out` must hold 0 (the wrapper zeroes
// it); every block adds its partial into it. Launches on `stream` and
// returns cudaGetLastError() (0 = launched). Allocates nothing and does
// not synchronise. `max_blocks` caps the grid (a few blocks per SM).
extern "C" int atpu_scaled_sum(const int32_t* x, long long n,
                               const int32_t* scale, int32_t* out,
                               int max_blocks, cudaStream_t stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const bool aligned = (reinterpret_cast<uintptr_t>(x) & 15u) == 0;
  const long long n4 = aligned ? n / 4 : 0;
  const long long work = n4 > 0 ? n4 : n;
  const long long per_block = static_cast<long long>(kThreads) * kUnroll;
  long long blocks = (work + per_block - 1) / per_block;
  if (blocks > max_blocks) blocks = max_blocks;
  if (blocks < 1) blocks = 1;
  scaled_sum_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      reinterpret_cast<const int4*>(x), n4, x, n, scale,
      reinterpret_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
