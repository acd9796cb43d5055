// Level-1 suffix-popcount table of the bitmap row store, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package computes this table with jnp
// (src/repro/core/rowstore.py, ``suffix_popcounts(self.rows)`` on the
// device).  It was added so the row store's set-up builds the table on the
// card from the rows it has just uploaded, instead of on the host.  The
// semantics are repro_torch/core/bitmap.py::suffix_popcounts:
// suffix[i, k] = popcount of row i from block k onward, suffix[i, nbl] = 0,
// for the rows 0 <= i < n; rows past n are not touched.
//
// What bounds it: memory bandwidth.  It reads every word of the n rows once
// (the table it writes is 1/bw of that) and does one __popc per word.  The
// design: one CTA per row (a grid-stride loop past 2^20 rows) walks the
// row's blocks from the last one to the first, kChunk blocks at a time.  A
// chunk's blocks are contiguous, so the CTA reads them as one run of
// vectors (16-byte loads when the block length allows, 4-byte otherwise),
// neighbouring lanes on neighbouring addresses, each thread issuing kUnroll
// loads before it reduces any.  A warp's 32 vectors fall into whole blocks
// when a block holds a divisor of 32 vectors or a multiple of 32: lane
// groups of that width (or the warp) sum by xor shuffles and one lane adds
// the sum to the block's count in shared memory (every lane does, for any
// other block length).  A reverse inclusive scan over the chunk's counts
// (warp scans plus one scan of the warp totals) adds the sum of every later
// chunk, carried in a register, and writes the chunk's table entries.
// Shared memory is fixed (kChunk counts), so any block count fits.
//
// C interface (ctypes): pointers and the stream are void*; returns
// cudaGetLastError() after the launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = kThreads;    // blocks a CTA scans per step
constexpr int kUnroll = 8;          // loads a thread has in flight
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int popc(int4 v) {
  return __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w);
}

__device__ __forceinline__ int popc(int32_t v) { return __popc(v); }

// Vec: the load type; W: the lanes whose vectors share a block and are
// summed before one shared-memory add (1 where blocks do not tile a warp).
template <typename Vec, int W>
__global__ void __launch_bounds__(kThreads)
suffix_table_kernel(const Vec* __restrict__ rows, int32_t* __restrict__ suffix,
                    int64_t n, int nbl, int vpb) {
  __shared__ int s_cnt[kChunk];
  __shared__ int s_warp[kWarps];
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  for (int64_t i = blockIdx.x; i < n; i += gridDim.x) {
    const Vec* row = rows + i * static_cast<int64_t>(nbl) * vpb;
    int32_t* out = suffix + i * static_cast<int64_t>(nbl + 1);
    if (t == 0) out[nbl] = 0;
    int carry = 0;                  // popcount of the blocks past the chunk
    for (int hi = nbl; hi > 0; hi -= kChunk) {
      const int lo = hi > kChunk ? hi - kChunk : 0;
      const int c = hi - lo;
      const int total = c * vpb;    // vectors in the chunk
      const Vec* base = row + static_cast<int64_t>(lo) * vpb;
      s_cnt[t] = 0;
      __syncthreads();
      // Per-block counts.  The loop bound is uniform across the warp, so
      // every lane reaches the shuffles.
      for (int j0 = warp * 32; j0 < total; j0 += kUnroll * kThreads) {
        int x[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int j = j0 + u * kThreads + lane;
          x[u] = j < total ? popc(base[j]) : 0;
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
          for (int off = W / 2; off > 0; off >>= 1)
            x[u] += __shfl_xor_sync(kFull, x[u], off);
          const int j = j0 + u * kThreads + lane;
          if (lane % W == 0 && j < total) atomicAdd(&s_cnt[j / vpb], x[u]);
        }
      }
      __syncthreads();
      // Reverse inclusive scan: thread t takes block c - 1 - t.
      int x = t < c ? s_cnt[c - 1 - t] : 0;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(kFull, x, off);
        if (lane >= off) x += y;
      }
      if (lane == 31) s_warp[warp] = x;
      __syncthreads();
      if (warp == 0) {
        int w = lane < kWarps ? s_warp[lane] : 0;
#pragma unroll
        for (int off = 1; off < kWarps; off <<= 1) {
          const int y = __shfl_up_sync(kFull, w, off);
          if (lane >= off) w += y;
        }
        if (lane < kWarps) s_warp[lane] = w;
      }
      __syncthreads();
      if (warp > 0) x += s_warp[warp - 1];
      if (t < c) out[lo + c - 1 - t] = carry + x;
      carry += s_warp[kWarps - 1];
      __syncthreads();              // s_cnt and s_warp are reused
    }
  }
}

template <typename Vec, int W>
void launch(const void* rows, void* suffix, int64_t n, int nbl, int vpb,
            cudaStream_t stream) {
  const int64_t grid = n < (1 << 20) ? n : (1 << 20);
  suffix_table_kernel<Vec, W><<<static_cast<unsigned>(grid), kThreads, 0, stream>>>(
      static_cast<const Vec*>(rows), static_cast<int32_t*>(suffix), n, nbl, vpb);
}

template <typename Vec>
void launch_vec(const void* rows, void* suffix, int64_t n, int nbl, int vpb,
                cudaStream_t stream) {
  const int w = vpb > 0 && vpb < 32 && 32 % vpb == 0 ? vpb
                : vpb > 0 && vpb % 32 == 0           ? 32
                                                     : 1;
  switch (w) {
    case 2: launch<Vec, 2>(rows, suffix, n, nbl, vpb, stream); break;
    case 4: launch<Vec, 4>(rows, suffix, n, nbl, vpb, stream); break;
    case 8: launch<Vec, 8>(rows, suffix, n, nbl, vpb, stream); break;
    case 16: launch<Vec, 16>(rows, suffix, n, nbl, vpb, stream); break;
    case 32: launch<Vec, 32>(rows, suffix, n, nbl, vpb, stream); break;
    default: launch<Vec, 1>(rows, suffix, n, nbl, vpb, stream); break;
  }
}

}  // namespace

extern "C" int repro_suffix_table(const void* rows, void* suffix, long long n,
                                  int nbl, int bw, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  if (bw % 4 == 0 && reinterpret_cast<uintptr_t>(rows) % 16 == 0)
    launch_vec<int4>(rows, suffix, n, nbl, bw / 4, st);
  else
    launch_vec<int32_t>(rows, suffix, n, nbl, bw, st);
  return static_cast<int>(cudaGetLastError());
}
