// EmbeddingBag (fused gather + masked sum or mean), for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/segment_embed.py::embedding_bag
// (its `_kernel`): out[b] = sum over slots j with mask[b, j] != 0 of
// table[ids[b, j]], divided for "mean" by max(count, 1) with the count kept
// as a float, as the Pallas kernel keeps it (an all-masked bag gives zeros).
// The (B, L, D) gathered tensor never exists.  table is fp32 (V, D), ids
// int32 (B, L), mask int32 or bool (B, L), out fp32 (B, D).
//
// What bounds it: memory, and at small batches latency.  Each valid slot
// reads one D-float row (1 KB at D = 256) and does D adds, so the bound is
// the bytes of ids, mask, the rows that valid slots name, and the output.
// Every design below walks a bag's valid slots in order, so each element's
// sum is taken in the plain version's order (bit-equal to it); a masked
// slot's row is never read; row offsets are 64-bit (id * D passes 2^31 past
// 8.4 M rows at D = 256).  Two designs, chosen by batch size:
// - Large batches (enough bags to give every SM 32 warps, one bag each):
//   throughput.  One warp per bag, lanes across D with 16-byte loads, the
//   slots walked one by one; the many warps in flight hide the latency,
//   and the few registers keep every SM full.
// - Small batches (512 bags at D = 256 make 64 such CTAs: half the SMs
//   idle, ~100 dependent round trips per warp): latency.  A warp owns one
//   bag and 32 consecutive 16-byte columns (D = 256: two warps per bag),
//   CTAs of 4 warps.  It loads the bag's ids and mask once, 64 slots at a
//   time with coalesced loads into two registers per lane, counts the valid
//   slots with __ballot_sync / __popc, takes them in slot order with
//   __shfl_sync, and issues the row loads of kBatch valid slots before
//   adding any of them: a bag of 50 slots costs a few round trips.
//
// C interface (ctypes): pointers and the stream are void*; returns
// cudaGetLastError() after the launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBatch = 8;  // row loads in flight per warp (small batches)

__device__ __forceinline__ void add(float4& a, const float4& x) {
  a.x += x.x;
  a.y += x.y;
  a.z += x.z;
  a.w += x.w;
}
__device__ __forceinline__ void add(float& a, float x) { a += x; }
__device__ __forceinline__ float4 zero(float4) { return make_float4(0.f, 0.f, 0.f, 0.f); }
__device__ __forceinline__ float zero(float) { return 0.f; }
__device__ __forceinline__ float4 divide(float4 a, float c) {
  return make_float4(a.x / c, a.y / c, a.z / c, a.w / c);
}
__device__ __forceinline__ float divide(float a, float c) { return a / c; }

// Vec = float4 (D % 4 == 0, 16-byte aligned table and out) or float.
// M = int32_t or uint8_t (bool) mask.

// Large batches: warp w of the grid owns bag w and walks its slots.
template <typename Vec, typename M, int kWarps>
__global__ void __launch_bounds__(32 * kWarps)
bag_slots_kernel(const Vec* __restrict__ table, const int32_t* __restrict__ ids,
                 const M* __restrict__ mask, Vec* __restrict__ out, int64_t n_rows, int64_t B,
                 int L, int64_t row_vecs, int mean) {
  const int lane = threadIdx.x % 32;
  const int64_t bag = int64_t(blockIdx.x) * kWarps + threadIdx.x / 32;
  if (bag >= B) return;
  const int32_t* bag_ids = ids + bag * L;
  const M* bag_mask = mask + bag * L;
  float cnt = 0.f;
  for (int j = 0; j < L; ++j) cnt += bag_mask[j] != 0 ? 1.f : 0.f;
  const float denom = fmaxf(cnt, 1.f);
  Vec* out_row = out + bag * row_vecs;
  for (int64_t c = lane; c < row_vecs; c += 32) {
    Vec acc = zero(Vec{});
#pragma unroll 4
    for (int j = 0; j < L; ++j) {
      const int64_t id = bag_ids[j];
      // Ids outside [0, V) on a valid slot are the caller's error; no row
      // outside the table is ever read.
      if (bag_mask[j] != 0 && id >= 0 && id < n_rows) add(acc, table[id * row_vecs + c]);
    }
    out_row[c] = mean ? divide(acc, denom) : acc;
  }
}

// Small batches: warp w of the grid owns bag w / col_blocks and the 32 Vec
// columns starting at (w % col_blocks) * 32.
template <typename Vec, typename M, int kWarps>
__global__ void __launch_bounds__(32 * kWarps)
bag_batched_kernel(const Vec* __restrict__ table, const int32_t* __restrict__ ids,
                   const M* __restrict__ mask, Vec* __restrict__ out, int64_t n_rows, int64_t B,
                   int L, int64_t row_vecs, int64_t col_blocks, int mean) {
  const int lane = threadIdx.x % 32;
  const int64_t w = int64_t(blockIdx.x) * kWarps + threadIdx.x / 32;
  const int64_t bag = w / col_blocks;
  if (bag >= B) return;  // whole warps leave together
  const int64_t c = (w % col_blocks) * 32 + lane;
  const bool col_ok = c < row_vecs;  // idle lanes still take part in the shuffles
  const int32_t* bag_ids = ids + bag * L;
  const M* bag_mask = mask + bag * L;
  Vec acc = zero(Vec{});
  int cnt = 0;
  for (int base = 0; base < L; base += 64) {
    // Slots base + lane and base + 32 + lane, loaded once.
    const int j0 = base + lane, j1 = base + 32 + lane;
    const int32_t id0 = j0 < L ? bag_ids[j0] : 0, id1 = j1 < L ? bag_ids[j1] : 0;
    const bool ok0 = j0 < L && bag_mask[j0] != 0, ok1 = j1 < L && bag_mask[j1] != 0;
    uint64_t valid = uint64_t(__ballot_sync(0xffffffffu, ok0)) |
                     (uint64_t(__ballot_sync(0xffffffffu, ok1)) << 32);
    cnt += __popcll(valid);
    while (valid) {  // warp-uniform
      Vec rows[kBatch];
      int n = 0;
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        if (valid) {
          const int p = __ffsll(static_cast<long long>(valid)) - 1;
          valid &= valid - 1;
          const int id_lo = __shfl_sync(0xffffffffu, id0, p & 31);
          const int id_hi = __shfl_sync(0xffffffffu, id1, p & 31);
          const int64_t id = p < 32 ? id_lo : id_hi;
          // As above; such a slot adds zero here.
          rows[i] = col_ok && id >= 0 && id < n_rows ? __ldg(&table[id * row_vecs + c])
                                                     : zero(Vec{});
          n = i + 1;
        }
      }
#pragma unroll
      for (int i = 0; i < kBatch; ++i)
        if (i < n) add(acc, rows[i]);
    }
  }
  if (col_ok) out[bag * row_vecs + c] = mean ? divide(acc, fmaxf(float(cnt), 1.f)) : acc;
}

template <typename Vec, typename M>
void launch(const void* table, const void* ids, const void* mask, void* out, int64_t V, int64_t B,
            int L, int64_t row_vecs, int mean, cudaStream_t st) {
  const auto* t = static_cast<const Vec*>(table);
  const auto* i = static_cast<const int32_t*>(ids);
  const auto* m = static_cast<const M*>(mask);
  auto* o = static_cast<Vec*>(out);
  if (B >= 132 * 32) {  // one bag per warp already gives the 132 SMs 32 warps each
    constexpr int kWarps = 8;
    const int64_t grid = (B + kWarps - 1) / kWarps;
    bag_slots_kernel<Vec, M, kWarps><<<static_cast<unsigned>(grid), 32 * kWarps, 0, st>>>(
        t, i, m, o, V, B, L, row_vecs, mean);
  } else {
    constexpr int kWarps = 4;
    const int64_t col_blocks = (row_vecs + 31) / 32;
    const int64_t grid = (B * col_blocks + kWarps - 1) / kWarps;
    bag_batched_kernel<Vec, M, kWarps><<<static_cast<unsigned>(grid), 32 * kWarps, 0, st>>>(
        t, i, m, o, V, B, L, row_vecs, col_blocks, mean);
  }
}

template <typename M>
void dispatch(const void* table, const void* ids, const void* mask, void* out, int64_t V,
              int64_t B, int L, int64_t D, int mean, cudaStream_t st) {
  const bool vec4 = D % 4 == 0 && reinterpret_cast<uintptr_t>(table) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (vec4)
    launch<float4, M>(table, ids, mask, out, V, B, L, D / 4, mean, st);
  else
    launch<float, M>(table, ids, mask, out, V, B, L, D, mean, st);
}

}  // namespace

// mask_bytes: 4 = int32 mask, 1 = bool mask.  mean: 1 = "mean", 0 = "sum".
extern "C" int repro_embedding_bag(const void* table, const void* ids, const void* mask,
                                   void* out, long long V, long long D, long long B, int L,
                                   int mask_bytes, int mean, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || D <= 0) return static_cast<int>(cudaGetLastError());
  if (L < 0 || (mask_bytes != 1 && mask_bytes != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  if (mask_bytes == 4)
    dispatch<int32_t>(table, ids, mask, out, V, B, L, D, mean, st);
  else
    dispatch<uint8_t>(table, ids, mask, out, V, B, L, D, mean, st);
  return static_cast<int>(cudaGetLastError());
}
