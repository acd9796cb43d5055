// EmbeddingBag (fused gather + masked sum or mean), for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/segment_embed.py::embedding_bag
// (its `_kernel`): out[b] = sum over slots j with mask[b, j] != 0 of
// table[ids[b, j]], divided for "mean" by max(count, 1) with the count kept
// as a float, as the Pallas kernel keeps it (an all-masked bag gives zeros).
// The (B, L, D) gathered tensor never exists.  table is fp32 (V, D), ids
// int32 (B, L), mask int32 or bool (B, L), out fp32 (B, D).
//
// What bounds it: memory.  Each valid slot reads one D-float row (1 KB at
// D = 256) and does D adds, so the bound is the bytes of ids, mask, the
// rows that valid slots name, and the output.  What the design does about
// it: one warp per bag; its lanes span D with 16-byte loads (D = 256 is two
// float4 per lane), so every row is read with whole 512-byte warp
// transactions, and the rows of one bag are independent loads the warp
// keeps in flight.  The slots are walked in order, so each element's sum is
// taken in the plain version's order; a masked slot's row is never read.
// Row offsets are 64-bit: id * D passes 2^31 past 8.4 M rows at D = 256.
//
// C interface (ctypes): pointers and the stream are void*; returns
// cudaGetLastError() after the launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;

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
template <typename Vec, typename M>
__global__ void __launch_bounds__(kThreads)
embedding_bag_kernel(const Vec* __restrict__ table, const int32_t* __restrict__ ids,
                     const M* __restrict__ mask, Vec* __restrict__ out, int64_t n_rows,
                     int64_t B, int L, int64_t row_vecs, int mean) {
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

template <typename Vec, typename M>
void launch(const void* table, const void* ids, const void* mask, void* out, int64_t V, int64_t B,
            int L, int64_t row_vecs, int mean, cudaStream_t st) {
  const int64_t grid = (B + kWarps - 1) / kWarps;
  embedding_bag_kernel<Vec, M><<<static_cast<unsigned>(grid), kThreads, 0, st>>>(
      static_cast<const Vec*>(table), static_cast<const int32_t*>(ids),
      static_cast<const M*>(mask), static_cast<Vec*>(out), V, B, L, row_vecs, mean);
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
