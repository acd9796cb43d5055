// Row-store compaction gather, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/compact.py::compact_gather:
// out[i] = slab[perm[i]] for 0 <= perm[i] < cap, zeros elsewhere.  The
// semantics follow repro_torch/kernels/ref.py::compact_gather_ref, which
// zero-fills perm[i] >= cap as the jnp ref does (the Pallas kernel instead
// clips such entries to cap - 1 and copies that row).
//
// What bounds it: memory bandwidth, nothing else — it reads the live rows
// once and writes every destination row once.  The design moves 16 bytes
// per thread per step when the row's byte length and both base pointers
// allow it (4 bytes otherwise), with neighbouring threads on neighbouring
// addresses.  One CTA per destination row (a grid-stride loop past 2^20
// rows), so no thread divides.  It serves any 4-byte element type: rows,
// suffix tables and codes alike.
//
// C interface (ctypes): pointers and the stream are void*, sizes are
// long long; returns cudaGetLastError() after the launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const T* __restrict__ slab, const int32_t* __restrict__ perm,
                   T* __restrict__ out, int64_t cap, int64_t n_out, int64_t row_vecs) {
  for (int64_t i = blockIdx.x; i < n_out; i += gridDim.x) {
    const int64_t src = perm[i];
    T* dst = out + i * row_vecs;
    if (src >= 0 && src < cap) {
      const T* s = slab + src * row_vecs;
      for (int64_t j = threadIdx.x; j < row_vecs; j += kThreads) dst[j] = s[j];
    } else {
      const T zero{};
      for (int64_t j = threadIdx.x; j < row_vecs; j += kThreads) dst[j] = zero;
    }
  }
}

template <typename T>
void launch(const void* slab, const void* perm, void* out, int64_t cap, int64_t n_out,
            int64_t row_vecs, cudaStream_t stream) {
  const int64_t grid = n_out < (1 << 20) ? n_out : (1 << 20);
  gather_rows_kernel<T><<<static_cast<unsigned>(grid), kThreads, 0, stream>>>(
      static_cast<const T*>(slab), static_cast<const int32_t*>(perm), static_cast<T*>(out),
      cap, n_out, row_vecs);
}

}  // namespace

extern "C" int repro_compact_gather(const void* slab, const void* perm, void* out,
                                    long long cap, long long n_out, long long row_bytes,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_out <= 0 || row_bytes <= 0) return static_cast<int>(cudaGetLastError());
  const bool vec16 = row_bytes % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(slab) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (vec16)
    launch<int4>(slab, perm, out, cap, n_out, row_bytes / 16, st);
  else
    launch<int32_t>(slab, perm, out, cap, n_out, row_bytes / 4, st);
  return static_cast<int>(cudaGetLastError());
}
