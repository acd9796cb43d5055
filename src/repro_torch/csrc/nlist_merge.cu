// PrePost+ N-list merge with early stopping, and the Z-merge scatter, for
// Hopper (sm_90a).
//
// nl_merge_kernel replaces the TPU kernel src/repro/kernels/nlist_merge.py::
// nlist_merge (body `_kernel`) together with the operand gather and the
// Z-merge group count that ops._nlist_presize_impl wraps around it.
// zmerge_scatter_kernel replaces ref._nl_zmerge_scatter, which is jnp in
// the JAX package (no Pallas kernel): it backs ops.nlist_scatter.
// Semantics are pinned by repro_torch/kernels/ref.py::nlist_presize_ref and
// nlist_scatter_ref, bit for bit.
//
// The merge is a data-dependent sequential walk, and its comparison and
// check counts must equal the sequential merge's (the oracle-exact counter
// rule), so the design is one thread per pair, 128 pairs to a CTA.  Each
// thread reads the (pre, post, freq) triples straight from the pool slab
// at u_off + i / v_off + j (no (P, L) gather is materialised), records the
// V index each U code matched in its out_slot row, and keeps z_mass, skip,
// comparisons and checks in registers.  With early stopping the guard
// z_mass + (rho_V - skip) >= minsup is evaluated after every step, exactly
// as the Pallas loop does; without it the guard is never evaluated.  The
// CTA first fills its 128 out_slot rows with the sentinel together
// (coalesced), then each thread walks its pair.  child_len comes out of
// the same walk: out_slot is non-decreasing over matched slots, so a match
// whose j differs from the previous match's starts a Z-merge group
// (ref._nl_group_starts).
//
// The scatter is one thread per pair as well: it walks its out_slot row,
// sums the U frequencies of each group, takes the representative V code's
// pre/post and writes child triple g at out_off + g, for destinations
// inside [0, cap) only (out_off >= cap marks a non-survivor).
//
// What bounds them: neither bytes nor operations.  The merge moves
// 12 bytes per code it visits plus the out_slot row it must write
// (P x lu x 4 bytes), but each thread's walk is a chain of dependent loads
// with no coalescing across the warp, so it runs at memory latency, not
// bandwidth.  Known slack, left for later work: a warp per pair (merge
// path partition of both lists, then a scan to recover the sequential
// counts) and staging each V list in shared memory.
//
// C interface (ctypes): pointers and the stream are void*, sizes int or
// long long; each entry returns cudaGetLastError() after its launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int32_t kSentinel = 0x7fffffff;

__device__ __forceinline__ const int32_t* code_at(const int32_t* codes, int64_t cap,
                                                  int64_t idx) {
  idx = idx < 0 ? 0 : (idx >= cap ? cap - 1 : idx);
  return codes + 3 * idx;
}

__global__ void __launch_bounds__(kThreads)
nl_merge_kernel(const int32_t* __restrict__ codes, int64_t cap,
                const int32_t* __restrict__ u_off, const int32_t* __restrict__ u_len,
                const int32_t* __restrict__ v_off, const int32_t* __restrict__ v_len,
                const int32_t* __restrict__ rho_v, int64_t n_pairs, int64_t lu,
                int minsup, int early_stop, int32_t* __restrict__ out_slot,
                int32_t* __restrict__ child_len, int32_t* __restrict__ support,
                int32_t* __restrict__ cmps_out, int32_t* __restrict__ checks_out,
                uint8_t* __restrict__ alive_out) {
  const int64_t p0 = static_cast<int64_t>(blockIdx.x) * kThreads;
  const int64_t rows_here = n_pairs - p0 < kThreads ? n_pairs - p0 : kThreads;
  int32_t* cta_rows = out_slot + p0 * lu;
  for (int64_t w = threadIdx.x; w < rows_here * lu; w += kThreads) cta_rows[w] = kSentinel;
  __syncthreads();

  const int64_t p = p0 + threadIdx.x;
  if (p >= n_pairs) return;
  const int nu = u_len[p], nv = v_len[p];
  const int64_t uo = u_off[p], vo = v_off[p];
  const int rho = rho_v[p];
  int32_t* slot = out_slot + p * lu;

  int i = 0, j = 0, z_mass = 0, skip = 0, cmps = 0, checks = 0;
  int groups = 0, last_j = -1;
  bool alive = true;
  while (i < nu && j < nv && alive) {
    ++cmps;
    const int32_t* x = code_at(codes, cap, uo + i);
    const int32_t* y = code_at(codes, cap, vo + j);
    const int x_pre = x[0], y_pre = y[0];
    const bool is_desc = x_pre > y_pre && x[1] < y[1];
    const bool adv = is_desc || x_pre <= y_pre;
    if (is_desc) {
      if (i < lu) slot[i] = j;
      z_mass += x[2];
      if (j != last_j) {
        ++groups;
        last_j = j;
      }
    }
    if (!adv) {
      skip += y[2];
      ++checks;
    }
    if (early_stop) alive = z_mass + (rho - skip) >= minsup;
    if (adv) ++i; else ++j;
  }
  child_len[p] = groups;
  support[p] = alive ? z_mass : 0;  // aborted => certified < minsup
  cmps_out[p] = cmps;
  checks_out[p] = checks;
  alive_out[p] = alive ? 1 : 0;
}

__global__ void __launch_bounds__(kThreads)
zmerge_scatter_kernel(int32_t* codes, int64_t cap, const int32_t* __restrict__ out_slot,
                      int64_t lu, const int32_t* __restrict__ u_off,
                      const int32_t* __restrict__ u_len, const int32_t* __restrict__ v_off,
                      const int32_t* __restrict__ v_len, const int32_t* __restrict__ out_off,
                      int64_t n_pairs, int32_t* __restrict__ child_len) {
  const int64_t p = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (p >= n_pairs) return;
  const int32_t* slot = out_slot + p * lu;
  const int nu = u_len[p], nv = v_len[p];
  const int64_t uo = u_off[p], vo = v_off[p], base = out_off[p];

  // One group: the representative V slot `rep` and the summed U mass.
  auto flush = [&](int64_t g, int rep, int freq) {
    const int64_t dest = base + g;
    if (dest < 0 || dest >= cap) return;
    const int32_t* y = code_at(codes, cap, vo + rep);
    const bool in_v = rep < nv;
    int32_t* out = codes + 3 * dest;
    out[0] = in_v ? y[0] : kSentinel;
    out[1] = in_v ? y[1] : 0;
    out[2] = freq;
  };

  int64_t g = -1;
  int running = -1, rep = 0, freq = 0;
  for (int64_t i = 0; i < lu; ++i) {
    const int s = slot[i];
    if (s == kSentinel) continue;
    if (s != running) {  // a group starts where the slot passes the running max
      if (g >= 0) flush(g, rep, freq);
      ++g;
      rep = s;
      freq = 0;
    }
    running = s > running ? s : running;
    if (i < nu) freq += code_at(codes, cap, uo + i)[2];
  }
  if (g >= 0) flush(g, rep, freq);
  child_len[p] = static_cast<int32_t>(g + 1);
}

unsigned grid_for(long long n_pairs) {
  return static_cast<unsigned>((n_pairs + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" int repro_nlist_merge(const void* codes, long long cap, const void* u_off,
                                 const void* u_len, const void* v_off, const void* v_len,
                                 const void* rho_v, long long n_pairs, long long lu,
                                 int minsup, int early_stop, void* out_slot,
                                 void* child_len, void* support, void* cmps,
                                 void* checks, void* alive, void* stream) {
  nl_merge_kernel<<<grid_for(n_pairs), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(codes), cap, static_cast<const int32_t*>(u_off),
      static_cast<const int32_t*>(u_len), static_cast<const int32_t*>(v_off),
      static_cast<const int32_t*>(v_len), static_cast<const int32_t*>(rho_v), n_pairs, lu,
      minsup, early_stop, static_cast<int32_t*>(out_slot), static_cast<int32_t*>(child_len),
      static_cast<int32_t*>(support), static_cast<int32_t*>(cmps),
      static_cast<int32_t*>(checks), static_cast<uint8_t*>(alive));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_zmerge_scatter(void* codes, long long cap, const void* out_slot,
                                    long long lu, const void* u_off, const void* u_len,
                                    const void* v_off, const void* v_len,
                                    const void* out_off, long long n_pairs,
                                    void* child_len, void* stream) {
  zmerge_scatter_kernel<<<grid_for(n_pairs), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<int32_t*>(codes), cap, static_cast<const int32_t*>(out_slot), lu,
      static_cast<const int32_t*>(u_off), static_cast<const int32_t*>(u_len),
      static_cast<const int32_t*>(v_off), static_cast<const int32_t*>(v_len),
      static_cast<const int32_t*>(out_off), n_pairs, static_cast<int32_t*>(child_len));
  return static_cast<int>(cudaGetLastError());
}
