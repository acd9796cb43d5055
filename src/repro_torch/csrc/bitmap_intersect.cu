// Blocked bitmap intersection with early stopping, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/bitmap_intersect.py::
// bitmap_intersect_es (body `_kernel`), and the gather + survivor-only
// scatter that ops._screen_and_intersect_impl wraps around it.  Semantics
// are pinned by repro_torch/kernels/ref.py::_blocked_es_scan and
// screen_and_intersect_ref, bit for bit.
//
// What bounds it: memory bandwidth.  Per pair the scan reads
// 2 x blocks_done x bw x 4 bytes of operand rows (plus two suffix words
// per block) and a survivor writes its child row and suffix table; the
// arithmetic is one AND and one __popc per word.  The design's answer is
// the paper's: work that early stopping cuts is never read.  One CTA walks
// one pair's blocks in order, reading the operand rows straight from the
// row-store slab through ua[p]/vb[p] (U and V are never materialised),
// reduces each block's popcount across the CTA, and evaluates the ES
// bound uniformly so the whole CTA stops together at the first failing
// block.  Survival is known only at the end of the scan, so a survivor
// (which by definition scanned every block) makes a second pass over its
// row, last block first, writing the child row and accumulating its suffix
// table on the way; a non-survivor's slot and any slot outside [0, cap)
// are never written.  Child slots never alias operand rows within one
// launch (the row store hands out only free slots as children).
//
// Known slack, left for later work: with bw = 8 (the smoke/CLI shape) most
// of the 128 threads idle; scoring several blocks per warp is the fix.
//
// C interface (ctypes): every pointer and the stream are void*, counts
// are int; returns cudaGetLastError() after the launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

struct ScanArgs {
  const int32_t* U;      // rows of the U operands (slab or (P, nb, bw))
  const int32_t* V;
  const int32_t* su;     // suffix tables, (rows, nb + 1)
  const int32_t* sv;
  const int32_t* ua;     // (P,) U row per pair, or null for row p
  const int32_t* vb;     // (P,) V row per pair, or null for row p
  const int32_t* rho;    // (P,) parent support ("andnot" bound)
  int n_pairs, nb, bw;
  int es_minsup;         // ES threshold; <= 0 disables early stopping
  int andnot;            // 0: Z = U & V; 1: Z = U & ~V
  int32_t* Z;            // (P, nb, bw) output, or null
  int32_t* cnt;          // (P,)
  int32_t* blocks;       // (P,)
  uint8_t* alive;        // (P,) bool
  int32_t* child_rows;   // slab to scatter survivors into, or null
  int32_t* child_suffix; // its suffix slab (cap, nb + 1)
  const int32_t* slots;  // (P,) child slot per pair
  int cap;               // slab capacity: slots outside [0, cap) are skipped
  int gate_minsup;       // survivor gate (the real minsup, ES on or off)
};

// CTA-wide sum; every thread returns the total.  `buf` alternates between
// calls, so a fast warp can never overwrite partials still being read.
__device__ __forceinline__ int cta_sum(int v, int (*red)[kWarps], int buf) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  if ((threadIdx.x & 31) == 0) red[buf][threadIdx.x >> 5] = v;
  __syncthreads();
  int s = 0;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) s += red[buf][i];
  return s;
}

__global__ void __launch_bounds__(kThreads) es_scan_kernel(ScanArgs a) {
  __shared__ int red[2][kWarps];
  const int p = blockIdx.x;
  const int64_t row_words = static_cast<int64_t>(a.nb) * a.bw;
  const int64_t iu = a.ua ? a.ua[p] : p;
  const int64_t iv = a.vb ? a.vb[p] : p;
  const int32_t* u = a.U + iu * row_words;
  const int32_t* v = a.V + iv * row_words;
  const int32_t* su = a.su + iu * (a.nb + 1);
  const int32_t* sv = a.sv + iv * (a.nb + 1);
  const int rho = a.rho[p];
  const int32_t vflip = a.andnot ? -1 : 0;  // z = u & (v ^ vflip)
  int32_t* z = a.Z ? a.Z + static_cast<int64_t>(p) * row_words : nullptr;

  // Every thread holds the same cnt/alive (cta_sum broadcasts), so the
  // loop exit and every branch below are uniform across the CTA.
  int cnt = 0, k = 0, it = 0;
  bool alive = true;
  while (k < a.nb && alive) {
    const int64_t off = static_cast<int64_t>(k) * a.bw;
    int local = 0;
    for (int w = threadIdx.x; w < a.bw; w += kThreads) {
      const int32_t zw = u[off + w] & (v[off + w] ^ vflip);
      local += __popc(zw);
      if (z) z[off + w] = zw;
    }
    cnt += cta_sum(local, red, it++ & 1);
    ++k;
    const int bound = a.andnot ? rho - cnt : cnt + min(su[k], sv[k]);
    alive = bound >= a.es_minsup;
  }
  if (z) {  // blocks past the abort read back as zero
    for (int64_t i = static_cast<int64_t>(k) * a.bw + threadIdx.x; i < row_words;
         i += kThreads)
      z[i] = 0;
  }
  if (threadIdx.x == 0) {
    a.cnt[p] = cnt;
    a.blocks[p] = k;
    a.alive[p] = alive ? 1 : 0;
  }
  if (!a.child_rows) return;

  const int support = a.andnot ? rho - cnt : cnt;
  const int slot = a.slots[p];
  if (!alive || support < a.gate_minsup || slot < 0 || slot >= a.cap) return;

  // Survivor epilogue: recompute Z block by block, last block first, so
  // the suffix table accumulates as the row is written.
  int32_t* out = a.child_rows + static_cast<int64_t>(slot) * row_words;
  int32_t* osuf = a.child_suffix + static_cast<int64_t>(slot) * (a.nb + 1);
  if (threadIdx.x == 0) osuf[a.nb] = 0;
  int acc = 0;
  for (int kk = a.nb - 1; kk >= 0; --kk) {
    const int64_t off = static_cast<int64_t>(kk) * a.bw;
    int local = 0;
    for (int w = threadIdx.x; w < a.bw; w += kThreads) {
      const int32_t zw = u[off + w] & (v[off + w] ^ vflip);
      local += __popc(zw);
      out[off + w] = zw;
    }
    acc += cta_sum(local, red, it++ & 1);
    if (threadIdx.x == 0) osuf[kk] = acc;
  }
}

}  // namespace

extern "C" int repro_es_scan(const void* U, const void* V, const void* su,
                             const void* sv, const void* ua, const void* vb,
                             const void* rho, int n_pairs, int nb, int bw,
                             int es_minsup, int andnot, void* Z, void* cnt,
                             void* blocks, void* alive, void* child_rows,
                             void* child_suffix, const void* slots, int cap,
                             int gate_minsup, void* stream) {
  ScanArgs a;
  a.U = static_cast<const int32_t*>(U);
  a.V = static_cast<const int32_t*>(V);
  a.su = static_cast<const int32_t*>(su);
  a.sv = static_cast<const int32_t*>(sv);
  a.ua = static_cast<const int32_t*>(ua);
  a.vb = static_cast<const int32_t*>(vb);
  a.rho = static_cast<const int32_t*>(rho);
  a.n_pairs = n_pairs;
  a.nb = nb;
  a.bw = bw;
  a.es_minsup = es_minsup;
  a.andnot = andnot;
  a.Z = static_cast<int32_t*>(Z);
  a.cnt = static_cast<int32_t*>(cnt);
  a.blocks = static_cast<int32_t*>(blocks);
  a.alive = static_cast<uint8_t*>(alive);
  a.child_rows = static_cast<int32_t*>(child_rows);
  a.child_suffix = static_cast<int32_t*>(child_suffix);
  a.slots = static_cast<const int32_t*>(slots);
  a.cap = cap;
  a.gate_minsup = gate_minsup;
  es_scan_kernel<<<n_pairs, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
