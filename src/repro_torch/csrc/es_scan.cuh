// Blocked bitmap scan with early stopping, for Hopper (sm_90a): the device
// code shared by the ES-scan kernel (bitmap_intersect.cu, kDiff = false)
// and the dEclat difference kernel (bitmap_diff.cu, kDiff = true).  Each
// source instantiates the template behind its own C entry point.
//
// One CTA walks one pair's blocks in order, reading the operand rows
// straight from the row-store slab through ua[p]/vb[p] (U and V are never
// materialised), reduces each block's popcount across the CTA, and
// evaluates the ES bound uniformly so the whole CTA stops together at the
// first failing block.  Survival is known only at the end of the scan, so
// a survivor (which by definition scanned every block) makes a second
// pass over its row, last block first, writing the child row and
// accumulating its suffix table on the way; a non-survivor's slot and any
// slot outside [0, cap) are never written.  Child slots never alias
// operand rows within one launch (the row store hands out only free slots
// as children).
//
// kDiff = false: Z = U & V (or U & ~V with `andnot`), bound
//   count + min(su[k+1], sv[k+1]) ("and") or rho - count ("andnot"),
//   blocks_done = blocks visited.
// kDiff = true: Z = U & ~V on the bound rho - count; sv is not read;
//   blocks_done counts only visited blocks whose U mass su[k] - su[k+1]
//   is positive, and those are the only blocks whose words are read: a
//   zero-mass U block has Z = 0 and cannot change the count (its Z words
//   are still written as zeros).  This requires su to be U's suffix
//   table, which it always is on the mining path.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace repro {

constexpr int kScanThreads = 128;
constexpr int kScanWarps = kScanThreads / 32;

struct ScanArgs {
  const int32_t* U;      // rows of the U operands (slab or (P, nb, bw))
  const int32_t* V;
  const int32_t* su;     // suffix tables, (rows, nb + 1)
  const int32_t* sv;     // (not read when kDiff)
  const int32_t* ua;     // (P,) U row per pair, or null for row p
  const int32_t* vb;     // (P,) V row per pair, or null for row p
  const int32_t* rho;    // (P,) parent support ("andnot"/diff bound)
  int n_pairs, nb, bw;
  int es_minsup;         // ES threshold; <= 0 disables early stopping
  int andnot;            // kDiff = false only: 0: Z = U & V; 1: Z = U & ~V
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
__device__ __forceinline__ int cta_sum(int v, int (*red)[kScanWarps], int buf) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  if ((threadIdx.x & 31) == 0) red[buf][threadIdx.x >> 5] = v;
  __syncthreads();
  int s = 0;
#pragma unroll
  for (int i = 0; i < kScanWarps; ++i) s += red[buf][i];
  return s;
}

template <bool kDiff>
__global__ void __launch_bounds__(kScanThreads) es_scan_kernel(ScanArgs a) {
  __shared__ int red[2][kScanWarps];
  const int p = blockIdx.x;
  const int64_t row_words = static_cast<int64_t>(a.nb) * a.bw;
  const int64_t iu = a.ua ? a.ua[p] : p;
  const int64_t iv = a.vb ? a.vb[p] : p;
  const int32_t* u = a.U + iu * row_words;
  const int32_t* v = a.V + iv * row_words;
  const int32_t* su = a.su + iu * (a.nb + 1);
  const int32_t* sv = kDiff ? nullptr : a.sv + iv * (a.nb + 1);
  const int rho = a.rho[p];
  const bool andnot = kDiff || a.andnot;
  const int32_t vflip = andnot ? -1 : 0;  // z = u & (v ^ vflip)
  int32_t* z = a.Z ? a.Z + static_cast<int64_t>(p) * row_words : nullptr;

  // Every thread holds the same cnt/alive (cta_sum broadcasts; the block
  // mass is read from one address), so the loop exit and every branch
  // below are uniform across the CTA.
  int cnt = 0, k = 0, it = 0, done = 0;
  bool alive = true;
  while (k < a.nb && alive) {
    const int64_t off = static_cast<int64_t>(k) * a.bw;
    if (!kDiff || su[k] - su[k + 1] > 0) {
      int local = 0;
      for (int w = threadIdx.x; w < a.bw; w += kScanThreads) {
        const int32_t zw = u[off + w] & (v[off + w] ^ vflip);
        local += __popc(zw);
        if (z) z[off + w] = zw;
      }
      cnt += cta_sum(local, red, it++ & 1);
      ++done;
    } else if (z) {
      for (int w = threadIdx.x; w < a.bw; w += kScanThreads) z[off + w] = 0;
    }
    ++k;
    const int bound = andnot ? rho - cnt : cnt + min(su[k], sv[k]);
    alive = bound >= a.es_minsup;
  }
  if (z) {  // blocks past the abort read back as zero
    for (int64_t i = static_cast<int64_t>(k) * a.bw + threadIdx.x; i < row_words;
         i += kScanThreads)
      z[i] = 0;
  }
  if (threadIdx.x == 0) {
    a.cnt[p] = cnt;
    a.blocks[p] = done;
    a.alive[p] = alive ? 1 : 0;
  }
  if (!a.child_rows) return;

  const int support = andnot ? rho - cnt : cnt;
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
    if (!kDiff || su[kk] - su[kk + 1] > 0) {
      int local = 0;
      for (int w = threadIdx.x; w < a.bw; w += kScanThreads) {
        const int32_t zw = u[off + w] & (v[off + w] ^ vflip);
        local += __popc(zw);
        out[off + w] = zw;
      }
      acc += cta_sum(local, red, it++ & 1);
    } else {
      for (int w = threadIdx.x; w < a.bw; w += kScanThreads) out[off + w] = 0;
    }
    if (threadIdx.x == 0) osuf[kk] = acc;
  }
}

inline ScanArgs make_scan_args(const void* U, const void* V, const void* su,
                               const void* sv, const void* ua, const void* vb,
                               const void* rho, int n_pairs, int nb, int bw,
                               int es_minsup, int andnot, void* Z, void* cnt,
                               void* blocks, void* alive, void* child_rows,
                               void* child_suffix, const void* slots, int cap,
                               int gate_minsup) {
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
  return a;
}

}  // namespace repro
