// Blocked bitmap intersection with early stopping, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/bitmap_intersect.py::
// bitmap_intersect_es (body `_kernel`), and the gather + survivor-only
// scatter that ops._screen_and_intersect_impl wraps around it.  Semantics
// are pinned by repro_torch/kernels/ref.py::_blocked_es_scan and
// screen_and_intersect_ref, bit for bit.  The device code lives in
// es_scan.cuh (es_scan_kernel<false>); its design is described there.
//
// What bounds it: bytes (one AND and one __popc a word), and on a naive
// walk the latency of the abort test between blocks; es_scan.cuh says how
// the stepped scan answers both.
//
// C interface (ctypes): every pointer and the stream are void*, counts
// are int; returns cudaGetLastError() after the launch.  `thr` is the
// optional per-pair threshold vector (null: es_minsup for every pair).

#include "es_scan.cuh"

extern "C" int repro_es_scan(const void* U, const void* V, const void* su,
                             const void* sv, const void* ua, const void* vb,
                             const void* rho, int n_pairs, int nb, int bw,
                             int es_minsup, const void* thr, int andnot,
                             void* Z, void* cnt,
                             void* blocks, void* alive, void* child_rows,
                             void* child_suffix, const void* slots, int cap,
                             int gate_minsup, void* stream) {
  const repro::ScanArgs a = repro::make_scan_args(
      U, V, su, sv, ua, vb, rho, n_pairs, nb, bw, es_minsup, thr, andnot, Z, cnt, blocks,
      alive, child_rows, child_suffix, slots, cap, gate_minsup);
  return repro::launch_scan<false>(a, static_cast<cudaStream_t>(stream));
}

// Warps the scan gives each pair at this shape (1 = a warp per pair).
extern "C" int repro_scan_warps(int n_pairs, int nb, int bw) {
  return repro::scan_warps_per_pair(n_pairs, nb, bw);
}

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
