// Blocked dEclat difference with early stopping and zero-block skipping,
// for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/bitmap_diff.py::bitmap_diff_es
// (body `_kernel`), and the gather + survivor-only scatter that
// ops._screen_and_diff_impl wraps around it.  Semantics are pinned by
// repro_torch/kernels/ref.py::_blocked_diff_scan and screen_and_diff_ref,
// bit for bit: Z = U & ~V, the pair dies when rho - count < minsup,
// blocks_done counts only the visited blocks whose U mass
// su[k] - su[k+1] is positive, and alive is published as its own output.
//
// The device code is es_scan_kernel<true> of es_scan.cuh, shared with the
// ES-scan kernel (its note gives the design: stepped loads, the abort
// found by a scan, a warp per pair or a few warps per pair when pairs are
// few, the survivor epilogue in the same steps).  What the diff
// instantiation changes: the bound is rho - count, no sv is read, and the
// kernel TAKES the zero-block skip -- a block whose U mass is zero is
// neither read nor counted (its Z words are written as zeros where a Z
// output is asked for).  That skip is the point of diffsets on dense
// data: deep diffset rows are mostly zero blocks.
//
// What bounds it: bytes -- the nonzero-mass operand blocks visited plus
// the U suffix words, and a survivor's child row and suffix table; the
// arithmetic is one ANDN and one __popc a word.
//
// C interface (ctypes): every pointer and the stream are void*, counts
// are int; returns cudaGetLastError() after the launch.  `thr` is the
// optional per-pair threshold vector (null: es_minsup for every pair).

#include "es_scan.cuh"

extern "C" int repro_diff_scan(const void* U, const void* V, const void* su,
                               const void* ua, const void* vb, const void* rho,
                               int n_pairs, int nb, int bw, int es_minsup,
                               const void* thr, void* Z,
                               void* cnt, void* blocks, void* alive, void* child_rows,
                               void* child_suffix, const void* slots, int cap,
                               int gate_minsup, void* stream) {
  const repro::ScanArgs a = repro::make_scan_args(
      U, V, su, nullptr, ua, vb, rho, n_pairs, nb, bw, es_minsup, thr, 1, Z, cnt, blocks,
      alive, child_rows, child_suffix, slots, cap, gate_minsup);
  return repro::launch_scan<true>(a, static_cast<cudaStream_t>(stream));
}
