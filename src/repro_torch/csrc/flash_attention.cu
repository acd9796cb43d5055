// Causal flash attention with GQA, for Hopper (sm_90a), on the tensor cores:
// fp32 in flash_attention_fp32.cu (3xTF32 mma.sync), bf16 in
// flash_attention_sm90.cuh (wgmma); this file holds their C entry.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::flash_attention
// (its `_kernel`): o = softmax(q k^T * scale, causal top-left mask) v, per
// (batch, query head), with the query head h reading kv head h / (H / KH).
// The online softmax state (m, l, acc) is fp32, as in the Pallas kernel, and
// KV tiles that lie wholly above the diagonal are skipped (the Pallas
// kernel's `pl.when`).  With a sliding window (window > 0, causal, the JAX
// prefill's chunked_attention(window=...)) row i sees keys i - window < j
// <= i: tiles wholly left of the CTA's first row's window are skipped too,
// and the left-edge tiles are masked.  Layout is the JAX package's: q
// (B, Sq, H, D), k (B, Skv, KH, D), v (B, Skv, KH, Dv), o (B, Sq, H, Dv),
// all contiguous, fp32 or bf16 (o in q's type).  Any Sq, Skv >= 1, D <= 192
// (MLA's expanded q/k heads) and Dv <= 128: the ragged edges of both tiles
// are masked here, so the Pallas kernel's Sq % q_block == 0 limit does not
// carry over.
//
// C interface (ctypes): pointers and the stream are void*; returns
// cudaGetLastError() after the launch.

#include <cstdint>
#include <cuda_runtime.h>

#include "flash_attention_sm90.cuh"

namespace fa32 {
// flash_attention_fp32.cu
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Skv,
                     int H, int KH, int D, int Dv, float scale, int causal, int window,
                     cudaStream_t st);
}  // namespace fa32

// dtype: 0 = fp32 (the 3xTF32 kernel, fa32::dispatch), 1 = bf16 (the wgmma
// kernel, fa90::dispatch); q, k, v and o alike.  window: 0 = none, else the
// sliding window (causal only, Sq <= Skv, so every row sees a key).  The
// wrapper checks shapes: 1 <= Sq, Skv; 1 <= D <= 192; 1 <= Dv <= 128;
// H % KH == 0.
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v, void* o, int B,
                                     int Sq, int Skv, int H, int KH, int D, int Dv, float scale,
                                     int causal, int window, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || Sq <= 0 || Skv <= 0 || D <= 0 || D > 192 || Dv <= 0 || Dv > 128 || KH <= 0 ||
      H % KH != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (window < 0 || (window > 0 && (!causal || Sq > Skv)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err =
      dtype == 1
          ? fa90::dispatch(q, k, v, o, B, Sq, Skv, H, KH, D, Dv, scale, causal, window, st)
          : fa32::dispatch(q, k, v, o, B, Sq, Skv, H, KH, D, Dv, scale, causal, window, st);
  return static_cast<int>(err);
}
