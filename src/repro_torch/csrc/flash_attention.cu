// Causal flash attention with GQA, for Hopper (sm_90a): fp32 here, bf16 on
// the tensor cores in flash_attention_sm90.cuh.
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
// The fp32 kernel below does its products as scalar fp32 FMAs: fp32 inputs
// are held to 2e-5 of the fp32 reference, which TF32 tensor cores would not
// meet.  What bounds it: at prefill shapes (S 2048, D 64) the work is
// ~2 S^2 D flops per head against 4 S D bytes, far above the card's ridge,
// so the bound is operations.  What the design does about it: each CTA owns
// a 64-row query tile of one (batch, head) and stages it once in shared
// memory (pre-scaled, fp32); K/V tiles of 64 keys are staged in turn.  Each
// of the 128 threads keeps a 4 x 8 register tile of scores (4 query rows, 8
// keys strided by 8) and a 4 x Dv/8 slice of the accumulator, so every
// shared-memory load feeds 2-3 FMAs, and row statistics are reduced over
// the 8 lanes that share a row with shuffles.  Row strides of Q and K are
// padded by one float so the strided reads hit distinct banks.  Heavy (late)
// query tiles are launched first.  Shared memory grows with D: 148 KB at
// D 192, Dv 128 (MLA's prefill), under the block's 227 KB.
//
// C interface (ctypes): pointers and the stream are void*; returns
// cudaGetLastError() after the launch.

#include <cstdint>
#include <cuda_runtime.h>

#include "flash_attention_sm90.cuh"

namespace {

constexpr int kBQ = 64;        // query rows per CTA
constexpr int kBKV = 64;       // keys per KV tile
constexpr int kThreads = 128;
constexpr int kTX = 8;         // threads sharing one group of query rows
constexpr int kRows = 4;       // query rows per thread
constexpr int kKeys = kBKV / kTX;  // keys per thread per tile
constexpr float kNeg = -1e30f;     // the Pallas kernel's mask value

__device__ __forceinline__ void stage(float* dst, int ld, const float* __restrict__ src,
                                      int64_t row_stride, int row0, int n_rows, int rows_valid,
                                      int width, float mul) {
  // dst[r * ld + c] = src[(row0 + r) * row_stride + c] * mul, zeros past rows_valid.
  for (int i = threadIdx.x; i < n_rows * width; i += kThreads) {
    const int r = i / width, c = i - r * width;
    const int s = row0 + r;
    dst[r * ld + c] = s < rows_valid ? src[int64_t(s) * row_stride + c] * mul : 0.f;
  }
}

// kDVP = accumulator columns per thread (Dv <= kTX * kDVP).
template <int kDVP>
__global__ void __launch_bounds__(kThreads)
flash_attn_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o, int Sq, int Skv, int H,
                  int KH, int D, int Dv, float scale, int causal, int window) {
  extern __shared__ float smem[];
  const int ldk = D + 1;
  float* Qs = smem;                      // kBQ x ldk
  float* Ks = Qs + kBQ * ldk;            // kBKV x ldk
  float* Vs = Ks + kBKV * ldk;           // kBKV x Dv
  float* Ps = Vs + kBKV * Dv;            // kBQ x (kBKV + 1)
  constexpr int ldp = kBKV + 1;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;   // late tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / KH);
  const int ty = threadIdx.x / kTX, tx = threadIdx.x % kTX;

  // Base pointers of this (batch, head): row s of q is q_b[s * H * D].
  const float* q_b = q + (int64_t(b) * Sq * H + h) * D;
  const float* k_b = k + (int64_t(b) * Skv * KH + kh) * D;
  const float* v_b = v + (int64_t(b) * Skv * KH + kh) * Dv;
  stage(Qs, ldk, q_b, int64_t(H) * D, q0, kBQ, Sq, D, scale);

  float m[kRows], l[kRows], acc[kRows][kDVP];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNeg;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < kDVP; ++c) acc[r][c] = 0.f;
  }

  // Tiles past the last query row of this CTA are wholly masked, and with a
  // window so are those that end before the first row's first key.
  const int kv_end = causal ? min(Skv, q0 + kBQ) : Skv;
  const int kv_begin = window > 0 ? max(0, q0 - window + 1) / kBKV * kBKV : 0;
  for (int k0 = kv_begin; k0 < kv_end; k0 += kBKV) {
    __syncthreads();               // the previous tile's K/V/P reads are done
    stage(Ks, ldk, k_b, int64_t(KH) * D, k0, kBKV, Skv, D, 1.f);
    stage(Vs, Dv, v_b, int64_t(KH) * Dv, k0, kBKV, Skv, Dv, 1.f);
    __syncthreads();

    float s[kRows][kKeys];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int j = 0; j < kKeys; ++j) s[r][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[kRows], kv[kKeys];
#pragma unroll
      for (int r = 0; r < kRows; ++r) qv[r] = Qs[(ty * kRows + r) * ldk + d];
#pragma unroll
      for (int j = 0; j < kKeys; ++j) kv[j] = Ks[(tx + kTX * j) * ldk + d];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int j = 0; j < kKeys; ++j) s[r][j] = fmaf(qv[r], kv[j], s[r][j]);
    }

#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = q0 + ty * kRows + r;
      float mt = kNeg;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const int key = k0 + tx + kTX * j;
        if (key >= Skv || (causal && key > row) || (window > 0 && row - key >= window))
          s[r][j] = kNeg;
        mt = fmaxf(mt, s[r][j]);
      }
#pragma unroll
      for (int off = 1; off < kTX; off <<= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      // A row may have seen no visible key yet (a window's left edge, or a
      // row past Sq): then m is still kNeg and the exponent is taken
      // against 0, so a masked entry's exp(-1e30 - 0) is exactly 0 whatever
      // tile comes first.  Once a real score has been seen, m is real.
      const float m_new = fmaxf(m[r], mt);
      const float m_use = m_new > kNeg ? m_new : 0.f;
      const float corr = expf(m[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const float p = expf(s[r][j] - m_use);
        REPRO_CHECK(s[r][j] > kNeg || p == 0.f);
        Ps[(ty * kRows + r) * ldp + tx + kTX * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 1; off < kTX; off <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[r] = l[r] * corr + sum;
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < kDVP; ++c) acc[r][c] *= corr;
    }
    __syncwarp();                  // a row's P is written by its own 8 lanes

    const int n_keys = min(kBKV, kv_end - k0);
    for (int j = 0; j < n_keys; ++j) {
      float pv[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) pv[r] = Ps[(ty * kRows + r) * ldp + j];
#pragma unroll
      for (int c = 0; c < kDVP; ++c) {
        const int col = tx + kTX * c;
        const float vv = col < Dv ? Vs[j * Dv + col] : 0.f;
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[r][c] = fmaf(pv[r], vv, acc[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = q0 + ty * kRows + r;
    if (row >= Sq) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    float* o_row = o + ((int64_t(b) * Sq + row) * H + h) * Dv;
#pragma unroll
    for (int c = 0; c < kDVP; ++c) {
      const int col = tx + kTX * c;
      if (col < Dv) o_row[col] = acc[r][c] * inv;
    }
  }
}

template <int kDVP>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Skv,
                   int H, int KH, int D, int Dv, float scale, int causal, int window,
                   cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (size_t(kBQ) * (D + 1) + size_t(kBKV) * (D + 1) + size_t(kBKV) * Dv +
                       size_t(kBQ) * (kBKV + 1));
  auto* fn = flash_attn_kernel<kDVP>;
  cudaError_t err =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  fn<<<grid, kThreads, smem, stream>>>(static_cast<const float*>(q), static_cast<const float*>(k),
                                       static_cast<const float*>(v), static_cast<float*>(o), Sq,
                                       Skv, H, KH, D, Dv, scale, causal, window);
  return cudaGetLastError();
}

cudaError_t dispatch_f32(const void* q, const void* k, const void* v, void* o, int B, int Sq,
                         int Skv, int H, int KH, int D, int Dv, float scale, int causal,
                         int window, cudaStream_t st) {
  auto* fn = Dv <= 16 ? launch<2> : Dv <= 32 ? launch<4> : Dv <= 64 ? launch<8> : launch<16>;
  return fn(q, k, v, o, B, Sq, Skv, H, KH, D, Dv, scale, causal, window, st);
}

}  // namespace

// dtype: 0 = fp32 (the scalar kernel above), 1 = bf16 (the tensor-core
// kernel, fa90::dispatch); q, k, v and o alike.  window: 0 = none, else
// the sliding window (causal only, Sq <= Skv, so every row sees a key).
// The wrapper checks shapes: 1 <= Sq, Skv; 1 <= D <= 192; 1 <= Dv <= 128;
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
          : dispatch_f32(q, k, v, o, B, Sq, Skv, H, KH, D, Dv, scale, causal, window, st);
  return static_cast<int>(err);
}

