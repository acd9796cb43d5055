// Causal flash attention with GQA in fp32, on Hopper's tensor cores (sm_90a,
// mma.sync).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::flash_attention
// (its `_kernel`) for fp32 inputs: the dtype 0 half of repro_flash_attention
// (flash_attention.cu, whose note gives the function, the masks, the window
// skip and the layout, and which checks the shapes; the bf16 half is
// flash_attention_sm90.cuh).
//
// What bounds it: at prefill shapes (S 2048, D 64) the two products are
// ~2 S^2 D flops per head against 4 S D bytes, far above the card's ridge,
// so the bound is operations.  Scalar FMAs cap it at the 67 TFLOP/s fp32
// non-tensor peak; one TF32 tensor-core pass keeps ~11 bits, short of the
// fp32 tolerance (2e-5).  What the design does:
// - 3xTF32 on the tensor cores (mma.sync m16n8k8 tf32, fp32 accumulate):
//   each operand is split in registers as x = hi + lo, hi = x rounded to
//   11 significant bits (integer add and mask), lo = x - hi (exact; the
//   tensor core reads lo's top 11 bits), and each product is lo a * hi b +
//   hi a * lo b + hi a * hi b, the small terms first.  Only lo * lo (~2^-22
//   of the product) and lo's truncation (~2^-21) are lost, so each product
//   keeps ~21 bits: three MMAs a step, at 495 TFLOP/s dense TF32 still
//   ~2.5x the SIMT ceiling.  S is summed over d in 16-column chunks, each
//   chunk's partial sum added to S in fp32.  (wgmma would need V^T staged:
//   its TF32 operands are K-major only.)
// - Work layout: a warp owns 16 query rows (MMA's M); a CTA has 8 warps
//   (128 rows) that read one K/V tile of 64 keys, 32 at D > 128.  At ~200
//   registers a thread one CTA fills an SM; two CTAs of 4 warps were
//   slower, as were 12 or 16 warps, two MMA tiles a warp, or the chunk
//   loop unrolled (it spills).  Grid (B * H, query tiles), the heaviest
//   (last) query tile of every head first.
// - Shared memory holds fp32 only: the Q tile (pre-scaled once by scale *
//   log2 e, so the softmax is exp2 of the scores, exact for any scale's
//   sign) and a ring of two K/V slots filled by cp.async (16-byte copies
//   when D and Dv are multiples of 4 and the pointers 16-byte aligned, else
//   4-byte ones; rows past S and columns past D zero-filled, D padded to 64,
//   128 or 192 and Dv to 64 or 128; the products skip the all-zero
//   16-column chunks): tile t + 1 arrives while tile t is computed.  At
//   D 128 / Dv 128 that is 215,040 bytes of the block's 232,448; at D 192
//   193,536.
// - Conflict-free float4 fragment loads.  The sum over d of Q K^T is taken
//   in a permuted order: in each 16-column chunk lane (g, t) = (lane / 4,
//   lane % 4) reads columns 4t .. 4t + 3 of rows g and g + 8 of Q and of
//   key g of each 8-key n-tile, which feed two k-steps (k-index t <-> column
//   4t or 4t + 2, t + 4 <-> 4t + 1 or 4t + 3).  Q and K rows are padded to a
//   stride of 16 mod 32 floats, so each quarter-warp's 8 float4 loads hit
//   distinct bank groups.
// - P never leaves the registers: the S accumulator of n-tile j holds keys
//   8j + 2t and 8j + 2t + 1 of rows g and g + 8, which are the A fragment of
//   P V's k-step j if its k-index t reads V row 8j + 2t and t + 4 reads row
//   8j + 2t + 1 (the sum over keys does not depend on the order).  V's
//   columns are permuted too: n-tile 4c + i reads column 32c + 4g + i, so a
//   lane reads 4 n-tiles' B values as one float4 (V rows padded to 4 mod 32
//   floats: conflict-free); the epilogue writes the columns back in order.
// - Online softmax in registers, fp32: row max over the 4 lanes of a row
//   (shuffles), exp2f; a row's sum is kept per lane and reduced once at the
//   end.  Only diagonal, window-edge and ragged tiles are masked; a warp
//   skips a tile none of its rows can see.  A row may have seen no visible
//   key yet (a window's left edge): m is then still -1e30 and the exponent
//   is taken against 0, so a masked p is exactly 0 (the checked build
//   asserts it).

#include <cassert>
#include <cstdint>
#include <cuda_runtime.h>

#ifndef REPRO_CHECK
#ifdef REPRO_CHECKED
#define REPRO_CHECK(cond) assert(cond)
#else
#define REPRO_CHECK(cond) ((void)0)
#endif
#endif

namespace {

constexpr int kWarps = 8;          // warps (of 16 query rows) a CTA
constexpr int kStages = 2;         // K/V ring slots
constexpr float kNeg = -1e30f;     // the Pallas kernel's mask value
constexpr float kLog2e = 1.4426950408889634f;

// Row strides in floats: Q and K rows (D padded to kDK, a multiple of 32)
// at 16 mod 32; V rows (Dv padded to kDV, a multiple of 32) at 4 mod 32.
__host__ __device__ constexpr int qk_stride(int dk) { return dk + 16; }
__host__ __device__ constexpr size_t smem_floats(int bq, int keys, int dk, int dv) {
  return size_t(bq) * qk_stride(dk) + size_t(kStages) * keys * (qk_stride(dk) + dv + 4);
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// dst[r * ld + c] = src[(row0 + r) * stride + c] for r < kRowsN, c <
// kWidth, zeros for rows >= n_valid and columns >= width, as cp.async
// copies of this thread's current group: 16 bytes each when `vec` (width %
// 4 == 0, src 16-byte aligned), else 4.
template <int kThreads, int kRowsN, int kWidth>
__device__ __forceinline__ void load_tile(float* dst, int ld, const float* __restrict__ src,
                                          int64_t stride, int row0, int n_valid, int width,
                                          bool vec) {
  if (vec) {
    constexpr int cpr = kWidth / 4;  // 16-byte chunks a row
    for (int i = threadIdx.x; i < kRowsN * cpr; i += kThreads) {
      const int r = i / cpr, c = (i % cpr) * 4;
      const bool ok = row0 + r < n_valid && c < width;
      const float* s = ok ? src + int64_t(row0 + r) * stride + c : src;
      const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst + r * ld + c));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(s),
                   "r"(ok ? 16 : 0)
                   : "memory");
    }
  } else {
    for (int i = threadIdx.x; i < kRowsN * kWidth; i += kThreads) {
      const int r = i / kWidth, c = i % kWidth;
      const bool ok = row0 + r < n_valid && c < width;
      const float* s = ok ? src + int64_t(row0 + r) * stride + c : src;
      const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst + r * ld + c));
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(s),
                   "r"(ok ? 4 : 0)
                   : "memory");
    }
  }
}

// x = hi + lo: hi = x rounded to TF32 (11 significant bits, ties away from
// zero) by an integer add and mask, lo = x - hi exactly (an fp32 with up to
// 13 significant bits, of which the tensor core reads the top 11).
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  const uint32_t h = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  hi = h;
  lo = __float_as_uint(__fsub_rn(x, __uint_as_float(h)));
}

// d += a b over one m16n8k8 TF32 tile, fp32 accumulate.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b in 3xTF32, the small products first.
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  mma(d, al, bh);
  mma(d, ah, bl);
  mma(d, ah, bh);
}

// kDK, kDV: D and Dv padded (kDK 64, 128 or 192; kDV 64 or 128); kKeys:
// keys a K/V tile.  vec: 16-byte copies and stores (D % 4 == Dv % 4 == 0,
// pointers aligned).
template <int kDK, int kDV, int kKeys>
__global__ void __launch_bounds__(kWarps * 32, 1)
flash_attn_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o, int Sq, int Skv, int H,
                  int KH, int D, int Dv, float scale, int causal, int window, int vec) {
  constexpr int kThreads = kWarps * 32, kBQ = kWarps * 16;
  constexpr int ldq = qk_stride(kDK), ldv = kDV + 4;
  constexpr int kNT = kKeys / 8;    // 8-key n-tiles of S a K/V tile
  constexpr int kNV = kDV / 8;      // 8-column n-tiles of O
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                        // kBQ x ldq
  float* Ks = Qs + kBQ * ldq;              // kStages x kKeys x ldq
  float* Vs = Ks + kStages * kKeys * ldq;  // kStages x kKeys x ldv

  const int h = blockIdx.x % H, b = blockIdx.x / H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // heavy (late) tiles first
  const int kh = h / (H / KH);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  REPRO_CHECK(b < int(gridDim.x) / H && kh < KH && q0 >= 0 && q0 < Sq);
  REPRO_CHECK(D <= kDK && Dv <= kDV);

  const float* q_b = q + (int64_t(b) * Sq * H + h) * D;
  const float* k_b = k + (int64_t(b) * Skv * KH + kh) * D;
  const float* v_b = v + (int64_t(b) * Skv * KH + kh) * Dv;
  const int dp = (D + 15) & ~15;  // columns of Q and K that are not all zero

  // Tiles past the last query row of this CTA are wholly masked, and with a
  // window so are those that end before the first row's first key.
  const int kv_end = causal ? min(Skv, q0 + kBQ) : Skv;
  const int kv_begin = window > 0 ? max(0, q0 - window + 1) / kKeys * kKeys : 0;
  const int n_tiles = (kv_end - kv_begin + kKeys - 1) / kKeys;
  REPRO_CHECK(n_tiles >= 1);
  auto load_kv = [&](int tile) {
    const int slot = tile % kStages, k0 = kv_begin + tile * kKeys;
    load_tile<kThreads, kKeys, kDK>(Ks + slot * kKeys * ldq, ldq, k_b, int64_t(KH) * D, k0, Skv,
                                    D, vec);
    load_tile<kThreads, kKeys, kDV>(Vs + slot * kKeys * ldv, ldv, v_b, int64_t(KH) * Dv, k0, Skv,
                                    Dv, vec);
  };
  load_tile<kThreads, kBQ, kDK>(Qs, ldq, q_b, int64_t(H) * D, q0, Sq, D, vec);
  load_kv(0);
  cp_commit();
#pragma unroll
  for (int s = 1; s < kStages; ++s) {
    if (s < n_tiles) load_kv(s);
    cp_commit();
  }
  cp_wait<kStages - 1>();  // Q and tile 0
  __syncthreads();
  const float c = scale * kLog2e;  // scores in log2 units
  for (int i = threadIdx.x; i < kBQ * ldq / 4; i += kThreads) {
    float4 x = reinterpret_cast<float4*>(Qs)[i];
    x.x *= c, x.y *= c, x.z *= c, x.w *= c;
    reinterpret_cast<float4*>(Qs)[i] = x;
  }
  __syncthreads();

  float acc[kNV][4];
#pragma unroll
  for (int j = 0; j < kNV; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};  // rows g and g + 8
  const int r0 = q0 + warp * 16;                // the warp's first row
  const float* qa = Qs + (warp * 16 + g) * ldq + 4 * t;

  for (int it = 0; it < n_tiles; ++it) {
    const int slot = it % kStages, k0 = kv_begin + it * kKeys;
    const bool seen = r0 < Sq && !(causal && k0 > r0 + 15) &&
                      !(window > 0 && r0 - (k0 + kKeys - 1) >= window);
    if (seen) {
      // S = Q K^T (log2 units), 3xTF32.
      float s[kNT][4];
#pragma unroll
      for (int n = 0; n < kNT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      const float* kb = Ks + slot * kKeys * ldq + g * ldq + 4 * t;
#pragma unroll 1
      for (int cc = 0; cc < dp; cc += 16) {  // a loop: unrolled, it spills
        const float4 xa = *reinterpret_cast<const float4*>(qa + cc);
        const float4 xb = *reinterpret_cast<const float4*>(qa + 8 * ldq + cc);
        uint32_t ah[2][4], al[2][4];
        split(xa.x, ah[0][0], al[0][0]), split(xb.x, ah[0][1], al[0][1]);
        split(xa.y, ah[0][2], al[0][2]), split(xb.y, ah[0][3], al[0][3]);
        split(xa.z, ah[1][0], al[1][0]), split(xb.z, ah[1][1], al[1][1]);
        split(xa.w, ah[1][2], al[1][2]), split(xb.w, ah[1][3], al[1][3]);
#pragma unroll
        for (int n = 0; n < kNT; ++n) {
          const float4 y = *reinterpret_cast<const float4*>(kb + n * 8 * ldq + cc);
          uint32_t bh[2][2], bl[2][2];
          split(y.x, bh[0][0], bl[0][0]), split(y.y, bh[0][1], bl[0][1]);
          split(y.z, bh[1][0], bl[1][0]), split(y.w, bh[1][1], bl[1][1]);
          // The chunk's partial sum, its small products first, then added
          // to S in fp32: each MMA rounds at its accumulator's magnitude,
          // and a chunk's is a few times below a whole score's.
          float sc[4] = {0.f, 0.f, 0.f, 0.f};
          mma(sc, al[0], bh[0]), mma(sc, ah[0], bl[0]);
          mma(sc, al[1], bh[1]), mma(sc, ah[1], bl[1]);
          mma(sc, ah[0], bh[0]), mma(sc, ah[1], bh[1]);
#pragma unroll
          for (int i = 0; i < 4; ++i) s[n][i] += sc[i];
        }
      }

      // Masks, only where a key of the tile is past Skv, right of the
      // diagonal or left of a row's window.
      const int row_a = r0 + g;
      if (k0 + kKeys > Skv || (causal && k0 + kKeys - 1 > r0) ||
          (window > 0 && r0 + 15 - k0 >= window)) {
#pragma unroll
        for (int n = 0; n < kNT; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int key = k0 + 8 * n + 2 * t + (i & 1), row = row_a + 8 * (i >> 1);
            if (key >= Skv || (causal && key > row) || (window > 0 && row - key >= window))
              s[n][i] = kNeg;
          }
      }

      // Online softmax: rows g (s[.][0..1]) and g + 8 (s[.][2..3]), a row's
      // max over the 4 lanes that hold it.
      float mx[2] = {kNeg, kNeg};
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
      }
      float m_use[2], corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        m_use[r] = m_new > kNeg ? m_new : 0.f;
        corr[r] = exp2f(m[r] - m_new);
        m[r] = m_new;
        l[r] *= corr[r];
      }
#pragma unroll
      for (int n = 0; n < kNT; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = exp2f(s[n][i] - m_use[i >> 1]);
          REPRO_CHECK(s[n][i] > kNeg || p == 0.f);
          s[n][i] = p;
          l[i >> 1] += p;
        }
#pragma unroll
      for (int j = 0; j < kNV; ++j) {
        acc[j][0] *= corr[0], acc[j][1] *= corr[0];
        acc[j][2] *= corr[1], acc[j][3] *= corr[1];
      }

      // O += P V, 3xTF32: k-step n reads V rows 8n + 2t (k-index t) and
      // 8n + 2t + 1 (t + 4); n-tile 4ch + i reads column 32ch + 4g + i.
      const float* vb = Vs + slot * kKeys * ldv + 2 * t * ldv + 4 * g;
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        uint32_t ph[4], pl[4];
        split(s[n][0], ph[0], pl[0]), split(s[n][2], ph[1], pl[1]);
        split(s[n][1], ph[2], pl[2]), split(s[n][3], ph[3], pl[3]);
#pragma unroll
        for (int ch = 0; ch < kDV / 32; ++ch) {
          const float4 v0 = *reinterpret_cast<const float4*>(vb + 8 * n * ldv + 32 * ch);
          const float4 v1 = *reinterpret_cast<const float4*>(vb + (8 * n + 1) * ldv + 32 * ch);
          const float b0[4] = {v0.x, v0.y, v0.z, v0.w}, b1[4] = {v1.x, v1.y, v1.z, v1.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            uint32_t bh[2], bl[2];
            split(b0[i], bh[0], bl[0]), split(b1[i], bh[1], bl[1]);
            mma3(acc[4 * ch + i], ph, pl, bh, bl);
          }
        }
      }
    }
    __syncthreads();  // every warp is done with this slot
    if (it + kStages < n_tiles) load_kv(it + kStages);
    cp_commit();
    cp_wait<kStages - 1>();  // tile it + 1
    __syncthreads();
  }

  // Epilogue: row sums over the 4 lanes of a row, divide, store columns
  // 32ch + 8t + i (c0 / c2 of n-tile 4ch + i) and 32ch + 8t + 4 + i (c1 / c3).
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = r0 + g + 8 * r;
    if (row >= Sq) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    float* o_row = o + ((int64_t(b) * Sq + row) * H + h) * Dv;
#pragma unroll
    for (int ch = 0; ch < kDV / 32; ++ch) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int col = 32 * ch + 8 * t + 4 * half, e = 2 * r + half;
        const float4 y = make_float4(acc[4 * ch][e] * inv, acc[4 * ch + 1][e] * inv,
                                     acc[4 * ch + 2][e] * inv, acc[4 * ch + 3][e] * inv);
        if (vec) {
          if (col < Dv) *reinterpret_cast<float4*>(o_row + col) = y;
        } else {
          const float w[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (col + i < Dv) o_row[col + i] = w[i];
        }
      }
    }
  }
}

template <int kDK, int kDV, int kKeys>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Skv,
                   int H, int KH, int D, int Dv, float scale, int causal, int window, int vec,
                   cudaStream_t stream) {
  constexpr int kBQ = kWarps * 16;
  constexpr size_t smem = sizeof(float) * smem_floats(kBQ, kKeys, kDK, kDV);
  static_assert(smem <= 232448, "the Q tile and the K/V ring must fit a block");
  auto* fn = flash_attn_kernel<kDK, kDV, kKeys>;
  cudaError_t err =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(unsigned(B) * unsigned(H), (Sq + kBQ - 1) / kBQ);
  fn<<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), Sq, Skv, H, KH, D, Dv, scale, causal, window, vec);
  return cudaGetLastError();
}

using LaunchFn = cudaError_t (*)(const void*, const void*, const void*, void*, int, int, int, int,
                                 int, int, int, float, int, int, int, cudaStream_t);

template <int kDK, int kKeys>
LaunchFn by_dv(int Dv) {
  return Dv <= 64 ? launch<kDK, 64, kKeys> : launch<kDK, 128, kKeys>;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

namespace fa32 {

cudaError_t dispatch(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Skv,
                     int H, int KH, int D, int Dv, float scale, int causal, int window,
                     cudaStream_t st) {
  const int vec = D % 4 == 0 && Dv % 4 == 0 && aligned16(q) && aligned16(k) && aligned16(v) &&
                  aligned16(o);
  const LaunchFn fn =
      D <= 64 ? by_dv<64, 64>(Dv) : D <= 128 ? by_dv<128, 64>(Dv) : by_dv<192, 32>(Dv);
  return fn(q, k, v, o, B, Sq, Skv, H, KH, D, Dv, scale, causal, window, vec, st);
}

}  // namespace fa32
