// Causal flash attention on Hopper's tensor cores (sm_90a, wgmma + TMA), bf16.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::flash_attention
// (its `_kernel`) for bf16 inputs; fp32 runs on the 3xTF32 kernel in
// flash_attention_fp32.cu.  It computes o = softmax(scale * q k^T, top-left
// causal mask or none) v per (batch, query head h), head h reading kv head
// h / (H / KH), with the online softmax state (m, l, acc) in fp32, masked
// scores -1e30 (exactly 0 after the exponent, as there), the output divided
// by max(l, 1e-30) and stored as bf16.  A sliding window (window > 0, with
// the causal mask: the JAX prefill's chunked_attention(window=...)) lets
// row i see keys i - window < j <= i.  Any Sq, Skv >= 1, D in [1, 192] and
// Dv in [1, 128]: head dims are zero-padded in shared memory to DP in {64,
// 128, 192} (192: MLA's expanded q/k heads, 128 + 64) and DVP in {64, 128}.
//
// What bounds it: at prefill shapes (S 2048, D 64) the two products are
// ~2 S^2 D flops per head against 4 S D bytes, far above the card's ridge,
// so the bound is the bf16 tensor-core rate; at D = 64 the softmax's one
// exponent per score (16 per clock per SM) costs as much as the products.
// What the design does about it:
// - CTA = one (batch, head) and 128 query rows, held by two warpgroups of
//   64 rows (wgmma's M).  The Q tile is loaded once, bf16, unscaled.  Heavy
//   (late) query tiles of every head start first.
// - K/V tiles of 128 keys go through a ring of NS slots in shared memory,
//   filled by TMA: one thread issues a tile's copies NS - 1 tiles ahead,
//   and an mbarrier per slot counts its bytes in.  NS is 3, or 2 at DP 192,
//   where Q (48 KB) and three slots (240 KB) would not fit the block's
//   227 KB: there a tile's copy is issued when its slot frees, one tile
//   ahead of its products, and is waited for at once.  The tensor maps
//   (4-D over (B, S, heads, dim), boxes of 64 dims x 128 rows, 128-byte
//   swizzle, out-of-range rows and dims filled with zeros) are built on the
//   host for each launch; cuTensorMapEncodeTiled comes through
//   cudaGetDriverEntryPoint, so nothing links the driver library.  TMA
//   needs 16-byte global strides: when D or Dv is not a multiple of 8 (or a
//   pointer is not 16-byte aligned) the same kernel fills the ring with
//   plain loads instead (kTma = false, chosen by shape).  Both write the
//   same layout: 64-column panels of R rows x 128 bytes, 16-byte chunk c of
//   row r at position c ^ (r % 8), the layout the wgmma descriptors name.
// - S = Q K^T: wgmma m64n128k16, A = Q and B = K from shared memory
//   (K-major, 128-byte swizzle; K steps of 32 bytes inside the row).
// - Softmax in registers, in the log2 domain: row max and row sum over the
//   4 lanes that share a row (shuffles); with a positive scale c the max of
//   the raw scores is taken and p = 2^(s c - m) is one FMA and one exponent.
//   Only the diagonal tile, the ragged last key tile and, with a window,
//   the (at most two) tiles at a warpgroup's left window edge are masked;
//   tiles wholly above the diagonal, or wholly left of the CTA's first
//   row's window, are never loaded (the Pallas kernel's `pl.when`).  A row
//   may see no key of the first tiles loaded (the left edge of a window),
//   so m may still be the initial -1e30 after a tile: the exponent is then
//   taken against 0, and a masked entry's 2^(s c - 0) is exactly 0 in both
//   branches (s is -inf or -1e30); the checked build asserts it.
// - O += P V: P is rounded to bf16 in registers and is wgmma's register A
//   operand (the fp32 accumulator fragment of S is, pairwise, the bf16 A
//   fragment of the next product); B = V from shared memory, stored
//   [key][dv], i.e. MN-major, read through the descriptor's transpose bit.
// - Overlap inside a warpgroup: iteration t issues S(t + 1) and then
//   O += P(t) V(t), waits for S(t + 1) only, and runs its softmax while the
//   second product is on the tensor cores; the accumulators are rescaled by
//   2^(m_old - m_new) once that product is done.  No product sits inside a
//   branch of the loop (ptxas would serialize them), so the last tile's
//   O += P V is peeled.  The two warpgroups of a CTA overlap each other too.
// - Epilogue: divide by l, round to bf16, store rows < Sq and cols < Dv.
//
// The checked build (-DREPRO_CHECKED, kernels/_build.py) asserts the ring's
// bookkeeping: tiles are loaded in order, a slot is refilled only after the
// products of the tile it held are done, every wait and every product names
// a tile that is still in its slot (so the wait's phase parity is that
// tile's fill), every TMA box starts inside its tensor's extents, and every
// masked score's exponent is 0.

#pragma once

#include <cassert>
#include <cstdint>
#include <cuda.h>  // CUtensorMap and its enums (types only: no driver library)
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#ifndef REPRO_CHECK
#ifdef REPRO_CHECKED
#define REPRO_CHECK(cond) assert(cond)
#else
#define REPRO_CHECK(cond) ((void)0)
#endif
#endif

namespace fa90 {

constexpr int kBQ = 128;        // query rows per CTA (two warpgroups of 64)
constexpr int kBKV = 128;       // keys per K/V tile
constexpr int kThreads = 256;   // two warpgroups
constexpr int kPanel = 64;      // bf16 columns per 128-byte swizzled panel
constexpr float kNeg = -1e30f;  // the Pallas kernel's mask value

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma matrix descriptor of a 128-byte-swizzled operand at shared address
// `addr` (layout type 1): lbo and sbo in bytes, as the operand's major-ness
// defines them.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t((lbo & 0x3FFFF) >> 4) << 16) |
         (uint64_t((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from touching registers of an async product early.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(d[i][j])::"memory");
}

// Makes this thread's shared-memory stores visible to wgmma (async proxy).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
// Waits for phase `parity` of the barrier to complete.  A copy that never
// lands traps (a launch error) instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t spins = 0;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spins > (1u << 26)) __trap();
  }
}
// One box {64 dims, 1 head, 128 rows, 1 batch} of a 4-D (B, S, heads, dim)
// tensor into shared memory, counted in at `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int dim0, int head, int row0, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(dim0), "r"(head), "r"(row0), "r"(batch), "r"(bar)
      : "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// d (64 x N, fp32) = (scale_d ? d : 0) + A (64 x 16) B (16 x N), A and B
// K-major in shared memory.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db, int scale_d);
// d (64 x N) = (scale_d ? d : 0) + A (64 x 16, bf16 registers) B, B MN-major
// in shared memory (transpose bit set).
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db,
                                         int scale_d);

template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t da, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64], const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// Shared-memory byte offset of 16-byte chunk c of row r in an R-row tile:
// 64-column panels of R rows x 128 bytes, chunk c % 8 of row r at position
// (c % 8) ^ (r % 8).  TMA's 128-byte swizzle writes exactly this.
template <int R>
__device__ __forceinline__ uint32_t chunk_off(int r, int c) {
  return (c >> 3) * (R * 128) + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

// Plain-load fill (shapes TMA cannot take): rows [row0, row0 + R) x
// columns [0, DP) of a bf16 matrix with row stride `ld` (elements), zeros
// past `rows_valid` and `width`.
template <int R, int DP>
__device__ __forceinline__ void load_plain(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                           int64_t ld, int row0, int rows_valid, int width) {
  for (int i = threadIdx.x; i < R * DP; i += kThreads) {
    const int r = i / DP, e = i - r * DP, s = row0 + r;
    dst[(chunk_off<R>(r, e >> 3) >> 1) + (e & 7)] =
        s < rows_valid && e < width ? src[int64_t(s) * ld + e] : __float2bfloat16(0.f);
  }
}

// K-major Q or K rows of an R-row tile, k-step ks (16 columns): SBO = the
// next 8 rows (1024 bytes); LBO is unused in this layout.
template <int R>
__device__ __forceinline__ uint64_t desc_k(uint32_t base, int ks) {
  return make_desc(base + (ks >> 2) * (R * 128) + (ks & 3) * 32, 16, 1024);
}
// MN-major V (rows = keys), k-step kk (16 keys): LBO = the next 64 columns
// (the next panel), SBO = the next 8 keys.
__device__ __forceinline__ uint64_t desc_v(uint32_t base, int kk) {
  return make_desc(base + kk * 2048, kBKV * 128, 1024);
}

// q (B, Sq, H, D), k (B, Skv, KH, D), v (B, Skv, KH, Dv), o (B, Sq, H, Dv),
// contiguous bf16; tm_* their tensor maps when kTma.  Grid (B * H,
// ceil(Sq / kBQ)): blockIdx.y = 0 is the last (heaviest) query tile.  NS:
// the K/V ring's slots (3: tile t's V read, t + 1's K read, t + 2 loading).
template <int DP, int DVP, int NS, bool kTma>
__global__ void __launch_bounds__(kThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v, const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k, const __nv_bfloat16* __restrict__ v,
                   __nv_bfloat16* __restrict__ o, int Sq, int Skv, int H, int KH, int D, int Dv,
                   float scale_log2, int causal, int window) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[NS + 1];  // K/V slots, then Q
  // Swizzled panels need 1024-byte alignment (the launch adds the slack).
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(
      smem_raw + ((1024 - smem_u32(smem_raw) % 1024) % 1024));  // kBQ x DP
  __nv_bfloat16* Ks = Qs + kBQ * DP;                             // NS x kBKV x DP
  __nv_bfloat16* Vs = Ks + NS * kBKV * DP;                       // NS x kBKV x DVP

  const int h = blockIdx.x % H, b = blockIdx.x / H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const int kh = h / (H / KH);
  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int tig = lane % 4;
  // This thread's accumulator rows: row_a and row_a + 8.
  const int row_a = q0 + wg * 64 + warp * 16 + lane / 4;

  // Tiles past this CTA's last query row are wholly masked: never loaded;
  // with a window, so are the tiles that end before its first row's first
  // key.  Ring tile i (0 <= i < n_tiles) is key tile t_first + i.
  const int kv_end = causal ? min(Skv, q0 + kBQ) : Skv;
  const int t_first = window > 0 ? max(0, q0 - window + 1) / kBKV : 0;
  const int n_tiles = (kv_end + kBKV - 1) / kBKV - t_first;

  const uint32_t bar0 = smem_u32(bars);
#ifdef REPRO_CHECKED
  // The ring's bookkeeping: tiles loaded so far (in order), and tiles whose
  // O += P V this thread's warpgroup has waited for.
  int next_load = 0, pv_done = 0;
  // `tile` has been loaded and its slot not refilled since.
  auto in_slot = [&](int tile) {
    return tile >= 0 && tile < next_load && tile + NS >= next_load;
  };
#endif
  REPRO_CHECK(b < int(gridDim.x) / H && kh >= 0 && kh < KH && q0 >= 0 && q0 < Sq);
  REPRO_CHECK(n_tiles >= 1 && t_first >= 0);
  auto load_kv = [&](int tile) {  // K and V of ring tile `tile` into its slot
    const int slot = tile % NS, row0 = (t_first + tile) * kBKV;
    REPRO_CHECK(tile >= 0 && tile < n_tiles && slot >= 0 && slot < NS);
#ifdef REPRO_CHECKED
    REPRO_CHECK(tile == next_load && (tile < NS || tile - NS < pv_done));
    ++next_load;
#endif
    __nv_bfloat16* ks = Ks + slot * kBKV * DP;
    __nv_bfloat16* vs = Vs + slot * kBKV * DVP;
    if constexpr (kTma) {
      if (threadIdx.x == 0) {
        const uint32_t bar = bar0 + 8 * slot;
        REPRO_CHECK(row0 < Skv);
        mbar_expect_tx(bar, (DP + DVP) / kPanel * kBKV * 128);
        for (int p = 0; p < DP / kPanel; ++p) {
          REPRO_CHECK(p * kPanel < D);
          tma_load(smem_u32(ks + p * kBKV * kPanel), &tm_k, bar, p * kPanel, kh, row0, b);
        }
        for (int p = 0; p < DVP / kPanel; ++p) {
          REPRO_CHECK(p * kPanel < Dv);
          tma_load(smem_u32(vs + p * kBKV * kPanel), &tm_v, bar, p * kPanel, kh, row0, b);
        }
      }
    } else {
      load_plain<kBKV, DP>(ks, k + (int64_t(b) * Skv * KH + kh) * D, int64_t(KH) * D, row0, Skv,
                           D);
      load_plain<kBKV, DVP>(vs, v + (int64_t(b) * Skv * KH + kh) * Dv, int64_t(KH) * Dv, row0,
                            Skv, Dv);
      fence_proxy_async();  // visible to the products after the next barrier
    }
  };
  // Waits for the slot of `tile` (TMA); plain loads are visible after the next barrier.
  auto wait_kv = [&](int tile) {
#ifdef REPRO_CHECKED
    REPRO_CHECK(in_slot(tile));
#endif
    if constexpr (kTma) mbar_wait(bar0 + 8 * (tile % NS), (tile / NS) & 1);
  };

  if constexpr (kTma) {
    if (threadIdx.x == 0) {
      for (int i = 0; i <= NS; ++i) mbar_init(bar0 + 8 * i, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      const uint32_t qbar = bar0 + 8 * NS;
      mbar_expect_tx(qbar, DP / kPanel * kBQ * 128);
      for (int p = 0; p < DP / kPanel; ++p) {
        REPRO_CHECK(p * kPanel < D);
        tma_load(smem_u32(Qs + p * kBQ * kPanel), &tm_q, qbar, p * kPanel, h, q0, b);
      }
    }
  } else {
    load_plain<kBQ, DP>(Qs, q + (int64_t(b) * Sq * H + h) * D, int64_t(H) * D, q0, Sq, D);
  }
  for (int i = 0; i < NS - 1 && i < n_tiles; ++i) load_kv(i);
  __syncthreads();  // plain loads visible
  if constexpr (kTma) mbar_wait(bar0 + 8 * NS, 0);

  float acc[DVP / 2];
#pragma unroll
  for (int i = 0; i < DVP / 2; ++i) acc[i] = 0.f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};  // l: this thread's partial row sums
  float s[kBKV / 2], corr[2];
  uint32_t pa[kBKV / 16][4];

  // This warpgroup's 64 Q rows: 64 * 128 bytes into each panel.
  const uint32_t q_addr = smem_u32(Qs) + wg * 64 * 128;
  auto issue_s = [&](int tile) {  // S = Q K^T (64 x 128 per warpgroup), async
#ifdef REPRO_CHECKED
    REPRO_CHECK(in_slot(tile));
#endif
    const uint32_t k_addr = smem_u32(Ks + (tile % NS) * kBKV * DP);
#pragma unroll
    for (int ks = 0; ks < DP / 16; ++ks)
      wgmma_ss<kBKV>(s, desc_k<kBQ>(q_addr, ks), desc_k<kBKV>(k_addr, ks), ks);
    wg_commit();
  };
  auto issue_pv = [&](int tile) {  // O += P V, async
#ifdef REPRO_CHECKED
    REPRO_CHECK(in_slot(tile));
#endif
    const uint32_t v_addr = smem_u32(Vs + (tile % NS) * kBKV * DVP);
#pragma unroll
    for (int kk = 0; kk < kBKV / 16; ++kk) wgmma_rs<DVP>(acc, pa[kk], desc_v(v_addr, kk), 1);
    wg_commit();
  };
  // Online softmax of ring tile `tile` in s: s becomes p (fp32), m and l
  // move on, corr = 2^(m_old - m_new) for the accumulators.  With a positive
  // scale c the row max commutes with it, so the scores stay raw: masked
  // ones are -inf, m = c max(s), p = 2^(s c - m) in one FMA.  Any other
  // scale multiplies first and masks with -1e30.  A row that has seen no
  // visible key yet has m = kNeg, and its exponent is taken against 0.
  const bool fold = scale_log2 > 0.f;
  const float c = fold ? scale_log2 : 1.f, neg = fold ? -__int_as_float(0x7f800000) : kNeg;
  const int wg_row0 = q0 + wg * 64;  // this warpgroup's first row
  auto masked = [&](int key, int row) {
    return key >= Skv || (causal && key > row) || (window > 0 && row - key >= window);
  };
  auto softmax = [&](int tile) {
    const int kv0 = (t_first + tile) * kBKV;
    if (!fold)
#pragma unroll
      for (int i = 0; i < kBKV / 2; ++i) s[i] *= scale_log2;
    // s[4j + e]: row row_a + 8 * (e >> 1), key kv0 + 8j + 2 tig + (e & 1).
    const bool edge = (causal && kv0 + kBKV - 1 > wg_row0) || kv0 + kBKV > Skv ||
                      (window > 0 && wg_row0 + 63 - kv0 >= window);
    if (edge) {
#pragma unroll
      for (int j = 0; j < kBKV / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (masked(kv0 + 8 * j + 2 * tig + (e & 1), row_a + 8 * (e >> 1))) s[4 * j + e] = neg;
    }
    float m_use[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mt = neg;
#pragma unroll
      for (int j = 0; j < kBKV / 8; ++j)
        mt = fmaxf(mt, fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
      const float m_new = fmaxf(m[r], mt * c);
      corr[r] = ex2(m[r] - m_new);
      m[r] = m_new;
      m_use[r] = m_new > kNeg ? m_new : 0.f;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < kBKV / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[4 * j + e] = ex2(fmaf(s[4 * j + e], c, -m_use[e >> 1]));
        sum[e >> 1] += s[4 * j + e];
      }
#ifdef REPRO_CHECKED
    if (edge)
#pragma unroll
      for (int j = 0; j < kBKV / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          REPRO_CHECK(!masked(kv0 + 8 * j + 2 * tig + (e & 1), row_a + 8 * (e >> 1)) ||
                      s[4 * j + e] == 0.f);
#endif
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + sum[r];
  };
  // Keys 16 kk .. 16 kk + 15 of P are the A fragment of product step kk.
  auto pack_p = [&]() {
#pragma unroll
    for (int kk = 0; kk < kBKV / 16; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[kk][i] = pack_bf16(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);
  };

  wait_kv(0);
  wg_fence();
  issue_s(0);
  wg_wait<0>();
  fence_regs(s);
  softmax(0);
  for (int t = 0; t + 1 < n_tiles; ++t) {
    pack_p();
    __syncthreads();  // tile t - 1's slot is free (and plain loads of t + 1 visible)
    if (t + NS - 1 < n_tiles) load_kv(t + NS - 1);
    if constexpr (!kTma && NS == 2) __syncthreads();  // plain loads of t + 1 visible
    wait_kv(t + 1);
    wg_fence();
    issue_s(t + 1);
    issue_pv(t);
    wg_wait<1>();  // S(t + 1) done; O += P(t) V(t) may still run
    fence_regs(s);
    softmax(t + 1);
    wg_wait<0>();
    fence_regs(acc);
    fence_regs(pa);
#ifdef REPRO_CHECKED
    pv_done = t + 1;
#endif
#pragma unroll
    for (int j = 0; j < DVP / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[4 * j + e] *= corr[e >> 1];
  }
  pack_p();
  wg_fence();
  issue_pv(n_tiles - 1);
  wg_wait<0>();
  fence_regs(acc);

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lr = l[r];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    inv[r] = 1.f / fmaxf(lr, 1e-30f);
  }
  const bool pairs = Dv % 2 == 0;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + 8 * r;
    if (row >= Sq) continue;
    __nv_bfloat16* o_row = o + ((int64_t(b) * Sq + row) * H + h) * Dv;
#pragma unroll
    for (int j = 0; j < DVP / 8; ++j) {
      const int col = 8 * j + 2 * tig;
      const float x0 = acc[4 * j + 2 * r] * inv[r], x1 = acc[4 * j + 2 * r + 1] * inv[r];
      if (pairs && col < Dv) {
        *reinterpret_cast<__nv_bfloat162*>(o_row + col) = __floats2bfloat162_rn(x0, x1);
      } else {
        if (col < Dv) o_row[col] = __float2bfloat16(x0);
        if (col + 1 < Dv) o_row[col + 1] = __float2bfloat16(x1);
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded.
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &res) != cudaSuccess ||
        res != cudaDriverEntryPointSuccess)
      p = nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &res) !=
            cudaSuccess ||
        res != cudaDriverEntryPointSuccess)
      p = nullptr;
#endif
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// Tensor map of a contiguous bf16 (B, S, heads, dim) tensor, boxes of
// {64 dims, 1 head, 128 rows, 1 batch}, 128-byte swizzle, zeros outside.
inline cudaError_t make_map(CUtensorMap* map, const void* base, int B, int S, int heads, int dim) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {cuuint64_t(dim), cuuint64_t(heads), cuuint64_t(S), cuuint64_t(B)};
  const cuuint64_t strides[3] = {cuuint64_t(dim) * 2, cuuint64_t(heads) * dim * 2,
                                 cuuint64_t(S) * heads * dim * 2};
  const cuuint32_t box[4] = {kPanel, 1, 128, 1}, step[4] = {1, 1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                         strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int DP, int DVP, int NS, bool kTma>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Skv,
                   int H, int KH, int D, int Dv, float scale, int causal, int window,
                   cudaStream_t stream) {
  CUtensorMap tq{}, tk{}, tv{};
  if constexpr (kTma) {
    cudaError_t err = make_map(&tq, q, B, Sq, H, D);
    if (err == cudaSuccess) err = make_map(&tk, k, B, Skv, KH, D);
    if (err == cudaSuccess) err = make_map(&tv, v, B, Skv, KH, Dv);
    if (err != cudaSuccess) return err;
  }
  const size_t smem =
      sizeof(__nv_bfloat16) * (size_t(kBQ) * DP + NS * size_t(kBKV) * (DP + DVP)) + 1024;
  auto* fn = flash_wgmma_kernel<DP, DVP, NS, kTma>;
  cudaError_t err =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(unsigned(B) * unsigned(H), (Sq + kBQ - 1) / kBQ);
  fn<<<grid, kThreads, smem, stream>>>(
      tq, tk, tv, static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), Sq, Skv, H, KH, D, Dv,
      scale * 1.4426950408889634f, causal, window);
  return cudaGetLastError();
}

// The K/V ring's slots at head width DP: three, or two where three do not
// fit the block's shared memory beside the Q tile.
template <int DP, int DVP>
constexpr int kRing = DP > 128 ? 2 : 3;

template <int DP, int DVP>
cudaError_t launch_tma(bool tma, const void* q, const void* k, const void* v, void* o, int B,
                       int Sq, int Skv, int H, int KH, int D, int Dv, float scale, int causal,
                       int window, cudaStream_t st) {
  constexpr int NS = kRing<DP, DVP>;
  static_assert(2 * (kBQ * DP + NS * kBKV * (DP + DVP)) + 1024 <= 232448,
                "the Q tile and the K/V ring must fit the block's shared memory");
  return tma ? launch<DP, DVP, NS, true>(q, k, v, o, B, Sq, Skv, H, KH, D, Dv, scale, causal,
                                         window, st)
             : launch<DP, DVP, NS, false>(q, k, v, o, B, Sq, Skv, H, KH, D, Dv, scale, causal,
                                          window, st);
}

// bf16 attention on the tensor cores; the caller has checked the shapes.
inline cudaError_t dispatch(const void* q, const void* k, const void* v, void* o, int B, int Sq,
                            int Skv, int H, int KH, int D, int Dv, float scale, int causal,
                            int window, cudaStream_t st) {
  if ((Sq + kBQ - 1) / kBQ > 65535 || int64_t(B) * H > 0x7fffffff) return cudaErrorInvalidValue;
  // TMA needs 16-byte global strides and addresses.
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const bool tma = D % 8 == 0 && Dv % 8 == 0 && aligned(q) && aligned(k) && aligned(v);
  auto* fn = D <= 64    ? (Dv <= 64 ? launch_tma<64, 64> : launch_tma<64, 128>)
             : D <= 128 ? (Dv <= 64 ? launch_tma<128, 64> : launch_tma<128, 128>)
                        : (Dv <= 64 ? launch_tma<192, 64> : launch_tma<192, 128>);
  return fn(tma, q, k, v, o, B, Sq, Skv, H, KH, D, Dv, scale, causal, window, st);
}

}  // namespace fa90
