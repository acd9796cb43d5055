// Blocked bitmap scan with early stopping, for Hopper (sm_90a): the device
// code shared by the ES-scan kernel (bitmap_intersect.cu, kDiff = false;
// it replaces src/repro/kernels/bitmap_intersect.py::bitmap_intersect_es)
// and the dEclat difference kernel (bitmap_diff.cu, kDiff = true; it
// replaces src/repro/kernels/bitmap_diff.py::bitmap_diff_es).  Each
// source instantiates the templates behind its own C entry point.
//
// What bounds it.  The arithmetic is one AND (ANDN) and one popcount a
// word, so the bound is bytes: the operand words up to each pair's abort,
// read from the row-store slab through ua[p]/vb[p] (U and V are never
// materialised), and the survivors' child rows.  The slab's operand rows
// sit in the 50 MB L2 after first touch, so the rate the scan can reach
// is the L2's.  What a naive walk loses instead is latency: the abort
// decision after block k gates the load of block k + 1, so a pair that
// loads one block, reduces it and tests the bound before the next load is
// a serial chain of memory round trips with almost nothing in flight.
//
// The design.  A pair's row is walked in STEPS of kStepWords words per
// warp: every lane issues all of its loads of a step at once (int4 when
// the block width is a multiple of 4 and the rows are 16-byte aligned,
// else 4-byte words; always coalesced), so a step has 2 x 2 KB in flight
// per warp and holds 4 blocks at bw = 128, 64 at bw = 8, 512 at bw = 1
// (per warp: a pair spread over W warps covers W times that a step).
// The abort point inside a step comes from a scan, not from a walk:
// per-element popcounts, a warp inclusive scan of them (two 16-bit
// counts packed in one shuffle), the bound of every block that ends in
// the step (count_k + min(su[k+1], sv[k+1]) for "and", rho - count_k for
// "andnot" and diff, in 64 bits), and a warp min over the failing
// elements' positions (__reduce_min_sync) gives the first failing block.
// cnt, blocks_done and alive come out exactly as the sequential walk's,
// whatever the suffix tables hold: the first failure is found, not the
// last pass, so nothing relies on the bound being monotone.  Words past
// the abort inside its step are read and ignored (at most one step a
// pair; diff also reads the next step's U suffix words, which it loads a
// step ahead so that its data loads need not wait for them); the work
// counter does not see them.
//
// Layouts, chosen per launch from n_pairs and the row length
// (scan_warps_per_pair), never as a fallback.  A pair's steps are a serial
// chain (load, scan, test), so the kernel's floor is its longest pair:
// a survivor walks every step twice.  Spreading a pair over W warps cuts
// that chain W-fold, and pays for it only where the card is already full:
//   * W = 2, 4, 8 warps per pair, while the launch holds fewer than
//     kTargetWarpsPerSm warps an SM and the row gives every warp a
//     portion of its own (4 at the Eclat main path's first dispatch,
//     4186 pairs; 8 at dEclat's, 325): a step spans W warps' consecutive
//     portions; each warp posts its portion's popcount, its count of
//     blocks done and the least bound offset of its block ends to shared
//     memory, and ONE __syncthreads per step lets every warp find the
//     first failing portion; only that warp then locates the failing
//     block;
//   * W = 1 otherwise: a warp owns a pair, kPairsPerCta pairs to a CTA,
//     warp reductions only, no barrier anywhere.
// Block widths that are not a multiple of 4 (and bw = 1, where one int4
// would hold four blocks, each with its own bound and mass) take the
// 4-byte path: 16 loads per operand a lane, still 512 words a step.
//
// Survivors (which scanned every block) make a second pass in the same
// steps, writing the child row as vectors and its suffix table from the
// same scan (suffix[k + 1] = total - count through block k): no per-block
// barrier.  A survivor writes only its own slot in [0, cap); a
// non-survivor's slot and any slot outside [0, cap) are never touched,
// and Z is never written into the slab speculatively.  Child slots never
// alias operand rows within one launch (the row store hands out only free
// slots as children), which is also why the operand loads may take the
// read-only path (__ldg).
//
// kDiff = false: Z = U & V (or U & ~V with `andnot`), blocks_done = blocks
//   visited.
// kDiff = true: Z = U & ~V on the bound rho - count; sv is not read; a
//   block whose U mass su[k] - su[k+1] is <= 0 is not loaded, adds 0 and
//   is not counted in blocks_done (its Z words are still written as zeros
//   where a Z output is asked for).  This requires su to be U's suffix
//   table, which it always is on the mining path.
//
// The threshold.  A pair dies at the first block end whose bound is below
// its threshold: es_minsup for every pair, or thr[p] where a per-pair
// vector is given (the sharded miner's minsup - slack, kernels/ops.py).
// Bounds are compared in 64 bits and never subtracted from a threshold,
// so any int32 threshold is exact, INT32_MIN included; one at or below 0
// never kills an "and" pair (its bound is a count plus suffix masses).

#pragma once

#include <cassert>
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

// REPRO_CHECK: a device-side assert in the checked build (-DREPRO_CHECKED,
// kernels/_build.py), nothing otherwise.  It guards every global index
// against its extent; a failure traps the launch (cudaErrorAssert).
#ifndef REPRO_CHECK
#ifdef REPRO_CHECKED
#define REPRO_CHECK(cond) assert(cond)
#else
#define REPRO_CHECK(cond) ((void)0)
#endif
#endif

namespace repro {

constexpr int kStepWords = 512;      // words one warp covers in one step
constexpr int kPairsPerCta = 4;      // pairs (one warp each) per CTA at W = 1
constexpr int kMaxWarpsPerPair = 8;
constexpr int kTargetWarpsPerSm = 64;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kNoFail = 0xffffffffu;

struct ScanArgs {
  const int32_t* U;      // rows of the U operands (slab or (P, nb, bw))
  const int32_t* V;
  const int32_t* su;     // suffix tables, (rows, nb + 1)
  const int32_t* sv;     // (not read when kDiff)
  const int32_t* ua;     // (P,) U row per pair, or null for row p
  const int32_t* vb;     // (P,) V row per pair, or null for row p
  const int32_t* rho;    // (P,) parent support ("andnot"/diff bound)
  int n_pairs, nb, bw;
  int es_minsup;         // ES threshold of every pair, where thr is null
  const int32_t* thr;    // (P,) per-pair ES threshold, or null
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

// VW words per load: int4 on the vector path, one word on the scalar one.
template <int VW> struct Vec;
template <> struct Vec<4> { using T = int4; };
template <> struct Vec<1> { using T = int32_t; };

__device__ __forceinline__ int4 zvec(int4 u, int4 v, int32_t f) {
  return make_int4(u.x & (v.x ^ f), u.y & (v.y ^ f), u.z & (v.z ^ f),
                   u.w & (v.w ^ f));
}
__device__ __forceinline__ int32_t zvec(int32_t u, int32_t v, int32_t f) {
  return u & (v ^ f);
}
__device__ __forceinline__ int popc(int4 x) {
  return __popc(x.x) + __popc(x.y) + __popc(x.z) + __popc(x.w);
}
__device__ __forceinline__ int popc(int32_t x) { return __popc(x); }
template <class T> __device__ __forceinline__ T zero_vec();
template <> __device__ __forceinline__ int4 zero_vec<int4>() {
  return make_int4(0, 0, 0, 0);
}
template <> __device__ __forceinline__ int32_t zero_vec<int32_t>() { return 0; }

// One pair's operands, in units of VW-word vectors.
template <int VW>
struct PairView {
  using T = typename Vec<VW>::T;
  const T* u;
  const T* v;
  const int32_t* su;
  const int32_t* sv;     // null when kDiff
  int row_vecs;          // nb * bw / VW
  int bvec;              // vectors per block (bw / VW)
  int q32, r32;          // 32 vectors = q32 blocks + r32 vectors
  int32_t vflip;         // z = u & (v ^ vflip)
  bool andnot;
};

// One warp's portion of a step: element j of a lane is vector
// e0 + 32 j + lane, so every load instruction of the warp is coalesced.
// Each element lies in one block (bw is a multiple of VW).
template <int VW, int L>
struct Step {
  using T = typename Vec<VW>::T;
  T z[L];          // z, zero for skipped and absent elements
  int incl[L];     // popcount of the portion up to and including element j
  int blk[L];      // the element's block
  int aux[L];      // "and": min(su[k+1], sv[k+1]) at a block end;
                   // diff: the block's U mass
  unsigned live;   // bit j: element j lies in the row
  unsigned ends;   // bit j: element j is its block's last
  int total;       // the portion's popcount
};

// Diff: the U masses su[k] - su[k+1] of a warp portion's elements (0
// outside the row), loaded a step ahead so that the data loads, which
// skip zero-mass blocks, never wait on them.
template <int VW, int L>
__device__ __forceinline__ void load_masses(int (&m)[L], const PairView<VW>& pv,
                                            int e0, int lane) {
  int e = e0 + lane;
  int k = e / pv.bvec;
  int r = e - k * pv.bvec;
#pragma unroll
  for (int j = 0; j < L; ++j) {
    REPRO_CHECK(e >= pv.row_vecs || (k >= 0 && k < pv.row_vecs / pv.bvec));
    m[j] = e < pv.row_vecs ? __ldg(pv.su + k) - __ldg(pv.su + k + 1) : 0;
    e += 32;
    k += pv.q32;
    r += pv.r32;
    if (r >= pv.bvec) {
      r -= pv.bvec;
      ++k;
    }
  }
}

// Issue every load of a warp's step portion at once, then popcount and
// scan.  kBound: read the suffix minima the "and" bound needs; `mass`:
// the elements' U masses (diff only).
template <bool kDiff, bool kBound, int VW, int L>
__device__ __forceinline__ void load_step(Step<VW, L>& st,
                                          const PairView<VW>& pv, int e0,
                                          int lane, const int (&mass)[L]) {
  using T = typename Vec<VW>::T;
  int e = e0 + lane;
  int k = e / pv.bvec;
  int r = e - k * pv.bvec;
  int c[L];
  st.live = 0;
  st.ends = 0;
#pragma unroll
  for (int j = 0; j < L; ++j) {
    const bool in = e < pv.row_vecs;
    const bool end = in && r == pv.bvec - 1;
    REPRO_CHECK(!in || (e >= 0 && k >= 0 && k < pv.row_vecs / pv.bvec &&
                        r >= 0 && r < pv.bvec));
    bool load = in;
    st.blk[j] = k;
    st.aux[j] = 0;
    if constexpr (kDiff) {
      st.aux[j] = mass[j];
      load = in && mass[j] > 0;
    } else if (kBound) {
      if (end && !pv.andnot)
        st.aux[j] = min(__ldg(pv.su + k + 1), __ldg(pv.sv + k + 1));
    }
    const T u = load ? __ldg(pv.u + e) : zero_vec<T>();
    const T v = load ? __ldg(pv.v + e) : zero_vec<T>();
    st.z[j] = zvec(u, v, pv.vflip);
    c[j] = popc(st.z[j]);
    st.live |= static_cast<unsigned>(in) << j;
    st.ends |= static_cast<unsigned>(end) << j;
    e += 32;
    k += pv.q32;
    r += pv.r32;
    if (r >= pv.bvec) {
      r -= pv.bvec;
      ++k;
    }
  }
  // Inclusive scan over (j, lane) in that order: two elements' counts per
  // shuffle, 16 bits each (a field sums at most 32 lanes x 32 VW bits =
  // 4096, so it never carries into the next).
  int run = 0;
#pragma unroll
  for (int j = 0; j < L; j += 2) {
    int x = c[j] | (c[j + 1] << 16);
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(kFull, x, off);
      if (lane >= off) x += y;
    }
    const int t = __shfl_sync(kFull, x, 31);
    st.incl[j] = run + (x & 0xffff);
    run += t & 0xffff;
    st.incl[j + 1] = run + (x >> 16);
    run += t >> 16;
  }
  st.total = run;
}

// The bound of block end j of a portion whose bound base is `base`:
// "and": base = count before the portion, bound = base + incl + aux;
// "andnot"/diff: base = rho - count before the portion, bound = base - incl.
template <int VW, int L>
__device__ __forceinline__ long long end_bound(const Step<VW, L>& st, int j,
                                               bool andnot, long long base) {
  return andnot ? base - st.incl[j]
                : base + st.incl[j] + static_cast<long long>(st.aux[j]);
}

// The warp's first failing block end as its position 32 j + lane (warp
// uniform), or kNoFail.  The lane that owns it gets its inclusive count
// in `pf` and its block in `kf`.
template <int VW, int L>
__device__ __forceinline__ unsigned first_fail(const Step<VW, L>& st,
                                               bool andnot, long long base,
                                               int thr, int lane, int& pf,
                                               int& kf) {
  unsigned key = kNoFail;
#pragma unroll
  for (int j = L - 1; j >= 0; --j) {   // descending: the first j wins
    if ((st.ends >> j & 1u) && end_bound(st, j, andnot, base) < thr) {
      key = 32u * j + lane;
      pf = st.incl[j];
      kf = st.blk[j];
    }
  }
  return __reduce_min_sync(kFull, key);
}

// Diff: the lane's block ends with positive U mass among positions <= lim.
template <int VW, int L>
__device__ __forceinline__ int massive_ends(const Step<VW, L>& st,
                                            unsigned lim, int lane) {
  int n = 0;
#pragma unroll
  for (int j = 0; j < L; ++j)
    n += (st.ends >> j & 1u) && st.aux[j] > 0 && 32u * j + lane <= lim;
  return n;
}

// Z of a warp's portion: z at positions <= lim, zero past it.
template <int VW, int L>
__device__ __forceinline__ void write_z(typename Vec<VW>::T* z,
                                        const Step<VW, L>& st, int e0,
                                        int lane, int lim) {
#pragma unroll
  for (int j = 0; j < L; ++j)
    if (st.live >> j & 1u)
      z[e0 + 32 * j + lane] = 32 * j + lane <= lim
                                  ? st.z[j]
                                  : zero_vec<typename Vec<VW>::T>();
}

struct PortionSum {
  long long min_g;   // least bound offset over the portion's block ends
  int total;         // the portion's popcount
  int massive;       // diff: its block ends with positive U mass
};

template <bool kDiff, int W, int VW>
__global__ void __launch_bounds__(W == 1 ? 32 * kPairsPerCta : 32 * W)
es_scan_kernel(ScanArgs a) {
  using T = typename Vec<VW>::T;
  constexpr int L = kStepWords / 32 / VW;   // loads per operand per lane
  constexpr int kWarpVecs = 32 * L;
  __shared__ PortionSum red[2][W];
  const int lane = threadIdx.x & 31;
  const int wi = W == 1 ? 0 : threadIdx.x >> 5;   // warp within the pair
  const int p = W == 1 ? blockIdx.x * kPairsPerCta + (threadIdx.x >> 5)
                       : blockIdx.x;
  if (W == 1 && p >= a.n_pairs) return;

  const int64_t row_words = static_cast<int64_t>(a.nb) * a.bw;
  const int64_t iu = a.ua ? a.ua[p] : p;
  const int64_t iv = a.vb ? a.vb[p] : p;
  // Operand rows index the slab (cap rows) when gathered, else the batch.
  REPRO_CHECK(iu >= 0 && iu < (a.ua ? a.cap : a.n_pairs));
  REPRO_CHECK(iv >= 0 && iv < (a.vb ? a.cap : a.n_pairs));
  REPRO_CHECK(W == 1 || wi < W);
  PairView<VW> pv;
  pv.u = reinterpret_cast<const T*>(a.U + iu * row_words);
  pv.v = reinterpret_cast<const T*>(a.V + iv * row_words);
  pv.su = a.su + iu * (a.nb + 1);
  pv.sv = kDiff ? nullptr : a.sv + iv * (a.nb + 1);
  pv.row_vecs = static_cast<int>(row_words / VW);
  pv.bvec = a.bw / VW;
  pv.q32 = 32 / pv.bvec;
  pv.r32 = 32 % pv.bvec;
  pv.andnot = kDiff || a.andnot;
  pv.vflip = pv.andnot ? -1 : 0;
  const long long rho = a.rho[p];
  const int thr = a.thr ? a.thr[p] : a.es_minsup;
  T* z = a.Z ? reinterpret_cast<T*>(a.Z + static_cast<int64_t>(p) * row_words)
             : nullptr;
  const int step_vecs = W * kWarpVecs;
  const int n_steps = (pv.row_vecs + step_vecs - 1) / step_vecs;

  Step<VW, L> st;
  int mass[L] = {}, next[L] = {};   // diff: this step's and the next's
  if constexpr (kDiff) load_masses(mass, pv, wi * kWarpVecs, lane);
  long long carry = 0;   // popcount of the steps before
  int done = 0;          // diff: positive-mass blocks done
  int phase = 0;         // barriers passed (picks the shared buffer)
  int s = 0;
  bool alive = true;
  for (; s < n_steps; ++s) {
    const int e0 = s * step_vecs + wi * kWarpVecs;
    if constexpr (kDiff) load_masses(next, pv, e0 + step_vecs, lane);
    load_step<kDiff, true>(st, pv, e0, lane, mass);
#pragma unroll
    for (int j = 0; j < L; ++j) mass[j] = next[j];
    // Which warp of the pair holds the first failing block end, the count
    // before this warp's portion, and the step's totals.
    int fw = -1;
    long long off = 0, step_total = st.total;
    int massive_before = 0, massive_all = 0;
    unsigned key = kNoFail;
    int pf = 0, kf = 0;
    if constexpr (W == 1) {
      key = first_fail(st, pv.andnot, pv.andnot ? rho - carry : carry, thr,
                       lane, pf, kf);
      fw = key == kNoFail ? -1 : 0;
      if (kDiff && fw < 0)
        massive_all = __reduce_add_sync(kFull, massive_ends(st, kNoFail, lane));
    } else {
      long long g = LLONG_MAX;
#pragma unroll
      for (int j = 0; j < L; ++j)
        if (st.ends >> j & 1u)
          g = min(g, end_bound(st, j, pv.andnot, 0));
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) g = min(g, __shfl_xor_sync(kFull, g, o));
      const int m = kDiff ? __reduce_add_sync(kFull, massive_ends(st, kNoFail, lane))
                          : 0;
      PortionSum* buf = red[phase & 1];
      if (lane == 0) buf[wi] = PortionSum{g, st.total, m};
      __syncthreads();
      ++phase;
      long long acc = 0;
      int macc = 0;
#pragma unroll
      for (int w = 0; w < W; ++w) {
        const PortionSum ps = buf[w];
        if (w == wi) {
          off = acc;
          massive_before = macc;
        }
        if (fw < 0 && ps.min_g != LLONG_MAX &&
            (pv.andnot ? rho - carry - acc : carry + acc) + ps.min_g < thr) {
          fw = w;
          if (w < wi) break;   // this warp's portion lies past the abort
        }
        if (fw < 0) macc += ps.massive;
        acc += ps.total;
      }
      step_total = acc;
      massive_all = macc;
      if (fw == wi)
        key = first_fail(st, pv.andnot,
                         pv.andnot ? rho - carry - off : carry + off, thr,
                         lane, pf, kf);
    }
    if (fw < 0) {
      carry += step_total;
      done += massive_all;
      if (z) write_z(z, st, e0, lane, INT_MAX);
      continue;
    }
    // The pair dies in this step.
    alive = false;
    if (wi == fw) {
      const int owner = key & 31;
      const long long cnt = carry + off + __shfl_sync(kFull, pf, owner);
      const int k_abort = __shfl_sync(kFull, kf, owner);
      int nblocks = k_abort + 1;
      if constexpr (kDiff)
        nblocks = done + massive_before +
                  __reduce_add_sync(kFull, massive_ends(st, key, lane));
      if (lane == 0) {
        a.cnt[p] = static_cast<int32_t>(cnt);
        a.blocks[p] = nblocks;
        a.alive[p] = 0;
      }
    }
    if (z)
      write_z(z, st, e0, lane,
              wi < fw ? INT_MAX : wi == fw ? static_cast<int>(key) : -1);
    break;
  }
  if (!alive) {
    if (z) {   // blocks past the abort's step read back as zero
      for (int i = (s + 1) * step_vecs + threadIdx.x % (32 * W);
           i < pv.row_vecs; i += 32 * W)
        z[i] = zero_vec<T>();
    }
    return;
  }
  if (wi == 0 && lane == 0) {
    a.cnt[p] = static_cast<int32_t>(carry);
    a.blocks[p] = kDiff ? done : a.nb;
    a.alive[p] = 1;
  }
  if (!a.child_rows) return;

  const long long support = pv.andnot ? rho - carry : carry;
  const int slot = a.slots[p];
  if (support < a.gate_minsup || slot < 0 || slot >= a.cap) return;
  REPRO_CHECK(a.child_suffix != nullptr);

  // Survivor epilogue: the same steps again, writing the child row and
  // its suffix table (suffix[k + 1] = total - count through block k).
  T* out = reinterpret_cast<T*>(a.child_rows + static_cast<int64_t>(slot) *
                                                   row_words);
  int32_t* osuf = a.child_suffix + static_cast<int64_t>(slot) * (a.nb + 1);
  const long long total = carry;
  if (wi == 0 && lane == 0) osuf[0] = static_cast<int32_t>(total);
  long long before = 0;
  if constexpr (kDiff) load_masses(mass, pv, wi * kWarpVecs, lane);
  for (int s2 = 0; s2 < n_steps; ++s2) {
    const int e0 = s2 * step_vecs + wi * kWarpVecs;
    if constexpr (kDiff) load_masses(next, pv, e0 + step_vecs, lane);
    load_step<kDiff, false>(st, pv, e0, lane, mass);
#pragma unroll
    for (int j = 0; j < L; ++j) mass[j] = next[j];
    long long off = 0, step_total = st.total;
    if constexpr (W > 1) {
      PortionSum* buf = red[phase & 1];
      if (lane == 0) buf[wi].total = st.total;
      __syncthreads();
      ++phase;
      step_total = 0;
#pragma unroll
      for (int w = 0; w < W; ++w) {
        if (w == wi) off = step_total;
        step_total += buf[w].total;
      }
    }
#pragma unroll
    for (int j = 0; j < L; ++j) {
      if (st.live >> j & 1u) out[e0 + 32 * j + lane] = st.z[j];
      REPRO_CHECK(!(st.ends >> j & 1u) || (st.blk[j] >= 0 && st.blk[j] < a.nb));
      if (st.ends >> j & 1u)
        osuf[st.blk[j] + 1] =
            static_cast<int32_t>(total - (before + off + st.incl[j]));
    }
    before += step_total;
  }
}

// Warps per pair: spread a pair over more warps only while the launch
// would hold fewer than kTargetWarpsPerSm warps per SM and the row still
// gives every warp a portion of its own.
inline int scan_warps_per_pair(int n_pairs, int nb, int bw) {
  static int sms = 0;
  if (sms <= 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        sms <= 0)
      sms = 132;
  }
  const long long row_words = static_cast<long long>(nb) * bw;
  int w = 1;
  while (w < kMaxWarpsPerPair &&
         static_cast<long long>(n_pairs) * w <
             static_cast<long long>(kTargetWarpsPerSm) * sms &&
         2LL * w * kStepWords <= row_words)
    w *= 2;
  return w;
}

template <bool kDiff, int W, int VW>
inline void launch_scan_w(const ScanArgs& a, cudaStream_t stream) {
  if (W == 1)
    es_scan_kernel<kDiff, W, VW>
        <<<(a.n_pairs + kPairsPerCta - 1) / kPairsPerCta, 32 * kPairsPerCta, 0,
           stream>>>(a);
  else
    es_scan_kernel<kDiff, W, VW><<<a.n_pairs, 32 * W, 0, stream>>>(a);
}

template <bool kDiff, int VW>
inline void launch_scan_vw(const ScanArgs& a, int w, cudaStream_t stream) {
  switch (w) {
    case 1: launch_scan_w<kDiff, 1, VW>(a, stream); break;
    case 2: launch_scan_w<kDiff, 2, VW>(a, stream); break;
    case 4: launch_scan_w<kDiff, 4, VW>(a, stream); break;
    default: launch_scan_w<kDiff, 8, VW>(a, stream); break;
  }
}

inline bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0;
}

// int4 loads need whole vectors per block and 16-byte aligned rows.
inline bool scan_vectorised(const ScanArgs& a) {
  return a.bw % 4 == 0 && aligned16(a.U) && aligned16(a.V) &&
         (!a.Z || aligned16(a.Z)) && (!a.child_rows || aligned16(a.child_rows));
}

template <bool kDiff>
inline int launch_scan(const ScanArgs& a, cudaStream_t stream) {
  const int w = scan_warps_per_pair(a.n_pairs, a.nb, a.bw);
  if (scan_vectorised(a))
    launch_scan_vw<kDiff, 4>(a, w, stream);
  else
    launch_scan_vw<kDiff, 1>(a, w, stream);
  return static_cast<int>(cudaGetLastError());
}

inline ScanArgs make_scan_args(const void* U, const void* V, const void* su,
                               const void* sv, const void* ua, const void* vb,
                               const void* rho, int n_pairs, int nb, int bw,
                               int es_minsup, const void* thr, int andnot,
                               void* Z, void* cnt,
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
  a.thr = static_cast<const int32_t*>(thr);
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
