// PrePost+ N-list merge with early stopping, and the Z-merge scatter, for
// Hopper (sm_90a).
//
// nl_merge_kernel replaces the TPU kernel src/repro/kernels/nlist_merge.py::
// nlist_merge (body `_kernel`) together with the operand gather and the
// Z-merge group count that ops._nlist_presize_impl wraps around it.
// zmerge_scatter_kernel replaces ref._nl_zmerge_scatter, which is jnp in
// the JAX package (no Pallas kernel): it backs ops.nlist_scatter.
// Semantics are pinned by repro_torch/kernels/ref.py::nlist_presize_ref and
// nlist_scatter_ref, bit for bit, on any input: the operands need not come
// from a PPC-tree (the tests feed pre-sorted codes with random post).
//
// What bounds them on this card.  The merge must take the sequential
// two-pointer walk's exact path, because its comparison and check counts
// are oracle-exact counters, so one pair is a chain of data-dependent
// steps: the kernel's time is set by the longest pair's chain (6799 steps
// in the first kosarak pre-pass) and by the work of all pairs together,
// far above the bytes it must move (every N-list once plus the P x lu
// match table).  A one-thread walk pays a dependent global load per step.
// The scatter only has to read the match table once, so it is bound by
// bytes (P x lu x 4), if every row is read coalesced.
//
// The merge's design: a warp per pair, 4 warps to a CTA.  Lane r holds U
// code ib + r of a 32-code U window, lane c V code jb + c of a 32-code V
// window, in registers (the V window also in shared memory for broadcast
// reads), and the next two windows of each are in flight.  Lane r turns
// its U code into two masks over the V window: adv (the walk would leave
// row r at that column: x.pre <= y.pre or x a descendant of y) and desc
// (x a descendant of y).  The path through the windows is the recurrence
// e_r = first adv column >= e_{r-1} (e_{r0-1} = the entry column), and
// 32 where row r leaves the V window to the right.  Each lane computes its
// row's e_r from its neighbour's in rounds (a shuffle and an __ffs): after
// k rounds the first k rows are exact, and a round that changes nothing
// has reached the recurrence's only solution, so the result is exact on
// any input; on N-lists of a PPC-tree the first round is already the
// answer.  From the path, in parallel: each row's match (desc at e_r),
// z_mass by a warp prefix sum, the Z-merge group starts (a match whose
// column differs from the previous match's, ref._nl_group_starts), the
// comparison and check counts.  Early stopping: the guard
// z_mass + (rho - skip) >= minsup holds after every step or the walk
// aborts there, evaluated in int32 wrap-around arithmetic as the
// sequential loop does.  Skip at column c is the V window's starting skip
// plus an inclusive prefix sum of its frequencies, so lane c holds it.
// Every lane checks the guard of its own j-step (as a column, with the
// z_mass of the row whose j-steps cover it) and of its own i-step (as a
// row), and a warp min over the failing steps' positions finds the abort;
// steps past it are not counted and their matches not kept.  Without a
// match in the block z_mass holds, so only the j-steps need checking.  The
// walk then leaves the U window at the bottom (its 32 match-table entries
// go out as one coalesced store) or the V window to the right.  The rest
// of each match-table row is filled with the sentinel by 16-byte stores,
// no CTA barrier needed.  The engine sorts pairs shortest first, so the
// grid is walked from the last pair back and the longest walks start
// first.  What is left: the longest pair is a chain of window blocks,
// each a string of dependent shared-memory reads, shuffles and votes
// (masks, rounds, scans, the guard check); one pair is never split across
// warps.
//
// The scatter's design: a warp per pair reads its out_slot row 128
// entries at a time (an int4 per lane where the row is 16-byte aligned,
// two chunks in flight).  Group starts come from a warp max-scan that
// carries the running maximum of the valid slots across chunks (start =
// valid && slot != running max before it), counted by a warp sum; chunks
// with no valid slot cost one vote.  Only pairs with a destination in
// [0, cap) do the rest: a warp sum scan of the U frequencies gives each
// start the prefix of U mass before it, a segmented scan carries the
// previous start's prefix, and the difference is the previous group's
// frequency.  Group g's (pre, post) is the representative V code's (the
// sentinel and 0 past v_len), written at out_off + g, and only
// destinations inside [0, cap) are written.
//
// C interface (ctypes): pointers and the stream are void*, sizes int or
// long long; each entry returns cudaGetLastError() after its launch.
//
// The checked build (-DREPRO_CHECKED, kernels/_build.py) turns REPRO_CHECK
// into a device-side assert on every global index against its extent and
// on every window bound, and adds repro_nlist_set_packed_adv, which makes
// the merge build its adv mask in the packed form desc | (x.pre <= y.pre)
// instead of the committed (x.pre <= y.pre) | (x.post < y.post): the same
// predicate, kept to reproduce one unexplained reading on the card.

#include <cassert>
#include <cstdint>
#include <cuda_runtime.h>

#ifdef REPRO_CHECKED
#define REPRO_CHECK(cond) assert(cond)
#else
#define REPRO_CHECK(cond) ((void)0)
#endif

namespace {

constexpr int kWarps = 4;  // pairs (warps) per CTA
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;
constexpr int32_t kSentinel = 0x7fffffff;
constexpr unsigned kNoFail = 0xffffffffu;

__device__ __forceinline__ const int32_t* code_at(const int32_t* codes, int64_t cap,
                                                  int64_t idx) {
  idx = idx < 0 ? 0 : (idx >= cap ? cap - 1 : idx);
  return codes + 3 * idx;
}

// int32 arithmetic that wraps, as the reference's does, without signed
// overflow.
__device__ __forceinline__ int wadd(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}
__device__ __forceinline__ int wsub(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) - static_cast<unsigned>(b));
}
// The early-stopping guard, evaluated as the sequential loop evaluates it.
__device__ __forceinline__ bool guard_holds(int z_mass, int rho, int skip, int minsup) {
  return wadd(z_mass, wsub(rho, skip)) >= minsup;
}

struct Code {
  int pre, post, freq;
};

__device__ __forceinline__ Code load_code(const int32_t* codes, int64_t cap, int64_t idx) {
  const int32_t* c = code_at(codes, cap, idx);
  return {c[0], c[1], c[2]};
}

// Inclusive warp prefix sum (wrapping).
__device__ __forceinline__ int warp_incl_sum(int v, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int o = __shfl_up_sync(kFull, v, off);
    if (lane >= off) v = wadd(v, o);
  }
  return v;
}

// Fill row[from, to) with the sentinel: scalar head and tail, 16-byte
// stores in between, the warp's lanes on neighbouring addresses.
__device__ __forceinline__ void fill_sentinel(int32_t* row, int64_t from, int64_t to,
                                              int lane) {
  if (from >= to) return;
  int64_t a = from;
  while (a < to && (reinterpret_cast<uintptr_t>(row + a) & 15) != 0) ++a;  // <= 3 steps
  const int64_t b = a + ((to - a) & ~int64_t{3});
  for (int64_t k = from + lane; k < a; k += 32) row[k] = kSentinel;
  const int4 s4 = make_int4(kSentinel, kSentinel, kSentinel, kSentinel);
  for (int64_t k = a + 4 * lane; k < b; k += 128) *reinterpret_cast<int4*>(row + k) = s4;
  for (int64_t k = b + lane; k < to; k += 32) row[k] = kSentinel;
}

// First column >= c whose bit is set in adv, 32 for none.
__device__ __forceinline__ int first_adv(unsigned adv, int c) {
  const unsigned m = c < 32 ? adv & (kFull << c) : 0u;
  return m ? __ffs(m) - 1 : 32;
}

// Per-warp shared memory: the V window's (pre, post), and for early
// stopping the row whose j-steps start at each column with z_mass there.
struct WarpSmem {
  int2 vw[32];
  int own_row[32];
  int own_z[32];
};

struct RowMasks {
  unsigned adv, desc;
};

// The masks of lane r's U row (x_pre, x_post) against the V window,
// columns in cols only: bit c of adv where the walk leaves the row at
// column c (x is a descendant of y, or x.pre <= y.pre), bit c of desc
// where x is a descendant of y (x.pre > y.pre and x.post < y.post).  The
// V window is read from shared memory by broadcast.
template <bool kPacked>
__device__ __forceinline__ RowMasks row_masks(int x_pre, int x_post, const int2* vw,
                                              unsigned cols) {
  unsigned le = 0, post_lt = 0;
#pragma unroll
  for (int c = 0; c < 32; ++c) {
    const int2 y = vw[c];
    le |= static_cast<unsigned>(x_pre <= y.x) << c;
    post_lt |= static_cast<unsigned>(x_post < y.y) << c;
  }
  const unsigned desc = ~le & post_lt & cols;
  if (kPacked) return {(desc | le) & cols, desc};
  // desc || x.pre <= y.pre  ==  x.pre <= y.pre || x.post < y.post
  return {(le | post_lt) & cols, desc};
}

template <bool kEarlyStop, bool kPacked>
__global__ void __launch_bounds__(kThreads)
nl_merge_kernel(const int32_t* __restrict__ codes, int64_t cap,
                const int32_t* __restrict__ u_off, const int32_t* __restrict__ u_len,
                const int32_t* __restrict__ v_off, const int32_t* __restrict__ v_len,
                const int32_t* __restrict__ rho_v, int64_t n_pairs, int64_t lu,
                int minsup, int32_t* __restrict__ out_slot,
                int32_t* __restrict__ child_len, int32_t* __restrict__ support,
                int32_t* __restrict__ cmps_out, int32_t* __restrict__ checks_out,
                uint8_t* __restrict__ alive_out) {
  __shared__ WarpSmem smem_all[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // CTAs start in blockIdx order and the engine sorts its pairs by length
  // bucket, shortest first: walk the grid from the last pair back, so that
  // the longest walks start first.
  const int64_t p = n_pairs - 1 - (static_cast<int64_t>(blockIdx.x) * kWarps + warp);
  if (p < 0) return;  // warp-uniform
  WarpSmem& sm = smem_all[warp];
  const int nu = u_len[p], nv = v_len[p];
  const int64_t uo = u_off[p], vo = v_off[p];
  const int rho = rho_v[p];
  int32_t* row = out_slot + p * lu;
  REPRO_CHECK(nu >= 0 && nv >= 0 && nu <= lu);
  REPRO_CHECK(nu == 0 || (uo >= 0 && uo + nu <= cap));
  REPRO_CHECK(nv == 0 || (vo >= 0 && vo + nv <= cap));

  int z_mass = 0, cmps = 0, checks = 0, groups = 0, last_j = -1;
  bool alive = true;
  int64_t written = 0;  // match-table entries [0, written) stored

  if (nu > 0 && nv > 0) {
    int ib = 0, jb = 0;  // window bases in U and V
    int r0 = 0, c0 = 0;  // where the walk enters the current windows
    // Lane r holds U code ib + r, lane c V code jb + c; the next two
    // windows of each are in flight.
    Code x = load_code(codes, cap, uo + lane);
    Code x_n1 = load_code(codes, cap, uo + 32 + lane);
    Code x_n2 = load_code(codes, cap, uo + 64 + lane);
    Code y = load_code(codes, cap, vo + lane);
    Code y_n1 = load_code(codes, cap, vo + 32 + lane);
    Code y_n2 = load_code(codes, cap, vo + 64 + lane);
    int nrows = min(32, nu), ncols = min(32, nv);
    unsigned cols = ncols == 32 ? kFull : (1u << ncols) - 1;
    int s_in = 0, s_ex = 0;  // skip after / before a j-step at this lane's column
    if (kEarlyStop) {
      s_in = warp_incl_sum(y.freq, lane);
      s_ex = wsub(s_in, y.freq);
    }
    sm.vw[lane] = make_int2(y.pre, y.post);
    __syncwarp();
    RowMasks m = row_masks<kPacked>(x.pre, x.post, sm.vw, cols);
    int my_slot = kSentinel;  // lane r: U code ib + r's match

    for (;;) {
      // 1. The path through the windows.  Row r leaves at e_r = the first
      // adv column >= e_{r-1} (e_{r0-1} = c0), 32 if it leaves the V window
      // to the right.  Each round makes one more row exact; a round that
      // changes nothing has reached the recurrence's only solution.
      const bool live = lane >= r0 && lane < nrows;
      int e = live ? first_adv(m.adv, c0) : (lane < r0 ? 0 : 32);
      int prev = c0;
      for (;;) {
        prev = __shfl_up_sync(kFull, e, 1);
        if (lane == r0) prev = c0;
        const int e2 = live ? first_adv(m.adv, prev) : e;
        if (!__any_sync(kFull, e2 != e)) break;
        e = e2;
      }
      const unsigned exits = __ballot_sync(kFull, live && e == 32);
      const bool right = exits != 0;
      const int r_end = right ? __ffs(exits) - 1 : nrows;  // rows [r0, r_end) take an i-step
      const bool istep = lane >= r0 && lane < r_end;
      const int c_end = right ? ncols : __shfl_sync(kFull, e, (r_end - 1) & 31);
      REPRO_CHECK(ib >= 0 && ib < nu && jb >= 0 && jb < nv);
      REPRO_CHECK(nrows >= 1 && nrows <= 32 && ncols >= 1 && ncols <= 32);
      REPRO_CHECK(r0 >= 0 && r0 <= r_end && r_end <= nrows);
      REPRO_CHECK(c0 >= 0 && c0 <= c_end && c_end <= ncols);
      REPRO_CHECK(!live || (e >= c0 && e <= 32));

      // 2. Matches, z_mass and Z-merge groups along the path.  Hit
      // columns never decrease along the path: a hit starts a group where
      // its column differs from the previous hit's.
      const bool hit = istep && ((m.desc >> (e & 31)) & 1u);
      const unsigned hits = __ballot_sync(kFull, hit);
      int z_after = z_mass, z_before = z_mass, z_end = z_mass, g_after = groups;
      unsigned starts = 0;
      if (hits) {
        const int dz = hit ? x.freq : 0;
        const unsigned earlier = hits & ((1u << lane) - 1u);
        const int prev_col = __shfl_sync(kFull, jb + e, earlier ? 31 - __clz(earlier) : 0);
        starts = __ballot_sync(kFull, hit && jb + e != (earlier ? prev_col : last_j));
        last_j = __shfl_sync(kFull, jb + e, 31 - __clz(hits));
        if (kEarlyStop) {
          z_after = wadd(z_mass, warp_incl_sum(dz, lane));
          z_before = wsub(z_after, dz);
          z_end = __shfl_sync(kFull, z_after, 31);
          g_after = groups + __popc(starts & (kFull >> (31 - lane)));
        } else {
          z_end = wadd(z_mass, static_cast<int>(__reduce_add_sync(kFull, static_cast<unsigned>(dz))));
        }
      }

      // 3. Early stopping: the guard after every step of the block.  A
      // warp min over the failing steps' positions (i-steps and j-steps
      // before them, packed with the j-steps up to them) finds the first.
      if (kEarlyStop) {
        unsigned key = kNoFail;
        if (!hits) {
          // z_mass holds through the block, so only j-steps move the
          // guard; an i-step without a match repeats the value before it,
          // which held, unless it is the walk's first step (then: rho).
          const unsigned run = (c_end > c0 ? (kFull >> (32 - c_end)) : 0u) & (kFull << c0);
          const unsigned fj =
              __ballot_sync(kFull, !guard_holds(z_mass, rho, s_in, minsup)) & run;
          if (fj) {
            const int k = __ffs(fj) - 1;
            const int i_before = __popc(__ballot_sync(kFull, istep && e <= k));
            key = (i_before + (k - c0)) * 64 + (k - c0 + 1);
          }
          if (cmps == 0 && r_end > 0 && __shfl_sync(kFull, e, 0) == 0 &&
              !guard_holds(0, rho, 0, minsup))
            key = 0;
        } else {
          // As a column, a lane checks its j-step with the z_mass of the
          // row whose j-steps cover it; as a row, its i-step.
          const bool exit_row = right && lane == r_end;
          const int run_end = exit_row ? ncols : e;
          const bool has_run = (istep || exit_row) && run_end > prev;
          const unsigned run_starts = __reduce_or_sync(kFull, has_run ? 1u << prev : 0u);
          REPRO_CHECK(!has_run || (prev >= 0 && prev < 32));
          if (has_run) {
            sm.own_row[prev] = lane;
            sm.own_z[prev] = z_before;
          }
          __syncwarp();
          if (lane >= c0 && lane < c_end) {
            const int s = 31 - __clz(run_starts & (kFull >> (31 - lane)));
            REPRO_CHECK(s >= c0 && s <= lane);
            const int owner = sm.own_row[s];
            if (!guard_holds(sm.own_z[s], rho, s_in, minsup))
              key = ((owner - r0) + (lane - c0)) * 64 + (lane - c0 + 1);
          }
          const int skip_at = __shfl_sync(kFull, s_ex, e & 31);
          if (istep && !guard_holds(z_after, rho, skip_at, minsup))
            key = min(key, static_cast<unsigned>(((lane - r0) + (e - c0)) * 64 + (e - c0)));
          __syncwarp();
        }
        key = __reduce_min_sync(kFull, key);
        if (key != kNoFail) {
          const int idx = static_cast<int>(key >> 6);
          cmps += idx + 1;
          checks += static_cast<int>(key & 63);
          alive = false;
          const bool kept = istep && (lane - r0) + (e - c0) <= idx;
          const int n_kept = __popc(__ballot_sync(kFull, kept));
          const int g = __shfl_sync(kFull, g_after, (r0 + n_kept - 1) & 31);
          if (n_kept > 0) groups = g;
          if (kept && hit) my_slot = jb + e;
          break;
        }
      }
      cmps += (r_end - r0) + (c_end - c0);
      checks += c_end - c0;
      if (hit) my_slot = jb + e;
      z_mass = z_end;
      groups += __popc(starts);

      // 4. Slide the window the path left.
      if (right) {
        if (jb + ncols >= nv) break;  // j reached nv
        const int skip0 = kEarlyStop ? __shfl_sync(kFull, s_in, 31) : 0;
        jb += 32;
        y = y_n1;
        y_n1 = y_n2;
        y_n2 = load_code(codes, cap, vo + jb + 64 + lane);
        ncols = min(32, nv - jb);
        cols = ncols == 32 ? kFull : (1u << ncols) - 1;
        if (kEarlyStop) {
          s_in = wadd(skip0, warp_incl_sum(y.freq, lane));
          s_ex = wsub(s_in, y.freq);
        }
        sm.vw[lane] = make_int2(y.pre, y.post);
        __syncwarp();
        m = row_masks<kPacked>(x.pre, x.post, sm.vw, cols);
        r0 = r_end;
        c0 = 0;
      } else {
        if (ib + lane < lu) row[ib + lane] = my_slot;
        written = ib + 32;
        if (ib + nrows >= nu) break;  // i reached nu
        ib += 32;
        x = x_n1;
        x_n1 = x_n2;
        x_n2 = load_code(codes, cap, uo + ib + 64 + lane);
        nrows = min(32, nu - ib);
        m = row_masks<kPacked>(x.pre, x.post, sm.vw, cols);
        my_slot = kSentinel;
        r0 = 0;
        c0 = c_end;
      }
      __syncwarp();
    }
    if (written <= ib) {  // the window the walk ended in
      if (ib + lane < lu) row[ib + lane] = my_slot;
      written = ib + 32;
    }
  }
  fill_sentinel(row, written < lu ? written : lu, lu, lane);
  if (lane == 0) {
    child_len[p] = groups;
    support[p] = alive ? z_mass : 0;  // aborted => certified < minsup
    cmps_out[p] = cmps;
    checks_out[p] = checks;
    alive_out[p] = alive ? 1 : 0;
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
zmerge_scatter_kernel(int32_t* codes, int64_t cap, const int32_t* __restrict__ out_slot,
                      int64_t lu, const int32_t* __restrict__ u_off,
                      const int32_t* __restrict__ u_len, const int32_t* __restrict__ v_off,
                      const int32_t* __restrict__ v_len, const int32_t* __restrict__ out_off,
                      int64_t n_pairs, int32_t* __restrict__ child_len) {
  const int lane = threadIdx.x & 31;
  const int64_t p = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (p >= n_pairs) return;  // warp-uniform
  const int32_t* srow = out_slot + p * lu;
  const int nu = u_len[p], nv = v_len[p];
  REPRO_CHECK(nu >= 0 && nv >= 0);
  const int64_t uo = u_off[p], vo = v_off[p], base = out_off[p];
  // Whether any destination base + g (g < child_len <= lu) is in [0, cap).
  const bool writes = base < cap && base + lu > 0;

  // Group g's (pre, post): the representative V code, sentinel past v_len.
  auto write_rep = [&](int64_t g, int rep) {
    const int64_t dest = base + g;
    if (dest < 0 || dest >= cap) return;
    const bool in_v = rep < nv;
    REPRO_CHECK(rep >= 0 && (!in_v || (vo >= 0 && vo + rep < cap)));
    const int32_t* y = code_at(codes, cap, vo + rep);
    int32_t* out = codes + 3 * dest;
    out[0] = in_v ? y[0] : kSentinel;
    out[1] = in_v ? y[1] : 0;
  };
  auto write_freq = [&](int64_t g, int freq) {
    const int64_t dest = base + g;
    if (dest >= 0 && dest < cap) codes[3 * dest + 2] = freq;
  };

  int running = -1;  // max of -1 and every valid slot before the chunk
  int groups = 0;    // group starts before the chunk
  int mass = 0;      // U mass of the valid slots before the chunk
  int start_mass = 0;  // mass before the last start so far (groups > 0)
  // Lane l's 4 entries of the chunk at k0; the sentinel past lu.
  auto load_chunk = [&](int64_t k0) {
    const int64_t i0 = k0 + 4 * lane;
    if (kVec && k0 + 128 <= lu) return *reinterpret_cast<const int4*>(srow + i0);
    int4 v;
    v.x = i0 < lu ? srow[i0] : kSentinel;
    v.y = i0 + 1 < lu ? srow[i0 + 1] : kSentinel;
    v.z = i0 + 2 < lu ? srow[i0 + 2] : kSentinel;
    v.w = i0 + 3 < lu ? srow[i0 + 3] : kSentinel;
    return v;
  };
  // Two chunks in flight ahead of the one being read.
  int4 ahead1 = load_chunk(0), ahead2 = load_chunk(128);
  for (int64_t k0 = 0; k0 < lu; k0 += 128) {
    const int64_t i0 = k0 + 4 * lane;
    const int4 v4 = ahead1;
    ahead1 = ahead2;
    ahead2 = load_chunk(k0 + 256);
    const int s[4] = {v4.x, v4.y, v4.z, v4.w};
    const bool any = s[0] != kSentinel || s[1] != kSentinel || s[2] != kSentinel ||
                     s[3] != kSentinel;
    if (!__any_sync(kFull, any)) continue;

    // Running maximum before this lane's entries: an exclusive warp
    // max-scan of the lanes' maxima, after the carried maximum.
    int lmax = -1;
#pragma unroll
    for (int t = 0; t < 4; ++t)
      if (s[t] != kSentinel) lmax = max(lmax, s[t]);
    int incl = lmax;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int o = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl = max(incl, o);
    }
    int before = __shfl_up_sync(kFull, incl, 1);
    before = max(running, lane == 0 ? -1 : before);
    bool start[4];
    int n_start = 0;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const bool valid = s[t] != kSentinel;
      start[t] = valid && s[t] != before;
      if (valid) before = max(before, s[t]);
      n_start += start[t];
    }
    const int starts_incl = warp_incl_sum(n_start, lane);
    const int chunk_starts = __shfl_sync(kFull, starts_incl, 31);

    if (writes) {
      int f[4], lmass = 0;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        REPRO_CHECK(!(s[t] != kSentinel && i0 + t < nu) || (uo >= 0 && uo + i0 + t < cap));
        f[t] = (s[t] != kSentinel && i0 + t < nu) ? code_at(codes, cap, uo + i0 + t)[2] : 0;
        lmass = wadd(lmass, f[t]);
      }
      const int mass_incl = warp_incl_sum(lmass, lane);
      int m = wadd(mass, wsub(mass_incl, lmass));  // mass before this lane
      int g = groups + starts_incl - n_start;      // groups before this lane
      // The mass before the last start of the lanes before this one: a
      // scan that keeps the right-most lane's value where it has one.
      int last = 0;
      {
        int mm = m;
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          if (start[t]) last = mm;
          mm = wadd(mm, f[t]);
        }
      }
      int val = last;
      int has = n_start > 0;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int ov = __shfl_up_sync(kFull, val, off);
        const int oh = __shfl_up_sync(kFull, has, off);
        if (lane >= off && !has) {
          val = ov;
          has = oh;
        }
      }
      int prev = __shfl_up_sync(kFull, val, 1);
      const int prev_has = __shfl_up_sync(kFull, has, 1);
      if (lane == 0 || !prev_has) prev = start_mass;
      // Each start closes the group before it (its mass is the prefix
      // difference) and opens its own.
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        if (start[t]) {
          if (g > 0) write_freq(g - 1, wsub(m, prev));
          write_rep(g, s[t]);
          prev = m;
          ++g;
        }
        m = wadd(m, f[t]);
      }
      if (__shfl_sync(kFull, has, 31)) start_mass = __shfl_sync(kFull, val, 31);
      mass = wadd(mass, __shfl_sync(kFull, mass_incl, 31));
    }
    groups += chunk_starts;
    running = max(running, __shfl_sync(kFull, incl, 31));
  }
  if (writes && groups > 0 && lane == 0) write_freq(groups - 1, wsub(mass, start_mass));
  if (lane == 0) child_len[p] = groups;
}

unsigned grid_for(long long n_pairs) {
  return static_cast<unsigned>((n_pairs + kWarps - 1) / kWarps);
}

#ifdef REPRO_CHECKED
bool g_packed_adv = false;
#endif

}  // namespace

#ifdef REPRO_CHECKED
extern "C" int repro_nlist_set_packed_adv(int on) {
  g_packed_adv = on != 0;
  return 0;
}
#endif

extern "C" int repro_nlist_merge(const void* codes, long long cap, const void* u_off,
                                 const void* u_len, const void* v_off, const void* v_len,
                                 const void* rho_v, long long n_pairs, long long lu,
                                 int minsup, int early_stop, void* out_slot,
                                 void* child_len, void* support, void* cmps,
                                 void* checks, void* alive, void* stream) {
  auto kernel = early_stop ? nl_merge_kernel<true, false> : nl_merge_kernel<false, false>;
#ifdef REPRO_CHECKED
  if (g_packed_adv)
    kernel = early_stop ? nl_merge_kernel<true, true> : nl_merge_kernel<false, true>;
#endif
  kernel<<<grid_for(n_pairs), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(codes), cap, static_cast<const int32_t*>(u_off),
      static_cast<const int32_t*>(u_len), static_cast<const int32_t*>(v_off),
      static_cast<const int32_t*>(v_len), static_cast<const int32_t*>(rho_v), n_pairs, lu,
      minsup, static_cast<int32_t*>(out_slot), static_cast<int32_t*>(child_len),
      static_cast<int32_t*>(support), static_cast<int32_t*>(cmps),
      static_cast<int32_t*>(checks), static_cast<uint8_t*>(alive));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_zmerge_scatter(void* codes, long long cap, const void* out_slot,
                                    long long lu, const void* u_off, const void* u_len,
                                    const void* v_off, const void* v_len,
                                    const void* out_off, long long n_pairs,
                                    void* child_len, void* stream) {
  // Rows take 16-byte loads when every row starts 16-byte aligned.
  const bool vec = lu % 4 == 0 && reinterpret_cast<uintptr_t>(out_slot) % 16 == 0;
  auto kernel = vec ? zmerge_scatter_kernel<true> : zmerge_scatter_kernel<false>;
  kernel<<<grid_for(n_pairs), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int32_t*>(codes), cap, static_cast<const int32_t*>(out_slot), lu,
      static_cast<const int32_t*>(u_off), static_cast<const int32_t*>(u_len),
      static_cast<const int32_t*>(v_off), static_cast<const int32_t*>(v_len),
      static_cast<const int32_t*>(out_off), n_pairs, static_cast<int32_t*>(child_len));
  return static_cast<int>(cudaGetLastError());
}
