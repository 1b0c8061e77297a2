// K9: the EditManager rebase window on integer columns, for Hopper (sm_90a).
//
// Replaces fluidframework_tpu/ops/tree_kernel.py rebase_window_kernel (:1146)
// with its flat bridge leg _flat_leg (:876) and pair step _pair_step (:1043);
// the plain PyTorch form of the same function is rebase_window_kernel in
// fluidframework_tpu_torch/ops/tree_kernel.py, and the packed-row wrapper
// that launches this kernel is fluidframework_tpu_torch/ops/rebase_kernel.py.
//
// One incoming commit c folds through a window of C in-flight entries: each
// step is the mirrored bridge pair rebase_pair(c, x) on padded mark columns
// (M = 12 leaf marks, PD = 4 interior levels).  Every encoding is one packed
// int32 row of 76 words:
//   dep 1 | fld 5 | pos 4 | val 5 | kind 12 | cnt 12 | det 12 | slo 12 | shi 12 | n 1
// and every step writes one row of 160 words:
//   valid | id_c | id_x | x (76) | stage (76) | x_drop (5)
// for every step, including the steps after the first invalid one, exactly
// as the plain form computes them.
//
// What bounds it: neither bytes nor operations but a per-step dependency
// chain.  A window moves 304 bytes in and 640 out a step and does a few
// thousand integer operations; step i + 1 cannot start before step i's c'
// and prefix-validity bit exist, and inside a step every pass (fate runs,
// placements, coalescing, emission, rebuild) reads the one before.  So a
// window's time is C times one step's latency; with many windows in flight
// the instructions a step executes matter too.  The design shortens the chain
// and keeps every pass to a few instructions a thread:
//   - one block of 384 threads per window, both legs at once: the two
//     flat_leg calls of a step read the same four [M] columns and write
//     disjoint outputs, so threads [0, 192) run leg 0 (c over x) and
//     [192, 384) leg 1 (x over c).  A leg syncs only its own six warps
//     (named barriers 1 and 2, three times a step); the block syncs twice,
//     where both legs hand their outputs to the pair step's tail and where
//     c' and the next x are handed to the next step;
//   - a prologue warp per leg computes the step's spine (a ballot over the
//     PD levels) and the leg's fate runs: lanes 0-15 the a marks, 16-31 the
//     b marks, two 16-lane shuffle scans of 4 rounds, into shared memory;
//   - one thread per atom: a leg's atom table is T = M (M + 2) = 168 atoms,
//     a-mark j's 14 atoms (insert | M b-runs | tail) on half-warp j (lanes
//     14 and 15 idle).  The insert boundary needs no loop over the b-runs:
//     at most one b-run covers a mark's offset (a ballot and a shuffle),
//     and the inserts at it are a 16-lane shuffle sum;
//   - the coalescing passes are ballots: the previous live atom, the group
//     and skip counts and out_n are bit scans and population counts of
//     per-warp ballots, shared through 6 words a leg and combined by a
//     3-round shuffle scan;
//   - each start atom (and each gap-skip atom) writes its output slot, and
//     every live atom adds its count to its group's slot and raises the
//     slot's source bound (shared atomics): no cumsum, no search for the
//     group's end, no search over the monotone slot column.  This gives
//     exactly the reference's emission, its clamp to T - 1 included (see
//     the emit note below);
//   - the window's entry rows are staged in shared memory ahead of the
//     steps, CHUNK rows at a time in two buffers with cp.async, so a step
//     never waits on device memory, for any C;
//   - the working set is 13,568 bytes of static shared memory a block
//     (staging 9,728, c double-buffered 608, the two legs' tables 1,616
//     each; kinds, source indices and flags uint8, counts and positions
//     int32) and 40 registers a thread, so a multiprocessor holds 4 windows
//     (1,536 threads; 528 windows a wave on 132 multiprocessors);
//   - integer arithmetic throughout.  The reference's clamped gathers stay
//     clamped (side.slo/shi/det[leg.lo/hi], kk[prev]).
#ifndef RW_EMULATE
#include <cuda_runtime.h>
#endif

namespace {

constexpr int M = 12;          // REBASE_MAX_MARKS
constexpr int PD = 4;          // REBASE_MAX_DEPTH
constexpr int NS = M + 2;      // atom slots per a-mark: insert | M b-runs | tail
constexpr int HALF = 16;       // threads per a-mark (one half-warp)
constexpr int LEG = M * HALF;  // threads per leg
constexpr int LEG_WARPS = LEG / 32;
constexpr int THREADS = 2 * LEG;
constexpr int ENC = 76;        // words per packed encoding
constexpr int STEP = 3 + 2 * ENC + PD + 1;  // words per step row
constexpr int CHUNK = 16;      // entry rows per staging buffer
constexpr int MIN_BLOCKS = 4;  // resident windows a multiprocessor must fit (caps registers at 40)
constexpr int PIECES = ENC / 4;  // 16-byte pieces per row
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned LOW = 0x0000ffffu;

static_assert(NS <= HALF && LEG % 32 == 0, "an a-mark's atoms fit a half-warp");
static_assert(LEG_WARPS <= 8, "a 3-round scan covers the leg's warps");
static_assert(STEP == 160 && ENC % 4 == 0, "row layout");
static_assert(STEP <= THREADS, "one thread per step-row word");

// Packed encoding offsets.
constexpr int O_DEP = 0, O_FLD = 1, O_POS = 6, O_VAL = 10, O_KIND = 15,
              O_CNT = 27, O_DET = 39, O_SLO = 51, O_SHI = 63, O_N = 75;
// Step row offsets.
constexpr int S_VALID = 0, S_IDC = 1, S_IDX = 2, S_X = 3, S_STAGE = 3 + ENC,
              S_DROP = 3 + 2 * ENC;
// Device mark codes (protocol/mark_schema.py TreeMarkKind).
constexpr int NOOP = 0, SKIP = 1, INSERT = 2, REMOVE = 3, MODIFY = 4;

// One leg's tables.
struct LegTab {
  // the prologue's: fate runs of the b marks, offsets of the a marks
  int ain[M], acons[M], acnt[M];
  int inS[M], inE[M], outS[M], bcons[M], bcnt[M];
  int tail_in, tail_out;
  int spine, pc, px;             // the step's spine (see SP_*)
  int a_n, adet;                 // live a marks; any a mark with a detached payload
  // the atoms'
  int endf[LEG];                 // atom's end position (read as the previous atom's)
  unsigned okb[LEG_WARPS], stb[LEG_WARPS], wsb[LEG_WARPS];  // per-warp ballots
  int badw[LEG_WARPS];
  int meta;                      // out_n << 1 | bad
  // the leg's output columns
  int cnt[M], hi[M];
  unsigned char akind[M], bkind[M], kk[LEG], kind[M], lo[M];
};

struct __align__(16) Block {
  int rows[2][CHUNK][ENC];       // staged window entries
  int c[2][ENC];                 // the carried c, double-buffered
  LegTab leg[2];                 // 0: c over x (a_after), 1: x over c
};

// ----------------------------------------------------------- row staging

#ifdef RW_EMULATE
// The host build copies in place of the asynchronous copy.
__device__ __forceinline__ void copy16(int* dst, const int* src) {
  for (int k = 0; k < 4; ++k) dst[k] = src[k];
}
__device__ __forceinline__ void copy_commit() {}
__device__ __forceinline__ void copy_wait_all_but_one() {}
#else
__device__ __forceinline__ void copy16(int* dst, const int* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void copy_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void copy_wait_all_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
// Named barrier ID over one leg's threads (bar.sync ID, LEG).
template <int ID>
__device__ __forceinline__ void leg_sync() {
  asm volatile("bar.sync %0, %1;\n" ::"n"(ID), "n"(LEG) : "memory");
}
#endif

__device__ __forceinline__ void sync_leg(int leg) {
  if (leg) leg_sync<2>(); else leg_sync<1>();
}

// Start the copy of `nrows` entry rows (16-byte aligned: a row is 304
// bytes) from device memory into `dst`, then commit one copy group (every
// thread commits one, empty or not).
__device__ __forceinline__ void stage_rows(int (*dst)[ENC], const int* src, int nrows) {
  int* d = &dst[0][0];
  for (int p = threadIdx.x; p < nrows * PIECES; p += THREADS) copy16(d + 4 * p, src + 4 * p);
  copy_commit();
}

// ------------------------------------------------------------ small helpers

__device__ __forceinline__ unsigned mask_lt(int lane) { return (1u << lane) - 1u; }
__device__ __forceinline__ unsigned mask_le(int lane) { return (2u << lane) - 1u; }
__device__ __forceinline__ int last_bit(unsigned v) { return 31 - __clz((int)v); }
__device__ __forceinline__ int first_bit(unsigned v) { return __ffs((int)v) - 1; }

// input consumed (SKIP/REMOVE: the count) or produced (SKIP/INSERT), 1 at a MODIFY
__device__ __forceinline__ int extent(int k, int c, int other) {
  return (k == SKIP || k == other) ? c : (k == MODIFY ? 1 : 0);
}

// [Skip(p), Modify] (or [Modify] at p == 0), column i
__device__ __forceinline__ int synth_kind(int p, int i) {
  return i == 0 ? (p > 0 ? SKIP : MODIFY) : (i == 1 ? (p > 0 ? MODIFY : NOOP) : NOOP);
}
__device__ __forceinline__ int synth_cnt(int p, int i) {
  return i == 0 ? (p > 0 ? p : 1) : (i == 1 ? (p > 0 ? 1 : 0) : 0);
}

__device__ __forceinline__ int clamp_m(int i) { return min(max(i, 0), M - 1); }

// The step's spine word: lstar (3 bits) | these flags | drops << 8.
constexpr int SP_CINT = 1 << 3, SP_XINT = 1 << 4, SP_ENGAGE = 1 << 5;

// --------------------------------------------------------- leg prologue
//
// Run by the leg's first warp: the spine from the shared c and x, then the
// leg's two mark columns (synthesized [Skip(p), Modify] on an interior
// side), lane r of lanes 0-15 holding a-mark r and of lanes 16-31 b-mark r,
// with their prefix sums, into the leg's table.  Zeroes the leg's output
// columns for the emission's atomics.
__device__ __forceinline__ void prologue(LegTab& g, int leg, const int* c, const int* x,
                                         int lane) {
  // spine: lanes l <= PD hold level l of both sides
  const int cdep = c[O_DEP], xdep = x[O_DEP];
  const int l = min(lane, PD), lp = min(lane, PD - 1);
  const int cf = c[O_FLD + l], xf = x[O_FLD + l];
  const int cp = c[O_POS + lp], xp = x[O_POS + lp];
  const int cv = c[O_VAL + l], xv = x[O_VAL + l];
  const bool match = lane < PD && lane < cdep && lane < xdep && cf == xf && cp == xp;
  const int lstar = first_bit(~__ballot_sync(FULL, match));  // leading matched levels
  const int f_c = __shfl_sync(FULL, cf, lstar), f_x = __shfl_sync(FULL, xf, lstar);
  const int lpos = min(lstar, PD - 1);
  const int pc = __shfl_sync(FULL, cp, lpos), px = __shfl_sync(FULL, xp, lpos);
  const unsigned drops = __ballot_sync(FULL, lane <= PD && cv > 0 && xv > 0 && lane <= lstar);
  const bool c_int = lstar < cdep, x_int = lstar < xdep;
  const bool case_d = f_c < 0 || f_x < 0;
  const bool case_a = !case_d && f_c != f_x;
  const bool engage = !case_d && !case_a && !(c_int && x_int);

  // mark columns: leg 0 rebases c (a) over x (b), leg 1 x over c
  const int r = lane & (HALF - 1);
  const bool is_b = lane >= HALF;
  const bool on_x = is_b != (leg != 0);
  const int* side = on_x ? x : c;
  const int rr = min(r, M - 1);
  int k = side[O_KIND + rr], n = side[O_CNT + rr];
  const int det = side[O_DET + rr];
  if (on_x ? x_int : c_int) {
    const int p = on_x ? px : pc;
    k = synth_kind(p, r);
    n = synth_cnt(p, r);
  }
  if (r >= M) k = n = 0;
  const int cons = extent(k, n, REMOVE), prod = extent(k, n, INSERT);
  int s1 = cons, s2 = prod;
#pragma unroll
  for (int d = 1; d < HALF; d <<= 1) {
    const int u1 = __shfl_up_sync(FULL, s1, d, HALF);
    const int u2 = __shfl_up_sync(FULL, s2, d, HALF);
    if (r >= d) {
      s1 += u1;
      s2 += u2;
    }
  }
  const unsigned live = __ballot_sync(FULL, k != NOOP);
  const unsigned dets = __ballot_sync(FULL, r < M && det > 0);
  if (r < M) {
    if (is_b) {
      g.inS[r] = s1 - cons;
      g.inE[r] = s1;
      g.outS[r] = s2 - prod;
      g.bcons[r] = cons;
      g.bcnt[r] = n;
      g.bkind[r] = (unsigned char)k;
    } else {
      g.ain[r] = s1 - cons;
      g.acons[r] = cons;
      g.acnt[r] = n;
      g.akind[r] = (unsigned char)k;
      g.cnt[r] = 0;
      g.hi[r] = 0;
      g.kind[r] = 0;
      g.lo[r] = 0;
    }
  }
  if (lane == 31) {  // the b side's totals
    g.tail_in = s1;
    g.tail_out = s2;
  }
  if (lane == 0) {
    g.spine = lstar | (c_int ? SP_CINT : 0) | (x_int ? SP_XINT : 0) |
              (engage ? SP_ENGAGE : 0) | (int)(drops << 8);
    g.pc = pc;
    g.px = px;
    g.a_n = __popc(live & LOW);
    g.adet = (dets & LOW) != 0;
  }
}

// --------------------------------------------------------------- one leg
//
// Rebase the a marks over the b marks from the prologue's columns into the
// leg's output columns and meta word.  The calling thread is leg thread
// `lt`: a-mark j = lt / 16, atom slot r = lt % 16 (0 insert, 1..M the
// b-run r - 1, M + 1 the tail, above that idle).  Ends with the outputs
// written, not yet synced.
__device__ __forceinline__ void flat_leg(LegTab& g, int leg, int lt) {
  const int lane = lt & 31, wl = lt >> 5, j = lt >> 4, r = lt & (HALF - 1);
  const unsigned half = (lane & HALF) ? ~LOW : LOW;
  const bool a_after = leg == 0;

  // --- phase 2: this thread's atom -----------------------------------------
  const int aki = g.akind[j], aci = g.acnt[j], a_in = g.ain[j], e_a = a_in + g.acons[j];
  const int tail_in = g.tail_in, tail_out = g.tail_out;
  const bool brun = r >= 1 && r <= M;
  const int i = clamp_m(r - 1);
  const int kb = brun ? g.bkind[i] : NOOP, cb = g.bcnt[i], consb = brun ? g.bcons[i] : 0;
  const int inS = g.inS[i], inE = g.inE[i], outS = g.outS[i];
  const bool runB = kb != NOOP && consb > 0;
  const bool gone = kb == REMOVE;
  // the insert boundary: the b-runs are disjoint intervals (inS, inE], so at
  // most one covers a_in; the inserts sitting at a_in are summed
  const bool cov = runB && inS < a_in && a_in <= inE;
  const unsigned covb = __ballot_sync(FULL, cov) & half;
  const int bcov = __shfl_sync(FULL, gone ? outS : outS + (a_in - inS),
                               covb ? first_bit(covb) : lane);
  const bool ins_at = kb == INSERT && inS == a_in;
  int prd = ins_at ? cb : 0;
  if (__ballot_sync(FULL, ins_at)) {
#pragma unroll
    for (int m = HALF / 2; m; m >>= 1) prd += __shfl_xor_sync(FULL, prd, m, HALF);
  }
  const bool isnode = aki == REMOVE || aki == MODIFY;
  bool ok = false, coll = false;
  int pos = 0, cnt = 0;
  if (r == 0) {  // insert
    const int before = a_in == 0 ? 0 : (covb ? bcov : tail_out + (a_in - tail_in));
    ok = aki == INSERT;
    pos = before + (a_after ? prd : 0);
    cnt = aci;
  } else if (brun) {  // a-mark j against b-run r - 1
    const int lo = max(a_in, inS), hi = min(e_a, inE);
    const bool overlap = runB && hi > lo;
    ok = overlap && isnode && !gone;
    pos = outS + (lo - inS);
    cnt = hi - lo;
    coll = aki == MODIFY && kb == MODIFY && overlap;
  } else if (r == M + 1) {  // tail
    const int tlo = max(a_in, tail_in);
    ok = isnode && e_a > tlo;
    pos = tail_out + (tlo - tail_in);
    cnt = e_a - tlo;
  }
  const bool ok0 = ok && cnt > 0;
  const unsigned okball = __ballot_sync(FULL, ok0);
  g.endf[lt] = pos + (aki == REMOVE ? cnt : (aki == MODIFY ? 1 : 0));
  g.kk[lt] = (unsigned char)aki;
  if (lane == 0) g.okb[wl] = okball;
  sync_leg(leg);

  // --- phase 3a: previous live atom, merges, group starts -------------------
  // lane v < LEG_WARPS holds warp v's word
  const unsigned okv = lane < LEG_WARPS ? g.okb[lane] : 0u;
  const unsigned live_w = __ballot_sync(FULL, okv != 0) & mask_lt(wl);
  const unsigned okp = __shfl_sync(FULL, okv, live_w ? last_bit(live_w) : 0);
  const unsigned mine = okball & mask_lt(lane);
  const int prev = mine ? wl * 32 + last_bit(mine)
                        : (live_w ? last_bit(live_w) * 32 + last_bit(okp) : -1);
  const bool has_prev = prev >= 0;
  const int pend = g.endf[has_prev ? prev : 0];
  const int pk = has_prev ? (int)g.kk[prev] : NOOP;
  const int gap = pos - (has_prev ? pend : 0);
  const bool merge = ok0 && pk == aki && gap == 0 && (aki == REMOVE || aki == INSERT);
  const bool start = ok0 && !merge;
  const bool ws = start && gap > 0;
  const unsigned stball = __ballot_sync(FULL, start);
  const unsigned wsball = __ballot_sync(FULL, ws);
  const bool wbad = __any_sync(FULL, coll || (ok0 && gap < 0));
  if (lane == 0) {
    g.stb[wl] = stball;
    g.wsb[wl] = wsball;
    g.badw[wl] = wbad;
  }
  sync_leg(leg);

  // --- phase 3b: slots and emission -----------------------------------------
  // per warp: group starts in the low 16 bits, gap skips in the high (<= 168 each)
  const int cv = lane < LEG_WARPS ? __popc(g.stb[lane]) | __popc(g.wsb[lane]) << 16 : 0;
  const bool badv = lane < LEG_WARPS && g.badw[lane];
  int incl = cv;
#pragma unroll
  for (int d = 1; d < LEG_WARPS; d <<= 1) {
    const int u = __shfl_up_sync(FULL, incl, d);
    if (lane >= d) incl += u;
  }
  const int before_me = __shfl_sync(FULL, incl - cv, wl);
  const int total = __shfl_sync(FULL, incl, LEG_WARPS - 1);
  const int grp = (before_me & LOW) + __popc(stball & mask_le(lane));
  const int nsk = (before_me >> 16) + __popc(wsball & mask_le(lane));
  const int out_n = (total & LOW) + (total >> 16);
  const bool bad = __any_sync(FULL, badv) || out_n > M;
  // Emit.  slot = groups - 1 + skips so far is monotone in the atom order
  // and rises only at a start atom, by 1 (a mark) or 2 (a gap skip, then a
  // mark), and a group's atoms share their start's slot.  So for s < out_n
  // the reference's first atom with slot >= s is the start atom writing s
  // here; its group's count is the sum of the group's live counts (csum at
  // the group's end minus csum before its start) and its source bound the
  // last live atom's a-mark, the largest in the group; for s >= out_n its
  // search runs off the end, clamps to T - 1 and matches nothing: the
  // zeroed slot.
  const int slot = grp - 1 + nsk;
  if (ok0 && slot < M) {
    atomicAdd(&g.cnt[slot], cnt);
    atomicMax(&g.hi[slot], j);
    if (start) {
      g.kind[slot] = (unsigned char)aki;
      g.lo[slot] = (unsigned char)j;
    }
  }
  if (ws && slot - 1 < M) {  // no group owns the skip's slot
    g.kind[slot - 1] = SKIP;
    g.cnt[slot - 1] = gap;
  }
  if (lt == 0) g.meta = out_n << 1 | (bad ? 1 : 0);
}

// The leg's output for the rebuild.
struct LegOut {
  const LegTab* g;
  int n;
};

// Word w of one side rebuilt from its leg's output (the reference's rebuild).
__device__ int rebuilt(const int* side, LegOut L, bool is_int, bool surv, int npos, int lstar,
                       unsigned drops, int w) {
  const bool trunc = is_int && !surv;
  const int t_dep = trunc ? lstar : side[O_DEP];
  if (w == O_DEP) return t_dep;
  if (w < O_POS) return side[w];
  if (w < O_VAL) return (is_int && surv && w - O_POS == lstar) ? npos : side[w];
  if (w < O_KIND) {
    const int l = w - O_VAL;
    return (l <= t_dep && !((drops >> l) & 1u)) ? side[w] : 0;
  }
  if (w == O_N) return !is_int ? L.n : (trunc ? 0 : side[O_N]);
  if (trunc) return 0;
  if (is_int) return side[w];
  const int f = (w - O_KIND) / M, i = (w - O_KIND) % M;
  if (i >= L.n) return 0;
  const int kind = L.g->kind[i];
  switch (f) {
    case 0: return kind;
    case 1: return L.g->cnt[i];
    case 2: return kind == REMOVE ? side[O_DET + clamp_m(L.g->lo[i])] : 0;
    case 3: return side[O_SLO + clamp_m(L.g->lo[i])];
    default: return side[O_SHI + clamp_m(L.g->hi[i])];
  }
}

// The pair step's tail, on threads [0, STEP): both legs' verdicts, the step
// row's word `tid`, and c' (word tid - S_STAGE) into `cn`.  Returns the
// step's validity.
__device__ __forceinline__ bool pair_tail(const LegTab& g0, const LegTab& g1, const int* c,
                                          const int* x, int* cn, bool el, bool dead, int tid,
                                          int* row) {
  const int lane = tid & 31;
  const int sp = g0.spine;
  const int lstar = sp & 7;
  const bool c_int = sp & SP_CINT, x_int = sp & SP_XINT, engage = sp & SP_ENGAGE;
  const unsigned drops = (unsigned)sp >> 8;
  const int n0 = g0.meta >> 1, n1 = g1.meta >> 1;
  // lane s < M checks leg 0's output slot s, lane 16 + s leg 1's
  const LegTab& gl = lane < HALF ? g0 : g1;
  const int s = clamp_m(lane & (HALF - 1));
  const bool in_slot = (lane & (HALF - 1)) < M;
  const int kd = gl.kind[s];
  const unsigned diff =
      __ballot_sync(FULL, in_slot && (kd != gl.akind[s] || gl.cnt[s] != gl.acnt[s]));
  const unsigned surv =
      __ballot_sync(FULL, in_slot && kd == MODIFY && s < (lane < HALF ? n0 : n1));
  const bool ident_c = n0 == g0.a_n && !(diff & LOW);
  const bool ident_x = n1 == g1.a_n && !(diff & ~LOW);
  const bool surv_c = surv & LOW, surv_x = surv & ~LOW;
  const bool det_c = !c_int && g0.adet && !ident_c;
  const bool det_x = !x_int && g1.adet && !ident_x;
  const bool step_bad = engage && ((g0.meta & 1) || (g1.meta & 1) || det_c || det_x);
  const bool ok = el && !dead && !step_bad;
  const int npos_c = g0.kind[0] == SKIP ? g0.cnt[0] : 0;
  const int npos_x = g1.kind[0] == SKIP ? g1.cnt[0] : 0;
  const bool changed_c = engage && (c_int ? !(surv_c && npos_c == g0.pc) : !ident_c);
  const bool changed_x = engage && (x_int ? !(surv_x && npos_x == g0.px) : !ident_x);
  const bool apply_c = ok && changed_c, apply_x = ok && changed_x;
  int v;
  if (tid == S_VALID) {
    v = ok;
  } else if (tid == S_IDC) {
    v = ok && !changed_c;
  } else if (tid == S_IDX) {
    v = ok && !changed_x && drops == 0;
  } else if (tid < S_STAGE) {
    const int k = tid - S_X, l = k - O_VAL;
    v = apply_x ? rebuilt(x, LegOut{&g1, n1}, x_int, surv_x, npos_x, lstar, drops, k)
                : ((l >= 0 && l <= PD && ((drops >> l) & 1u)) ? 0 : x[k]);
  } else if (tid < S_DROP) {
    const int k = tid - S_STAGE;
    v = apply_c ? rebuilt(c, LegOut{&g0, n0}, c_int, surv_c, npos_c, lstar, 0u, k) : c[k];
    cn[k] = v;
  } else {
    v = (drops >> (tid - S_DROP)) & 1u;
  }
  row[tid] = v;
  return ok;
}

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    rebase_window_kernel(const int* __restrict__ c_in, const int* __restrict__ xs,
                         const unsigned char* __restrict__ elig, int* __restrict__ final_c,
                         int* __restrict__ steps, int W, int C) {
  __shared__ Block sm;
  const int tid = threadIdx.x;
  const int leg = tid >= LEG;
  const int lt = tid - leg * LEG;
  const long long w = blockIdx.x;
  if (w >= W) return;  // the whole block leaves together
  const int* xw = xs + w * C * ENC;
  for (int k = tid; k < ENC; k += THREADS) sm.c[0][k] = c_in[w * ENC + k];
  stage_rows(sm.rows[0], xw, min(C, CHUNK));
  stage_rows(sm.rows[1], xw + CHUNK * ENC, min(max(C - CHUNK, 0), CHUNK));
  bool dead = false;
  int cur = 0;
  for (int i = 0; i < C; ++i) {
    const int q = i / CHUNK, rr = i - q * CHUNK;
    if (rr == 0) {
      copy_wait_all_but_one();
      __syncthreads();
    }
    const bool el = elig[w * C + i] != 0;
    const int* c = sm.c[cur];
    const int* x = sm.rows[q & 1][rr];
    LegTab& g = sm.leg[leg];
    // both legs at once: leg 0 rebases c over x, leg 1 x over c
    if (lt < 32) prologue(g, leg, c, x, lt);
    sync_leg(leg);
    flat_leg(g, leg, lt);
    __syncthreads();
    if (tid < STEP)
      dead = !pair_tail(sm.leg[0], sm.leg[1], c, x, sm.c[cur ^ 1], el, dead, tid,
                        steps + (w * C + i) * STEP) || dead;
    __syncthreads();  // c' and the next x handed over; the legs' tables free
    if (rr == CHUNK - 1)
      stage_rows(sm.rows[q & 1], xw + (q + 2) * CHUNK * ENC, min(max(C - (q + 2) * CHUNK, 0), CHUNK));
    cur ^= 1;
  }
  for (int k = tid; k < ENC; k += THREADS) final_c[w * ENC + k] = sm.c[cur][k];
}

}  // namespace

#ifndef RW_EMULATE
// c[W, 76], xs[W, C, 76] and elig[W, C] (uint8) in; final_c[W, 76] and
// steps[W, C, 160] out, all contiguous on the device, xs 16-byte aligned
// (cudaErrorMisalignedAddress otherwise).  Launches one block of 384 threads
// per window on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int rebase_window_launch(const void* c, const void* xs, const void* elig,
                                    void* final_c, void* steps, int W, int C, void* stream) {
  if (W <= 0) return 0;
  if ((unsigned long long)xs & 15ull) return (int)cudaErrorMisalignedAddress;
  rebase_window_kernel<<<W, THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)c, (const int*)xs, (const unsigned char*)elig, (int*)final_c, (int*)steps, W,
      C);
  return (int)cudaGetLastError();
}
#endif
