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
// What bounds it: neither bytes nor operations.  A window is a serial chain
// of C steps, each two legs of dependent scans (a few hundred integer
// operations over 168 atoms), so one window's time is latency; W windows run
// side by side, one warp each.  The design keeps that chain on chip:
//   - one warp per window (a block holds up to WPB windows; W = 1 is one
//     warp); the carried c, the current x and every leg table stay in the
//     warp's slice of shared memory across the C steps;
//   - each leg's per-mark prefix sums over M are warp scans (__shfl_up_sync);
//   - the [M, M] overlap tables are 144 entries per leg: lane j < M walks
//     a-mark j against the M b-runs;
//   - the atom table has T = M (M + 2) = 168 entries: lane l < 28 owns the
//     6 consecutive atoms [6 l, 6 l + 6), scans them serially, and a warp
//     scan carries the chunk totals across lanes (forward cumsum / cummax,
//     and with __shfl_down_sync the reverse cummin);
//   - the 12 output slots are binary searches over the monotone slot column;
//   - integer arithmetic throughout.
#ifndef RW_EMULATE
#include <cuda_runtime.h>
#endif

namespace {

constexpr int M = 12;          // REBASE_MAX_MARKS
constexpr int PD = 4;          // REBASE_MAX_DEPTH
constexpr int NS = M + 2;      // atom slots per a-mark: insert | M b-runs | tail
constexpr int T = M * NS;      // atoms per leg
constexpr int CH = 6;          // atoms per lane
constexpr int NL = T / CH;     // lanes that own atoms
constexpr int ENC = 76;        // words per packed encoding
constexpr int STEP = 3 + 2 * ENC + PD + 1;  // words per step row
constexpr int WPB = 4;         // windows (warps) per block at most
constexpr unsigned FULL = 0xffffffffu;

static_assert(NL * CH == T && NL <= 32, "atom chunks must cover the table");
static_assert(STEP == 160, "step row layout");

// Packed encoding offsets.
constexpr int O_DEP = 0, O_FLD = 1, O_POS = 6, O_VAL = 10, O_KIND = 15,
              O_CNT = 27, O_DET = 39, O_SLO = 51, O_SHI = 63, O_N = 75;
// Step row offsets.
constexpr int S_VALID = 0, S_IDC = 1, S_IDX = 2, S_X = 3, S_STAGE = 3 + ENC,
              S_DROP = 3 + 2 * ENC;
// Device mark codes (protocol/mark_schema.py TreeMarkKind).
constexpr int NOOP = 0, SKIP = 1, INSERT = 2, REMOVE = 3, MODIFY = 4;

struct Leg {
  int kind[M], cnt[M], lo[M], hi[M];
  int n, bad, ident;
};

// One window's working set (about 9 KB).
struct Warp {
  int c[ENC], x[ENC], nc[ENC];
  int ak[M], ac[M], bk[M], bc[M];  // leg inputs: the c side, the x side
  Leg leg[2];                      // 0: c over x (a_after), 1: x over c
  int inS[M], inE[M], outS[M], consB[M];
  int kk[T], pos[T], endf[T], gap[T], mc[T], csum[T], cmj[T], slot[T], gend[T];
  unsigned char ok0[T], start[T], wskip[T];
};

__device__ __forceinline__ int lane_id() { return threadIdx.x & 31; }

__device__ __forceinline__ int warp_incl_sum(int v) {
  const int lane = lane_id();
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_up_sync(FULL, v, d);
    if (lane >= d) v += u;
  }
  return v;
}

__device__ __forceinline__ int warp_incl_max(int v) {
  const int lane = lane_id();
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_up_sync(FULL, v, d);
    if (lane >= d) v = max(v, u);
  }
  return v;
}

// min over this lane and every later lane
__device__ __forceinline__ int warp_suffix_min(int v) {
  const int lane = lane_id();
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_down_sync(FULL, v, d);
    if (lane + d < 32) v = min(v, u);
  }
  return v;
}

// input consumed (SKIP/REMOVE: the count) or produced (SKIP/INSERT), 1 at a MODIFY
__device__ __forceinline__ int extent(int k, int c, int other) {
  return (k == SKIP || k == other) ? c : (k == MODIFY ? 1 : 0);
}

__device__ __forceinline__ void put_atom(Warp& s, int t, bool ok, int pos, int cnt, int kind) {
  const bool live = ok && cnt > 0;
  s.ok0[t] = live;
  s.kk[t] = kind;
  s.pos[t] = pos;
  s.mc[t] = live ? cnt : 0;
  s.endf[t] = pos + (kind == REMOVE ? cnt : (kind == MODIFY ? 1 : 0));
}

// One bridge leg: rebase the a marks over the b marks (both [M] in shared
// memory, written before the call with a __syncwarp).
__device__ void flat_leg(Warp& s, const int* ak, const int* ac, const int* bk,
                         const int* bc, bool a_after, Leg& out) {
  const int lane = lane_id();

  // --- phase 1: fate runs of b (lane i < M holds b-mark i), a's offsets ---
  const int bki = lane < M ? bk[lane] : NOOP;
  const int bci = lane < M ? bc[lane] : 0;
  const int consb = extent(bki, bci, REMOVE);
  const int prodb = extent(bki, bci, INSERT);
  const int inc_in = warp_incl_sum(consb);
  const int inc_out = warp_incl_sum(prodb);
  const int tail_in = __shfl_sync(FULL, inc_in, 31);
  const int tail_out = __shfl_sync(FULL, inc_out, 31);
  if (lane < M) {
    s.inS[lane] = inc_in - consb;
    s.inE[lane] = inc_in;
    s.outS[lane] = inc_out - prodb;
    s.consB[lane] = consb;
  }
  const int aki = lane < M ? ak[lane] : NOOP;
  const int aci = lane < M ? ac[lane] : 0;
  const int consa = extent(aki, aci, REMOVE);
  const int a_in = warp_incl_sum(consa) - consa;
  __syncwarp();

  // --- phase 2: lane j < M places a-mark j against every b-run ------------
  bool coll_j = false;
  if (lane < M) {
    const bool a_live = aki != NOOP;
    const bool isnode = a_live && (aki == REMOVE || aki == MODIFY);
    const bool modA = a_live && aki == MODIFY;
    const int e_a = a_in + consa;
    const int base = lane * NS;
    bool has_cov = false;
    int before = 0, prods = 0;
    for (int i = 0; i < M; ++i) {
      const int k = bk[i];
      const bool blive = k != NOOP;
      const int iS = s.inS[i], iE = s.inE[i], oS = s.outS[i];
      const bool runB = blive && s.consB[i] > 0;
      const bool gone = blive && k == REMOVE;
      if (runB && iS < a_in && a_in <= iE) {
        has_cov = true;
        before += gone ? oS : oS + (a_in - iS);
      }
      if (k == INSERT && iS == a_in) prods += bc[i];
      const int lo = max(a_in, iS), hi = min(e_a, iE);
      const bool overlap = runB && hi > lo;
      put_atom(s, base + 1 + i, overlap && isnode && !gone, oS + (lo - iS), hi - lo, aki);
      coll_j = coll_j || (modA && k == MODIFY && overlap);
    }
    before = a_in == 0 ? 0 : (has_cov ? before : tail_out + (a_in - tail_in));
    put_atom(s, base, a_live && aki == INSERT, before + (a_after ? prods : 0), aci, aki);
    const int tlo = max(a_in, tail_in);
    put_atom(s, base + NS - 1, isnode && e_a > tlo, tail_out + (tlo - tail_in), e_a - tlo, aki);
  }
  const bool coll = __any_sync(FULL, coll_j);
  const int a_n = __popc(__ballot_sync(FULL, lane < M && aki != NOOP));
  __syncwarp();

  // --- phase 3: coalescing emission over the atom table -------------------
  const bool owns = lane < NL;
  const int t0 = lane * CH;
  // pass A: the last live atom before each chunk (exclusive cummax)
  int last = -1;
  if (owns)
    for (int k = 0; k < CH; ++k)
      if (s.ok0[t0 + k]) last = t0 + k;
  int prev = __shfl_up_sync(FULL, warp_incl_max(last), 1);
  if (lane == 0) prev = -1;
  // pass B: gaps and merge decisions; chunk totals
  int n_start = 0, n_skip = 0, s_mc = 0, m_j = -1, first_start = T;
  bool neg_gap = false;
  if (owns) {
    for (int k = 0; k < CH; ++k) {
      const int t = t0 + k;
      const bool ok = s.ok0[t];
      const int kind = s.kk[t];
      const int gap = s.pos[t] - (prev >= 0 ? s.endf[prev] : 0);
      const int pkind = prev >= 0 ? s.kk[prev] : NOOP;
      const bool merge = ok && pkind == kind && gap == 0 && (kind == REMOVE || kind == INSERT);
      const bool st = ok && !merge;
      const bool ws = st && gap > 0;
      s.gap[t] = gap;
      s.start[t] = st;
      s.wskip[t] = ws;
      n_start += st;
      n_skip += ws;
      s_mc += s.mc[t];
      neg_gap = neg_gap || (ok && gap < 0);
      if (st && first_start == T) first_start = t;
      if (ok) {
        m_j = t / NS;
        prev = t;
      }
    }
  }
  const int inc_start = warp_incl_sum(n_start);
  const int inc_skip = warp_incl_sum(n_skip);
  const int inc_mc = warp_incl_sum(s_mc);
  int mj = __shfl_up_sync(FULL, warp_incl_max(m_j), 1);
  if (lane == 0) mj = -1;
  int nsa = __shfl_down_sync(FULL, warp_suffix_min(first_start), 1);
  if (lane == 31) nsa = T;
  const int out_n = __shfl_sync(FULL, inc_start, 31) + __shfl_sync(FULL, inc_skip, 31);
  const bool any_neg = __any_sync(FULL, neg_gap);
  if (owns) {
    // pass C: inclusive group ids, skip counts, count sums, last source j
    int g = inc_start - n_start, ns = inc_skip - n_skip, cs = inc_mc - s_mc;
    for (int k = 0; k < CH; ++k) {
      const int t = t0 + k;
      g += s.start[t];
      ns += s.wskip[t];
      cs += s.mc[t];
      if (s.ok0[t]) mj = t / NS;
      s.slot[t] = g - 1 + ns;
      s.csum[t] = cs;
      s.cmj[t] = mj;
    }
    // pass D (backward): each group's last atom = next start - 1
    for (int k = CH - 1; k >= 0; --k) {
      const int t = t0 + k;
      s.gend[t] = min(nsa - 1, T - 1);
      if (s.start[t]) nsa = t;
    }
  }
  __syncwarp();

  // output slot s = lane: the first atom whose slot reaches s
  bool diff = false;
  if (lane < M) {
    int lo = 0, hi = T;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (s.slot[mid] < lane) lo = mid + 1; else hi = mid;
    }
    const int h = min(lo, T - 1);
    const int sl = s.slot[h];
    const bool is_mark = s.start[h] && sl == lane;
    const bool is_skip = s.wskip[h] && sl == lane + 1;
    const int ge = s.gend[h];
    const int k = is_mark ? s.kk[h] : (is_skip ? SKIP : 0);
    const int cnt = is_mark ? s.csum[ge] - s.csum[h] + s.mc[h] : (is_skip ? s.gap[h] : 0);
    out.kind[lane] = k;
    out.cnt[lane] = cnt;
    out.lo[lane] = is_mark ? h / NS : 0;
    out.hi[lane] = is_mark ? s.cmj[ge] : 0;
    diff = k != ak[lane] || cnt != ac[lane];
  }
  const bool any_diff = __any_sync(FULL, diff);
  if (lane == 0) {
    out.n = out_n;
    out.bad = coll || any_neg || out_n > M;
    out.ident = out_n == a_n && !any_diff;
  }
  __syncwarp();
}

// [Skip(p), Modify] (or [Modify] at p == 0), column i
__device__ __forceinline__ int synth_kind(int p, int i) {
  return i == 0 ? (p > 0 ? SKIP : MODIFY) : (i == 1 ? (p > 0 ? MODIFY : NOOP) : NOOP);
}
__device__ __forceinline__ int synth_cnt(int p, int i) {
  return i == 0 ? (p > 0 ? p : 1) : (i == 1 ? (p > 0 ? 1 : 0) : 0);
}

__device__ __forceinline__ int clamp_m(int i) { return min(max(i, 0), M - 1); }

// Word w of one side rebuilt from its leg's output (the reference's rebuild).
__device__ int rebuilt(const int* side, const Leg& L, bool is_int, bool surv, int npos,
                       int lstar, unsigned drops, int w) {
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
  const bool live = i < L.n;
  if (!live) return 0;
  switch (f) {
    case 0: return L.kind[i];
    case 1: return L.cnt[i];
    case 2: return L.kind[i] == REMOVE ? side[O_DET + clamp_m(L.lo[i])] : 0;
    case 3: return side[O_SLO + clamp_m(L.lo[i])];
    default: return side[O_SHI + clamp_m(L.hi[i])];
  }
}

// One mirrored bridge pair on s.c and s.x; writes the step row to `row` and
// leaves c' in s.c.  `dead` is the window's prefix-validity carry.
__device__ void pair_step(Warp& s, bool elig, bool& dead, int* row) {
  const int lane = lane_id();
  const int* c = s.c;
  const int* x = s.x;
  const int cdep = c[O_DEP], xdep = x[O_DEP];
  int lstar = 0;
  for (int l = 0; l < PD; ++l) {
    if (!(l < cdep && l < xdep && c[O_FLD + l] == x[O_FLD + l] && c[O_POS + l] == x[O_POS + l]))
      break;
    ++lstar;
  }
  const bool c_int = lstar < cdep, x_int = lstar < xdep;
  const int f_c = c[O_FLD + lstar], f_x = x[O_FLD + lstar];
  const bool case_d = f_c < 0 || f_x < 0;
  const bool case_a = !case_d && f_c != f_x;
  const bool engage = !case_d && !case_a && !(c_int && x_int);
  const int lp = min(lstar, PD - 1);
  const int pc = c[O_POS + lp], px = x[O_POS + lp];
  if (lane < M) {
    s.ak[lane] = c_int ? synth_kind(pc, lane) : c[O_KIND + lane];
    s.ac[lane] = c_int ? synth_cnt(pc, lane) : c[O_CNT + lane];
    s.bk[lane] = x_int ? synth_kind(px, lane) : x[O_KIND + lane];
    s.bc[lane] = x_int ? synth_cnt(px, lane) : x[O_CNT + lane];
  }
  __syncwarp();
  flat_leg(s, s.ak, s.ac, s.bk, s.bc, true, s.leg[0]);
  flat_leg(s, s.bk, s.bc, s.ak, s.ac, false, s.leg[1]);
  const Leg& LC = s.leg[0];
  const Leg& LX = s.leg[1];

  const bool any_cdet = __any_sync(FULL, lane < M && c[O_DET + lane] > 0);
  const bool any_xdet = __any_sync(FULL, lane < M && x[O_DET + lane] > 0);
  const bool det_c = !c_int && any_cdet && !LC.ident;
  const bool det_x = !x_int && any_xdet && !LX.ident;
  const bool step_bad = engage && (LC.bad || LX.bad || det_c || det_x);
  const bool ok = elig && !dead && !step_bad;

  unsigned drops = 0;
  bool any_drop = false;
  for (int l = 0; l <= PD; ++l) {
    const bool d = c[O_VAL + l] > 0 && x[O_VAL + l] > 0 && l <= lstar;
    drops |= (unsigned)d << l;
    any_drop = any_drop || d;
  }
  bool surv_c = false, surv_x = false;
  for (int i = 0; i < M; ++i) {
    surv_c = surv_c || (LC.kind[i] == MODIFY && i < LC.n);
    surv_x = surv_x || (LX.kind[i] == MODIFY && i < LX.n);
  }
  const int npos_c = LC.kind[0] == SKIP ? LC.cnt[0] : 0;
  const int npos_x = LX.kind[0] == SKIP ? LX.cnt[0] : 0;
  const bool changed_c = engage && (c_int ? !(surv_c && npos_c == pc) : !LC.ident);
  const bool changed_x = engage && (x_int ? !(surv_x && npos_x == px) : !LX.ident);
  const bool apply_c = ok && engage && changed_c;
  const bool apply_x = ok && engage && changed_x;

  for (int w = lane; w < ENC; w += 32) {
    int xv;
    if (apply_x) {
      xv = rebuilt(x, LX, x_int, surv_x, npos_x, lstar, drops, w);
    } else {
      const int l = w - O_VAL;
      xv = (l >= 0 && l <= PD && ((drops >> l) & 1u)) ? 0 : x[w];
    }
    const int cv = apply_c ? rebuilt(c, LC, c_int, surv_c, npos_c, lstar, 0u, w) : c[w];
    row[S_X + w] = xv;
    row[S_STAGE + w] = cv;
    s.nc[w] = cv;
  }
  if (lane <= PD) row[S_DROP + lane] = (drops >> lane) & 1u;
  if (lane == 0) {
    row[S_VALID] = ok;
    row[S_IDC] = ok && !(engage && changed_c);
    row[S_IDX] = ok && !(engage && changed_x) && !any_drop;
  }
  __syncwarp();
  for (int w = lane; w < ENC; w += 32) s.c[w] = s.nc[w];
  __syncwarp();
  dead = dead || !ok;
}

__global__ void rebase_window_kernel(const int* __restrict__ c_in, const int* __restrict__ xs,
                                     const unsigned char* __restrict__ elig,
                                     int* __restrict__ final_c, int* __restrict__ steps,
                                     int W, int C) {
  __shared__ Warp smem[WPB];
  const int lane = lane_id();
  const int wib = threadIdx.x >> 5;
  const long long w = (long long)blockIdx.x * (blockDim.x >> 5) + wib;
  if (w >= W) return;  // the whole warp leaves together
  Warp& s = smem[wib];
  for (int k = lane; k < ENC; k += 32) s.c[k] = c_in[w * ENC + k];
  bool dead = false;
  for (int i = 0; i < C; ++i) {
    const long long r = w * C + i;
    for (int k = lane; k < ENC; k += 32) s.x[k] = xs[r * ENC + k];
    __syncwarp();
    pair_step(s, elig[r] != 0, dead, steps + r * STEP);
  }
  for (int k = lane; k < ENC; k += 32) final_c[w * ENC + k] = s.c[k];
}

}  // namespace

#ifndef RW_EMULATE
// c[W, 76], xs[W, C, 76] and elig[W, C] (uint8) in; final_c[W, 76] and
// steps[W, C, 160] out, all contiguous on the device.  Launches on `stream`
// and returns cudaGetLastError() (0 on success).
extern "C" int rebase_window_launch(const void* c, const void* xs, const void* elig,
                                    void* final_c, void* steps, int W, int C, void* stream) {
  if (W <= 0) return 0;
  const int wpb = W < WPB ? W : WPB;
  rebase_window_kernel<<<(W + wpb - 1) / wpb, 32 * wpb, 0, (cudaStream_t)stream>>>(
      (const int*)c, (const int*)xs, (const unsigned char*)elig, (int*)final_c, (int*)steps,
      W, C);
  return (int)cudaGetLastError();
}
#endif
