// Native host dispatch plane: the merge-tree megastep as tight row loops.
//
// The port's own copy of the reference's native/megastep.cpp, built by
// native/gxx.py into fluidframework_tpu_torch/_build/ (loaded through
// native/megastep_native.py; parallel/native_plane.py is the plane).
//
// This is a transliteration of ops/mergetree_kernel.py's single-lane op
// branches (_do_insert/_do_remove/_do_annotate/_do_ack/_do_obliterate +
// compact/set_min_seq) over the SAME int32 state columns, applied as the
// [K, D, B] op ring apply_megastep dispatches.  The contract is byte
// identity with the reference's lax program and the port's torch program
// over the FULL arrays — including the shift remnants _open_slot leaves in
// padding slots and the _SEG_FILL values compaction writes there — so the
// conformance tests (tests/test_torch_dispatch_backends.py) compare raw
// columns, not just the canonical_doc live prefix.
//
// Two deliberate semantic notes, both proven no-ops for identity:
//  * The lax kernel gates the insert-time swallow analysis on a fleet
//    -global per-slice scalar (any doc's ob table nonempty | any op in
//    the slice is an OBLITERATE).  The full analysis on an EMPTY table
//    yields exactly the no-swallow result, so these loops always run it.
//  * Padding slots only ever hold shift remnants of previously-live
//    values or _SEG_FILL; a per-doc high-water mark (``hw``) bounds the
//    suffix that can differ from fill, so shifts memmove [k, hw) instead
//    of [k, S) — bitwise identical, not an approximation.
//
// Column pointer table (all int32, row-major, doc axis leading):
//   idx  field        shape
//    0   text         [D, T]
//    1   text_end     [D]
//    2   nseg         [D]
//    3   seg_start    [D, S]
//    4   seg_len      [D, S]
//    5   ins_key      [D, S]
//    6   ins_client   [D, S]
//    7   seg_uid      [D, S]
//    8   seg_obpre    [D, S]
//    9   rem_keys     [R, D, S]   (tuple fields stacked on a leading axis)
//   10   rem_clients  [R, D, S]
//   11   prop_keys    [P, D, S]
//   12   prop_vals    [P, D, S]
//   13   uid_next     [D]
//   14   ob_key       [D, OB]
//   15   ob_client    [D, OB]
//   16   ob_start_uid [D, OB]
//   17   ob_end_uid   [D, OB]
//   18   ob_start_side[D, OB]
//   19   ob_end_side  [D, OB]
//   20   ob_ref_seq   [D, OB]
//   21   min_seq      [D]
//   22   error        [D]
//
// dims: [D, T, S, R, P, OB, K, B, L]
// ops:  int32[K, D, B, 8]; payloads: int32[K, D, B, L].

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int32_t LOCAL_BASE = INT32_C(1) << 30;
constexpr int32_t NO_REMOVE = INT32_MAX;  // (1 << 31) - 1

constexpr int32_t ERR_SEG_OVERFLOW = 1;
constexpr int32_t ERR_TEXT_OVERFLOW = 2;
constexpr int32_t ERR_REM_OVERFLOW = 4;
constexpr int32_t ERR_POS_RANGE = 8;
constexpr int32_t ERR_OB_OVERFLOW = 16;

enum OpKind : int32_t {
  NOOP = 0,
  INSERT = 1,
  REMOVE = 2,
  ANNOTATE = 3,
  ACK = 4,
  OBLITERATE = 5,
};

constexpr int32_t SIDE_BEFORE = 0;
constexpr int32_t SIDE_AFTER = 1;

constexpr int MAX_TUPLE = 16;   // R / P slots supported
constexpr int MAX_OB = 64;      // obliterate window slots supported

// int32 wraparound arithmetic (jnp semantics; signed overflow is UB in
// C++, so route through uint32).
inline int32_t add32(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) +
                              static_cast<uint32_t>(b));
}
inline int32_t sub32(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) -
                              static_cast<uint32_t>(b));
}

// _SEG_FILL (mergetree_kernel._SEG_FILL): the padding-slot conventions.
struct SegFill {
  int32_t seg_start = 0, seg_len = 0, ins_key = 0, ins_client = -1;
  int32_t seg_uid = -1, seg_obpre = -1;
  int32_t rem_keys = NO_REMOVE, rem_clients = -1;
  int32_t prop_keys = -1, prop_vals = 0;
};
constexpr SegFill FILL{};

// One document's state columns (raw pointers into the fleet arrays).
struct Doc {
  int32_t* text;
  int32_t* text_end;
  int32_t* nseg;
  int32_t* seg_start;
  int32_t* seg_len;
  int32_t* ins_key;
  int32_t* ins_client;
  int32_t* seg_uid;
  int32_t* seg_obpre;
  int32_t* rem_keys[MAX_TUPLE];
  int32_t* rem_clients[MAX_TUPLE];
  int32_t* prop_keys[MAX_TUPLE];
  int32_t* prop_vals[MAX_TUPLE];
  int32_t* uid_next;
  int32_t* ob_key;
  int32_t* ob_client;
  int32_t* ob_start_uid;
  int32_t* ob_end_uid;
  int32_t* ob_start_side;
  int32_t* ob_end_side;
  int32_t* ob_ref_seq;
  int32_t* min_seq;
  int32_t* error;
  int T, S, R, P, OB;
  int hw;  // high-water: slots >= hw hold exact _SEG_FILL values
};

// Scratch reused across ops (sized once per call).
struct Scratch {
  std::vector<uint8_t> vis;
  std::vector<int32_t> vlen;
  std::vector<int32_t> excl;
  std::vector<uint8_t> mark;
  void size(int S) {
    vis.resize(S);
    vlen.resize(S);
    excl.resize(S);
    mark.resize(S);
  }
};

// _visible + _vis_lengths: perspective mask / visible prefix, live slots
// only (every lax consumer of these masks ANDs with _alive).  Returns
// the visible total.
int32_t compute_vis(const Doc& d, Scratch& sc, int32_t ref_seq,
                    int32_t client) {
  const int n = *d.nseg;
  int32_t run = 0;
  for (int i = 0; i < n; ++i) {
    bool ins_occ = d.ins_key[i] <= ref_seq || d.ins_client[i] == client;
    bool rem_occ = false;
    for (int r = 0; r < d.R; ++r) {
      if (d.rem_keys[r][i] <= ref_seq || d.rem_clients[r][i] == client) {
        rem_occ = true;
        break;
      }
    }
    bool v = ins_occ && !rem_occ;
    sc.vis[i] = v;
    int32_t vl = v ? d.seg_len[i] : 0;
    sc.vlen[i] = vl;
    sc.excl[i] = run;
    run = add32(run, vl);
  }
  return run;
}

// _tiebreak: >= keys win (grouped batches / back-to-front insert chunks).
inline bool tiebreak(const Doc& d, int i, int32_t op_key) {
  int32_t rem0 = NO_REMOVE;
  for (int r = 0; r < d.R; ++r)
    if (d.rem_keys[r][i] < rem0) rem0 = d.rem_keys[r][i];
  return op_key >= d.ins_key[i] || (rem0 < LOCAL_BASE && rem0 > op_key);
}

struct NewSeg {
  int32_t seg_start, seg_len, ins_key, ins_client, seg_uid, seg_obpre;
  int32_t rem_keys[MAX_TUPLE], rem_clients[MAX_TUPLE];
  int32_t prop_keys[MAX_TUPLE], prop_vals[MAX_TUPLE];
};

// One column's slot-open: shift [k, hw) right one, write newval at k.
// Slots >= hw are fill, and shifting fill over fill is the identity, so
// the bounded memmove reproduces lax _shift_right over the full array.
inline void shift_col(int32_t* a, int k, int hw, int S, int32_t newval) {
  int top = hw < S - 1 ? hw : S - 1;
  if (top > k) std::memmove(a + k + 1, a + k, (top - k) * sizeof(int32_t));
  a[k] = newval;
}

// _open_slot: conditionally shift every per-segment array right at k and
// write the new segment.  Returns whether the slot actually opened
// (capacity overflow latches ERR_SEG_OVERFLOW and cancels the shift).
bool open_slot(Doc& d, int k, bool doit, const NewSeg& ns) {
  if (!doit) return false;
  if (*d.nseg >= d.S) {
    *d.error |= ERR_SEG_OVERFLOW;
    return false;
  }
  const int hw = d.hw, S = d.S;
  shift_col(d.seg_start, k, hw, S, ns.seg_start);
  shift_col(d.seg_len, k, hw, S, ns.seg_len);
  shift_col(d.ins_key, k, hw, S, ns.ins_key);
  shift_col(d.ins_client, k, hw, S, ns.ins_client);
  shift_col(d.seg_uid, k, hw, S, ns.seg_uid);
  shift_col(d.seg_obpre, k, hw, S, ns.seg_obpre);
  for (int r = 0; r < d.R; ++r) {
    shift_col(d.rem_keys[r], k, hw, S, ns.rem_keys[r]);
    shift_col(d.rem_clients[r], k, hw, S, ns.rem_clients[r]);
  }
  for (int p = 0; p < d.P; ++p) {
    shift_col(d.prop_keys[p], k, hw, S, ns.prop_keys[p]);
    shift_col(d.prop_vals[p], k, hw, S, ns.prop_vals[p]);
  }
  *d.nseg += 1;
  int nhw = hw + 1;
  if (k + 1 > nhw) nhw = k + 1;
  d.hw = nhw < S ? nhw : S;
  return true;
}

// _ensure_boundary: split the segment strictly containing pos; After-side
// obliterate anchors on the split segment follow the right half's uid.
void ensure_boundary(Doc& d, Scratch& sc, int32_t pos, int32_t ref_seq,
                     int32_t client) {
  compute_vis(d, sc, ref_seq, client);
  const int n = *d.nseg;
  int k = -1;
  for (int i = 0; i < n; ++i) {
    if (sc.vis[i] && sc.excl[i] < pos &&
        pos < add32(sc.excl[i], sc.vlen[i])) {
      k = i;
      break;
    }
  }
  if (k < 0) return;
  const int32_t off = sub32(pos, sc.excl[k]);
  const int32_t old_uid = d.seg_uid[k];
  const int32_t right_uid = *d.uid_next;
  NewSeg right{};
  right.seg_start = add32(d.seg_start[k], off);
  right.seg_len = sub32(d.seg_len[k], off);
  right.ins_key = d.ins_key[k];
  right.ins_client = d.ins_client[k];
  right.seg_uid = right_uid;
  right.seg_obpre = d.seg_obpre[k];
  for (int r = 0; r < d.R; ++r) {
    right.rem_keys[r] = d.rem_keys[r][k];
    right.rem_clients[r] = d.rem_clients[r][k];
  }
  for (int p = 0; p < d.P; ++p) {
    right.prop_keys[p] = d.prop_keys[p][k];
    right.prop_vals[p] = d.prop_vals[p][k];
  }
  open_slot(d, k + 1, true, right);
  // The lax kernel trims the left half, bumps uid_next and moves anchors
  // whenever the split was REQUESTED — even when _open_slot's capacity
  // check cancelled the right half (error latched above).
  d.seg_len[k] = off;
  *d.uid_next = add32(*d.uid_next, 1);
  for (int j = 0; j < d.OB; ++j) {
    if (d.ob_start_uid[j] == old_uid && d.ob_start_side[j] == SIDE_AFTER)
      d.ob_start_uid[j] = right_uid;
    if (d.ob_end_uid[j] == old_uid && d.ob_end_side[j] == SIDE_AFTER)
      d.ob_end_uid[j] = right_uid;
  }
}

// _obliterate_swallow (via _ob_anchor_indices): the insert-time rule.
// Writes the new segment's R remove slots (sorted ascending, NO_REMOVE
// padded) + obpre; returns candidate-overflow.
bool obliterate_swallow(const Doc& d, int k, int32_t key, int32_t client,
                        int32_t ref_seq, NewSeg& ns) {
  const int OB = d.OB, n = *d.nseg;
  bool concurrent[MAX_OB], others[MAX_OB], acked_conc[MAX_OB],
      unacked_conc[MAX_OB];
  bool any_conc = false, any_others = false, any_acked = false;
  // argmax/argmin with lax first-occurrence tie-breaking, defaults over
  // the masked fills exactly as jnp.where produces them.
  int newest_i = 0, na_i = 0, ou_i = 0;
  int32_t newest_val = INT32_MIN, na_val = INT32_MIN, ou_val = INT32_MAX;
  for (int j = 0; j < OB; ++j) {
    bool used = d.ob_key[j] >= 0;
    int s_idx = 0, e_idx = 0;
    bool s_found = false, e_found = false;
    if (used) {
      for (int i = 0; i < n; ++i)
        if (d.seg_uid[i] == d.ob_start_uid[j]) {
          s_idx = i;
          s_found = true;
          break;
        }
      for (int i = 0; i < n; ++i)
        if (d.seg_uid[i] == d.ob_end_uid[j]) {
          e_idx = i;
          e_found = true;
          break;
        }
    }
    bool inside = used && s_found && e_found && s_idx < k && e_idx >= k;
    concurrent[j] = inside && d.ob_key[j] > ref_seq;
    others[j] = concurrent[j] && d.ob_client[j] != client;
    acked_conc[j] = concurrent[j] && d.ob_key[j] < LOCAL_BASE;
    unacked_conc[j] = concurrent[j] && d.ob_key[j] >= LOCAL_BASE;
    any_conc = any_conc || concurrent[j];
    any_others = any_others || others[j];
    any_acked = any_acked || acked_conc[j];
    int32_t ck = concurrent[j] ? d.ob_key[j] : -1;
    if (ck > newest_val) {
      newest_val = ck;
      newest_i = j;
    }
    int32_t ak = acked_conc[j] ? d.ob_key[j] : -1;
    if (ak > na_val) {
      na_val = ak;
      na_i = j;
    }
    int32_t uk = unacked_conc[j] ? d.ob_key[j] : NO_REMOVE;
    if (uk < ou_val) {
      ou_val = uk;
      ou_i = j;
    }
  }
  int32_t newest_key = concurrent[newest_i] ? d.ob_key[newest_i] : -1;
  int32_t newest_client = d.ob_client[newest_i];
  int32_t na_key = acked_conc[na_i] ? d.ob_key[na_i] : -1;
  int32_t na_client = d.ob_client[na_i];
  bool mark = any_others && any_conc && newest_client != client;
  bool include_acked =
      !any_acked || na_key == newest_key || na_client != client;
  int32_t ckeys[MAX_OB];
  for (int j = 0; j < OB; ++j) {
    bool cand = mark && ((others[j] && acked_conc[j] && include_acked) ||
                         (unacked_conc[j] && j == ou_i));
    ckeys[j] = cand ? d.ob_key[j] : NO_REMOVE;
  }
  // Extract the R smallest candidate stamps ascending (first-min ties).
  for (int r = 0; r < d.R; ++r) {
    int mi = 0;
    for (int j = 1; j < OB; ++j)
      if (ckeys[j] < ckeys[mi]) mi = j;
    int32_t kk = OB > 0 ? ckeys[mi] : NO_REMOVE;
    ns.rem_keys[r] = kk;
    ns.rem_clients[r] = kk < NO_REMOVE ? d.ob_client[mi] : -1;
    if (OB > 0) ckeys[mi] = NO_REMOVE;
  }
  bool overflow = false;
  for (int j = 0; j < OB; ++j)
    if (ckeys[j] < NO_REMOVE) overflow = true;
  ns.seg_obpre = any_conc ? newest_key : -1;
  return overflow;
}

// _do_insert.
void do_insert(Doc& d, Scratch& sc, const int32_t* op,
               const int32_t* payload, int L) {
  const int32_t key = op[1], client = op[2], ref_seq = op[3], pos = op[4];
  const int32_t text_len = op[6];
  ensure_boundary(d, sc, pos, ref_seq, client);
  const int32_t total = compute_vis(d, sc, ref_seq, client);
  const int n = *d.nseg;
  int k = n;
  for (int i = 0; i < n; ++i) {
    if (sc.excl[i] >= pos && (sc.vlen[i] > 0 || tiebreak(d, i, key))) {
      k = i;
      break;
    }
  }
  const bool text_over = add32(*d.text_end, text_len) > d.T;
  if (!text_over) {
    // Masked scatter with mode="drop": at most L payload entries land,
    // text_end still advances by text_len below (lax parity).
    int32_t lim = text_len < L ? text_len : L;
    for (int32_t t = 0; t < lim; ++t) {
      int32_t dst = add32(*d.text_end, t);
      if (dst >= 0 && dst < d.T) d.text[dst] = payload[t];
    }
  }
  NewSeg ns{};
  ns.seg_start = *d.text_end;
  ns.seg_len = text_len;
  ns.ins_key = key;
  ns.ins_client = client;
  ns.seg_uid = *d.uid_next;
  // Always the full analysis: on an empty ob table it reduces exactly to
  // _no_obliterate_swallow, which is how the lax per-slice gate stays a
  // pure optimization (see module comment).
  bool rem_over = obliterate_swallow(d, k, key, client, ref_seq, ns);
  for (int p = 0; p < d.P; ++p) {
    ns.prop_keys[p] = -1;
    ns.prop_vals[p] = 0;
  }
  const bool ok = !text_over && pos <= total;
  open_slot(d, k, ok, ns);  // seg overflow latches inside, uid/text still move
  if (ok) {
    *d.text_end = add32(*d.text_end, text_len);
    *d.uid_next = add32(*d.uid_next, 1);
  }
  if (text_over) *d.error |= ERR_TEXT_OVERFLOW;
  if (pos > total) *d.error |= ERR_POS_RANGE;
  if (ok && rem_over) *d.error |= ERR_REM_OVERFLOW;
}

// _mark_range: split both boundaries, mark visible fully-inside segments.
void mark_range(Doc& d, Scratch& sc, const int32_t* op) {
  const int32_t client = op[2], ref_seq = op[3], pos1 = op[4], pos2 = op[5];
  ensure_boundary(d, sc, pos1, ref_seq, client);
  ensure_boundary(d, sc, pos2, ref_seq, client);
  const int32_t total = compute_vis(d, sc, ref_seq, client);
  const int n = *d.nseg;
  for (int i = 0; i < n; ++i) {
    sc.mark[i] = sc.vis[i] && sc.excl[i] >= pos1 &&
                 add32(sc.excl[i], sc.vlen[i]) <= pos2 && sc.vlen[i] > 0;
  }
  if (pos2 > total) *d.error |= ERR_POS_RANGE;
}

// _splice_remove_stamp over sc.mark[0, nseg).
bool splice_remove_stamp(Doc& d, const Scratch& sc, int32_t key,
                         int32_t client) {
  bool overflow = false;
  const int n = *d.nseg;
  for (int i = 0; i < n; ++i) {
    if (!sc.mark[i]) continue;
    bool placed = false;
    for (int r = 0; r < d.R; ++r) {
      if (d.rem_keys[r][i] == NO_REMOVE) {
        d.rem_keys[r][i] = key;
        d.rem_clients[r][i] = client;
        placed = true;
        break;
      }
    }
    if (!placed) overflow = true;
  }
  return overflow;
}

void do_remove(Doc& d, Scratch& sc, const int32_t* op) {
  mark_range(d, sc, op);
  if (splice_remove_stamp(d, sc, op[1], op[2])) *d.error |= ERR_REM_OVERFLOW;
}

// _do_annotate: LWW by stamp key, >= ties to the later-applied op.
void do_annotate(Doc& d, Scratch& sc, const int32_t* op) {
  mark_range(d, sc, op);
  const int32_t key = op[1], prop_slot = op[6], value = op[7];
  if (prop_slot < 0 || prop_slot >= d.P) return;
  const int n = *d.nseg;
  int32_t* pk = d.prop_keys[prop_slot];
  int32_t* pv = d.prop_vals[prop_slot];
  for (int i = 0; i < n; ++i) {
    if (sc.mark[i] && key >= pk[i]) {
      pk[i] = key;
      pv[i] = value;
    }
  }
}

// _do_obliterate: sided mark + window-table record.
void do_obliterate(Doc& d, Scratch& sc, const int32_t* op) {
  const int32_t key = op[1], client = op[2], ref_seq = op[3];
  const int32_t pos1 = op[4], pos2 = op[5], side1 = op[6], side2 = op[7];
  const int32_t start_pos = add32(pos1, side1);
  const int32_t end_pos = add32(pos2, side2);
  int32_t total = compute_vis(d, sc, ref_seq, client);
  const bool valid =
      0 <= pos1 && pos1 <= pos2 && pos2 < total && start_pos <= end_pos;
  // Invalid ops split at 0 in the lax kernel — a strict-interior test
  // can never hit pos 0, so only the valid path splits.
  if (valid) {
    ensure_boundary(d, sc, start_pos, ref_seq, client);
    ensure_boundary(d, sc, end_pos, ref_seq, client);
  }
  compute_vis(d, sc, ref_seq, client);
  const int n = *d.nseg;
  int s_idx = n, e_idx = n;
  for (int i = 0; i < n; ++i)
    if (sc.vis[i] && sc.excl[i] <= pos1 &&
        pos1 < add32(sc.excl[i], sc.vlen[i])) {
      s_idx = i;
      break;
    }
  for (int i = 0; i < n; ++i)
    if (sc.vis[i] && sc.excl[i] <= pos2 &&
        pos2 < add32(sc.excl[i], sc.vlen[i])) {
      e_idx = i;
      break;
    }
  const int32_t lo = s_idx + (side1 == SIDE_AFTER ? 1 : 0);
  const int32_t hi = e_idx - (side2 == SIDE_BEFORE ? 1 : 0);
  const bool local_op = key >= LOCAL_BASE;
  for (int i = 0; i < n; ++i) {
    // _obliterate_visit, element-wise.
    int32_t rem_min = NO_REMOVE;
    bool same_client_stamp = false;
    for (int r = 0; r < d.R; ++r) {
      int32_t rk = d.rem_keys[r][i];
      if (rk < rem_min) rem_min = rk;
      if (d.rem_clients[r][i] == client && rk > d.ins_key[i] && rk <= key)
        same_client_stamp = true;
    }
    bool has_acked_rem = rem_min < LOCAL_BASE;
    bool is_local_ins = d.ins_key[i] >= LOCAL_BASE;
    bool ins_conc =
        !(d.ins_key[i] <= ref_seq || d.ins_client[i] == client);
    bool visit = local_op
                     ? static_cast<bool>(sc.vis[i])
                     : (!has_acked_rem || sc.vis[i] || is_local_ins ||
                        (ins_conc && !same_client_stamp));
    bool skip = is_local_ins && d.seg_obpre[i] >= LOCAL_BASE && !local_op;
    sc.mark[i] = valid && i >= lo && i <= hi && visit && !skip;
  }
  bool rem_over = splice_remove_stamp(d, sc, key, client);
  int slot = 0;
  bool has_free = false;
  for (int j = 0; j < d.OB; ++j)
    if (d.ob_key[j] < 0) {
      slot = j;
      has_free = true;
      break;
    }
  if (valid && has_free) {
    // Anchor reads clamp like jnp out-of-bounds gathers (s_idx/e_idx
    // default to nseg, which can equal S on a full doc).
    int si = s_idx < d.S ? s_idx : d.S - 1;
    int ei = e_idx < d.S ? e_idx : d.S - 1;
    d.ob_key[slot] = key;
    d.ob_client[slot] = client;
    d.ob_start_uid[slot] = d.seg_uid[si];
    d.ob_end_uid[slot] = d.seg_uid[ei];
    d.ob_start_side[slot] = side1;
    d.ob_end_side[slot] = side2;
    d.ob_ref_seq[slot] = ref_seq;
  }
  if (!valid) *d.error |= ERR_POS_RANGE;
  if (valid && !has_free) *d.error |= ERR_OB_OVERFLOW;
  if (rem_over) *d.error |= ERR_REM_OVERFLOW;
}

// _do_ack: pending localSeq stamps -> acked seq.  Scans [0, hw): the lax
// where() covers the full arrays, but slots >= hw hold exact fill values
// (0 / NO_REMOVE / -1), none of which can equal a local key (>= 2^30,
// < NO_REMOVE), so the bounded scan is identical.
void do_ack(Doc& d, const int32_t* op) {
  const int32_t new_client = op[2], new_ref = op[3];
  const int32_t local_seq = op[6], seq = op[7];
  const int32_t local_key = add32(LOCAL_BASE, local_seq);
  const bool rw_c = new_client >= 0;
  const int hw = d.hw;
  for (int i = 0; i < hw; ++i) {
    if (d.ins_key[i] == local_key) {
      d.ins_key[i] = seq;
      if (rw_c) d.ins_client[i] = new_client;
    }
    for (int r = 0; r < d.R; ++r) {
      if (d.rem_keys[r][i] == local_key) {
        d.rem_keys[r][i] = seq;
        if (rw_c) d.rem_clients[r][i] = new_client;
      }
    }
    for (int p = 0; p < d.P; ++p)
      if (d.prop_keys[p][i] == local_key) d.prop_keys[p][i] = seq;
    if (d.seg_obpre[i] == local_key) d.seg_obpre[i] = seq;
  }
  for (int j = 0; j < d.OB; ++j) {
    if (d.ob_key[j] == local_key) {
      d.ob_key[j] = seq;
      if (rw_c) d.ob_client[j] = new_client;
      if (new_ref >= 0) d.ob_ref_seq[j] = new_ref;
    }
  }
}

void apply_op(Doc& d, Scratch& sc, const int32_t* op, const int32_t* payload,
              int L) {
  int32_t kind = op[0];
  if (kind < 0) kind = 0;          // lax.switch clamps
  if (kind > OBLITERATE) kind = OBLITERATE;
  switch (kind) {
    case NOOP:
      break;
    case INSERT:
      do_insert(d, sc, op, payload, L);
      break;
    case REMOVE:
      do_remove(d, sc, op);
      break;
    case ANNOTATE:
      do_annotate(d, sc, op);
      break;
    case ACK:
      do_ack(d, op);
      break;
    case OBLITERATE:
      do_obliterate(d, sc, op);
      break;
  }
}

// set_min_seq + compact (zamboni), per doc: evict segments whose winning
// remove is acked at or below min_seq, keep obliterate anchors, write
// _SEG_FILL into every vacated slot (the lax gather fills [n_keep, S)).
void compact_doc(Doc& d, int32_t new_min_arg) {
  int32_t new_min = *d.min_seq > new_min_arg ? *d.min_seq : new_min_arg;
  *d.min_seq = new_min;
  for (int j = 0; j < d.OB; ++j) {
    int32_t k = d.ob_key[j];
    if (k >= 0 && k < LOCAL_BASE && k <= new_min) d.ob_key[j] = -1;
  }
  const int n = *d.nseg;
  int w = 0;
  for (int i = 0; i < n; ++i) {
    int32_t rem0 = NO_REMOVE;
    for (int r = 0; r < d.R; ++r)
      if (d.rem_keys[r][i] < rem0) rem0 = d.rem_keys[r][i];
    bool dead = rem0 < LOCAL_BASE && rem0 <= new_min;
    bool anchored = false;
    if (dead) {
      for (int j = 0; j < d.OB; ++j) {
        if (d.ob_key[j] >= 0 && (d.seg_uid[i] == d.ob_start_uid[j] ||
                                 d.seg_uid[i] == d.ob_end_uid[j])) {
          anchored = true;
          break;
        }
      }
    }
    if (dead && !anchored) continue;
    if (w != i) {
      d.seg_start[w] = d.seg_start[i];
      d.seg_len[w] = d.seg_len[i];
      d.ins_key[w] = d.ins_key[i];
      d.ins_client[w] = d.ins_client[i];
      d.seg_uid[w] = d.seg_uid[i];
      d.seg_obpre[w] = d.seg_obpre[i];
      for (int r = 0; r < d.R; ++r) {
        d.rem_keys[r][w] = d.rem_keys[r][i];
        d.rem_clients[r][w] = d.rem_clients[r][i];
      }
      for (int p = 0; p < d.P; ++p) {
        d.prop_keys[p][w] = d.prop_keys[p][i];
        d.prop_vals[p][w] = d.prop_vals[p][i];
      }
    }
    ++w;
  }
  for (int i = w; i < d.hw; ++i) {
    d.seg_start[i] = FILL.seg_start;
    d.seg_len[i] = FILL.seg_len;
    d.ins_key[i] = FILL.ins_key;
    d.ins_client[i] = FILL.ins_client;
    d.seg_uid[i] = FILL.seg_uid;
    d.seg_obpre[i] = FILL.seg_obpre;
    for (int r = 0; r < d.R; ++r) {
      d.rem_keys[r][i] = FILL.rem_keys;
      d.rem_clients[r][i] = FILL.rem_clients;
    }
    for (int p = 0; p < d.P; ++p) {
      d.prop_keys[p][i] = FILL.prop_keys;
      d.prop_vals[p][i] = FILL.prop_vals;
    }
  }
  *d.nseg = w;
  d.hw = w;
}

// Bind one doc's column pointers from the table + compute its high-water
// mark (first index from the top whose slot differs from _SEG_FILL).
bool bind_doc(Doc& d, const int64_t* cols, const int32_t* dims, int didx) {
  const int D = dims[0], T = dims[1], S = dims[2], R = dims[3], P = dims[4],
            OB = dims[5];
  if (R > MAX_TUPLE || P > MAX_TUPLE || OB > MAX_OB) return false;
  (void)D;
  auto p32 = [&](int c) { return reinterpret_cast<int32_t*>(cols[c]); };
  d.T = T;
  d.S = S;
  d.R = R;
  d.P = P;
  d.OB = OB;
  d.text = p32(0) + static_cast<int64_t>(didx) * T;
  d.text_end = p32(1) + didx;
  d.nseg = p32(2) + didx;
  d.seg_start = p32(3) + static_cast<int64_t>(didx) * S;
  d.seg_len = p32(4) + static_cast<int64_t>(didx) * S;
  d.ins_key = p32(5) + static_cast<int64_t>(didx) * S;
  d.ins_client = p32(6) + static_cast<int64_t>(didx) * S;
  d.seg_uid = p32(7) + static_cast<int64_t>(didx) * S;
  d.seg_obpre = p32(8) + static_cast<int64_t>(didx) * S;
  for (int r = 0; r < R; ++r) {
    d.rem_keys[r] = p32(9) + (static_cast<int64_t>(r) * dims[0] + didx) * S;
    d.rem_clients[r] =
        p32(10) + (static_cast<int64_t>(r) * dims[0] + didx) * S;
  }
  for (int p = 0; p < P; ++p) {
    d.prop_keys[p] = p32(11) + (static_cast<int64_t>(p) * dims[0] + didx) * S;
    d.prop_vals[p] = p32(12) + (static_cast<int64_t>(p) * dims[0] + didx) * S;
  }
  d.uid_next = p32(13) + didx;
  d.ob_key = p32(14) + static_cast<int64_t>(didx) * OB;
  d.ob_client = p32(15) + static_cast<int64_t>(didx) * OB;
  d.ob_start_uid = p32(16) + static_cast<int64_t>(didx) * OB;
  d.ob_end_uid = p32(17) + static_cast<int64_t>(didx) * OB;
  d.ob_start_side = p32(18) + static_cast<int64_t>(didx) * OB;
  d.ob_end_side = p32(19) + static_cast<int64_t>(didx) * OB;
  d.ob_ref_seq = p32(20) + static_cast<int64_t>(didx) * OB;
  d.min_seq = p32(21) + didx;
  d.error = p32(22) + didx;
  int hw = S;
  while (hw > 0) {
    const int i = hw - 1;
    bool fill = d.seg_start[i] == FILL.seg_start &&
                d.seg_len[i] == FILL.seg_len &&
                d.ins_key[i] == FILL.ins_key &&
                d.ins_client[i] == FILL.ins_client &&
                d.seg_uid[i] == FILL.seg_uid &&
                d.seg_obpre[i] == FILL.seg_obpre;
    for (int r = 0; fill && r < R; ++r)
      fill = d.rem_keys[r][i] == FILL.rem_keys &&
             d.rem_clients[r][i] == FILL.rem_clients;
    for (int p = 0; fill && p < P; ++p)
      fill = d.prop_keys[p][i] == FILL.prop_keys &&
             d.prop_vals[p][i] == FILL.prop_vals;
    if (!fill) break;
    --hw;
  }
  if (hw < *d.nseg) hw = *d.nseg;
  d.hw = hw;
  return true;
}

}  // namespace

extern "C" {

int32_t ms_abi_version() { return 1; }

// Apply a [K, D, B] op ring in place.  dims = [D,T,S,R,P,OB,K,B,L].
// Returns 0 on success, -1 on unsupported dims.
int32_t ms_megastep(const int64_t* cols, const int32_t* dims,
                    const int32_t* ops, const int32_t* payloads) {
  const int D = dims[0], K = dims[6], B = dims[7], L = dims[8];
  Scratch sc;
  sc.size(dims[2]);
  for (int dd = 0; dd < D; ++dd) {
    Doc d;
    if (!bind_doc(d, cols, dims, dd)) return -1;
    for (int k = 0; k < K; ++k) {
      const int64_t slice = (static_cast<int64_t>(k) * D + dd) * B;
      for (int b = 0; b < B; ++b) {
        apply_op(d, sc, ops + (slice + b) * 8, payloads + (slice + b) * L, L);
      }
    }
  }
  return 0;
}

// set_min_seq + compact every doc in place.  dims = [D,T,S,R,P,OB].
int32_t ms_compact(const int64_t* cols, const int32_t* dims,
                   const int32_t* min_seqs) {
  const int D = dims[0];
  for (int dd = 0; dd < D; ++dd) {
    Doc d;
    if (!bind_doc(d, cols, dims, dd)) return -1;
    compact_doc(d, min_seqs[dd]);
  }
  return 0;
}

}  // extern "C"
