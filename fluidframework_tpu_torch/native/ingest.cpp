// Native wire-ingest encoder: JSON-lines sequenced messages -> op tensors.
//
// The device fleet (models/doc_batch_engine.py) applies merge-tree ops from
// int32 row tensors; producing those rows from the wire is pure host work
// and the measured ingest bottleneck when done per-op in Python.  This is
// the C++ data-plane equivalent of the reference's server-side codecs
// (routerlicious consumes Kafka JSON through native librdkafka + JS codecs;
// here the whole decode+encode runs native).
//
// One encoder per document: it owns the quorum table (clientId -> short id,
// built from sequenced joins), the property-slot interning table, and the
// MSN watermark — the same per-doc host state DocBatchEngine keeps.
//
// The parser is a STREAMING recursive-descent JSON reader specialized for
// the SequencedMessage schema (protocol/messages.py to_json): no DOM, no
// per-line allocation (string scratch buffers are reused), tolerant of key
// order, handles escapes incl. \uXXXX surrogate pairs, and decodes UTF-8
// to codepoints so payload rows match Python's ord() exactly.
//
// Build: native/ingest_native.py warm() runs
//   g++ -O2 -shared -fPIC -std=c++17 -o _build/libtpuingest-<hash>.so ingest.cpp
// (the package's _build/ directory; the name carries the source's hash).

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

// Op row layout mirrors ops/mergetree_kernel.py:
//   0 kind | 1 key | 2 client | 3 ref_seq | 4 pos1 | 5 pos2 | 6 a | 7 b
enum OpKind { NOOP = 0, INSERT = 1, REMOVE = 2, ANNOTATE = 3, ACK = 4, OBLITERATE = 5 };
constexpr int OP_FIELDS = 8;
constexpr int SIDE_BEFORE = 0, SIDE_AFTER = 1;

struct Scanner {
  const char* p;
  const char* end;

  void skip_ws() {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\r' || *p == '\n')) p++;
  }
  bool consume(char c) {
    skip_ws();
    if (p < end && *p == c) { p++; return true; }
    return false;
  }
  char peek() {
    skip_ws();
    return p < end ? *p : '\0';
  }
};

// Decode a JSON string starting AT the opening quote.  Appends codepoints
// to *cps (when non-null) and raw bytes to *bytes (when non-null).
bool parse_string(Scanner& s, std::vector<uint32_t>* cps, std::string* bytes) {
  if (!s.consume('"')) return false;
  while (s.p < s.end) {
    unsigned char c = (unsigned char)*s.p;
    if (c == '"') { s.p++; return true; }
    uint32_t cp;
    if (c == '\\') {
      s.p++;
      if (s.p >= s.end) return false;
      char e = *s.p++;
      switch (e) {
        case '"': cp = '"'; break;
        case '\\': cp = '\\'; break;
        case '/': cp = '/'; break;
        case 'b': cp = '\b'; break;
        case 'f': cp = '\f'; break;
        case 'n': cp = '\n'; break;
        case 'r': cp = '\r'; break;
        case 't': cp = '\t'; break;
        case 'u': {
          if (s.end - s.p < 4) return false;
          cp = 0;
          for (int i = 0; i < 4; i++) {
            char h = *s.p++;
            cp <<= 4;
            if (h >= '0' && h <= '9') cp |= h - '0';
            else if (h >= 'a' && h <= 'f') cp |= h - 'a' + 10;
            else if (h >= 'A' && h <= 'F') cp |= h - 'A' + 10;
            else return false;
          }
          if (cp >= 0xD800 && cp <= 0xDBFF && s.end - s.p >= 6 &&
              s.p[0] == '\\' && s.p[1] == 'u') {
            uint32_t lo = 0;
            bool ok = true;
            for (int i = 0; i < 4; i++) {
              char h = s.p[2 + i];
              lo <<= 4;
              if (h >= '0' && h <= '9') lo |= h - '0';
              else if (h >= 'a' && h <= 'f') lo |= h - 'a' + 10;
              else if (h >= 'A' && h <= 'F') lo |= h - 'A' + 10;
              else { ok = false; break; }
            }
            if (ok && lo >= 0xDC00 && lo <= 0xDFFF) {
              cp = 0x10000 + ((cp - 0xD800) << 10) + (lo - 0xDC00);
              s.p += 6;
            }
          }
          break;
        }
        default: return false;
      }
    } else {
      int extra;
      if (c < 0x80) { cp = c; extra = 0; }
      else if ((c >> 5) == 0x6) { cp = c & 0x1F; extra = 1; }
      else if ((c >> 4) == 0xE) { cp = c & 0x0F; extra = 2; }
      else if ((c >> 3) == 0x1E) { cp = c & 0x07; extra = 3; }
      else return false;
      s.p++;
      for (int i = 0; i < extra; i++) {
        if (s.p >= s.end || ((unsigned char)*s.p >> 6) != 0x2) return false;
        cp = (cp << 6) | ((unsigned char)*s.p & 0x3F);
        s.p++;
      }
    }
    if (cps) cps->push_back(cp);
    if (bytes) {
      // Re-encode codepoint as UTF-8 (ids/keys are normally ASCII).
      if (cp < 0x80) bytes->push_back((char)cp);
      else if (cp < 0x800) {
        bytes->push_back((char)(0xC0 | (cp >> 6)));
        bytes->push_back((char)(0x80 | (cp & 0x3F)));
      } else if (cp < 0x10000) {
        bytes->push_back((char)(0xE0 | (cp >> 12)));
        bytes->push_back((char)(0x80 | ((cp >> 6) & 0x3F)));
        bytes->push_back((char)(0x80 | (cp & 0x3F)));
      } else {
        bytes->push_back((char)(0xF0 | (cp >> 18)));
        bytes->push_back((char)(0x80 | ((cp >> 12) & 0x3F)));
        bytes->push_back((char)(0x80 | ((cp >> 6) & 0x3F)));
        bytes->push_back((char)(0x80 | (cp & 0x3F)));
      }
    }
  }
  return false;
}

// Fast path for OBJECT KEYS: our schema's keys are plain ASCII without
// escapes, so scan straight to the closing quote (fall back to the full
// string parser if a backslash shows up).
bool parse_key(Scanner& s, std::string* out) {
  if (!s.consume('"')) return false;
  const char* q = (const char*)memchr(s.p, '"', s.end - s.p);
  if (!q) return false;
  if (memchr(s.p, '\\', q - s.p)) {  // escaped key: rare, take the slow path
    s.p--;  // back onto the opening quote
    out->clear();
    return parse_string(s, nullptr, out);
  }
  out->assign(s.p, q - s.p);
  s.p = q + 1;
  return true;
}

bool parse_number(Scanner& s, double* out) {
  s.skip_ws();
  char* endp = nullptr;
  *out = strtod(s.p, &endp);
  if (endp == s.p) return false;
  s.p = endp;
  return true;
}

bool skip_value(Scanner& s);

bool skip_container(Scanner& s, char open, char close) {
  if (!s.consume(open)) return false;
  if (s.consume(close)) return true;
  while (true) {
    if (open == '{') {
      if (!parse_string(s, nullptr, nullptr)) return false;
      if (!s.consume(':')) return false;
    }
    if (!skip_value(s)) return false;
    if (s.consume(',')) continue;
    return s.consume(close);
  }
}

bool skip_value(Scanner& s) {
  char c = s.peek();
  if (c == '{') return skip_container(s, '{', '}');
  if (c == '[') return skip_container(s, '[', ']');
  if (c == '"') return parse_string(s, nullptr, nullptr);
  if (c == 't') { s.p += 4; return s.p <= s.end; }
  if (c == 'f') { s.p += 5; return s.p <= s.end; }
  if (c == 'n') { s.p += 4; return s.p <= s.end; }
  double d;
  return parse_number(s, &d);
}

struct Encoder {
  int max_insert_len;
  int prop_slots;
  int64_t min_seq = 0;
  std::unordered_map<std::string, int32_t> quorum;
  std::unordered_map<int64_t, int32_t> prop_slot;
  std::string error;
  // Reused per-line scratch (the no-allocation-per-line contract).
  std::string key, str_a, str_b;
  std::vector<uint32_t> seg;

  int prop_for(int64_t prop) {
    auto it = prop_slot.find(prop);
    if (it != prop_slot.end()) return it->second;
    if ((int)prop_slot.size() >= prop_slots) return -1;
    int slot = (int)prop_slot.size();
    prop_slot.emplace(prop, slot);
    return slot;
  }
};

struct Out {
  int32_t* ops;
  int32_t* payloads;
  int32_t max_rows;
  int L;
  int32_t n = 0;
  bool overflow = false;

  int32_t* next_row() {
    if (n >= max_rows) { overflow = true; return nullptr; }
    int32_t* row = ops + (int64_t)n * OP_FIELDS;
    memset(payloads + (int64_t)n * L, 0, sizeof(int32_t) * L);
    n++;
    return row;
  }
};

// Parsed fields of one contents object (wire op forms, shared_string.py).
struct Contents {
  int64_t type = -1;
  int64_t pos1 = 0, pos2 = 0;         // plain positions
  int64_t p1pos = 0, p2pos = 0;       // sided places
  bool p1before = true, p2before = true;
  bool sided1 = false, sided2 = false;
  bool has_seg = false;
  // join form
  bool has_client = false;
  int64_t short_id = -1;
  // annotate: (prop id, value) pairs
  std::vector<std::pair<int64_t, int64_t>> props;
};

// Parse a place object {"pos": N, "before": B}.
bool parse_place(Scanner& s, Encoder& e, int64_t* pos, bool* before) {
  if (!s.consume('{')) return false;
  if (s.consume('}')) return true;
  while (true) {
    if (!parse_key(s, &e.key)) return false;
    if (!s.consume(':')) return false;
    if (e.key == "pos") {
      double d;
      if (!parse_number(s, &d)) return false;
      *pos = (int64_t)d;
    } else if (e.key == "before") {
      char c = s.peek();
      if (c == 't') { *before = true; s.p += 4; }
      else if (c == 'f') { *before = false; s.p += 5; }
      else return false;
    } else if (!skip_value(s)) {
      return false;
    }
    if (s.consume(',')) continue;
    return s.consume('}');
  }
}

bool parse_contents(Scanner& s, Encoder& e, Contents* c) {
  if (s.peek() == 'n') { s.p += 4; return true; }  // null contents
  if (!s.consume('{')) return false;
  if (s.consume('}')) return true;
  while (true) {
    if (!parse_key(s, &e.key)) return false;
    if (!s.consume(':')) return false;
    if (e.key == "type") {
      double d;
      if (!parse_number(s, &d)) return false;
      c->type = (int64_t)d;
    } else if (e.key == "pos1") {
      if (s.peek() == '{') {
        c->sided1 = true;
        if (!parse_place(s, e, &c->p1pos, &c->p1before)) return false;
      } else {
        double d;
        if (!parse_number(s, &d)) return false;
        c->pos1 = (int64_t)d;
      }
    } else if (e.key == "pos2") {
      if (s.peek() == '{') {
        c->sided2 = true;
        if (!parse_place(s, e, &c->p2pos, &c->p2before)) return false;
      } else {
        double d;
        if (!parse_number(s, &d)) return false;
        c->pos2 = (int64_t)d;
      }
    } else if (e.key == "seg") {
      e.seg.clear();
      if (!parse_string(s, &e.seg, nullptr)) return false;
      c->has_seg = true;
    } else if (e.key == "props") {
      if (!s.consume('{')) return false;
      if (!s.consume('}')) {
        while (true) {
          e.str_b.clear();
          if (!parse_string(s, nullptr, &e.str_b)) return false;
          if (!s.consume(':')) return false;
          double d;
          if (!parse_number(s, &d)) return false;
          // Match the Python path's int(prop): a non-numeric key must error
          // loudly, never collapse to id 0.
          char* kend = nullptr;
          int64_t pid = strtoll(e.str_b.c_str(), &kend, 10);
          if (kend == e.str_b.c_str() || *kend != '\0') return false;
          c->props.emplace_back(pid, (int64_t)d);
          if (s.consume(',')) continue;
          if (!s.consume('}')) return false;
          break;
        }
      }
    } else if (e.key == "clientId") {
      e.str_a.clear();
      if (!parse_string(s, nullptr, &e.str_a)) return false;
      c->has_client = true;
    } else if (e.key == "short") {
      double d;
      if (!parse_number(s, &d)) return false;
      c->short_id = (int64_t)d;
    } else if (!skip_value(s)) {
      return false;
    }
    if (s.consume(',')) continue;
    return s.consume('}');
  }
}

bool emit_line(Encoder& e, Scanner& s, Out& out) {
  // Top-level message fields.
  int64_t seq = 0, ref = 0, mseq = 0;
  char mtype = '\0';  // 'o' op, 'j' join, other
  bool have_contents = false;
  Contents c;
  e.str_a.clear();  // join contents clientId
  std::string client_id;

  if (!s.consume('{')) { e.error = "json parse error"; return false; }
  if (!s.consume('}')) {
    while (true) {
      if (!parse_key(s, &e.key)) { e.error = "bad key"; return false; }
      if (!s.consume(':')) { e.error = "missing colon"; return false; }
      if (e.key == "sequenceNumber") {
        double d; if (!parse_number(s, &d)) return false; seq = (int64_t)d;
      } else if (e.key == "referenceSequenceNumber") {
        double d; if (!parse_number(s, &d)) return false; ref = (int64_t)d;
      } else if (e.key == "minimumSequenceNumber") {
        double d; if (!parse_number(s, &d)) return false; mseq = (int64_t)d;
      } else if (e.key == "type") {
        e.str_b.clear();
        if (!parse_string(s, nullptr, &e.str_b)) return false;
        mtype = e.str_b == "op" ? 'o' : (e.str_b == "join" ? 'j' : 'x');
      } else if (e.key == "clientId") {
        client_id.clear();
        if (!parse_string(s, nullptr, &client_id)) return false;
      } else if (e.key == "contents") {
        if (!parse_contents(s, e, &c)) { e.error = "bad contents"; return false; }
        have_contents = true;
      } else if (!skip_value(s)) {
        e.error = "bad value";
        return false;
      }
      if (s.consume(',')) continue;
      if (s.consume('}')) break;
      e.error = "unterminated object";
      return false;
    }
  }

  if (mseq > e.min_seq) e.min_seq = mseq;
  if (mtype == 'j') {
    if (!have_contents || !c.has_client || c.short_id < 0) {
      e.error = "bad join";
      return false;
    }
    e.quorum[e.str_a] = (int32_t)c.short_id;
    return true;
  }
  if (mtype != 'o') return true;  // leave/noop/summarize...: MSN only
  auto q = e.quorum.find(client_id);
  if (q == e.quorum.end()) { e.error = "op from unjoined client"; return false; }
  int32_t client = q->second;

  if (c.type == 0) {  // INSERT: chunk back-to-front (mk.encode_insert)
    if (!c.has_seg) { e.error = "insert without seg"; return false; }
    int n = (int)e.seg.size();
    int L = e.max_insert_len;
    int nchunks = (n + L - 1) / L;
    for (int ch = nchunks - 1; ch >= 0; ch--) {
      int start = ch * L;
      int len = std::min(L, n - start);
      int32_t* row = out.next_row();
      if (!row) return true;
      row[0] = INSERT; row[1] = (int32_t)seq; row[2] = client;
      row[3] = (int32_t)ref; row[4] = (int32_t)c.pos1; row[5] = 0;
      row[6] = len; row[7] = 0;
      int32_t* pay = out.payloads + (int64_t)(out.n - 1) * out.L;
      for (int i = 0; i < len; i++) pay[i] = (int32_t)e.seg[start + i];
    }
  } else if (c.type == 1) {  // REMOVE
    int32_t* row = out.next_row();
    if (!row) return true;
    row[0] = REMOVE; row[1] = (int32_t)seq; row[2] = client;
    row[3] = (int32_t)ref; row[4] = (int32_t)c.pos1; row[5] = (int32_t)c.pos2;
    row[6] = row[7] = 0;
  } else if (c.type == 2) {  // ANNOTATE: one row per property
    for (auto& pv : c.props) {
      int slot = e.prop_for(pv.first);
      if (slot < 0) { e.error = "out of prop slots"; return false; }
      int32_t* row = out.next_row();
      if (!row) return true;
      row[0] = ANNOTATE; row[1] = (int32_t)seq; row[2] = client;
      row[3] = (int32_t)ref; row[4] = (int32_t)c.pos1; row[5] = (int32_t)c.pos2;
      row[6] = slot; row[7] = (int32_t)pv.second;
    }
  } else if (c.type == 4) {  // OBLITERATE plain: (pos1,Before)..(pos2-1,After)
    int32_t* row = out.next_row();
    if (!row) return true;
    row[0] = OBLITERATE; row[1] = (int32_t)seq; row[2] = client;
    row[3] = (int32_t)ref; row[4] = (int32_t)c.pos1;
    row[5] = (int32_t)c.pos2 - 1; row[6] = SIDE_BEFORE; row[7] = SIDE_AFTER;
  } else if (c.type == 5) {  // OBLITERATE_SIDED
    if (!c.sided1 || !c.sided2) { e.error = "bad sided places"; return false; }
    int32_t* row = out.next_row();
    if (!row) return true;
    row[0] = OBLITERATE; row[1] = (int32_t)seq; row[2] = client;
    row[3] = (int32_t)ref; row[4] = (int32_t)c.p1pos; row[5] = (int32_t)c.p2pos;
    row[6] = c.p1before ? SIDE_BEFORE : SIDE_AFTER;
    row[7] = c.p2before ? SIDE_BEFORE : SIDE_AFTER;
  } else {
    e.error = "unsupported op type";
    return false;
  }
  return true;
}

// ---------------------------------------------------------------------------
// Tree wire decode: sequenced tree-edit batches -> mark-pool columns.
//
// The tree family's host fold pools sequence-field mark lists as columnar
// spans (fluidframework_tpu/dds/tree/mark_pool.py).  This decoder parses
// the NUMERIC PLANE of a tree op batch — message envelopes, edit framing,
// and every mark's kind/count/id/offset — straight into flat columns, and
// hands payloads that are genuinely object-shaped (insert content, removed
// subtrees, nested changes, non-sequence field kinds) back to Python as
// RAW JSON byte spans, so only those spans pay a json.loads.
//
// Stateless by design (no quorum/prop tables: tree identity is the
// client-id string plus the edit's (sid, rev) revision, all returned as
// spans), so one call decodes a whole feed chunk idempotently.  Anything
// the columnar grammar cannot express — grouped batches, address
// envelopes, dict-form commits with constraints, escaped key strings —
// degrades per MESSAGE to an opaque contents span the Python side parses
// exactly like the no-native path, and a malformed line fails the whole
// call so the Python oracle owns error semantics.
// ---------------------------------------------------------------------------

namespace tree {

// Mark kind codes — MUST match dds/tree/mark_pool.py (K_SKIP..K_MOVEIN).
enum MarkKind { MK_SKIP = 0, MK_INSERT = 1, MK_REMOVE = 2, MK_MODIFY = 3,
                MK_MOVEOUT = 4, MK_MOVEIN = 5 };

constexpr int MSG_FIELDS = 14;   // see ing_tree_decode docstring
constexpr int CHG_FIELDS = 3;
constexpr int FLD_FIELDS = 4;
constexpr int MARK_FIELDS = 5;

// Message status codes.
enum MsgStatus { ST_EDITS = 0, ST_SKIP = 1, ST_OPAQUE = 2 };

struct TreeOut {
  const char* base;
  int64_t* msgs; int32_t max_msgs;
  int32_t* chgs; int32_t max_chgs;
  int32_t* flds; int32_t max_flds;
  int32_t* marks; int32_t max_marks;
  int64_t* spans; int32_t max_spans;
  int32_t n_msgs = 0, n_chgs = 0, n_flds = 0, n_marks = 0, n_spans = 0;
  bool overflow = false;

  int32_t span(const char* s, const char* e) {
    if (n_spans >= max_spans) { overflow = true; return -1; }
    spans[2 * (int64_t)n_spans] = s - base;
    spans[2 * (int64_t)n_spans + 1] = e - s;
    return n_spans++;
  }
  int32_t* mark_row() {
    if (n_marks >= max_marks) { overflow = true; return nullptr; }
    int32_t* r = marks + (int64_t)n_marks++ * MARK_FIELDS;
    r[0] = r[1] = r[2] = r[3] = 0; r[4] = -1;
    return r;
  }
  int32_t* fld_row() {
    if (n_flds >= max_flds) { overflow = true; return nullptr; }
    int32_t* r = flds + (int64_t)n_flds++ * FLD_FIELDS;
    r[0] = -1; r[1] = r[2] = 0; r[3] = -1;
    return r;
  }
  int32_t* chg_row() {
    if (n_chgs >= max_chgs) { overflow = true; return nullptr; }
    int32_t* r = chgs + (int64_t)n_chgs++ * CHG_FIELDS;
    r[0] = r[1] = 0; r[2] = -1;
    return r;
  }
};

// Raw escape-free string span (keys / ids / tags).  Any backslash fails —
// the caller degrades to the opaque route, never mis-slices.
bool span_string(Scanner& s, const char** b, const char** e) {
  s.skip_ws();
  if (s.p >= s.end || *s.p != '"') return false;
  const char* q = (const char*)memchr(s.p + 1, '"', s.end - s.p - 1);
  if (!q) return false;
  if (memchr(s.p + 1, '\\', q - s.p - 1)) return false;
  *b = s.p + 1; *e = q; s.p = q + 1;
  return true;
}

// Record the extent of one JSON value as a span (payload handoff).
int32_t value_span(Scanner& s, TreeOut& out) {
  s.skip_ws();
  const char* start = s.p;
  if (!skip_value(s)) return -2;  // malformed
  return out.span(start, s.p);
}

bool parse_i64(Scanner& s, int64_t* v) {
  double d;
  if (!parse_number(s, &d)) return false;
  *v = (int64_t)d;
  return true;
}

// One mark array element; emits one mark row.  Returns false on malformed
// input (whole-line error: Python owns the failure semantics).
bool parse_mark(Scanner& s, TreeOut& out) {
  if (!s.consume('[')) return false;
  const char* tb; const char* te;
  if (!span_string(s, &tb, &te)) return false;
  size_t tl = te - tb;
  int32_t* row = out.mark_row();
  if (row == nullptr) return false;  // overflow: caller retries the call
  int64_t v = 0;
  if (tl == 1 && *tb == 's') {
    row[0] = MK_SKIP;
    if (!s.consume(',') || !parse_i64(s, &v)) return false;
    row[1] = (int32_t)v;
  } else if (tl == 1 && *tb == 'i') {
    row[0] = MK_INSERT;
    if (!s.consume(',')) return false;
    row[4] = value_span(s, out);
    if (row[4] == -2) return false;
  } else if (tl == 1 && *tb == 'r') {
    row[0] = MK_REMOVE;
    if (!s.consume(',') || !parse_i64(s, &v)) return false;
    row[1] = (int32_t)v;
    if (s.peek() == ',') {
      s.consume(',');
      row[4] = value_span(s, out);
      if (row[4] == -2) return false;
    }
  } else if (tl == 1 && *tb == 'm') {
    row[0] = MK_MODIFY;
    row[1] = 1;
    if (!s.consume(',')) return false;
    row[4] = value_span(s, out);
    if (row[4] == -2) return false;
  } else if (tl == 2 && tb[0] == 'm' && tb[1] == 'o') {
    row[0] = MK_MOVEOUT;
    if (!s.consume(',') || !parse_i64(s, &v)) return false;
    row[1] = (int32_t)v;
    if (!s.consume(',') || !parse_i64(s, &v)) return false;
    row[2] = (int32_t)v;
    if (s.peek() == ',') {
      s.consume(',');
      if (!parse_i64(s, &v)) return false;
      row[3] = (int32_t)v;
    }
  } else if (tl == 2 && tb[0] == 'm' && tb[1] == 'i') {
    row[0] = MK_MOVEIN;
    if (!s.consume(',') || !parse_i64(s, &v)) return false;
    row[2] = (int32_t)v;  // id
    if (!s.consume(',') || !parse_i64(s, &v)) return false;
    row[1] = (int32_t)v;  // count
    row[3] = -1;          // offset None sentinel (mark_pool._NONE_OFF)
    if (s.peek() == ',') {
      s.consume(',');
      if (s.peek() == 'n') { s.p += 4; }
      else if (parse_i64(s, &v)) row[3] = (int32_t)v;
      else return false;
    }
  } else {
    return false;  // unknown tag: Python raises on it, so do we
  }
  return s.consume(']');
}

// One NodeChange object {"v": [...], "f": {key: fieldchange}}.
bool parse_change(Scanner& s, TreeOut& out) {
  int32_t* chg = out.chg_row();
  int32_t fld_start = out.n_flds;
  int32_t v_span = -1;
  if (!s.consume('{')) return false;
  if (!s.consume('}')) {
    while (true) {
      const char* kb; const char* ke;
      if (!span_string(s, &kb, &ke)) return false;
      if (!s.consume(':')) return false;
      size_t kl = ke - kb;
      if (kl == 1 && *kb == 'v') {
        v_span = value_span(s, out);
        if (v_span == -2) return false;
      } else if (kl == 1 && *kb == 'f') {
        if (!s.consume('{')) return false;
        if (!s.consume('}')) {
          while (true) {
            const char* fb; const char* fe;
            if (!span_string(s, &fb, &fe)) return false;
            if (!s.consume(':')) return false;
            int32_t* fld = out.fld_row();
            int32_t key_span = out.span(fb, fe);
            int32_t mark_start = out.n_marks;
            if (s.peek() == '[') {
              s.consume('[');
              if (!s.consume(']')) {
                while (true) {
                  if (!parse_mark(s, out)) return false;
                  if (s.consume(',')) continue;
                  if (!s.consume(']')) return false;
                  break;
                }
              }
              if (fld != nullptr) {
                fld[0] = key_span;
                fld[1] = mark_start;
                fld[2] = out.n_marks - mark_start;
              }
            } else {
              // Non-sequence field kind: raw span, Python's registry
              // decodes it (same as the no-native path).
              int32_t os = value_span(s, out);
              if (os == -2) return false;
              if (fld != nullptr) {
                fld[0] = key_span;
                fld[3] = os;
              }
            }
            if (s.consume(',')) continue;
            if (!s.consume('}')) return false;
            break;
          }
        }
      } else if (!skip_value(s)) {
        return false;
      }
      if (s.consume(',')) continue;
      if (!s.consume('}')) return false;
      break;
    }
  }
  if (chg != nullptr) {
    chg[0] = fld_start;
    chg[1] = out.n_flds - fld_start;
    chg[2] = v_span;
  }
  return true;
}

enum ContentsResult { CT_EDIT, CT_OPAQUE, CT_ERROR };

// Parse contents as a direct {"type":"edit", "sid", "rev", "changes":[..]}
// object.  Emits chg/fld/mark/span rows as it goes; a shape the grammar
// cannot express rolls those rows back and reports CT_OPAQUE (the caller
// records the raw span instead).
ContentsResult parse_edit_contents(
    Scanner& s, TreeOut& out, int64_t* sid_off, int64_t* sid_len,
    int64_t* rev, int32_t* chg_start, int32_t* chg_count) {
  int32_t m0 = out.n_msgs, c0 = out.n_chgs, f0 = out.n_flds;
  int32_t k0 = out.n_marks, s0 = out.n_spans;
  (void)m0;
  bool is_edit = false, saw_changes = false;
  *chg_start = out.n_chgs;
  if (!s.consume('{')) return CT_OPAQUE;
  if (!s.consume('}')) {
    while (true) {
      const char* kb; const char* ke;
      if (!span_string(s, &kb, &ke)) goto opaque;
      if (!s.consume(':')) return CT_ERROR;
      {
        size_t kl = ke - kb;
        if (kl == 4 && memcmp(kb, "type", 4) == 0) {
          const char* vb; const char* ve;
          if (!span_string(s, &vb, &ve)) goto opaque;
          if (ve - vb != 4 || memcmp(vb, "edit", 4) != 0) goto opaque;
          is_edit = true;
        } else if (kl == 3 && memcmp(kb, "sid", 3) == 0) {
          const char* vb; const char* ve;
          if (!span_string(s, &vb, &ve)) goto opaque;
          *sid_off = vb - out.base;
          *sid_len = ve - vb;
        } else if (kl == 3 && memcmp(kb, "rev", 3) == 0) {
          if (!parse_i64(s, rev)) goto opaque;
        } else if (kl == 7 && memcmp(kb, "changes", 7) == 0) {
          if (s.peek() != '[') goto opaque;  // dict form (constraints)
          s.consume('[');
          saw_changes = true;
          if (!s.consume(']')) {
            while (true) {
              if (!parse_change(s, out)) return CT_ERROR;
              if (s.consume(',')) continue;
              if (!s.consume(']')) return CT_ERROR;
              break;
            }
          }
        } else if (!skip_value(s)) {
          return CT_ERROR;
        }
      }
      if (s.consume(',')) continue;
      if (!s.consume('}')) return CT_ERROR;
      break;
    }
  }
  if (!is_edit || !saw_changes) goto opaque;
  *chg_count = out.n_chgs - *chg_start;
  return CT_EDIT;
opaque:
  out.n_chgs = c0; out.n_flds = f0; out.n_marks = k0; out.n_spans = s0;
  return CT_OPAQUE;
}

}  // namespace tree

}  // namespace

extern "C" {

void* ing_create(int32_t max_insert_len, int32_t prop_slots) {
  auto* e = new Encoder();
  e->max_insert_len = max_insert_len;
  e->prop_slots = prop_slots;
  return e;
}

void ing_destroy(void* h) { delete (Encoder*)h; }

int64_t ing_min_seq(void* h) { return ((Encoder*)h)->min_seq; }

const char* ing_last_error(void* h) { return ((Encoder*)h)->error.c_str(); }

// Encode newline-separated JSON messages.  Returns rows written, or
// -1 on parse/semantic error (see ing_last_error), or -(2+rows) when
// out_ops capacity was exhausted mid-stream (caller grows and retries; all
// encoder state updates are idempotent so a re-run is safe).
int32_t ing_encode(void* h, const char* data, int64_t len,
                   int32_t* out_ops, int32_t* out_payloads, int32_t max_rows) {
  Encoder& e = *(Encoder*)h;
  e.error.clear();
  Out out{out_ops, out_payloads, max_rows, e.max_insert_len};
  const char* p = data;
  const char* end = data + len;
  while (p < end) {
    const char* nl = (const char*)memchr(p, '\n', end - p);
    const char* line_end = nl ? nl : end;
    if (line_end > p) {
      Scanner s{p, line_end};
      if (!emit_line(e, s, out)) return -1;
      if (out.overflow) return -(2 + out.n);
    }
    p = nl ? nl + 1 : end;
  }
  return out.n;
}

// Tree wire decode (see the tree:: namespace header comment).
//
// Layouts (row-major):
//   out_msgs  int64[max_msgs, 14]: seq, ref, min_seq, rev, client_off,
//             client_len, sid_off, sid_len, chg_start, chg_count, status
//             (0 edits, 1 skip, 2 opaque), opq_off, opq_len, client_seq
//   out_chgs  int32[max_chgs, 3]: fld_start, fld_count, v_span
//   out_flds  int32[max_flds, 4]: key_span, mark_start, mark_count,
//             opaque_span (>=0: non-sequence field change JSON)
//   out_marks int32[max_marks, 5]: kind, a, b, c, payload_span
//   out_spans int64[max_spans, 2]: byte offset, byte length (into data)
//
// Returns the message count (counts for all five tables in out_counts),
// -1 on a malformed line (*err_line = its index; the caller falls back to
// the Python decode, which owns error semantics), or -2 when any output
// table filled (caller doubles capacities and re-runs; the decode is
// stateless so a re-run is safe).
int32_t ing_tree_decode(const char* data, int64_t len,
                        int64_t* out_msgs, int32_t max_msgs,
                        int32_t* out_chgs, int32_t max_chgs,
                        int32_t* out_flds, int32_t max_flds,
                        int32_t* out_marks, int32_t max_marks,
                        int64_t* out_spans, int32_t max_spans,
                        int32_t* out_counts, int32_t* err_line) {
  using namespace tree;
  TreeOut out{data, out_msgs, max_msgs, out_chgs, max_chgs,
              out_flds, max_flds, out_marks, max_marks,
              out_spans, max_spans};
  *err_line = -1;
  const char* p = data;
  const char* end = data + len;
  int32_t line_idx = -1;
  while (p < end) {
    const char* nl = (const char*)memchr(p, '\n', end - p);
    const char* line_end = nl ? nl : end;
    if (line_end > p) {
      line_idx++;
      if (out.n_msgs >= max_msgs) return -2;
      int64_t* m = out_msgs + (int64_t)out.n_msgs * MSG_FIELDS;
      for (int i = 0; i < MSG_FIELDS; i++) m[i] = 0;
      m[10] = ST_SKIP;
      Scanner s{p, line_end};
      bool is_op = false;
      const char* cstart = nullptr;
      const char* cend = nullptr;
      if (!s.consume('{')) { *err_line = line_idx; return -1; }
      if (!s.consume('}')) {
        while (true) {
          const char* kb; const char* ke;
          if (!span_string(s, &kb, &ke)) { *err_line = line_idx; return -1; }
          if (!s.consume(':')) { *err_line = line_idx; return -1; }
          size_t kl = ke - kb;
          bool ok = true;
          if (kl == 14 && memcmp(kb, "sequenceNumber", 14) == 0) {
            ok = parse_i64(s, &m[0]);
          } else if (kl == 23 &&
                     memcmp(kb, "referenceSequenceNumber", 23) == 0) {
            ok = parse_i64(s, &m[1]);
          } else if (kl == 21 &&
                     memcmp(kb, "minimumSequenceNumber", 21) == 0) {
            ok = parse_i64(s, &m[2]);
          } else if (kl == 4 && memcmp(kb, "type", 4) == 0) {
            const char* vb; const char* ve;
            ok = span_string(s, &vb, &ve);
            is_op = ok && (ve - vb == 2) && memcmp(vb, "op", 2) == 0;
          } else if (kl == 20 &&
                     memcmp(kb, "clientSequenceNumber", 20) == 0) {
            ok = parse_i64(s, &m[13]);
          } else if (kl == 8 && memcmp(kb, "clientId", 8) == 0) {
            const char* vb; const char* ve;
            ok = span_string(s, &vb, &ve);
            if (ok) { m[4] = vb - data; m[5] = ve - vb; }
          } else if (kl == 8 && memcmp(kb, "contents", 8) == 0) {
            s.skip_ws();
            cstart = s.p;
            ok = skip_value(s);
            cend = s.p;
          } else {
            ok = skip_value(s);
          }
          if (!ok) { *err_line = line_idx; return -1; }
          if (s.consume(',')) continue;
          if (s.consume('}')) break;
          *err_line = line_idx;
          return -1;
        }
      }
      if (is_op && cstart != nullptr) {
        Scanner cs{cstart, cend};
        int32_t chg_start = 0, chg_count = 0;
        ContentsResult r = parse_edit_contents(
            cs, out, &m[6], &m[7], &m[3], &chg_start, &chg_count);
        if (r == CT_ERROR) {
          if (out.overflow) return -2;  // table filled mid-parse: retry
          *err_line = line_idx;
          return -1;
        }
        if (r == CT_EDIT) {
          m[8] = chg_start;
          m[9] = chg_count;
          m[10] = ST_EDITS;
        } else {
          m[10] = ST_OPAQUE;
          m[11] = cstart - data;
          m[12] = cend - cstart;
        }
      }
      if (out.overflow) return -2;
      out.n_msgs++;
    }
    p = nl ? nl + 1 : end;
  }
  out_counts[0] = out.n_msgs;
  out_counts[1] = out.n_chgs;
  out_counts[2] = out.n_flds;
  out_counts[3] = out.n_marks;
  out_counts[4] = out.n_spans;
  return out.n_msgs;
}

// Export the property interning table: writes up to max_entries
// (prop_id, slot) pairs into out_props/out_slots and returns the entry
// count.  This is the checkpoint-fidelity seam — the host folds these
// REAL property ids into its own table before cutting a checkpoint of a
// native-mode document, so restored annotations round-trip prop ids
// instead of this encoder's private slot numbers.
int32_t ing_prop_table(void* h, int64_t* out_props, int32_t* out_slots,
                       int32_t max_entries) {
  Encoder& e = *(Encoder*)h;
  int32_t n = 0;
  for (const auto& kv : e.prop_slot) {
    if (n >= max_entries) break;
    out_props[n] = kv.first;
    out_slots[n] = kv.second;
    ++n;
  }
  return n;
}

}  // extern "C"
