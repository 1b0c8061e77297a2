// Native deli sequencer: the ordering-service hot loop as a C library.
//
// The port's own copy of the repository's native/sequencer.cpp, built by
// g++ into fluidframework_tpu_torch/_build/ (native/sequencer_native.py).
//
// Reference parity: routerlicious deli's ticket() state machine
// (server/routerlicious/packages/lambdas/src/deli/lambda.ts:851 semantics,
// re-implemented): monotone sequence assignment, per-client clientSeq
// exactly-once validation, refSeq tracking, and MSN (minimum sequence
// number) computation over joined clients (clientSeqManager.ts) — the pure
// integer kernel the Python Sequencer wraps for tests and the pipeline
// runs in production form.
//
// C ABI for ctypes (no pybind11 in the image). All strings are
// NUL-terminated UTF-8. Thread-compatible (one state = one partition; the
// partition manager shards documents across states, so no locking here —
// same as deli's per-partition single-threaded consumption).

#include <cstdint>
#include <cstring>
#include <map>
#include <string>
#include <vector>

namespace {

struct ClientEntry {
    int32_t short_id;
    int64_t client_seq;  // last accepted clientSeq (exactly-once)
    int64_t ref_seq;     // latest refSeq observed from this client
};

struct SequencerState {
    int64_t seq;
    int64_t min_seq;     // last computed MSN (monotone)
    int32_t next_short;
    std::map<std::string, ClientEntry> clients;

    int64_t compute_msn() const {
        // MSN = min over clients' refSeq; with no clients the window floor
        // rides the head (deli: msn tracks seq when the quorum is empty).
        if (clients.empty()) return seq;
        int64_t m = INT64_MAX;
        for (const auto& kv : clients)
            m = kv.second.ref_seq < m ? kv.second.ref_seq : m;
        return m;
    }

    void advance_msn() {
        int64_t m = compute_msn();
        if (m > min_seq) min_seq = m;
    }
};

}  // namespace

extern "C" {

// Nack codes mirror server/sequencer.py ticket() rules.
enum TicketStatus {
    TICKET_OK = 0,
    NACK_NOT_JOINED = 1,
    NACK_REFSEQ_BELOW_MSN = 2,
    NACK_REFSEQ_FUTURE = 3,
    NACK_CLIENTSEQ_ORDER = 4,
};

void* seq_create(int64_t starting_seq) {
    auto* s = new SequencerState();
    s->seq = starting_seq;
    s->min_seq = 0;
    s->next_short = 0;
    return s;
}

void seq_destroy(void* h) { delete static_cast<SequencerState*>(h); }

int64_t seq_current(void* h) { return static_cast<SequencerState*>(h)->seq; }
int64_t seq_min(void* h) {
    auto* s = static_cast<SequencerState*>(h);
    s->advance_msn();
    return s->min_seq;
}
int32_t seq_client_count(void* h) {
    return (int32_t) static_cast<SequencerState*>(h)->clients.size();
}

// Join: assigns the next short id, seq-stamps the join. Returns short id,
// with *out_seq = the join's sequence number, *out_min = MSN after join.
int32_t seq_join(void* h, const char* client_id, int64_t* out_seq, int64_t* out_min) {
    auto* s = static_cast<SequencerState*>(h);
    if (s->clients.count(client_id)) return -1;  // duplicate join
    ClientEntry e;
    e.short_id = s->next_short++;
    e.client_seq = 0;
    // The join message is stamped with the joiner's floor at the PRE-join
    // head; only after stamping does the joiner's window start at its own
    // join seq (matches server/sequencer.py join()).
    e.ref_seq = s->seq;
    s->clients[client_id] = e;
    s->seq += 1;
    s->advance_msn();
    *out_seq = s->seq;
    *out_min = s->min_seq;
    s->clients[client_id].ref_seq = s->seq;
    return e.short_id;
}

// Leave: seq-stamps the leave, drops the client from MSN computation.
// Returns the leaver's short id on success, -1 if unknown. The leave
// message is stamped exactly like the Python oracle's: clientSeq is the
// client's next clientSeq (last accepted + 1) and refSeq is the client's
// last observed refSeq — both reported via out params so the wrapper can
// persist a bit-identical op log.
int32_t seq_leave(void* h, const char* client_id, int64_t* out_seq, int64_t* out_min,
                  int64_t* out_client_seq, int64_t* out_ref_seq) {
    auto* s = static_cast<SequencerState*>(h);
    auto it = s->clients.find(client_id);
    if (it == s->clients.end()) return -1;
    int32_t short_id = it->second.short_id;
    *out_client_seq = it->second.client_seq + 1;
    *out_ref_seq = it->second.ref_seq;
    s->clients.erase(it);
    s->seq += 1;
    s->advance_msn();
    *out_seq = s->seq;
    *out_min = s->min_seq;
    return short_id;
}

// The hot loop: validate + stamp one op.
int32_t seq_ticket(void* h, const char* client_id, int64_t client_seq,
                   int64_t ref_seq, int64_t* out_seq, int64_t* out_min,
                   int32_t* out_short) {
    auto* s = static_cast<SequencerState*>(h);
    auto it = s->clients.find(client_id);
    if (it == s->clients.end()) return NACK_NOT_JOINED;
    if (ref_seq < s->min_seq) return NACK_REFSEQ_BELOW_MSN;
    if (ref_seq > s->seq) return NACK_REFSEQ_FUTURE;
    if (client_seq != it->second.client_seq + 1) return NACK_CLIENTSEQ_ORDER;
    it->second.client_seq = client_seq;
    if (ref_seq > it->second.ref_seq) it->second.ref_seq = ref_seq;
    s->seq += 1;
    s->advance_msn();
    *out_seq = s->seq;
    *out_min = s->min_seq;
    *out_short = it->second.short_id;
    return TICKET_OK;
}

// Service-minted message (summary acks): stamp without a client.
int64_t seq_mint_service(void* h, int64_t* out_min) {
    auto* s = static_cast<SequencerState*>(h);
    s->seq += 1;
    s->advance_msn();  // empty quorum: the floor rides the head
    *out_min = s->min_seq;
    return s->seq;
}

// ---------------------------------------------------------------- checkpoint
// Flat binary checkpoint (deli checkpointManager analog): the full integer
// state keyed by the caller's log offset. Layout:
//   int64 seq, int64 min_seq, int32 next_short, int32 n_clients,
//   then per client: int32 short, int64 client_seq, int64 ref_seq,
//                    int32 name_len, bytes name.
int64_t seq_checkpoint(void* h, uint8_t* buf, int64_t cap) {
    auto* s = static_cast<SequencerState*>(h);
    std::vector<uint8_t> out;
    auto put = [&out](const void* p, size_t n) {
        const uint8_t* b = static_cast<const uint8_t*>(p);
        out.insert(out.end(), b, b + n);
    };
    int32_t n = (int32_t)s->clients.size();
    put(&s->seq, 8); put(&s->min_seq, 8); put(&s->next_short, 4); put(&n, 4);
    for (const auto& kv : s->clients) {
        put(&kv.second.short_id, 4);
        put(&kv.second.client_seq, 8);
        put(&kv.second.ref_seq, 8);
        int32_t len = (int32_t)kv.first.size();
        put(&len, 4);
        put(kv.first.data(), len);
    }
    if ((int64_t)out.size() <= cap && buf) std::memcpy(buf, out.data(), out.size());
    return (int64_t)out.size();
}

void* seq_restore(const uint8_t* buf, int64_t len) {
    auto* s = new SequencerState();
    int64_t off = 0;
    bool bad = false;
    // Every read is validated against len so a truncated or corrupt
    // checkpoint yields nullptr instead of out-of-bounds reads.
    auto get = [&](void* p, size_t n) {
        if (bad || off + (int64_t)n > len) { bad = true; return; }
        std::memcpy(p, buf + off, n);
        off += (int64_t)n;
    };
    int32_t n = 0;
    get(&s->seq, 8); get(&s->min_seq, 8); get(&s->next_short, 4); get(&n, 4);
    if (bad || n < 0) { delete s; return nullptr; }
    for (int32_t i = 0; i < n; i++) {
        ClientEntry e; int32_t slen = 0;
        get(&e.short_id, 4); get(&e.client_seq, 8); get(&e.ref_seq, 8); get(&slen, 4);
        if (bad || slen < 0 || off + (int64_t)slen > len) { delete s; return nullptr; }
        std::string name(reinterpret_cast<const char*>(buf + off), (size_t)slen);
        off += slen;
        s->clients[name] = e;
    }
    return s;
}

}  // extern "C"
