// Native wire-format decoder and run-detection walker for columnar
// text-change batches (the host codec of automerge_tpu_torch; a copy of
// the JAX package's automerge_tpu/native/codec.cpp).
//
// Decoding: JSON change lists (the sync wire format) go straight into the
// struct-of-arrays columns the engine consumes
// (engine/columnar.py:TextChangeBatch) by one recursive-descent pass into
// preallocated columns, where the Python decoder loops per op.
//
// Scope: ins/set/del/inc ops on ONE list/text object, with single-char
// string values or integer values. Anything else (nested objects, rich
// values, unknown fields that matter) sets `unsupported`, and the Python
// caller decodes the whole batch with the Python decoder instead.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -pthread codec.cpp, driven by
// automerge_tpu_torch/native/__init__.py (cached by a digest of source and
// flags; ctypes binding, no pybind11). ctypes releases the GIL for the
// duration of every call.

#include <algorithm>
#include <climits>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>
#include <unordered_map>

namespace {

struct Parser {
    const char* p;
    const char* end;
    bool ok = true;
    std::string err;

    explicit Parser(const char* s, size_t n) : p(s), end(s + n) {}

    void fail(const std::string& m) {
        if (ok) { ok = false; err = m; }
    }
    void ws() { while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r')) ++p; }
    bool eat(char c) {
        ws();
        if (p < end && *p == c) { ++p; return true; }
        return false;
    }
    bool expect(char c) {
        if (!eat(c)) fail(std::string("expected '") + c + "'");
        return ok;
    }
    bool peek(char c) { ws(); return p < end && *p == c; }

    // JSON string -> UTF-8 bytes (handles escapes incl. \uXXXX pairs)
    bool str(std::string& out) {
        out.clear();
        if (!expect('"')) return false;
        while (p < end && *p != '"') {
            char c = *p++;
            if (c != '\\') { out.push_back(c); continue; }
            if (p >= end) { fail("bad escape"); return false; }
            char e = *p++;
            switch (e) {
                case '"': out.push_back('"'); break;
                case '\\': out.push_back('\\'); break;
                case '/': out.push_back('/'); break;
                case 'b': out.push_back('\b'); break;
                case 'f': out.push_back('\f'); break;
                case 'n': out.push_back('\n'); break;
                case 'r': out.push_back('\r'); break;
                case 't': out.push_back('\t'); break;
                case 'u': {
                    if (end - p < 4) { fail("bad \\u"); return false; }
                    auto hex4 = [&]() {
                        unsigned v = 0;
                        for (int i = 0; i < 4; i++) {
                            char h = *p++;
                            v <<= 4;
                            if (h >= '0' && h <= '9') v |= h - '0';
                            else if (h >= 'a' && h <= 'f') v |= h - 'a' + 10;
                            else if (h >= 'A' && h <= 'F') v |= h - 'A' + 10;
                            else { fail("bad hex"); return 0u; }
                        }
                        return v;
                    };
                    unsigned cp = hex4();
                    if (!ok) return false;
                    if (cp >= 0xD800 && cp <= 0xDBFF) {  // surrogate pair
                        if (end - p < 6 || p[0] != '\\' || p[1] != 'u') {
                            fail("lone surrogate"); return false;
                        }
                        p += 2;
                        unsigned lo = hex4();
                        if (!ok) return false;
                        cp = 0x10000 + ((cp - 0xD800) << 10) + (lo - 0xDC00);
                    }
                    // encode UTF-8
                    if (cp < 0x80) out.push_back((char)cp);
                    else if (cp < 0x800) {
                        out.push_back((char)(0xC0 | (cp >> 6)));
                        out.push_back((char)(0x80 | (cp & 0x3F)));
                    } else if (cp < 0x10000) {
                        out.push_back((char)(0xE0 | (cp >> 12)));
                        out.push_back((char)(0x80 | ((cp >> 6) & 0x3F)));
                        out.push_back((char)(0x80 | (cp & 0x3F)));
                    } else {
                        out.push_back((char)(0xF0 | (cp >> 18)));
                        out.push_back((char)(0x80 | ((cp >> 12) & 0x3F)));
                        out.push_back((char)(0x80 | ((cp >> 6) & 0x3F)));
                        out.push_back((char)(0x80 | (cp & 0x3F)));
                    }
                    break;
                }
                default: fail("bad escape"); return false;
            }
        }
        return expect('"');
    }

    bool integer(long long& out) {
        ws();
        bool neg = false;
        if (p < end && *p == '-') { neg = true; ++p; }
        if (p >= end || *p < '0' || *p > '9') { fail("expected int"); return false; }
        long long v = 0;
        while (p < end && *p >= '0' && *p <= '9') {
            if (v > (LLONG_MAX - 9) / 10) {
                fail("int out of range");  // would wrap -> python fallback
                return false;
            }
            v = v * 10 + (*p++ - '0');
        }
        if (p < end && (*p == '.' || *p == 'e' || *p == 'E')) {
            fail("float value");  // unsupported -> python fallback
            return false;
        }
        out = neg ? -v : v;
        return true;
    }

    // skip any JSON value (for unknown fields)
    bool skip() {
        ws();
        if (p >= end) { fail("eof"); return false; }
        char c = *p;
        if (c == '"') { std::string s; return str(s); }
        if (c == '{') {
            ++p;
            if (eat('}')) return true;
            do {
                std::string k;
                if (!str(k) || !expect(':') || !skip()) return false;
            } while (eat(','));
            return expect('}');
        }
        if (c == '[') {
            ++p;
            if (eat(']')) return true;
            do { if (!skip()) return false; } while (eat(','));
            return expect(']');
        }
        if (!strncmp(p, "true", 4)) { p += 4; return true; }
        if (!strncmp(p, "false", 5)) { p += 5; return true; }
        if (!strncmp(p, "null", 4)) { p += 4; return true; }
        long long n;
        // tolerate floats when skipping
        if (*p == '-' || (*p >= '0' && *p <= '9')) {
            while (p < end && (*p == '-' || *p == '+' || *p == '.' ||
                               *p == 'e' || *p == 'E' ||
                               (*p >= '0' && *p <= '9'))) ++p;
            return true;
        }
        (void)n;
        fail("bad value");
        return false;
    }
};

constexpr int8_t KIND_INS = 0, KIND_SET = 1, KIND_DEL = 2, KIND_INC = 3;
constexpr int32_t HEAD_PARENT = -1;

struct Batch {
    bool unsupported = false;
    std::string err;
    std::string err_obj;                   // object id ops must target
    std::string scratch1, scratch2, scratch3, scratch4;  // join buffers
    // per change
    std::vector<std::string> actors;
    std::vector<int32_t> seqs;
    std::vector<std::string> deps_json;    // raw slices, decoded in python
    std::vector<std::string> messages;     // "" = none
    std::vector<uint8_t> has_message;
    // per op
    std::vector<int32_t> op_change;
    std::vector<int8_t> op_kind;
    std::vector<int32_t> op_ta, op_tc, op_pa, op_pc;
    std::vector<int64_t> op_value;
    // batch actor interning
    std::vector<std::string> actor_table;
    std::unordered_map<std::string, int32_t> actor_rank;

    int32_t intern(const std::string& a) {
        auto it = actor_rank.find(a);
        if (it != actor_rank.end()) return it->second;
        int32_t r = (int32_t)actor_table.size();
        actor_table.push_back(a);
        actor_rank.emplace(a, r);
        return r;
    }
};

// "actor:ctr" -> (rank, ctr); false if malformed
bool parse_elem_id(Batch& b, const std::string& id, int32_t& a, int32_t& c) {
    size_t pos = id.rfind(':');
    if (pos == std::string::npos || pos + 1 >= id.size()) return false;
    if (id.find('\n') != std::string::npos) return false;  // join-safe ids only
    long long ctr = 0;
    for (size_t i = pos + 1; i < id.size(); i++) {
        if (id[i] < '0' || id[i] > '9') return false;
        ctr = ctr * 10 + (id[i] - '0');
        if (ctr > INT32_MAX) return false;  // python fallback, no truncation
    }
    a = b.intern(id.substr(0, pos));
    c = (int32_t)ctr;
    return true;
}

// single-char UTF-8 string -> codepoint, or -1
int64_t single_codepoint(const std::string& s) {
    if (s.empty()) return -1;
    unsigned char c0 = s[0];
    size_t need = c0 < 0x80 ? 1 : (c0 >> 5) == 6 ? 2 : (c0 >> 4) == 14 ? 3
                  : (c0 >> 3) == 30 ? 4 : 0;
    if (need == 0 || s.size() != need) return -1;
    if (need == 1) return c0;
    uint32_t cp = c0 & (0x7F >> need);
    for (size_t i = 1; i < need; i++) {
        if ((s[i] & 0xC0) != 0x80) return -1;
        cp = (cp << 6) | (s[i] & 0x3F);
    }
    return cp;
}

bool parse_op(Parser& ps, Batch& b, const std::string& obj_id,
              int32_t change_row) {
    if (!ps.expect('{')) return false;
    std::string action, obj, key, value_str;
    long long elem = -1, value_int = 0;
    bool have_value_str = false, have_value_int = false, value_other = false;
    bool have_datatype = false;
    if (!ps.peek('}')) do {
        std::string k;
        if (!ps.str(k) || !ps.expect(':')) return false;
        if (k == "action") { if (!ps.str(action)) return false; }
        else if (k == "obj") { if (!ps.str(obj)) return false; }
        else if (k == "key") { if (!ps.str(key)) return false; }
        else if (k == "elem") { if (!ps.integer(elem)) return false; }
        else if (k == "value") {
            ps.ws();
            if (ps.peek('"')) { have_value_str = ps.str(value_str); if (!have_value_str) return false; }
            else if (ps.p < ps.end && (*ps.p == '-' || (*ps.p >= '0' && *ps.p <= '9'))) {
                if (!ps.integer(value_int)) { value_other = true; ps.ok = true; if (!ps.skip()) return false; }
                else have_value_int = true;
            } else { value_other = true; if (!ps.skip()) return false; }
        }
        else if (k == "datatype") { have_datatype = true; if (!ps.skip()) return false; }
        else { if (!ps.skip()) return false; }
    } while (ps.eat(','));
    if (!ps.expect('}')) return false;

    if (obj != obj_id) { b.unsupported = true; b.err = "op targets other object"; return true; }
    b.op_change.push_back(change_row);
    if (action == "ins") {
        if (elem < 0 || elem > INT32_MAX) {
            // missing 'elem' field (stays -1) or out of int32 range: defer
            // to the python decoder rather than emit a corrupt packed key
            b.unsupported = true;
            b.err = elem < 0 ? "ins without elem" : "elem out of range";
        }
        b.op_kind.push_back(KIND_INS);
        b.op_ta.push_back(-2);  // filled by caller: the change's actor
        b.op_tc.push_back(elem < 0 || elem > INT32_MAX ? 0 : (int32_t)elem);
        if (key == "_head") { b.op_pa.push_back(HEAD_PARENT); b.op_pc.push_back(0); }
        else {
            int32_t a = HEAD_PARENT, c = 0;
            if (!parse_elem_id(b, key, a, c)) {
                // keep columns aligned: the post-parse fixup loop walks all
                // columns of this change even on the unsupported path
                b.unsupported = true; b.err = "bad elemId";
            }
            b.op_pa.push_back(a); b.op_pc.push_back(c);
        }
        b.op_value.push_back(0);
    } else if (action == "set" || action == "del" || action == "inc") {
        b.op_kind.push_back(action == "set" ? KIND_SET : action == "del" ? KIND_DEL : KIND_INC);
        int32_t a = 0, c = 0;
        if (!parse_elem_id(b, key, a, c)) {
            b.unsupported = true; b.err = "bad elemId";  // columns stay aligned
            a = 0; c = 0;
        }
        b.op_ta.push_back(a); b.op_tc.push_back(c);
        b.op_pa.push_back(HEAD_PARENT); b.op_pc.push_back(0);
        if (action == "set") {
            if (have_datatype || value_other || have_value_int) {
                // pooled / rich values -> python decoder
                b.unsupported = true; b.err = "rich value";
                b.op_value.push_back(0);
            } else if (have_value_str) {
                int64_t cp = single_codepoint(value_str);
                if (cp < 0) { b.unsupported = true; b.err = "multi-char value"; }
                b.op_value.push_back(cp < 0 ? 0 : cp);
            } else { b.unsupported = true; b.err = "missing value"; b.op_value.push_back(0); }
        } else if (action == "inc") {
            b.op_value.push_back(have_value_int ? value_int : 0);
            if (!have_value_int) { b.unsupported = true; b.err = "inc without int"; }
        } else b.op_value.push_back(0);
    } else {
        b.unsupported = true; b.err = "unsupported action: " + action;
        // keep columns aligned
        b.op_kind.push_back(KIND_DEL);
        b.op_ta.push_back(0); b.op_tc.push_back(0);
        b.op_pa.push_back(HEAD_PARENT); b.op_pc.push_back(0);
        b.op_value.push_back(0);
    }
    return true;
}

bool parse_change(Parser& ps, Batch& b) {
    if (!ps.expect('{')) return false;
    int32_t row = (int32_t)b.actors.size();
    b.actors.emplace_back();
    b.seqs.push_back(0);
    b.deps_json.emplace_back("{}");
    b.messages.emplace_back();
    b.has_message.push_back(0);
    size_t ops_from = b.op_kind.size();
    // the python decoder raises on changes missing these fields; the
    // native tier must fall back, never default them (a seq-0 change
    // would queue forever in causal admission)
    bool saw_actor = false, saw_seq = false, saw_ops = false;
    if (!ps.peek('}')) do {
        std::string k;
        if (!ps.str(k) || !ps.expect(':')) return false;
        if (k == "actor") {
            saw_actor = true;
            if (!ps.str(b.actors[row])) return false;
            // actor ids travel '\n'-joined to python; exotic ids fall back
            if (b.actors[row].find('\n') != std::string::npos) {
                b.unsupported = true; b.err = "newline in actor id";
            }
        }
        else if (k == "seq") {
            saw_seq = true;
            long long s; if (!ps.integer(s)) return false;
            if (s < 0 || s > INT32_MAX) { b.unsupported = true; b.err = "seq out of range"; s = 0; }
            b.seqs[row] = (int32_t)s;
        }
        else if (k == "deps") {
            // deps is a flat {actor: seq} map; re-serialize compactly (the
            // python side json-decodes each line, so no raw input slices —
            // pretty-printed payloads must round-trip too)
            if (!ps.expect('{')) return false;
            std::string& out = b.deps_json[row];
            out = "{";
            if (!ps.peek('}')) {
                bool first = true;
                do {
                    std::string dk;
                    long long dv;
                    if (!ps.str(dk) || !ps.expect(':')) return false;
                    if (!ps.integer(dv)) { b.unsupported = true; b.err = "non-int dep"; return false; }
                    if (!first) out.push_back(',');
                    first = false;
                    out.push_back('"');
                    for (char ch : dk) {  // JSON-escape the actor id
                        if (ch == '"' || ch == '\\') { out.push_back('\\'); out.push_back(ch); }
                        else if ((unsigned char)ch < 0x20) {
                            char buf[8];
                            snprintf(buf, sizeof buf, "\\u%04x", ch);
                            out += buf;
                        } else out.push_back(ch);
                    }
                    out += "\":" + std::to_string(dv);
                } while (ps.eat(','));
            }
            if (!ps.expect('}')) return false;
            out.push_back('}');
        }
        else if (k == "message") {
            ps.ws();
            if (ps.peek('"')) {
                if (!ps.str(b.messages[row])) return false;
                b.has_message[row] = 1;
                if (b.messages[row].find('\x1f') != std::string::npos) {
                    b.unsupported = true; b.err = "separator in message";
                }
            }
            else {
                // null means absent (matches python's None); any other
                // non-string value the python path PRESERVES, so the
                // native tier must not silently drop it
                if (!ps.peek('n')) {
                    b.unsupported = true; b.err = "non-string message";
                }
                if (!ps.skip()) return false;
            }
        }
        else if (k == "ops") {
            saw_ops = true;
            if (!ps.expect('[')) return false;
            if (!ps.eat(']')) {
                do { if (!parse_op(ps, b, b.err_obj, row)) return false; } while (ps.eat(','));
                if (!ps.expect(']')) return false;
            }
        }
        else { if (!ps.skip()) return false; }
    } while (ps.eat(','));
    if (!ps.expect('}')) return false;
    if (!saw_actor || !saw_seq || !saw_ops) {
        b.unsupported = true; b.err = "change missing actor/seq/ops";
    }
    // ins target actor = the change's own actor
    int32_t rank = b.intern(b.actors[row]);
    for (size_t i = ops_from; i < b.op_kind.size(); i++)
        if (b.op_ta[i] == -2) b.op_ta[i] = rank;
    return true;
}

struct Handle {
    Batch b;
    std::string obj_id;
};

}  // namespace

extern "C" {

void* amtpu_parse(const char* json, long json_len, const char* obj_id) {
    auto* h = new Handle();
    h->obj_id = obj_id;
    h->b.err_obj = obj_id;
    Parser ps(json, (size_t)json_len);
    if (!ps.expect('[')) { h->b.unsupported = true; h->b.err = ps.err; return h; }
    if (!ps.eat(']')) {
        do {
            if (!parse_change(ps, h->b)) {
                h->b.unsupported = true;
                h->b.err = ps.err.empty() ? "parse error" : ps.err;
                return h;
            }
        } while (ps.eat(','));
        if (!ps.expect(']')) { h->b.unsupported = true; h->b.err = ps.err; }
    }
    return h;
}

int amtpu_unsupported(void* hv) { return ((Handle*)hv)->b.unsupported ? 1 : 0; }

const char* amtpu_error(void* hv) { return ((Handle*)hv)->b.err.c_str(); }

long amtpu_n_changes(void* hv) { return (long)((Handle*)hv)->b.actors.size(); }
long amtpu_n_ops(void* hv) { return (long)((Handle*)hv)->b.op_kind.size(); }
long amtpu_n_actors(void* hv) { return (long)((Handle*)hv)->b.actor_table.size(); }

void amtpu_fill_ops(void* hv, int32_t* op_change, int8_t* op_kind,
                    int32_t* ta, int32_t* tc, int32_t* pa, int32_t* pc,
                    int64_t* value) {
    Batch& b = ((Handle*)hv)->b;
    size_t n = b.op_kind.size();
    memcpy(op_change, b.op_change.data(), n * 4);
    memcpy(op_kind, b.op_kind.data(), n);
    memcpy(ta, b.op_ta.data(), n * 4);
    memcpy(tc, b.op_tc.data(), n * 4);
    memcpy(pa, b.op_pa.data(), n * 4);
    memcpy(pc, b.op_pc.data(), n * 4);
    memcpy(value, b.op_value.data(), n * 8);
}

void amtpu_fill_seqs(void* hv, int32_t* seqs) {
    Batch& b = ((Handle*)hv)->b;
    memcpy(seqs, b.seqs.data(), b.seqs.size() * 4);
}

// '\n'-joined string tables (actors, actor_table, deps json, messages)
static void join(const std::vector<std::string>& v, std::string& out) {
    out.clear();
    for (size_t i = 0; i < v.size(); i++) {
        if (i) out.push_back('\n');
        out += v[i];
    }
}

const char* amtpu_actors(void* hv) {
    auto* h = (Handle*)hv;
    join(h->b.actors, h->b.scratch1);
    return h->b.scratch1.c_str();
}
const char* amtpu_actor_table(void* hv) {
    auto* h = (Handle*)hv;
    join(h->b.actor_table, h->b.scratch2);
    return h->b.scratch2.c_str();
}
const char* amtpu_deps(void* hv) {
    auto* h = (Handle*)hv;
    join(h->b.deps_json, h->b.scratch3);
    return h->b.scratch3.c_str();
}
const char* amtpu_messages(void* hv) {
    auto* h = (Handle*)hv;
    // messages may contain '\n'; join with '\x1f' (unit separator)
    h->b.scratch4.clear();
    for (size_t i = 0; i < h->b.messages.size(); i++) {
        if (i) h->b.scratch4.push_back('\x1f');
        h->b.scratch4.push_back(h->b.has_message[i] ? '1' : '0');
        h->b.scratch4 += h->b.messages[i];
    }
    return h->b.scratch4.c_str();
}

void amtpu_free(void* hv) { delete (Handle*)hv; }

}  // extern "C"

// ---------------------------------------------------------------------------
// Typing-run detection over columnar op batches: the single-pass native
// form of engine/runs.py:detect_runs (same predicate, op by op). Python
// numpy needs ~8 vectorized passes over the columns; this walks them once.
// ---------------------------------------------------------------------------

struct RunPlan {
    std::vector<int64_t> hpos, run_len, head_slot, rpos, res_new_slot;
    std::vector<int32_t> blob;
    int64_t n_ins = 0;
    bool blob_lt_128 = true, blob_lt_256 = true;
};

// ---------------------------------------------------------------------------
// Parallel run detection. The greedy scan carries only (a) whether the scan
// position is even with respect to pair consumption — i.e. whether a pair
// crossing the chunk boundary consumed its first op — and (b) whether the
// immediately preceding pair ended at pos-2 (run contiguity). Chunks are
// therefore simulated speculatively for the two possible entry ALIGNMENTS
// (boundary op not consumed / consumed by a boundary-crossing pair), with
// contiguity resolved by construction: the sim assumes the "a pair may have
// ended at start-2" basis, and pairs continuing that entry run accumulate in
// `lead_len` instead of minting a head. The serial stitch then either merges
// the lead into the previous chunk's last run (entry was contiguous) or
// mints the head at the chunk start (it was not). Head slots / residual
// slots are stored chunk-local and rebased by the stitched global INS count.
// ---------------------------------------------------------------------------

struct SimOut {
    std::vector<int64_t> hpos, run_len, head_ins;  // heads; local ins before
    std::vector<int64_t> rpos, res_ins;  // residuals; local ins after, or -1
    std::vector<int32_t> blob;
    int64_t lead_len = 0;   // pairs continuing the PREVIOUS chunk's run
    int64_t ins_count = 0;  // INS ops consumed in this chunk
    int exit_state = 0;     // next chunk entry: 0 aligned/non-contig,
                            // 1 aligned/contig, 2 misaligned (consumed)
    bool blob_lt_128 = true, blob_lt_256 = true;
};

static void simulate_chunk(
    int64_t start, int64_t end, int64_t n, const int8_t* kind,
    const int32_t* ta, const int32_t* tc, const int32_t* pa,
    const int32_t* pc, const int64_t* val, const int32_t* row,
    SimOut& o) {
    constexpr int8_t INS = 0, SET = 1;
    constexpr int64_t NO_PAIR = INT64_MIN;  // can never equal i-2
    if (end > start) {
        o.blob.reserve((end - start) / 2 + 1);  // avoid regrow copies of
        o.hpos.reserve(1024);                   // the per-pair vector
        o.run_len.reserve(1024);
        o.head_ins.reserve(1024);
    }
    int64_t prev_pair = start - 2;  // entry basis: a pair MAY have ended
                                    // at start-2 (stitch resolves truth)
    // NOTE: a block-precomputed predicate-mask variant was measured
    // SLOWER here (the short-circuiting scalar compares run once per
    // PAIR, i.e. half the ops, while masks must be computed for every
    // op); the win on this path is -O3 -march=x86-64-v3 codegen, not
    // manual restructuring.
    int64_t i = start;
    while (i < end) {
        bool pair = (kind[i] == INS && i + 1 < n && kind[i + 1] == SET
                     && row[i + 1] == row[i] && ta[i + 1] == ta[i]
                     && tc[i + 1] == tc[i] && val[i + 1] >= 0
                     && val[i + 1] < (1LL << 31));
        if (pair) {
            bool cont = (prev_pair == i - 2 && prev_pair >= 0
                         && row[i] == row[i - 2]
                         && ta[i] == ta[i - 2] && tc[i] == tc[i - 2] + 1
                         && pa[i] == ta[i - 2] && pc[i] == tc[i - 2]);
            if (cont && o.hpos.empty() && o.rpos.empty()) {
                o.lead_len++;  // unbroken cont prefix from `start`
            } else if (cont) {
                o.run_len.back()++;
            } else {
                o.hpos.push_back(i);
                o.run_len.push_back(1);
                o.head_ins.push_back(o.ins_count);
            }
            int64_t v = val[i + 1];
            o.blob.push_back((int32_t)v);
            if (v >= 128) o.blob_lt_128 = false;
            if (v >= 256) o.blob_lt_256 = false;
            o.ins_count++;
            prev_pair = i;
            i += 2;
        } else {
            o.rpos.push_back(i);
            if (kind[i] == INS) {
                o.ins_count++;
                o.res_ins.push_back(o.ins_count);
            } else {
                o.res_ins.push_back(-1);
            }
            prev_pair = NO_PAIR;
            i += 1;
        }
    }
    if (i == end) {
        o.exit_state = (prev_pair == end - 2 && prev_pair >= 0) ? 1 : 0;
    } else {
        o.exit_state = 2;  // the pair at end-1 consumed op `end`
    }
}

extern "C" {

void* amtpu_detect_runs(
    int64_t n, const int8_t* kind, const int32_t* ta, const int32_t* tc,
    const int32_t* pa, const int32_t* pc, const int64_t* val,
    const int32_t* row, int64_t base_elems) {
    auto* p = new RunPlan();

    constexpr int64_t MIN_CHUNK = 1 << 19;  // thread fan-out threshold
    int64_t hw = (int64_t)std::thread::hardware_concurrency();
    // test/tuning hook: AMTPU_DETECT_THREADS forces the fan-out width so
    // the speculative stitch is exercisable on low-core machines
    if (const char* env_t = getenv("AMTPU_DETECT_THREADS")) {
        long forced = atol(env_t);
        if (forced > 0) hw = forced;
    }
    int64_t T = std::min(hw > 0 ? hw : 1, (n + MIN_CHUNK - 1) / MIN_CHUNK);
    T = std::min<int64_t>(T, 32);

    if (T <= 1) {
        // serial: single chunk, entry aligned and non-contiguous (a lead
        // cannot form: prev_pair = -2 fails the >= 0 guard)
        SimOut s;
        simulate_chunk(0, n, n, kind, ta, tc, pa, pc, val, row, s);
        p->hpos = std::move(s.hpos);
        p->run_len = std::move(s.run_len);
        p->head_slot.resize(p->hpos.size());
        for (size_t j = 0; j < p->hpos.size(); ++j)
            p->head_slot[j] = base_elems + s.head_ins[j] + 1;
        p->rpos = std::move(s.rpos);
        p->res_new_slot.resize(p->rpos.size());
        for (size_t j = 0; j < p->rpos.size(); ++j)
            p->res_new_slot[j] =
                s.res_ins[j] >= 0 ? base_elems + s.res_ins[j] : -1;
        p->blob = std::move(s.blob);
        p->n_ins = s.ins_count;
        p->blob_lt_128 = s.blob_lt_128;
        p->blob_lt_256 = s.blob_lt_256;
        return p;
    }

    std::vector<int64_t> cuts(T + 1);
    for (int64_t k = 0; k <= T; ++k) cuts[k] = n * k / T;
    // two sims per chunk: entry aligned at cuts[k], entry misaligned at
    // cuts[k]+1 (chunk 0 only aligned)
    std::vector<SimOut> A(T), M(T);
    std::vector<std::thread> threads;
    threads.reserve(2 * T - 1);  // one thread per SIM (not per chunk):
    for (int64_t k = 0; k < T; ++k) {  // keeps the critical path ~n/T
        threads.emplace_back([&, k] {  // instead of 2n/T
            simulate_chunk(cuts[k], cuts[k + 1], n, kind, ta, tc, pa, pc,
                           val, row, A[k]);
        });
        if (k > 0)
            threads.emplace_back([&, k] {
                simulate_chunk(cuts[k] + 1, cuts[k + 1], n, kind, ta, tc,
                               pa, pc, val, row, M[k]);
            });
    }
    for (auto& t : threads) t.join();

    // serial stitch: resolve each chunk's entry state, rebase slots
    int state = 0;
    int64_t ins_base = 0;
    for (int64_t k = 0; k < T; ++k) {
        SimOut& s = (state == 2) ? M[k] : A[k];
        if (s.lead_len) {
            if (state == 0) {
                // entry was NOT contiguous: the lead is its own run
                // headed at the chunk's first op (local ins count 0;
                // state 0 implies the aligned sim, so the first op is
                // at cuts[k])
                p->hpos.push_back(cuts[k]);
                p->run_len.push_back(s.lead_len);
                p->head_slot.push_back(base_elems + ins_base + 1);
            } else {
                p->run_len.back() += s.lead_len;
            }
        }
        p->hpos.insert(p->hpos.end(), s.hpos.begin(), s.hpos.end());
        p->run_len.insert(p->run_len.end(), s.run_len.begin(),
                          s.run_len.end());
        for (int64_t h : s.head_ins)
            p->head_slot.push_back(base_elems + ins_base + h + 1);
        p->rpos.insert(p->rpos.end(), s.rpos.begin(), s.rpos.end());
        for (int64_t r : s.res_ins)
            p->res_new_slot.push_back(
                r >= 0 ? base_elems + ins_base + r : -1);
        p->blob.insert(p->blob.end(), s.blob.begin(), s.blob.end());
        p->blob_lt_128 = p->blob_lt_128 && s.blob_lt_128;
        p->blob_lt_256 = p->blob_lt_256 && s.blob_lt_256;
        ins_base += s.ins_count;
        state = s.exit_state;
    }
    p->n_ins = ins_base;
    return p;
}

int64_t amtpu_plan_n_runs(void* pv) { return (int64_t)((RunPlan*)pv)->hpos.size(); }
int64_t amtpu_plan_n_pairs(void* pv) { return (int64_t)((RunPlan*)pv)->blob.size(); }
int64_t amtpu_plan_n_res(void* pv) { return (int64_t)((RunPlan*)pv)->rpos.size(); }
int64_t amtpu_plan_n_ins(void* pv) { return ((RunPlan*)pv)->n_ins; }
int amtpu_plan_blob_lt(void* pv, int bound) {
    auto* p = (RunPlan*)pv;
    return bound == 128 ? p->blob_lt_128 : p->blob_lt_256;
}

void amtpu_plan_fill(void* pv, int64_t* hpos, int64_t* run_len,
                     int64_t* head_slot, int64_t* rpos,
                     int64_t* res_new_slot, int32_t* blob) {
    auto* p = (RunPlan*)pv;
    memcpy(hpos, p->hpos.data(), p->hpos.size() * 8);
    memcpy(run_len, p->run_len.data(), p->run_len.size() * 8);
    memcpy(head_slot, p->head_slot.data(), p->head_slot.size() * 8);
    memcpy(rpos, p->rpos.data(), p->rpos.size() * 8);
    memcpy(res_new_slot, p->res_new_slot.data(), p->res_new_slot.size() * 8);
    memcpy(blob, p->blob.data(), p->blob.size() * 4);
}

void amtpu_plan_free(void* pv) { delete (RunPlan*)pv; }

}  // extern "C"

// ---------------------------------------------------------------------------
// DocSet round planning over the doc axis (engine/doc_set.py `_plan_axis`).
// For every planned document of one round: the three host stages its
// per-document planner (`_plan_fast`) runs through numpy on arrays of a few
// elements, here as one loop over the documents per stage, on concatenated
// inputs:
//
//   merge   the round's run heads as (actor rank << 32 | ctr) key ranges,
//           sorted, checked for overlap within the round and against every
//           resident tier, coalesced, appended as one tier, then the
//           size-doubling compaction: engine/host_index.py
//           `BatchRangeIndex.merge`, tier for tier;
//   lookup  every run parent in the document's staged tiers (the virtual
//           head takes slot 0), the winners' ranks and seqs, the runs'
//           element offsets;
//   mirror  engine/segments.py `SegmentMirror.apply_round`: the new heads,
//           the chain-break candidates q = par + 1 and their Lamport
//           comparison through the staged tiers' slot -> key map.
//
// A document's resident tiers are probed by binary search and copied only
// where the compaction merges them, so a round costs O(K log K + K T log R)
// a document for K new ranges and T tiers of R ranges, plus the mirror's
// copy; the slot -> key probes scan the tiers once, O(R log Q), and only
// for a document with chain-break candidates. Anything the per-document
// planner would reject or degrade on (an overlap, an unknown parent, a
// counter or rank outside the int32 envelope, an index outside the batch's
// tables, a slot missing from the index, unsorted mirror heads) stops the
// stage with a nonzero status (AXIS_*); the caller then plans the round per
// document, which raises or degrades exactly as it always did.
// ---------------------------------------------------------------------------

namespace {

enum : int64_t {
    AXIS_OK = 0,
    AXIS_SCOPE = 1,       // an index outside the tables, or the envelope
    AXIS_DUPLICATE = 2,   // an element id overlaps another
    AXIS_UNKNOWN = 3,     // a run parent the index does not hold
    AXIS_MIRROR = 4,      // the mirror update cannot be made here
};

constexpr int64_t HEAD_PARENT_ACTOR = -1;   // _common.HEAD_PARENT

struct RunRef {            // one sorted tier: resident, or made here
    const int64_t *s, *l, *z;
    int64_t n;
};

struct AxisPass {
    // --- inputs (the caller keeps every array alive until free) ---
    int64_t n_docs = 0, compact_tiers = 12;
    const int64_t *run_off, *rank_off, *crow_off, *tier_off;   // n_docs + 1
    const int32_t *ta, *tc, *pa, *pc;   // per run: the head op's columns
    const int64_t *row, *run_len, *head_slot;   // per run
    const int64_t* rank;                // per doc: batch actor -> rank
    const int32_t *row_rank, *row_seq;  // per doc: change row -> rank, seq
    const int64_t* tier_len;            // per resident tier
    const int64_t *t_s, *t_l, *t_z;     // resident tiers, concatenated
    const int64_t* m_len;               // per doc (-1: no mirror)
    const int64_t *m_h, *m_p, *m_c, *m_a;   // mirrors, concatenated
    const int64_t *n_elems, *n_pairs;   // per doc
    const uint8_t* relocate;            // per doc: copy the kept tiers too
    std::vector<int64_t> tier_data, mirror_data;   // data offsets
    int64_t bad_doc = -1;

    // --- merge ---
    std::vector<int64_t> keep;          // per doc: resident tiers kept
    std::vector<int64_t> new_off;       // per doc (n_docs + 1): new tiers
    std::vector<int64_t> new_len, new_data;   // per new tier
    std::vector<int64_t> o_s, o_l, o_z;       // new tiers' data
    std::vector<int64_t> actor;         // per run: the key's actor half
    // --- lookup ---
    std::vector<int64_t> parent_slot;   // per run
    // --- mirror ---
    std::vector<int64_t> mo_len;        // per doc (-1: no mirror)
    std::vector<int64_t> mo_h, mo_p, mo_c, mo_a;

    RunRef resident(int64_t t) const {
        int64_t o = tier_data[t];
        return {t_s + o, t_l + o, t_z + o, tier_len[t]};
    }
    RunRef made(int64_t k) const {
        int64_t o = new_data[k];
        return {o_s.data() + o, o_l.data() + o, o_z.data() + o, new_len[k]};
    }
    // the staged index of doc i: its kept tiers, then the ones made here
    void staged(int64_t i, std::vector<RunRef>& out) const {
        out.clear();
        for (int64_t t = tier_off[i]; t < tier_off[i] + keep[i]; ++t)
            out.push_back(resident(t));
        for (int64_t k = new_off[i]; k < new_off[i + 1]; ++k)
            out.push_back(made(k));
    }
    int64_t fail(int64_t code, int64_t i) {
        bad_doc = i;
        return code;
    }
};

// a sorted run, coalescing key- and slot-contiguous neighbours
// (host_index._coalesce), appended to out
struct Sink {
    std::vector<int64_t> s, l, z;
    void clear() { s.clear(); l.clear(); z.clear(); }
    void push(int64_t ks, int64_t kl, int64_t kz) {
        if (!s.empty() && s.back() + l.back() == ks &&
            z.back() + l.back() == kz) {
            l.back() += kl;
            return;
        }
        s.push_back(ks);
        l.push_back(kl);
        z.push_back(kz);
    }
    RunRef ref() const { return {s.data(), l.data(), z.data(),
                                 (int64_t)s.size()}; }
};

// two sorted, key-disjoint runs merged by start, a's first on a tie
// (host_index._merge_runs)
static void merge_into(const RunRef& a, const RunRef& b, Sink& out) {
    out.clear();
    int64_t i = 0, j = 0;
    while (i < a.n || j < b.n) {
        if (j >= b.n || (i < a.n && a.s[i] <= b.s[j])) {
            out.push(a.s[i], a.l[i], a.z[i]);
            ++i;
        } else {
            out.push(b.s[j], b.l[j], b.z[j]);
            ++j;
        }
    }
}

// position of the last start <= key, or -1 (searchsorted side="right" - 1)
static inline int64_t last_le(const int64_t* s, int64_t n, int64_t key) {
    return (int64_t)(std::upper_bound(s, s + n, key) - s) - 1;
}

static bool is_sorted64(const int64_t* a, int64_t n) {
    for (int64_t k = 1; k < n; ++k)
        if (a[k] < a[k - 1]) return false;
    return true;
}

}  // namespace

extern "C" {

void* amtpu_axis_begin(
    int64_t n_docs, int64_t compact_tiers, const int64_t* run_off,
    const int32_t* ta, const int32_t* tc, const int32_t* pa,
    const int32_t* pc, const int64_t* row, const int64_t* run_len,
    const int64_t* head_slot, const int64_t* rank_off, const int64_t* rank,
    const int64_t* crow_off, const int32_t* row_rank,
    const int32_t* row_seq, const int64_t* tier_off,
    const int64_t* tier_len, const int64_t* t_s, const int64_t* t_l,
    const int64_t* t_z, const int64_t* m_len, const int64_t* m_h,
    const int64_t* m_p, const int64_t* m_c, const int64_t* m_a,
    const int64_t* n_elems, const int64_t* n_pairs,
    const uint8_t* relocate) {
    auto* p = new AxisPass();
    p->n_docs = n_docs;
    p->compact_tiers = compact_tiers;
    p->run_off = run_off;
    p->ta = ta; p->tc = tc; p->pa = pa; p->pc = pc;
    p->row = row; p->run_len = run_len; p->head_slot = head_slot;
    p->rank_off = rank_off; p->rank = rank;
    p->crow_off = crow_off; p->row_rank = row_rank; p->row_seq = row_seq;
    p->tier_off = tier_off; p->tier_len = tier_len;
    p->t_s = t_s; p->t_l = t_l; p->t_z = t_z;
    p->m_len = m_len;
    p->m_h = m_h; p->m_p = m_p; p->m_c = m_c; p->m_a = m_a;
    p->n_elems = n_elems; p->n_pairs = n_pairs; p->relocate = relocate;
    int64_t n_tiers = tier_off[n_docs];
    p->tier_data.resize(n_tiers + 1);
    p->tier_data[0] = 0;
    for (int64_t t = 0; t < n_tiers; ++t)
        p->tier_data[t + 1] = p->tier_data[t] + tier_len[t];
    p->mirror_data.resize(n_docs + 1);
    p->mirror_data[0] = 0;
    for (int64_t i = 0; i < n_docs; ++i)
        p->mirror_data[i + 1] = p->mirror_data[i] +
                                (m_len[i] > 0 ? m_len[i] : 0);
    return p;
}

// The index merge of every document. `sizes` gets (new tiers, their
// ranges). Returns AXIS_OK or the first failing status.
int64_t amtpu_axis_merge(void* pv, int64_t* sizes) {
    auto* p = (AxisPass*)pv;
    const int64_t D = p->n_docs;
    const int64_t n_runs = p->run_off[D];
    p->keep.assign(D, 0);
    p->new_off.assign(D + 1, 0);
    p->new_len.clear();
    p->new_data.clear();
    p->o_s.clear(); p->o_l.clear(); p->o_z.clear();
    p->actor.assign(n_runs, 0);
    std::vector<int64_t> order;
    std::vector<int64_t> ks, kl, kz;
    std::vector<RunRef> stack;
    Sink fresh, buf[2];
    auto emit = [p](const RunRef& r) {
        p->new_len.push_back(r.n);
        p->new_data.push_back((int64_t)p->o_s.size());
        p->o_s.insert(p->o_s.end(), r.s, r.s + r.n);
        p->o_l.insert(p->o_l.end(), r.l, r.l + r.n);
        p->o_z.insert(p->o_z.end(), r.z, r.z + r.n);
    };
    for (int64_t i = 0; i < D; ++i) {
        const int64_t r0 = p->run_off[i], r1 = p->run_off[i + 1];
        const int64_t K = r1 - r0;
        const int64_t* rank = p->rank + p->rank_off[i];
        const int64_t n_rank = p->rank_off[i + 1] - p->rank_off[i];
        ks.resize(K); kl.resize(K); kz.resize(K);
        for (int64_t j = 0; j < K; ++j) {
            const int64_t r = r0 + j;
            const int64_t a = p->ta[r], c = p->tc[r];
            if (a < 0 || a >= n_rank || c < 0)
                return p->fail(AXIS_SCOPE, i);
            const int64_t rk = rank[a];
            if (rk < 0 || rk > INT32_MAX) return p->fail(AXIS_SCOPE, i);
            p->actor[r] = rk;
            ks[j] = (rk << 32) | c;
            kl[j] = p->run_len[r];
            kz[j] = p->head_slot[r];
        }
        // sort by start (stable) and check the round's own overlap
        order.resize(K);
        for (int64_t j = 0; j < K; ++j) order[j] = j;
        std::stable_sort(order.begin(), order.end(),
                         [&](int64_t x, int64_t y) { return ks[x] < ks[y]; });
        for (int64_t j = 0; j + 1 < K; ++j)
            if (ks[order[j]] + kl[order[j]] > ks[order[j + 1]])
                return p->fail(AXIS_DUPLICATE, i);
        // against every resident tier
        const int64_t t0 = p->tier_off[i], t1 = p->tier_off[i + 1];
        for (int64_t t = t0; t < t1; ++t) {
            const RunRef res = p->resident(t);
            for (int64_t j = 0; j < K; ++j) {
                const int64_t s = ks[j], e = s + kl[j];
                const int64_t pos = last_le(res.s, res.n, s);
                if (pos >= 0 && s < res.s[pos] + res.l[pos])
                    return p->fail(AXIS_DUPLICATE, i);
                const int64_t lo = pos + 1;
                if (lo < res.n && res.s[lo] < e)
                    return p->fail(AXIS_DUPLICATE, i);
            }
        }
        // the tier stack, then the doubling compaction
        stack.clear();
        for (int64_t t = t0; t < t1; ++t) stack.push_back(p->resident(t));
        int64_t keep = t1 - t0;
        if (K) {
            fresh.clear();
            for (int64_t j = 0; j < K; ++j)
                fresh.push(ks[order[j]], kl[order[j]], kz[order[j]]);
            stack.push_back(fresh.ref());
            int flip = 0;
            while (stack.size() > 1 &&
                   (stack.back().n >= stack[stack.size() - 2].n ||
                    (int64_t)stack.size() > p->compact_tiers)) {
                RunRef b = stack.back();
                stack.pop_back();
                RunRef a = stack.back();
                stack.pop_back();
                merge_into(a, b, buf[flip]);
                stack.push_back(buf[flip].ref());
                flip ^= 1;
            }
            keep = (int64_t)stack.size() - 1;
        }
        if (p->relocate[i]) {
            for (const RunRef& r : stack) emit(r);
            p->keep[i] = 0;
        } else {
            for (size_t k = keep; k < stack.size(); ++k) emit(stack[k]);
            p->keep[i] = keep;
        }
        p->new_off[i + 1] = (int64_t)p->new_len.size();
    }
    sizes[0] = (int64_t)p->new_len.size();
    sizes[1] = (int64_t)p->o_s.size();
    return AXIS_OK;
}

void amtpu_axis_merge_fill(void* pv, int64_t* keep, int64_t* new_off,
                           int64_t* new_len, int64_t* actor, int64_t* s,
                           int64_t* l, int64_t* z) {
    auto* p = (AxisPass*)pv;
    const int64_t D = p->n_docs;
    memcpy(keep, p->keep.data(), D * 8);
    memcpy(new_off, p->new_off.data(), (D + 1) * 8);
    memcpy(new_len, p->new_len.data(), p->new_len.size() * 8);
    memcpy(actor, p->actor.data(), p->actor.size() * 8);
    memcpy(s, p->o_s.data(), p->o_s.size() * 8);
    memcpy(l, p->o_l.data(), p->o_l.size() * 8);
    memcpy(z, p->o_z.data(), p->o_z.size() * 8);
}

// Every run parent through its document's staged index, and the runs'
// descriptor columns. Per run: parent_slot, win_actor, win_seq and
// elem_base; per doc: n_breaks. Returns AXIS_OK or the first failing
// status.
int64_t amtpu_axis_lookup(void* pv, int64_t* parent_slot, int32_t* win_actor,
                          int32_t* win_seq, int64_t* elem_base,
                          int64_t* n_breaks) {
    auto* p = (AxisPass*)pv;
    const int64_t D = p->n_docs;
    p->parent_slot.assign(p->run_off[D], 0);
    std::vector<RunRef> tiers;
    for (int64_t i = 0; i < D; ++i) {
        p->staged(i, tiers);
        const int64_t* rank = p->rank + p->rank_off[i];
        const int64_t n_rank = p->rank_off[i + 1] - p->rank_off[i];
        const int64_t c0 = p->crow_off[i];
        const int64_t n_rows = p->crow_off[i + 1] - c0;
        int64_t breaks = 0, base = 0;
        for (int64_t r = p->run_off[i]; r < p->run_off[i + 1]; ++r) {
            const bool head = p->pa[r] == HEAD_PARENT_ACTOR;
            const int64_t a = head ? 0 : p->pa[r], c = p->pc[r];
            if (a < 0 || a >= n_rank || c < 0)
                return p->fail(AXIS_SCOPE, i);
            const int64_t rk = rank[a];
            if (rk < 0 || rk > INT32_MAX) return p->fail(AXIS_SCOPE, i);
            const int64_t key = (rk << 32) | c;
            int64_t slot = 0;
            bool found = false;
            for (const RunRef& t : tiers) {
                const int64_t pos = last_le(t.s, t.n, key);
                if (pos >= 0 && key < t.s[pos] + t.l[pos]) {
                    slot = t.z[pos] + (key - t.s[pos]);
                    found = true;
                }
            }
            if (!found && !head) return p->fail(AXIS_UNKNOWN, i);
            const int64_t w = p->row[r];
            if (w < 0 || w >= n_rows) return p->fail(AXIS_SCOPE, i);
            p->parent_slot[r] = parent_slot[r] = head ? 0 : slot;
            win_actor[r] = p->row_rank[c0 + w];
            win_seq[r] = p->row_seq[c0 + w];
            elem_base[r] = base;
            base += p->run_len[r];
            breaks += !head;
        }
        n_breaks[i] = breaks;
    }
    return AXIS_OK;
}

// The segment mirror of every document that has one. `sizes[0]` gets the
// new mirrors' total length. Returns AXIS_OK or the first failing status.
int64_t amtpu_axis_mirror(void* pv, int64_t* sizes) {
    auto* p = (AxisPass*)pv;
    const int64_t D = p->n_docs;
    p->mo_len.assign(D, -1);
    p->mo_h.clear(); p->mo_p.clear(); p->mo_c.clear(); p->mo_a.clear();
    std::vector<RunRef> tiers;
    std::vector<int64_t> ins_sorted, cq, cc, ca, qs, qkey, bq;
    std::vector<int64_t> xh, xp, xc, xa;   // the round's heads, sorted
    std::vector<uint8_t> hit;
    for (int64_t i = 0; i < D; ++i) {
        const int64_t m = p->m_len[i];
        if (m < 0) continue;
        const int64_t mo = p->mirror_data[i];
        const int64_t *H = p->m_h + mo, *P = p->m_p + mo, *C = p->m_c + mo,
                      *A = p->m_a + mo;
        const int64_t r0 = p->run_off[i], r1 = p->run_off[i + 1];
        if (!is_sorted64(H, m)) return p->fail(AXIS_MIRROR, i);
        const int64_t n_after = p->n_elems[i] + p->n_pairs[i];
        // chain-break candidates: q = par + 1 neither an old head nor a
        // head minted this round
        ins_sorted.assign(p->head_slot + r0, p->head_slot + r1);
        const bool ins_in_order = is_sorted64(ins_sorted.data(), r1 - r0);
        std::sort(ins_sorted.begin(), ins_sorted.end());
        cq.clear(); cc.clear(); ca.clear();
        for (int64_t r = r0; r < r1; ++r) {
            const int64_t par = p->parent_slot[r], q = par + 1;
            if (!(par >= 1 && q <= n_after)) continue;
            if (std::binary_search(H, H + m, q)) continue;
            if (std::binary_search(ins_sorted.begin(), ins_sorted.end(), q))
                continue;
            cq.push_back(q);
            cc.push_back(p->tc[r]);
            ca.push_back(p->actor[r]);
        }
        bq.clear();
        if (!cq.empty()) {
            // slot -> key through the staged tiers: one scan of their
            // ranges against the sorted distinct queries
            qs = cq;
            std::sort(qs.begin(), qs.end());
            qs.erase(std::unique(qs.begin(), qs.end()), qs.end());
            qkey.assign(qs.size(), 0);
            hit.assign(qs.size(), 0);
            p->staged(i, tiers);
            for (const RunRef& t : tiers)
                for (int64_t k = 0; k < t.n; ++k) {
                    auto it = std::lower_bound(qs.begin(), qs.end(), t.z[k]);
                    for (; it != qs.end() && *it < t.z[k] + t.l[k]; ++it) {
                        const size_t u = it - qs.begin();
                        if (hit[u]) return p->fail(AXIS_MIRROR, i);
                        hit[u] = 1;
                        qkey[u] = t.s[k] + (*it - t.z[k]);
                    }
                }
            for (uint8_t h : hit)
                if (!h) return p->fail(AXIS_MIRROR, i);
            for (size_t k = 0; k < cq.size(); ++k) {
                const size_t u =
                    std::lower_bound(qs.begin(), qs.end(), cq[k]) -
                    qs.begin();
                const int64_t qa = qkey[u] >> 32, qr = qkey[u] & 0xFFFFFFFFLL;
                if (cc[k] > qr || (cc[k] == qr && ca[k] > qa))
                    bq.push_back(cq[k]);
            }
            std::sort(bq.begin(), bq.end());
            bq.erase(std::unique(bq.begin(), bq.end()), bq.end());
        }
        // the round's heads: the run heads, then the breaks (bq - 1 their
        // parent slots, their keys from the same probe), stably by slot
        const int64_t K = r1 - r0;
        const size_t nx = K + bq.size();
        xh.resize(nx); xp.resize(nx); xc.resize(nx); xa.resize(nx);
        for (int64_t j = 0; j < K; ++j) {
            xh[j] = p->head_slot[r0 + j];
            xp[j] = p->parent_slot[r0 + j];
            xc[j] = p->tc[r0 + j];
            xa[j] = p->actor[r0 + j];
        }
        for (size_t k = 0; k < bq.size(); ++k) {
            const size_t u =
                std::lower_bound(qs.begin(), qs.end(), bq[k]) - qs.begin();
            xh[K + k] = bq[k];
            xp[K + k] = bq[k] - 1;
            xc[K + k] = qkey[u] & 0xFFFFFFFFLL;
            xa[K + k] = qkey[u] >> 32;
        }
        std::vector<int64_t> order(nx);
        for (size_t k = 0; k < nx; ++k) order[k] = k;
        if (!ins_in_order || (K && !bq.empty()))
            std::stable_sort(order.begin(), order.end(),
                             [&](int64_t x, int64_t y) {
                                 return xh[x] < xh[y];
                             });
        // merged behind the old heads (sorted, first on a tie): the
        // stable argsort of old ++ runs ++ breaks
        p->mo_len[i] = m + (int64_t)nx;
        size_t a = 0, b = 0;
        while (a < (size_t)m || b < nx) {
            if (b >= nx || (a < (size_t)m && H[a] <= xh[order[b]])) {
                p->mo_h.push_back(H[a]); p->mo_p.push_back(P[a]);
                p->mo_c.push_back(C[a]); p->mo_a.push_back(A[a]);
                ++a;
            } else {
                const int64_t k = order[b++];
                p->mo_h.push_back(xh[k]); p->mo_p.push_back(xp[k]);
                p->mo_c.push_back(xc[k]); p->mo_a.push_back(xa[k]);
            }
        }
    }
    sizes[0] = (int64_t)p->mo_h.size();
    return AXIS_OK;
}

void amtpu_axis_mirror_fill(void* pv, int64_t* mo_len, int64_t* h,
                            int64_t* par, int64_t* c, int64_t* a) {
    auto* p = (AxisPass*)pv;
    memcpy(mo_len, p->mo_len.data(), p->n_docs * 8);
    memcpy(h, p->mo_h.data(), p->mo_h.size() * 8);
    memcpy(par, p->mo_p.data(), p->mo_p.size() * 8);
    memcpy(c, p->mo_c.data(), p->mo_c.size() * 8);
    memcpy(a, p->mo_a.data(), p->mo_a.size() * 8);
}

int64_t amtpu_axis_bad_doc(void* pv) { return ((AxisPass*)pv)->bad_doc; }

void amtpu_axis_free(void* pv) { delete (AxisPass*)pv; }

}  // extern "C"

// ---------------------------------------------------------------------------
// The DocSet read's segment plans over the doc axis (engine/doc_set.py
// `texts()`). For every row: engine/segments.py `SegmentMirror.plan(S,
// n_elems)`, the (4, S) int32 segplan, and the mirror's `head_checksum()`
// and `aux_checksum()`, bit for bit, with int64 and uint32 arithmetic that
// wraps as numpy's does.
//
// `plan` linearizes by pointer doubling (`_linearize_np`). A mirror's tree
// has every head's parent segment before it (its parent slot precedes it),
// and its heads are strictly sorted, so every weight is at least 1; here
// each row is a tree walk instead: each parent's segment by a search from
// the segment before, each segment's children listed in index order (and
// sorted by (attach, ctr, actor) descending where there are two or more),
// then one preorder walk that sums the weights. The order `plan` ranks by is that preorder, the start
// positions its weight sums: O(n) for the mirrors the DocSet grows (a typing
// run's head: its parent segment is the one before). A row the walk cannot
// plan (unsorted heads, a parent outside the tree, weights that do not rise
// along the walk) holds no true mirror: it gets the empty mirror's plan and
// checksums, which the device's segment count from the chain bits refutes
// wherever the row has a segment, so the caller heals the row. A row with
// n_segs + 2 > S, or with columns of unequal length or none, stops the pass
// (SEGPLAN_*), as `plan` raises on it.
// ---------------------------------------------------------------------------

namespace {

enum : int64_t {
    SEGPLAN_OK = 0,
    SEGPLAN_BUCKET = 1,    // n_segs + 2 > S
    SEGPLAN_LENGTHS = 2,   // the row's columns differ in length, or are empty
};

// ops/ingest.py HASH_K1..K4 and mix32_np
constexpr uint32_t HASH_K1 = 2654435761u, HASH_K2 = 2246822519u,
                   HASH_K3 = 3266489917u, HASH_K4 = 668265263u;

static inline uint32_t mix32(uint32_t x) {
    x *= HASH_K1;
    x ^= x >> 15;
    x *= HASH_K2;
    x ^= x >> 13;
    return x;
}

static inline int64_t wadd(int64_t a, int64_t b) {
    return (int64_t)((uint64_t)a + (uint64_t)b);
}
static inline int64_t wsub(int64_t a, int64_t b) {
    return (int64_t)((uint64_t)a - (uint64_t)b);
}
static inline int64_t wneg(int64_t a) { return (int64_t)(0 - (uint64_t)a); }

// the last j with H[j] <= x (-1 if none) in sorted H[0, n), galloping out
// from g: searchsorted(H, x, side="right") - 1
static inline int64_t last_le_from(const int64_t* H, int64_t n, int64_t x,
                                   int64_t g) {
    int64_t lo, hi, step = 1;
    if (H[g] <= x) {
        lo = g;
        while (lo + step < n && H[lo + step] <= x) {
            lo += step;
            step <<= 1;
        }
        hi = std::min(lo + step, n);
    } else {
        hi = g;
        while (hi - step >= 0 && H[hi - step] > x) {
            hi -= step;
            step <<= 1;
        }
        lo = std::max(hi - step, (int64_t)0);
    }
    return (int64_t)(std::upper_bound(H + lo, H + hi, x) - H) - 1;
}

struct SegScratch {
    std::vector<int64_t> pnode, first_child, last_child, next_sib, multi,
        kids;
};

// The tree walk of a mirror of n >= 2 entries, sorted heads H: each
// segment's start position into r_starts, and the position -> segment
// order into r_perm[0, n - 1). False where the row is no such tree (a
// parent below H[0], or a parent segment not before its head) or where the
// weights do not rise along the walk, so that `plan`'s stable argsort of
// the starts need not be the walk.
static bool walk_tree(int64_t n, const int64_t* H, const int64_t* P,
                      const int64_t* C, const int64_t* A, int64_t n_elems,
                      int32_t* r_perm, int32_t* r_starts, SegScratch& t) {
    // each head's parent segment (the one before it, on a typing run),
    // and the children of each segment as a list in index order; the
    // parents with two or more children are listed in t.multi
    t.pnode.resize(n);
    t.first_child.assign(n, -1);
    t.last_child.resize(n);
    t.next_sib.resize(n);
    t.multi.clear();
    t.pnode[0] = 0;
    for (int64_t k = 1; k < n; ++k) {
        const int64_t x = P[k];
        const int64_t p = H[k - 1] <= x && x < H[k]
                              ? k - 1 : last_le_from(H, n, x, k - 1);
        if (p < 0 || p >= k) return false;
        t.pnode[k] = p;
        t.next_sib[k] = -1;
        const int64_t f = t.first_child[p];
        if (f < 0) {
            t.first_child[p] = k;
        } else {
            if (f == t.last_child[p]) t.multi.push_back(p);
            t.next_sib[t.last_child[p]] = k;
        }
        t.last_child[p] = k;
    }
    // siblings by (attach, ctr, actor) descending, then index ascending
    // (lexsort is stable); wrapped negation, as numpy negates
    auto before = [&](int64_t x, int64_t y) {
        const int64_t ax = wneg(wsub(P[x], H[t.pnode[x]]));
        const int64_t ay = wneg(wsub(P[y], H[t.pnode[y]]));
        if (ax != ay) return ax < ay;
        const int64_t cx = wneg(C[x]), cy = wneg(C[y]);
        if (cx != cy) return cx < cy;
        const int64_t rx = wneg(A[x]), ry = wneg(A[y]);
        if (rx != ry) return rx < ry;
        return x < y;
    };
    for (const int64_t p : t.multi) {
        t.kids.clear();
        for (int64_t k = t.first_child[p]; k >= 0; k = t.next_sib[k])
            t.kids.push_back(k);
        std::sort(t.kids.begin(), t.kids.end(), before);
        t.first_child[p] = t.kids[0];
        for (size_t j = 0; j + 1 < t.kids.size(); ++j)
            t.next_sib[t.kids[j]] = t.kids[j + 1];
        t.next_sib[t.kids.back()] = -1;
    }
    // preorder from segment 0: a segment starts where the weights before
    // it end (a segment's weight: the slots to the next head, the last
    // one's to n_elems + 1)
    r_starts[0] = 0;
    int64_t v = 0, m = 0, acc = 0, prev = 0;
    for (;;) {
        int64_t u = t.first_child[v];
        if (u < 0) {
            u = v;
            while (u && t.next_sib[u] < 0) u = t.pnode[u];
            if (!u) return true;
            u = t.next_sib[u];
        }
        v = u;
        if (m && !(prev < acc)) return false;
        prev = acc;
        r_starts[v] = (int32_t)acc;
        r_perm[m++] = (int32_t)v;
        acc = wadd(acc, v < n - 1 ? wsub(H[v + 1], H[v])
                                  : wsub(wadd(n_elems, 1), H[n - 1]));
    }
}

}  // namespace

extern "C" {

// Every row's segplan into plans (n_rows, 4, S) and its (head, aux)
// checksums into checks (n_rows, 2); a row the walk cannot plan gets the
// empty mirror's. `off` (4, n_rows + 1): each column's row offsets into its concatenation
// (heads, par, hctr, hactor). Returns SEGPLAN_OK, or the first failing
// row's status with the row in bad[0].
int64_t amtpu_axis_segplan(int64_t n_rows, int64_t S, const int64_t* off,
                           const int64_t* heads, const int64_t* par,
                           const int64_t* hctr, const int64_t* hactor,
                           const int64_t* n_elems, int32_t* plans,
                           int32_t* checks, int64_t* bad) {
    static const int64_t empty_heads[1] = {0};
    SegScratch t;
    bad[0] = -1;
    for (int64_t i = 0; i < n_rows; ++i) {
        int64_t n = off[i + 1] - off[i];
        if (n < 1) return bad[0] = i, SEGPLAN_LENGTHS;
        for (int c = 1; c < 4; ++c) {
            const int64_t* oc = off + c * (n_rows + 1);
            if (oc[i + 1] - oc[i] != n) return bad[0] = i, SEGPLAN_LENGTHS;
        }
        if (n + 1 > S) return bad[0] = i, SEGPLAN_BUCKET;
        const int64_t* H = heads + off[i];
        const int64_t* P = par + off[(n_rows + 1) + i];
        const int64_t* C = hctr + off[2 * (n_rows + 1) + i];
        const int64_t* A = hactor + off[3 * (n_rows + 1) + i];
        int32_t* r_heads = plans + i * 4 * S;
        int32_t* r_perm = r_heads + S;
        int32_t* r_starts = r_heads + 2 * S;
        int32_t* r_meta = r_heads + 3 * S;
        if (n > 1 && !(is_sorted64(H, n) && walk_tree(n, H, P, C, A,
                                                      n_elems[i], r_perm,
                                                      r_starts, t))) {
            n = 1;
            H = empty_heads;
        }
        const int64_t n_segs = n - 1;
        for (int64_t k = 0; k < n; ++k) r_heads[k] = (int32_t)H[k];
        std::fill(r_heads + n, r_heads + S, 0);
        if (n == 1) r_starts[0] = 0;
        std::fill(r_starts + n, r_starts + S, 0);
        r_perm[n_segs] = 0;
        for (int64_t k = n; k < S; ++k) r_perm[k] = (int32_t)k;
        std::fill(r_meta, r_meta + S, 0);
        r_meta[0] = (int32_t)n_segs;
        // the checksums: wrapping uint32 sums of the mixed heads, and of
        // the mixed (parent, ctr, actor, head) keys
        uint32_t hsum = 0, asum = 0;
        for (int64_t k = 1; k < n; ++k) {
            const uint32_t h = (uint32_t)H[k];
            hsum += mix32(h);
            asum += mix32((uint32_t)P[k] * HASH_K2 + (uint32_t)C[k] * HASH_K3 +
                          (uint32_t)A[k] * HASH_K4 + h);
        }
        checks[2 * i] = (int32_t)hsum;
        checks[2 * i + 1] = (int32_t)asum;
    }
    return SEGPLAN_OK;
}

}  // extern "C"
