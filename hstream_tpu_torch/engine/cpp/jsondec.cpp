// Native batch decoder: HStreamRecord + google.protobuf.Struct wire
// format -> columnar arrays, one pass over a whole appended batch.
//
// The server's per-record JSON ingest path (proto parse + Struct->dict
// in Python) costs ~8us/record; at changelog rates that IS the query
// loop. This decoder walks the protobuf wire format directly (the
// field layout of proto/api.proto:87-97 and the well-known Struct) and
// emits dense typed columns + per-column null masks + a string
// dictionary, which feed the executor's staged columnar path with no
// per-record Python at all. SURVEY §7: "protobuf decode + key
// dictionary off the critical path (C++ ingest, columnar staging)".
//
// The reference's analogue is its native store client decode
// (hstream-store cbits reader path); its JSON values ride protobuf
// Structs exactly like ours (HStreamApi.proto HStreamRecord).
//
// Per-record classification (out_class):
//   0 = flat JSON decoded into columns
//   1 = RAW-flagged record (columnar producer batches etc — Python
//       routes by payload magic)
//   2 = needs the Python fallback (nested struct/list values, type
//       conflict with an established column, malformed bytes)
//
// Build: common/nativebuild.py (g++ -O3, no deps).

#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Reader {
    const uint8_t *p;
    const uint8_t *end;
    bool ok = true;

    bool more() const { return ok && p < end; }

    uint64_t varint() {
        uint64_t v = 0;
        int shift = 0;
        while (p < end && shift < 64) {
            uint8_t b = *p++;
            v |= (uint64_t)(b & 0x7f) << shift;
            if (!(b & 0x80)) return v;
            shift += 7;
        }
        ok = false;
        return 0;
    }

    // length-delimited span; returns false on overrun
    bool span(const uint8_t **s, int64_t *len) {
        uint64_t l = varint();
        if (!ok || (uint64_t)(end - p) < l) { ok = false; return false; }
        *s = p;
        *len = (int64_t)l;
        p += l;
        return true;
    }

    bool skip(uint32_t wire) {
        switch (wire) {
            case 0: varint(); return ok;
            case 1:
                if (end - p < 8) { ok = false; return false; }
                p += 8;
                return true;
            case 2: {
                const uint8_t *s; int64_t l;
                return span(&s, &l);
            }
            case 5:
                if (end - p < 4) { ok = false; return false; }
                p += 4;
                return true;
            default: ok = false; return false;
        }
    }
};

enum ColType { T_NUM = 0, T_STR = 1, T_BOOL = 2 };

struct Col {
    int type = -1;
    std::vector<double> nums;
    std::vector<int32_t> sids;
    std::vector<uint8_t> bools;
    std::vector<uint8_t> nulls;  // 1 = null / missing
    std::unordered_map<std::string, int32_t> dict;
    std::vector<std::string> dict_list;
    int64_t dict_bytes = 0;
};

struct Scan {
    int64_t n = 0;
    std::vector<std::string> names;  // insertion order
    std::unordered_map<std::string, int> index;
    std::vector<Col> cols;

    Col &get(const std::string &name) {
        auto it = index.find(name);
        if (it != index.end()) return cols[it->second];
        index.emplace(name, (int)cols.size());
        names.push_back(name);
        cols.emplace_back();
        Col &c = cols.back();
        c.nums.assign(n, 0.0);
        c.sids.assign(n, 0);
        c.bools.assign(n, 0);
        c.nulls.assign(n, 1);  // rows before discovery are missing
        return c;
    }
};

// one decoded field of the record being scanned (commit only when the
// whole record parses flat — a rejected record must not half-write)
struct FieldVal {
    std::string name;
    int type;     // ColType, or -1 for explicit null
    double num = 0.0;
    uint8_t b = 0;
    std::string str;
};

// Value message: returns false -> record needs Python fallback
static bool parse_value(const uint8_t *s, int64_t len, FieldVal *fv) {
    Reader r{s, s + len};
    fv->type = -1;  // empty Value == null (WhichOneof None)
    while (r.more()) {
        uint64_t tag = r.varint();
        if (!r.ok) return false;
        uint32_t field = (uint32_t)(tag >> 3), wire = (uint32_t)(tag & 7);
        if (field == 1 && wire == 0) {          // null_value
            r.varint();
            fv->type = -1;
        } else if (field == 2 && wire == 1) {   // number_value
            if (r.end - r.p < 8) return false;
            double d;
            std::memcpy(&d, r.p, 8);
            r.p += 8;
            fv->type = T_NUM;
            fv->num = d;
        } else if (field == 3 && wire == 2) {   // string_value
            const uint8_t *vs; int64_t vl;
            if (!r.span(&vs, &vl)) return false;
            fv->type = T_STR;
            fv->str.assign((const char *)vs, (size_t)vl);
        } else if (field == 4 && wire == 0) {   // bool_value
            uint64_t v = r.varint();
            if (!r.ok) return false;
            fv->type = T_BOOL;
            fv->b = v ? 1 : 0;
        } else if (field == 5 || field == 6) {  // struct_value / list_value
            return false;  // nested -> Python fallback
        } else {
            if (!r.skip(wire)) return false;
        }
    }
    return r.ok;
}

}  // namespace

extern "C" {

// Scan n records (record i = buf[offs[i]..offs[i+1])). out_ts[i] =
// publish_time_ms or default_ts[i] when unset. Returns an opaque Scan*.
void *jd_scan(const uint8_t *buf, const int64_t *offs, int64_t n,
              const int64_t *default_ts, int64_t *out_ts,
              uint8_t *out_class) {
    Scan *sc = new Scan();
    sc->n = n;
    std::vector<FieldVal> scratch;
    for (int64_t i = 0; i < n; ++i) {
        out_ts[i] = default_ts[i];
        out_class[i] = 2;
        Reader r{buf + offs[i], buf + offs[i + 1]};
        uint64_t flag = 0;
        int64_t publish = 0;
        const uint8_t *payload = nullptr;
        int64_t paylen = -1;
        bool bad = false;
        while (r.more()) {
            uint64_t tag = r.varint();
            if (!r.ok) { bad = true; break; }
            uint32_t field = (uint32_t)(tag >> 3),
                     wire = (uint32_t)(tag & 7);
            if (field == 1 && wire == 2) {        // header
                const uint8_t *hs; int64_t hl;
                if (!r.span(&hs, &hl)) { bad = true; break; }
                Reader h{hs, hs + hl};
                while (h.more()) {
                    uint64_t htag = h.varint();
                    if (!h.ok) { bad = true; break; }
                    uint32_t hf = (uint32_t)(htag >> 3),
                             hw = (uint32_t)(htag & 7);
                    if (hf == 1 && hw == 0) flag = h.varint();
                    else if (hf == 3 && hw == 0)
                        publish = (int64_t)h.varint();
                    else if (!h.skip(hw)) { bad = true; break; }
                }
                if (!h.ok) bad = true;
            } else if (field == 2 && wire == 2) { // payload
                if (!r.span(&payload, &paylen)) { bad = true; break; }
            } else if (!r.skip(wire)) { bad = true; break; }
        }
        if (bad || !r.ok) continue;  // class 2: Python reproduces the
                                     // old path's error behavior
        if (publish > 0) out_ts[i] = publish;
        if (flag != 0) { out_class[i] = 1; continue; }  // RAW
        // JSON payload: Struct { map<string, Value> fields = 1 }
        scratch.clear();
        bool flat = true;
        if (paylen >= 0) {
            Reader s{payload, payload + paylen};
            while (s.more()) {
                uint64_t tag = s.varint();
                if (!s.ok) { flat = false; break; }
                uint32_t field = (uint32_t)(tag >> 3),
                         wire = (uint32_t)(tag & 7);
                if (field == 1 && wire == 2) {
                    const uint8_t *es; int64_t el;
                    if (!s.span(&es, &el)) { flat = false; break; }
                    Reader e{es, es + el};
                    FieldVal fv;
                    bool have_key = false, have_val = false;
                    fv.type = -1;
                    while (e.more()) {
                        uint64_t etag = e.varint();
                        if (!e.ok) { flat = false; break; }
                        uint32_t ef = (uint32_t)(etag >> 3),
                                 ew = (uint32_t)(etag & 7);
                        if (ef == 1 && ew == 2) {
                            const uint8_t *ks; int64_t kl;
                            if (!e.span(&ks, &kl)) { flat = false; break; }
                            if (kl > 255) { flat = false; break; }
                            // (>255-byte field names -> Python fallback
                            // so jd_col_meta's fixed buffer never
                            // silently merges distinct columns)
                            fv.name.assign((const char *)ks, (size_t)kl);
                            have_key = true;
                        } else if (ef == 2 && ew == 2) {
                            const uint8_t *vs; int64_t vl;
                            if (!e.span(&vs, &vl)) { flat = false; break; }
                            if (!parse_value(vs, vl, &fv)) {
                                flat = false;
                                break;
                            }
                            have_val = true;
                        } else if (!e.skip(ew)) { flat = false; break; }
                    }
                    if (!flat || !e.ok) { flat = false; break; }
                    if (have_key) {
                        (void)have_val;  // missing Value == null
                        scratch.push_back(std::move(fv));
                    }
                } else if (!s.skip(wire)) { flat = false; break; }
            }
            if (!s.ok) flat = false;
        }
        if (!flat) continue;  // class 2
        // type-compat check against established columns BEFORE commit
        for (const FieldVal &fv : scratch) {
            if (fv.type < 0) continue;
            auto it = sc->index.find(fv.name);
            if (it != sc->index.end()) {
                int t = sc->cols[it->second].type;
                if (t != -1 && t != fv.type) { flat = false; break; }
            }
        }
        // duplicate keys with conflicting types inside ONE record
        for (size_t a = 0; flat && a + 1 < scratch.size(); ++a)
            for (size_t b = a + 1; b < scratch.size(); ++b)
                if (scratch[a].type >= 0 && scratch[b].type >= 0 &&
                    scratch[a].type != scratch[b].type &&
                    scratch[a].name == scratch[b].name) {
                    flat = false;
                    break;
                }
        if (!flat) continue;  // class 2 (conflicting value type)
        for (FieldVal &fv : scratch) {
            Col &c = sc->get(fv.name);
            if (fv.type < 0) {           // explicit null
                c.nulls[i] = 1;
                continue;
            }
            if (c.type == -1) c.type = fv.type;
            c.nulls[i] = 0;
            if (fv.type == T_NUM) {
                c.nums[i] = fv.num;
            } else if (fv.type == T_BOOL) {
                c.bools[i] = fv.b;
            } else {
                auto di = c.dict.find(fv.str);
                int32_t sid;
                if (di == c.dict.end()) {
                    sid = (int32_t)c.dict_list.size();
                    c.dict.emplace(fv.str, sid);
                    c.dict_bytes += (int64_t)fv.str.size();
                    c.dict_list.push_back(std::move(fv.str));
                } else {
                    sid = di->second;
                }
                c.sids[i] = sid;
            }
        }
        out_class[i] = 0;
    }
    return sc;
}

int64_t jd_ncols(void *h) { return (int64_t)((Scan *)h)->cols.size(); }

// name (<=255 bytes; *name_len_out gives the exact byte length so NUL
// bytes inside names survive), type (ColType; -1 = all-null column),
// dict entry count + total dict bytes (string columns)
void jd_col_meta(void *h, int64_t i, char *name_out,
                 int32_t *name_len_out, int32_t *type_out,
                 int32_t *ndict_out, int64_t *dict_bytes_out) {
    Scan *sc = (Scan *)h;
    const std::string &nm = sc->names[i];
    size_t l = nm.size() < 255 ? nm.size() : 255;
    std::memcpy(name_out, nm.data(), l);
    *name_len_out = (int32_t)l;
    Col &c = sc->cols[i];
    *type_out = c.type;
    *ndict_out = (int32_t)c.dict_list.size();
    *dict_bytes_out = c.dict_bytes;
}

// copy column i's data; pass the buffer matching its type (others may
// be null). nulls is always filled.
void jd_col_data(void *h, int64_t i, double *nums, int32_t *sids,
                 uint8_t *bools, uint8_t *nulls) {
    Scan *sc = (Scan *)h;
    Col &c = sc->cols[i];
    if (nums) std::memcpy(nums, c.nums.data(), sc->n * sizeof(double));
    if (sids) std::memcpy(sids, c.sids.data(), sc->n * sizeof(int32_t));
    if (bools) std::memcpy(bools, c.bools.data(), sc->n);
    std::memcpy(nulls, c.nulls.data(), sc->n);
}

// string dictionary as concatenated bytes + per-entry lengths
void jd_dict_data(void *h, int64_t i, uint8_t *concat, int32_t *lens) {
    Col &c = ((Scan *)h)->cols[i];
    uint8_t *w = concat;
    for (size_t j = 0; j < c.dict_list.size(); ++j) {
        const std::string &s = c.dict_list[j];
        std::memcpy(w, s.data(), s.size());
        w += s.size();
        lens[j] = (int32_t)s.size();
    }
}

void jd_free(void *h) { delete (Scan *)h; }

}  // extern "C"
