// Native bulk text parser — file bytes → columnar batch arrays. The
// port's copy of paddlebox_tpu/native/slot_parser.cpp (the same parse,
// byte for byte: the port may not import the JAX package, so it builds
// this file into its own library beside kv_index.cpp, see
// paddlebox_tpu_torch/native/__init__.py).
//
// Role in the reference: the C++ DataFeed parse path
// (paddle/fluid/framework/data_feed.cc — MultiSlotDataFeed text parsing
// and the dlopen'd ISlotParser fast parsers, data_feed.h:450,1984). The
// reference parses line→SlotRecord objects; here the pipeline is
// columnar end-to-end, so the native parser emits flat arrays the
// ColumnarRecords store adopts directly — no per-record Python objects,
// no per-line interpreter round trip.
//
// Formats:
//   criteo_parse: Criteo display-ads TSV "label \t I1..I13 \t C1..C26"
//     — dense log1p(max(v,0)), missing dense → 0, categorical hex salted
//     with (slot+1)<<52 (matching python CriteoParser bit-for-bit).
//   slot_text_parse: the generic MultiSlotDataFeed wire format
//     "<n> v0..vn-1" per slot in schema order, described by a compact
//     slot-spec array (see slot_text_parse docs below).

#include <cctype>
#include <cerrno>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>

namespace {

inline const char* next_line(const char* p, const char* end) {
  const char* nl = static_cast<const char*>(
      memchr(p, '\n', static_cast<size_t>(end - p)));
  return nl ? nl + 1 : end;
}

// strtof over a [p, q) field with python-float() semantics: surrounding
// whitespace tolerated (python strips it), the remaining token must parse
// COMPLETELY (float("1x") raises), and C99 hex-float forms are rejected
// (float("0x1p1") raises).
inline bool parse_float(const char* p, const char* q, float* out) {
  while (p < q && isspace(static_cast<unsigned char>(*p))) ++p;
  while (q > p && isspace(static_cast<unsigned char>(*(q - 1)))) --q;
  if (p >= q) return false;
  char tmp[64];
  size_t n = static_cast<size_t>(q - p);
  if (n >= sizeof(tmp)) return false;  // longer than any real number
  for (size_t i = 0; i < n; ++i) {
    if (p[i] == 'x' || p[i] == 'X') return false;  // hex-float form
  }
  memcpy(tmp, p, n);
  tmp[n] = 0;
  char* endp = nullptr;
  float v = strtof(tmp, &endp);
  if (endp != tmp + n) return false;
  *out = v;
  return true;
}

// a token must END at whitespace/line end — otherwise strtol("2.5")
// would accept what python's int("2.5") rejects
inline bool at_token_end(const char* c, const char* line_end) {
  return c >= line_end || isspace(static_cast<unsigned char>(*c));
}

// python float() rejects C99 hex-float forms ("0x1p1") that strtof takes
inline bool token_has_hex_marker(const char* c, const char* line_end) {
  for (; c < line_end && !isspace(static_cast<unsigned char>(*c)); ++c) {
    if (*c == 'x' || *c == 'X') return true;
  }
  return false;
}

inline bool parse_hex64(const char* p, const char* q, uint64_t* out) {
  if (p >= q) return false;
  uint64_t v = 0;
  for (const char* c = p; c < q; ++c) {
    int d;
    if (*c >= '0' && *c <= '9') d = *c - '0';
    else if (*c >= 'a' && *c <= 'f') d = *c - 'a' + 10;
    else if (*c >= 'A' && *c <= 'F') d = *c - 'A' + 10;
    else return false;
    v = (v << 4) | static_cast<uint64_t>(d);
  }
  *out = v;
  return true;
}

}  // namespace

extern "C" {

// Criteo TSV → columnar. keys_out [max_rec*26] u64, dense_out
// [max_rec*13] f32, label_out [max_rec] f32. Malformed lines are
// skipped. Returns records parsed (<= max_rec; extra lines ignored).
int64_t criteo_parse(const char* buf, int64_t len, int64_t max_rec,
                     uint64_t* keys_out, float* dense_out,
                     float* label_out) {
  const char* p = buf;
  const char* end = buf + len;
  const uint64_t kShift = 52;
  const uint64_t kMask = (1ull << kShift) - 1ull;
  int64_t n = 0;
  while (p < end && n < max_rec) {
    const char* line_end = static_cast<const char*>(
        memchr(p, '\n', static_cast<size_t>(end - p)));
    if (!line_end) line_end = end;
    // split into 40 tab-separated fields (lines with more tabs → skipped)
    const char* f[41];
    int nf = 0;
    f[0] = p;
    for (const char* c = p; c < line_end && nf < 40; ++c) {
      if (*c == '\t') {
        f[++nf] = c + 1;
      }
    }
    if (nf == 39) {
      const char* fe[40];
      for (int i = 0; i < 39; ++i) fe[i] = f[i + 1] - 1;
      fe[39] = line_end;
      float label;
      if (parse_float(f[0], fe[0], &label)) {
        float* dd = dense_out + n * 13;
        for (int i = 0; i < 13; ++i) {
          float v;
          dd[i] = parse_float(f[1 + i], fe[1 + i], &v)
                      ? log1pf(v > 0.f ? v : 0.f) : 0.f;
        }
        uint64_t* kk = keys_out + n * 26;
        for (int i = 0; i < 26; ++i) {
          uint64_t h;
          if (!parse_hex64(f[14 + i], fe[14 + i], &h)) h = 0xFFFFFFFFull;
          kk[i] = (static_cast<uint64_t>(i + 1) << kShift) | (h & kMask);
        }
        label_out[n] = label;
        ++n;
      }
    }
    p = (line_end < end) ? line_end + 1 : end;
  }
  return n;
}

// Generic MultiSlotDataFeed text: per line, for each slot in schema
// order: "<count> v0 ... v<count-1>". Slot spec per slot (int32 pairs):
//   kind: 0 = uint64 sparse (used), 1 = float dense (used, `dim` vals),
//         2 = label, 3 = show, 4 = clk, 5 = skip (unused slot)
//   dim:  expected value count for kind 1 (others ignore it)
// Outputs (caller-allocated):
//   keys_out [key_cap] u64 + key_slot_out [key_cap] i32 — flat sparse
//   rec_key_offsets [max_rec+1] i64 — per-record key spans
//   dense_out [max_rec * dense_dim] f32, label/show/clk [max_rec] f32
// Returns records parsed; -1 if key_cap overflowed (caller doubles).
int64_t slot_text_parse(const char* buf, int64_t len, const int32_t* spec,
                        int64_t num_slots, int64_t dense_dim,
                        int64_t max_rec, int64_t key_cap,
                        uint64_t* keys_out, int32_t* key_slot_out,
                        int64_t* rec_key_offsets, float* dense_out,
                        float* label_out, float* show_out, float* clk_out) {
  const char* p = buf;
  const char* end = buf + len;
  int64_t n = 0;
  int64_t nkeys = 0;
  rec_key_offsets[0] = 0;
  while (p < end && n < max_rec) {
    const char* line_end = static_cast<const char*>(
        memchr(p, '\n', static_cast<size_t>(end - p)));
    if (!line_end) line_end = end;
    const char* c = p;
    int64_t rec_keys_start = nkeys;
    float* dd = dense_out + n * dense_dim;
    int64_t dpos = 0;
    float label = 0.f, show = 1.f, clk = 0.f;
    bool has_label = false, has_clk = false;
    bool ok = true;
    int32_t sparse_slot_id = 0;
    for (int64_t s = 0; ok && s < num_slots; ++s) {
      int32_t kind = spec[s * 2];
      int32_t dim = spec[s * 2 + 1];
      // read count — guard the line end BEFORE strtol: it would treat
      // '\n' as skippable whitespace and consume the NEXT line's tokens
      while (c < line_end && isspace(static_cast<unsigned char>(*c))) ++c;
      if (c >= line_end) { ok = false; break; }
      char* endp = nullptr;
      long cnt = strtol(c, &endp, 10);
      if (endp == c || cnt < 0 || !at_token_end(endp, line_end)) {
        ok = false;
        break;
      }
      c = endp;
      if (kind == 1 && cnt != dim) { ok = false; break; }
      // group presence sets python's defaults even for empty groups
      // (label/clk = 0.0 when the group exists with zero values)
      if (kind == 2) { has_label = true; label = 0.f; }
      if (kind == 4) { has_clk = true; clk = 0.f; }
      for (long i = 0; ok && i < cnt; ++i) {
        while (c < line_end && isspace(static_cast<unsigned char>(*c))) ++c;
        if (c >= line_end) { ok = false; break; }
        if (kind == 5) {  // unused slot: consume the token unparsed
          while (c < line_end && !isspace(static_cast<unsigned char>(*c)))
            ++c;
        } else if (kind == 0) {
          // negatives wrap and over-range saturates in strtoull, but both
          // overflow python's uint64 cast → DROP the line on both paths
          // ('+5' parses as 5 on both)
          if (*c == '-') { ok = false; break; }
          char* ep = nullptr;
          errno = 0;
          uint64_t v = strtoull(c, &ep, 10);
          if (ep == c || errno == ERANGE
              || !at_token_end(ep, line_end)) { ok = false; break; }
          c = ep;
          if (nkeys >= key_cap) return -1;
          keys_out[nkeys] = v;
          key_slot_out[nkeys] = sparse_slot_id;
          ++nkeys;
        } else {
          if (token_has_hex_marker(c, line_end)) { ok = false; break; }
          char* ep = nullptr;
          float v = strtof(c, &ep);
          if (ep == c || !at_token_end(ep, line_end)) { ok = false; break; }
          c = ep;
          if (kind == 1) {
            if (dpos < dense_dim) dd[dpos++] = v;
          } else if (kind == 2 && i == 0) {
            label = v;
          } else if (kind == 3 && i == 0) {
            show = v;
          } else if (kind == 4 && i == 0) {
            clk = v;
          }
        }
      }
      if (kind == 0) ++sparse_slot_id;
    }
    if (ok) {
      for (int64_t i = dpos; i < dense_dim; ++i) dd[i] = 0.f;
      label_out[n] = label;
      show_out[n] = show;
      clk_out[n] = has_clk ? clk : (has_label ? label : 0.f);
      ++n;
      rec_key_offsets[n] = nkeys;
    } else {
      nkeys = rec_keys_start;  // drop the partial record's keys
    }
    p = (line_end < end) ? line_end + 1 : end;
  }
  return n;
}

}  // extern "C"
