// Native CSV chunk scanner.
//
// Single-pass byte-level state machine with the same semantics as the
// Python specification in csvplus_tpu_torch/csvio.py (which mirrors the
// reference's use of Go encoding/csv, csvplus.go:1091-1097):
//   - records end at '\n' or "\r\n"; quoted fields may span lines;
//   - blank lines and comment-prefixed lines are skipped at record start;
//   - RFC-4180 quoting with "" doubling; without lazy_quotes a bare '"'
//     in an unquoted field or a stray '"' in a quoted field is an error;
//   - a trailing delimiter yields an empty last field.
//
// Output is COLUMNAR-friendly: no per-record allocations, just flat
// arrays of field (start, length) into the input buffer.  Fields that
// need transformation (escaped quotes, normalized line breaks inside
// quotes) are materialized into a caller-provided scratch buffer and
// flagged with a negative start: start = -(scratch_offset + 1).
//
// Returns the total number of fields parsed, or a negative error code
// with *err_record set to the 1-based record ordinal.

#include <cstdint>
#include <cstring>

extern "C" {

enum {
  CSV_ERR_BARE_QUOTE = -1,  // bare " in non-quoted field
  CSV_ERR_QUOTE = -2,       // extraneous or missing " in quoted-field
  CSV_ERR_OVERFLOW = -3,    // caller's arrays too small (should not happen)
};

int64_t csv_scan(const char* buf, int64_t len, char delim, char comment,
                 int has_comment, int lazy_quotes, int trim_space,
                 int64_t* field_starts, int32_t* field_lens,
                 int32_t* rec_counts, char* scratch, int64_t scratch_cap,
                 int64_t* scratch_used, int64_t max_fields,
                 int64_t max_records, int64_t* err_record) {
  int64_t pos = 0;
  int64_t nfields = 0;
  int64_t nrecords = 0;
  int64_t scr = 0;

  while (pos < len) {
    // ---- record start: skip blank lines and comment lines ----
    if (buf[pos] == '\n') { pos += 1; continue; }
    if (buf[pos] == '\r' && pos + 1 < len && buf[pos + 1] == '\n') {
      pos += 2; continue;
    }
    if (has_comment && buf[pos] == comment) {
      while (pos < len && buf[pos] != '\n') pos++;
      if (pos < len) pos++;  // consume '\n'
      continue;
    }

    if (nrecords >= max_records) { *err_record = nrecords; return CSV_ERR_OVERFLOW; }
    int32_t fields_in_rec = 0;
    bool record_done = false;

    while (!record_done) {
      // ---- one field ----
      if (nfields >= max_fields) { *err_record = nrecords + 1; return CSV_ERR_OVERFLOW; }
      if (trim_space) {
        while (pos < len && (buf[pos] == ' ' || buf[pos] == '\t')) pos++;
      }

      if (pos < len && buf[pos] == '"') {
        // ---- quoted field ----
        pos++;
        int64_t seg_start = pos;   // current contiguous segment
        bool needs_scratch = false;
        int64_t scr_start = scr;   // scratch offset if transformed
        int64_t plain_start = pos; // zero-copy range when !needs_scratch
        int64_t plain_len = 0;

        auto flush_segment = [&](int64_t upto) {
          // append [seg_start, upto) to scratch
          int64_t n = upto - seg_start;
          if (n > 0) {
            if (scr + n > scratch_cap) n = scratch_cap - scr;  // defensive
            std::memcpy(scratch + scr, buf + seg_start, n);
            scr += n;
          }
        };
        auto to_scratch_mode = [&](int64_t upto) {
          if (!needs_scratch) {
            needs_scratch = true;
            scr_start = scr;
            seg_start = plain_start;
            flush_segment(upto);
            seg_start = upto;
          }
        };

        for (;;) {
          if (pos >= len) {
            // EOF inside quotes
            if (!lazy_quotes) { *err_record = nrecords + 1; return CSV_ERR_QUOTE; }
            // the Python spec strips each line's terminator before
            // scanning, so a terminator right at EOF is not field data
            int64_t end = pos;
            if (end > seg_start && buf[end - 1] == '\n') {
              end--;
              if (end > seg_start && buf[end - 1] == '\r') end--;
            }
            if (needs_scratch) {
              flush_segment(end);
              field_starts[nfields] = -(scr_start + 1);
              field_lens[nfields] = (int32_t)(scr - scr_start);
            } else {
              field_starts[nfields] = plain_start;
              field_lens[nfields] = (int32_t)(end - plain_start);
            }
            nfields++; fields_in_rec++;
            record_done = true;
            break;
          }
          char c = buf[pos];
          if (c == '"') {
            if (pos + 1 < len && buf[pos + 1] == '"') {
              // doubled quote -> literal "
              to_scratch_mode(pos);
              flush_segment(pos);  // seg_start..pos (content before quote)
              if (scr < scratch_cap) scratch[scr++] = '"';
              pos += 2;
              seg_start = pos;
              continue;
            }
            // closing quote
            int64_t content_end = pos;
            pos++;
            // NOTE: a lone '\r' at EOF is NOT a terminator (the Python
            // spec only strips "\r\n" pairs), so '"..."\r<EOF>' is a
            // stray-quote situation, matching csvio.py.
            bool at_delim = pos < len && buf[pos] == delim;
            bool at_lf = pos < len && buf[pos] == '\n';
            bool at_crlf = pos + 1 < len && buf[pos] == '\r' && buf[pos + 1] == '\n';
            bool at_eof = pos >= len;
            if (at_delim || at_lf || at_crlf || at_eof) {
              if (needs_scratch) {
                flush_segment(content_end);
                field_starts[nfields] = -(scr_start + 1);
                field_lens[nfields] = (int32_t)(scr - scr_start);
              } else {
                field_starts[nfields] = plain_start;
                field_lens[nfields] = (int32_t)(content_end - plain_start);
              }
              nfields++; fields_in_rec++;
              if (at_delim) { pos++; break; }            // next field
              if (at_lf) { pos++; record_done = true; break; }
              if (at_crlf) { pos += 2; record_done = true; break; }
              record_done = true; break;                 // EOF
            }
            if (lazy_quotes) {
              // stray quote kept literally, stay inside quotes
              to_scratch_mode(content_end);
              flush_segment(content_end);
              if (scr < scratch_cap) scratch[scr++] = '"';
              seg_start = pos;
              continue;
            }
            *err_record = nrecords + 1;
            return CSV_ERR_QUOTE;
          }
          if (c == '\r' && pos + 1 < len && buf[pos + 1] == '\n') {
            if (pos + 2 >= len) {
              // CRLF directly at EOF is a record terminator, not field
              // data (csvio.py strips each line's terminator before
              // scanning) — defer to the EOF-inside-quotes handler,
              // which strips it from the segment
              pos += 2;
              continue;
            }
            // line break inside quotes normalizes to '\n'
            to_scratch_mode(pos);
            flush_segment(pos);
            if (scr < scratch_cap) scratch[scr++] = '\n';
            pos += 2;
            seg_start = pos;
            continue;
          }
          pos++;
        }
      } else {
        // ---- unquoted field ----
        int64_t start = pos;
        while (pos < len && buf[pos] != delim && buf[pos] != '\n') {
          if (buf[pos] == '"' && !lazy_quotes) {
            *err_record = nrecords + 1;
            return CSV_ERR_BARE_QUOTE;
          }
          pos++;
        }
        int64_t end = pos;
        // strip the '\r' of a "\r\n" terminator only — a lone trailing
        // '\r' at EOF is field data (csvio._strip_eol semantics)
        bool at_nl = pos < len && buf[pos] == '\n';
        if (at_nl && end > start && buf[end - 1] == '\r') end--;
        field_starts[nfields] = start;
        field_lens[nfields] = (int32_t)(end - start);
        nfields++; fields_in_rec++;
        if (pos < len && buf[pos] == delim) { pos++; continue; }  // next field
        if (pos < len) pos++;  // consume '\n'
        record_done = true;
      }
    }

    rec_counts[nrecords++] = fields_in_rec;
  }

  *scratch_used = scr;
  *err_record = nrecords;
  return nfields;
}

// how many records were produced before an error / at success is carried
// via err_record; a second entry point reports the record count for
// convenience when pre-sizing is needed.  flags_out also reports byte
// presence in the same single pass (bit0 quote, bit1 CR, bit2 comment
// char) so the simple-scan gate needs no extra full-buffer scans.
int64_t csv_count_bounds(const char* buf, int64_t len, char delim,
                         char comment, int64_t* max_fields_out,
                         int64_t* max_records_out, int64_t* flags_out) {
  int64_t d = 0, nl = 0;
  int64_t flags = 0;
  for (int64_t i = 0; i < len; i++) {
    const char c = buf[i];
    if (c == delim) d++;
    else if (c == '\n') nl++;
    else if (c == '"') flags |= 1;
    else if (c == '\r') flags |= 2;
    if (c == comment) flags |= 4;
  }
  *max_fields_out = d + nl + 2;
  *max_records_out = nl + 2;
  *flags_out = flags;
  return 0;
}

// Gather n (start, len) fields into NUL-padded fixed-width rows of
// `width` bytes — the dictionary-encode pre-pass.  Replaces a numpy
// index-matrix gather that allocated an (n, width) int64 index array;
// here it is one memcpy+memset per field.  Caller guarantees
// lens[i] <= width and starts[i] + lens[i] <= buffer length.
void csv_pack_fields(const char* buf, const int64_t* starts,
                     const int32_t* lens, int64_t n, int32_t width,
                     char* out) {
  for (int64_t i = 0; i < n; ++i) {
    char* dst = out + i * (int64_t)width;
    int32_t l = lens[i];
    memcpy(dst, buf + starts[i], (size_t)l);
    memset(dst + l, 0, (size_t)(width - l));
  }
}

// Same gather for fields of <= 8 bytes, packed big-endian (first byte
// most significant, NUL padding in the low bytes) straight into native
// uint64 values: integer order == byte order, and np.unique on a
// native scalar dtype is the fastest encode sort available.
void csv_pack_fields_u64(const char* buf, const int64_t* starts,
                         const int32_t* lens, int64_t n, uint64_t* out) {
  for (int64_t i = 0; i < n; ++i) {
    uint64_t v = 0;
    memcpy(&v, buf + starts[i], (size_t)lens[i]);
    out[i] = __builtin_bswap64(v);
  }
}

// Typed value lanes: parse n (start, len) fields as `prefix + canonical
// int32 suffix` — the affix form covering pure integers (empty prefix,
// sign allowed) and prefixed ids ("o123", "c45").  Canonical means the
// suffix round-trips bitwise through int->decimal formatting: "0" or
// [1-9][0-9]*, value <= INT32_MAX (negatives only with an empty prefix,
// no "-0", value >= -INT32_MAX so |v| always formats).  On the first
// call *prefix_len is -1 and the prefix derives from field 0 (longest
// canonical suffix; leading zeros join the prefix); later calls verify
// the caller's prefix.  Returns 1 when every field conforms (out[] is
// filled), 0 otherwise — a failed chunk costs one pass and the column
// falls back to dictionary encoding.
static inline int parse_canon_i32(const char* p, int32_t l, int allow_sign,
                                  int32_t* out) {
  if (l <= 0) return 0;
  int neg = 0;
  if (allow_sign && p[0] == '-') {
    neg = 1;
    p++;
    l--;
    if (l <= 0 || p[0] == '0') return 0;  // "-" / "-0" / "-0..." invalid
  }
  if (l > 10) return 0;
  if (l > 1 && p[0] == '0') return 0;  // leading zero
  int64_t v = 0;
  for (int32_t i = 0; i < l; ++i) {
    const char c = p[i];
    if (c < '0' || c > '9') return 0;
    v = v * 10 + (c - '0');
  }
  if (v > 2147483647) return 0;  // also rejects INT32_MIN via |v| bound
  *out = neg ? (int32_t)-v : (int32_t)v;
  return 1;
}

// ONE pack core shared by the contiguous and strided entry points
// (field i of the parse is flat field off + i*stride).
static int64_t pack_i32_core(const char* buf, const int64_t* starts,
                             const int32_t* lens, int64_t n, int64_t stride,
                             int64_t off, char* prefix_buf,
                             int64_t* prefix_len, int64_t prefix_cap,
                             int32_t* out) {
  if (n == 0) return 1;
  if (*prefix_len < 0) {
    // derive from the first field: whole-cell signed canonical -> empty
    // prefix; else prefix = cell minus its longest canonical suffix
    const char* f0 = buf + starts[off];
    const int32_t l0 = lens[off];
    if (parse_canon_i32(f0, l0, 1, out)) {
      *prefix_len = 0;
    } else {
      int32_t d0 = l0;  // start of the trailing digit run
      while (d0 > 0 && f0[d0 - 1] >= '0' && f0[d0 - 1] <= '9') d0--;
      int32_t s = d0;
      // shrink until the suffix is canonical AND fits int32
      while (s < l0 && !parse_canon_i32(f0 + s, l0 - s, 0, out)) s++;
      if (s >= l0) return 0;  // no usable numeric suffix
      if (s > prefix_cap) return 0;
      memcpy(prefix_buf, f0, (size_t)s);
      *prefix_len = s;
    }
  }
  const int64_t plen = *prefix_len;
  const int allow_sign = plen == 0;
  for (int64_t i = 0; i < n; ++i) {
    const int64_t fi = off + i * stride;
    const char* f = buf + starts[fi];
    const int32_t l = lens[fi];
    if (l < plen || (plen && memcmp(f, prefix_buf, (size_t)plen) != 0))
      return 0;
    if (!parse_canon_i32(f + plen, l - (int32_t)plen, allow_sign, &out[i]))
      return 0;
  }
  return 1;
}

int64_t csv_pack_int32(const char* buf, const int64_t* starts,
                       const int32_t* lens, int64_t n, char* prefix_buf,
                       int64_t* prefix_len, int64_t prefix_cap,
                       int32_t* out) {
  return pack_i32_core(buf, starts, lens, n, 1, 0, prefix_buf, prefix_len,
                       prefix_cap, out);
}

// Strided variant for RECTANGULAR chunks: column `off` of record i sits
// at flat field index off + i*stride, so the per-column position-array
// gather (and its Python-side construction) disappears entirely — the
// single-core ingest profile's second-largest cost after the scan.
int64_t csv_pack_int32_strided(const char* buf, const int64_t* starts,
                               const int32_t* lens, int64_t n_records,
                               int64_t stride, int64_t off,
                               char* prefix_buf, int64_t* prefix_len,
                               int64_t prefix_cap, int32_t* out) {
  return pack_i32_core(buf, starts, lens, n_records, stride, off,
                       prefix_buf, prefix_len, prefix_cap, out);
}

// FUSED tokenize + typed parse for fully-typed rectangular chunks: one
// pass over the bytes, emitting int32 affix values per selected column
// and NOTHING else — no (start, len) offset arrays at all.  At 100M
// rows the two-pass path writes ~4.8GB of field offsets that the typed
// parse then re-reads; this replaces both with a single streaming pass.
//
// Contract (caller pre-checks): no quote/CR/comment bytes in the chunk,
// every selected column already in typed mode with an ESTABLISHED
// prefix, records end at '\n' (a final record may end at EOF), blank
// lines skip at record start.  `outs[c]` is the output array for field
// c, or NULL for unselected fields (skipped without typed constraints).
// Returns the record count on success, 0 to bail (any non-conforming
// cell, field-count mismatch, overflow past max_records) — the caller
// then reruns the chunk through the generic scan, which also owns the
// exact row-numbered error reporting.
int64_t csv_scan_parse_i32(const char* buf, int64_t len, char delim,
                           int64_t ncols, const char* prefix_blob,
                           const int64_t* prefix_off,
                           const int64_t* prefix_len, int32_t** outs,
                           int64_t max_records) {
  int64_t pos = 0;
  int64_t nrec = 0;
  while (pos < len) {
    if (buf[pos] == '\n') { pos++; continue; }  // blank line at record start
    if (nrec >= max_records) return 0;
    for (int64_t c = 0; c < ncols; ++c) {
      const char term = (c == ncols - 1) ? '\n' : delim;
      if (outs[c] == nullptr) {
        // unselected field: raw skip to terminator
        while (pos < len && buf[pos] != delim && buf[pos] != '\n') pos++;
      } else {
        const int64_t plen = prefix_len[c];
        const char* pfx = prefix_blob + prefix_off[c];
        if (pos + plen > len || memcmp(buf + pos, pfx, (size_t)plen) != 0)
          return 0;
        pos += plen;
        int neg = 0;
        if (plen == 0 && pos < len && buf[pos] == '-') { neg = 1; pos++; }
        if (pos >= len || buf[pos] < '0' || buf[pos] > '9') return 0;
        if (buf[pos] == '0') {
          // canonical: "0" must be the whole suffix
          outs[c][nrec] = 0;
          pos++;
          if (neg) return 0;  // "-0" never stored
          if (pos < len && buf[pos] >= '0' && buf[pos] <= '9') return 0;
        } else {
          int64_t v = 0;
          int digits = 0;
          while (pos < len && buf[pos] >= '0' && buf[pos] <= '9') {
            v = v * 10 + (buf[pos] - '0');
            if (++digits > 10) return 0;
            pos++;
          }
          if (v > 2147483647) return 0;
          outs[c][nrec] = neg ? (int32_t)-v : (int32_t)v;
        }
      }
      // terminator
      if (pos >= len) {
        // EOF terminates the LAST field of a record only
        if (c != ncols - 1) return 0;
      } else if (buf[pos] == term) {
        pos++;
      } else {
        return 0;  // wrong arity / stray byte
      }
    }
    nrec++;
  }
  return nrec;
}

// Format n int32 values as decimal into a fixed-width (n, width) byte
// matrix, NUL-padded — the typed column's demote/materialize pre-pass
// (the inverse of csv_pack_int32's parse).  Caller guarantees width >=
// 11 (sign + 10 digits).  lens_out gets each value's decimal length.
void csv_format_i32(const int32_t* values, int64_t n, int32_t width,
                    char* out, int32_t* lens_out) {
  for (int64_t i = 0; i < n; ++i) {
    char tmp[12];
    int32_t v = values[i];
    int p = 12;
    uint32_t a = v < 0 ? (uint32_t)(-(int64_t)v) : (uint32_t)v;
    do {
      tmp[--p] = (char)('0' + a % 10);
      a /= 10;
    } while (a);
    if (v < 0) tmp[--p] = '-';
    const int32_t l = 12 - p;
    char* dst = out + i * (int64_t)width;
    memcpy(dst, tmp + p, (size_t)l);
    memset(dst + l, 0, (size_t)(width - l));
    lens_out[i] = l;
  }
}

// CSV body assembly: scatter one column's escaped dictionary entries
// into a pre-sized row-major output buffer, appending `sep` after each
// field (',' mid-row, '\n' for the last column).  The caller computes
// per-row byte starts vectorized (dictionary entry lengths gathered by
// code + exclusive scan across columns); this loop is one memcpy per
// cell with zero Python objects.
void csv_scatter_fields(const char* blob, const int64_t* dict_off,
                        const int32_t* dict_len, const int32_t* codes,
                        const int64_t* starts, int64_t n, char sep,
                        char* out) {
  for (int64_t i = 0; i < n; ++i) {
    const int32_t c = codes[i];
    const int32_t l = dict_len[c];
    memcpy(out + starts[i], blob + dict_off[c], (size_t)l);
    out[starts[i] + l] = sep;
  }
}

// Unpack k big-endian-packed u64 dictionary values into NUL-padded
// fixed-width byte rows (the 'S{width}' dictionary array) — replaces a
// numpy (k, width) shift-and-mask broadcast that dominated the encode
// of high-cardinality columns.
void csv_u64_to_bytes(const uint64_t* uniq, int64_t k, int32_t width,
                      char* out) {
  for (int64_t i = 0; i < k; ++i) {
    const uint64_t be = __builtin_bswap64(uniq[i]);  // memory order = byte order
    memcpy(out + i * (int64_t)width, &be, (size_t)width);
  }
}

// Branchless-ish SWAR tokenizer for SIMPLE chunks: no quote bytes, no
// CR, no comment lines (caller prechecks with memchr).  Only field
// boundaries exist, so each record is delimiter-split text ending at
// '\n'; blank lines are skipped at record start like the full state
// machine.  Emits the same (starts, lens, counts) layout as csv_scan
// with nothing in scratch.  Returns total fields.
int64_t csv_scan_simple(const char* buf, int64_t len, char delim,
                        int64_t* field_starts, int32_t* field_lens,
                        int32_t* rec_counts, int64_t* nrec_out) {
  constexpr uint64_t kOnes = 0x0101010101010101ull;
  constexpr uint64_t kHighs = 0x8080808080808080ull;
  const uint64_t dmask = kOnes * (uint8_t)delim;
  const uint64_t nmask = kOnes * (uint8_t)'\n';
  int64_t nfields = 0;
  int64_t nrec = 0;
  int64_t pos = 0;
  while (pos < len) {
    if (buf[pos] == '\n') {  // blank line at record start: skip
      pos++;
      continue;
    }
    int32_t fields_in_rec = 0;
    int64_t field_start = pos;
    for (;;) {
      // scan 8 bytes at a time for delim or newline
      uint64_t hit = 0;
      while (pos + 8 <= len) {
        uint64_t w;
        memcpy(&w, buf + pos, 8);
        const uint64_t dx = w ^ dmask;
        const uint64_t nx = w ^ nmask;
        hit = ((dx - kOnes) & ~dx & kHighs) | ((nx - kOnes) & ~nx & kHighs);
        if (hit) break;
        pos += 8;
      }
      if (hit) {
        pos += __builtin_ctzll(hit) >> 3;
      } else {
        while (pos < len && buf[pos] != delim && buf[pos] != '\n') pos++;
      }
      field_starts[nfields] = field_start;
      field_lens[nfields] = (int32_t)(pos - field_start);
      nfields++;
      fields_in_rec++;
      if (pos >= len) break;            // EOF ends the record
      const char c = buf[pos++];
      if (c == '\n') break;             // record done
      field_start = pos;                // c == delim: next field
      if (pos >= len) {                 // trailing delimiter at EOF:
        field_starts[nfields] = pos;    // empty last field
        field_lens[nfields] = 0;
        nfields++;
        fields_in_rec++;
        break;
      }
    }
    rec_counts[nrec++] = fields_in_rec;
  }
  *nrec_out = nrec;
  return nfields;
}

// Hash-based dictionary encode for u64-packed fields: one linear-probe
// pass assigns provisional codes in first-seen order (uniq_out gets the
// distinct values unsorted; the caller sorts the small distinct set and
// rank-remaps the codes).  Returns the distinct count, or -1 when it
// exceeds max_k — high-cardinality columns bail to the sort path, so
// the probe table stays small and cache-resident for the low-
// cardinality columns this exists for.
}  // extern "C" — reopened below for the hash-encode wrappers

// splitmix64-style finalizer: every input bit affects every output bit.
// Packed fields carry their bytes big-endian (short values vary ONLY in
// the high bits), so a plain multiply-shift hash would drop exactly the
// bits that differ and collapse whole columns into one probe chain.
static inline uint64_t mix64(uint64_t h) {
  h ^= h >> 33;
  h *= 0xFF51AFD7ED558CCDull;
  h ^= h >> 33;
  h *= 0xC4CEB9FE1A85EC53ull;
  h ^= h >> 33;
  return h;
}

namespace {

// ONE open-addressing hash-encode core shared by the 1-lane and 2-lane
// entry points (a review found the two hand-copied variants drifting).
// Starts at a cache-resident 64K-slot table and rehash-doubles with the
// load kept <= 1/2; returns the distinct count, or -1 once max_k
// distinct values have been seen (the caller bails to a sort encode).
// `load(i)` yields row i's key; `store(k, key)` records distinct #k in
// first-seen order; prov_codes[i] gets row i's provisional code.
template <typename K, typename Load, typename Store>
int64_t hash_encode_core(int64_t n, int64_t max_k, Load load, Store store,
                         int32_t* prov_codes) {
  int64_t limit = 1 << 16;  // never below the starting capacity
  while (limit < 2 * max_k) limit <<= 1;
  int64_t cap = 1 << 16;
  K* keys = new K[cap];
  int32_t* slots = new int32_t[cap];
  memset(slots, 0xFF, (size_t)cap * sizeof(int32_t));  // -1 = empty
  uint64_t mask = (uint64_t)cap - 1;
  int64_t grow_at = cap >> 1;
  int64_t k = 0;
  for (int64_t i = 0; i < n; ++i) {
    const K v = load(i);
    uint64_t j = v.hash() & mask;
    for (;;) {
      const int32_t s = slots[j];
      if (s < 0) {
        if (k >= max_k) {
          delete[] keys;
          delete[] slots;
          return -1;
        }
        slots[j] = (int32_t)k;
        keys[j] = v;
        store(k, v);
        prov_codes[i] = (int32_t)k;
        k++;
        break;
      }
      if (keys[j] == v) {
        prov_codes[i] = s;
        break;
      }
      j = (j + 1) & mask;
    }
    if (k >= grow_at && cap < limit) {  // rehash-double
      const int64_t ncap = cap << 1;
      K* nkeys = new K[ncap];
      int32_t* nslots = new int32_t[ncap];
      memset(nslots, 0xFF, (size_t)ncap * sizeof(int32_t));
      const uint64_t nmask = (uint64_t)ncap - 1;
      for (int64_t o = 0; o < cap; ++o) {
        if (slots[o] < 0) continue;
        uint64_t j2 = keys[o].hash() & nmask;
        while (nslots[j2] >= 0) j2 = (j2 + 1) & nmask;
        nslots[j2] = slots[o];
        nkeys[j2] = keys[o];
      }
      delete[] keys;
      delete[] slots;
      keys = nkeys;
      slots = nslots;
      cap = ncap;
      mask = nmask;
      grow_at = cap >> 1;
    }
  }
  delete[] keys;
  delete[] slots;
  return k;
}

struct Key1 {
  uint64_t v;
  bool operator==(const Key1& o) const { return v == o.v; }
  uint64_t hash() const { return mix64(v); }
};

struct Key2 {
  uint64_t h, l;
  bool operator==(const Key2& o) const { return h == o.h && l == o.l; }
  uint64_t hash() const { return mix64(h ^ mix64(l)); }
};

}  // namespace

extern "C" {

// Hash-based dictionary encode for u64-packed (<= 8 byte) fields:
// provisional codes in first-seen order; the caller sorts the distinct
// set and rank-remaps.  -1 = bailed past max_k distinct.
int64_t csv_encode_hash_u64(const uint64_t* packed, int64_t n,
                            uint64_t* uniq_out, int32_t* prov_codes,
                            int64_t max_k) {
  return hash_encode_core<Key1>(
      n, max_k, [&](int64_t i) { return Key1{packed[i]}; },
      [&](int64_t k, const Key1& v) { uniq_out[k] = v.v; }, prov_codes);
}

// Two-lane variant for 9..16-byte fields packed as big-endian (hi, lo)
// u64 pairs.
int64_t csv_encode_hash_u64x2(const uint64_t* hi, const uint64_t* lo,
                              int64_t n, uint64_t* uniq_hi,
                              uint64_t* uniq_lo, int32_t* prov_codes,
                              int64_t max_k) {
  return hash_encode_core<Key2>(
      n, max_k, [&](int64_t i) { return Key2{hi[i], lo[i]}; },
      [&](int64_t k, const Key2& v) {
        uniq_hi[k] = v.h;
        uniq_lo[k] = v.l;
      },
      prov_codes);
}

}  // extern "C"
