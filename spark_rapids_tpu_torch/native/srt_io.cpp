// Host half of the port's Parquet and ORC I/O: the byte-level loops that
// walk a column chunk's or an ORC stream's structure, and the raw Snappy
// block codec.
//
// Port of spark_rapids_tpu/native/srt_native.cpp (srt_parse_runs :120,
// srt_parse_pages :179, srt_plain_strings :299), widened where SF 10 needs
// it: page walks also speak v2 data pages, run tables and value starts are
// 64-bit, and bit widths go to 32. The device decodes values (csrc/
// parquet_decode.cu); these loops touch runs, page headers and length
// prefixes only. Snappy (the raw block format that Parquet's SNAPPY codec
// uses) has no library on the machine with the card, so it is written
// here: a greedy hash-chain compressor over 64 KiB blocks and a bounds-
// checked decompressor.
//
// Plain C interface, built with the host C++ compiler at first use and
// loaded with ctypes (native/__init__.py).

#include <cstdint>
#include <cstring>

#define SRT_API extern "C" __attribute__((visibility("default")))

namespace {

// ------------------------------------------------------------ thrift
struct Reader {
  const uint8_t* buf;
  int64_t pos;
  int64_t end;
  bool err = false;

  uint64_t varint() {
    uint64_t out = 0;
    int shift = 0;
    for (;;) {
      if (pos >= end || shift > 63) {
        err = true;
        return 0;
      }
      const uint8_t b = buf[pos++];
      out |= (uint64_t)(b & 0x7F) << shift;
      if (!(b & 0x80)) return out;
      shift += 7;
    }
  }

  int64_t zigzag() {
    const uint64_t v = varint();
    return (int64_t)(v >> 1) ^ -(int64_t)(v & 1);
  }

  void skip_value(int ftype);

  // Parse a struct, reporting (fid, ftype) to `cb`; the callback returns
  // true when it consumed the value itself.
  template <typename F>
  void parse_struct(F&& cb) {
    int64_t fid = 0;
    for (;;) {
      if (pos >= end) {
        err = true;
        return;
      }
      const uint8_t b = buf[pos++];
      if (b == 0) return;
      const int delta = b >> 4;
      const int ftype = b & 0x0F;
      fid = delta ? fid + delta : zigzag();
      if (err) return;
      if (!cb(fid, ftype, *this)) skip_value(ftype);
      if (err) return;
    }
  }
};

void Reader::skip_value(int ftype) {
  switch (ftype) {
    case 1:
    case 2:
      return;  // a struct field's bool lives in its type nibble
    case 3:
      ++pos;
      return;
    case 4:
    case 5:
    case 6:
      zigzag();
      return;
    case 7:
      pos += 8;
      return;
    case 8: {
      const uint64_t n = varint();
      if (err || n > (uint64_t)(end - pos)) {
        err = true;
        return;
      }
      pos += (int64_t)n;
      return;
    }
    case 9:
    case 10: {
      if (pos >= end) {
        err = true;
        return;
      }
      const uint8_t b = buf[pos++];
      uint64_t n = b >> 4;
      const int et = b & 0x0F;
      if (n == 15) n = varint();
      if (err || n > (uint64_t)(end - pos)) {
        err = true;
        return;
      }
      // a list's bools are one byte each
      for (uint64_t i = 0; i < n && !err; ++i) {
        if (et == 1 || et == 2)
          ++pos;
        else
          skip_value(et);
      }
      return;
    }
    case 12:
      parse_struct([](int64_t, int, Reader&) { return false; });
      return;
    default:
      err = true;
  }
}

bool is_int(int t) { return t >= 3 && t <= 6; }

inline int64_t read_int(Reader& r, int t) {
  if (t != 3) return r.zigzag();
  if (r.pos >= r.end) {
    r.err = true;
    return 0;
  }
  return (int8_t)r.buf[r.pos++];
}

// ------------------------------------------------------------ snappy
inline uint32_t load32(const uint8_t* p) {
  uint32_t v;
  memcpy(&v, p, 4);
  return v;
}

inline uint64_t load64(const uint8_t* p) {
  uint64_t v;
  memcpy(&v, p, 8);
  return v;
}

constexpr int kHashBits = 14;
constexpr int64_t kBlock = 1 << 16;

inline uint32_t hash4(uint32_t v) {
  return (v * 0x1e35a7bdu) >> (32 - kHashBits);
}

uint8_t* emit_literal(uint8_t* op, const uint8_t* lit, int64_t len) {
  int64_t n = len - 1;
  if (n < 60) {
    *op++ = (uint8_t)(n << 2);
  } else {
    uint8_t* tag = op++;
    int count = 0;
    while (n > 0) {
      *op++ = (uint8_t)(n & 0xFF);
      n >>= 8;
      ++count;
    }
    *tag = (uint8_t)((59 + count) << 2);
  }
  memcpy(op, lit, (size_t)len);
  return op + len;
}

// 4 <= len <= 64, offset < 65536
uint8_t* emit_copy_short(uint8_t* op, int64_t offset, int64_t len) {
  if (len < 12 && offset < 2048) {
    *op++ = (uint8_t)(1 | ((len - 4) << 2) | ((offset >> 8) << 5));
    *op++ = (uint8_t)(offset & 0xFF);
  } else {
    *op++ = (uint8_t)(2 | ((len - 1) << 2));
    *op++ = (uint8_t)(offset & 0xFF);
    *op++ = (uint8_t)(offset >> 8);
  }
  return op;
}

uint8_t* emit_copy(uint8_t* op, int64_t offset, int64_t len) {
  while (len >= 68) {
    op = emit_copy_short(op, offset, 64);
    len -= 64;
  }
  if (len > 64) {
    op = emit_copy_short(op, offset, 60);
    len -= 60;
  }
  return emit_copy_short(op, offset, len);
}

// One block (< 64 KiB, so every offset fits two bytes).
uint8_t* compress_block(const uint8_t* base, int64_t n, uint8_t* op,
                        uint16_t* table) {
  const uint8_t* end = base + n;
  const uint8_t* lit = base;
  if (n >= 16) {
    memset(table, 0, sizeof(uint16_t) << kHashBits);
    const uint8_t* limit = end - 8;
    const uint8_t* ip = base + 1;
    uint32_t skip = 32;
    while (ip < limit) {
      const uint32_t cur = load32(ip);
      const uint32_t h = hash4(cur);
      const uint8_t* cand = base + table[h];
      table[h] = (uint16_t)(ip - base);
      if (cand >= ip || load32(cand) != cur) {
        ip += skip >> 5;
        ++skip;
        continue;
      }
      skip = 32;
      const uint8_t* m = ip + 4;
      const uint8_t* c = cand + 4;
      while (m + 8 <= end) {
        const uint64_t x = load64(m) ^ load64(c);
        if (x) {
          m += __builtin_ctzll(x) >> 3;
          goto matched;
        }
        m += 8;
        c += 8;
      }
      while (m < end && *m == *c) {
        ++m;
        ++c;
      }
    matched:
      if (ip > lit) op = emit_literal(op, lit, ip - lit);
      op = emit_copy(op, ip - cand, m - ip);
      ip = m;
      lit = ip;
    }
  }
  if (lit < end) op = emit_literal(op, lit, end - lit);
  return op;
}

}  // namespace

extern "C" {

// Run table of one RLE / bit-packed hybrid stream in buf[start:end).
// Returns the number of runs, -1 when max_runs is too small, -2 when the
// stream is malformed. out_start[i]: output index where run i begins;
// is_rle[i]: 1 for an RLE run of value[i], 0 for a bit-packed run whose
// values start at bit bit_off[i] of buf; *produced_out: values described
// (bit-packed runs pad to groups of 8).
SRT_API int64_t srt_parse_runs(const uint8_t* buf, int64_t start, int64_t end,
                               int32_t bit_width, int64_t num_values,
                               int64_t* out_start, uint8_t* is_rle,
                               int32_t* value, int64_t* bit_off,
                               int64_t max_runs, int64_t* produced_out) {
  if (bit_width < 0 || bit_width > 32) return -2;
  int64_t pos = start;
  int64_t produced = 0;
  int64_t n = 0;
  const int32_t vbytes = (bit_width + 7) / 8;
  while (produced < num_values && pos < end) {
    uint64_t header = 0;
    int shift = 0;
    for (;;) {
      if (pos >= end || shift > 63) return -2;
      const uint8_t b = buf[pos++];
      header |= (uint64_t)(b & 0x7F) << shift;
      if (!(b & 0x80)) break;
      shift += 7;
    }
    if (n >= max_runs) return -1;
    if (header & 1) {
      const int64_t groups = (int64_t)(header >> 1);
      if (bit_width > 0 && groups > (end - pos) / bit_width + 1) return -2;
      out_start[n] = produced;
      is_rle[n] = 0;
      value[n] = 0;
      bit_off[n] = pos * 8;
      pos += groups * bit_width;
      produced += groups * 8;
    } else {
      const int64_t count = (int64_t)(header >> 1);
      uint32_t uv = 0;
      for (int32_t k = 0; k < vbytes && pos + k < end; ++k)
        uv |= (uint32_t)buf[pos + k] << (8 * k);
      pos += vbytes;
      out_start[n] = produced;
      is_rle[n] = 1;
      value[n] = (int32_t)uv;
      bit_off[n] = 0;
      produced += count;
    }
    ++n;
  }
  *produced_out = produced;
  return n;
}

// 1-bits among the first n values of a bit-width-1 hybrid stream, from its
// run table (the present-value count of a page, known on the host without
// a device round trip).
SRT_API int64_t srt_count_ones(const uint8_t* buf, int64_t nbytes,
                               const int64_t* out_start,
                               const uint8_t* is_rle, const int32_t* value,
                               const int64_t* bit_off, int64_t n_runs,
                               int64_t total, int64_t n) {
  int64_t ones = 0;
  for (int64_t i = 0; i < n_runs; ++i) {
    const int64_t s = out_start[i];
    const int64_t e = i + 1 < n_runs ? out_start[i + 1] : total;
    const int64_t cnt = (e < n ? e : n) - s;
    if (cnt <= 0) continue;
    if (is_rle[i]) {
      ones += (value[i] & 1) * cnt;
      continue;
    }
    const int64_t b0 = bit_off[i] >> 3;
    const int64_t full = cnt >> 3;
    if (b0 + full + ((cnt & 7) ? 1 : 0) > nbytes) return -1;
    for (int64_t k = 0; k < full; ++k)
      ones += __builtin_popcount(buf[b0 + k]);
    if (cnt & 7)
      ones += __builtin_popcount(buf[b0 + full] & ((1u << (cnt & 7)) - 1u));
  }
  return ones;
}

// Walk the page headers of one column chunk (v1 and v2 data pages and
// dictionary pages). Returns the page count, or -1 when max_pages is too
// small, -2 on malformed thrift, -4 on another page type (its type id in
// *bad_type).
SRT_API int64_t srt_parse_pages(const uint8_t* buf, int64_t len, int32_t* kind,
                                int64_t* num_values, int32_t* encoding,
                                int64_t* data_start, int64_t* data_len,
                                int64_t* uncompressed_len, int64_t* def_len,
                                int64_t* rep_len, uint8_t* data_compressed,
                                int64_t max_pages, int32_t* bad_type) {
  int64_t n = 0;
  int64_t pos = 0;
  while (pos < len) {
    Reader r{buf, pos, len};
    int64_t ph_type = -1, ph_unc = -1, ph_comp = -1;
    int64_t nv = -1, enc = -1, d2_def = 0, d2_rep = 0, d2_comp = 1;
    auto sub = [&](Reader& rr, bool v2) {
      rr.parse_struct([&](int64_t f, int t, Reader& r2) {
        if (t == 1 || t == 2) {  // bool field: value in the type nibble
          if (v2 && f == 7) d2_comp = t == 1 ? 1 : 0;
          return true;
        }
        if (!is_int(t)) return false;
        const int64_t v = read_int(r2, t);
        if (f == 1) nv = v;
        if (!v2 && f == 2) enc = v;
        if (v2 && f == 4) enc = v;
        if (v2 && f == 5) d2_def = v;
        if (v2 && f == 6) d2_rep = v;
        return true;
      });
      return true;
    };
    r.parse_struct([&](int64_t fid, int ftype, Reader& rr) {
      if (is_int(ftype) && fid <= 3) {
        const int64_t v = read_int(rr, ftype);
        if (fid == 1) ph_type = v;
        if (fid == 2) ph_unc = v;
        if (fid == 3) ph_comp = v;
        return true;
      }
      if (ftype == 12 && (fid == 5 || fid == 7)) return sub(rr, false);
      if (ftype == 12 && fid == 8) return sub(rr, true);
      return false;
    });
    if (r.err || ph_comp < 0 || ph_type < 0 || nv < 0) return -2;
    if (ph_comp > len - r.pos) return -2;
    if (n >= max_pages) return -1;
    if (ph_type != 0 && ph_type != 2 && ph_type != 3) {
      *bad_type = (int32_t)ph_type;
      return -4;
    }
    if (ph_type != 2 && enc < 0) return -2;
    kind[n] = (int32_t)ph_type;
    num_values[n] = nv;
    encoding[n] = ph_type == 2 ? 0 : (int32_t)enc;
    data_start[n] = r.pos;
    data_len[n] = ph_comp;
    uncompressed_len[n] = ph_unc < 0 ? ph_comp : ph_unc;
    def_len[n] = ph_type == 3 ? d2_def : 0;
    rep_len[n] = ph_type == 3 ? d2_rep : 0;
    data_compressed[n] = ph_type == 3 ? (uint8_t)d2_comp : 1;
    ++n;
    pos = r.pos + ph_comp;
  }
  return n;
}

// n values of (u32 LE length + bytes) from buf[pos:end): absolute starts and
// lengths. Returns n, or -1 on a truncated or malformed value.
SRT_API int64_t srt_plain_strings(const uint8_t* buf, int64_t pos, int64_t end,
                                  int64_t n, int64_t* starts, int32_t* lens) {
  for (int64_t i = 0; i < n; i++) {
    if (pos + 4 > end) return -1;
    const uint32_t ln = (uint32_t)buf[pos] | ((uint32_t)buf[pos + 1] << 8) |
                        ((uint32_t)buf[pos + 2] << 16) |
                        ((uint32_t)buf[pos + 3] << 24);
    pos += 4;
    if (ln > 0x7FFFFFFFu || (int64_t)ln > end - pos) return -1;
    starts[i] = pos;
    lens[i] = (int32_t)ln;
    pos += (int64_t)ln;
  }
  return n;
}

// The header walk of one DELTA_BINARY_PACKED stream in buf[pos:end) that
// holds n_values values (port of the reference's _parse_delta_header :468):
// per miniblock that carries data its absolute bit offset, bit width and
// the min delta of its block. meta[0..3]: first value, values per
// miniblock, the byte just past the stream, the miniblocks it needs (set
// before any other check, so a first call with max_mbs = 0 sizes the
// tables). Trailing miniblocks of the last block carry no bytes. Widths go
// to 64, the format's limit. Returns the miniblock count, or -1 when
// max_mbs is too small, -2 truncated, -3 a count that is not n_values, -4
// a bad block geometry, -5 a width past 64.
SRT_API int64_t srt_parse_delta(const uint8_t* buf, int64_t pos, int64_t end,
                                int64_t n_values, int64_t max_mbs,
                                int64_t* mb_bit_off, int32_t* mb_width,
                                int64_t* mb_min_delta, int64_t* meta) {
  Reader r{buf, pos, end};
  const uint64_t block_size = r.varint();
  const uint64_t mbs = r.varint();
  const uint64_t total = r.varint();
  const int64_t first = r.zigzag();
  if (r.err) return -2;
  if ((int64_t)total != n_values || total > (1ull << 62)) return -3;
  if (mbs == 0 || block_size == 0 || mbs > block_size ||
      block_size % (8 * mbs) != 0 || block_size > (1ull << 31))
    return -4;
  const int64_t vpm = (int64_t)(block_size / mbs);
  const int64_t ndeltas = n_values > 0 ? n_values - 1 : 0;
  const int64_t needed = (ndeltas + vpm - 1) / vpm;
  meta[0] = first;
  meta[1] = vpm;
  meta[2] = r.pos;
  meta[3] = needed;
  if (needed > max_mbs) return -1;
  int64_t n = 0;
  int64_t idx = 0;
  while (idx < ndeltas) {
    if (r.pos >= end) return -2;
    const int64_t min_delta = r.zigzag();
    if (r.err || (int64_t)mbs > end - r.pos) return -2;
    const uint8_t* widths = buf + r.pos;
    r.pos += (int64_t)mbs;
    for (uint64_t k = 0; k < mbs && idx < ndeltas; ++k) {
      const int w = widths[k];
      if (w > 64) return -5;
      mb_bit_off[n] = r.pos * 8;
      mb_width[n] = w;
      mb_min_delta[n] = min_delta;
      ++n;
      r.pos += vpm * w / 8;
      idx += vpm;
    }
    if (r.pos > end) return -2;
  }
  meta[2] = r.pos;
  return n;
}

// ------------------------------------------------------------ ORC
// The run walks of ORC's integer and byte streams (port of the reference's
// parse_rlev2 :466 and parse_byte_rle :610 in io/orc_device.py): headers,
// varints and patch lists only; the device expands the values (csrc/
// orc_decode.cu). Widths go to 64 where the reference stops at 56.

static const int kOrcWidths[32] = {1,  2,  3,  4,  5,  6,  7,  8,
                                   9,  10, 11, 12, 13, 14, 15, 16,
                                   17, 18, 19, 20, 21, 22, 23, 24,
                                   26, 28, 30, 32, 40, 48, 56, 64};

static int orc_closest_fixed_bits(int x) {
  for (int w : kOrcWidths)
    if (w >= x) return w;
  return 64;
}

// `width` bits (1-64) at absolute bit `bitpos` of buf, most significant
// first; bytes at or past `end` read as 0.
static uint64_t orc_be_bits(const uint8_t* buf, int64_t end, int64_t bitpos,
                            int width) {
  const int64_t byte = bitpos >> 3;
  const int s = (int)(bitpos & 7);
  uint64_t hi = 0;
  for (int i = 0; i < 8; ++i)
    hi = (hi << 8) | (byte + i < end ? buf[byte + i] : 0u);
  const uint64_t lo = byte + 8 < end ? buf[byte + 8] : 0u;
  const uint64_t win = s ? (hi << s) | (lo >> (8 - s)) : hi;
  return width == 64 ? win : win >> (64 - width);
}

// The RLEv2 stream buf[start:end) up to num_values values, as a run table:
// per run its kind (0 SHORT_REPEAT, 1 DIRECT, 2 DELTA, 3 PATCHED_BASE),
// first output slot, value count, base (SHORT_REPEAT value, DELTA first
// value, PATCHED_BASE base), DELTA's first delta, the absolute bit offset
// and width of its packed payload; and PATCHED_BASE's patches as (output
// slot, value << width). Signed streams zigzag-decode SHORT_REPEAT values
// and DELTA bases (DIRECT payloads on the device). meta[0] = values
// produced, meta[1] = patches (set even when max_patches is too small).
// Returns the run count, or -1 max_runs / max_patches too small, -2 a
// truncated stream, -3 a PATCHED_BASE run whose value and patch widths
// pass 64, -4 a value outside the int64 range (as the reference's
// OverflowError :595).
SRT_API int64_t srt_parse_rlev2(const uint8_t* buf, int64_t start,
                                int64_t end, int64_t num_values,
                                int32_t is_signed, int64_t max_runs,
                                int8_t* kind, int64_t* out_start,
                                int32_t* count, int64_t* base,
                                int64_t* delta0, int64_t* bit_off,
                                int8_t* width, int64_t max_patches,
                                int64_t* patch_pos, int64_t* patch_add,
                                int64_t* meta) {
  int64_t pos = start, produced = 0, n = 0, np = 0;
  const uint64_t kMax = (uint64_t)INT64_MAX;
  while (produced < num_values && pos < end) {
    if (n >= max_runs) return -1;
    const uint8_t h = buf[pos];
    const int enc = h >> 6;
    int64_t runs_base = 0, d0 = 0, boff = 0;
    int w = 0, cnt = 0;
    if (enc == 0) {  // SHORT_REPEAT
      const int vw = ((h >> 3) & 7) + 1;
      cnt = (h & 7) + 3;
      if (pos + 1 + vw > end) return -2;
      uint64_t v = 0;
      for (int i = 0; i < vw; ++i) v = (v << 8) | buf[pos + 1 + i];
      if (is_signed) {
        runs_base = (int64_t)(v >> 1) ^ -(int64_t)(v & 1);
      } else {
        if (v > kMax) return -4;
        runs_base = (int64_t)v;
      }
      pos += 1 + vw;
    } else {
      if (pos + 2 > end) return -2;
      cnt = (((h & 1) << 8) | buf[pos + 1]) + 1;
      const int code = (h >> 1) & 0x1F;
      if (enc == 1) {  // DIRECT
        w = kOrcWidths[code];
        boff = (pos + 2) * 8;
        pos += 2 + ((int64_t)cnt * w + 7) / 8;
        if (pos > end) return -2;
      } else if (enc == 3) {  // DELTA
        w = code == 0 ? 0 : kOrcWidths[code];
        Reader r{buf, pos + 2, end};
        if (is_signed) {
          runs_base = r.zigzag();
        } else {
          const uint64_t v = r.varint();
          if (!r.err && v > kMax) return -4;
          runs_base = (int64_t)v;
        }
        d0 = r.zigzag();
        if (r.err) return -2;
        boff = r.pos * 8;
        pos = r.pos + (w ? ((int64_t)(cnt > 2 ? cnt - 2 : 0) * w + 7) / 8 : 0);
        if (pos > end) return -2;
      } else {  // PATCHED_BASE
        w = kOrcWidths[code];
        if (pos + 4 > end) return -2;
        const uint8_t b3 = buf[pos + 2], b4 = buf[pos + 3];
        const int bw = ((b3 >> 5) & 7) + 1;
        const int pw = kOrcWidths[b3 & 0x1F];
        const int pgw = ((b4 >> 5) & 7) + 1;
        const int pl = b4 & 0x1F;
        if (w + pw > 64) return -3;
        int64_t p = pos + 4;
        if (p + bw > end) return -2;
        uint64_t b = 0;
        for (int i = 0; i < bw; ++i) b = (b << 8) | buf[p + i];
        const uint64_t msb = 1ull << (bw * 8 - 1);
        runs_base = (b & msb) ? -(int64_t)(b & (msb - 1)) : (int64_t)b;
        p += bw;
        boff = p * 8;
        p += ((int64_t)cnt * w + 7) / 8;
        const int plw = orc_closest_fixed_bits(pgw + pw);
        const int64_t list_end = p + ((int64_t)pl * plw + 7) / 8;
        if (list_end > end) return -2;
        int64_t out_idx = produced;
        for (int e = 0; e < pl; ++e) {
          const uint64_t entry = orc_be_bits(buf, list_end,
                                             p * 8 + (int64_t)e * plw, plw);
          const uint64_t gap = pw == 64 ? 0 : entry >> pw;
          const uint64_t pval = pw == 64 ? entry : entry & ((1ull << pw) - 1);
          out_idx += (int64_t)gap;
          if (!pval) continue;
          if (w > 0 && pval > (kMax >> w)) return -4;
          if (np < max_patches) {
            patch_pos[np] = out_idx;
            patch_add[np] = (int64_t)(pval << w);
          }
          ++np;
        }
        pos = list_end;
      }
    }
    kind[n] = (int8_t)(enc == 0 ? 0 : enc == 1 ? 1 : enc == 3 ? 2 : 3);
    out_start[n] = produced;
    count[n] = cnt;
    base[n] = runs_base;
    delta0[n] = d0;
    bit_off[n] = boff;
    width[n] = (int8_t)w;
    ++n;
    produced += cnt;
  }
  meta[0] = produced;
  meta[1] = np;
  return np > max_patches ? -1 : n;
}

// The byte-RLE stream buf[start:end) (ORC's PRESENT and BOOLEAN streams)
// as a run table: per run its first output byte, byte count, whether it
// repeats one byte (and which), and the offset of its literal bytes.
// meta[0] = bytes produced, meta[1] = set bits among the first num_bits.
// Returns the run count, or -1 max_runs too small, -2 a truncated stream.
SRT_API int64_t srt_parse_byte_rle(const uint8_t* buf, int64_t start,
                                   int64_t end, int64_t num_bits,
                                   int64_t max_runs, int64_t* out_start,
                                   int32_t* count, uint8_t* is_run,
                                   uint8_t* value, int64_t* lit_off,
                                   int64_t* meta) {
  int64_t pos = start, produced = 0, n = 0, ones = 0;
  const int64_t nbytes = (num_bits + 7) / 8;
  auto add_ones = [&](uint8_t b, int64_t at) {
    if (at >= nbytes) return;
    if (at == nbytes - 1 && (num_bits & 7))
      b &= (uint8_t)(0xFF00u >> (num_bits & 7));
    ones += __builtin_popcount(b);
  };
  while (pos < end) {
    if (n >= max_runs) return -1;
    const uint8_t h = buf[pos];
    int cnt;
    if (h < 128) {
      cnt = h + 3;
      if (pos + 2 > end) return -2;
      is_run[n] = 1;
      value[n] = buf[pos + 1];
      lit_off[n] = 0;
      for (int k = 0; k < cnt; ++k) add_ones(buf[pos + 1], produced + k);
      pos += 2;
    } else {
      cnt = 256 - h;
      if (pos + 1 + cnt > end) return -2;
      is_run[n] = 0;
      value[n] = 0;
      lit_off[n] = pos + 1;
      for (int k = 0; k < cnt; ++k) add_ones(buf[pos + 1 + k], produced + k);
      pos += 1 + cnt;
    }
    out_start[n] = produced;
    count[n] = cnt;
    ++n;
    produced += cnt;
  }
  meta[0] = produced;
  meta[1] = ones;
  return n;
}

// ------------------------------------------------------------ snappy
SRT_API int64_t srt_snappy_max_compressed(int64_t n) { return 32 + n + n / 6; }

// Raw Snappy block of src[0:n) into dst (srt_snappy_max_compressed(n)
// bytes); returns the compressed length.
SRT_API int64_t srt_snappy_compress(const uint8_t* src, int64_t n,
                                    uint8_t* dst) {
  uint8_t* op = dst;
  uint64_t v = (uint64_t)n;
  while (v >= 0x80) {
    *op++ = (uint8_t)(v | 0x80);
    v >>= 7;
  }
  *op++ = (uint8_t)v;
  uint16_t table[1 << kHashBits];
  for (int64_t off = 0; off < n; off += kBlock) {
    const int64_t len = n - off < kBlock ? n - off : kBlock;
    op = compress_block(src + off, len, op, table);
  }
  return op - dst;
}

// The uncompressed length a raw Snappy block declares, or -1.
SRT_API int64_t srt_snappy_uncompressed_length(const uint8_t* src,
                                               int64_t n) {
  uint64_t v = 0;
  int shift = 0;
  for (int64_t i = 0; i < n && shift <= 63; ++i) {
    v |= (uint64_t)(src[i] & 0x7F) << shift;
    if (!(src[i] & 0x80)) return v > (1ull << 62) ? -1 : (int64_t)v;
    shift += 7;
  }
  return -1;
}

// Decompress a raw Snappy block into dst (dst_cap bytes). Returns the
// length written, or -1 when the block is malformed or does not fit.
SRT_API int64_t srt_snappy_decompress(const uint8_t* src, int64_t n,
                                      uint8_t* dst, int64_t dst_cap) {
  int64_t ip = 0;
  uint64_t ulen = 0;
  int shift = 0;
  for (;;) {
    if (ip >= n || shift > 63) return -1;
    const uint8_t b = src[ip++];
    ulen |= (uint64_t)(b & 0x7F) << shift;
    if (!(b & 0x80)) break;
    shift += 7;
  }
  if (ulen > (uint64_t)dst_cap) return -1;
  const int64_t out_len = (int64_t)ulen;
  int64_t op = 0;
  while (ip < n) {
    const uint8_t tag = src[ip++];
    int64_t len, offset;
    switch (tag & 3) {
      case 0: {
        len = (tag >> 2) + 1;
        if (len > 60) {
          const int nb = (int)len - 60;
          if (ip + nb > n) return -1;
          len = 0;
          for (int k = 0; k < nb; ++k) len |= (int64_t)src[ip + k] << (8 * k);
          len += 1;
          ip += nb;
        }
        if (len > n - ip || len > out_len - op) return -1;
        memcpy(dst + op, src + ip, (size_t)len);
        ip += len;
        op += len;
        continue;
      }
      case 1:
        if (ip >= n) return -1;
        len = ((tag >> 2) & 7) + 4;
        offset = ((int64_t)(tag >> 5) << 8) | src[ip++];
        break;
      case 2:
        if (ip + 2 > n) return -1;
        len = (tag >> 2) + 1;
        offset = (int64_t)src[ip] | ((int64_t)src[ip + 1] << 8);
        ip += 2;
        break;
      default:
        if (ip + 4 > n) return -1;
        len = (tag >> 2) + 1;
        offset = (int64_t)load32(src + ip);
        ip += 4;
        break;
    }
    if (offset <= 0 || offset > op || len > out_len - op) return -1;
    uint8_t* d = dst + op;
    const uint8_t* s = d - offset;
    if (offset >= len) {
      memcpy(d, s, (size_t)len);
    } else if (offset >= 8) {
      // 8 bytes at a time: each chunk reads bytes already written
      int64_t k = 0;
      for (; k + 8 <= len; k += 8) memcpy(d + k, s + k, 8);
      for (; k < len; ++k) d[k] = s[k];
    } else {
      for (int64_t k = 0; k < len; ++k) d[k] = s[k];
    }
    op += len;
  }
  return op == out_len ? op : -1;
}

// One ORC stream of Snappy blocks, buf[start:end) in ORC's framing (a
// 3-byte little-endian header, length << 1 | is_original, before each
// block). With out == nullptr: the stream's uncompressed size; else the
// stream decompressed into out[0:out_len) (out_len that size). Returns
// the size, or -1 a malformed block, -2 a block past the stream, -3 an
// out_len that is not the size. One call a stream: the caller's threads
// take streams in parallel without a per-block round trip.
SRT_API int64_t srt_orc_snappy_stream(const uint8_t* buf, int64_t start,
                                      int64_t end, uint8_t* out,
                                      int64_t out_len) {
  int64_t pos = start, total = 0;
  while (pos < end) {
    if (pos + 3 > end) return -2;
    const uint32_t h = buf[pos] | (buf[pos + 1] << 8) | (buf[pos + 2] << 16);
    pos += 3;
    const int64_t blen = h >> 1;
    if (pos + blen > end) return -2;
    const int64_t ulen =
        (h & 1) ? blen : srt_snappy_uncompressed_length(buf + pos, blen);
    if (ulen < 0) return -1;
    if (out != nullptr) {
      if (total + ulen > out_len) return -3;
      if (h & 1) {
        memcpy(out + total, buf + pos, (size_t)blen);
      } else if (ulen &&
                 srt_snappy_decompress(buf + pos, blen, out + total, ulen) !=
                     ulen) {
        return -1;
      }
    }
    total += ulen;
    pos += blen;
  }
  return out != nullptr && total != out_len ? -3 : total;
}

// ORC's framing of Snappy blocks (the writer's side of
// srt_orc_snappy_stream): src[0:n) cut into blocks of `block` bytes, each
// compressed, or kept where compression does not shrink it, after its
// 3-byte little-endian header (length << 1 | is_original). dst holds
// srt_orc_snappy_framed_max(n, block) bytes; returns the bytes written.
SRT_API int64_t srt_orc_snappy_framed_max(int64_t n, int64_t block) {
  const int64_t blocks = block > 0 ? (n + block - 1) / block : 0;
  return blocks * (3 + srt_snappy_max_compressed(block));
}

SRT_API int64_t srt_orc_snappy_framed(const uint8_t* src, int64_t n,
                                      int64_t block, uint8_t* dst) {
  if (block <= 0 || block >= (1 << 23)) return -1;
  uint8_t* op = dst;
  for (int64_t off = 0; off < n; off += block) {
    const int64_t len = n - off < block ? n - off : block;
    const int64_t c = srt_snappy_compress(src + off, len, op + 3);
    uint32_t h;
    if (c < len) {
      h = (uint32_t)c << 1;
    } else {
      memcpy(op + 3, src + off, (size_t)len);
      h = ((uint32_t)len << 1) | 1u;
    }
    op[0] = (uint8_t)h;
    op[1] = (uint8_t)(h >> 8);
    op[2] = (uint8_t)(h >> 16);
    op += 3 + (h >> 1);
  }
  return op - dst;
}


// ------------------------------------------------------------------ CSV
// The field-boundary plans of the CSV scan (io/csv_device.py). Each writes
// the (start, length) of every field column-major: field (row, col) at
// [col * stride + row], so a column's spans are contiguous.

// Occurrences of byte `b` in buf[lo, hi).
SRT_API int64_t srt_count_byte(const uint8_t* buf, int64_t lo, int64_t hi,
                               int32_t b) {
  int64_t n = 0;
  const uint8_t v = (uint8_t)b;
  for (int64_t i = lo; i < hi; ++i) n += buf[i] == v;
  return n;
}

// The quotes of buf[lo, hi), and whether it holds a byte past 0x7F
// (meta[0], meta[1]), in one pass.
SRT_API void srt_csv_stats(const uint8_t* buf, int64_t lo, int64_t hi,
                           int64_t* meta) {
  int64_t quotes = 0;
  uint8_t acc = 0;
  for (int64_t i = lo; i < hi; ++i) {
    quotes += buf[i] == (uint8_t)'"';
    acc |= buf[i];
  }
  meta[0] = quotes;
  meta[1] = (acc & 0x80) ? 1 : 0;
}

// The field plan of buf[lo, hi): spark_rapids_tpu/native/srt_native.cpp:
// srt_csv_plan (:257) made quote-aware, so that it gives the rows of
// spark_rapids_tpu/io/csv_device.py:_plan_fields_quoted (:130) as well, in
// one sweep. It checks the column count of every line and trims CRLF, as
// the reference's sweep does; separators and newlines inside quotes are
// not boundaries (a quote toggles the state after itself), a field that
// starts and ends with a quote loses them, and the second quote of each
// "" pair met inside quotes is deleted. Fields with any other quote
// layout make the range ineligible. buf is rewritten in place when pairs
// were deleted: the spans then point into the rewritten bytes, which end
// at hi - meta[0]. meta[1] is 1 when a byte past 0x7F was seen. A range
// that does not end in a newline ends with a virtual one. Returns the
// rows, -1 (not eligible: a ragged line, a quote layout) or -3 (more than
// max_rows rows).
SRT_API int64_t srt_csv_plan(uint8_t* buf, int64_t lo, int64_t hi,
                             int32_t sep, int32_t ncols, int32_t* starts,
                             int32_t* lens, int64_t stride,
                             int64_t max_rows, int64_t* meta) {
  meta[0] = meta[1] = 0;
  if (hi <= lo || ncols <= 0) return -1;
  const uint8_t sp = (uint8_t)sep;
  const bool virtual_end = buf[hi - 1] != (uint8_t)'\n';
  bool inside = false, prev_first = false;
  int64_t deleted = 0, row = 0;
  int32_t col = 0;
  int64_t fstart = lo, fdel = 0, quotes = 0;
  uint8_t high = 0;
  for (int64_t i = lo; i <= hi; ++i) {
    bool is_nl;
    if (i == hi) {
      if (!virtual_end) break;
      is_nl = true;
    } else {
      const uint8_t c = buf[i];
      high |= c;
      if (c == (uint8_t)'"') {
        // the first quote of a "" pair is met inside quotes; its partner
        // is deleted
        const bool first =
            inside && i + 1 < hi && buf[i + 1] == (uint8_t)'"';
        if (prev_first) ++deleted;
        prev_first = first;
        ++quotes;
        inside = !inside;
        continue;
      }
      prev_first = false;
      if (inside || (c != sp && c != (uint8_t)'\n')) continue;
      is_nl = c == (uint8_t)'\n';
    }
    if (col < ncols - 1 ? is_nl : !is_nl) return -1;  // ragged line
    if (row >= max_rows) return -3;
    int64_t flen = i - fstart;
    if (col == ncols - 1 && flen > 0 && buf[i - 1] == (uint8_t)'\r') --flen;
    const bool quoted = flen >= 2 && buf[fstart] == (uint8_t)'"' &&
                        buf[fstart + flen - 1] == (uint8_t)'"';
    const int64_t pairs = deleted - fdel;
    if (quoted ? quotes != 2 + 2 * pairs : quotes != 0) return -1;
    const int64_t s = fstart + (quoted ? 1 : 0);
    const int64_t l = flen - (quoted ? 2 : 0) - pairs;
    starts[(int64_t)col * stride + row] = (int32_t)(s - fdel);
    lens[(int64_t)col * stride + row] = (int32_t)l;
    fstart = i + 1;
    fdel = deleted;
    quotes = 0;
    if (is_nl) {
      col = 0;
      ++row;
    } else {
      ++col;
    }
  }
  if (col != 0) return -1;
  meta[0] = deleted;
  meta[1] = (high & 0x80) ? 1 : 0;
  if (deleted > 0) {
    // delete the second quote of each pair, in place
    inside = prev_first = false;
    int64_t w = lo;
    for (int64_t i = lo; i < hi; ++i) {
      const uint8_t c = buf[i];
      if (c == (uint8_t)'"') {
        const bool first =
            inside && i + 1 < hi && buf[i + 1] == (uint8_t)'"';
        const bool skip = prev_first;
        prev_first = first;
        inside = !inside;
        if (skip) continue;
      } else {
        prev_first = false;
      }
      buf[w++] = c;
    }
  }
  return row;
}

// The end of the last line of buf[lo, hi) whose newline lies outside
// quotes (lo starts a line outside quotes): the position after that
// newline, or -1 when there is none.
SRT_API int64_t srt_csv_last_line_end(const uint8_t* buf, int64_t lo,
                                      int64_t hi) {
  bool inside = false;
  int64_t last = -1;
  for (int64_t i = lo; i < hi; ++i) {
    const uint8_t c = buf[i];
    if (c == (uint8_t)'"') {
      inside = !inside;
    } else if (c == (uint8_t)'\n' && !inside) {
      last = i + 1;
    }
  }
  return last;
}

// The position after the first newline outside quotes in buf[lo, hi),
// given whether lo lies inside quotes; hi when there is none.
SRT_API int64_t srt_csv_next_line(const uint8_t* buf, int64_t lo,
                                  int64_t hi, int32_t inside) {
  bool in = inside != 0;
  for (int64_t i = lo; i < hi; ++i) {
    const uint8_t c = buf[i];
    if (c == (uint8_t)'"') {
      in = !in;
    } else if (c == (uint8_t)'\n' && !in) {
      return i + 1;
    }
  }
  return hi;
}

}  // extern "C"
