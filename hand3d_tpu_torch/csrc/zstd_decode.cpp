// A Zstandard frame decoder (RFC 8878), host C++ with a plain C interface
// for ctypes (hand3d_tpu_torch/weights/zstd.py builds and binds it).
//
// It decodes what tensorstore writes into Orbax checkpoints and everything
// else the format allows without a dictionary: raw, RLE and compressed
// blocks; raw, RLE, Huffman (1 or 4 streams) and treeless literals, with
// FSE-coded or direct Huffman weights; predefined, RLE, FSE and repeat
// sequence tables and the three repeat offsets; frames with or without a
// content size, concatenated frames and skippable frames. A frame's xxh64
// content checksum is verified where it carries one. A frame that names a
// dictionary is refused.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC zstd_decode.cpp -o libzstd_decode.so
//
// C interface:
//   void* zd_decompress(const uint8_t* src, size_t n, char* err, size_t cap)
//     decodes every frame of src[0, n) into a buffer it owns; returns a
//     handle, or NULL with a message in err[0, cap) on bad input.
//   const uint8_t* zd_data(void* h); size_t zd_size(void* h);
//   void zd_free(void* h);

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct Error : std::runtime_error {
  explicit Error(const std::string& m) : std::runtime_error(m) {}
};

[[noreturn]] void fail(const std::string& m) { throw Error(m); }

inline uint32_t le16(const uint8_t* p) { return p[0] | (uint32_t(p[1]) << 8); }
inline uint32_t le24(const uint8_t* p) { return le16(p) | (uint32_t(p[2]) << 16); }
inline uint32_t le32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}
inline uint64_t le64(const uint8_t* p) {
  uint64_t v;
  std::memcpy(&v, p, 8);
  return v;
}
inline int highbit(uint32_t v) { return 31 - __builtin_clz(v); }

// ---------------------------------------------------------------- xxh64

constexpr uint64_t P1 = 11400714785074694791ULL, P2 = 14029467366897019727ULL,
                   P3 = 1609587929392839161ULL, P4 = 9650029242287828579ULL,
                   P5 = 2870177450012600261ULL;
inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint64_t xround(uint64_t acc, uint64_t in) {
  return rotl(acc + in * P2, 31) * P1;
}
inline uint64_t xmerge(uint64_t acc, uint64_t v) {
  return (acc ^ xround(0, v)) * P1 + P4;
}

uint64_t xxh64(const uint8_t* p, size_t n, uint64_t seed) {
  const uint8_t* end = p + n;
  uint64_t h;
  if (n >= 32) {
    uint64_t v1 = seed + P1 + P2, v2 = seed + P2, v3 = seed, v4 = seed - P1;
    for (; p + 32 <= end; p += 32) {
      v1 = xround(v1, le64(p));
      v2 = xround(v2, le64(p + 8));
      v3 = xround(v3, le64(p + 16));
      v4 = xround(v4, le64(p + 24));
    }
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = xmerge(h, v1);
    h = xmerge(h, v2);
    h = xmerge(h, v3);
    h = xmerge(h, v4);
  } else {
    h = seed + P5;
  }
  h += n;
  for (; p + 8 <= end; p += 8) h = rotl(h ^ xround(0, le64(p)), 27) * P1 + P4;
  if (p + 4 <= end) {
    h = rotl(h ^ (uint64_t(le32(p)) * P1), 23) * P2 + P3;
    p += 4;
  }
  for (; p < end; ++p) h = rotl(h ^ (*p * P5), 11) * P1;
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

// ------------------------------------------------------------ bit readers

// Forward little-endian bits (FSE table descriptions).
struct ForwardBits {
  const uint8_t* p;
  size_t n;
  size_t pos = 0;  // bits consumed
  ForwardBits(const uint8_t* p_, size_t n_) : p(p_), n(n_) {}
  uint32_t peek(int bits) const {
    uint64_t v = 0;
    size_t byte = pos >> 3;
    for (int i = 0; i < 8 && byte + i < n; ++i) v |= uint64_t(p[byte + i]) << (8 * i);
    return uint32_t((v >> (pos & 7)) & ((1ULL << bits) - 1));
  }
  void skip(int bits) {
    pos += bits;
    if (pos > 8 * n) fail("FSE table description runs past its input");
  }
  size_t bytes_used() const { return (pos + 7) >> 3; }
};

// Backward bits (Huffman and FSE streams): the last byte's highest set bit
// is a padding marker; bits are then taken from the top down. Bits below
// the start read as zeros, and `overflowed` tells that they were taken.
struct BackwardBits {
  const uint8_t* p;
  size_t n;
  int64_t pos;  // bits not yet consumed; the next read ends here
  BackwardBits(const uint8_t* p_, size_t n_) : p(p_), n(n_) {
    if (n == 0) fail("empty bitstream");
    uint8_t last = p[n - 1];
    if (last == 0) fail("bitstream's last byte holds no padding marker");
    pos = int64_t(8 * (n - 1)) + highbit(last);
  }
  // bits [at, at + bits) of the stream, at >= 0, bits <= 56
  uint64_t window(int64_t at, int bits) const {
    size_t byte = size_t(at >> 3);
    uint64_t v;
    if (byte + 8 <= n) {
      v = le64(p + byte);
    } else {
      v = 0;
      for (size_t i = 0; byte + i < n; ++i) v |= uint64_t(p[byte + i]) << (8 * i);
    }
    return (v >> (at & 7)) & ((1ULL << bits) - 1);
  }
  uint64_t peek(int bits) const {
    if (bits == 0) return 0;
    int64_t at = pos - bits;
    if (at >= 0) return window(at, bits);
    int have = int(pos);  // bits left above the start
    if (have <= 0) return 0;
    return window(0, have) << (bits - have);
  }
  uint64_t read(int bits) {
    uint64_t v = peek(bits);
    pos -= bits;
    return v;
  }
  bool overflowed() const { return pos < 0; }
  bool finished() const { return pos == 0; }
};

// ------------------------------------------------------------ FSE tables

struct FseEntry {
  uint16_t symbol;
  uint8_t bits;
  uint16_t base;  // next state = base + read(bits)
};

struct FseTable {
  int log = -1;  // accuracy log; -1: no table yet
  std::vector<FseEntry> t;
};

// normalized counts -> decoding table (RFC 8878 4.1.1)
void build_fse(FseTable& out, const std::vector<int16_t>& norm, int log) {
  const uint32_t size = 1u << log;
  out.log = log;
  out.t.assign(size, FseEntry{0, 0, 0});
  std::vector<uint32_t> next(norm.size());
  int64_t high = int64_t(size) - 1;
  for (size_t s = 0; s < norm.size(); ++s) {
    if (norm[s] == -1) {
      if (high < 0) fail("FSE table: too many low-probability symbols");
      out.t[size_t(high--)].symbol = uint16_t(s);
      next[s] = 1;
    } else {
      next[s] = uint32_t(norm[s] > 0 ? norm[s] : 0);
    }
  }
  const uint32_t step = (size >> 1) + (size >> 3) + 3, mask = size - 1;
  uint32_t position = 0;
  for (size_t s = 0; s < norm.size(); ++s) {
    for (int i = 0; i < norm[s]; ++i) {
      out.t[position].symbol = uint16_t(s);
      do {
        position = (position + step) & mask;
      } while (int64_t(position) > high);
    }
  }
  if (position != 0) fail("FSE table: counts do not fill the table");
  for (uint32_t u = 0; u < size; ++u) {
    FseEntry& e = out.t[u];
    uint32_t state = next[e.symbol]++;
    int bits = log - highbit(state);
    e.bits = uint8_t(bits);
    e.base = uint16_t((state << bits) - size);
  }
}

// reads an FSE table description; returns the bytes it took
size_t read_fse(FseTable& out, const uint8_t* p, size_t n, int max_log,
                int max_symbol) {
  ForwardBits in(p, n);
  if (n == 0) fail("FSE table description: no input");
  int log = int(in.peek(4)) + 5;
  in.skip(4);
  if (log > max_log) fail("FSE table: accuracy log " + std::to_string(log) +
                          " above " + std::to_string(max_log));
  int remaining = (1 << log) + 1, threshold = 1 << log, bits = log + 1;
  std::vector<int16_t> norm;
  bool previous0 = false;
  while (remaining > 1) {
    if (previous0) {
      // runs of zero-probability symbols: 2-bit repeat flags, 3 continues
      int repeat;
      do {
        repeat = int(in.peek(2));
        in.skip(2);
        for (int i = 0; i < repeat; ++i) norm.push_back(0);
      } while (repeat == 3);
      if (int(norm.size()) > max_symbol + 1) fail("FSE table: too many symbols");
    }
    int max = (2 * threshold - 1) - remaining;
    int count;
    uint32_t low = in.peek(bits - 1);
    if (int(low) < max) {
      count = int(low);
      in.skip(bits - 1);
    } else {
      count = int(in.peek(bits));
      if (count >= threshold) count -= max;
      in.skip(bits);
    }
    --count;  // count - 1: -1 marks a "less than one" probability
    remaining -= count < 0 ? -count : count;
    norm.push_back(int16_t(count));
    if (int(norm.size()) > max_symbol + 1) fail("FSE table: too many symbols");
    previous0 = count == 0;
    while (remaining < threshold && bits > 1) {
      --bits;
      threshold >>= 1;
    }
  }
  if (remaining != 1) fail("FSE table: probabilities do not sum up");
  build_fse(out, norm, log);
  return in.bytes_used();
}

void rle_fse(FseTable& out, uint8_t symbol) {
  out.log = 0;
  out.t.assign(1, FseEntry{symbol, 0, 0});
}

// --------------------------------------------------------------- Huffman

struct HufEntry {
  uint8_t symbol;
  uint8_t bits;
};

struct HufTable {
  int max_bits = 0;  // 0: no table yet
  std::vector<HufEntry> t;
};

// the Huffman tree description; returns the bytes it took
size_t read_huffman(HufTable& out, const uint8_t* p, size_t n) {
  if (n == 0) fail("Huffman tree description: no input");
  uint8_t weights[256] = {0};
  int count;
  size_t used;
  uint8_t header = p[0];
  if (header >= 128) {  // direct: 4 bits a weight
    count = header - 127;
    used = 1 + size_t(count + 1) / 2;
    if (used > n) fail("Huffman weights run past the block");
    for (int i = 0; i < count; ++i) {
      uint8_t b = p[1 + i / 2];
      weights[i] = (i % 2 == 0) ? (b >> 4) : (b & 15);
    }
  } else {  // FSE-coded, two interleaved states
    size_t size = header;
    used = 1 + size;
    if (used > n || size == 0) fail("Huffman weights run past the block");
    FseTable fse;
    size_t desc = read_fse(fse, p + 1, size, 6, 255);
    if (desc >= size) fail("Huffman weights: no bitstream after the table");
    BackwardBits in(p + 1 + desc, size - desc);
    uint32_t s1 = uint32_t(in.read(fse.log)), s2 = uint32_t(in.read(fse.log));
    count = 0;
    for (;;) {
      if (count >= 255) fail("Huffman weights: too many");
      const FseEntry& e1 = fse.t[s1];
      weights[count++] = uint8_t(e1.symbol);
      s1 = e1.base + uint32_t(in.read(e1.bits));
      if (in.overflowed()) {
        if (count >= 255) fail("Huffman weights: too many");
        weights[count++] = uint8_t(fse.t[s2].symbol);
        break;
      }
      if (count >= 255) fail("Huffman weights: too many");
      const FseEntry& e2 = fse.t[s2];
      weights[count++] = uint8_t(e2.symbol);
      s2 = e2.base + uint32_t(in.read(e2.bits));
      if (in.overflowed()) {
        if (count >= 255) fail("Huffman weights: too many");
        weights[count++] = uint8_t(fse.t[s1].symbol);
        break;
      }
    }
  }
  // the last symbol's weight is implied: the sum must reach a power of 2
  uint32_t total = 0;
  for (int i = 0; i < count; ++i) {
    if (weights[i] > 11) fail("Huffman weight above 11");
    if (weights[i]) total += 1u << (weights[i] - 1);
  }
  if (total == 0) fail("Huffman weights all zero");
  int max_bits = highbit(total) + 1;
  uint32_t rest = (1u << max_bits) - total;
  if (rest & (rest - 1)) fail("Huffman weights do not sum to a power of 2");
  if (count >= 256) fail("Huffman weights: too many");
  weights[count++] = uint8_t(highbit(rest) + 1);
  if (max_bits > 11) fail("Huffman code longer than 11 bits");
  // table of 2^max_bits entries, weight 1 first, symbols in order
  uint32_t start[13] = {0};
  uint32_t rank[13] = {0};
  for (int i = 0; i < count; ++i) rank[weights[i]]++;
  uint32_t next = 0;
  for (int w = 1; w <= max_bits; ++w) {
    start[w] = next;
    next += rank[w] << (w - 1);
  }
  if (next != (1u << max_bits)) fail("Huffman table does not fill");
  out.max_bits = max_bits;
  out.t.assign(size_t(1) << max_bits, HufEntry{0, 0});
  for (int s = 0; s < count; ++s) {
    int w = weights[s];
    if (!w) continue;
    uint32_t len = 1u << (w - 1);
    HufEntry e{uint8_t(s), uint8_t(max_bits + 1 - w)};
    for (uint32_t u = 0; u < len; ++u) out.t[start[w] + u] = e;
    start[w] += len;
  }
  return used;
}

void huffman_stream(const HufTable& h, const uint8_t* p, size_t n, uint8_t* dst,
                    size_t count) {
  BackwardBits in(p, n);
  const int mb = h.max_bits;
  const HufEntry* t = h.t.data();
  size_t i = 0;
  // fast part: four symbols per 64-bit window while the window holds them
  while (i + 4 <= count && in.pos >= 4 * mb + 8) {
    int64_t at = in.pos - 4 * mb;
    uint64_t w = in.window(at, 4 * mb);  // top bits of w are the next codes
    int left = 4 * mb;
    for (int k = 0; k < 4; ++k) {
      const HufEntry& e = t[(w >> (left - mb)) & ((1u << mb) - 1)];
      dst[i++] = e.symbol;
      left -= e.bits;
      in.pos -= e.bits;
    }
  }
  for (; i < count; ++i) {
    const HufEntry& e = t[in.peek(mb)];
    dst[i] = e.symbol;
    in.pos -= e.bits;
  }
  if (!in.finished()) fail("Huffman stream not consumed exactly");
}

// ---------------------------------------------------------- sequences

const int16_t LL_DEFAULT[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2,
                                2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2,
                                2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t ML_DEFAULT[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t OF_DEFAULT[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

const uint32_t LL_BASE[36] = {0,  1,  2,   3,   4,   5,    6,    7,    8,
                              9,  10, 11,  12,  13,  14,   15,   16,   18,
                              20, 22, 24,  28,  32,  40,   48,   64,   128,
                              256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
const uint8_t LL_BITS[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3,
                             4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t ML_BASE[53] = {
    3,  4,  5,  6,  7,  8,  9,  10, 11,  12,  13,  14,   15,   16,   17,   18,   19,   20,
    21, 22, 23, 24, 25, 26, 27, 28, 29,  30,  31,  32,   33,   34,   35,   37,   39,   41,
    43, 47, 51, 59, 67, 83, 99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t ML_BITS[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1,
                             2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};

struct FrameState {
  HufTable huf;
  FseTable ll, of, ml;
  uint32_t rep[3] = {1, 4, 8};
};

// one table of the sequences section by its mode; returns bytes taken
size_t sequence_table(FseTable& t, int mode, const uint8_t* p, size_t n,
                      const int16_t* def, int def_n, int def_log, int max_log,
                      int max_symbol, const char* name) {
  switch (mode) {
    case 0:
      build_fse(t, std::vector<int16_t>(def, def + def_n), def_log);
      return 0;
    case 1:
      if (n < 1) fail(std::string(name) + " RLE table: no input");
      if (p[0] > max_symbol) fail(std::string(name) + " RLE symbol out of range");
      rle_fse(t, p[0]);
      return 1;
    case 2:
      return read_fse(t, p, n, max_log, max_symbol);
    default:
      if (t.log < 0) fail(std::string(name) + " repeat mode with no earlier table");
      return 0;
  }
}

void compressed_block(FrameState& st, const uint8_t* p, size_t n,
                      std::vector<uint8_t>& out, size_t frame_start) {
  if (n < 1) fail("empty compressed block");
  // ---- literals section
  std::vector<uint8_t> lit;
  const int ltype = p[0] & 3, sf = (p[0] >> 2) & 3;
  size_t pos;
  if (ltype < 2) {  // raw or RLE
    size_t regen;
    if ((sf & 1) == 0) {
      regen = p[0] >> 3;
      pos = 1;
    } else if (sf == 1) {
      if (n < 2) fail("literals header truncated");
      regen = (p[0] >> 4) + (size_t(p[1]) << 4);
      pos = 2;
    } else {
      if (n < 3) fail("literals header truncated");
      regen = (p[0] >> 4) + (size_t(p[1]) << 4) + (size_t(p[2]) << 12);
      pos = 3;
    }
    if (ltype == 0) {
      if (pos + regen > n) fail("raw literals run past the block");
      lit.assign(p + pos, p + pos + regen);
      pos += regen;
    } else {
      if (pos + 1 > n) fail("RLE literals run past the block");
      lit.assign(regen, p[pos]);
      pos += 1;
    }
  } else {  // Huffman-compressed or treeless
    size_t regen, csize;
    int streams = sf == 0 ? 1 : 4;
    if (sf < 2) {
      if (n < 3) fail("literals header truncated");
      uint32_t h = le24(p);
      regen = (h >> 4) & 0x3FF;
      csize = (h >> 14) & 0x3FF;
      pos = 3;
    } else if (sf == 2) {
      if (n < 4) fail("literals header truncated");
      uint32_t h = le32(p);
      regen = (h >> 4) & 0x3FFF;
      csize = h >> 18;
      pos = 4;
    } else {
      if (n < 5) fail("literals header truncated");
      uint64_t h = le32(p) | (uint64_t(p[4]) << 32);
      regen = (h >> 4) & 0x3FFFF;
      csize = (h >> 22) & 0x3FFFF;
      pos = 5;
    }
    if (pos + csize > n) fail("compressed literals run past the block");
    const uint8_t* q = p + pos;
    size_t qn = csize;
    if (ltype == 2) {
      size_t used = read_huffman(st.huf, q, qn);
      q += used;
      qn -= used;
    } else if (st.huf.max_bits == 0) {
      fail("treeless literals with no earlier Huffman table");
    }
    lit.resize(regen);
    if (streams == 1) {
      huffman_stream(st.huf, q, qn, lit.data(), regen);
    } else {
      if (qn < 6) fail("4-stream literals: no jump table");
      size_t s1 = le16(q), s2 = le16(q + 2), s3 = le16(q + 4);
      if (6 + s1 + s2 + s3 > qn) fail("4-stream literals: jump table past the end");
      size_t s4 = qn - 6 - s1 - s2 - s3;
      size_t part = (regen + 3) / 4;
      if (3 * part > regen) fail("4-stream literals: too few literals");
      const uint8_t* b = q + 6;
      huffman_stream(st.huf, b, s1, lit.data(), part);
      huffman_stream(st.huf, b + s1, s2, lit.data() + part, part);
      huffman_stream(st.huf, b + s1 + s2, s3, lit.data() + 2 * part, part);
      huffman_stream(st.huf, b + s1 + s2 + s3, s4, lit.data() + 3 * part,
                     regen - 3 * part);
    }
    pos += csize;
  }
  // ---- sequences section
  if (pos >= n) fail("compressed block has no sequences section");
  size_t nseq;
  uint8_t b0 = p[pos];
  if (b0 < 128) {
    nseq = b0;
    pos += 1;
  } else if (b0 < 255) {
    if (pos + 2 > n) fail("sequence count truncated");
    nseq = (size_t(b0 - 128) << 8) + p[pos + 1];
    pos += 2;
  } else {
    if (pos + 3 > n) fail("sequence count truncated");
    nseq = p[pos + 1] + (size_t(p[pos + 2]) << 8) + 0x7F00;
    pos += 3;
  }
  if (nseq == 0) {
    if (pos != n) fail("bytes after an empty sequences section");
    out.insert(out.end(), lit.begin(), lit.end());
    return;
  }
  if (pos >= n) fail("sequences section truncated");
  uint8_t modes = p[pos++];
  if (modes & 3) fail("reserved bits set in the sequence modes");
  pos += sequence_table(st.ll, modes >> 6, p + pos, n - pos, LL_DEFAULT, 36, 6, 9,
                        35, "literal-length");
  pos += sequence_table(st.of, (modes >> 4) & 3, p + pos, n - pos, OF_DEFAULT, 29,
                        5, 8, 31, "offset");
  pos += sequence_table(st.ml, (modes >> 2) & 3, p + pos, n - pos, ML_DEFAULT, 53,
                        6, 9, 52, "match-length");
  if (pos >= n) fail("sequences section has no bitstream");
  BackwardBits in(p + pos, n - pos);
  uint32_t sll = uint32_t(in.read(st.ll.log));
  uint32_t sof = uint32_t(in.read(st.of.log));
  uint32_t sml = uint32_t(in.read(st.ml.log));
  size_t lpos = 0;
  for (size_t k = 0; k < nseq; ++k) {
    const FseEntry& ell = st.ll.t[sll];
    const FseEntry& eof = st.of.t[sof];
    const FseEntry& eml = st.ml.t[sml];
    uint32_t ofcode = eof.symbol, llcode = ell.symbol, mlcode = eml.symbol;
    if (ofcode > 31) fail("offset code out of range");
    uint64_t ofvalue = (uint64_t(1) << ofcode) + in.read(ofcode);
    uint32_t ml = ML_BASE[mlcode] + uint32_t(in.read(ML_BITS[mlcode]));
    uint32_t ll = LL_BASE[llcode] + uint32_t(in.read(LL_BITS[llcode]));
    uint64_t offset;
    if (ofvalue > 3) {
      offset = ofvalue - 3;
      st.rep[2] = st.rep[1];
      st.rep[1] = st.rep[0];
      st.rep[0] = uint32_t(offset);
    } else {
      uint32_t idx = uint32_t(ofvalue) - (ll != 0 ? 1 : 0);
      if (idx == 0) {
        offset = st.rep[0];
      } else {
        offset = idx == 3 ? uint64_t(st.rep[0]) - 1 : st.rep[idx];
        if (idx != 1) st.rep[2] = st.rep[1];
        st.rep[1] = st.rep[0];
        st.rep[0] = uint32_t(offset);
      }
    }
    if (k + 1 < nseq) {  // states: literal length, match length, offset
      sll = ell.base + uint32_t(in.read(ell.bits));
      sml = eml.base + uint32_t(in.read(eml.bits));
      sof = eof.base + uint32_t(in.read(eof.bits));
    }
    if (in.overflowed()) fail("sequences bitstream overread");
    // execute: literals, then the match
    if (lpos + ll > lit.size()) fail("sequence takes more literals than decoded");
    out.insert(out.end(), lit.begin() + lpos, lit.begin() + lpos + ll);
    lpos += ll;
    size_t have = out.size() - frame_start;
    if (offset == 0 || offset > have) fail("match offset beyond the frame's output");
    size_t at = out.size(), from = at - size_t(offset);
    out.resize(at + ml);
    uint8_t* o = out.data();
    if (offset >= ml) {
      std::memcpy(o + at, o + from, ml);
    } else {  // the match overlaps its own output: byte by byte
      for (uint32_t i = 0; i < ml; ++i) o[at + i] = o[from + i];
    }
  }
  if (!in.finished()) fail("sequences bitstream not consumed exactly");
  out.insert(out.end(), lit.begin() + lpos, lit.end());
}

// one frame at src[0, n); appends to out; returns the bytes it took
size_t decode_frame(const uint8_t* src, size_t n, std::vector<uint8_t>& out) {
  if (n < 4) fail("truncated frame");
  uint32_t magic = le32(src);
  if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {  // skippable
    if (n < 8) fail("truncated skippable frame");
    uint64_t size = le32(src + 4);
    if (8 + size > n) fail("skippable frame runs past the input");
    return size_t(8 + size);
  }
  if (magic != 0xFD2FB528u) {
    char m[64];
    std::snprintf(m, sizeof m, "not a zstd frame (magic 0x%08x)", magic);
    fail(m);
  }
  size_t pos = 4;
  if (pos >= n) fail("truncated frame header");
  uint8_t fhd = src[pos++];
  int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1, checksum = (fhd >> 2) & 1,
      did_flag = fhd & 3;
  if (fhd & 8) fail("reserved bit set in the frame header");
  if (!single) {
    if (pos >= n) fail("truncated frame header");
    pos++;  // window descriptor: the whole frame is decoded in memory
  }
  static const int did_size[4] = {0, 1, 2, 4};
  uint32_t did = 0;
  if (pos + did_size[did_flag] > n) fail("truncated frame header");
  for (int i = 0; i < did_size[did_flag]; ++i) did |= uint32_t(src[pos + i]) << (8 * i);
  pos += did_size[did_flag];
  if (did != 0) fail("frame names dictionary " + std::to_string(did) +
                     ": dictionaries are not supported");
  int fcs_size = fcs_flag == 0 ? (single ? 1 : 0) : (1 << fcs_flag);
  if (pos + fcs_size > n) fail("truncated frame header");
  bool has_size = fcs_size > 0;
  uint64_t content = 0;
  if (fcs_size == 1) content = src[pos];
  if (fcs_size == 2) content = le16(src + pos) + 256;
  if (fcs_size == 4) content = le32(src + pos);
  if (fcs_size == 8) content = le64(src + pos);
  pos += fcs_size;
  const size_t start = out.size();
  if (has_size) out.reserve(start + size_t(content));
  FrameState st;
  for (;;) {
    if (pos + 3 > n) fail("truncated block header");
    uint32_t bh = le24(src + pos);
    pos += 3;
    int last = bh & 1, type = (bh >> 1) & 3;
    size_t size = bh >> 3;
    if (type == 1) {
      if (pos + 1 > n) fail("RLE block runs past the input");
      out.insert(out.end(), size, src[pos]);
      pos += 1;
    } else {
      if (pos + size > n) fail("block runs past the input");
      if (type == 0) out.insert(out.end(), src + pos, src + pos + size);
      else if (type == 2) compressed_block(st, src + pos, size, out, start);
      else fail("reserved block type");
      pos += size;
    }
    if (last) break;
  }
  if (has_size && out.size() - start != content)
    fail("frame decoded to " + std::to_string(out.size() - start) +
         " bytes, its header says " + std::to_string(content));
  if (checksum) {
    if (pos + 4 > n) fail("truncated content checksum");
    uint32_t want = le32(src + pos);
    uint32_t got = uint32_t(xxh64(out.data() + start, out.size() - start, 0));
    if (want != got) fail("content checksum mismatch");
    pos += 4;
  }
  return pos;
}

void decode_all(const uint8_t* src, size_t n, std::vector<uint8_t>& out) {
  if (n == 0) fail("no zstd frame in an empty input");
  size_t pos = 0;
  while (pos < n) pos += decode_frame(src + pos, n - pos, out);
}

void set_error(char* err, size_t cap, const char* msg) {
  if (err && cap) {
    std::strncpy(err, msg, cap - 1);
    err[cap - 1] = 0;
  }
}

}  // namespace

extern "C" {

void* zd_decompress(const uint8_t* src, size_t n, char* err, size_t cap) {
  auto* out = new std::vector<uint8_t>();
  try {
    decode_all(src, n, *out);
    return out;
  } catch (const std::exception& e) {
    set_error(err, cap, e.what());
    delete out;
    return nullptr;
  }
}

const uint8_t* zd_data(void* h) {
  return static_cast<std::vector<uint8_t>*>(h)->data();
}

size_t zd_size(void* h) { return static_cast<std::vector<uint8_t>*>(h)->size(); }

void zd_free(void* h) { delete static_cast<std::vector<uint8_t>*>(h); }

}  // extern "C"
