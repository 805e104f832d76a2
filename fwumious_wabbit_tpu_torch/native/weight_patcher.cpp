// weight_patcher — byte-level model-file diff/patch tool.
//
// Reimplements the reference's standalone patcher binary
// (reference: weight_patcher/src/main.rs:52-266) with the identical on-disk
// format, so diffs interoperate both ways:
//   gzip stream of entries, each entry =
//     LEB128 varint (index delta from the previous mismatch; the first
//     entry's value is the absolute index) followed by ONE raw byte (the
//     new value from file B).
// Files A and B must be the same size (successive checkpoints of the same
// model are). Used to ship frequent model updates as small patches.
//
// CLI:
//   weight_patcher create_diff <file_a> <file_b> <diff_out>
//   weight_patcher recreate    <file_a> <diff>   <file_out>

#include <zlib.h>

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

constexpr size_t CHUNK = 1 << 20;

void write_varint(std::vector<uint8_t>& out, uint64_t value) {
  while (value >= 0x80) {
    out.push_back(uint8_t(value & 0x7f) | 0x80);
    value >>= 7;
  }
  out.push_back(uint8_t(value));
}

int create_diff(const char* a_path, const char* b_path, const char* diff_path) {
  FILE* fa = std::fopen(a_path, "rb");
  FILE* fb = std::fopen(b_path, "rb");
  if (!fa || !fb) {
    std::fprintf(stderr, "cannot open input files\n");
    return 1;
  }
  gzFile gz = gzopen(diff_path, "wb6");
  if (!gz) {
    std::fprintf(stderr, "cannot open %s\n", diff_path);
    return 1;
  }
  std::vector<uint8_t> buf_a(CHUNK), buf_b(CHUNK), out;
  out.reserve(CHUNK);
  uint64_t position = 0, prev_index = 0;
  for (;;) {
    size_t na = std::fread(buf_a.data(), 1, CHUNK, fa);
    size_t nb = std::fread(buf_b.data(), 1, CHUNK, fb);
    if (na == 0 && nb == 0) break;
    size_t n = na > nb ? na : nb;
    for (size_t i = 0; i < n; i++) {
      // past-EOF bytes compare unequal; B's byte defaults to 0, mirroring the
      // reference's Option handling (weight_patcher/src/main.rs:96-106)
      uint8_t av = i < na ? buf_a[i] : 0, bv = i < nb ? buf_b[i] : 0;
      bool differs = (i >= na) != (i >= nb) || av != bv;
      if (differs) {
        uint64_t cur = position + i;
        write_varint(out, cur - prev_index);
        out.push_back(bv);
        prev_index = cur;
      }
    }
    position += n;
    if (out.size() >= CHUNK) {
      gzwrite(gz, out.data(), unsigned(out.size()));
      out.clear();
    }
  }
  if (!out.empty()) gzwrite(gz, out.data(), unsigned(out.size()));
  gzclose(gz);
  std::fclose(fa);
  std::fclose(fb);
  return 0;
}

struct DiffReader {
  gzFile gz;
  std::vector<uint8_t> buf;
  size_t pos = 0, len = 0;
  bool refill() {
    int n = gzread(gz, buf.data(), unsigned(buf.size()));
    if (n <= 0) return false;
    len = size_t(n);
    pos = 0;
    return true;
  }
  bool byte(uint8_t* out) {
    if (pos >= len && !refill()) return false;
    *out = buf[pos++];
    return true;
  }
  bool varint(uint64_t* out) {
    uint64_t v = 0;
    int shift = 0;
    uint8_t b;
    for (;;) {
      if (!byte(&b)) return false;
      v |= uint64_t(b & 0x7f) << shift;
      if ((b & 0x80) == 0) break;
      shift += 7;
    }
    *out = v;
    return true;
  }
};

int recreate(const char* a_path, const char* diff_path, const char* out_path) {
  FILE* fa = std::fopen(a_path, "rb");
  FILE* fo = std::fopen(out_path, "wb");
  if (!fa || !fo) {
    std::fprintf(stderr, "cannot open files\n");
    return 1;
  }
  DiffReader dr{gzopen(diff_path, "rb"), std::vector<uint8_t>(CHUNK)};
  if (!dr.gz) {
    std::fprintf(stderr, "cannot open %s\n", diff_path);
    return 1;
  }

  uint64_t next_index = 0;
  uint8_t next_byte = 0;
  bool have_entry = dr.varint(&next_index) && dr.byte(&next_byte);

  std::vector<uint8_t> buf(CHUNK);
  uint64_t position = 0;
  for (;;) {
    size_t n = std::fread(buf.data(), 1, CHUNK, fa);
    if (n == 0) break;
    for (size_t i = 0; i < n; i++, position++) {
      if (have_entry && position == next_index) {
        buf[i] = next_byte;
        uint64_t delta = 0;
        have_entry = dr.varint(&delta) && dr.byte(&next_byte);
        next_index += delta;
      }
    }
    std::fwrite(buf.data(), 1, n, fo);
  }
  gzclose(dr.gz);
  std::fclose(fa);
  std::fclose(fo);
  return 0;
}

}  // namespace

int main(int argc, char** argv) {
  if (argc == 5 && std::strcmp(argv[1], "create_diff") == 0)
    return create_diff(argv[2], argv[3], argv[4]);
  if (argc == 5 && std::strcmp(argv[1], "recreate") == 0)
    return recreate(argv[2], argv[3], argv[4]);
  std::fprintf(stderr,
               "usage: weight_patcher create_diff <file_a> <file_b> <diff>\n"
               "       weight_patcher recreate    <file_a> <diff> <out>\n");
  return 2;
}
