// fw_core.h — shared core of the native engine: murmur3, the VW text
// parser (packed u32 records), and the feature translator. Included by both
// fw_native.cpp (ingest C ABI) and fw_ffi.cpp (embedded inference C API).
// Contracts are bit-exact with the Python reference implementation
// (fwumious_wabbit_tpu/ingest/{parser,translator}.py); see fw_native.cpp for
// the full provenance notes.
#pragma once

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <limits>
#include <unordered_map>
#include <utility>
#include <vector>

namespace fwn {


constexpr uint32_t MASK31 = 0x7fffffffu;
constexpr uint32_t IS_NOT_SINGLE_MASK = 0x80000000u;
constexpr uint32_t NO_FEATURES = IS_NOT_SINGLE_MASK;
constexpr uint32_t NO_LABEL = 0xff;
constexpr uint32_t FLOAT32_ONE = 1065353216u;  // 1.0f bits
constexpr uint32_t VOWPAL_FNV_PRIME = 16777619u;
constexpr uint32_t CONSTANT_HASH = 11650396u;
constexpr int HEADER_LEN = 3;

inline uint32_t rotl32(uint32_t x, int r) { return (x << r) | (x >> (32 - r)); }

// MurmurHash3 x86_32 (reference: src/parser.rs:79-88 via fasthash)
inline uint32_t murmur3_32(const uint8_t* data, size_t len, uint32_t seed) {
  const uint32_t c1 = 0xcc9e2d51u, c2 = 0x1b873593u;
  uint32_t h = seed;
  const size_t nblocks = len / 4;
  for (size_t i = 0; i < nblocks; i++) {
    uint32_t k;
    std::memcpy(&k, data + 4 * i, 4);
    k *= c1;
    k = rotl32(k, 15);
    k *= c2;
    h ^= k;
    h = rotl32(h, 13);
    h = h * 5 + 0xe6546b64u;
  }
  const uint8_t* tail = data + nblocks * 4;
  uint32_t k = 0;
  switch (len & 3) {
    case 3: k ^= uint32_t(tail[2]) << 16; [[fallthrough]];
    case 2: k ^= uint32_t(tail[1]) << 8; [[fallthrough]];
    case 1:
      k ^= uint32_t(tail[0]);
      k *= c1;
      k = rotl32(k, 15);
      k *= c2;
      h ^= k;
  }
  h ^= uint32_t(len);
  h ^= h >> 16;
  h *= 0x85ebca6bu;
  h ^= h >> 13;
  h *= 0xc2b2ae35u;
  h ^= h >> 16;
  return h;
}

inline uint32_t f32_bits(float x) {
  uint32_t b;
  std::memcpy(&b, &x, 4);
  return b;
}
inline float bits_f32(uint32_t b) {
  float x;
  std::memcpy(&x, &b, 4);
  return x;
}

// strtof on a bounded token; "NONE" → NaN (reference: src/parser.rs parse of
// float tokens; the Python impl maps b"NONE" to nan)
inline bool parse_float_tok(const uint8_t* s, size_t len, float* out) {
  if (len == 4 && std::memcmp(s, "NONE", 4) == 0) {
    *out = std::nanf("");
    return true;
  }
  char buf[64];
  if (len == 0 || len >= sizeof(buf)) return false;
  std::memcpy(buf, s, len);
  buf[len] = 0;
  char* end = nullptr;
  *out = std::strtof(buf, &end);
  return end == buf + len;
}

struct NamespaceInfo {
  int index;        // namespace_index (slot)
  int format;       // 0 categorical, 1 f32
  uint32_t seed;    // murmur3 of the name
};

struct ComboDesc {
  std::vector<int> ns;       // namespace indices (slot or transform index)
  std::vector<int> ns_type;  // 0 primitive, 1 transformed
  float weight;
};

// One --transform statement, resolved (reference:
// src/feature_transform_implementations.rs, ingest/transforms.py).
struct TransformDef {
  enum Kind {
    BinnerSqrt,        // interpolated
    BinnerSqrtPlain,
    BinnerLog,
    BinnerLogPlain,
    BinnerLogRatio,
    BinnerLogRatioPlain,
    Weight,
    Combine,
  };
  int kind = 0;
  std::vector<int> from;       // namespace indices
  std::vector<int> from_type;  // 0 primitive, 1 transformed
  float p0 = 0.0f;             // greater_than / multiplier
  float p1 = 1.0f;             // resolution
  uint32_t seeds[5] = {};      // per-target 5-seed set
};

struct FfmFieldDesc {
  std::vector<int> ns;
  std::vector<int> ns_type;
};

struct Config {
  int num_namespaces = 0;
  std::unordered_map<std::string, NamespaceInfo> lookup;
  // direct table for single-byte namespace names (the overwhelmingly common
  // case — the reference uses a radix tree for the same reason,
  // reference: src/radix_tree.rs:33-64); index = byte value, .index < 0 =
  // not a 1-char name
  NamespaceInfo char1[256] = {};
  void finalize_lookup() {
    for (auto& e : char1) e.index = -1;
    for (const auto& [name, info] : lookup)
      if (name.size() == 1) char1[uint8_t(name[0])] = info;
  }
  const NamespaceInfo* find(const uint8_t* name, size_t len) const {
    if (len == 1) {
      const NamespaceInfo& e = char1[name[0]];
      return e.index >= 0 ? &e : nullptr;
    }
    auto it = lookup.find(std::string(reinterpret_cast<const char*>(name), len));
    return it == lookup.end() ? nullptr : &it->second;
  }
  int skip_prefix = 0;
  std::vector<ComboDesc> combos;
  bool add_constant = true;
  uint32_t lr_mask = 0, ffm_mask = 0;
  std::vector<FfmFieldDesc> ffm_fields;
  std::vector<TransformDef> transforms;
  int num_threads = 1;
  bool build_records = true;  // false: skip accumulating packed records (no cache)
};

using Feats = std::vector<std::pair<uint32_t, float>>;

// Per-example translated features, SoA within one shard.
struct Shard {
  // parsed packed records, concatenated (for cache writing)
  std::vector<uint32_t> records;
  // per example
  std::vector<float> label, importance;
  std::vector<int32_t> lr_start, ffm_start;  // offsets into feature arrays
  std::vector<uint32_t> lr_ids;
  std::vector<float> lr_vals;
  std::vector<int32_t> lr_combos;
  std::vector<uint32_t> ffm_ids;
  std::vector<float> ffm_vals;
  std::vector<int32_t> ffm_fields;
  std::string error;
  // combo-chain scratch for translate_record: lives here (the Shard is
  // already per-thread) instead of function-scope thread_local — dynamic
  // TLS lookups (__tls_get_addr) measured ~7% of ingest CPU
  Feats scr_cur, scr_feats, scr_nxt;
  void clear() {
    records.clear();
    label.clear();
    importance.clear();
    lr_start.clear();
    ffm_start.clear();
    lr_ids.clear();
    lr_vals.clear();
    lr_combos.clear();
    ffm_ids.clear();
    ffm_vals.clear();
    ffm_fields.clear();
    error.clear();
  }
};

struct Ctx {
  Config cfg;
  std::vector<Shard> shards;
  // examples carried across translate calls (fwn_carry_tail): a block's
  // sub-batch remainder re-appears at index 0 of the next block, so batch
  // boundaries stop depending on the caller's chunking
  Shard carry;
  std::string error;
  int64_t n_examples = 0;
  int64_t records_consumed = 0;
  int lr_max = 0, ffm_max = 0;
  // fwn_all_ones result for the CURRENT block, computed lazily once per
  // translate (-1 = stale). The flags query is per-batch in the hot loop;
  // rescanning the whole block's value arrays per call measured 21% of
  // ingest time at B=32k.
  int all_ones_cache = -1;
  // byte offset of the empty line that ended the last translated block
  // (an empty line = end-of-stream, reference src/main.rs:215-222), or -1.
  // Detected during the parse walk itself — the former Python-side
  // bytes.find pre-scans for "\n\n"/"\n\r\n" cost ~9% of ingest.
  int64_t stop_offset = -1;
};

// ---------------------------------------------------------------------------
// parser: one line → packed u32 record appended to rec
// (bit-exact port of the contract in ingest/parser.py / reference
// src/parser.rs:214-461)
// ---------------------------------------------------------------------------

enum class LineKind { Example, Empty, Flush, HogwildLoad, Error };

inline LineKind parse_line(const Config& cfg, const uint8_t* line, size_t n,
                    std::vector<uint32_t>& rec, std::string& err) {
  while (n && (line[n - 1] == '\n' || line[n - 1] == '\r')) n--;
  if (n == 0) return LineKind::Empty;

  const size_t base = rec.size();
  rec.resize(base + HEADER_LEN + cfg.num_namespaces);
  for (int i = 0; i < cfg.num_namespaces; i++)
    rec[base + HEADER_LEN + i] = NO_FEATURES;
  rec[base] = 0;

  uint8_t first = line[0];
  if (first == '1') {
    rec[base + 1] = 1;
  } else if (first == '-') {
    rec[base + 1] = 0;
  } else if (first == '|') {
    rec[base + 1] = NO_LABEL;
  } else if (n >= 5 && std::memcmp(line, "flush", 5) == 0) {
    rec.resize(base);
    return LineKind::Flush;
  } else if (n > 13 && std::memcmp(line, "hogwild_load ", 13) == 0) {
    rec.resize(base);
    return LineKind::HogwildLoad;
  } else {
    rec.resize(base);
    err = "Cannot parse an example";
    return LineKind::Error;
  }

  size_t pos = 0;
  if (rec[base + 1] == NO_LABEL) {
    rec[base + 2] = FLOAT32_ONE;
  } else {
    while (pos < n && line[pos] != ' ') pos++;
    while (pos < n && line[pos] == ' ') pos++;
    if (pos < n && line[pos] == '|') {
      rec[base + 2] = FLOAT32_ONE;
    } else {
      size_t start = pos;
      while (pos < n && line[pos] != ' ') pos++;
      float imp;
      if (!parse_float_tok(line + start, pos - start, &imp)) {
        rec.resize(base);
        err = "Failed parsing example importance";
        return LineKind::Error;
      }
      if (imp < 0.0f) {
        rec.resize(base);
        err = "Example importance cannot be negative";
        return LineKind::Error;
      }
      rec[base + 2] = f32_bits(imp);
    }
  }

  while (pos < n && line[pos] != '|') pos++;

  uint32_t cur_seed = 0;
  size_t cur_slot = base + HEADER_LEN;
  int cur_format = 0;
  float cur_ns_weight = 1.0f;
  int cur_num_features = 0;
  size_t ns_tail_start = 0;

  while (pos < n) {
    while (pos < n && line[pos] == ' ') pos++;
    size_t start = pos;
    while (pos < n && line[pos] != ' ' && line[pos] != ':') pos++;
    size_t end_first = pos;
    while (pos < n && line[pos] != ' ') pos++;
    size_t end = pos;
    if (start >= n) break;

    if (line[start] == '|') {
      if (end_first != end) {
        if (!parse_float_tok(line + end_first + 1, end - end_first - 1,
                             &cur_ns_weight)) {
          rec.resize(base);
          err = "Failed parsing namespace weight";
          return LineKind::Error;
        }
      } else {
        cur_ns_weight = 1.0f;
      }
      const NamespaceInfo* info =
          cfg.find(line + start + 1, end_first - start - 1);
      if (!info) {
        rec.resize(base);
        err = "Feature name was not predeclared in vw_namespace_map.csv: " +
              std::string(reinterpret_cast<const char*>(line + start + 1),
                          end_first - start - 1);
        return LineKind::Error;
      }
      cur_seed = info->seed;
      cur_slot = base + HEADER_LEN + info->index;
      cur_format = info->format;
      cur_num_features = 0;
      ns_tail_start = rec.size() - base;
    } else {
      uint32_t h = murmur3_32(line + start, end_first - start, cur_seed) & MASK31;
      float feat_weight = 1.0f;
      if (end_first != end) {
        if (!parse_float_tok(line + end_first + 1, end - end_first - 1,
                             &feat_weight)) {
          rec.resize(base);
          err = "Failed parsing feature weight";
          return LineKind::Error;
        }
      }
      if (cur_num_features == 0 && cur_format == 0 && cur_ns_weight == 1.0f &&
          feat_weight == 1.0f) {
        rec[cur_slot] = h;
      } else {
        uint32_t slot_val = rec[cur_slot];
        if (cur_num_features == 1 && (slot_val & IS_NOT_SINGLE_MASK) == 0) {
          rec.push_back(slot_val);
          rec.push_back(FLOAT32_ONE);
        }
        rec.push_back(h);
        if (cur_format == 1) {
          size_t fstart = start + cfg.skip_prefix;
          float fval;
          if (end_first != fstart) {
            if (!parse_float_tok(line + fstart, end_first - fstart, &fval)) {
              rec.resize(base);
              err = "Failed parsing feature value to float (for float namespace)";
              return LineKind::Error;
            }
          } else {
            fval = std::nanf("");
          }
          rec.push_back(f32_bits(fval));
          if (cur_ns_weight * feat_weight != 1.0f) {
            rec.resize(base);
            err = "Namespaces that are f32 can not have weight attached";
            return LineKind::Error;
          }
        } else {
          rec.push_back(f32_bits(cur_ns_weight * feat_weight));
        }
        rec[cur_slot] =
            IS_NOT_SINGLE_MASK |
            uint32_t((ns_tail_start << 16) + (rec.size() - base));
      }
      cur_num_features++;
    }
    pos++;
  }
  rec[base] = uint32_t(rec.size() - base);
  return LineKind::Example;
}

// ---------------------------------------------------------------------------
// translator: packed record → LR/FFM feature lists
// (port of ingest/translator.py / reference src/feature_buffer.rs:137-338)
// ---------------------------------------------------------------------------

// Two-record view for partial-evaluation serving (fw_ffi.cpp 3-call cache):
// a namespace slot declared in the ``delta`` record REPLACES the primary
// record's slot — exactly what re-declaring a namespace later on the same
// line does in parse_line (the later declaration overwrites the slot), so
// translating a (context, delta) pair through this view is equivalent to
// parsing the concatenated line. ``delta == nullptr`` (the ingest hot path)
// reads the primary record only.
struct RecView {
  const uint32_t* primary;
  const uint32_t* delta = nullptr;

  const uint32_t* rec(int slot) const {
    if (delta && delta[HEADER_LEN + slot] != NO_FEATURES) return delta;
    return primary;
  }
};

// append (hash, value) pairs of one primitive namespace from a record.
// Tail offsets are clamped to the record length so a corrupted cache file
// cannot cause out-of-bounds reads.
inline void read_primitive(const RecView& view, int slot, int format,
                           Feats& out) {
  const uint32_t* rec = view.rec(slot);
  uint32_t tok = rec[HEADER_LEN + slot];
  if ((tok & IS_NOT_SINGLE_MASK) == 0) {
    out.emplace_back(tok, 1.0f);
    return;
  }
  if (tok == NO_FEATURES) return;
  uint32_t start = (tok >> 16) & 0x3fff;
  uint32_t end = tok & 0xffff;
  uint32_t reclen = rec[0];
  if (end > reclen) end = reclen;
  for (uint32_t off = start; off + 1 < end; off += 2) {
    float v = format == 1 ? 1.0f : bits_f32(rec[off + 1]);
    out.emplace_back(rec[off], v);
  }
}

// ---------------------------------------------------------------------------
// feature transforms (reference: src/feature_transform_executor.rs:49-94,
// src/feature_transform_implementations.rs; semantics oracle:
// ingest/transforms.py — the emission order and float-width choices below
// mirror it operation for operation)
// ---------------------------------------------------------------------------

inline void emit_i32(uint32_t seed, uint32_t to_data, double value, Feats& out) {
  uint8_t b[4] = {uint8_t(to_data), uint8_t(to_data >> 8),
                  uint8_t(to_data >> 16), uint8_t(to_data >> 24)};
  out.emplace_back(murmur3_32(b, 4, seed) & MASK31, float(value));
}

inline void emit_i32_i32(uint32_t seed, uint32_t d1, uint32_t d2, double value,
                         Feats& out) {
  uint8_t b[4] = {uint8_t(d1), uint8_t(d1 >> 8), uint8_t(d1 >> 16),
                  uint8_t(d1 >> 24)};
  uint32_t h1 = murmur3_32(b, 4, seed);
  uint8_t c[4] = {uint8_t(d2), uint8_t(d2 >> 8), uint8_t(d2 >> 16),
                  uint8_t(d2 >> 24)};
  out.emplace_back(murmur3_32(c, 4, h1) & MASK31, float(value));
}

// f32-truncate-toward-zero as u32 two's complement (int(np.float32(f)))
inline uint32_t trunc_f32_u32(double f) {
  return uint32_t(int64_t(float(f)));
}

inline void emit_f32(uint32_t seed, double f, double value, bool interpolated,
                     Feats& out) {
  if (!std::isfinite(f)) {
    emit_i32(seed, f32_bits(float(f)), value, out);
  } else if (interpolated) {
    double fl = std::floor(f);
    double part = f - fl;
    if (part != 0.0) emit_i32(seed, uint32_t(int64_t(fl) + 1), value * part, out);
    part = 1.0 - part;
    if (part != 0.0) emit_i32(seed, uint32_t(int64_t(fl)), value * part, out);
  } else {
    emit_i32(seed, trunc_f32_u32(f), value, out);
  }
}

inline double safe_ln(double x) {
  if (x > 0.0) return std::log(x);
  if (x == 0.0) return -std::numeric_limits<double>::infinity();
  return std::nan("");
}

// float values of an f32 namespace (feature_reader_float_namespace!,
// reference: src/feature_buffer.rs:110-135) — hash_value is always 1.0
inline void read_float_ns(const RecView& view, int slot,
                          std::vector<float>& out) {
  out.clear();
  const uint32_t* rec = view.rec(slot);
  uint32_t tok = rec[HEADER_LEN + slot];
  if ((tok & IS_NOT_SINGLE_MASK) == 0 || tok == NO_FEATURES) return;
  uint32_t start = (tok >> 16) & 0x3fff;
  uint32_t end = tok & 0xffff;
  uint32_t reclen = rec[0];
  if (end > reclen) end = reclen;
  for (uint32_t off = start; off + 1 < end; off += 2)
    out.push_back(bits_f32(rec[off + 1]));
}

inline void read_features(const Config& cfg, const RecView& view,
                          const std::vector<int>& formats, int idx, int type,
                          Feats& out);

// 5 precomputed murmur3 seeds per transformed namespace
// (reference: src/feature_transform_executor.rs:17-27)
inline void fill_transform_seeds(TransformDef& t, int to_namespace_index) {
  uint32_t seed = uint32_t(to_namespace_index) ^ 0x80000000u;
  const uint8_t quads[5][4] = {{214, 231, 1, 55},
                               {255, 6, 14, 69},
                               {50, 6, 71, 123},
                               {10, 3, 0, 43},
                               {0, 53, 10, 201}};
  for (int i = 0; i < 5; i++) t.seeds[i] = murmur3_32(quads[i], 4, seed);
}

inline void run_transform(const Config& cfg, const RecView& view,
                          const std::vector<int>& formats, int tidx,
                          Feats& out) {
  const TransformDef& t = cfg.transforms[tidx];
  switch (t.kind) {
    case TransformDef::BinnerSqrt:
    case TransformDef::BinnerSqrtPlain:
    case TransformDef::BinnerLog:
    case TransformDef::BinnerLogPlain: {
      bool is_sqrt = t.kind == TransformDef::BinnerSqrt ||
                     t.kind == TransformDef::BinnerSqrtPlain;
      bool interp = t.kind == TransformDef::BinnerSqrt ||
                    t.kind == TransformDef::BinnerLog;
      std::vector<float> vals;
      read_float_ns(view, t.from[0], vals);
      for (float v : vals) {
        if (v < t.p0) {
          emit_i32(t.seeds[0], trunc_f32_u32(v), 1.0, out);
        } else {
          double x = double(v) - double(t.p0);
          // python's math.log raises at 0 → NaN (C log would give -inf)
          double fx = is_sqrt ? std::sqrt(x)
                              : (x == 0.0 ? std::nan("") : std::log(x));
          float tr = float(fx) * t.p1;
          emit_f32(t.seeds[1], double(tr), 1.0, interp, out);
        }
      }
      break;
    }
    case TransformDef::BinnerLogRatio:
    case TransformDef::BinnerLogRatioPlain: {
      bool interp = t.kind == TransformDef::BinnerLogRatio;
      std::vector<float> v1s, v2s;
      read_float_ns(view, t.from[0], v1s);
      read_float_ns(view, t.from[1], v2s);
      for (float v1 : v1s)
        for (float v2 : v2s) {
          if (double(v2) + double(v1) < double(t.p0)) {
            emit_i32_i32(t.seeds[1], trunc_f32_u32(v1), trunc_f32_u32(v2),
                         1.0, out);
          } else if (v1 == 0.0f) {
            emit_f32(t.seeds[2], safe_ln(double(v2) - double(t.p0)), 1.0,
                     interp, out);
          } else if (v2 == 0.0f) {
            emit_f32(t.seeds[3], safe_ln(double(v1) - double(t.p0)), 1.0,
                     interp, out);
          } else {
            double o = safe_ln(double(v1) / double(v2)) * double(t.p1);
            emit_f32(t.seeds[0], o, 1.0, interp, out);
          }
        }
      break;
    }
    case TransformDef::Weight: {
      Feats local;  // plain local: the source may itself be transformed
      read_features(cfg, view, formats, t.from[0], t.from_type[0], local);
      for (const auto& [h, v] : local)
        emit_i32(t.seeds[0], h, double(v) * double(t.p0), out);
      break;
    }
    case TransformDef::Combine: {
      // cartesian XOR-combine of 2..4 namespaces
      std::vector<Feats> parts(t.from.size());
      for (size_t i = 0; i < t.from.size(); i++)
        read_features(cfg, view, formats, t.from[i], t.from_type[i], parts[i]);
      // recursive cartesian, depth ≤ 4
      struct Rec {
        const std::vector<Feats>& parts;
        uint32_t seed;
        Feats& out;
        void go(size_t i, uint32_t acc_h, double acc_v) {
          if (i == parts.size()) {
            emit_i32(seed, acc_h, acc_v, out);
            return;
          }
          for (const auto& [h, v] : parts[i]) go(i + 1, acc_h ^ h, acc_v * v);
        }
      } r{parts, t.seeds[0], out};
      r.go(0, 0, 1.0);
      break;
    }
  }
}

inline void read_features(const Config& cfg, const RecView& view,
                          const std::vector<int>& formats, int idx, int type,
                          Feats& out) {
  if (type == 1) {
    run_transform(cfg, view, formats, idx, out);
    return;
  }
  read_primitive(view, idx, formats[idx], out);
}

inline void translate_record(const Config& cfg, const uint32_t* rec,
                      const std::vector<int>& formats, Shard& sh,
                      bool ffm_primitive_only = false) {
  // NO_LABEL stays 255.0, mirroring the Python translator (unlabeled lines
  // only occur on predict paths where the label is unused)
  sh.label.push_back(float(rec[1]));
  sh.importance.push_back(bits_f32(rec[2]));
  sh.lr_start.push_back(int32_t(sh.lr_ids.size()));
  sh.ffm_start.push_back(int32_t(sh.ffm_ids.size()));

  Feats& feats = sh.scr_feats;
  Feats& cur = sh.scr_cur;
  Feats& nxt = sh.scr_nxt;
  const RecView view{rec, nullptr};

  int combo_index = 0;
  for (const auto& combo : cfg.combos) {
    cur.clear();
    read_features(cfg, view, formats, combo.ns[0], combo.ns_type[0], cur);
    for (size_t d = 1; d < combo.ns.size(); d++) {
      feats.clear();
      read_features(cfg, view, formats, combo.ns[d], combo.ns_type[d], feats);
      nxt.clear();
      for (const auto& [h_acc, v_acc] : cur) {
        uint32_t half = h_acc * VOWPAL_FNV_PRIME;
        for (const auto& [h, v] : feats)
          nxt.emplace_back(h ^ half, v_acc * v);
      }
      std::swap(cur, nxt);
    }
    for (const auto& [h, v] : cur) {
      sh.lr_ids.push_back(h & cfg.lr_mask);
      sh.lr_vals.push_back(v * combo.weight);
      sh.lr_combos.push_back(combo_index);
    }
    combo_index++;
  }
  if (cfg.add_constant) {
    sh.lr_ids.push_back(CONSTANT_HASH & cfg.lr_mask);
    sh.lr_vals.push_back(1.0f);
    sh.lr_combos.push_back(int32_t(cfg.combos.size()));
  }
  if (!cfg.ffm_fields.empty()) {
    int field_index = 0;
    for (const auto& field : cfg.ffm_fields) {
      for (size_t d = 0; d < field.ns.size(); d++) {
        if (ffm_primitive_only && field.ns_type[d] != 0) continue;
        feats.clear();
        read_features(cfg, view, formats, field.ns[d], field.ns_type[d], feats);
        for (const auto& [h, v] : feats) {
          sh.ffm_ids.push_back(h & cfg.ffm_mask);
          sh.ffm_vals.push_back(v);
          sh.ffm_fields.push_back(field_index);
        }
      }
      field_index++;
    }
  }
}

}  // namespace fwn
