// fw_native — the C++ host ingest engine: VW text parsing, feature
// translation and fixed-shape batch assembly, multi-threaded.
//
// This is the native equivalent of the reference's hot host path
// (reference: src/parser.rs:214-461 byte-level record parsing,
// src/feature_buffer.rs:137-338 combo/field translation) re-shaped for
// batched TPU consumption: instead of one packed record at a time feeding a
// per-example learner, a *block* of text lines is parsed and translated in
// parallel into structure-of-arrays feature lists, which are then scattered
// into dense padded [B, L] / [B, N] arrays the device consumes directly.
//
// Contracts kept bit-exact with the Python reference implementation
// (fwumious_wabbit_tpu/ingest/parser.py, translator.py) and hence with the
// reference engine:
//   * murmur3_32 feature hashing seeded by murmur3 of the namespace name
//   * the packed u32 record layout [len, label, importance, slots..., tail]
//   * VW FNV-prime interaction chaining, 2^bits masking, constant feature
//
// Exposed via a C ABI consumed with ctypes (no pybind11 in this image).

#include <atomic>
#include <cmath>
#if defined(__F16C__)
#include <immintrin.h>
#endif
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

#include "fw_core.h"

using namespace fwn;


// ---------------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------------

extern "C" {

void* fwn_create(int num_namespaces, const char* ns_names,
                 const int* ns_name_lens, const int* ns_indices,
                 const int* ns_formats, int skip_prefix, int num_combos,
                 const int* combo_offsets, const int* combo_ns,
                 const int* combo_ns_types, const float* combo_weights,
                 int add_constant, uint32_t lr_mask, uint32_t ffm_mask,
                 int num_ffm_fields, const int* field_offsets,
                 const int* field_ns, const int* field_ns_types,
                 int num_transforms, const int* t_kinds, const float* t_p0,
                 const float* t_p1, const int* t_from_offsets,
                 const int* t_from, const int* t_from_types,
                 int num_threads) {
  auto* ctx = new Ctx();
  Config& c = ctx->cfg;
  c.num_namespaces = num_namespaces;
  c.skip_prefix = skip_prefix;
  const char* p = ns_names;
  // num_namespaces is the SLOT count; the name table (one entry per declared
  // name, both short and verbose forms) is sized by ns_name_lens[0], with
  // per-name lengths at ns_name_lens[1..].
  int num_names = ns_name_lens[0];
  for (int i = 0; i < num_names; i++) {
    int len = ns_name_lens[1 + i];
    std::string name(p, len);
    p += len;
    c.lookup[name] = NamespaceInfo{
        ns_indices[i], ns_formats[i],
        murmur3_32(reinterpret_cast<const uint8_t*>(name.data()), name.size(), 0)};
  }
  for (int i = 0; i < num_combos; i++) {
    ComboDesc d;
    for (int j = combo_offsets[i]; j < combo_offsets[i + 1]; j++) {
      d.ns.push_back(combo_ns[j]);
      d.ns_type.push_back(combo_ns_types[j]);
    }
    d.weight = combo_weights[i];
    c.combos.push_back(std::move(d));
  }
  c.add_constant = add_constant != 0;
  c.lr_mask = lr_mask;
  c.ffm_mask = ffm_mask;
  for (int i = 0; i < num_ffm_fields; i++) {
    FfmFieldDesc f;
    for (int j = field_offsets[i]; j < field_offsets[i + 1]; j++) {
      f.ns.push_back(field_ns[j]);
      f.ns_type.push_back(field_ns_types[j]);
    }
    c.ffm_fields.push_back(std::move(f));
  }
  for (int i = 0; i < num_transforms; i++) {
    TransformDef t;
    t.kind = t_kinds[i];
    t.p0 = t_p0[i];
    t.p1 = t_p1[i];
    for (int j = t_from_offsets[i]; j < t_from_offsets[i + 1]; j++) {
      t.from.push_back(t_from[j]);
      t.from_type.push_back(t_from_types[j]);
    }
    fill_transform_seeds(t, i);
    c.transforms.push_back(std::move(t));
  }
  c.num_threads = num_threads > 0 ? num_threads : 1;
  c.finalize_lookup();
  ctx->shards.resize(c.num_threads);
  return ctx;
}

void fwn_destroy(void* p) { delete static_cast<Ctx*>(p); }

const char* fwn_last_error(void* p) {
  return static_cast<Ctx*>(p)->error.c_str();
}

// formats per slot (built once per ctx) — slot -> format
static std::vector<int> slot_formats(const Config& c) {
  std::vector<int> formats(c.num_namespaces, 0);
  for (const auto& [name, info] : c.lookup) formats[info.index] = info.format;
  return formats;
}

// Parse + translate a block of newline-separated examples. Returns the
// number of examples, or -1 on error (see fwn_last_error). In-band command
// lines (flush / hogwild_load) are ERRORS in file mode, exactly like the
// reference (src/main.rs:218-221 propagates the parser's command "error"
// and the run exits); they are only meaningful on the serving socket.
int64_t fwn_translate_block(void* p, const char* buf, int64_t len) {
  auto* ctx = static_cast<Ctx*>(p);
  ctx->all_ones_cache = -1;
  ctx->stop_offset = -1;
  const Config& cfg = ctx->cfg;
  const auto* data = reinterpret_cast<const uint8_t*>(buf);

  // split into per-thread line ranges
  int T = cfg.num_threads;
  std::vector<std::pair<int64_t, int64_t>> ranges;
  int64_t chunk = len / T + 1;
  int64_t s = 0;
  for (int t = 0; t < T && s < len; t++) {
    int64_t e = s + chunk;
    if (e >= len) {
      e = len;
    } else {
      while (e < len && data[e - 1] != '\n') e++;
    }
    ranges.emplace_back(s, e);
    s = e;
  }
  T = int(ranges.size());

  auto formats = slot_formats(cfg);
  // end-of-stream / abort resolution by BYTE OFFSET: an empty line ends the
  // stream (reference src/main.rs:215-222), an in-band command or parse
  // error aborts — but only if it occurs BEFORE the earliest empty line
  // (content after the end-of-stream marker is never "seen"). Each shard
  // CAS-mins the offset of what it hit; shards whose range lies past the
  // earliest stop exit early and are discarded after the join.
  std::atomic<int64_t> stop_min{INT64_MAX}, err_min{INT64_MAX};
  auto cas_min = [](std::atomic<int64_t>& a, int64_t v) {
    int64_t cur = a.load(std::memory_order_relaxed);
    while (v < cur &&
           !a.compare_exchange_weak(cur, v, std::memory_order_relaxed)) {
    }
  };
  std::vector<int64_t> shard_err_off(size_t(T), INT64_MAX);

  // clear up front (not inside work): examples carried from the previous
  // block (fwn_carry_tail) lead shard 0, and the parse threads APPEND
  for (auto& sh : ctx->shards) sh.clear();
  if (!ctx->carry.label.empty()) {
    std::swap(ctx->shards[0], ctx->carry);
    ctx->carry.clear();
  }

  auto work = [&](int t) {
    Shard& sh = ctx->shards[t];
    auto [rs, re] = ranges[t];
    int64_t i = rs;
    std::vector<uint32_t> scratch;  // reused per line when records not kept
    while (i < re && i < stop_min.load(std::memory_order_relaxed) &&
           i < err_min.load(std::memory_order_relaxed)) {
      // memchr: libc's SIMD scan beats the byte loop on ~120-byte lines
      const void* nl = std::memchr(data + i, '\n', size_t(re - i));
      int64_t j = nl ? int64_t(static_cast<const uint8_t*>(nl) - data) : re;
      std::vector<uint32_t>& rec = cfg.build_records ? sh.records : scratch;
      if (!cfg.build_records) rec.clear();
      size_t rec_base = rec.size();
      std::string err;
      LineKind kind = parse_line(cfg, data + i, size_t(j - i), rec, err);
      if (kind == LineKind::Example) {
        translate_record(cfg, rec.data() + rec_base, formats, sh);
      } else if (kind == LineKind::Empty) {
        cas_min(stop_min, i);
        return;
      } else if (kind == LineKind::Flush) {
        sh.error = "Not really an error: a \"flush\" command from client";
        shard_err_off[t] = i;
        cas_min(err_min, i);
        return;
      } else if (kind == LineKind::HogwildLoad) {
        sh.error =
            "Not really an error: a \"hogwild_load\" command from client";
        shard_err_off[t] = i;
        cas_min(err_min, i);
        return;
      } else if (kind == LineKind::Error) {
        sh.error = err;
        shard_err_off[t] = i;
        cas_min(err_min, i);
        return;
      }
      i = j + 1;
    }
  };

  if (T == 1) {
    work(0);
  } else {
    std::vector<std::thread> threads;
    for (int t = 0; t < T; t++) threads.emplace_back(work, t);
    for (auto& th : threads) th.join();
  }
  // (all shards were cleared up front; shard 0 may hold carried examples
  // even when T == 0 — an empty input flushes the carry)

  const int64_t stop = stop_min.load(std::memory_order_relaxed);
  const int64_t aerr = err_min.load(std::memory_order_relaxed);
  if (aerr < stop) {
    for (int t = 0; t < T; t++) {
      if (shard_err_off[t] == aerr) {
        ctx->error = ctx->shards[t].error;
        return -1;
      }
    }
  }
  if (stop != INT64_MAX) {
    ctx->stop_offset = stop;
    // shards whose whole range lies after the stop parsed post-EOF bytes
    for (int t = 0; t < T; t++) {
      if (ranges[t].first > stop) ctx->shards[t].clear();
    }
  } else {
    ctx->stop_offset = -1;
  }

  int64_t n = 0;
  int lr_max = 0, ffm_max = 0;
  for (auto& sh : ctx->shards) {
    size_t m = sh.label.size();
    sh.lr_start.push_back(int32_t(sh.lr_ids.size()));
    sh.ffm_start.push_back(int32_t(sh.ffm_ids.size()));
    for (size_t i = 0; i < m; i++) {
      lr_max = std::max(lr_max, int(sh.lr_start[i + 1] - sh.lr_start[i]));
      ffm_max = std::max(ffm_max, int(sh.ffm_start[i + 1] - sh.ffm_start[i]));
    }
    n += int64_t(m);
  }
  ctx->n_examples = n;
  ctx->lr_max = lr_max;
  ctx->ffm_max = ffm_max;
  return n;
}

// Translate pre-parsed packed u32 records (the cache read path). A partial
// trailing record is left unconsumed (fwn_records_consumed reports how many
// words were processed); callers carry the tail into the next chunk.
int64_t fwn_translate_records(void* p, const uint32_t* recs, int64_t words) {
  auto* ctx = static_cast<Ctx*>(p);
  ctx->all_ones_cache = -1;
  ctx->stop_offset = -1;
  const Config& cfg = ctx->cfg;
  auto formats = slot_formats(cfg);
  for (auto& sh : ctx->shards) sh.clear();
  Shard& sh = ctx->shards[0];
  if (!ctx->carry.label.empty()) {  // carried examples lead the block
    std::swap(ctx->shards[0], ctx->carry);
    ctx->carry.clear();
  }
  int64_t off = 0;
  while (off < words) {
    uint32_t reclen = recs[off];
    if (reclen < uint32_t(HEADER_LEN + cfg.num_namespaces)) {
      ctx->error = "corrupt record stream";
      return -1;
    }
    if (off + int64_t(reclen) > words) break;  // partial trailing record
    translate_record(cfg, recs + off, formats, sh);
    off += reclen;
  }
  ctx->records_consumed = off;
  sh.lr_start.push_back(int32_t(sh.lr_ids.size()));
  sh.ffm_start.push_back(int32_t(sh.ffm_ids.size()));
  int lr_max = 0, ffm_max = 0;
  for (size_t i = 0; i < sh.label.size(); i++) {
    lr_max = std::max(lr_max, int(sh.lr_start[i + 1] - sh.lr_start[i]));
    ffm_max = std::max(ffm_max, int(sh.ffm_start[i + 1] - sh.ffm_start[i]));
  }
  ctx->n_examples = int64_t(sh.label.size());
  ctx->lr_max = lr_max;
  ctx->ffm_max = ffm_max;
  return ctx->n_examples;
}

int fwn_lr_max(void* p) { return static_cast<Ctx*>(p)->lr_max; }

// words consumed by the last fwn_translate_records call
int64_t fwn_records_consumed(void* p) {
  return static_cast<Ctx*>(p)->records_consumed;
}

// byte offset of the empty line (end-of-stream marker) that ended the last
// fwn_translate_block, or -1 if the block had none
int64_t fwn_stop_offset(void* p) {
  return static_cast<Ctx*>(p)->stop_offset;
}

// toggle packed-record accumulation (only needed when writing a cache)
void fwn_set_build_records(void* p, int on) {
  static_cast<Ctx*>(p)->cfg.build_records = on != 0;
}

// bitmask over the last translated block: bit0 = every LR value is 1.0,
// bit1 = every FFM value is 1.0, bit2 = every example importance is 1.0.
// Lets the host skip transferring arrays the device can reconstruct as ones.
int fwn_all_ones(void* p) {
  auto* ctx = static_cast<Ctx*>(p);
  if (ctx->all_ones_cache >= 0) return ctx->all_ones_cache;
  int flags = 7;
  for (auto& sh : ctx->shards) {
    if (flags & 1)
      for (float v : sh.lr_vals)
        if (v != 1.0f) {
          flags &= ~1;
          break;
        }
    if (flags & 2)
      for (float v : sh.ffm_vals)
        if (v != 1.0f) {
          flags &= ~2;
          break;
        }
    if (flags & 4)
      for (float v : sh.importance)
        if (v != 1.0f) {
          flags &= ~4;
          break;
        }
  }
  ctx->all_ones_cache = flags;
  return flags;
}
int fwn_ffm_max(void* p) { return static_cast<Ctx*>(p)->ffm_max; }

// Concatenated packed records of the last block (cache write path).
int64_t fwn_records_len(void* p) {
  auto* ctx = static_cast<Ctx*>(p);
  int64_t n = 0;
  for (auto& sh : ctx->shards) n += int64_t(sh.records.size());
  return n;
}

void fwn_records_copy(void* p, uint32_t* out) {
  auto* ctx = static_cast<Ctx*>(p);
  for (auto& sh : ctx->shards) {
    std::memcpy(out, sh.records.data(), sh.records.size() * 4);
    out += sh.records.size();
  }
}

// Scatter examples [start, start+count) of the translated block into dense
// padded arrays (example indices are global across shards, in input order).
// B >= count; L >= lr widths; N >= ffm widths. Arrays must be
// zero-initialized by the caller (padding stays id 0 / value 0).
void fwn_fill_range(void* p, int64_t start, int64_t count, int64_t B,
                    int64_t L, int64_t N, float* label, float* importance,
                    int32_t* lr_ids, float* lr_vals, int8_t* lr_combos,
                    int32_t* ffm_ids, float* ffm_vals, int8_t* ffm_fields) {
  auto* ctx = static_cast<Ctx*>(p);
  (void)B;
  int64_t row = 0;        // output row
  int64_t base = 0;       // global index of this shard's first example
  int64_t end = start + count;
  for (auto& sh : ctx->shards) {
    int64_t m = int64_t(sh.label.size());
    int64_t lo = std::max(start - base, int64_t(0));
    int64_t hi = std::min(end - base, m);
    for (int64_t i = lo; i < hi; i++, row++) {
      label[row] = sh.label[i];
      importance[row] = sh.importance[i];
      int32_t a = sh.lr_start[i], b = sh.lr_start[i + 1];
      for (int32_t j = a; j < b; j++) {
        int64_t o = row * L + (j - a);
        lr_ids[o] = int32_t(sh.lr_ids[j]);
        lr_vals[o] = sh.lr_vals[j];
        lr_combos[o] = int8_t(sh.lr_combos[j]);
      }
      if (N > 0) {
        a = sh.ffm_start[i];
        b = sh.ffm_start[i + 1];
        for (int32_t j = a; j < b; j++) {
          int64_t o = row * N + (j - a);
          ffm_ids[o] = int32_t(sh.ffm_ids[j]);
          ffm_vals[o] = sh.ffm_vals[j];
          ffm_fields[o] = int8_t(sh.ffm_fields[j]);
        }
      }
    }
    base += m;
    if (base >= end) break;
  }
}

void fwn_fill(void* p, int64_t B, int64_t L, int64_t N, float* label,
              float* importance, int32_t* lr_ids, float* lr_vals,
              int8_t* lr_combos, int32_t* ffm_ids, float* ffm_vals,
              int8_t* ffm_fields) {
  auto* ctx = static_cast<Ctx*>(p);
  fwn_fill_range(p, 0, ctx->n_examples, B, L, N, label, importance, lr_ids,
                 lr_vals, lr_combos, ffm_ids, ffm_vals, ffm_fields);
}

// Keep examples [consumed, n) for the NEXT translate call — they will
// lead shard 0, so batch boundaries stop depending on the caller's chunk
// size. Without this every input chunk ended in a padded partial batch
// (~3% padded device compute at 10M rows / 64 MB chunks, and one extra
// compiled solo program per run). Packed records are NOT carried: the
// cache writer consumed them when their block was parsed.
void fwn_carry_tail(void* p, int64_t consumed) {
  auto* ctx = static_cast<Ctx*>(p);
  Shard& dst = ctx->carry;
  dst.clear();
  int64_t base = 0;
  for (auto& sh : ctx->shards) {
    int64_t m = int64_t(sh.label.size());
    int64_t lo = std::max(consumed - base, int64_t(0));
    for (int64_t i = lo; i < m; i++) {
      dst.label.push_back(sh.label[i]);
      dst.importance.push_back(sh.importance[i]);
      dst.lr_start.push_back(int32_t(dst.lr_ids.size()));
      for (int32_t j = sh.lr_start[i]; j < sh.lr_start[i + 1]; j++) {
        dst.lr_ids.push_back(sh.lr_ids[j]);
        dst.lr_vals.push_back(sh.lr_vals[j]);
        dst.lr_combos.push_back(sh.lr_combos[j]);
      }
      dst.ffm_start.push_back(int32_t(dst.ffm_ids.size()));
      for (int32_t j = sh.ffm_start[i]; j < sh.ffm_start[i + 1]; j++) {
        dst.ffm_ids.push_back(sh.ffm_ids[j]);
        dst.ffm_vals.push_back(sh.ffm_vals[j]);
        dst.ffm_fields.push_back(sh.ffm_fields[j]);
      }
    }
    base += m;
  }
}

// Per-batch multiplicity counts for the batch-mean cap (ops/adagrad.py
// batch_mean_grads): out[i] encodes the number of non-padding entries in
// the batch whose key (ids[j] >> shift) equals entry i's key; padding
// (mark[i] < 0) gets 0. Encoding is an 8-bit soft-float to keep the
// host->device transfer small: codes 0..15 are exact counts; above that,
// code = e<<3 | (m-8) with c rounded UP to (8+m)<<(e-3) — at most 12.5%
// high, i.e. the cap only ever gets (slightly) more conservative.
// Counting is an LSD byte-radix sort of (key, entry-index) packed in u64 —
// sequential passes stay cache-friendly where an open-addressing table
// thrashed (measured 22 ms hashed vs ~14 ms radix at K=512k); it replaces
// a ~32 ms device-side sort per step. Constant key bytes skip their pass.
static inline uint8_t encode_count(uint64_t c) {
  if (c <= 15) return uint8_t(c);
  int e = 63 - __builtin_clzll(c);          // floor(log2 c), e >= 4
  uint64_t m = (c + ((1ull << (e - 3)) - 1)) >> (e - 3);  // round up
  if (m == 16) { e++; m = 8; }
  return uint8_t((e << 3) | (m - 8));       // 32..255
}

// Shared radix body: `cur` holds (key << 28 | entry_index) packed u64
// entries (entry_index < 2^28); sorts by key and writes each entry's
// 8-bit multiplicity code to out[entry_index]. Scratch persists across
// calls (fresh vectors measured ~7 MB of malloc + zero-fill + page-fault
// churn per 32k x 13 batch, a large share of the counts pass).
static thread_local std::vector<uint64_t> g_radix_cur, g_radix_nxt;
static thread_local std::vector<size_t> g_radix_hist;
constexpr int RADIX_IDX_BITS = 28;
constexpr int RADIX_B1 = 13;  // fixed low-digit width: 8K-bucket histogram
// (64 KB, L2-resident) built DURING the key-build pass — an adaptive b1
// would need `seen` first and cost one extra 8 B/entry read

static void radix_emit_codes(uint32_t seen, uint8_t* out) {
  std::vector<uint64_t>& cur = g_radix_cur;
  std::vector<uint64_t>& nxt = g_radix_nxt;
  std::vector<size_t>& hist = g_radix_hist;
  size_t n = cur.size();
  if (nxt.size() < n) nxt.resize(n);
  int key_bits = 32;
  while (key_bits > 1 && !(seen >> (key_bits - 1))) key_bits--;
  if (seen == 0) key_bits = 1;
  // pass 1: low B1 bits, histogram already built by the caller
  {
    size_t buckets = size_t(1) << RADIX_B1;
    uint64_t mask = buckets - 1;
    for (size_t b = 0; b < buckets; b++) hist[b + 1] += hist[b];
    for (size_t i = 0; i < n; i++)
      nxt[hist[(cur[i] >> RADIX_IDX_BITS) & mask]++] = cur[i];
    cur.swap(nxt);
  }
  // pass 2: remaining high bits (hash ids are < 2^25 on typical configs,
  // so this is ~12 bits; none needed for keys that fit B1)
  if (key_bits > RADIX_B1) {
    int width = key_bits - RADIX_B1;
    size_t buckets = size_t(1) << width;
    uint64_t mask = buckets - 1;
    hist.assign(buckets + 1, 0);
    for (size_t i = 0; i < n; i++)
      hist[((cur[i] >> (RADIX_IDX_BITS + RADIX_B1)) & mask) + 1]++;
    for (size_t b = 0; b < buckets; b++) hist[b + 1] += hist[b];
    for (size_t i = 0; i < n; i++)
      nxt[hist[(cur[i] >> (RADIX_IDX_BITS + RADIX_B1)) & mask]++] = cur[i];
    cur.swap(nxt);
  }
  // run-length counts over the sorted keys, written back via the index
  for (size_t s = 0; s < n;) {
    uint64_t key = cur[s] >> RADIX_IDX_BITS;
    size_t e = s + 1;
    while (e < n && (cur[e] >> RADIX_IDX_BITS) == key) e++;
    uint8_t c8 = encode_count(e - s);
    for (size_t j = s; j < e; j++)
      out[cur[j] & ((1u << RADIX_IDX_BITS) - 1)] = c8;
    s = e;
  }
}

void fwn_batch_counts(const int32_t* ids, const int8_t* mark,
                      const float* vals, int64_t K,
                      int32_t shift, uint8_t* out) {
  std::vector<uint64_t>& cur = g_radix_cur;
  std::vector<size_t>& hist = g_radix_hist;
  if (cur.capacity() < size_t(K)) cur.reserve(size_t(K));
  cur.clear();
  hist.assign((size_t(1) << RADIX_B1) + 1, 0);
  uint32_t seen = 0;
  for (int64_t i = 0; i < K; i++) {
    // skip padding AND explicit zero-valued features (vals may be null
    // when the engine proved the value array all-ones): a zero-valued
    // entry has zero gradient, so the device path's touched-only counts
    // and the Python oracle (train/loop.py np_counts) both exclude it —
    // counting it here would desynchronize the two ingest engines
    if (mark[i] < 0 || (vals != nullptr && vals[i] == 0.0f)) {
      out[i] = 0;
      continue;
    }
    uint32_t key = uint32_t(ids[i]) >> shift;
    seen |= key;
    hist[(key & ((1u << RADIX_B1) - 1)) + 1]++;
    cur.push_back((uint64_t(key) << RADIX_IDX_BITS) | uint64_t(i));
  }
  radix_emit_codes(seen, out);
}

// bit-pack a [B, W] non-negative i32 id column to `bits` per entry
// ([B, ceil(W*bits/32)] u32 words, row-major bit-writer — the numpy
// column-sliced version measured 4.9 ms/batch of strided access; this is
// sequential). Returns 1, or 0 when any value overflows `bits` (including
// negatives viewed as u32) — the caller ships the column unpacked then.
int fwn_bitpack_ids(const int32_t* ids, int64_t B, int32_t W, int32_t bits,
                    int32_t words, uint32_t* out) {
  const uint32_t* src = reinterpret_cast<const uint32_t*>(ids);
  for (int64_t b = 0; b < B; b++) {
    const uint32_t* row = src + b * W;
    uint32_t* dst = out + b * words;
    uint64_t accum = 0;
    int nbits = 0, w = 0;
    for (int32_t j = 0; j < W; j++) {
      if (row[j] >> bits) return 0;
      accum |= uint64_t(row[j]) << nbits;
      nbits += bits;
      if (nbits >= 32) {
        dst[w++] = uint32_t(accum);
        accum >>= 32;
        nbits -= 32;
      }
    }
    if (nbits > 0) dst[w] = uint32_t(accum);
  }
  return 1;
}

// like fwn_bitpack_ids but with a per-column bit width (the vocab-encoded
// transfer: dictionary-index columns pack at their dictionary's width,
// direct columns at bit_precision — train/packed.py encode_vocab_ids)
int fwn_bitpack_mixed(const int32_t* ids, int64_t B, int32_t W,
                      const int32_t* bits, int32_t words, uint32_t* out) {
  const uint32_t* src = reinterpret_cast<const uint32_t*>(ids);
  for (int64_t b = 0; b < B; b++) {
    const uint32_t* row = src + b * W;
    uint32_t* dst = out + b * words;
    uint64_t accum = 0;
    int nbits = 0, w = 0;
    for (int32_t j = 0; j < W; j++) {
      if (row[j] >> bits[j]) return 0;
      accum |= uint64_t(row[j]) << nbits;
      nbits += bits[j];
      if (nbits >= 32) {
        dst[w++] = uint32_t(accum);
        accum >>= 32;
        nbits -= 32;
      }
    }
    if (nbits > 0) dst[w] = uint32_t(accum);
  }
  return 1;
}

// ---------------------------------------------------------------------------
// Persistent per-column id→index vocabulary (packed-transfer compression).
//
// The uplink ships 25-bit hash ids, but most columns of a fixed-width
// schema draw from a small stationary set (a categorical namespace's
// value set). Each column keeps an insertion-ordered dictionary; the
// payload ships ceil(log2(size))-bit indices and the device holds the
// index→id table, resolving ids with a row-gather (train/packed.py).
// A column whose dictionary would exceed `max_cap` flips to direct
// (ships raw ids) permanently — high-cardinality columns such as LR
// interaction combos degrade gracefully with zero configuration.
// ---------------------------------------------------------------------------

namespace {

struct VocabCol {
  // open addressing over (key, idx) PAIRS — one cache line per probe
  // (split key/idx arrays cost two misses per hit; the lookups are
  // latency-bound random accesses over a multi-MB working set) —
  // power-of-two capacity, empty = UINT32_MAX key
  struct Pair {
    uint32_t key;
    int32_t idx;
  };
  std::vector<Pair> tab;
  std::vector<int32_t> order;  // ids in index order (the export table)
  bool direct = false;

  void rehash(size_t cap) {
    std::vector<Pair> nt(cap, Pair{UINT32_MAX, 0});
    size_t mask = cap - 1;
    for (const Pair& p : tab) {
      if (p.key == UINT32_MAX) continue;
      size_t h = (p.key * 2654435761u) & mask;
      while (nt[h].key != UINT32_MAX) h = (h + 1) & mask;
      nt[h] = p;
    }
    tab.swap(nt);
  }

  size_t slot(uint32_t id) const {
    return (id * 2654435761u) & (tab.size() - 1);
  }

  // id → dense index, assigning the next index to unseen ids;
  // returns −1 when the dictionary would exceed max_cap
  int32_t lookup_or_add(uint32_t id, int32_t max_cap) {
    if (tab.empty()) rehash(1024);
    size_t mask = tab.size() - 1;
    size_t h = slot(id);
    while (tab[h].key != UINT32_MAX) {
      if (tab[h].key == id) return tab[h].idx;
      h = (h + 1) & mask;
    }
    if (int32_t(order.size()) >= max_cap) return -1;
    tab[h] = Pair{id, int32_t(order.size())};
    order.push_back(int32_t(id));
    if (order.size() * 2 > tab.size()) rehash(tab.size() * 2);
    return int32_t(order.size()) - 1;
  }
};

struct Vocab {
  std::vector<VocabCol> cols;
  int32_t max_cap = 0;
  bool dirty = false;

  // Cross-column id index (fused counts): id → the dictionary slot(s)
  // holding it, maintained at mint time. The fused emit counts dictionary
  // entries per (column, index) slot — a dense array — instead of
  // radix-sorting every entry of the batch; this index is what keeps the
  // GLOBAL count semantics exact (the multiplicity key is the raw id, so
  // the same id minted into two columns, or colliding with a direct
  // column's id, must aggregate across them — ~2.7k colliding entries
  // per 32k×13 batch at b=25 by the birthday bound).
  // Open addressing, u64 = id(32) << 32 | value(32); value is
  // (col << 24 | idx) for a single-column id, or MULTI | pool index for
  // ids minted in more than one column. Empty slot = all-ones key.
  static constexpr uint32_t MULTI = 0x80000000u;
  std::vector<uint64_t> idx_tab;
  std::vector<std::vector<uint32_t>> idx_pool;
  size_t idx_count = 0;

  void idx_rehash(size_t cap) {
    std::vector<uint64_t> nt(cap, ~0ull);
    size_t mask = cap - 1;
    for (uint64_t e : idx_tab) {
      if (e == ~0ull) continue;
      size_t h = (uint32_t(e >> 32) * 2654435761u) & mask;
      while (nt[h] != ~0ull) h = (h + 1) & mask;
      nt[h] = e;
    }
    idx_tab.swap(nt);
  }

  // value for id, or UINT32_MAX when the id was never minted
  uint32_t idx_find(uint32_t id) const {
    if (idx_tab.empty()) return UINT32_MAX;
    size_t mask = idx_tab.size() - 1;
    size_t h = (id * 2654435761u) & mask;
    while (idx_tab[h] != ~0ull) {
      if (uint32_t(idx_tab[h] >> 32) == id) return uint32_t(idx_tab[h]);
      h = (h + 1) & mask;
    }
    return UINT32_MAX;
  }

  void idx_add(uint32_t id, int32_t col, int32_t idx) {
    if (idx_tab.empty()) idx_rehash(1 << 12);
    size_t mask = idx_tab.size() - 1;
    size_t h = (id * 2654435761u) & mask;
    uint32_t packed = (uint32_t(col) << 24) | uint32_t(idx);
    while (idx_tab[h] != ~0ull) {
      if (uint32_t(idx_tab[h] >> 32) == id) {
        uint32_t v = uint32_t(idx_tab[h]);
        if (v & MULTI) {
          idx_pool[v & ~MULTI].push_back(packed);
        } else {
          idx_pool.push_back({v, packed});
          idx_tab[h] = (uint64_t(id) << 32) |
                       (MULTI | uint32_t(idx_pool.size() - 1));
        }
        return;
      }
      h = (h + 1) & mask;
    }
    idx_tab[h] = (uint64_t(id) << 32) | packed;
    if (++idx_count * 2 > idx_tab.size()) idx_rehash(idx_tab.size() * 2);
  }

  // mint-aware lookup: like col.lookup_or_add but keeps the cross-column
  // id index in sync (ALL mint sites must go through this)
  int32_t lookup_or_add_indexed(int32_t j, uint32_t id) {
    VocabCol& col = cols[size_t(j)];
    size_t pre = col.order.size();
    int32_t r = col.lookup_or_add(id, max_cap);
    if (r >= 0 && col.order.size() != pre) idx_add(id, j, r);
    return r;
  }
};

}  // namespace

void* fwn_vocab_create(int32_t n_cols, int32_t max_cap) {
  auto* v = new Vocab();
  v->cols.resize(size_t(n_cols));
  v->max_cap = max_cap;
  return v;
}

void fwn_vocab_destroy(void* p) { delete static_cast<Vocab*>(p); }

// Fused single-sweep encode (the production path): raw [B, W] ids that
// may carry combo+1 in the bits at/above `shift` (shift=0: pure ids).
// One row-major pass extracts and verifies a batch-uniform combo row,
// masks the ids, and dictionary-encodes them (direct columns pass the
// masked id through). Returns 1 on success, 0 when the combo layout is
// not row-uniform (the caller ships the plain combo-packed path) —
// replaces three full-array numpy passes + a column-major C pass
// (measured 2.1 + 4.7 ms/batch → ~2 ms at B=32k, W=13).
int fwn_vocab_encode2(void* p, const int32_t* raw, int64_t B, int32_t W,
                      int64_t stride, int32_t shift, uint32_t mask,
                      int32_t* out_idx, int32_t* sizes,
                      int32_t* combo_row) {
  auto* v = static_cast<Vocab*>(p);
  if (size_t(W) > v->cols.size() || B <= 0 || stride < W) return 0;
  std::vector<VocabCol*> cols(static_cast<size_t>(W));
  std::vector<size_t> before(static_cast<size_t>(W));
  for (int32_t j = 0; j < W; j++) {
    cols[size_t(j)] = &v->cols[size_t(j)];
    before[size_t(j)] = cols[size_t(j)]->order.size();
  }
  const uint32_t* src = reinterpret_cast<const uint32_t*>(raw);
  // software-pipelined prefetch: while probing row b, row b+1's first
  // probe slots are already in flight — the lookups are independent
  // random misses over a multi-MB working set, so keeping ~2W of them
  // outstanding overlaps the latency instead of serializing it
  auto prefetch_row = [&](int64_t b) {
    const uint32_t* row = src + b * stride;
    for (int32_t j = 0; j < W; j++) {
      const VocabCol& col = *cols[size_t(j)];
      if (!col.direct && !col.tab.empty())
        __builtin_prefetch(col.tab.data() + col.slot(row[j] & mask), 0, 1);
    }
  };
  prefetch_row(0);
  for (int64_t b = 0; b < B; b++) {
    const uint32_t* row = src + b * stride;
    int32_t* orow = out_idx + b * W;
    // combo extraction/uniformity check rides the same sweep
    if (shift > 0) {
      for (int32_t j = 0; j < W; j++) {
        int32_t c = int32_t(row[j] >> shift) - 1;
        if (b == 0) {
          combo_row[j] = c;
        } else if (c != combo_row[j]) {
          // variable combo layout: bail out, but entries already added
          // this batch must still count as growth (a later snapshot has
          // to carry them or indices minted later would dangle)
          for (int32_t q = 0; q < W; q++)
            if (!cols[size_t(q)]->direct &&
                cols[size_t(q)]->order.size() != before[size_t(q)])
              v->dirty = true;
          return 0;
        }
      }
    } else if (b == 0) {
      for (int32_t j = 0; j < W; j++) combo_row[j] = -1;  // unused
    }
    if (b + 1 < B) prefetch_row(b + 1);
    for (int32_t j = 0; j < W; j++) {
      int32_t id = int32_t(row[j] & mask);
      VocabCol& col = *cols[size_t(j)];
      if (col.direct) {
        orow[j] = id;
        continue;
      }
      int32_t r = v->lookup_or_add_indexed(j, uint32_t(id));
      if (r >= 0) {
        orow[j] = r;
        continue;
      }
      // overflow: column flips direct; backfill earlier rows of j
      col.direct = true;
      v->dirty = true;
      for (int64_t k = 0; k < b; k++)
        out_idx[k * W + j] = int32_t(src[k * stride + j] & mask);
      orow[j] = id;
    }
  }
  for (int32_t j = 0; j < W; j++) {
    VocabCol& col = *cols[size_t(j)];
    if (!col.direct && col.order.size() != before[size_t(j)])
      v->dirty = true;
    sizes[j] = col.direct ? -1 : int32_t(col.order.size());
  }
  return 1;
}

// Scatter per-entry multiplicity codes into the vocabulary-shadow count
// table (train/packed.py table_counts): tab[bases[j] + idx[b,j]] =
// codes[b,j] for dictionary columns (bases[j] >= 0). Within one batch a
// given id carries ONE global multiplicity, so the write is idempotent
// per (column, index). `tab` must be zeroed by the caller; codes may be
// a column-sliced view (row stride in bytes).
void fwn_counts_table(const int32_t* idx, const uint8_t* codes,
                      int64_t codes_stride, int64_t B, int32_t W,
                      const int32_t* bases, uint8_t* tab) {
  for (int64_t b = 0; b < B; b++) {
    const int32_t* irow = idx + b * W;
    const uint8_t* crow = codes + b * codes_stride;
    for (int32_t j = 0; j < W; j++)
      if (bases[j] >= 0) tab[bases[j] + irow[j]] = crow[j];
  }
}

// Fused steady-state batch emit: translated SoA shards → the final wire
// arrays of one packed full batch, in ONE sweep (plus the global
// multiplicity radix pass). Replaces, for the overwhelmingly common
// fixed-width/full-batch case, the chain fill_range → numpy combo-pack →
// fwn_batch_counts → fwn_vocab_encode2 → fwn_bitpack_mixed →
// fwn_counts_table → numpy packbits — each of which materializes (and
// re-reads) a [B, W]-sized intermediate. The outputs are byte-identical
// to that chain's (asserted in tests/test_fused_emit.py); anything
// irregular BAILS (returns 0) and the caller falls back to the general
// path, which re-encodes the same batch idempotently (lookup_or_add
// re-finds entries this sweep already minted; `dirty` is set on any mint
// so the next snapshot still ships).
//
// Bail conditions: an example without exactly `W_all` LR entries, a
// non-uniform combo row, a label outside {0,1}, any dictionary mint or
// overflow (the layout's widths/tab bases are computed by the caller
// from PRE-batch dictionary sizes; growth could change them), an index
// overflowing its wire width, or a row-uniform count matrix (the
// general path ships that as a broadcast instead of a table).
//
// Layout contract with train/packed.py (see prepare_for_transfer):
//   out_label  [B/32] u32   — 1-bit little-endian labels (bitpack_labels)
//   out_direct [B, n_direct] u8 — per-entry codes of direct columns
//   out_tab    [tab_len] u8 — dictionary columns' code table (table_counts)
//   out_ids    [B, words] u32 — mixed-width bit-packed indices
//   combo_row  [W_all] i32  — the uniform combo row INCLUDING the
//                             stripped constant column's combo
//   out_const_code — the constant column's (uniform) multiplicity code
// tab_len < 0 disables the counts machinery (schemas without the
// batch-mean cap ship only label + ids).
int fwn_emit_fused(void* ctx_p, void* vocab_p, int64_t start, int64_t count,
                   int32_t W_all, uint32_t const_id,
                   const int32_t* widths, const int32_t* tab_bases,
                   int32_t words, int64_t tab_len, int32_t n_direct,
                   uint32_t* out_ids, uint8_t* out_tab, uint8_t* out_direct,
                   uint32_t* out_label, int32_t* combo_row,
                   int32_t* out_const_code,
                   // FFM columns (n_ffm_pad == 0: LR-only schema). The
                   // wire shape is the general path's PADDED width (the
                   // stream floors it at 4): every example must carry the
                   // same real entry count R <= n_ffm_pad; columns past R
                   // emit id 0 / field -1 / count 0, exactly like
                   // fill_range's padding. ffm_shift < 0: no FFM counts.
                   int32_t n_ffm_pad, int32_t ffm_bits, int32_t ffm_words,
                   int32_t ffm_shift, uint32_t* out_ffm_ids,
                   uint8_t* out_ffm_counts, int32_t* ffm_field_row) {
  auto* ctx = static_cast<Ctx*>(ctx_p);
  auto* v = static_cast<Vocab*>(vocab_p);
  const int32_t W = W_all - 1;  // wire columns (constant column stripped)
  if (W < 1 || size_t(W) > v->cols.size() || count <= 0 || (count & 31))
    return 0;
  const bool with_counts = tab_len >= 0;
  if (count * W_all >= (int64_t(1) << RADIX_IDX_BITS)) return 0;
  if (n_ffm_pad > 0 && count * n_ffm_pad >= (int64_t(1) << RADIX_IDX_BITS))
    return 0;

  // resolve the example range to (shard, local index) spans and verify
  // the fixed width W_all — variable-width examples use the general path
  struct Span {
    const Shard* sh;
    int64_t lo, hi;
  };
  Span spans[64];
  int n_spans = 0;
  {
    int64_t base = 0;
    const int64_t end = start + count;
    for (const auto& sh : ctx->shards) {
      int64_t m = int64_t(sh.label.size());
      int64_t lo = std::max(start - base, int64_t(0));
      int64_t hi = std::min(end - base, m);
      if (lo < hi) {
        if (n_spans == 64) return 0;
        spans[n_spans++] = Span{&sh, lo, hi};
      }
      base += m;
      if (base >= end) break;
    }
    if (base < end && n_spans == 0) return 0;
  }
  int64_t total = 0;
  int32_t ffm_R = -1;  // real FFM entries per example (uniform or bail)
  for (int s = 0; s < n_spans; s++) {
    const Shard& sh = *spans[s].sh;
    for (int64_t i = spans[s].lo; i < spans[s].hi; i++) {
      if (sh.lr_start[i + 1] - sh.lr_start[i] != W_all) return 0;
      if (n_ffm_pad > 0) {
        int32_t r = sh.ffm_start[i + 1] - sh.ffm_start[i];
        if (ffm_R < 0) ffm_R = r;
        if (r != ffm_R || r > n_ffm_pad) return 0;
      }
    }
    total += spans[s].hi - spans[s].lo;
  }
  if (total != count) return 0;
  if (n_ffm_pad > 0 && ffm_R < 0) return 0;

  // The emit sweep — vocab lookup, mixed-width bit-write, per-slot count
  // accumulation, label bits, combo/constant verification.
  //
  // Counting strategy (replaces the former whole-batch radix sort, which
  // at 459k entries/batch was the single largest non-parse producer cost):
  // dictionary entries count into a dense per-(column, index) array —
  // slot_counts IS tab-shaped — and only the direct columns' entries
  // (one column, ~32k entries on the Eat-Rate schema) go through a radix.
  // GLOBAL id semantics (the multiplicity key is the raw id, aggregated
  // across columns) are restored exactly via the Vocab's cross-column id
  // index: total(id) = Σ slot_counts over the still-dict slots holding id
  //                  + (direct-column occurrences of id)
  //                  + B·[id == constant id]
  // — byte-identical to the general path's fwn_batch_counts (asserted in
  // tests/test_fused_emit.py, including an engineered-collision config).
  std::vector<VocabCol*> cols(static_cast<size_t>(W));
  size_t before[64];
  if (W > 64) return 0;
  for (int32_t j = 0; j < W; j++) {
    cols[size_t(j)] = &v->cols[size_t(j)];
    before[j] = cols[size_t(j)]->order.size();
    // caller derived the layout from PRE-batch state: a direct column must
    // map to tab base -1 and vice versa
    if (with_counts && (tab_bases[j] < 0) != cols[size_t(j)]->direct)
      return 0;
  }
  auto bail = [&]() {
    for (int32_t j = 0; j < W; j++)
      if (!cols[size_t(j)]->direct &&
          cols[size_t(j)]->order.size() != before[j])
        v->dirty = true;
    return 0;
  };
  std::memset(out_label, 0, size_t(count / 32) * 4);
  static thread_local std::vector<uint32_t> slot_counts, ab_extra;
  static thread_local std::vector<uint64_t> ffm_ent;
  static thread_local std::vector<size_t> ffm_hist;
  std::vector<uint64_t>& ab = g_radix_cur;
  std::vector<size_t>& hist = g_radix_hist;
  uint32_t ab_seen = 0, ffm_seen = 0;
  const bool ffm_counts_on = n_ffm_pad > 0 && ffm_shift >= 0;
  if (with_counts) {
    std::memset(out_tab, 0, size_t(tab_len));
    slot_counts.assign(size_t(tab_len), 0);
    ab_extra.assign(size_t(tab_len), 0);
    if (ab.capacity() < size_t(count * n_direct))
      ab.reserve(size_t(count * n_direct));
    ab.clear();
    hist.assign((size_t(1) << RADIX_B1) + 1, 0);
  }
  if (ffm_counts_on) {
    if (ffm_ent.capacity() < size_t(count * ffm_R))
      ffm_ent.reserve(size_t(count * ffm_R));
    ffm_ent.clear();
    ffm_hist.assign((size_t(1) << RADIX_B1) + 1, 0);
    // padding columns' codes are 0, like fill_range+batch_counts
    std::memset(out_ffm_counts, 0, size_t(count * n_ffm_pad));
  }
  int64_t b = 0;
  auto prefetch_row = [&](const uint32_t* row) {
    for (int32_t j = 0; j < W; j++) {
      const VocabCol& col = *cols[size_t(j)];
      if (!col.direct && !col.tab.empty())
        __builtin_prefetch(col.tab.data() + col.slot(row[j]), 0, 1);
    }
  };
  for (int s = 0; s < n_spans; s++) {
    const Shard& sh = *spans[s].sh;
    for (int64_t i = spans[s].lo; i < spans[s].hi; i++, b++) {
      float l = sh.label[i];
      if (l != 0.0f && l != 1.0f) return bail();
      if (l == 1.0f) out_label[b >> 5] |= 1u << (b & 31);
      const int32_t a0 = sh.lr_start[i];
      const uint32_t* row = sh.lr_ids.data() + a0;
      const int32_t* crow = sh.lr_combos.data() + a0;
      if (b == 0) {
        for (int32_t j = 0; j < W_all; j++) combo_row[j] = crow[j];
      } else {
        for (int32_t j = 0; j < W_all; j++)
          if (crow[j] != combo_row[j]) return bail();
      }
      if (i + 1 < spans[s].hi)
        prefetch_row(sh.lr_ids.data() + sh.lr_start[i + 1]);
      if (row[W] != const_id) return bail();
      if (n_ffm_pad > 0) {
        const int32_t f0 = sh.ffm_start[i];
        const uint32_t* frow = sh.ffm_ids.data() + f0;
        const int32_t* ffrow = sh.ffm_fields.data() + f0;
        if (b == 0) {
          for (int32_t j = 0; j < ffm_R; j++) ffm_field_row[j] = ffrow[j];
          for (int32_t j = ffm_R; j < n_ffm_pad; j++) ffm_field_row[j] = -1;
        } else {
          for (int32_t j = 0; j < ffm_R; j++)
            if (ffrow[j] != ffm_field_row[j]) return bail();
        }
        uint32_t* fdst = out_ffm_ids + b * ffm_words;
        uint64_t fac = 0;
        int fbits = 0, fw = 0;
        for (int32_t j = 0; j < n_ffm_pad; j++) {
          uint32_t id = j < ffm_R ? frow[j] : 0u;
          if (ffm_bits == 0) {
            // raw i32 mode: the bit-pack would not save a whole word at
            // this padded width, so the general path ships the column
            // unpacked (bitpack_ids' words >= W early-out)
            fdst[j] = id;
          } else {
            if (id >> ffm_bits) return bail();
            fac |= uint64_t(id) << fbits;
            fbits += ffm_bits;
            if (fbits >= 32) {
              fdst[fw++] = uint32_t(fac);
              fac >>= 32;
              fbits -= 32;
            }
          }
          if (ffm_counts_on && j < ffm_R) {
            uint32_t key = id >> ffm_shift;
            ffm_seen |= key;
            ffm_hist[(key & ((1u << RADIX_B1) - 1)) + 1]++;
            ffm_ent.push_back((uint64_t(key) << RADIX_IDX_BITS) |
                              uint64_t(b * n_ffm_pad + j));
          }
        }
        if (ffm_bits != 0 && fbits > 0) fdst[fw] = uint32_t(fac);
      }
      uint32_t* dst = out_ids + b * words;
      uint64_t accum = 0;
      int nbits = 0, w = 0;
      int32_t d = 0;
      for (int32_t j = 0; j < W; j++) {
        uint32_t id = row[j];
        VocabCol& col = *cols[size_t(j)];
        uint32_t idx;
        if (col.direct) {
          idx = id;
          if (with_counts) {
            // direct entries radix by id; codes land in the post-pass
            ab_seen |= id;
            hist[(id & ((1u << RADIX_B1) - 1)) + 1]++;
            ab.push_back((uint64_t(id) << RADIX_IDX_BITS) |
                         uint64_t(b * n_direct + d));
            d++;
          }
        } else {
          size_t pre = col.order.size();
          int32_t r = v->lookup_or_add_indexed(j, id);
          if (r < 0 || col.order.size() != pre) return bail();  // mint or
          // overflow: the layout was derived from pre-batch sizes
          idx = uint32_t(r);
          if (with_counts) slot_counts[tab_bases[j] + r]++;
        }
        if (idx >> widths[j]) return bail();
        accum |= uint64_t(idx) << nbits;
        nbits += widths[j];
        if (nbits >= 32) {
          dst[w++] = uint32_t(accum);
          accum >>= 32;
          nbits -= 32;
        }
      }
      if (nbits > 0) dst[w] = uint32_t(accum);
    }
  }
  // FFM multiplicity codes: an independent key space (id >> ffm_shift over
  // the FFM entries only, exactly fwn_batch_counts' semantics for the ffm
  // arrays); runs AFTER the LR direct pass since both share the radix
  // scratch. Row-uniform codes bail like the LR table (the general path
  // ships those as a zero-byte broadcast).
  auto emit_ffm_codes = [&]() -> bool {
    if (!ffm_counts_on) return true;
    g_radix_cur.swap(ffm_ent);
    g_radix_hist.swap(ffm_hist);
    radix_emit_codes(ffm_seen, out_ffm_counts);
    bool funiform = true;
    for (int32_t j = 0; j < n_ffm_pad && funiform; j++) {
      uint8_t c0 = out_ffm_counts[j];
      for (int64_t q = 1; q < count; q++)
        if (out_ffm_counts[q * n_ffm_pad + j] != c0) {
          funiform = false;
          break;
        }
    }
    return !funiform;
  };
  if (!with_counts) return emit_ffm_codes() ? 1 : bail();

  // post-pass 1: direct-column codes by id run-length; each unique direct
  // id folds in the dictionary slots holding the same id (cross-column
  // collisions) and distributes its own count back to those slots
  const size_t ab_n = ab.size();  // the swap below can leave ab with a
  // LARGER backing vector whose tail is stale scratch
  {
    std::vector<uint64_t>& cur = ab;
    std::vector<uint64_t>& nxt = g_radix_nxt;
    size_t n = ab_n;
    if (nxt.size() < n) nxt.resize(n);
    int key_bits = 32;
    while (key_bits > 1 && !(ab_seen >> (key_bits - 1))) key_bits--;
    if (ab_seen == 0) key_bits = 1;
    {
      size_t buckets = size_t(1) << RADIX_B1;
      uint64_t kmask = buckets - 1;
      for (size_t q = 0; q < buckets; q++) hist[q + 1] += hist[q];
      for (size_t q = 0; q < n; q++)
        nxt[hist[(cur[q] >> RADIX_IDX_BITS) & kmask]++] = cur[q];
      cur.swap(nxt);
    }
    if (key_bits > RADIX_B1) {
      int width = key_bits - RADIX_B1;
      size_t buckets = size_t(1) << width;
      uint64_t kmask = buckets - 1;
      hist.assign(buckets + 1, 0);
      for (size_t q = 0; q < n; q++)
        hist[((cur[q] >> (RADIX_IDX_BITS + RADIX_B1)) & kmask) + 1]++;
      for (size_t q = 0; q < buckets; q++) hist[q + 1] += hist[q];
      for (size_t q = 0; q < n; q++)
        nxt[hist[(cur[q] >> (RADIX_IDX_BITS + RADIX_B1)) & kmask]++] = cur[q];
      cur.swap(nxt);
    }
  }
  uint64_t ab_const = 0;
  auto dict_slots_sum = [&](uint32_t id, uint64_t ab_count,
                            bool distribute) -> uint64_t {
    // Σ slot_counts over the still-dict slots holding `id`; optionally
    // write the direct-column count back to those slots for the tab pass
    uint32_t val = v->idx_find(id);
    if (val == UINT32_MAX) return 0;
    uint64_t sum = 0;
    auto one = [&](uint32_t packed) {
      int32_t cj = int32_t(packed >> 24);
      int32_t ci = int32_t(packed & 0xffffffu);
      if (cj >= W || tab_bases[cj] < 0) return;  // column went direct (its
      // occurrences are in the radix) or lies past this layout's width
      int64_t slot = tab_bases[cj] + ci;
      sum += slot_counts[slot];
      if (distribute) ab_extra[slot] = uint32_t(ab_count);
    };
    if (val & Vocab::MULTI) {
      for (uint32_t packed : v->idx_pool[val & ~Vocab::MULTI]) one(packed);
    } else {
      one(val);
    }
    return sum;
  };
  for (size_t s0 = 0, n = ab_n; s0 < n;) {
    uint32_t id = uint32_t(ab[s0] >> RADIX_IDX_BITS);
    size_t e = s0 + 1;
    while (e < n && uint32_t(ab[e] >> RADIX_IDX_BITS) == id) e++;
    uint64_t c = e - s0;
    if (id == const_id) ab_const = c;
    uint64_t total = c + dict_slots_sum(id, c, true) +
                     (id == const_id ? uint64_t(count) : 0);
    uint8_t c8 = encode_count(total);
    for (size_t q = s0; q < e; q++)
      out_direct[ab[q] & ((1u << RADIX_IDX_BITS) - 1)] = c8;
    s0 = e;
  }
  *out_const_code = int32_t(encode_count(
      uint64_t(count) + ab_const + dict_slots_sum(const_id, 0, false)));

  // post-pass 2: the dictionary-column code table + the row-uniformity
  // check (all wire columns constant ⟺ every row's code vector equal —
  // the general path ships that as a zero-byte broadcast instead)
  bool codes_uniform = true;
  for (int32_t j = 0; j < W; j++) {
    if (tab_bases[j] < 0) continue;
    const VocabCol& col = *cols[size_t(j)];
    int first_code = -1;
    for (size_t idx = 0, m = col.order.size(); idx < m; idx++) {
      int64_t slot = tab_bases[j] + int64_t(idx);
      uint32_t c0 = slot_counts[slot];
      if (c0 == 0) continue;  // untouched slot: stays 0, never read
      uint32_t id = uint32_t(col.order[idx]);
      uint64_t total = c0 + uint64_t(ab_extra[slot]) +
                       (id == const_id ? uint64_t(count) : 0);
      uint32_t val = v->idx_find(id);
      if (val != UINT32_MAX && (val & Vocab::MULTI)) {
        // id minted in several columns: global count sums their slots
        total = uint64_t(ab_extra[slot]) +
                (id == const_id ? uint64_t(count) : 0);
        for (uint32_t packed : v->idx_pool[val & ~Vocab::MULTI]) {
          int32_t cj = int32_t(packed >> 24);
          if (cj < W && tab_bases[cj] >= 0)
            total += slot_counts[tab_bases[cj] + int32_t(packed & 0xffffffu)];
        }
      }
      uint8_t c8 = encode_count(total);
      out_tab[slot] = c8;
      if (first_code < 0) first_code = c8;
      else if (first_code != c8) codes_uniform = false;
    }
  }
  if (codes_uniform && n_direct > 0) {
    for (int32_t d = 0; d < n_direct && codes_uniform; d++) {
      uint8_t c0 = out_direct[d];
      for (int64_t q = 1; q < count; q++)
        if (out_direct[q * n_direct + d] != c0) {
          codes_uniform = false;
          break;
        }
    }
  }
  if (codes_uniform) return bail();  // the general path ships row-uniform
  // counts as a zero-byte broadcast — a table would be strictly worse
  if (!emit_ffm_codes()) return bail();
  return 1;
}

// whether column j has overflowed to direct (raw ids on the wire)
int fwn_vocab_col_direct(void* p, int32_t col) {
  auto* v = static_cast<Vocab*>(p);
  if (size_t(col) >= v->cols.size()) return -1;
  return v->cols[size_t(col)].direct ? 1 : 0;
}

// write column j's dictionary (index order, first `cap` entries) into
// out; returns the count written. `cap` bounds the WRITE, not the
// dictionary: a snapshot region sized by an earlier layout must never be
// overflowed by inserts that happened between layout and export (the
// producer encodes batch N+1 BEFORE flushing group N; indices >= cap
// cannot appear in that group's payload, so clamping is exact).
int64_t fwn_vocab_export(void* p, int32_t col, int64_t cap, int32_t* out) {
  auto* v = static_cast<Vocab*>(p);
  if (size_t(col) >= v->cols.size() || cap <= 0) return 0;
  // export even after a direct flip: `order` is retained, and a PENDING
  // group encoded before the flip still ships dictionary indices that
  // must resolve (its layout's region covers indices < cap by
  // construction)
  const auto& o = v->cols[size_t(col)].order;
  size_t n = o.size() < size_t(cap) ? o.size() : size_t(cap);
  std::memcpy(out, o.data(), n * sizeof(int32_t));
  return int64_t(n);
}

// current dictionary size of column j (entries minted so far, retained
// across a direct flip); -1 for an out-of-range column
int64_t fwn_vocab_col_size(void* p, int32_t col) {
  auto* v = static_cast<Vocab*>(p);
  if (size_t(col) >= v->cols.size()) return -1;
  return int64_t(v->cols[size_t(col)].order.size());
}

int fwn_vocab_dirty(void* p) { return static_cast<Vocab*>(p)->dirty ? 1 : 0; }
void fwn_vocab_clear_dirty(void* p) {
  static_cast<Vocab*>(p)->dirty = false;
}

// memchr-based byte count (the Python-side bytes.count measured ~12% of
// predict-mode CPU sizing the output buffer)
int64_t fwn_count_byte(const char* buf, int64_t len, int b) {
  int64_t c = 0;
  const char* p = buf;
  const char* e = buf + len;
  while (p < e) {
    const void* hit = std::memchr(p, b, size_t(e - p));
    if (!hit) break;
    c++;
    p = static_cast<const char*>(hit) + 1;
  }
  return c;
}

// Fixed integer workload for CPU-window calibration (bench.py): the wall
// time of `iters` xorshift steps measures how much of a physical core this
// vCPU is actually getting RIGHT NOW — on this shared host both wall AND
// CLOCK_THREAD_CPUTIME swing ~4x for identical work (hypervisor steal /
// frequency scaling), so in-run CPU counters are only comparable between
// windows whose probe agrees. Returns the lattice value so the loop can't
// be optimized away.
uint64_t fwn_cpu_probe(int64_t iters) {
  uint64_t x = 88172645463325252ull;
  for (int64_t i = 0; i < iters; i++) {
    x ^= x << 13;
    x ^= x >> 7;
    x ^= x << 17;
  }
  return x;
}

// standalone hashing (tests / tooling)
uint32_t fwn_murmur3(const char* data, int64_t len, uint32_t seed) {
  return murmur3_32(reinterpret_cast<const uint8_t*>(data), size_t(len), seed);
}

// format predictions as '%.6f\n' lines (the reference's output format,
// src/main.rs:260-269); out must hold ≥ 16·n bytes; returns bytes written
// f16-bucket weight quantization (persistence/quantization.py format,
// reference: src/quantization.rs:41-95). numpy's f16<->f32 astype is a
// scalar loop (~450 ms for 10M weights, above the reference's 300 ms
// gate); F16C converts 8 lanes per instruction. Rounding is IEEE
// nearest-even in both, so outputs are bit-identical to numpy's.
// scalar float->half with IEEE round-to-nearest-even, bit-matching the F16C
// _cvtss_sh path (and numpy's astype(float16)) including denormal halves and
// NaN/Inf — so checkpoints quantized on a non-F16C toolchain stay
// bit-identical to the Python path (persistence/quantization.py).
static inline uint16_t f32_to_f16_rtne(float f) {
  uint32_t x;
  std::memcpy(&x, &f, 4);
  uint32_t sign = (x >> 16) & 0x8000u;
  uint32_t ax = x & 0x7fffffffu;
  if (ax >= 0x47800000u)  // >= 65536: overflow to inf; NaN keeps a payload
    return uint16_t(sign | 0x7c00u | ((ax > 0x7f800000u) ? 0x200u : 0u));
  uint32_t e = ax >> 23;  // biased f32 exponent
  if (e < 102) return uint16_t(sign);  // < 2^-25: underflows to signed zero
  uint32_t m = (ax & 0x7fffffu) | 0x800000u;  // mantissa with implicit bit
  // normal halves shift out 13 bits; denormal halves shift out more
  uint32_t shift = (e >= 113) ? 13u : (126u - e);
  uint32_t r = m & ((1u << shift) - 1u);
  uint32_t half = 1u << (shift - 1u);
  uint32_t v = m >> shift;
  if (r > half || (r == half && (v & 1u))) v++;
  if (e >= 113)  // v in [1024, 2048]: the +v carries into the exponent
    return uint16_t(sign | (((e - 112u) << 10) - 1024u + v));
  return uint16_t(sign | v);  // v <= 1024: denormal (or rounds up to normal)
}

// test hook: the portable scalar conversion regardless of toolchain F16C —
// lets the suite assert bit-parity with numpy on every build
uint16_t fwn_f32_to_f16_scalar(float f) { return f32_to_f16_rtne(f); }

void fwn_quantize_buckets(const float* w, int64_t n, float mn, float inc,
                          uint16_t* out) {
  // true division (not reciprocal-multiply): the numpy path divides, and
  // a ULP difference at a .5 boundary would flip a bucket
  int64_t i = 0;
#if defined(__F16C__) && defined(__AVX__)
  __m256 vmn = _mm256_set1_ps(mn);
  __m256 vinc = _mm256_set1_ps(inc);
  for (; i + 8 <= n; i += 8) {
    __m256 x = _mm256_loadu_ps(w + i);
    x = _mm256_div_ps(_mm256_sub_ps(x, vmn), vinc);
    x = _mm256_round_ps(x, _MM_FROUND_TO_NEAREST_INT | _MM_FROUND_NO_EXC);
    __m128i h = _mm256_cvtps_ph(x, _MM_FROUND_TO_NEAREST_INT);
    _mm_storeu_si128(reinterpret_cast<__m128i*>(out + i), h);
  }
#endif
  for (; i < n; i++) {
    float x = std::nearbyintf((w[i] - mn) / inc);
#if defined(__F16C__)
    out[i] = _cvtss_sh(x, _MM_FROUND_TO_NEAREST_INT);
#else
    out[i] = f32_to_f16_rtne(x);
#endif
  }
}

void fwn_dequantize_f16(const uint16_t* in, int64_t n, float mn, float inc,
                        float* out) {
  int64_t i = 0;
#if defined(__F16C__) && defined(__AVX__)
  __m256 vmn = _mm256_set1_ps(mn);
  __m256 vinc = _mm256_set1_ps(inc);
  for (; i + 8 <= n; i += 8) {
    __m128i h = _mm_loadu_si128(reinterpret_cast<const __m128i*>(in + i));
    __m256 x = _mm256_cvtph_ps(h);
    _mm256_storeu_ps(out + i, _mm256_add_ps(vmn, _mm256_mul_ps(x, vinc)));
  }
#endif
#if defined(__F16C__) && defined(__AVX__)
  if (i < n) {  // tail through the same AVX ops (the scalar expression
    // would be FMA-contracted at -O3 and round differently)
    uint16_t hbuf[8] = {0};
    float fbuf[8];
    int64_t m = n - i;
    std::memcpy(hbuf, in + i, size_t(m) * 2);
    __m256 x = _mm256_cvtph_ps(
        _mm_loadu_si128(reinterpret_cast<const __m128i*>(hbuf)));
    _mm256_storeu_ps(
        fbuf, _mm256_add_ps(_mm256_set1_ps(mn),
                            _mm256_mul_ps(x, _mm256_set1_ps(inc))));
    std::memcpy(out + i, fbuf, size_t(m) * 4);
    i = n;
  }
#endif
  for (; i < n; i++) {
    uint16_t h = in[i];
    uint32_t sign = uint32_t(h & 0x8000u) << 16;
    uint32_t exp = (h >> 10) & 0x1f;
    uint32_t man = h & 0x3ffu;
    uint32_t b;
    if (exp == 0) b = sign;  // bucket indices are integers; denormals ~ 0
    else if (exp == 31) b = sign | 0x7f800000u | (man << 13);
    else b = sign | ((exp - 15 + 127) << 23) | (man << 13);
    float x;
    std::memcpy(&x, &b, 4);
    float t = x * inc;  // two roundings, as numpy does
    out[i] = mn + t;
  }
}

int64_t fwn_format_preds(const float* preds, int64_t n, char* out) {
  char* p = out;
  for (int64_t i = 0; i < n; i++) {
    double d = double(preds[i]);
    // fast fixed-point path for the overwhelmingly common case (sigmoid
    // outputs in [0, 1]): "0.xxxxxx\n" / "1.000000\n" by integer digit
    // emission — snprintf's %.6f measured ~220 ms per 10⁶ predictions,
    // squarely on the predict-mode critical path. d·10⁶ carries ≤ ~1e-10
    // absolute product rounding error, so values within 1e-8 of a decimal
    // rounding boundary fall back to snprintf to keep byte parity with the
    // slow path (asserted over 10⁷ random inputs in tests).
    if (d >= 0.0 && d <= 1.0) {
      double scaled = d * 1e6;
      double fl = std::floor(scaled);
      double frac = scaled - fl;
      if (std::fabs(frac - 0.5) > 1e-8) {
        uint32_t v = uint32_t(std::nearbyint(scaled));  // ≤ 1000000
        p[0] = v >= 1000000 ? '1' : '0';
        if (v >= 1000000) v -= 1000000;
        p[1] = '.';
        for (int k = 7; k >= 2; k--) {
          p[k] = char('0' + v % 10);
          v /= 10;
        }
        p[8] = '\n';
        p += 9;
        continue;
      }
    }
    int ret = std::snprintf(p, 16, "%.6f\n", d);
    // snprintf returns the WOULD-BE length on truncation; clamp the advance
    // to the bytes actually written (≤15 in a 16-byte slot) so a pathological
    // value (inf/huge through this generic C ABI) cannot run p past the
    // caller's 16·n buffer. Keep the trailing newline so line counts hold.
    if (ret < 0) ret = 0;
    if (ret > 15) {
      p[14] = '\n';
      ret = 15;
    }
    p += ret;
  }
  return p - out;
}

}  // extern "C"
