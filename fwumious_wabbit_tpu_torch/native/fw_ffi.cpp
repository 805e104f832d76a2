// fw_ffi — the embedded inference C API: load a model file once, make cheap
// per-thread clones, predict on VW text lines, and amortize a shared request
// context across many candidates with the 3-call cache.
//
// This is the native equivalent of the reference's cdylib embedding API
// (reference: src/lib.rs:151-252):
//   new_fw_predictor_prototype(command) → loads weights once (immutable/
//     inference path: optimizer state skipped, reference persistence.rs:159-173)
//   clone_lite(proto)                   → cheap per-thread copy (weights shared)
//   fw_predict(ptr, line)               → full forward on one VW line
//   fw_setup_cache(ptr, context_line)   → precompute FFM contra fields +
//     interaction matrix + LR combo partials for the request context
//     (reference: src/block_ffm.rs:650-782, src/regressor.rs:412-423)
//   fw_predict_with_cache(ptr, delta)   → per-candidate forward adding only
//     the delta features (reference: src/lib.rs:88-115, block_ffm.rs:442-560)
//   free_predictor(ptr)
//
// Errors return -1.0 from predict calls, matching the reference's
// EOF/EXCEPTION error codes (src/lib.rs:47-48).
//
// The forward math mirrors the JAX model (fwumious_wabbit_tpu/models/model.py
// predict path) exactly — including this framework's aligned FFM slab
// addressing (ops/tables.py) — so C++ inference is bit-comparable to device
// inference on the same model file.

#include "fw_core.h"

#include <cstdio>
#include <memory>
#include <set>
#include <thread>
#include <unordered_set>

namespace {

using namespace fwn;

// ---------------------------------------------------------------------------
// minimal JSON (objects/arrays/strings/numbers/bools/null) — just enough for
// the two documents embedded in model files
// ---------------------------------------------------------------------------

struct Json {
  enum Kind { Null, Bool, Num, Str, Arr, Obj } kind = Null;
  bool b = false;
  double num = 0;
  std::string str;
  std::vector<Json> arr;
  std::vector<std::pair<std::string, Json>> obj;

  const Json* get(const std::string& key) const {
    for (const auto& [k, v] : obj)
      if (k == key) return &v;
    return nullptr;
  }
  double num_or(const std::string& key, double d) const {
    const Json* j = get(key);
    return j && j->kind == Num ? j->num : d;
  }
  bool bool_or(const std::string& key, bool d) const {
    const Json* j = get(key);
    return j && j->kind == Bool ? j->b : d;
  }
  std::string str_or(const std::string& key, const std::string& d) const {
    const Json* j = get(key);
    return j && j->kind == Str ? j->str : d;
  }
};

struct JsonParser {
  const char* p;
  const char* end;
  bool ok = true;

  void ws() {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r')) p++;
  }
  bool lit(const char* s) {
    size_t n = std::strlen(s);
    if (size_t(end - p) >= n && std::memcmp(p, s, n) == 0) {
      p += n;
      return true;
    }
    ok = false;
    return false;
  }
  Json parse() {
    ws();
    Json j;
    if (p >= end) {
      ok = false;
      return j;
    }
    switch (*p) {
      case '{': {
        j.kind = Json::Obj;
        p++;
        ws();
        if (p < end && *p == '}') {
          p++;
          return j;
        }
        for (;;) {
          ws();
          Json key = parse();
          if (!ok || key.kind != Json::Str) {
            ok = false;
            return j;
          }
          ws();
          if (p >= end || *p != ':') {
            ok = false;
            return j;
          }
          p++;
          j.obj.emplace_back(key.str, parse());
          ws();
          if (p < end && *p == ',') {
            p++;
            continue;
          }
          if (p < end && *p == '}') {
            p++;
            return j;
          }
          ok = false;
          return j;
        }
      }
      case '[': {
        j.kind = Json::Arr;
        p++;
        ws();
        if (p < end && *p == ']') {
          p++;
          return j;
        }
        for (;;) {
          j.arr.push_back(parse());
          ws();
          if (p < end && *p == ',') {
            p++;
            continue;
          }
          if (p < end && *p == ']') {
            p++;
            return j;
          }
          ok = false;
          return j;
        }
      }
      case '"': {
        j.kind = Json::Str;
        p++;
        while (p < end && *p != '"') {
          if (*p == '\\' && p + 1 < end) {
            p++;
            switch (*p) {
              case 'n': j.str += '\n'; break;
              case 't': j.str += '\t'; break;
              case 'r': j.str += '\r'; break;
              case 'b': j.str += '\b'; break;
              case 'f': j.str += '\f'; break;
              case 'u': {
                // \uXXXX — decode BMP code points to UTF-8
                if (p + 4 < end) {
                  unsigned cp = 0;
                  for (int i = 1; i <= 4; i++) {
                    char c = p[i];
                    cp <<= 4;
                    if (c >= '0' && c <= '9') cp |= unsigned(c - '0');
                    else if (c >= 'a' && c <= 'f') cp |= unsigned(c - 'a' + 10);
                    else if (c >= 'A' && c <= 'F') cp |= unsigned(c - 'A' + 10);
                  }
                  p += 4;
                  if (cp < 0x80) {
                    j.str += char(cp);
                  } else if (cp < 0x800) {
                    j.str += char(0xc0 | (cp >> 6));
                    j.str += char(0x80 | (cp & 0x3f));
                  } else {
                    j.str += char(0xe0 | (cp >> 12));
                    j.str += char(0x80 | ((cp >> 6) & 0x3f));
                    j.str += char(0x80 | (cp & 0x3f));
                  }
                }
                break;
              }
              default: j.str += *p;
            }
          } else {
            j.str += *p;
          }
          p++;
        }
        if (p < end) p++;  // closing quote
        return j;
      }
      case 't': j.kind = Json::Bool; j.b = true; lit("true"); return j;
      case 'f': j.kind = Json::Bool; j.b = false; lit("false"); return j;
      case 'n': j.kind = Json::Null; lit("null"); return j;
      default: {
        j.kind = Json::Num;
        char* numend = nullptr;
        j.num = std::strtod(p, &numend);
        if (numend == p) {
          ok = false;
        } else {
          p = numend;
        }
        return j;
      }
    }
  }
};

// ---------------------------------------------------------------------------
// model structures
// ---------------------------------------------------------------------------

struct NNLayer {
  int fan_in = 0, width = 0;
  std::vector<float> w;  // [fan_in, width] column-major-by-neuron? stored [in][out]
  std::vector<float> b;  // [width]
  int activation = 0;    // 0 none, 1 relu
  int layernorm = 0;     // 0 none, 1 before, 2 after
};

struct Model {
  Config cfg;                 // parser/translator config
  std::vector<int> formats;   // slot -> format
  int num_combos = 0;         // incl. constant
  int num_fields = 0;
  int ffm_k = 0;
  int ffm_align = 0;          // slab alignment (ops/tables.py make_spec)
  std::vector<float> lr_w;    // [2^b]
  std::vector<float> ffm_w;   // [ffm_weights_len]
  std::vector<NNLayer> layers;
  NNLayer final_layer;
  bool has_nn = false;
  int topology = 1;  // 1/2/4/5
  int joined_width = 0;

  // Partial-evaluation dependency sets (the 3-call serving cache): for each
  // LR combo and each FFM (field, source) entry, the primitive namespaces it
  // transitively reads (transforms resolved). A combo/entry must be
  // recomputed per candidate iff the delta line declares one of them; all
  // others reuse the context-time value.
  std::vector<std::vector<char>> combo_prim;              // [combo][ns] 0/1
  std::vector<std::vector<std::vector<char>>> field_prim; // [field][d][ns]

  void resolve_prim(int idx, int type, std::vector<char>& mark) const {
    if (type == 0) {
      if (idx >= 0 && size_t(idx) < mark.size()) mark[idx] = 1;
      return;
    }
    const TransformDef& t = cfg.transforms[idx];
    for (size_t i = 0; i < t.from.size(); i++)
      resolve_prim(t.from[i], t.from_type[i], mark);
  }

  void build_dependency_sets() {
    combo_prim.clear();
    for (const ComboDesc& c : cfg.combos) {
      std::vector<char> mark(cfg.num_namespaces, 0);
      for (size_t d = 0; d < c.ns.size(); d++)
        resolve_prim(c.ns[d], c.ns_type[d], mark);
      combo_prim.push_back(std::move(mark));
    }
    field_prim.clear();
    for (const FfmFieldDesc& f : cfg.ffm_fields) {
      std::vector<std::vector<char>> per_entry;
      for (size_t d = 0; d < f.ns.size(); d++) {
        std::vector<char> mark(cfg.num_namespaces, 0);
        resolve_prim(f.ns[d], f.ns_type[d], mark);
        per_entry.push_back(std::move(mark));
      }
      field_prim.push_back(std::move(per_entry));
    }
  }
};

int next_pow2(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// f16 (IEEE binary16) → f32, for dequantizing FFM weights
// (persistence/quantization.py stores f16 bucket indices)
float half_to_float(uint16_t h) {
  uint32_t sign = uint32_t(h & 0x8000) << 16;
  uint32_t exp = (h >> 10) & 0x1f;
  uint32_t man = h & 0x3ff;
  uint32_t bits;
  if (exp == 0) {
    if (man == 0) {
      bits = sign;
    } else {
      exp = 127 - 15 + 1;
      while ((man & 0x400) == 0) {
        man <<= 1;
        exp--;
      }
      man &= 0x3ff;
      bits = sign | (exp << 23) | (man << 13);
    }
  } else if (exp == 31) {
    bits = sign | 0x7f800000 | (man << 13);
  } else {
    bits = sign | ((exp - 15 + 127) << 23) | (man << 13);
  }
  return bits_f32(bits);
}

struct Loaded {
  std::shared_ptr<Model> model;
  std::string error;
};

bool read_exact(FILE* f, void* out, size_t n) {
  return std::fread(out, 1, n, f) == n;
}

Loaded load_model(const std::string& path) {
  Loaded out;
  FILE* f = std::fopen(path.c_str(), "rb");
  if (!f) {
    out.error = "cannot open model file: " + path;
    return out;
  }
  auto fail = [&](const std::string& msg) {
    std::fclose(f);
    out.error = msg;
    out.model = nullptr;
    return out;
  };
  char magic[4];
  uint32_t version = 0;
  if (!read_exact(f, magic, 4) || std::memcmp(magic, "FWRE", 4) != 0)
    return fail("Model file does not begin with magic bytes FWRE");
  if (!read_exact(f, &version, 4) || version != 6)
    return fail("unsupported model file version");

  auto read_chunk = [&](std::string* s) {
    uint64_t n = 0;
    if (!read_exact(f, &n, 8)) return false;
    s->resize(n);
    return n == 0 || read_exact(f, s->data(), n);
  };
  std::string vw_json, mi_json;
  if (!read_chunk(&vw_json) || !read_chunk(&mi_json))
    return fail("truncated model header");

  JsonParser vp{vw_json.data(), vw_json.data() + vw_json.size()};
  Json vw = vp.parse();
  JsonParser mp{mi_json.data(), mi_json.data() + mi_json.size()};
  Json mi = mp.parse();
  if (!vp.ok || !mp.ok) return fail("bad JSON in model header");

  auto model = std::make_shared<Model>();
  Config& cfg = model->cfg;

  // namespace map (vwmap.to_source_json layout)
  cfg.skip_prefix = int(vw.num_or("namespace_skip_prefix", 0));
  const Json* entries = vw.get("entries");
  if (!entries) return fail("namespace map missing entries");
  int max_index = -1;
  for (const Json& e : entries->arr) {
    int index = int(e.num_or("namespace_index", 0));
    int format = e.str_or("namespace_format", "Categorical") == "F32" ? 1 : 0;
    for (const char* key : {"namespace_vwname", "namespace_verbose"}) {
      std::string name = e.str_or(key, "");
      if (!name.empty())
        cfg.lookup[name] = NamespaceInfo{
            index, format,
            murmur3_32(reinterpret_cast<const uint8_t*>(name.data()),
                       name.size(), 0)};
    }
    max_index = std::max(max_index, index);
  }
  cfg.num_namespaces = max_index + 1;
  model->formats.assign(cfg.num_namespaces, 0);
  for (const auto& [name, info] : cfg.lookup)
    model->formats[info.index] = info.format;

  // model instance (model_instance.to_json layout)
  int bit_precision = int(mi.num_or("bit_precision", 18));
  cfg.lr_mask = (1u << bit_precision) - 1;
  cfg.add_constant = mi.bool_or("add_constant_feature", true);
  auto ns_type_of = [](const Json& nd) {
    return nd.str_or("namespace_type", "Primitive") == "Transformed" ? 1 : 0;
  };
  const Json* combos = mi.get("feature_combo_descs");
  if (combos)
    for (const Json& c : combos->arr) {
      ComboDesc d;
      d.weight = float(c.num_or("weight", 1.0));
      const Json* nds = c.get("namespace_descriptors");
      if (nds)
        for (const Json& nd : nds->arr) {
          d.ns.push_back(int(nd.num_or("namespace_index", 0)));
          d.ns_type.push_back(ns_type_of(nd));
        }
      cfg.combos.push_back(std::move(d));
    }

  // transform namespaces (--transform statements, resolved order)
  const Json* tn = mi.get("transform_namespaces");
  if (tn && tn->get("v")) {
    int index = 0;
    for (const Json& tj : tn->get("v")->arr) {
      TransformDef t;
      std::string fn = tj.str_or("function_name", "");
      if (fn == "BinnerSqrt") t.kind = TransformDef::BinnerSqrt;
      else if (fn == "BinnerSqrtPlain") t.kind = TransformDef::BinnerSqrtPlain;
      else if (fn == "BinnerLog") t.kind = TransformDef::BinnerLog;
      else if (fn == "BinnerLogPlain") t.kind = TransformDef::BinnerLogPlain;
      else if (fn == "BinnerLogRatio") t.kind = TransformDef::BinnerLogRatio;
      else if (fn == "BinnerLogRatioPlain") t.kind = TransformDef::BinnerLogRatioPlain;
      else if (fn == "Weight") t.kind = TransformDef::Weight;
      else if (fn == "Combine") t.kind = TransformDef::Combine;
      else return fail("unknown transform function: " + fn);
      const Json* params = tj.get("function_parameters");
      bool is_binner = t.kind <= TransformDef::BinnerLogRatioPlain;
      if (params && !params->arr.empty()) {
        t.p0 = float(params->arr[0].num);
        if (params->arr.size() > 1) t.p1 = float(params->arr[1].num);
      } else if (is_binner) {
        t.p0 = 0.0f;
        t.p1 = 1.0f;
      }
      const Json* froms = tj.get("from_namespaces");
      if (froms)
        for (const Json& fj : froms->arr) {
          const Json* nd = fj.get("namespace_descriptor");
          if (nd) {
            t.from.push_back(int(nd->num_or("namespace_index", 0)));
            t.from_type.push_back(ns_type_of(*nd));
          }
        }
      fill_transform_seeds(t, index++);
      cfg.transforms.push_back(std::move(t));
    }
  }
  model->num_combos = int(cfg.combos.size()) + (cfg.add_constant ? 1 : 0);

  model->ffm_k = int(mi.num_or("ffm_k", 0));
  int ffm_bits = int(mi.num_or("ffm_bit_precision", 0));
  const Json* fields = mi.get("ffm_fields");
  if (model->ffm_k > 0 && fields) {
    int dim_bits = 0;
    while (model->ffm_k > (1 << dim_bits)) dim_bits++;
    cfg.ffm_mask = ((1u << ffm_bits) - 1) ^ ((1u << dim_bits) - 1);
    for (const Json& fj : fields->arr) {
      FfmFieldDesc f;
      for (const Json& nd : fj.arr) {
        f.ns.push_back(int(nd.num_or("namespace_index", 0)));
        f.ns_type.push_back(
            nd.str_or("namespace_type", "Primitive") == "Transformed" ? 1 : 0);
      }
      cfg.ffm_fields.push_back(std::move(f));
    }
    model->num_fields = int(cfg.ffm_fields.size());
    int slab = model->num_fields * model->ffm_k;
    model->ffm_align = slab <= 128 ? next_pow2(slab) : ((slab + 127) / 128) * 128;
  }
  cfg.num_threads = 1;
  cfg.finalize_lookup();

  std::string optimizer = mi.str_or("optimizer", "AdagradFlex");
  bool has_state = optimizer != "SGD";
  bool dequantize = mi.get("dequantize_weights") &&
                    mi.get("dequantize_weights")->kind == Json::Bool &&
                    mi.get("dequantize_weights")->b;

  uint64_t total = 0;
  if (!read_exact(f, &total, 8)) return fail("truncated model file");

  // LR block: interleaved (w, acc) pairs when has_state
  size_t lr_n = size_t(1) << bit_precision;
  model->lr_w.resize(lr_n);
  if (has_state) {
    // de-interleave (w, acc) pairs in 8 MB chunks: a whole-table temp would
    // double the peak RSS and add ~0.2 s of page faults on a 2^25 table
    // (predict-mode startup is on the measured path, BENCHMARK.md:22)
    constexpr size_t CH = size_t(1) << 20;  // pairs per chunk
    std::vector<float> tmp(CH * 2);
    size_t done = 0;
    while (done < lr_n) {
      size_t m = std::min(CH, lr_n - done);
      if (!read_exact(f, tmp.data(), m * 8)) return fail("truncated LR block");
      float* dst = model->lr_w.data() + done;
      for (size_t i = 0; i < m; i++) dst[i] = tmp[2 * i];
      done += m;
    }
  } else {
    if (!read_exact(f, model->lr_w.data(), lr_n * 4))
      return fail("truncated LR block");
  }

  if (model->ffm_k > 0 && model->num_fields > 0) {
    size_t n = (size_t(1) << ffm_bits) +
               size_t(model->num_fields) * size_t(model->ffm_k);
    model->ffm_w.resize(n);
    if (dequantize) {
      // quantization header: f32 increment, f32 min; values are f16 bucket
      // indices (persistence/quantization.py format, mirroring
      // reference src/quantization.rs:41-95)
      float winc = 0, wmin = 0;
      if (!read_exact(f, &winc, 4) || !read_exact(f, &wmin, 4))
        return fail("truncated quantization header");
      std::vector<uint16_t> q(n);
      if (!read_exact(f, q.data(), n * 2)) return fail("truncated FFM block");
      for (size_t i = 0; i < n; i++)
        model->ffm_w[i] = wmin + half_to_float(q[i]) * winc;
    } else {
      if (!read_exact(f, model->ffm_w.data(), n * 4))
        return fail("truncated FFM block");
      if (has_state) {
        if (std::fseek(f, long(n * 4), SEEK_CUR) != 0)
          return fail("truncated FFM optimizer state");
      }
    }
  }

  // NN tower (model_file._nn_layer_bytes layout: neuron-major weights then
  // biases, then same-length optimizer state when has_state)
  const Json* nn = mi.get("nn_config");
  int tri_width = model->num_fields * (model->num_fields + 1) / 2;
  model->joined_width =
      model->num_combos + (model->ffm_k > 0 ? tri_width : 0);
  std::string topo = nn ? nn->str_or("topology", "one") : "one";
  model->topology = topo == "two" ? 2 : topo == "four" ? 4 : topo == "five" ? 5 : 1;
  const Json* layers = nn ? nn->get("layers") : nullptr;
  if (layers && !layers->arr.empty()) {
    model->has_nn = true;
    int d = model->joined_width;
    auto read_layer = [&](int fan_in, int width, const Json* spec) -> NNLayer {
      NNLayer l;
      l.fan_in = fan_in;
      l.width = width;
      if (spec) {
        std::string act = spec->str_or("activation", "none");
        l.activation = act == "relu" ? 1 : 0;
        std::string lnorm = spec->str_or("layernorm", "none");
        l.layernorm = lnorm == "before" ? 1 : lnorm == "after" ? 2 : 0;
      }
      std::vector<float> flat(size_t(fan_in + 1) * width);
      if (!read_exact(f, flat.data(), flat.size() * 4)) {
        l.fan_in = -1;  // signal error
        return l;
      }
      // neuron-major → [in][out]
      l.w.resize(size_t(fan_in) * width);
      for (int j = 0; j < width; j++)
        for (int i = 0; i < fan_in; i++)
          l.w[size_t(i) * width + j] = flat[size_t(j) * fan_in + i];
      l.b.assign(flat.begin() + size_t(fan_in) * width, flat.end());
      if (has_state)
        if (std::fseek(f, long(flat.size() * 4), SEEK_CUR) != 0) l.fan_in = -1;
      return l;
    };
    for (const Json& spec : layers->arr) {
      int width = 20;
      const Json* wj = spec.get("width");
      if (wj) width = wj->kind == Json::Str ? std::atoi(wj->str.c_str())
                                            : int(wj->num);
      NNLayer l = read_layer(d, width, &spec);
      if (l.fan_in < 0) return fail("truncated NN layer");
      model->layers.push_back(std::move(l));
      d = width;
    }
    int final_in = d + (model->topology != 2 ? model->joined_width : 0);
    model->final_layer = read_layer(final_in, 1, nullptr);
    if (model->final_layer.fan_in < 0) return fail("truncated final layer");
  }

  std::fclose(f);
  model->build_dependency_sets();
  out.model = model;
  return out;
}

// ---------------------------------------------------------------------------
// forward math (mirrors models/model.py predict path)
// ---------------------------------------------------------------------------

// True partial-evaluation context cache (reference: src/block_lr.rs:205-255,
// src/block_ffm.rs:650-782, src/parser.rs:171-212 — and strictly stronger:
// the reference re-parses + re-translates the WHOLE concatenated line per
// candidate and skips work inside the blocks; here the context's parsed
// RECORD, per-combo LR sums and contra tensor are cached, so a candidate
// costs parse(delta) + the delta-dependent combos/entries + F²k dots +
// tower — ~independent of context size.
struct FfmCache {
  bool active = false;
  std::vector<uint32_t> ctx_rec;  // the context's parsed packed record
  std::vector<float> contra;  // [F][F*k]  C[t][f*k..] = Σ_{a∈f} v_a·w_a→t
  std::vector<float> diag;    // [F] Σ_{a∈t} v_a²‖w_a→t‖²
  std::string context;        // raw context line bytes (no newline; fallback)
  std::vector<float> lr_partial;  // per-combo context sums Σ w[h]·v (+const)
};

extern thread_local std::string g_last_error;  // defined with the C ABI below

struct Predictor {
  std::shared_ptr<Model> model;
  Shard sh;  // scratch translation output
  FfmCache cache;
  // per-predictor scratch (capacity retained across calls — the serving
  // hot path must not allocate per candidate)
  std::vector<float> sx, scontra, sdiag;

  const float* slab(uint32_t h) const {
    // the slab address quantization must mirror ops/tables.py gather():
    // align ≤ 128 → h & ~(align−1); align > 128 (multi-row slabs) →
    // row-aligned start h & ~127
    size_t mask = model->ffm_align <= 128 ? size_t(model->ffm_align - 1) : size_t(127);
    size_t start = size_t(h) & ~mask;
    return model->ffm_w.data() + start;
  }

  // translate one line into sh (single example); returns false on error
  bool translate_line(const std::string& line, bool primitive_only_ffm) {
    sh.clear();
    std::vector<uint32_t> rec;
    std::string err;
    LineKind kind = parse_line(
        model->cfg, reinterpret_cast<const uint8_t*>(line.data()), line.size(),
        rec, err);
    if (kind != LineKind::Example) return false;
    // the cache path keeps only primitive FFM features, mirroring
    // translate_and_filter (reference: src/feature_buffer.rs:286-312)
    translate_record(model->cfg, rec.data(), model->formats, sh,
                     primitive_only_ffm);
    sh.lr_start.push_back(int32_t(sh.lr_ids.size()));
    sh.ffm_start.push_back(int32_t(sh.ffm_ids.size()));
    return true;
  }

  // contra[t][f*k+kk] += sign·v·w_a→t[kk] for one feature a in field f
  // (sign −1 retracts a context contribution the delta supersedes)
  void add_feature_to_contra(std::vector<float>& contra, std::vector<float>& diag,
                             uint32_t h, float v, int field,
                             float sign = 1.0f) const {
    const Model& m = *model;
    int F = m.num_fields, k = m.ffm_k, Fk = F * k;
    const float* w = slab(h);
    for (int t = 0; t < F; t++) {
      float* row = contra.data() + size_t(t) * Fk + size_t(field) * k;
      const float* wt = w + size_t(t) * k;
      for (int kk = 0; kk < k; kk++) row[kk] += sign * v * wt[kk];
    }
    const float* wself = w + size_t(field) * k;
    float ss = 0;
    for (int kk = 0; kk < k; kk++) ss += wself[kk] * wself[kk];
    diag[field] += sign * v * v * ss;
  }

  // Σ w[h & mask]·v·combo.weight over the combo's chained interaction
  // features, read through ``view`` (the per-combo piece of
  // translate_record + the LR gather, fw_core.h:582-601)
  float combo_sum(const RecView& view, size_t combo_idx) const {
    const Model& m = *model;
    const ComboDesc& combo = m.cfg.combos[combo_idx];
    thread_local Feats cur, feats, nxt;
    cur.clear();
    read_features(m.cfg, view, m.formats, combo.ns[0], combo.ns_type[0], cur);
    for (size_t d = 1; d < combo.ns.size(); d++) {
      feats.clear();
      read_features(m.cfg, view, m.formats, combo.ns[d], combo.ns_type[d], feats);
      nxt.clear();
      for (const auto& [h_acc, v_acc] : cur) {
        uint32_t half = h_acc * VOWPAL_FNV_PRIME;
        for (const auto& [h, v] : feats) nxt.emplace_back(h ^ half, v_acc * v);
      }
      std::swap(cur, nxt);
    }
    float s = 0;
    for (const auto& [h, v] : cur)
      s += m.lr_w[h & m.cfg.lr_mask] * v * combo.weight;
    return s;
  }

  // add (sign=+1) or retract (sign=−1) one FFM (field, source) entry's
  // features into contra/diag, read through ``view``
  void entry_contra(const RecView& view, int field, size_t d, float sign,
                    std::vector<float>& contra, std::vector<float>& diag) const {
    const Model& m = *model;
    const FfmFieldDesc& f = m.cfg.ffm_fields[field];
    thread_local Feats feats;
    feats.clear();
    read_features(m.cfg, view, m.formats, f.ns[d], f.ns_type[d], feats);
    for (const auto& [h, v] : feats)
      add_feature_to_contra(contra, diag, h & m.cfg.ffm_mask, v, field, sign);
  }

  // F×F interaction matrix → lower-triangle outputs appended to x
  void triangle_outputs(const std::vector<float>& contra,
                        const std::vector<float>& diag,
                        std::vector<float>& x) const {
    const Model& m = *model;
    int F = m.num_fields, k = m.ffm_k, Fk = F * k;
    for (int i = 0; i < F; i++) {
      for (int j = 0; j <= i; j++) {
        // inter[i][j] = 0.5·⟨C[i][j·k..], C[j][i·k..]⟩ (− diag corr on i==j)
        const float* a = contra.data() + size_t(i) * Fk + size_t(j) * k;
        const float* b = contra.data() + size_t(j) * Fk + size_t(i) * k;
        float dot = 0;
        for (int kk = 0; kk < k; kk++) dot += a[kk] * b[kk];
        float inter = 0.5f * dot - (i == j ? 0.5f * diag[i] : 0.0f);
        x.push_back(i == j ? inter : 2.0f * inter);
      }
    }
  }

  static void normalize_predict(std::vector<float>& t) {
    // prediction-path normalize: x/σ with the reference's quirky variance
    // (reference: src/block_normalize.rs:130-163, models/model.py)
    double mean = 0;
    for (float v : t) mean += v;
    mean /= double(t.size());
    double var = 0;
    for (float v : t) {
      double w = mean * mean - v;
      var += w * w;
    }
    var = (var + 1e-2) / double(t.size());
    float sigma = float(std::sqrt(var));
    for (float& v : t) v /= sigma;
  }

  float tower(const std::vector<float>& x) const {
    const Model& m = *model;
    std::vector<float> t = x;
    if (m.topology == 4) normalize_predict(t);
    // topology five's stop-gradient is an identity at inference
    for (const NNLayer& l : m.layers) {
      std::vector<float> out(l.width);
      for (int j = 0; j < l.width; j++) {
        float acc = l.b[j];
        for (int i = 0; i < l.fan_in; i++)
          acc += t[i] * l.w[size_t(i) * l.width + j];
        out[j] = acc;
      }
      if (l.layernorm == 1) normalize_predict(out);
      if (l.activation == 1)
        for (float& v : out)
          if (v < 0) v = 0;
      if (l.layernorm == 2) normalize_predict(out);
      t = std::move(out);
    }
    if (m.topology != 2) t.insert(t.end(), x.begin(), x.end());
    const NNLayer& fl = m.final_layer;
    float logit = fl.b[0];
    for (int i = 0; i < fl.fan_in; i++) logit += t[i] * fl.w[i];
    return logit;
  }

  float finish(std::vector<float>& x) const {
    float logit;
    if (model->has_nn) {
      logit = tower(x);
    } else {
      logit = 0;
      for (float v : x) logit += v;
    }
    if (std::isnan(logit)) return 0.5f;
    if (logit > 50.0f) logit = 50.0f;
    if (logit < -50.0f) logit = -50.0f;
    return 1.0f / (1.0f + std::exp(-logit));
  }

  // forward over the example currently translated into ``sh``
  float forward_translated() {
    const Model& m = *model;
    std::vector<float>& x = sx;
    x.assign(size_t(m.num_combos), 0.0f);
    // hashed gathers are uniform over a 128+ MB table — one cache+TLB miss
    // each. Issue all the prefetches before the dependent sum loop so the
    // misses overlap instead of serializing (the reference leans on the
    // same trick in its SSE paths, src/block_ffm.rs:106-114).
    for (size_t i = 0; i < sh.lr_ids.size(); i++)
      __builtin_prefetch(m.lr_w.data() + sh.lr_ids[i], 0, 1);
    for (size_t i = 0; i < sh.lr_ids.size(); i++)
      x[sh.lr_combos[i]] += m.lr_w[sh.lr_ids[i]] * sh.lr_vals[i];
    if (m.ffm_k > 0 && m.num_fields > 0) {
      int F = m.num_fields, Fk = F * m.ffm_k;
      scontra.assign(size_t(F) * Fk, 0.0f);
      sdiag.assign(size_t(F), 0.0f);
      for (size_t i = 0; i < sh.ffm_ids.size(); i++)
        add_feature_to_contra(scontra, sdiag, sh.ffm_ids[i], sh.ffm_vals[i],
                              sh.ffm_fields[i]);
      triangle_outputs(scontra, sdiag, x);
    }
    return finish(x);
  }

  float predict(const std::string& line) {
    if (!translate_line(line, false)) return -1.0f;
    return forward_translated();
  }

  // Bulk forward over a block of newline-terminated VW lines — the CLI
  // predict (-t) fast path. The reference's predict mode is exactly this
  // host-side per-line loop at ~592k lines/s (reference: src/main.rs:
  // 213-270 with update=false, BENCHMARK.md:22); keeping it on the host
  // skips the device link entirely. Stops at the first non-example line:
  // status 0 = consumed what it could (partial tail line stays unconsumed),
  // 1 = empty line (end-of-stream, reference's size-0 record), 2 = flush
  // command, 3 = hogwild_load command (both abort a file run, like the
  // reference's main loop), 4 = parse error (message via
  // fw_ffi_last_error). Returns the number of predictions written.
  int64_t predict_block(const char* buf, int64_t len, float* out, int64_t cap,
                        int64_t* consumed, int32_t* status) {
    const Model& m = *model;
    *status = 0;
    int64_t n_out = 0, i = 0;
    std::vector<uint32_t> rec;
    std::string err;
    while (i < len && n_out < cap) {
      const void* nl = std::memchr(buf + i, '\n', size_t(len - i));
      if (!nl) break;  // partial tail line: caller carries it over
      int64_t j = int64_t(static_cast<const char*>(nl) - buf);
      rec.clear();
      LineKind kind = parse_line(
          m.cfg, reinterpret_cast<const uint8_t*>(buf + i), size_t(j - i),
          rec, err);
      if (kind != LineKind::Example) {
        *consumed = i;
        if (kind == LineKind::Empty) *status = 1;
        else if (kind == LineKind::Flush) *status = 2;
        else if (kind == LineKind::HogwildLoad) *status = 3;
        else { g_last_error = err; *status = 4; }
        return n_out;
      }
      sh.clear();
      translate_record(m.cfg, rec.data(), model->formats, sh, false);
      sh.lr_start.push_back(int32_t(sh.lr_ids.size()));
      sh.ffm_start.push_back(int32_t(sh.ffm_ids.size()));
      out[n_out++] = forward_translated();
      i = j + 1;
    }
    *consumed = i;
    return n_out;
  }

  // Multi-threaded bulk forward: shards the block's lines across `T`
  // newline-aligned ranges, each walked by a lite context (weights
  // shared via the Model shared_ptr, scratch private — same sharing
  // shape as clone_lite). Output order and the stop-at-first-special-
  // line contract match predict_block exactly: the earliest special
  // line (empty / flush / hogwild_load / parse error) wins, its range's
  // predictions stop there, later ranges are discarded. The reference's
  // predict mode is single-core by design (src/main.rs:213-270); this
  // scales the CLI predict path with host cores. Serial fallback for
  // small blocks and for callers whose `cap` cannot hold every line
  // (the capped-resume contract is only implemented serially).
  int64_t predict_block_mt(const char* buf, int64_t len, float* out,
                           int64_t cap, int64_t* consumed, int32_t* status,
                           int32_t T) {
    if (T <= 1 || len < (1 << 20))
      return predict_block(buf, len, out, cap, consumed, status);
    int64_t n_lines = 0;
    for (const char* p = buf, *end = buf + len;
         (p = static_cast<const char*>(
              std::memchr(p, '\n', size_t(end - p)))) != nullptr;
         p++)
      n_lines++;
    if (n_lines > cap)
      return predict_block(buf, len, out, cap, consumed, status);

    std::vector<std::pair<int64_t, int64_t>> ranges;
    int64_t chunk = len / T + 1, s = 0;
    while (s < len) {
      int64_t e = s + chunk;
      if (e >= len) {
        e = len;
      } else {
        const void* nl = std::memchr(buf + e, '\n', size_t(len - e));
        e = nl ? static_cast<const char*>(nl) - buf + 1 : len;
      }
      ranges.emplace_back(s, e);
      s = e;
    }
    int R = int(ranges.size());
    struct Part {
      std::vector<float> preds;
      int64_t consumed_end = 0;
      int64_t ev_off = -1;
      int32_t ev_status = 0;
      std::string err;
    };
    size_t nparts = size_t(R);
    std::vector<Part> parts(nparts);
    auto work = [&](int r) {
      auto [rs, re] = ranges[size_t(r)];
      Predictor lite;
      lite.model = model;
      Part& P = parts[size_t(r)];
      P.consumed_end = rs;
      int64_t i = rs;
      std::vector<uint32_t> rec;
      std::string err;
      while (i < re) {
        const void* nl = std::memchr(buf + i, '\n', size_t(re - i));
        if (!nl) break;  // partial tail line (last range only)
        int64_t j = static_cast<const char*>(nl) - buf;
        rec.clear();
        LineKind kind = parse_line(
            model->cfg, reinterpret_cast<const uint8_t*>(buf + i),
            size_t(j - i), rec, err);
        if (kind != LineKind::Example) {
          P.ev_off = i;
          P.ev_status = kind == LineKind::Empty    ? 1
                        : kind == LineKind::Flush ? 2
                        : kind == LineKind::HogwildLoad ? 3 : 4;
          P.err = err;
          return;
        }
        lite.sh.clear();
        translate_record(model->cfg, rec.data(), model->formats, lite.sh,
                         false);
        lite.sh.lr_start.push_back(int32_t(lite.sh.lr_ids.size()));
        lite.sh.ffm_start.push_back(int32_t(lite.sh.ffm_ids.size()));
        P.preds.push_back(lite.forward_translated());
        i = j + 1;
        P.consumed_end = i;
      }
    };
    std::vector<std::thread> ts;
    ts.reserve(size_t(R));
    for (int r = 0; r < R; r++) ts.emplace_back(work, r);
    for (auto& t : ts) t.join();

    // ranges are byte-ordered, a range stops at its first special line,
    // so the FIRST range reporting an event holds the earliest one
    int ev_r = -1;
    for (int r = 0; r < R; r++)
      if (parts[size_t(r)].ev_off >= 0) {
        ev_r = r;
        break;
      }
    int64_t n_out = 0;
    int last_r = ev_r >= 0 ? ev_r : R - 1;
    for (int r = 0; r <= last_r; r++)
      for (float v : parts[size_t(r)].preds) out[n_out++] = v;
    if (ev_r >= 0) {
      *consumed = parts[size_t(ev_r)].ev_off;
      *status = parts[size_t(ev_r)].ev_status;
      if (*status == 4) g_last_error = parts[size_t(ev_r)].err;
    } else {
      *consumed = parts[size_t(R - 1)].consumed_end;
      *status = 0;
    }
    return n_out;
  }

  float setup_cache(const std::string& line) {
    const Model& m = *model;
    cache.active = false;
    // parse ONCE, keep the packed record — candidates never re-touch the
    // context bytes (the reference re-parses the whole concatenated line
    // per candidate, src/parser.rs:196-212; this is the stronger form)
    std::vector<uint32_t> rec;
    std::string err;
    LineKind kind = parse_line(
        m.cfg, reinterpret_cast<const uint8_t*>(line.data()), line.size(),
        rec, err);
    if (kind != LineKind::Example) return -1.0f;
    cache.ctx_rec = std::move(rec);
    cache.context = line;
    while (!cache.context.empty() &&
           (cache.context.back() == '\n' || cache.context.back() == '\r'))
      cache.context.pop_back();

    const RecView view{cache.ctx_rec.data(), nullptr};
    // per-combo context sums (reference: block_lr.rs prepare_forward_cache)
    cache.lr_partial.assign(size_t(m.num_combos), 0.0f);
    for (size_t c = 0; c < m.cfg.combos.size(); c++)
      cache.lr_partial[c] = combo_sum(view, c);
    if (m.cfg.add_constant)
      cache.lr_partial[m.cfg.combos.size()] =
          m.lr_w[CONSTANT_HASH & m.cfg.lr_mask];

    // full contra tensor of the context — including transformed namespaces
    // (the reference caches primitive-only and re-adds the rest per
    // candidate; here delta-dependent entries are retracted+recomputed via
    // the dependency sets, so everything cacheable is cached)
    int F = m.num_fields, Fk = F * m.ffm_k;
    cache.contra.assign(size_t(F) * Fk, 0.0f);
    cache.diag.assign(size_t(F), 0.0f);
    for (int field = 0; field < F; field++)
      for (size_t d = 0; d < m.cfg.ffm_fields[field].ns.size(); d++)
        entry_contra(view, field, d, 1.0f, cache.contra, cache.diag);
    cache.active = true;
    return 0.0f;
  }

  float predict_with_cache(const std::string& delta) {
    if (!cache.active) return predict(delta);
    const Model& m = *model;

    // the delta must be pure namespace declarations (" |B x ..."); anything
    // else (labels, importance) would splice into the context's token
    // stream under concatenation — fall back to the exact concat parse
    size_t s = 0;
    while (s < delta.size() && (delta[s] == ' ' || delta[s] == '\t')) s++;
    size_t e = delta.size();
    while (e > s && (delta[e - 1] == '\n' || delta[e - 1] == '\r')) e--;
    if (s == e) {  // empty delta: the context alone
      sx.assign(cache.lr_partial.begin(), cache.lr_partial.end());
      if (m.ffm_k > 0 && m.num_fields > 0)
        triangle_outputs(cache.contra, cache.diag, sx);
      return finish(sx);
    }
    if (delta[s] != '|') {
      std::string full = cache.context + delta;
      return predict(full);
    }

    // parse ONLY the delta bytes (their own record; namespaces declared in
    // the delta REPLACE the context's slots, matching concatenated-line
    // parse semantics — see RecView in fw_core.h)
    thread_local std::vector<uint32_t> drec;
    drec.clear();
    std::string err;
    LineKind kind = parse_line(
        m.cfg, reinterpret_cast<const uint8_t*>(delta.data() + s), e - s,
        drec, err);
    if (kind != LineKind::Example) return -1.0f;
    const RecView view{cache.ctx_rec.data(), drec.data()};
    const RecView ctx_view{cache.ctx_rec.data(), nullptr};

    auto delta_present = [&](int ns) {
      return drec[HEADER_LEN + ns] != NO_FEATURES;
    };
    auto dep_hit = [&](const std::vector<char>& mark) {
      for (int ns = 0; ns < m.cfg.num_namespaces; ns++)
        if (mark[ns] && delta_present(ns)) return true;
      return false;
    };

    // LR: cached combo sums; recompute only delta-dependent combos
    std::vector<float>& x = sx;
    x.assign(cache.lr_partial.begin(), cache.lr_partial.end());
    for (size_t c = 0; c < m.cfg.combos.size(); c++)
      if (dep_hit(m.combo_prim[c])) x[c] = combo_sum(view, c);

    if (m.ffm_k > 0 && m.num_fields > 0) {
      scontra.assign(cache.contra.begin(), cache.contra.end());
      sdiag.assign(cache.diag.begin(), cache.diag.end());
      for (int field = 0; field < m.num_fields; field++)
        for (size_t d = 0; d < m.cfg.ffm_fields[field].ns.size(); d++)
          if (dep_hit(m.field_prim[field][d])) {
            // retract the context-time contribution of this entry (usually
            // empty: the delta namespace was absent at setup), then add the
            // merged-view contribution
            entry_contra(ctx_view, field, d, -1.0f, scontra, sdiag);
            entry_contra(view, field, d, 1.0f, scontra, sdiag);
          }
      triangle_outputs(scontra, sdiag, x);
    }
    return finish(x);
  }
};

// naive shellword split (enough for "-i model.fwt --flag value")
std::vector<std::string> shellwords(const std::string& s) {
  std::vector<std::string> out;
  std::string cur;
  bool in_q = false, in_dq = false;
  for (char c : s) {
    if (in_q) {
      if (c == '\'') in_q = false;
      else cur += c;
    } else if (in_dq) {
      if (c == '"') in_dq = false;
      else cur += c;
    } else if (c == '\'') {
      in_q = true;
    } else if (c == '"') {
      in_dq = true;
    } else if (c == ' ' || c == '\t') {
      if (!cur.empty()) {
        out.push_back(cur);
        cur.clear();
      }
    } else {
      cur += c;
    }
  }
  if (!cur.empty()) out.push_back(cur);
  return out;
}

// thread_local: the TCP server calls new_fw_predictor_prototype (via
// hogwild_load) from concurrent connection-handler threads; errno-style
// per-thread storage makes concurrent swaps race-free.
thread_local std::string g_last_error;

}  // namespace

// ---------------------------------------------------------------------------
// C API (names match the reference's cdylib, src/lib.rs:151-252)
// ---------------------------------------------------------------------------

extern "C" {

void* new_fw_predictor_prototype(const char* command) {
  g_last_error.clear();
  std::vector<std::string> words = shellwords(command ? command : "");
  std::string model_path;
  for (size_t i = 0; i + 1 < words.size(); i++)
    if (words[i] == "-i" || words[i] == "--initial_regressor")
      model_path = words[i + 1];
  if (model_path.empty() && !words.empty() && words.size() == 1)
    model_path = words[0];  // convenience: bare path accepted
  if (model_path.empty()) {
    g_last_error = "Cannot resolve input weights file name";
    return nullptr;
  }
  Loaded loaded = load_model(model_path);
  if (!loaded.model) {
    g_last_error = loaded.error;
    return nullptr;
  }
  auto* p = new Predictor();
  p->model = loaded.model;
  return p;
}

void* clone_lite(void* prototype) {
  if (!prototype) return nullptr;
  auto* proto = static_cast<Predictor*>(prototype);
  auto* p = new Predictor();
  p->model = proto->model;  // weights shared, scratch/cache private
  return p;
}

float fw_predict(void* ptr, const char* input_buffer) {
  if (!ptr || !input_buffer) return -1.0f;
  return static_cast<Predictor*>(ptr)->predict(input_buffer);
}

float fw_setup_cache(void* ptr, const char* input_buffer) {
  if (!ptr || !input_buffer) return -1.0f;
  return static_cast<Predictor*>(ptr)->setup_cache(input_buffer);
}

float fw_predict_with_cache(void* ptr, const char* input_buffer) {
  if (!ptr || !input_buffer) return -1.0f;
  return static_cast<Predictor*>(ptr)->predict_with_cache(input_buffer);
}

int64_t fw_predict_block(void* ptr, const char* buf, int64_t len, float* out,
                         int64_t cap, int64_t* consumed, int32_t* status) {
  if (!ptr || !buf || !out || !consumed || !status) {
    if (status) *status = 4;
    if (consumed) *consumed = 0;
    g_last_error = "fw_predict_block: null argument";
    return 0;
  }
  return static_cast<Predictor*>(ptr)->predict_block(buf, len, out, cap,
                                                     consumed, status);
}

int64_t fw_predict_block_mt(void* ptr, const char* buf, int64_t len,
                            float* out, int64_t cap, int64_t* consumed,
                            int32_t* status, int32_t threads) {
  if (!ptr || !buf || !out || !consumed || !status) {
    if (status) *status = 4;
    if (consumed) *consumed = 0;
    g_last_error = "fw_predict_block_mt: null argument";
    return 0;
  }
  return static_cast<Predictor*>(ptr)->predict_block_mt(
      buf, len, out, cap, consumed, status, threads);
}

void free_predictor(void* ptr) { delete static_cast<Predictor*>(ptr); }

const char* fw_ffi_last_error() { return g_last_error.c_str(); }

}  // extern "C"
