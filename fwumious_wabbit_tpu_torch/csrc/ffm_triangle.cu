// FFM field-pair interactions, forward and backward, with the slab gather
// fused in — hand-written for Hopper (sm_90a).
//
// The forward replaces the TPU kernel
// fwumious_wabbit_tpu/ops/pallas/ffm.py::ffm_triangle (pl.pallas_call at
// ffm.py:131, body _ffm_kernel at ffm.py:73-111) together with the slab
// gather before it (ops/tables.py gather). Same function, not a
// block-by-block copy. With e[n] the F·k floats of feature n's slab,
//
//   C[t][f][:]   = sum over n with field(n) == f of v_n * e[n][t*k : (t+1)*k]
//   diag[t]      = 0.5 * sum over n with field(n) == t of v_n^2 * |e[n][t*k : (t+1)*k]|^2
//   inter[t][f]  = 0.5 * <C[t][f][:], C[f][t][:]>  -  [t == f] * diag[t]
//   out[b, tri(i, j)] = inter[i][j] * (j < i ? 2 : 1)   (row-major lower triangle)
//
// The backward replaces what the JAX package takes from jax.vjp through XLA
// (the unfused path, fwumious_wabbit_tpu/models/model.py:418-443). With
// G[t][f] = G[f][t] the upstream gradient of triangle entry
// (max(t, f), min(t, f)) — the off-diagonal x2 is folded in, since that
// entry is <C[i][j], C[j][i]>:
//
//   d emb[n, t*k + kk] = v_n * G[t][f_n] * C[f_n][t][kk]
//                        - [t == f_n] * G[t][t] * v_n^2 * e[n][t*k + kk]
//
// and 0 where f_n is outside [0, F) or v_n is 0. No gradient flows to vals
// or fields.
//
// The slab gather (tables.gather's rule): feature n's slab is the F·k
// contiguous floats of the flat table from base = id & mask, where mask =
// ~(align - 1) when a slab fits in one 128-float row (align = F·k rounded up
// to a power of two) and ~127 otherwise. The [B, N, F·k] slab tensor is
// never written to device memory. Both kernels read the table only; it is
// updated after both backward passes of a train step.
//
// Inputs: table [R, 128] f32, ids [B, N] i32, vals [B, N] f32, fields [B, N]
// i32, all contiguous; out and g_out [B, F(F+1)/2] f32; d_emb [B, N, F*k] f32.
// Padding is inert in both forms the repo produces: fields == -1 (or any
// value outside [0, F)) never matches a field, and val 0.0 contributes 0.
//
// What bounds them on this card. Bytes, not operations: an example takes
// ~700 flops against hundreds of bytes (F=2, k=8, N=4: 48 bytes of ids,
// values and fields, up to 256 of slabs, 12 of triangle, and 256 of d emb
// in the backward). At B=32,768 on the first 32,768 lines of
// chip_smoke.py's 1M file, whose ids name few distinct slabs, the forward
// must move 2.2 MB (0.66 us at 3.35 TB/s) and the backward 10.6 MB
// (3.17 us). Below B of about 4k the bytes take less time than a launch:
// the floor there is the launch itself (an empty kernel at the same grid
// and shared memory: 0.74 us of device time at 128 blocks, 1.25 us at
// 1,024, on an H100 SXM at 700 W in chip_smoke.py) plus the chain of
// dependent steps inside a block, which the design keeps short.
//
// Design: one pipelined tile kernel for each direction, for every (F, k).
// - Tiles. One block per tile of TILE examples. TILE comes from F·F·k, so
//   that a tile's contra tensor C is ~1024 floats (32 examples at F=2, k=8;
//   1 at F=40); it shrinks to B / SMs at a small batch, so that every SM
//   has work, and where a tile's slabs would not fit one ring stage. (A
//   grid of about one wave whose blocks walked several tiles each, the
//   next tile's copies in flight, was slower at B=32,768 on an H100.)
// - Two dependent rounds per tile, every thread issuing copies. A block's
//   first chunk: each slab copy's thread reads its position's id, value and
//   field (one round trip), writes them to the index stage, and issues
//   cp.async copies of every slab chunk the tile needs (field in [0, F),
//   value not 0) into the shared-memory ring; then a single wait. 16-byte
//   copies when F·k % 4 == 0 and the table is 16-byte aligned (every slab
//   base then is; the FFM gate's k=10 slab is 80 contiguous bytes), 8-byte
//   or 4-byte otherwise. Hopper's TMA cannot gather rows, hence cp.async.
//   A tile that is one chunk (every main-path shape) takes this round and
//   computes.
// - Chunks. Positions stream through the ring in chunks of a tile's
//   positions, or of part of one example's when N·F·k is too large, so
//   shared memory does not grow with N. A block's first two chunks go out
//   as above at once. Later chunks: their ids, values and fields (and,
//   backward, g_out rows) are contiguous runs, staged by cp.async three
//   steps ahead (16 bytes where aligned, 4 at the edges; four index
//   stages, three ring stages), so while a chunk computes, the next two
//   chunks' slabs and the indices of the one after are in flight. A
//   multi-chunk tile's backward
//   streams its chunks twice (C first, then the gradient, with each slab
//   staged again for its self term). A contra tensor too large to leave
//   room for the ring reads slabs and g_out straight from global memory
//   (kStaged = false).
// - Compute from the staged slabs. The main path's shapes (F=2, k=8 and the
//   FFM gate's k=10, on an aligned table) are compiled with F, k and the
//   copy width fixed and, for one-chunk tiles, keep C in registers: the
//   forward's lane kk of an example sums every C[t][f][kk] and the self
//   terms and a butterfly of shuffles adds the triangle's parts over kk;
//   the backward's lane (t, kq) sums C[f][t][kq..] over a group of the
//   example's positions, a butterfly adds the groups, and the lane writes
//   its positions' gradient. No shared-memory C, no barrier after the
//   slabs arrive. Every other shape (and a multi-chunk tile) adds into C in
//   shared memory: thread item (b, t, kk) owns C[b][t][*][kk], N·F·k adds
//   per example, then a barrier and the triangle or the gradient.
// - Stores. The forward writes a tile's [TILE, T] triangle as one
//   contiguous run; the backward its [TILE, N, F·k] block, 16 bytes a
//   thread at k % 4 == 0 (8 at the gate's k=10).
// - No tensor cores: the work is bytes-bound, and TF32 would break the
//   1e-5 agreement with the plain version.
// - Fixed order, no atomics. Each sum runs in an order that depends on the
//   example alone (its positions in order, or in position groups set by F,
//   k and N; then a fixed order or butterfly over kk), never on B, its
//   place in the batch, TILE or the chunks. Reruns are
//   bit-identical, and an example gives the same bits alone or in any
//   batch.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;       // threads per block (ops/ffm.THREADS)
constexpr int kIdxStages = 4;       // index stages (ops/ffm.IDX_STAGES)
constexpr int kSlabStages = 3;      // slab ring stages (ops/ffm.SLAB_STAGES)
constexpr size_t kStaticSmemLimit = 48 * 1024;

// A launch's inputs, its geometry (ops/ffm.geometry) and the scalars the
// launcher derives from them once, so that no thread divides to find them.
struct Params {
  const float* table;
  const int* ids;
  const float* vals;
  const int* fields;
  const float* g_out;  // backward only
  float* out;          // forward: [B, T]; backward: d emb [B, N, F*k]
  int B, N, F, k, mask;
  int tile, chunk, vec;
  // derived by the launcher
  int T, Fk, fk_pad;          // triangle entries, slab floats, a ring slot
  int nch, npass;             // chunks per tile; sweeps per tile
  float inv_N;                // 1/N: example of a position (see example_of)
  int pg;                     // position groups per example, fixed shapes
  int idx_off, idx_stride;    // index stages: offset and words per array
  int g_off, g_stride;        // g_out stages
  int ring_off, ring_stride;  // slab ring stages
};

__host__ __device__ __forceinline__ int round4(int n) { return (n + 3) & ~3; }

// Shared memory of one block, in 4-byte words, each region 16-byte aligned:
// C [tile][F][F][k]; kIdxStages stages of the ids, values and fields of one
// chunk (4 words of slack each, to shift a run onto the source's 16-byte
// phase); staged backward: kIdxStages stages of g_out rows; staged:
// kSlabStages ring stages of chunk slabs. ops/ffm.py smem_words mirrors it.
struct Layout {
  int c, idx, g, ring, total;
};

__host__ __device__ inline Layout layout(bool bwd, bool staged, int F, int k,
                                         int tile, int chunk) {
  Layout l;
  const int T = F * (F + 1) / 2;
  l.c = 0;
  l.idx = l.c + round4(tile * F * F * k);
  l.g = l.idx + kIdxStages * 3 * round4(chunk + 4);
  l.ring = l.g + (bwd && staged ? kIdxStages * round4(tile * T + 4) : 0);
  l.total = l.ring + (staged ? kSlabStages * chunk * round4(F * k) : 0);
  return l;
}

__device__ __forceinline__ size_t slab_base(int id, int mask) {
  return (size_t)(unsigned)(id & mask);
}

__device__ __forceinline__ void cp_async(void* dst, const void* src, int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
  else if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// V consecutive floats to and from shared memory in one access (V = 4, 2, 1;
// the address aligned to 4V bytes).
template <int V>
__device__ __forceinline__ void load_v(float (&r)[V], const float* a) {
  if constexpr (V == 4) {
    const float4 q = *reinterpret_cast<const float4*>(a);
    r[0] = q.x, r[1] = q.y, r[2] = q.z, r[3] = q.w;
  } else if constexpr (V == 2) {
    const float2 q = *reinterpret_cast<const float2*>(a);
    r[0] = q.x, r[1] = q.y;
  } else {
    r[0] = *a;
  }
}

template <int V>
__device__ __forceinline__ void store_v(float* a, const float (&r)[V]) {
  if constexpr (V == 4)
    *reinterpret_cast<float4*>(a) = make_float4(r[0], r[1], r[2], r[3]);
  else if constexpr (V == 2)
    *reinterpret_cast<float2*>(a) = make_float2(r[0], r[1]);
  else
    *a = r[0];
}

// Word offset at which a run copied from `src` starts inside its stage: the
// run keeps the source's 16-byte phase, so its body moves in 16-byte copies.
__device__ __forceinline__ int phase(const void* src) {
  return (int)(((uintptr_t)src >> 2) & 3);
}

// One warp issues cp.async copies of the n words at src into stage +
// phase(src): 4-byte copies up to the first 16-byte boundary, 16-byte
// copies, 4-byte copies of the tail.
__device__ __forceinline__ void stage_run(unsigned* stage, const void* src_v,
                                          int n, int lane) {
  const unsigned* src = static_cast<const unsigned*>(src_v);
  const int mis = phase(src);
  const int head = min((4 - mis) & 3, n);
  const int body = (n - head) >> 2;
  const int total = head + body + (n - head - 4 * body);
  unsigned* dst = stage + mis;
  for (int x = lane; x < total; x += 32) {
    if (x < head) {
      cp_async(dst + x, src + x, 4);
    } else if (x < head + body) {
      const int w = head + 4 * (x - head);
      cp_async(dst + w, src + w, 16);
    } else {
      const int w = x + 3 * body;  // head + 4*body + (x - head - body)
      cp_async(dst + w, src + w, 4);
    }
  }
}

// The least power of two that is at least n.
__host__ __device__ constexpr int pow2_at_least(int n) { return n <= 1 ? 1 : 2 * pow2_at_least((n + 1) / 2); }

// One chunk of a block's stream: positions [q0, q1) of the tile of examples
// [b0, b0 + nb); pass 1 is the backward's second sweep of a multi-chunk tile.
struct Chunk {
  bool valid;
  int b0, nb, q0, q1, pass, j;
};

// The tile kernel of one direction. kF, kK, kVec > 0 fix F, k and the slab
// copy width at compile time (the main path's F=2 with k=8 and the FFM
// gate's k=10, on a 16-byte aligned table): divisions by constants,
// unrolled loops, C's F sums of a thread item in registers. Zero takes them
// from Params, and each item adds into C in shared memory instead.
template <bool kBwd, bool kStaged, int kF, int kK, int kVec>
struct TileKernel {
  // floats along k that one thread item of the fixed shapes covers, read
  // and written in one shared-memory access
  static constexpr int kVK = kK % 4 == 0 ? 4 : kK % 2 == 0 ? 2 : 1;
  const Params p;
  unsigned* smem;

  __device__ TileKernel(const Params& p_, unsigned* smem_) : p(p_), smem(smem_) {}

  __device__ int nF() const { return kF ? kF : p.F; }
  __device__ int nK() const { return kK ? kK : p.k; }
  __device__ int nFk() const { return kF ? kF * kK : p.Fk; }
  __device__ int nT() const { return kF ? kF * (kF + 1) / 2 : p.T; }
  __device__ int nVec() const { return kVec ? kVec : p.vec; }

  // chunk s of this block's tile
  __device__ Chunk at(int s) const {
    Chunk c;
    c.valid = s < p.npass * p.nch;
    if (!c.valid) return c;
    c.pass = s >= p.nch;
    c.j = s - c.pass * p.nch;
    c.b0 = (int)blockIdx.x * p.tile;
    c.nb = min(p.tile, p.B - c.b0);
    c.q0 = c.b0 * p.N + c.j * p.chunk;
    c.q1 = min(c.q0 + p.chunk, (c.b0 + c.nb) * p.N);
    return c;
  }

  __device__ float* C() const { return reinterpret_cast<float*>(smem); }
  __device__ unsigned* idx_stage(int st, int a) const {
    return smem + p.idx_off + (st * 3 + a) * p.idx_stride;
  }
  __device__ unsigned* g_stage(int st) const {
    return smem + p.g_off + st * p.g_stride;
  }
  __device__ float* ring(int rs) const {
    return reinterpret_cast<float*>(smem + p.ring_off + rs * p.ring_stride);
  }

  // the chunk's ids, values and fields inside index stage st
  __device__ const int* sid(const Chunk& c, int st) const {
    return reinterpret_cast<const int*>(idx_stage(st, 0)) + phase(p.ids + c.q0);
  }
  __device__ const float* sval(const Chunk& c, int st) const {
    return reinterpret_cast<const float*>(idx_stage(st, 1)) + phase(p.vals + c.q0);
  }
  __device__ const int* sfld(const Chunk& c, int st) const {
    return reinterpret_cast<const int*>(idx_stage(st, 2)) + phase(p.fields + c.q0);
  }
  // the g_out rows of the chunk's tile, staged or in global memory
  __device__ const float* grows(const Chunk& c, int st) const {
    const float* src = p.g_out + (size_t)c.b0 * nT();
    if (kStaged) return reinterpret_cast<const float*>(g_stage(st)) + phase(src);
    return src;
  }

  // chunks whose positions get their gradient written in this sweep
  __device__ bool writes_grad(const Chunk& c) const {
    return kBwd && (p.npass == 1 || c.pass == 1);
  }

  // a warp for each run: ids, values, fields and (the last warp, which has
  // the fewest slab copies to issue) the backward's g_out rows
  __device__ void issue_indices(const Chunk& c, int st) const {
    if (!c.valid) return;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int n = c.q1 - c.q0;
    if (warp == 0)
      stage_run(idx_stage(st, 0), p.ids + c.q0, n, lane);
    else if (warp == 1)
      stage_run(idx_stage(st, 1), p.vals + c.q0, n, lane);
    else if (warp == 2)
      stage_run(idx_stage(st, 2), p.fields + c.q0, n, lane);
    else if (warp == kThreads / 32 - 1 && kStaged && writes_grad(c))
      stage_run(g_stage(st), p.g_out + (size_t)c.b0 * nT(), c.nb * nT(), lane);
  }

  // Every slab the chunk needs into ring stage rs, before a single wait.
  // kDirect (a block's first chunk): each copy's thread reads its position's
  // field, value and id from global memory, four copies' worth at a time
  // before any is issued, and the thread of a slab's first piece writes
  // them to index stage st, so the slabs wait for no index copy. Otherwise
  // they come from index stage st, staged two steps before.
  template <bool kDirect>
  __device__ void issue_slabs(const Chunk& c, int st, int rs) const {
    if (!c.valid || !(kStaged || kDirect)) return;
    if ((c.q1 - c.q0) * (nFk() / nVec()) <= kThreads)
      issue_slabs_u<kDirect, 1>(c, st, rs);
    else
      issue_slabs_u<kDirect, 4>(c, st, rs);
  }

  template <bool kDirect, int U>
  __device__ void issue_slabs_u(const Chunk& c, int st, int rs) const {
    const int F = nF(), vec = nVec(), per = nFk() / vec;
    const int n = c.q1 - c.q0;
    int* id_s = const_cast<int*>(sid(c, st));
    float* v_s = const_cast<float*>(sval(c, st));
    int* fl_s = const_cast<int*>(sfld(c, st));
    float* dst = ring(rs);
    for (int x0 = threadIdx.x; x0 < n * per; x0 += U * kThreads) {
      int f[U], id[U], pl[U], w[U];
      float v[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int x = x0 + u * kThreads;
        pl[u] = x / per;
        w[u] = (x - pl[u] * per) * vec;
        f[u] = -1;
        if (x >= n * per) continue;
        if (kDirect) {
          f[u] = __ldg(p.fields + c.q0 + pl[u]);
          v[u] = __ldg(p.vals + c.q0 + pl[u]);
          id[u] = __ldg(p.ids + c.q0 + pl[u]);
        } else {
          f[u] = fl_s[pl[u]];
          v[u] = v_s[pl[u]];
          id[u] = id_s[pl[u]];
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (kDirect && x0 + u * kThreads < n * per && w[u] == 0) {
          fl_s[pl[u]] = f[u];
          v_s[pl[u]] = v[u];
          id_s[pl[u]] = id[u];
        }
        if (!kStaged || f[u] < 0 || f[u] >= F || v[u] == 0.f) continue;
        cp_async(dst + pl[u] * p.fk_pad + w[u],
                 p.table + slab_base(id[u], p.mask) + w[u], vec * 4);
      }
    }
  }

  // the example, within its tile, of the chunk's position pl: (pl0 + pl) / N
  // as (pl0 + pl + 0.5) * (1/N) rounded down, exact while positions stay
  // below 2^21 (the quotient is never within 1/(2N) of an integer)
  __device__ int example_of(int pl0, int pl) const {
    return (int)(((float)(pl0 + pl) + 0.5f) * p.inv_N);
  }

  __device__ const float* slab(const int* id, int rs, int pl) const {
    if (kStaged) return ring(rs) + pl * p.fk_pad;
    return p.table + slab_base(id[pl], p.mask);
  }

  // C over the chunk's positions: thread item (b, t, kk) owns C[b][t][*][kk].
  // In a forward whose tile is one chunk, the item also sums the self-term
  // squares (v·e)^2 of its example's positions in field t, and leaves
  // C[b][t][t][kk]^2 minus that sum in place of C[b][t][t][kk], which the
  // forward needs for nothing else.
  __device__ void accumulate(const Chunk& c, int st, int rs) const {
    const int* id = sid(c, st);
    const float* v = sval(c, st);
    const int* fl = sfld(c, st);
    const int F = nF(), k = nK(), Fk = nFk(), N = p.N;
    const bool fold = !kBwd && p.nch == 1;
    float* Cm = C();
    for (int it = threadIdx.x; it < c.nb * Fk; it += kThreads) {
      const int b = it / Fk;
      const int r = it - b * Fk;
      const int t = r / k;
      float* cb = Cm + (b * F + t) * F * k + (r - t * k);  // C[b][t][f][kk] at cb[f*k]
      const int lo = max(c.q0, (c.b0 + b) * N) - c.q0;
      const int hi = min(c.q1, (c.b0 + b + 1) * N) - c.q0;
      float sq = 0.f;
      if (c.j == 0)
        for (int f = 0; f < F; ++f) cb[f * k] = 0.f;
      for (int pl = lo; pl < hi; ++pl) {
        const int fn = fl[pl];
        const float vn = v[pl];
        if (fn < 0 || fn >= F || vn == 0.f) continue;
        const float ve = vn * slab(id, rs, pl)[r];
        cb[fn * k] += ve;
        if (!kBwd && fn == t) sq += ve * ve;
      }
      if (fold) cb[t * k] = cb[t * k] * cb[t * k] - sq;
    }
  }

  // Lanes per example of the fixed shapes' register paths: forward one per
  // kk, backward one per (t, kq) item of kVK floats (before its position
  // groups); each rounded up to a power of two.
  static constexpr int kFwdLanes = pow2_at_least(kK);
  static constexpr int kBwdLanes = pow2_at_least(kF * (kK / kVK));

  // The forward of a one-chunk tile at the fixed shapes, C in registers:
  // lane kk of an example's kFwdLanes (kK of them active) sums C[t][f][kk]
  // for every t, f and the self-term squares over its example's positions,
  // forms each triangle entry's part at kk (C[i][j] * C[j][i], or
  // C[t][t]^2 minus the squares on the diagonal), and a butterfly of
  // shuffles over the example's lanes adds the parts. Lane idx < T stores
  // entry idx: the tile's triangle is one contiguous run.
  // kN > 0: N fixed at compile time (the main path's N=2, 4, 8), so the
  // loop over an example's positions unrolls and its loads overlap; the
  // sums run in the same order either way.
  template <int kN>
  __device__ void triangle_regs(const Chunk& c, int st, int rs) const {
    constexpr int KP = kFwdLanes;
    constexpr int T = kF * (kF + 1) / 2;
    static_assert(kF > 0 && KP <= 32 && T <= KP, "the fixed shapes only");
    const int* id = sid(c, st);
    const float* v = sval(c, st);
    const int* fl = sfld(c, st);
    const int items = c.nb * KP;
    for (int base = 0; base < items; base += kThreads) {  // block-uniform
      const int it = base + (int)threadIdx.x;
      const int b = it / KP, kk = it % KP;
      float acc[kF][kF], sq[kF];
#pragma unroll
      for (int t = 0; t < kF; ++t) {
        sq[t] = 0.f;
#pragma unroll
        for (int f = 0; f < kF; ++f) acc[t][f] = 0.f;
      }
      if (it < items && kk < kK) {
        const int N = kN ? kN : p.N;
#pragma unroll
        for (int n = 0; n < (kN ? kN : N); ++n) {
          const int pl = b * N + n;
          const int fn = fl[pl];
          const float vn = v[pl];
          const bool ok = fn >= 0 && fn < kF && vn != 0.f;
          const float* e = slab(id, rs, pl) + kk;
#pragma unroll
          for (int t = 0; t < kF; ++t) {
            const float ve = ok ? vn * e[t * kK] : 0.f;
#pragma unroll
            for (int f = 0; f < kF; ++f)
              if (fn == f) acc[t][f] += ve;
            if (fn == t) sq[t] += ve * ve;
          }
        }
      }
      float part[T];
#pragma unroll
      for (int i = 0; i < kF; ++i) {
#pragma unroll
        for (int j = 0; j <= i; ++j)
          part[i * (i + 1) / 2 + j] =
              i == j ? acc[i][i] * acc[i][i] - sq[i] : acc[i][j] * acc[j][i];
      }
#pragma unroll
      for (int off = KP / 2; off >= 1; off >>= 1) {
#pragma unroll
        for (int e = 0; e < T; ++e) part[e] += __shfl_xor_sync(0xffffffffu, part[e], off);
      }
      float out = 0.f;
#pragma unroll
      for (int i = 0; i < kF; ++i) {
#pragma unroll
        for (int j = 0; j <= i; ++j) {
          // off-diagonal: 2 * (0.5 * sum) == sum exactly
          const int e = i * (i + 1) / 2 + j;
          if (kk == e) out = i == j ? 0.5f * part[e] : part[e];
        }
      }
      if (it < items && kk < T) p.out[((size_t)c.b0 + b) * T + kk] = out;
    }
  }

  // The backward of a one-chunk tile at the fixed shapes, C in registers.
  // An example takes kBwdLanes * pg lanes of one warp: lane (g, t, kq) sums
  // C[f][t][kq*V ..] for every f over positions g, g + pg, ... of its
  // example in field t (C[f][t][kk] = sum of v_n e[n][f*k + kk] there); a
  // butterfly over g adds the groups' sums, which is all the gradient of
  // field t's slab segment needs; then the lane writes d emb[n][t*k + kq*V
  // ..] for its group's positions n, V floats at a time (16 bytes at k=8, 8
  // at k=10).
  // position groups per example at N: the most, up to N, that fit one
  // warp beside the example's kBwdLanes (the launcher's pg)
  __host__ __device__ static constexpr int groups_at(int n) {
    int g = 1;
    while (kBwdLanes * g * 2 <= 32 && g * 2 <= n) g *= 2;
    return g;
  }

  template <int kN>
  __device__ void gradient_regs(const Chunk& c, int st, int rs) const {
    constexpr int V = kVK, KQ = kK / V, T = kF * (kF + 1) / 2;
    constexpr int TP = kBwdLanes;
    static_assert(TP <= 32, "the fixed shapes only");
    const int* id = sid(c, st);
    const float* v = sval(c, st);
    const int* fl = sfld(c, st);
    const float* g_rows = grows(c, st);
    const int N = kN ? kN : p.N;
    const int PG = kN ? groups_at(kN) : p.pg, L = TP * PG;
    const int items = c.nb * L;
    for (int base = 0; base < items; base += kThreads) {  // block-uniform
      const int it = base + (int)threadIdx.x;
      const int b = it / L, tq = it % TP, g = (it % L) / TP;
      const int t = tq / KQ, kk = (tq - t * KQ) * V;
      const bool active = it < items && tq < kF * KQ;
      float acc[kF][V];
#pragma unroll
      for (int f = 0; f < kF; ++f) {
#pragma unroll
        for (int u = 0; u < V; ++u) acc[f][u] = 0.f;
      }
      const int lo = b * N + g, hi = (b + 1) * N;
      // positions g, g + PG, ... of the example: (N - g + PG - 1) / PG of
      // them; with kN fixed the loops unroll
      constexpr int kMax = kN ? (kN + groups_at(kN) - 1) / groups_at(kN) : 1;
      if (active) {
#pragma unroll
        for (int m = 0; m < (kN ? kMax : (N + PG - 1) / PG); ++m) {
          const int pl = lo + m * PG;
          if (pl >= hi) break;
          const float vn = v[pl];
          if (fl[pl] != t || vn == 0.f) continue;
          const float* e = slab(id, rs, pl) + kk;
#pragma unroll
          for (int f = 0; f < kF; ++f) {
            float ef[V];
            load_v<V>(ef, e + f * kK);
#pragma unroll
            for (int u = 0; u < V; ++u) acc[f][u] += vn * ef[u];
          }
        }
      }
      for (int off = TP; off < L; off <<= 1) {
#pragma unroll
        for (int f = 0; f < kF; ++f) {
#pragma unroll
          for (int u = 0; u < V; ++u)
            acc[f][u] += __shfl_xor_sync(0xffffffffu, acc[f][u], off);
        }
      }
      if (!active) continue;
      const float* gb = g_rows + b * T;
      const float gtt = gb[t * (t + 1) / 2 + t];
      float* d0 = p.out + ((size_t)c.b0 * N + lo) * (kF * kK) + t * kK + kk;
#pragma unroll
      for (int m = 0; m < (kN ? kMax : (N + PG - 1) / PG); ++m) {
        const int pl = lo + m * PG;
        if (pl >= hi) break;
        float* d = d0 + (size_t)m * PG * (kF * kK);
        const int fn = fl[pl];
        const float vn = v[pl];
        float res[V], e[V], cf[V];
        load_v<V>(e, slab(id, rs, pl) + t * kK + kk);
#pragma unroll
        for (int u = 0; u < V; ++u) cf[u] = acc[0][u];
#pragma unroll
        for (int f = 1; f < kF; ++f) {
          if (fn == f) {
#pragma unroll
            for (int u = 0; u < V; ++u) cf[u] = acc[f][u];
          }
        }
        const bool in = fn >= 0 && fn < kF && vn != 0.f;
        const int hi_tf = t > fn ? t : fn, lo_tf = t > fn ? fn : t;
        const float gtf = in ? gb[hi_tf * (hi_tf + 1) / 2 + lo_tf] : 0.f;
#pragma unroll
        for (int u = 0; u < V; ++u) {
          float gr = vn * gtf * cf[u];
          if (t == fn) gr -= gtt * vn * vn * e[u];
          res[u] = in ? gr : 0.f;
        }
        store_v<V>(d, res);
      }
    }
  }

  // 0.5 * sum over example ex's positions in field t of |v e[t*k ..]|^2,
  // read from global memory: the self term of a forward whose tile spans
  // chunks
  __device__ float self_term(int ex, int t) const {
    const int k = nK();
    float s = 0.f;
    for (int n = 0; n < p.N; ++n) {
      const size_t q = (size_t)ex * p.N + n;
      const float vn = __ldg(p.vals + q);
      if (__ldg(p.fields + q) != t || vn == 0.f) continue;
      const float* e = p.table + slab_base(__ldg(p.ids + q), p.mask) + t * k;
      for (int kk = 0; kk < k; ++kk) {
        const float ve = vn * __ldg(e + kk);
        s += ve * ve;
      }
    }
    return 0.5f * s;
  }

  // row i of the triangle holding entry idx (row i starts at i(i+1)/2)
  __device__ int tri_row(int idx) const {
    if constexpr (kF > 0) {
      int i = 0;
#pragma unroll
      for (int r = 1; r < kF; ++r)
        if (idx >= r * (r + 1) / 2) i = r;
      return i;
    } else {
      int i = (int)((sqrtf(8.f * idx + 1.f) - 1.f) * 0.5f);
      if ((i + 1) * (i + 2) / 2 <= idx) ++i;
      if (i * (i + 1) / 2 > idx) --i;
      return i;
    }
  }

  // the tile's [nb, T] triangle, one contiguous run
  __device__ void triangle(const Chunk& c) const {
    const int F = nF(), k = nK(), T = nT();
    const float* Cm = C();
    for (int x = threadIdx.x; x < c.nb * T; x += kThreads) {
      const int b = x / T;
      const int idx = x - b * T;
      const int i = tri_row(idx);
      const int j = idx - i * (i + 1) / 2;
      const float* cij = Cm + ((b * F + i) * F + j) * k;
      float out;
      if (i == j && p.nch == 1) {  // C^2 minus the self-term squares, per kk
        float q = 0.f;
        for (int kk = 0; kk < k; ++kk) q += cij[kk];
        out = 0.5f * q;
      } else {
        const float* cji = Cm + ((b * F + j) * F + i) * k;
        float dot = 0.f;
        for (int kk = 0; kk < k; ++kk) dot += cij[kk] * cji[kk];
        // off-diagonal: 2 * (0.5 * dot) == dot exactly
        out = i == j ? 0.5f * dot - self_term(c.b0 + b, i) : dot;
      }
      p.out[(size_t)c.b0 * T + x] = out;
    }
  }

  // d emb of the chunk's positions, one contiguous run
  template <int VS>
  __device__ void gradient_vs(const Chunk& c, int st, int rs) const {
    const int* id = sid(c, st);
    const float* v = sval(c, st);
    const int* fl = sfld(c, st);
    const float* g = grows(c, st);
    const int F = nF(), k = nK(), Fk = nFk(), N = p.N;
    const float* Cm = C();
    float* d = p.out + (size_t)c.q0 * Fk;
    const int items = (c.q1 - c.q0) * Fk / VS;
    const int pl0 = c.q0 - c.b0 * N;  // the chunk's first position in its tile
    for (int x = threadIdx.x; x < items; x += kThreads) {
      const int e0 = x * VS;
      const int pl = e0 / Fk;
      const int r0 = e0 - pl * Fk;
      const int b = example_of(pl0, pl);
      const int f = fl[pl];
      const float vn = v[pl];
      const bool in = f >= 0 && f < F && vn != 0.f;
      const float* gb = g + b * nT();
      const float* cb = Cm + (b * F + f) * F * k;
      float res[VS];
#pragma unroll
      for (int u = 0; u < VS; ++u) {
        const int r = r0 + u;
        const int t = r / k;
        float gr = 0.f;
        if (in) {
          const int hi = t > f ? t : f, lo = t > f ? f : t;
          gr = vn * gb[hi * (hi + 1) / 2 + lo] * cb[t * k + (r - t * k)];
          if (t == f)
            gr -= gb[t * (t + 1) / 2 + t] * vn * vn * slab(id, rs, pl)[r];
        }
        res[u] = gr;
      }
      store_v<VS>(d + e0, res);
    }
  }

  template <int kN>
  __device__ void regs(const Chunk& c, int st, int rs) const {
    if constexpr (kBwd)
      gradient_regs<kN>(c, st, rs);
    else
      triangle_regs<kN>(c, st, rs);
  }

  __device__ void compute(const Chunk& c, int st, int rs) const {
    if constexpr (kF > 0) {
      if (p.nch == 1) {
        switch (p.N) {
          case 2: regs<2>(c, st, rs); break;
          case 4: regs<4>(c, st, rs); break;
          case 8: regs<8>(c, st, rs); break;
          default: regs<0>(c, st, rs);
        }
        return;
      }
    }
    if (c.pass == 0) {
      accumulate(c, st, rs);
      if (c.j != p.nch - 1) return;
      __syncthreads();  // the tile's C is complete
      if (!kBwd) {
        triangle(c);
        return;
      }
      if (p.npass == 2) return;  // the gradient comes in the second sweep
    }
    if (nFk() % 4 == 0)
      gradient_vs<4>(c, st, rs);
    else
      gradient_vs<1>(c, st, rs);
  }

  // The block's tile. One chunk (every main-path shape): its indices and
  // slabs, then its compute. Several: a stream of chunks, index stage
  // s % 4 and ring stage s % 3 for chunk s; the first two chunks' slabs go
  // out at once (their ids read directly); while chunk s computes, the
  // slabs of s + 1 and s + 2 and the indices of s + 3 are in flight.
  __device__ void run() const {
    Chunk c0 = at(0), c1 = at(1), c2 = at(2);
    if (!c1.valid) {
      issue_first(c0, 0);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      compute(c0, 0, 0);
      return;
    }
    issue_first(c0, 0);
    cp_async_commit();
    issue_indices(c2, 2);
    cp_async_commit();
    issue_first(c1, 1);
    cp_async_commit();
    for (int s = 0; c0.valid; ++s) {
      const Chunk c3 = at(s + 3);
      cp_async_wait<1>();  // chunk s staged, and the indices of s + 2
      __syncthreads();     // step s - 1 done with its stages
      issue_indices(c3, (s + 3) % kIdxStages);
      cp_async_commit();
      issue_slabs<false>(c2, (s + 2) % kIdxStages, (s + 2) % kSlabStages);
      cp_async_commit();
      compute(c0, s % kIdxStages, s % kSlabStages);
      c0 = c1;
      c1 = c2;
      c2 = c3;
    }
  }

  // a chunk's slabs from ids read directly, and its g_out rows (backward)
  __device__ void issue_first(const Chunk& c, int st) const {
    issue_slabs<true>(c, st, st);
    if (kBwd && kStaged && c.valid && writes_grad(c) &&
        (threadIdx.x >> 5) == kThreads / 32 - 1)
      stage_run(g_stage(st), p.g_out + (size_t)c.b0 * nT(), c.nb * nT(),
                threadIdx.x & 31);
  }
};

__device__ __forceinline__ unsigned* dynamic_smem() {
  extern __shared__ __align__(16) unsigned smem_words[];
  return smem_words;
}

template <bool kStaged, int kF, int kK, int kVec>
__global__ void __launch_bounds__(kThreads) ffm_fwd_kernel(const Params p) {
  TileKernel<false, kStaged, kF, kK, kVec>(p, dynamic_smem()).run();
}

// The backward is held to 64 registers a thread, so that four blocks fit an
// SM as for the forward; unbounded, its stream took more and three fit.
template <bool kStaged, int kF, int kK, int kVec>
__global__ void __launch_bounds__(kThreads, 4) ffm_bwd_kernel(const Params p) {
  TileKernel<true, kStaged, kF, kK, kVec>(p, dynamic_smem()).run();
}

// An empty kernel, launched like the others: the launch floor.
__global__ void ffm_empty_kernel() {}

using TileFn = void (*)(Params);

template <bool kStaged, int kF, int kK, int kVec>
TileFn tile_fn(bool bwd) {
  return bwd ? ffm_bwd_kernel<kStaged, kF, kK, kVec>
             : ffm_fwd_kernel<kStaged, kF, kK, kVec>;
}

// The instantiation of the tile kernel for (F, k) and the slab copy width:
// fixed for the main path's shapes on a 16-byte aligned table, from Params
// for every other.
TileFn tile_fn(bool bwd, bool staged, int F, int k, int vec) {
  if (staged && vec == 4 && F == 2 && k == 8) return tile_fn<true, 2, 8, 4>(bwd);
  if (staged && vec == 4 && F == 2 && k == 10) return tile_fn<true, 2, 10, 4>(bwd);
  return staged ? tile_fn<true, 0, 0, 0>(bwd) : tile_fn<false, 0, 0, 0>(bwd);
}

cudaError_t allow_smem(const void* kernel, size_t smem) {
  if (smem <= kStaticSmemLimit) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <typename Kernel, typename... Args>
int launch(Kernel kernel, int grid, size_t smem, cudaStream_t stream,
           Args... args) {
  const cudaError_t err = allow_smem((const void*)kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kThreads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

int launch_tile(bool bwd, Params p, int staged, int smem, void* stream) {
  const Layout l = layout(bwd, staged != 0, p.F, p.k, p.tile, p.chunk);
  if (smem != 4 * l.total || p.tile < 1 || p.chunk < 1 ||
      (p.vec != 1 && p.vec != 2 && p.vec != 4) || (p.F * p.k) % p.vec != 0)
    return (int)cudaErrorInvalidValue;
  p.T = p.F * (p.F + 1) / 2;
  p.Fk = p.F * p.k;
  p.fk_pad = round4(p.Fk);
  p.nch = p.tile * p.N > p.chunk ? (p.tile * p.N + p.chunk - 1) / p.chunk : 1;
  p.npass = bwd && p.nch > 1 ? 2 : 1;
  p.inv_N = p.N > 0 ? 1.f / (float)p.N : 0.f;
  // position groups per example in the backward's register path at the
  // fixed shapes: the most, up to N, that fit one warp beside the
  // example's other lanes. They set the order of C's sums, so they depend
  // on F, k and N alone, never on the batch or the tile.
  const int vk = p.k % 4 == 0 ? 4 : p.k % 2 == 0 ? 2 : 1;
  int lanes = 1;
  while (lanes < p.F * (p.k / vk)) lanes <<= 1;
  p.pg = 1;
  while (bwd && lanes * p.pg * 2 <= 32 && p.pg * 2 <= p.N) p.pg <<= 1;
  p.idx_off = l.idx;
  p.idx_stride = round4(p.chunk + 4);
  p.g_off = l.g;
  p.g_stride = round4(p.tile * p.T + 4);
  p.ring_off = l.ring;
  p.ring_stride = p.chunk * p.fk_pad;
  const int tiles = (p.B + p.tile - 1) / p.tile;  // one block each
  return launch(tile_fn(bwd, staged != 0, p.F, p.k, p.vec), tiles, (size_t)smem,
                (cudaStream_t)stream, p);
}

}  // namespace

extern "C" {

// Shared memory bytes of a block of the forward (backward = 0) or the
// backward at this geometry; ops/ffm.py computes the same.
int fwt_ffm_smem_bytes(int backward, int F, int k, int tile, int chunk,
                       int staged) {
  return 4 * layout(backward != 0, staged != 0, F, k, tile, chunk).total;
}

// Each launcher runs on `stream` and returns the CUDA error code (0 =
// launched). The caller has checked the shapes and computed the geometry
// (ops/ffm.geometry): examples per tile, positions per chunk, whether the
// slabs are staged, the slab copy width in floats and the shared memory
// bytes. The grid is one block per tile.
int fwt_ffm_fused(const float* table, const int* ids, const float* vals,
                  const int* fields, float* out, int B, int N, int F, int k,
                  int mask, int tile, int chunk, int staged, int vec, int smem,
                  void* stream) {
  if (B == 0) return 0;
  Params p{};
  p.table = table, p.ids = ids, p.vals = vals, p.fields = fields, p.out = out;
  p.B = B, p.N = N, p.F = F, p.k = k, p.mask = mask;
  p.tile = tile, p.chunk = chunk, p.vec = vec;
  return launch_tile(false, p, staged, smem, stream);
}

int fwt_ffm_fused_bwd(const float* g_out, const float* table, const int* ids,
                      const float* vals, const int* fields, float* d_emb,
                      int B, int N, int F, int k, int mask, int tile, int chunk,
                      int staged, int vec, int smem, void* stream) {
  if (B == 0 || N == 0) return 0;
  Params p{};
  p.table = table, p.ids = ids, p.vals = vals, p.fields = fields, p.g_out = g_out;
  p.out = d_emb;
  p.B = B, p.N = N, p.F = F, p.k = k, p.mask = mask;
  p.tile = tile, p.chunk = chunk, p.vec = vec;
  return launch_tile(true, p, staged, smem, stream);
}

// The empty kernel at a launch's grid and shared memory.
int fwt_ffm_empty(int grid, int smem, void* stream) {
  return launch(ffm_empty_kernel, grid, (size_t)smem, (cudaStream_t)stream);
}

const char* fwt_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
