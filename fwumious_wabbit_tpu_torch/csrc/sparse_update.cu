// Sparse AdaGrad row update — hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel
// fwumious_wabbit_tpu/ops/pallas/sparse_update.py::sparse_adagrad_update
// (pl.pallas_call at sparse_update.py:299 for SGD and :315 for AdaGrad, body
// _kernel :114-235, rate _rate/_pow_mpt :77-111). Same function, not a
// block-by-block copy:
//
//   for each row r touched by the K update rows, and each of its 128 lanes:
//     s       = sum of grows[i, lane] over the i with rid[i] == r
//     q       = sum of grows[i, lane]^2 over the same i
//     acc_new = acc[r, lane] + q;   acc[r, lane] = acc_new
//     w[r, lane] -= rate(acc_new) * s          (AdaGrad LUT / flex)
//     w[r, lane] -= lr * s                     (SGD: no acc)
//
// The rate: LUT — the entry of the 2048-entry f32 table (ops/adagrad.py
// build_lut, the reference's table, src/optimizer.rs:121-156) at the top 11
// bits of acc_new, read from a copy in shared memory, so it is the table's
// value bit for bit (the TPU recomputed it because a table gather is slow
// there; a GPU reads 8 KB of shared memory cheaply); flex — lr * acc^-p
// (rsqrtf at p = 1/2, powf otherwise), a non-finite update set to 0. The last
// add, product and difference are __fadd_rn/__fmul_rn/__fsub_rn, so they are
// never contracted into an FMA: the plain version rounds each on its own, and
// where every id occurs once the LUT and SGD updates equal it bit for bit.
//
// Inputs: w, acc [R, 128] f32 (acc null for SGD), updated in place; rs [K]
// i32 — the row ids sorted (stable), ids >= R or < 0 are padding; order [K]
// i64 — rs[j] = rid[order[j]]; grows [K, 128] f32 in the caller's order;
// lut [2048] f32 (LUT only); scratch [ceil(K/T), 2, 2, 128] f32, written by
// the first pass and read by the second. All 16-byte aligned. T = kTile = 64
// sorted positions per tile: at the train step's shapes it gave the lowest
// device time of 32, 64 and 128 (PERF.md).
//
// What bounded the previous design: one block per run, walking the run
// alone in steps of dependent loads (sorted id, then its row number, then the
// row). The FFM slots' padding (id 0, gradient 0) makes one run of ~6,144
// rows per 1024-example step, which took 766 µs on an H100 80GB HBM3 at 700 W
// against 429 µs for the plain index_add_ version; HBM bandwidth and
// arithmetic were idle (a few MB move per call).
//
// Design: a segmented sum over the sorted stream in two launches, no atomics.
// * Pass 1, one 128-thread block per tile of T sorted positions: the block
//   loads its T ids and row numbers in one coalesced step, then stages every
//   gradient row, the w and acc rows of each run that ends in the tile, and
//   the LUT into shared memory with cp.async (16 bytes a thread), so the tile
//   pays about two memory latencies. One thread per lane walks the staged
//   rows in sorted order, summing s and q per piece. A run inside the tile is
//   applied at once; the tile's first piece, when its run began in an earlier
//   tile, and its last piece, when its run goes on into the next, go to
//   scratch instead (a tile inside a run writes its whole sum as its first).
// * Pass 2, one block per tile: the block of the tile that holds the head of
//   a run crossing the tile's right edge adds, in tile order, that tile's
//   last piece and the first piece of every later tile the run reaches (all
//   addresses known, 16 loads in flight), and applies the update once. The
//   other blocks exit after reading two or three ids.
// A run of n positions costs about T + n/T serial steps instead of n, and the
// grid is K/T blocks, not K. Every sum has a fixed order, so reruns are
// bit-identical. Padding pieces do nothing.
//
// What bounds it now: at the train step's K (8,192 and 16,384 rows, 4 and
// 8 MB of gradients) the two passes move a few MB, a few µs of HBM time; the
// wrapper's stable sort (several launches of its own) and the launches
// themselves are most of a call's time.
//
// No tensor cores: the work is a segmented f32 sum at well under one flop
// per byte. The TPU summed with a one-hot bf16x3 matmul because its scatter
// was slow; on this card a one-hot product would add work and lose f32
// exactness. Built without --use_fast_math, so denormal accumulators are
// kept, as on the CPU.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kLane = 128;          // floats per row; one thread per lane
constexpr int kTile = 64;           // T: sorted positions per pass-1 block
constexpr int kThreads = kLane;
constexpr int kChunks = kLane / 4;  // 16-byte chunks per row
constexpr int kLutSize = 2048;
constexpr int kLutShift = 20;       // 31 - log2(kLutSize)
constexpr int kInFlight = 16;       // pass 2: partial loads in flight
constexpr int kSgd = 100;
constexpr int kLut = 300;

// the role of a sorted position in its tile, for pass 1's walk
enum : int {
  kInside = 0,  // not the last position of its piece
  kSkip = 1,    // the last position of a padding piece
  kApply = 2,   // the last position of a run that lies inside the tile
  kFirst = 3,   // the last position of a piece whose run began earlier
  kLast = 4,    // the last position of a piece whose run goes on
};

__device__ __forceinline__ void cp16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void stage_lut(float* slut, const float* lut) {
  for (int e = threadIdx.x; e < kLutSize / 4; e += kThreads)
    cp16(slut + 4 * e, lut + 4 * e);
}

__device__ __forceinline__ float pow_mpt(float x, float power_t) {
  if (power_t == 0.5f) return rsqrtf(x);
  if (power_t == 0.0f) return 1.0f;
  if (power_t == 1.0f) return 1.0f / x;
  return powf(x, -power_t);
}

// One weight's update from its sums s and q; w0 and a0 are its values
// before (a0 unused for SGD).
__device__ __forceinline__ void apply(float* w, float* acc, size_t off,
                                      float w0, float a0, float s, float q,
                                      int kind, float lr, float power_t,
                                      const float* slut) {
  if (kind == kSgd) {
    w[off] = __fsub_rn(w0, __fmul_rn(lr, s));
    return;
  }
  const float a = __fadd_rn(a0, q);
  acc[off] = a;
  float upd;
  if (kind == kLut) {
    upd = __fmul_rn(s, slut[(__float_as_uint(a) >> kLutShift) & (kLutSize - 1)]);
  } else {
    upd = __fmul_rn(s, __fmul_rn(lr, pow_mpt(a, power_t)));
    if (!isfinite(upd)) upd = 0.f;
  }
  w[off] = __fsub_rn(w0, upd);
}

// gradients, w, acc rows; the LUT; row numbers, ids, roles
constexpr size_t kTileSmem =
    3 * (size_t)kTile * kLane * 4 + kLutSize * 4 + (size_t)kTile * (8 + 4 + 4);

__global__ void __launch_bounds__(kThreads)
    tile_kernel(float* __restrict__ w, float* __restrict__ acc,
                const int* __restrict__ rs, const long long* __restrict__ order,
                const float* __restrict__ grows, const float* __restrict__ lut,
                float* __restrict__ scratch, int R, int K, int kind, float lr,
                float power_t) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* sg = reinterpret_cast<float*>(smem);
  float* sw = sg + kTile * kLane;
  float* sa = sw + kTile * kLane;
  float* slut = sa + kTile * kLane;
  long long* sorder = reinterpret_cast<long long*>(slut + kLutSize);
  int* srs = reinterpret_cast<int*>(sorder + kTile);
  int* sact = srs + kTile;
  __shared__ int edge[2];  // the ids just before and just after the tile

  const int tid = threadIdx.x;
  const int t0 = blockIdx.x * kTile;
  const int n = min(kTile, K - t0);
  for (int i = tid; i < n; i += kThreads) {
    srs[i] = rs[t0 + i];
    sorder[i] = order[t0 + i];
  }
  if (tid == 0) {  // -1 never equals a real id
    edge[0] = t0 > 0 ? rs[t0 - 1] : -1;
    edge[1] = t0 + n < K ? rs[t0 + n] : -1;
  }
  __syncthreads();
  for (int i = tid; i < n; i += kThreads) {
    const int r = srs[i];
    int act = kInside;
    if (i == n - 1 || srs[i + 1] != r) {
      if (r < 0 || r >= R) act = kSkip;
      else if (r == edge[0]) act = kFirst;  // rs is sorted: this piece starts at 0
      else if (i == n - 1 && r == edge[1]) act = kLast;
      else act = kApply;
    }
    sact[i] = act;
  }
  __syncthreads();
  for (int e = tid; e < n * kChunks; e += kThreads) {
    const int i = e / kChunks, c = (e % kChunks) * 4;
    const int r = srs[i];
    if (r < 0 || r >= R) continue;  // padding: its row is never read
    cp16(sg + i * kLane + c, grows + sorder[i] * kLane + c);
    if (sact[i] == kApply) {
      cp16(sw + i * kLane + c, w + (size_t)r * kLane + c);
      if (kind != kSgd) cp16(sa + i * kLane + c, acc + (size_t)r * kLane + c);
    }
  }
  if (kind == kLut) stage_lut(slut, lut);
  cp_wait_all();
  __syncthreads();

  const int lane = tid;
  // -0 is the additive identity: a one-row sum is that row's value exactly.
  // A padding piece sums unstaged shared memory and is dropped at its end.
  float s = -0.f, q = -0.f;
  for (int i = 0; i < n; ++i) {
    const float g = sg[i * kLane + lane];
    s = __fadd_rn(s, g);
    q = __fadd_rn(q, __fmul_rn(g, g));
    const int act = sact[i];
    if (act == kInside) continue;
    if (act == kApply) {
      const int j = i * kLane + lane;
      apply(w, acc, (size_t)srs[i] * kLane + lane, sw[j],
            kind != kSgd ? sa[j] : 0.f, s, q, kind, lr, power_t, slut);
    } else if (act != kSkip) {
      // scratch[tile][0 = first, 1 = last][s, q][lane]
      float* p = scratch + (size_t)(blockIdx.x * 2 + (act == kLast)) * 2 * kLane + lane;
      p[0] = s;
      p[kLane] = q;
    }
    s = -0.f;
    q = -0.f;
  }
}

__global__ void __launch_bounds__(kThreads)
    crossing_kernel(float* __restrict__ w, float* __restrict__ acc,
                    const int* __restrict__ rs, const float* __restrict__ lut,
                    const float* __restrict__ scratch, int R, int K, int kind,
                    float lr, float power_t) {
  __shared__ __align__(16) float slut[kLutSize];
  const int b = blockIdx.x, tid = threadIdx.x;
  const long long end = (long long)(b + 1) * kTile;
  if (end >= K) return;
  const int r = rs[end - 1];
  if (r < 0 || r >= R || rs[end] != r) return;  // no run crosses the right edge
  if (b > 0 && rs[(long long)b * kTile - 1] == r) return;  // its head is in an earlier tile
  // the later tiles whose first position is in the run: a prefix of them,
  // since rs is sorted; counted kThreads tiles at a time
  int m = 0;
  for (;;) {
    const long long p = (long long)(b + 1 + m + tid) * kTile;
    const int hit = __syncthreads_count(p < K && rs[p] == r);
    m += hit;
    if (hit < kThreads) break;
  }
  if (kind == kLut) {
    stage_lut(slut, lut);
    cp_wait_all();
    __syncthreads();
  }
  const int lane = tid;
  const float* part = scratch + lane;  // tile c's first piece: part[c * 4 * kLane]
  float s = part[(size_t)(b * 2 + 1) * 2 * kLane];
  float q = part[(size_t)(b * 2 + 1) * 2 * kLane + kLane];
  for (int c0 = 0; c0 < m; c0 += kInFlight) {
    float ps[kInFlight], pq[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const size_t c = (size_t)b + 1 + c0 + u;
      const bool in_run = c0 + u < m;
      ps[u] = in_run ? part[c * 4 * kLane] : -0.f;
      pq[u] = in_run ? part[c * 4 * kLane + kLane] : -0.f;
    }
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      s = __fadd_rn(s, ps[u]);
      q = __fadd_rn(q, pq[u]);
    }
  }
  const size_t off = (size_t)r * kLane + lane;
  apply(w, acc, off, w[off], kind != kSgd ? acc[off] : 0.f, s, q, kind, lr,
        power_t, slut);
}

}  // namespace

extern "C" {

// Launches both passes on `stream` and returns a CUDA error code (0 =
// launched). `tile` is the T the caller sized scratch for, ceil(K / tile)
// tiles; it must be kTile. The caller has checked shapes, types, contiguity
// and alignment.
int fwt_sparse_adagrad_update(float* w, float* acc, const int* rs,
                              const long long* order, const float* grows,
                              const float* lut, float* scratch, int R, int K,
                              int tile, int kind, float lr, float power_t,
                              void* stream) {
  if (tile != kTile) return (int)cudaErrorInvalidValue;
  if (K == 0) return 0;
  static bool attribute_set = false;  // once per process
  if (!attribute_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kTileSmem);
    if (e != cudaSuccess) return (int)e;
    attribute_set = true;
  }
  const cudaStream_t st = (cudaStream_t)stream;
  const int tiles = (K + kTile - 1) / kTile;
  tile_kernel<<<tiles, kThreads, kTileSmem, st>>>(
      w, acc, rs, order, grows, lut, scratch, R, K, kind, lr, power_t);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  crossing_kernel<<<tiles, kThreads, 0, st>>>(w, acc, rs, lut, scratch, R, K,
                                              kind, lr, power_t);
  return (int)cudaGetLastError();
}

const char* fwt_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
