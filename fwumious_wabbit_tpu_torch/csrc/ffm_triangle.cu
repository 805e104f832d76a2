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
// and 0 where f_n is outside [0, F). No gradient flows to vals or fields.
//
// The slab gather (tables.gather's rule): feature n's slab is the F·k floats
// of the flat table from base = id & mask, where mask = ~(align - 1) when a
// slab fits in one 128-float row (align = F·k rounded up to a power of two)
// and ~127 otherwise (rows_per_slab consecutive rows from the id's row). The
// kernels read those floats straight from the table: the [B, N, F·k] slab
// tensor is never written to device memory, and the five launches that built
// it are gone. Both kernels read the table only; it is updated after both
// backward passes of a train step.
//
// Inputs: table [R, 128] f32, ids [B, N] i32, vals [B, N] f32, fields [B, N]
// i32, all contiguous; out and g_out [B, F(F+1)/2] f32; d_emb [B, N, F*k] f32.
// Padding is inert in both forms the repo produces: fields == -1 (or any
// value outside [0, F)) never matches a field, and val 0.0 contributes 0 to
// C, to diag and to the gradient.
//
// What bounds them: bytes, not operations (~700 flops per example). The
// forward must read each feature's slab once, its id, value and field, and
// write the triangle: at the serving shape (B=256, N=8, F=2, k=8) 131,072 +
// 24,576 + 3,072 = 158,720 bytes, 0.05 us at 3.35 TB/s. The backward reads
// as much plus g_out and writes d_emb (B·N·F·k·4 bytes): at B=1024
// 1,159,168 bytes, 0.35 us. Both are far below one launch's latency, so
// what the design buys is fewer launches and fewer dependent round trips to
// memory.
//
// Design. The warp path, for F·F·(k/VW) <= 32 (the F=2, k=8 model of the
// main path and the small test shapes): one warp per example, four examples
// per 128-thread block. Lane (g, p), p = (t·F + f)·KQ + kq with KQ = k/VW,
// owns the VW floats C[t][f][kq·VW ..] and sums them over the features
// n ≡ g (mod G), G = 32 / (P rounded up to a power of two): only the lane
// whose f is the feature's field loads that slab chunk, so each slab float
// is read once, as a 16-byte load (VW = 4) when k % 4 == 0 and the table is
// 16-byte aligned (every slab base then is). A butterfly of xor shuffles
// over g completes C in every lane group; the triangle's dot products and
// the self terms are a shuffle from the partner lane (f, t, kq) and a
// butterfly over kq: no shared memory, no __syncthreads. The backward
// recomputes C the same way, then lanes stride over the example's N·F·KQ
// output chunks, each taking C[f_n][t][kq] by one shuffle from the lane that
// holds it, and write d emb as 16-byte stores.
//
// The shared-memory path, for larger F·F·k (F=16 k=8, F=40 k=8, or k not a
// power of two per vector): one block per example, C (F·F·k floats) and the
// F self terms (forward) or the symmetric G (backward) in dynamic shared
// memory; above 48 KB the launcher raises the kernel's limit, up to the
// card's 227 KB per block. Threads stride over (t, f, kk) for C and over
// (n, t, kk) for the gradient, reading the table directly.
//
// Every sum runs in a fixed order (over n in order within a lane or thread,
// then a fixed butterfly): no atomics, reruns are bit-identical.

#include <cuda_runtime.h>

namespace {

constexpr size_t kStaticSmemLimit = 48 * 1024;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerBlock = 4;  // examples per block on the warp path

__device__ __forceinline__ size_t slab_base(int id, int mask) {
  return (size_t)(unsigned)(id & mask);
}

template <int VW>
__device__ __forceinline__ void load_vec(float (&r)[VW], const float* p) {
  if constexpr (VW == 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    r[0] = q.x;
    r[1] = q.y;
    r[2] = q.z;
    r[3] = q.w;
  } else {
    r[0] = __ldg(p);
  }
}

template <int VW>
__device__ __forceinline__ void store_vec(float* p, const float (&r)[VW]) {
  if constexpr (VW == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(r[0], r[1], r[2], r[3]);
  } else {
    p[0] = r[0];
  }
}

// -- the warp path --------------------------------------------------------------

// One warp's contra tensor. Lane (g, p) with g = lane / Pp, p = lane % Pp
// and p = (t*F + f)*KQ + kq holds, on return, C[t][f][kq*VW .. kq*VW + VW)
// summed over all n (the same value in every lane of that p); with kSelf,
// S holds the self-term partial sum of v_n^2 * e^2 for t == f. Lanes with
// p >= F*F*KQ hold zeros.
template <int VW, bool kSelf>
__device__ __forceinline__ void warp_contra(
    const float* __restrict__ table, const int* __restrict__ id,
    const float* __restrict__ v, const int* __restrict__ fl, int N, int F,
    int k, int mask, int Pp, float (&C)[VW], float (&S)[VW]) {
  const int lane = threadIdx.x & 31;
  const int KQ = k / VW;
  const int p = lane & (Pp - 1);
  const int t = p / (F * KQ);
  const int f = (p / KQ) % F;
  const int kq = p % KQ;
  const bool active = p < F * F * KQ;
#pragma unroll
  for (int c = 0; c < VW; ++c) C[c] = S[c] = 0.f;
  for (int n = lane / Pp; n < N; n += 32 / Pp) {
    if (active && __ldg(fl + n) == f) {
      const float vn = __ldg(v + n);
      float e[VW];
      load_vec<VW>(e, table + slab_base(__ldg(id + n), mask) + t * k + kq * VW);
#pragma unroll
      for (int c = 0; c < VW; ++c) {
        C[c] += vn * e[c];
        if (kSelf && t == f) S[c] += vn * vn * e[c] * e[c];
      }
    }
  }
  for (int off = Pp; off < 32; off <<= 1) {
#pragma unroll
    for (int c = 0; c < VW; ++c) {
      C[c] += __shfl_xor_sync(kFull, C[c], off);
      if (kSelf) S[c] += __shfl_xor_sync(kFull, S[c], off);
    }
  }
}

template <int VW>
__global__ void ffm_fwd_warp_kernel(const float* __restrict__ table,
                                    const int* __restrict__ ids,
                                    const float* __restrict__ vals,
                                    const int* __restrict__ fields,
                                    float* __restrict__ out, int B, int N,
                                    int F, int k, int mask, int Pp) {
  const int b = blockIdx.x * kWarpsPerBlock + threadIdx.x / 32;
  if (b >= B) return;  // the whole warp: b is the same in every lane
  const size_t row = (size_t)b * N;
  float C[VW], S[VW];
  warp_contra<VW, true>(table, ids + row, vals + row, fields + row, N, F, k,
                        mask, Pp, C, S);

  const int lane = threadIdx.x & 31;
  const int KQ = k / VW;
  const int p = lane & (Pp - 1);
  const int t = p / (F * KQ);
  const int f = (p / KQ) % F;
  const int kq = p % KQ;
  const bool active = p < F * F * KQ;
  const int src = active ? (f * F + t) * KQ + kq : lane;  // holds C[f][t][kq]
  float dot = 0.f, sq = 0.f;
#pragma unroll
  for (int c = 0; c < VW; ++c) {
    dot += C[c] * __shfl_sync(kFull, C[c], src);
    sq += S[c];
  }
  for (int off = 1; off < KQ; off <<= 1) {  // the KQ lanes of one (t, f)
    dot += __shfl_xor_sync(kFull, dot, off);
    sq += __shfl_xor_sync(kFull, sq, off);
  }
  if (active && lane < Pp && kq == 0 && f <= t) {
    const int T = F * (F + 1) / 2;
    // off-diagonal: 2 * (0.5 * dot) == dot exactly
    out[(size_t)b * T + t * (t + 1) / 2 + f] =
        (t == f) ? 0.5f * dot - 0.5f * sq : dot;
  }
}

template <int VW>
__global__ void ffm_bwd_warp_kernel(const float* __restrict__ g_out,
                                    const float* __restrict__ table,
                                    const int* __restrict__ ids,
                                    const float* __restrict__ vals,
                                    const int* __restrict__ fields,
                                    float* __restrict__ d_emb, int B, int N,
                                    int F, int k, int mask, int Pp) {
  const int b = blockIdx.x * kWarpsPerBlock + threadIdx.x / 32;
  if (b >= B) return;
  const size_t row = (size_t)b * N;
  const int* id = ids + row;
  const float* v = vals + row;
  const int* fl = fields + row;
  float C[VW], S[VW];
  warp_contra<VW, false>(table, id, v, fl, N, F, k, mask, Pp, C, S);

  const int lane = threadIdx.x & 31;
  const int KQ = k / VW;
  const int FKQ = F * KQ;
  const int items = N * FKQ;  // VW-float chunks of the example's d emb
  const float* g = g_out + (size_t)b * (F * (F + 1) / 2);
  float* d = d_emb + row * (size_t)(F * k);
  for (int i0 = 0; i0 < items; i0 += 32) {  // the same trip count in every lane
    const int i = i0 + lane;
    const int n = i / FKQ;
    const int t = (i - n * FKQ) / KQ;
    const int kq = i - n * FKQ - t * KQ;
    const int f = i < items ? __ldg(fl + n) : -1;
    const bool in = f >= 0 && f < F;
    const int src = in ? (f * F + t) * KQ + kq : lane;  // holds C[f][t][kq]
    float c[VW];
#pragma unroll
    for (int cc = 0; cc < VW; ++cc) c[cc] = __shfl_sync(kFull, C[cc], src);
    if (i >= items) continue;
    float r[VW];
#pragma unroll
    for (int cc = 0; cc < VW; ++cc) r[cc] = 0.f;
    if (in) {
      const float vn = __ldg(v + n);
      const int hi = t > f ? t : f, lo = t > f ? f : t;
      const float gtf = __ldg(g + hi * (hi + 1) / 2 + lo);
#pragma unroll
      for (int cc = 0; cc < VW; ++cc) r[cc] = vn * gtf * c[cc];
      if (t == f) {
        float e[VW];
        load_vec<VW>(e, table + slab_base(__ldg(id + n), mask) + t * k + kq * VW);
        const float gtt = __ldg(g + t * (t + 1) / 2 + t);
#pragma unroll
        for (int cc = 0; cc < VW; ++cc) r[cc] -= gtt * vn * vn * e[cc];
      }
    }
    store_vec<VW>(d + (size_t)n * (F * k) + t * k + kq * VW, r);
  }
}

// -- the shared-memory path -----------------------------------------------------

// C[t][f][kk] of one example (thread i owns i = (t*F + f)*k + kk)
__device__ __forceinline__ void block_contra(const float* __restrict__ table,
                                             const int* __restrict__ id,
                                             const float* __restrict__ v,
                                             const int* __restrict__ fl,
                                             float* C, int N, int F, int k,
                                             int mask) {
  const int Fk = F * k;
  for (int i = threadIdx.x; i < F * Fk; i += blockDim.x) {
    const int t = i / Fk;
    const int f = (i - t * Fk) / k;
    const int kk = i - t * Fk - f * k;
    float acc = 0.f;
    for (int n = 0; n < N; ++n) {
      if (fl[n] == f)
        acc += v[n] * __ldg(table + slab_base(id[n], mask) + t * k + kk);
    }
    C[i] = acc;
  }
}

__global__ void ffm_fwd_block_kernel(const float* __restrict__ table,
                                     const int* __restrict__ ids,
                                     const float* __restrict__ vals,
                                     const int* __restrict__ fields,
                                     float* __restrict__ out, int N, int F,
                                     int k, int mask) {
  extern __shared__ float smem[];
  float* C = smem;                 // [F][F][k]
  float* diag = smem + F * F * k;  // [F]

  const int T = F * (F + 1) / 2;
  const size_t b = blockIdx.x;
  const int* id = ids + b * N;
  const float* v = vals + b * N;
  const int* fl = fields + b * N;

  block_contra(table, id, v, fl, C, N, F, k, mask);
  // self terms: thread t owns diag[t]
  for (int t = threadIdx.x; t < F; t += blockDim.x) {
    float acc = 0.f;
    for (int n = 0; n < N; ++n) {
      if (fl[n] == t) {
        const float* w = table + slab_base(id[n], mask) + t * k;
        float sq = 0.f;
        for (int kk = 0; kk < k; ++kk) sq += w[kk] * w[kk];
        acc += 0.5f * sq * v[n] * v[n];
      }
    }
    diag[t] = acc;
  }
  __syncthreads();

  // triangle: entry idx ↔ (i, j), j <= i, row i starting at i(i+1)/2
  for (int idx = threadIdx.x; idx < T; idx += blockDim.x) {
    int i = 0;
    while ((i + 1) * (i + 2) / 2 <= idx) ++i;
    const int j = idx - i * (i + 1) / 2;
    const float* cij = C + (i * F + j) * k;
    const float* cji = C + (j * F + i) * k;
    float dot = 0.f;
    for (int kk = 0; kk < k; ++kk) dot += cij[kk] * cji[kk];
    const float inter = 0.5f * dot;
    out[b * T + idx] = (i == j) ? inter - diag[i] : 2.f * inter;
  }
}

__global__ void ffm_bwd_block_kernel(const float* __restrict__ g_out,
                                     const float* __restrict__ table,
                                     const int* __restrict__ ids,
                                     const float* __restrict__ vals,
                                     const int* __restrict__ fields,
                                     float* __restrict__ d_emb, int N, int F,
                                     int k, int mask) {
  extern __shared__ float smem[];
  float* C = smem;              // [F][F][k]
  float* G = smem + F * F * k;  // [F][F], symmetric

  const int Fk = F * k;
  const int T = F * (F + 1) / 2;
  const size_t b = blockIdx.x;
  const int* id = ids + b * N;
  const float* v = vals + b * N;
  const int* fl = fields + b * N;
  float* d = d_emb + b * (size_t)N * Fk;

  block_contra(table, id, v, fl, C, N, F, k, mask);
  for (int p = threadIdx.x; p < F * F; p += blockDim.x) {
    const int t = p / F;
    const int f = p - t * F;
    const int i = t > f ? t : f;
    const int j = t > f ? f : t;
    G[p] = g_out[b * T + i * (i + 1) / 2 + j];
  }
  __syncthreads();

  // thread x owns d emb[n, t*k + kk], x = n*F*k + t*k + kk
  for (int x = threadIdx.x; x < N * Fk; x += blockDim.x) {
    const int n = x / Fk;
    const int r = x - n * Fk;
    const int t = r / k;
    const int kk = r - t * k;
    const int f = fl[n];
    float g = 0.f;
    if (f >= 0 && f < F) {
      const float vn = v[n];
      g = vn * G[t * F + f] * C[(f * F + t) * k + kk];
      if (t == f)
        g -= G[t * F + t] * vn * vn * __ldg(table + slab_base(id[n], mask) + r);
    }
    d[x] = g;
  }
}

int threads_for(int work) {
  int threads = work >= 256 ? 256 : ((work + 31) / 32) * 32;
  return threads < 32 ? 32 : threads;
}

// Lanes per example group on the warp path (F*F*k/VW rounded up to a power
// of two), or 0 when the example does not fit one warp that way.
int warp_lanes(int F, int k, int vw) {
  const int KQ = k / vw;
  const int P = F * F * KQ;
  if (P < 1 || P > 32 || (KQ & (KQ - 1)) != 0) return 0;
  int Pp = 1;
  while (Pp < P) Pp <<= 1;
  return Pp;
}

// Launch with `smem` bytes of dynamic shared memory, raising the kernel's
// limit above the default 48 KB when needed; returns the CUDA error code.
template <typename Kernel, typename... Args>
int launch(Kernel kernel, int blocks, int threads, size_t smem,
           cudaStream_t stream, Args... args) {
  if (smem > kStaticSmemLimit) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<blocks, threads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Which path the launchers take for (F, k): the warp path's lanes per
// example group, or 0 for the shared-memory path. `vec16` says the table is
// 16-byte aligned (then 16-byte loads are used where k % 4 == 0).
int fwt_ffm_fused_warp_lanes(int F, int k, int vec16) {
  return warp_lanes(F, k, vec16 && k % 4 == 0 ? 4 : 1);
}

// Each launcher runs on `stream` and returns the CUDA error code (0 =
// launched). The caller has checked shapes and that the shared memory fits
// in the card's 227 KB per block.
int fwt_ffm_fused(const float* table, const int* ids, const float* vals,
                  const int* fields, float* out, int B, int N, int F, int k,
                  int mask, int vec16, void* stream) {
  if (B == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  const int vw = vec16 && k % 4 == 0 ? 4 : 1;
  const int Pp = warp_lanes(F, k, vw);
  if (Pp) {
    const int blocks = (B + kWarpsPerBlock - 1) / kWarpsPerBlock;
    if (vw == 4)
      return launch(ffm_fwd_warp_kernel<4>, blocks, 32 * kWarpsPerBlock, 0, s,
                    table, ids, vals, fields, out, B, N, F, k, mask, Pp);
    return launch(ffm_fwd_warp_kernel<1>, blocks, 32 * kWarpsPerBlock, 0, s,
                  table, ids, vals, fields, out, B, N, F, k, mask, Pp);
  }
  const size_t smem = (size_t)(F * F * k + F) * sizeof(float);
  return launch(ffm_fwd_block_kernel, B, threads_for(F * F * k), smem, s,
                table, ids, vals, fields, out, N, F, k, mask);
}

int fwt_ffm_fused_bwd(const float* g_out, const float* table, const int* ids,
                      const float* vals, const int* fields, float* d_emb,
                      int B, int N, int F, int k, int mask, int vec16,
                      void* stream) {
  if (B == 0 || N == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  const int vw = vec16 && k % 4 == 0 ? 4 : 1;
  const int Pp = warp_lanes(F, k, vw);
  if (Pp) {
    const int blocks = (B + kWarpsPerBlock - 1) / kWarpsPerBlock;
    if (vw == 4)
      return launch(ffm_bwd_warp_kernel<4>, blocks, 32 * kWarpsPerBlock, 0, s,
                    g_out, table, ids, vals, fields, d_emb, B, N, F, k, mask,
                    Pp);
    return launch(ffm_bwd_warp_kernel<1>, blocks, 32 * kWarpsPerBlock, 0, s,
                  g_out, table, ids, vals, fields, d_emb, B, N, F, k, mask, Pp);
  }
  const size_t smem = (size_t)(F * F * k + F * F) * sizeof(float);
  const int work = F * F * k > N * F * k ? F * F * k : N * F * k;
  return launch(ffm_bwd_block_kernel, B, threads_for(work), smem, s, g_out,
                table, ids, vals, fields, d_emb, N, F, k, mask);
}

const char* fwt_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
