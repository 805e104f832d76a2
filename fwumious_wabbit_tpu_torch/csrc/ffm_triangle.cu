// FFM field-pair interactions, forward and backward — hand-written for
// Hopper (sm_90a).
//
// The forward replaces the TPU kernel
// fwumious_wabbit_tpu/ops/pallas/ffm.py::ffm_triangle (pl.pallas_call at
// ffm.py:131, body _ffm_kernel at ffm.py:73-111). Same function, not a
// block-by-block copy:
//
//   C[t][f][:]   = sum over n with field(n) == f of v_n * emb[n, t*k : (t+1)*k]
//   diag[t]      = 0.5 * sum over n with field(n) == t of v_n^2 * |emb[n, t*k : (t+1)*k]|^2
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
//                        - [t == f_n] * G[t][t] * v_n^2 * emb[n, t*k + kk]
//
// and 0 where f_n is outside [0, F). No gradient flows to vals or fields.
//
// Inputs: emb [B, N, F*k] f32, vals [B, N] f32, fields [B, N] i32, all
// contiguous; out and g_out [B, F(F+1)/2] f32; d_emb [B, N, F*k] f32.
// Padding is inert in both forms the repo produces: fields == -1 (or any
// value outside [0, F)) never matches a field, and val 0.0 contributes 0 to
// C, to diag and to the gradient.
//
// What bounds them: the forward reads B*N*(F*k + 2)*4 bytes and writes
// B*F(F+1)/2*4 bytes; the backward reads about as much again plus g_out and
// writes d_emb (B*N*F*k*4 bytes): about 150 KB and 0.3 MB at the serving and
// training shapes (B=256 and 1024, N=8, F*k=16). At that size both are bound
// by launch latency, not by HBM bandwidth or arithmetic.
//
// Design: one block per example. The example's contra tensor C (F*F*k
// floats, 256 B at F=2, k=8) and the per-field self terms (forward) or the
// symmetric G (backward) live in dynamic shared memory, so nothing but the
// inputs and the outputs touches device memory (the TPU kernel's VMEM
// tiling, in shared memory). Above 48 KB the launcher raises the kernel's
// dynamic shared memory limit, up to the card's 227 KB per block. Threads
// stride over (t, f, kk) for C and over (n, t, kk) for the gradient; each
// sum runs over n in order, so every result has a fixed order: no atomics,
// deterministic results.

#include <cuda_runtime.h>

namespace {

constexpr size_t kStaticSmemLimit = 48 * 1024;

// C[t][f][kk] of example e (thread i owns i = (t*F + f)*k + kk)
__device__ __forceinline__ void contra(const float* __restrict__ e,
                                       const float* __restrict__ v,
                                       const int* __restrict__ fl, float* C,
                                       int N, int F, int k) {
  const int Fk = F * k;
  for (int i = threadIdx.x; i < F * Fk; i += blockDim.x) {
    const int t = i / Fk;
    const int f = (i - t * Fk) / k;
    const int kk = i - t * Fk - f * k;
    float acc = 0.f;
    for (int n = 0; n < N; ++n) {
      if (fl[n] == f) acc += v[n] * e[(size_t)n * Fk + t * k + kk];
    }
    C[i] = acc;
  }
}

__global__ void ffm_triangle_kernel(const float* __restrict__ emb,
                                    const float* __restrict__ vals,
                                    const int* __restrict__ fields,
                                    float* __restrict__ out,
                                    int N, int F, int k) {
  extern __shared__ float smem[];
  float* C = smem;                 // [F][F][k]
  float* diag = smem + F * F * k;  // [F]

  const int Fk = F * k;
  const int T = F * (F + 1) / 2;
  const size_t b = blockIdx.x;
  const float* e = emb + b * (size_t)N * Fk;
  const float* v = vals + b * (size_t)N;
  const int* fl = fields + b * (size_t)N;

  contra(e, v, fl, C, N, F, k);
  // self terms: thread t owns diag[t]
  for (int t = threadIdx.x; t < F; t += blockDim.x) {
    float acc = 0.f;
    for (int n = 0; n < N; ++n) {
      if (fl[n] == t) {
        const float* w = e + (size_t)n * Fk + t * k;
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

__global__ void ffm_triangle_bwd_kernel(const float* __restrict__ g_out,
                                        const float* __restrict__ emb,
                                        const float* __restrict__ vals,
                                        const int* __restrict__ fields,
                                        float* __restrict__ d_emb,
                                        int N, int F, int k) {
  extern __shared__ float smem[];
  float* C = smem;              // [F][F][k]
  float* G = smem + F * F * k;  // [F][F], symmetric

  const int Fk = F * k;
  const int T = F * (F + 1) / 2;
  const size_t b = blockIdx.x;
  const float* e = emb + b * (size_t)N * Fk;
  const float* v = vals + b * (size_t)N;
  const int* fl = fields + b * (size_t)N;
  float* d = d_emb + b * (size_t)N * Fk;

  contra(e, v, fl, C, N, F, k);
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
      if (t == f) g -= G[t * F + t] * vn * vn * e[x];
    }
    d[x] = g;
  }
}

int threads_for(int work) {
  int threads = work >= 256 ? 256 : ((work + 31) / 32) * 32;
  return threads < 32 ? 32 : threads;
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

// Each launcher runs on `stream` and returns the CUDA error code (0 =
// launched). The caller has checked shapes and that the shared memory fits
// in the card's 227 KB per block.
int fwt_ffm_triangle(const float* emb, const float* vals, const int* fields,
                     float* out, int B, int N, int F, int k, void* stream) {
  if (B == 0) return 0;
  const size_t smem = (size_t)(F * F * k + F) * sizeof(float);
  return launch(ffm_triangle_kernel, B, threads_for(F * F * k), smem,
                (cudaStream_t)stream, emb, vals, fields, out, N, F, k);
}

int fwt_ffm_triangle_bwd(const float* g_out, const float* emb,
                         const float* vals, const int* fields, float* d_emb,
                         int B, int N, int F, int k, void* stream) {
  if (B == 0 || N == 0) return 0;
  const size_t smem = (size_t)(F * F * k + F * F) * sizeof(float);
  const int work = F * F * k > N * F * k ? F * F * k : N * F * k;
  return launch(ffm_triangle_bwd_kernel, B, threads_for(work), smem,
                (cudaStream_t)stream, g_out, emb, vals, fields, d_emb, N, F,
                k);
}

const char* fwt_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
