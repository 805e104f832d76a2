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
// The rate mirrors _rate/_pow_mpt: LUT — the 11-bit bucket of acc's bits,
// the two bucket edges with denormals flushed to 0 plus the initial
// gradient, lr * 1/2 * (e0^-p + e1^-p), lr where that is not finite; flex —
// lr * acc^-p, a non-finite update set to 0. Fast paths at p = 0, 1/2, 1.
//
// Inputs: w, acc [R, 128] f32 (acc null for SGD), updated in place; rs [K]
// i32 — the row ids sorted (stable), ids >= R or < 0 are padding; order [K]
// i64 — rs[j] = rid[order[j]]; grows [K, 128] f32 in the caller's order.
//
// What bounds it: it reads K*512 bytes of gradients and the touched rows of
// w and acc, and writes those rows once: at B=1024 a few MB, so on this card
// it is bound by launch latency and, for a long run of one row (a constant
// feature hit by every example), by that run's serial loop — not by HBM
// bandwidth or arithmetic. The TPU kernel streamed the whole table through
// VMEM and summed with a one-hot matmul on the MXU; here an indexed load is
// cheap, so only the touched rows move.
//
// Design: one 128-thread block per sorted position j, one thread per lane.
// A block whose row equals its predecessor's, or is padding, exits; a run's
// head walks the run in sorted order, 16 rows at a time with their loads
// in flight together, summing s and q in registers, then reads w and acc
// once and writes them once. A run's rows are summed serially, so one long
// run (a row every example touches) sets the kernel's time. Every sum has a
// fixed order, so reruns are bit-identical: no atomics, no host
// synchronisation. Built without --use_fast_math, so denormal accumulators
// are kept, as on the CPU.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kLane = 128;
constexpr int kUnroll = 16;
constexpr int kSgd = 100;
constexpr int kFlex = 200;
constexpr int kLut = 300;
constexpr float kFltMin = 1.17549435e-38f;  // smallest normal f32

__device__ __forceinline__ float pow_mpt(float x, float power_t) {
  if (power_t == 0.5f) return rsqrtf(x);
  if (power_t == 0.0f) return 1.0f;
  if (power_t == 1.0f) return 1.0f / x;
  return powf(x, -power_t);
}

__device__ __forceinline__ float lut_edge(unsigned key, float iag) {
  float v = __uint_as_float(key << 20);
  if (fabsf(v) < kFltMin) v = 0.0f;
  return v + iag;
}

__device__ __forceinline__ float rate(float acc, int kind, float lr,
                                      float power_t, float iag) {
  if (kind == kLut) {
    const unsigned key = __float_as_uint(acc) >> 20;
    const float val = (lr * 0.5f) * (pow_mpt(lut_edge(key, iag), power_t) +
                                     pow_mpt(lut_edge(key + 1u, iag), power_t));
    return isfinite(val) ? val : lr;
  }
  return lr * pow_mpt(acc, power_t);
}

__global__ void sparse_update_kernel(float* __restrict__ w,
                                     float* __restrict__ acc,
                                     const int* __restrict__ rs,
                                     const long long* __restrict__ order,
                                     const float* __restrict__ grows,
                                     int R, int K, int kind, float lr,
                                     float power_t, float iag) {
  const int j = blockIdx.x;
  const int r = rs[j];
  if (r < 0 || r >= R) return;             // padding
  if (j > 0 && rs[j - 1] == r) return;     // not the head of its run
  const int lane = threadIdx.x;
  float s = 0.f, q = 0.f;
  // kUnroll loads in flight at a time; the sums still run in sorted order
  // (a position past the run adds an exact 0)
  for (int i = j;; i += kUnroll) {
    float g[kUnroll];
    int n = 0;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int p = i + u;
      const bool in_run = p < K && rs[p] == r;  // true on a prefix: rs is sorted
      g[u] = in_run ? grows[order[p] * kLane + lane] : 0.f;
      n += in_run;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      s += g[u];
      q += g[u] * g[u];
    }
    if (n < kUnroll) break;
  }
  const size_t off = (size_t)r * kLane + lane;
  if (kind == kSgd) {
    w[off] -= lr * s;
    return;
  }
  const float a = acc[off] + q;
  acc[off] = a;
  float upd = s * rate(a, kind, lr, power_t, iag);
  if (kind == kFlex && !isfinite(upd)) upd = 0.f;
  w[off] -= upd;
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 = launched). The
// caller has checked shapes, types and contiguity.
int fwt_sparse_adagrad_update(float* w, float* acc, const int* rs,
                              const long long* order, const float* grows,
                              int R, int K, int kind, float lr, float power_t,
                              float iag, void* stream) {
  if (K == 0) return 0;
  sparse_update_kernel<<<K, kLane, 0, (cudaStream_t)stream>>>(
      w, acc, rs, order, grows, R, K, kind, lr, power_t, iag);
  return (int)cudaGetLastError();
}

const char* fwt_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
