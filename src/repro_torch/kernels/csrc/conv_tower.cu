// The Conv1D tower with a masked max-pool: embedded activations in,
// pooled features out, in one kernel launch.
//
// Replaces the TPU kernel src/repro/kernels/conv1d_stack.py::
// conv1d_stack_fused (body _kernel, _tower(masked_pool=True)). Per batch
// row it computes
//   1. L x ("same" conv as fs shifted taps, + bias, ReLU) on x as given;
//   2. the max over the positions where mask > 0 only, floored at 0, so a
//      row whose every position is masked pools to exactly 0.
// x and the params are float32 or bfloat16; all arithmetic is float32, and
// the output has x's dtype (a bf16 output is the f32 result rounded to
// nearest). This is the "half-fused" rung: the embedding gather stays
// outside, where conv_forward.cu does it inside.
//
// What bounds it on an H100 (SXM): at COSTMODEL_BASE (6 layers, fs=2,
// 64 channels), B=64, S=256 the tower is sum 2*S*fs*Cin*Cout ~= 25.2
// MFLOP per row, ~1.61 GFLOP in all: ~24 us at the published 67 TFLOP/s
// of float32 outside the tensor cores. The bytes it must move (x, the
// mask, the params, the output) are ~4.4 MB: ~1.3 us at 3.35 TB/s. The
// float32 kernel is bound by operations; it accumulates with plain FFMA,
// never TF32.
//
// Design: conv_forward.cu's, without its gather, FC stack and heads (the
// two sources are kept apart on purpose: K1's times stay as measured).
//  * One thread block per batch row, so a row's output is bit-identical
//    for every batch size B.
//  * The sequence is cut into tiles of T output positions. A tile also
//    computes a left halo of sum (fs-1)/2 and a right halo of sum fs/2
//    positions, which it recomputes instead of exchanging. Two ping-pong
//    activation buffers of (T + halo + kRows) x C_max f32 live in dynamic
//    shared memory; plan() picks T so that they fit in 227 KB and is the
//    one place the layout and its limits are written (the wrapper asks
//    it through conv_tower_plan_tile).
//  * "Same" padding is per layer and asymmetric: layer l pads (fs-1)/2
//    on the left and fs/2 on the right, and w[k] multiplies
//    x[t - (fs-1)/2 + k]. Every layer's input at a position outside
//    [0, S) must be ZERO, so each layer writes 0 there, never relu(bias).
//    Inside [0, S) x is used as given, masked or not: the mask only
//    decides which positions enter the pool.
//  * The pool is a running max per channel across tiles, started at
//    -inf; max is exact in any order.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxConv = 8;        // conv layers the param block holds
constexpr int kThreads = 256;
constexpr int kRows = 4;           // output rows per thread; the buffers
                                   // carry kRows spare rows for it
constexpr int kSmemLimit = 232448; // 227 KB a block may opt in to

template <typename T>
struct Tower {
  int c_in;                        // channels of x
  int n_conv;
  const T* conv_w[kMaxConv];       // (fs, Cin, Cout) each
  const T* conv_b[kMaxConv];       // (Cout,)
  int fs[kMaxConv];
  int c_out[kMaxConv];
  int ldc;                         // activation row stride (max width)
  int halo_l, halo_r, tile;
};

__device__ __forceinline__ float ld(const float* p) { return __ldg(p); }

__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ void st(float* p, float v) { *p = v; }

__device__ __forceinline__ void st(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);        // round to nearest even
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
conv_tower_kernel(const T* __restrict__ x, const float* __restrict__ mask,
                  int S, const Tower<T> net, T* __restrict__ out) {
  extern __shared__ float smem[];
  const int span = net.tile + net.halo_l + net.halo_r;
  const int rows = span + kRows;
  const int ldc = net.ldc;
  float* buf0 = smem;
  float* buf1 = buf0 + rows * ldc;
  const int c_last = net.c_out[net.n_conv - 1];
  float* pooled = buf1 + rows * ldc;            // (c_last,)

  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int C0 = net.c_in;
  const T* row_x = x + (size_t)blockIdx.x * S * C0;
  const float* row_m = mask + (size_t)blockIdx.x * S;

  for (int c = tid; c < c_last; c += nt) pooled[c] = -INFINITY;

  for (int t0 = 0; t0 < S; t0 += net.tile) {
    // buffer row r holds sequence position base + r
    const int base = t0 - net.halo_l;
    // positions outside [0, S) are zero rows
    for (int i = tid; i < span * C0; i += nt) {
      const int r = i / C0, e = i - r * C0;
      const int p = base + r;
      buf0[r * ldc + e] =
          (p >= 0 && p < S) ? ld(row_x + (size_t)p * C0 + e) : 0.f;
    }
    __syncthreads();

    float* in = buf0;
    float* nxt = buf1;
    int lo = 0, hi = span, c_in = C0;
    for (int l = 0; l < net.n_conv; ++l) {
      const int fs = net.fs[l];
      const int pad_l = (fs - 1) / 2, pad_r = fs / 2;
      const int c_out = net.c_out[l];
      const int olo = lo + pad_l, ohi = hi - pad_r;
      const int groups = (ohi - olo + kRows - 1) / kRows;
      const T* __restrict__ w = net.conv_w[l];
      const T* __restrict__ bias = net.conv_b[l];
      for (int i = tid; i < groups * c_out; i += nt) {
        const int co = i % c_out;
        const int r0 = olo + (i / c_out) * kRows;
        const float bv = ld(bias + co);
        float acc[kRows];
#pragma unroll
        for (int j = 0; j < kRows; ++j) acc[j] = bv;
        for (int k = 0; k < fs; ++k) {
          // rows past ohi read spare or stale rows; their sums are dropped
          const float* xr = in + (r0 - pad_l + k) * ldc;
          const T* wk = w + (size_t)k * c_in * c_out + co;
          // 16 weight loads in flight: with conv_forward.cu's unroll of 4
          // this kernel took twice as long (measured on the H100)
#pragma unroll 16
          for (int ci = 0; ci < c_in; ++ci) {
            const float wv = ld(wk + (size_t)ci * c_out);
#pragma unroll
            for (int j = 0; j < kRows; ++j)
              acc[j] = fmaf(xr[j * ldc + ci], wv, acc[j]);
          }
        }
#pragma unroll
        for (int j = 0; j < kRows; ++j) {
          const int r = r0 + j;
          if (r < ohi) {
            const int p = base + r;
            nxt[r * ldc + co] = (p >= 0 && p < S) ? fmaxf(acc[j], 0.f) : 0.f;
          }
        }
      }
      __syncthreads();
      float* t = in;
      in = nxt;
      nxt = t;
      lo = olo;
      hi = ohi;
      c_in = c_out;
    }
    // rows [lo, hi) are now the tile's own positions [t0, t0 + tile);
    // only the valid ones enter the pool
    for (int c = tid; c < c_last; c += nt) {
      float m = pooled[c];
      for (int r = lo; r < hi && base + r < S; ++r)
        if (row_m[base + r] > 0.f) m = fmaxf(m, in[r * ldc + c]);
      pooled[c] = m;
    }
    __syncthreads();
  }

  for (int c = tid; c < c_last; c += nt)
    st(out + (size_t)blockIdx.x * c_last + c, fmaxf(pooled[c], 0.f));
}

// The tile plan, the one place the shared-memory layout and the kernel's
// limits are decided. Dynamic shared memory holds two ping-pong buffers of
// (tile + halo_l + halo_r + kRows) x ldc floats and the pooled vector
// (c_last). tile is all of S when that fits in kSmemLimit, else as many
// positions as fit; 0 when not even one does; -1 for layer counts or
// sizes the kernel does not take.
struct Plan {
  int tile = -1, halo_l = 0, halo_r = 0, ldc = 0;
  size_t smem = 0;
};

Plan plan(int S, int c_in, int n_conv, const int* fs, const int* c_out) {
  Plan p;
  if (S < 1 || c_in < 1 || n_conv < 1 || n_conv > kMaxConv) return p;
  p.ldc = c_in;
  for (int l = 0; l < n_conv; ++l) {
    if (fs[l] < 1 || c_out[l] < 1) return p;
    p.halo_l += (fs[l] - 1) / 2;
    p.halo_r += fs[l] / 2;
    if (c_out[l] > p.ldc) p.ldc = c_out[l];
  }
  const long fixed = c_out[n_conv - 1];
  const long rows = (kSmemLimit / (long)sizeof(float) - fixed) / (2L * p.ldc);
  long tile = rows - p.halo_l - p.halo_r - kRows;
  if (tile > S) tile = S;
  if (tile < 1) {
    p.tile = 0;
    return p;
  }
  p.tile = (int)tile;
  p.smem = (size_t)(2L * (tile + p.halo_l + p.halo_r + kRows) * p.ldc +
                    fixed) * sizeof(float);
  return p;
}

// Returns 0, a cudaError_t, -1 (unsupported layer counts or sizes) or -2
// (not even one position per tile fits in shared memory).
template <typename T>
int launch(const void* x, const float* mask, int B, int S, int c_in,
           int n_conv, const void* const* conv_w, const void* const* conv_b,
           const int* fs, const int* c_out, void* out, void* stream) {
  const Plan p = plan(S, c_in, n_conv, fs, c_out);
  if (p.tile < 0 || B < 0) return -1;
  if (p.tile == 0) return -2;
  if (B == 0) return 0;
  Tower<T> net = {};
  net.c_in = c_in;
  net.n_conv = n_conv;
  for (int l = 0; l < n_conv; ++l) {
    net.conv_w[l] = static_cast<const T*>(conv_w[l]);
    net.conv_b[l] = static_cast<const T*>(conv_b[l]);
    net.fs[l] = fs[l];
    net.c_out[l] = c_out[l];
  }
  net.ldc = p.ldc;
  net.halo_l = p.halo_l;
  net.halo_r = p.halo_r;
  net.tile = p.tile;
  // the opt-in is per device, so it is set on every launch (it is cheap)
  const cudaError_t attr = cudaFuncSetAttribute(
      conv_tower_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)p.smem);
  if (attr != cudaSuccess) return (int)attr;
  conv_tower_kernel<T><<<B, kThreads, p.smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), mask, S, net, static_cast<T*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

#define CONV_TOWER_ARGS                                                    \
  const void *x, const float *mask, int B, int S, int c_in, int n_conv,   \
      const void *const *conv_w, const void *const *conv_b, const int *fs, \
      const int *c_out, void *out, void *stream

#define CONV_TOWER_PASS \
  x, mask, B, S, c_in, n_conv, conv_w, conv_b, fs, c_out, out, stream

extern "C" int conv_tower_f32(CONV_TOWER_ARGS) {
  return launch<float>(CONV_TOWER_PASS);
}

extern "C" int conv_tower_bf16(CONV_TOWER_ARGS) {
  return launch<__nv_bfloat16>(CONV_TOWER_PASS);
}

// Output positions per tile for these sizes (see plan()), or launch()'s
// codes: -1 for unsupported sizes, -2 when not even one position fits.
extern "C" int conv_tower_plan_tile(int S, int c_in, int n_conv,
                                    const int* fs, const int* c_out) {
  const int tile = plan(S, c_in, n_conv, fs, c_out).tile;
  return tile == 0 ? -2 : tile;
}

extern "C" const char* conv_tower_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
