// Fused serving forward of the Conv1D cost model: token ids in,
// per-target predictions out, in one kernel launch.
//
// Replaces the TPU kernel src/repro/kernels/conv1d_stack.py::
// conv_forward_fused (body _forward_kernel). Per batch row it computes
//   1. x = emb[ids], with the rows of PAD id 0 zeroed (emb[0] is not 0);
//   2. L x ("same" conv as fs shifted taps, + bias, ReLU);
//   3. max over ALL S positions, pads included (not masked);
//   4. the hidden FC stack with ReLU;
//   5. every head as one (F, n_heads) matmul + bias.
// Params are float32 or bfloat16; all arithmetic and the output are f32.
//
// What bounds it on an H100 (SXM): at COSTMODEL_BASE (6 layers, fs=2,
// 64 channels), B=64, S=256 the conv tower is sum 2*S*fs*Cin*Cout
// ~= 25.2 MFLOP per row, ~1.61 GFLOP in all: ~24 us at the published
// 67 TFLOP/s of float32 outside the tensor cores. The bytes it must move
// (ids, the gathered embedding rows, the params, the output) are below
// 4.6 MB: ~1.4 us at 3.35 TB/s. The float32 kernel is bound by
// operations. It accumulates with plain FFMA, never TF32: TF32's 10-bit
// mantissa puts a plain version about 1e-3 relative off the float32
// reference, outside the 2e-4 parity at outputs of a few tenths
// (chip_smoke.py reports the TF32 plain version's error). The bf16 path
// could later reach the tensor cores.
//
// Design (simple and right first; making it fast -- wgmma, TMA, several
// rows per block for small B -- is later work):
//  * One thread block per batch row. Rows never share a reduction, so a
//    row's output is bit-identical for every batch size B.
//  * The embedding table (2 MiB f32 at COSTMODEL_BASE) does not fit in
//    shared memory; rows are gathered from global memory, where the
//    table stays resident in L2.
//  * The sequence is cut into tiles of T output positions. A tile also
//    computes a left halo of sum (fs-1)/2 and a right halo of sum fs/2
//    positions, which it recomputes instead of exchanging. Two ping-pong
//    activation buffers of (T + halo + kRows) x C_max f32 live in dynamic
//    shared memory; plan() picks T so that they fit in 227 KB. plan() is
//    the one place the layout and its limits are written: the wrapper
//    asks it through conv_forward_plan_tile.
//  * An id outside [0, V) reads as PAD, so the kernel never reads outside
//    the table; the wrapper rejects such ids (on the host for the
//    service's ids, by default with a device check).
//  * "Same" padding is per layer and asymmetric: layer l pads (fs-1)/2
//    on the left and fs/2 on the right, and w[k] multiplies
//    x[t - (fs-1)/2 + k]. Every layer's input at a position outside
//    [0, S) must be ZERO, so each layer writes 0 there, never
//    relu(bias).
//  * The max-pool is a running max per channel across tiles; max is
//    exact in any order. The FC stack and the heads then run in the same
//    block on the pooled vector, with weights read from global memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxConv = 8;        // conv layers the param block holds
constexpr int kMaxFc = 4;          // hidden FC layers
constexpr int kThreads = 256;
constexpr int kRows = 4;           // output rows per thread; the buffers
                                   // carry kRows spare rows for it
constexpr int kSmemLimit = 232448; // 227 KB a block may opt in to

template <typename T>
struct Net {
  const T* emb;
  int vocab;
  int embed;
  int n_conv;
  const T* conv_w[kMaxConv];       // (fs, Cin, Cout) each
  const T* conv_b[kMaxConv];       // (Cout,)
  int fs[kMaxConv];
  int c_out[kMaxConv];
  int n_fc;
  const T* fc_w[kMaxFc];           // (Fin, Fout)
  const T* fc_b[kMaxFc];
  int fc_out[kMaxFc];
  const T* head_w;                 // (F, n_heads), heads stacked
  const T* head_b;                 // (n_heads,)
  int n_heads;
  int ldc;                         // activation row stride (max width)
  int f_max;                       // widest hidden FC layer
  int halo_l, halo_r, tile;
};

__device__ __forceinline__ float ld(const float* p) { return __ldg(p); }

__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
conv_forward_kernel(const int* __restrict__ ids, int S, const Net<T> net,
                    float* __restrict__ out) {
  extern __shared__ float smem[];
  const int span = net.tile + net.halo_l + net.halo_r;
  const int rows = span + kRows;
  const int ldc = net.ldc;
  float* buf0 = smem;
  float* buf1 = buf0 + rows * ldc;
  const int c_last = net.c_out[net.n_conv - 1];
  float* pooled = buf1 + rows * ldc;            // (c_last,)
  float* h0 = pooled + c_last;                  // (f_max,)
  float* h1 = h0 + net.f_max;                   // (f_max,)

  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int* row_ids = ids + (size_t)blockIdx.x * S;

  for (int c = tid; c < c_last; c += nt) pooled[c] = -INFINITY;

  for (int t0 = 0; t0 < S; t0 += net.tile) {
    // buffer row r holds sequence position base + r
    const int base = t0 - net.halo_l;
    // gather: positions outside [0, S) and PAD ids give zero rows
    const int E = net.embed;
    for (int i = tid; i < span * E; i += nt) {
      const int r = i / E, e = i - r * E;
      const int p = base + r;
      const int id = (p >= 0 && p < S) ? row_ids[p] : 0;
      buf0[r * ldc + e] = id > 0 && id < net.vocab
                              ? ld(net.emb + (size_t)id * E + e)
                              : 0.f;
    }
    __syncthreads();

    float* in = buf0;
    float* nxt = buf1;
    int lo = 0, hi = span, c_in = E;
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
          const float* x = in + (r0 - pad_l + k) * ldc;
          const T* wk = w + (size_t)k * c_in * c_out + co;
#pragma unroll 4
          for (int ci = 0; ci < c_in; ++ci) {
            const float wv = ld(wk + (size_t)ci * c_out);
#pragma unroll
            for (int j = 0; j < kRows; ++j)
              acc[j] = fmaf(x[j * ldc + ci], wv, acc[j]);
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
    // rows [lo, hi) are now the tile's own positions [t0, t0 + tile)
    for (int c = tid; c < c_last; c += nt) {
      float m = pooled[c];
      for (int r = lo; r < hi && base + r < S; ++r)
        m = fmaxf(m, in[r * ldc + c]);
      pooled[c] = m;
    }
    __syncthreads();
  }

  // hidden FC stack, then every head as one matmul
  const float* hin = pooled;
  int f_in = c_last;
  for (int l = 0; l < net.n_fc; ++l) {
    const int f_out = net.fc_out[l];
    float* hout = (l & 1) ? h1 : h0;
    const T* __restrict__ w = net.fc_w[l];
    for (int o = tid; o < f_out; o += nt) {
      float acc = ld(net.fc_b[l] + o);
      for (int k = 0; k < f_in; ++k)
        acc = fmaf(hin[k], ld(w + (size_t)k * f_out + o), acc);
      hout[o] = fmaxf(acc, 0.f);
    }
    __syncthreads();
    hin = hout;
    f_in = f_out;
  }
  for (int o = tid; o < net.n_heads; o += nt) {
    float acc = ld(net.head_b + o);
    for (int k = 0; k < f_in; ++k)
      acc = fmaf(hin[k], ld(net.head_w + (size_t)k * net.n_heads + o), acc);
    out[(size_t)blockIdx.x * net.n_heads + o] = acc;
  }
}

// The tile plan, the one place the shared-memory layout and the kernel's
// limits are decided. Dynamic shared memory holds two ping-pong buffers of
// (tile + halo_l + halo_r + kRows) x ldc floats, the pooled vector
// (c_last) and two FC scratch vectors (f_max each). tile is all of S when
// that fits in kSmemLimit, else as many positions as fit; 0 when not even
// one does; -1 for layer counts or sizes the kernel does not take.
struct Plan {
  int tile = -1, halo_l = 0, halo_r = 0, ldc = 0, f_max = 1;
  size_t smem = 0;
};

Plan plan(int S, int embed, int n_conv, const int* fs, const int* c_out,
          int n_fc, const int* fc_out) {
  Plan p;
  if (S < 1 || embed < 1 || n_conv < 1 || n_conv > kMaxConv || n_fc < 0 ||
      n_fc > kMaxFc)
    return p;
  p.ldc = embed;
  for (int l = 0; l < n_conv; ++l) {
    if (fs[l] < 1 || c_out[l] < 1) return p;
    p.halo_l += (fs[l] - 1) / 2;
    p.halo_r += fs[l] / 2;
    if (c_out[l] > p.ldc) p.ldc = c_out[l];
  }
  for (int l = 0; l < n_fc; ++l) {
    if (fc_out[l] < 1) return p;
    if (fc_out[l] > p.f_max) p.f_max = fc_out[l];
  }
  const long fixed = c_out[n_conv - 1] + 2L * p.f_max;
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
int launch(const int* ids, int B, int S, const void* emb, int vocab,
           int embed, int n_conv, const void* const* conv_w,
           const void* const* conv_b, const int* fs, const int* c_out,
           int n_fc, const void* const* fc_w, const void* const* fc_b,
           const int* fc_out, const void* head_w, const void* head_b,
           int n_heads, float* out, void* stream) {
  const Plan p = plan(S, embed, n_conv, fs, c_out, n_fc, fc_out);
  if (p.tile < 0 || B < 0 || n_heads < 1 || vocab < 1) return -1;
  if (p.tile == 0) return -2;
  Net<T> net = {};
  net.emb = static_cast<const T*>(emb);
  net.vocab = vocab;
  net.embed = embed;
  net.n_conv = n_conv;
  for (int l = 0; l < n_conv; ++l) {
    net.conv_w[l] = static_cast<const T*>(conv_w[l]);
    net.conv_b[l] = static_cast<const T*>(conv_b[l]);
    net.fs[l] = fs[l];
    net.c_out[l] = c_out[l];
  }
  net.n_fc = n_fc;
  for (int l = 0; l < n_fc; ++l) {
    net.fc_w[l] = static_cast<const T*>(fc_w[l]);
    net.fc_b[l] = static_cast<const T*>(fc_b[l]);
    net.fc_out[l] = fc_out[l];
  }
  net.head_w = static_cast<const T*>(head_w);
  net.head_b = static_cast<const T*>(head_b);
  net.n_heads = n_heads;
  net.ldc = p.ldc;
  net.f_max = p.f_max;
  net.halo_l = p.halo_l;
  net.halo_r = p.halo_r;
  net.tile = p.tile;
  if (B == 0) return 0;
  // the opt-in is per device, so it is set on every launch (it is cheap)
  const cudaError_t attr = cudaFuncSetAttribute(
      conv_forward_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)p.smem);
  if (attr != cudaSuccess) return (int)attr;
  conv_forward_kernel<T><<<B, kThreads, p.smem,
                           static_cast<cudaStream_t>(stream)>>>(
      ids, S, net, out);
  return (int)cudaGetLastError();
}

}  // namespace

#define CONV_FORWARD_ARGS                                                  \
  const int *ids, int B, int S, const void *emb, int vocab, int embed,    \
      int n_conv, const void *const *conv_w, const void *const *conv_b,   \
      const int *fs, const int *c_out, int n_fc, const void *const *fc_w, \
      const void *const *fc_b, const int *fc_out, const void *head_w,     \
      const void *head_b, int n_heads, float *out, void *stream

#define CONV_FORWARD_PASS                                                  \
  ids, B, S, emb, vocab, embed, n_conv, conv_w, conv_b, fs, c_out, n_fc,   \
      fc_w, fc_b, fc_out, head_w, head_b, n_heads, out, stream

extern "C" int conv_forward_f32(CONV_FORWARD_ARGS) {
  return launch<float>(CONV_FORWARD_PASS);
}

extern "C" int conv_forward_bf16(CONV_FORWARD_ARGS) {
  return launch<__nv_bfloat16>(CONV_FORWARD_PASS);
}

// Output positions per tile for these sizes (see plan()), or launch()'s
// codes: -1 for unsupported sizes, -2 when not even one position fits.
extern "C" int conv_forward_plan_tile(int S, int embed, int n_conv,
                                      const int* fs, const int* c_out,
                                      int n_fc, const int* fc_out) {
  const int tile = plan(S, embed, n_conv, fs, c_out, n_fc, fc_out).tile;
  return tile == 0 ? -2 : tile;
}

extern "C" const char* conv_forward_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
