// The Conv1D tower on one sequence tile, shared by conv_forward.cu (K1,
// the fused serving forward) and conv_tower.cu (K3, the masked tower).
//
// What bounds it on an H100 (SXM): at COSTMODEL_BASE (6 layers, fs=2,
// 64 channels), S=256 the tower is sum 2*S*fs*Cin*Cout ~= 25.2 MFLOP per
// row (~1.61 GFLOP at B=64: ~24 us at the published 67 TFLOP/s of
// float32 outside the tensor cores), against a few MB of bytes: bound by
// operations. It accumulates with plain FFMA, never TF32 (TF32's 10-bit
// mantissa lands outside the 2e-4 parity at outputs of a few tenths).
//
// Design:
//  * A row's sequence is cut into n_tiles tiles of T output positions,
//    and each (row, tile) is an ordinary thread block: grid B * n_tiles.
//    A tile also computes a left halo of sum (fs-1)/2 and a right halo of
//    sum fs/2 positions, which it recomputes; blocks never talk to each
//    other during the tower. tile_plan() picks T from B and S so that a
//    small batch still fills the card (B * n_tiles >= kTargetBlocks where
//    the tiles can be that short), and is the one place T is written down.
//  * T may change with B and rows stay bit-identical, because every conv
//    output is computed in one fixed order -- bias, then taps k = 0..fs-1,
//    then input channels ci ascending, one FFMA each -- whatever tile or
//    thread computes it, and max is exact in any order.
//  * Weights are staged in shared memory one tap at a time, (Cin x Cout)
//    widened to f32 and zero-padded to multiples of 4, in two buffers: the
//    next tap is fetched (cp.async for f32) while the current one is
//    consumed, so any filter size fits. Every layer's bias is staged once,
//    at the start, so no tap waits on a global load.
//  * Register blocking: a thread computes 4 positions x 4 output channels
//    from 16-byte reads of x and w: 8 shared-memory loads per 64 FFMA.
//    The running sums of a tap live in the next layer's buffer between
//    taps (a store and a reload of a float are exact), so a block may
//    hold more (position, channel) groups than threads.
//  * Every layer's input at a position outside [0, S) must be ZERO ("same"
//    padding: layer l pads (fs-1)/2 left and fs/2 right, w[k] multiplies
//    x[t - (fs-1)/2 + k]), so each layer writes 0 there, never relu(bias).
//  * The pool meets once: each block writes its tile's per-channel max to
//    a workspace, then counts itself in its row's arrival counter; the
//    row's last block to arrive reduces the partials in tile order and
//    runs the epilogue (K1: FC stack and heads; K3: floor and store). No
//    second kernel and no dependence on arrival order. The workspace and
//    its counters (zeroed by cudaMemsetAsync on the launching stream)
//    come from the caller for each launch, so two streams never share one.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace conv_tile {

constexpr int kMaxConv = 8;         // conv layers the param block holds
constexpr int kThreads = 256;
constexpr int kRP = 4;              // positions per thread (register block)
constexpr int kRC = 4;              // output channels per thread
constexpr int kSmemLimit = 232448;  // 227 KB a block may opt in to
constexpr int kTargetBlocks = 2 * 132;  // two blocks per H100 SM

__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }

template <typename T>
struct Tower {
  int c_in;                          // channels of the tower's input
  int n_conv;
  const T* conv_w[kMaxConv];         // (fs, Cin, Cout) each
  const T* conv_b[kMaxConv];         // (Cout,)
  int fs[kMaxConv];
  int c_out[kMaxConv];
  int ldc;                           // activation row stride, round4(max)
  int wsize;                         // floats of one staged tap
  int halo_l, halo_r, tile, n_tiles;
  unsigned* counters;                // (B,), zeroed before the launch
  float* partials;                   // (B, n_tiles, c_last)
};

// The tile plan. Dynamic shared memory holds two ping-pong activation
// buffers of (T + halo_l + halo_r + kRP) x ldc floats (kRP spare rows for
// the last register block), two staged taps of wsize floats, every
// layer's bias (n_conv x ldc), the pooled vector, kThreads floats of
// scratch and tail_floats for the epilogue.
// tile is 0 when not even one position fits, -1 for layer counts or sizes
// the kernels do not take.
struct Plan {
  int tile = -1, n_tiles = 0, halo_l = 0, halo_r = 0, ldc = 0, wsize = 0;
  size_t smem = 0, workspace = 0;
};

inline Plan tile_plan(int B, int S, int c_in, int n_conv, const int* fs,
                      const int* c_out, long tail_floats) {
  Plan p;
  if (B < 0 || S < 1 || c_in < 1 || n_conv < 1 || n_conv > kMaxConv)
    return p;
  int width = round4(c_in), widest_out = 0;
  long wsize = 0;
  for (int l = 0; l < n_conv; ++l) {
    if (fs[l] < 1 || c_out[l] < 1) return p;
    p.halo_l += (fs[l] - 1) / 2;
    p.halo_r += fs[l] / 2;
    const long tap = (long)round4(l ? c_out[l - 1] : c_in) * round4(c_out[l]);
    if (tap > wsize) wsize = tap;
    if (round4(c_out[l]) > width) width = round4(c_out[l]);
    if (round4(c_out[l]) > widest_out) widest_out = round4(c_out[l]);
  }
  p.ldc = width;
  const int halo = p.halo_l + p.halo_r;
  const long fixed = 2 * wsize + (long)n_conv * width +
                     round4(c_out[n_conv - 1]) + kThreads + tail_floats;
  const long rows = (kSmemLimit / (long)sizeof(float) - fixed) / (2L * width);
  const long cap = rows - halo - kRP;          // longest tile that fits
  if (wsize > (1L << 24) || cap < 1) {
    p.tile = 0;
    return p;
  }
  p.wsize = (int)wsize;
  // one (position, channel) group per thread at the widest layer ...
  const long one_pass = (long)(kThreads / (widest_out / kRC)) * kRP - halo;
  // ... but no shorter than twice the halo or four register blocks
  const long floor_t = 2L * halo > 4L * kRP ? 2L * halo : 4L * kRP;
  long hi = one_pass > floor_t ? one_pass : floor_t;
  if (hi > cap) hi = cap;
  if (hi > S) hi = S;
  const long lo = floor_t < hi ? floor_t : hi;
  const long want = (kTargetBlocks + (B > 0 ? B : 1) - 1) / (B > 0 ? B : 1);
  long t = (S + want - 1) / want;
  if (t < lo) t = lo;
  if (t > hi) t = hi;
  const long n = (S + t - 1) / t;
  const long even = (S + n - 1) / n;           // the same n, tiles evened
  if (even >= lo) t = even;
  p.tile = (int)t;
  p.n_tiles = (int)((S + t - 1) / t);
  p.smem = (size_t)(2L * (t + halo + kRP) * width + fixed) * sizeof(float);
  p.workspace = (size_t)round4(B) * sizeof(unsigned) +
                (size_t)B * p.n_tiles * round4(c_out[n_conv - 1]) *
                    sizeof(float);
  return p;
}

__device__ __forceinline__ float ld(const float* p) { return __ldg(p); }

__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ void st(float* p, float v) { *p = v; }

__device__ __forceinline__ void st(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);          // round to nearest even
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Stage tap w (c_in x c_out, row-major) into dst as (round4(c_in) x
// round4(c_out)) f32, zero-padded. f32 goes by cp.async (16 bytes where
// the row allows it), bf16 is widened through registers.
template <typename T>
__device__ void stage_tap(float* dst, const T* w, int c_in, int c_out) {
  const int cpad = round4(c_out), n4 = round4(c_in) * cpad / 4;
  bool wide = false;
  if constexpr (std::is_same<T, float>::value)
    wide = c_out % 4 == 0 && ((uintptr_t)w & 15) == 0;
  for (int i = threadIdx.x; i < n4; i += kThreads) {
    const int ci = (4 * i) / cpad, c = 4 * i - ci * cpad;
    float* d = dst + 4 * i;
    const T* s = w + (size_t)ci * c_out + c;
    if constexpr (std::is_same<T, float>::value) {
      if (wide && ci < c_in) {
        cp_async16(d, s);
        continue;
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (ci < c_in && c + e < c_out) {
        if constexpr (std::is_same<T, float>::value)
          cp_async4(d + e, s + e);
        else
          d[e] = ld(s + e);
      } else {
        d[e] = 0.f;
      }
    }
  }
  cp_async_commit();
}

// One tap k of layer l: the running sums of rows [olo, ohi) of nxt gain
// sum_ci in[r - pad_l + k][ci] * w[ci][co]. Tap 0 starts from the bias;
// the last tap applies ReLU, or writes 0 outside [0, S).
template <typename T>
__device__ void conv_tap(const Tower<T>& net, int l, int k, int c_in,
                         const float* __restrict__ in,
                         float* __restrict__ nxt,
                         const float* __restrict__ w,
                         const float* __restrict__ bias, int olo, int ohi,
                         int base, int S) {
  const int ldc = net.ldc;
  const int fs = net.fs[l], pad_l = (fs - 1) / 2, c_out = net.c_out[l];
  const int cpad = round4(c_out), ncg = cpad / kRC, cin4 = round4(c_in);
  const int items = (ohi - olo + kRP - 1) / kRP * ncg;
  const bool first = k == 0, last = k == fs - 1;
  for (int i = threadIdx.x; i < items; i += kThreads) {
    const int co = (i % ncg) * kRC;
    const int r0 = olo + (i / ncg) * kRP;
    float acc[kRP][kRC];
    if (first) {
      const float4 b = *reinterpret_cast<const float4*>(bias + co);
#pragma unroll
      for (int j = 0; j < kRP; ++j)
        acc[j][0] = b.x, acc[j][1] = b.y, acc[j][2] = b.z, acc[j][3] = b.w;
    } else {
#pragma unroll
      for (int j = 0; j < kRP; ++j) {
        const float4 v =
            *reinterpret_cast<const float4*>(nxt + (r0 + j) * ldc + co);
        acc[j][0] = v.x, acc[j][1] = v.y, acc[j][2] = v.z, acc[j][3] = v.w;
      }
    }
    // rows past ohi read spare or stale rows; their sums are dropped
    const float* x = in + (r0 - pad_l + k) * ldc;
    const float* wc = w + co;
#pragma unroll 2
    for (int ci = 0; ci < cin4; ci += 4) {
      float xv[kRP][4], wv[4][kRC];
#pragma unroll
      for (int j = 0; j < kRP; ++j) {
        const float4 v = *reinterpret_cast<const float4*>(x + j * ldc + ci);
        xv[j][0] = v.x, xv[j][1] = v.y, xv[j][2] = v.z, xv[j][3] = v.w;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 v =
            *reinterpret_cast<const float4*>(wc + (ci + q) * cpad);
        wv[q][0] = v.x, wv[q][1] = v.y, wv[q][2] = v.z, wv[q][3] = v.w;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int j = 0; j < kRP; ++j)
#pragma unroll
          for (int c = 0; c < kRC; ++c)
            acc[j][c] = fmaf(xv[j][q], wv[q][c], acc[j][c]);
    }
#pragma unroll
    for (int j = 0; j < kRP; ++j) {
      const int r = r0 + j;
      if (last) {
        if (r >= ohi) continue;
        const int p = base + r;
        const bool inside = p >= 0 && p < S;
#pragma unroll
        for (int c = 0; c < kRC; ++c)
          acc[j][c] = inside ? fmaxf(acc[j][c], 0.f) : 0.f;
      }
      *reinterpret_cast<float4*>(nxt + r * ldc + co) =
          make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
    }
  }
}

// Shared-memory layout of a block (see Plan).
struct Smem {
  float *buf0, *buf1, *w0, *w1, *bias, *pooled, *scratch, *tail;
};

template <typename T>
__device__ Smem carve(const Tower<T>& net, float* smem) {
  const int rows = net.tile + net.halo_l + net.halo_r + kRP;
  Smem s;
  s.buf0 = smem;
  s.buf1 = s.buf0 + rows * net.ldc;
  s.w0 = s.buf1 + rows * net.ldc;
  s.w1 = s.w0 + net.wsize;
  s.bias = s.w1 + net.wsize;
  s.pooled = s.bias + net.n_conv * net.ldc;
  s.scratch = s.pooled + round4(net.c_out[net.n_conv - 1]);
  s.tail = s.scratch + kThreads;
  return s;
}

// The tower on one tile, then the pool's meeting. fill(buf, span, ldc,
// base) writes the tower's input rows (sequence positions base ..
// base + span - 1, zero outside [0, S), columns up to round4(c_in), the
// pad columns zero); valid(p) says whether position p enters the pool.
// Returns true in the row's last block to arrive only, with the row's
// pool (the max over every tile's valid positions, -inf where none) in
// s.pooled.
template <typename T, typename Fill, typename Valid>
__device__ bool tower_tile(const Tower<T>& net, const Smem& s, int S,
                           int row, int tile, Fill fill, Valid valid) {
  const int tid = threadIdx.x;
  const int t0 = tile * net.tile;
  const int base = t0 - net.halo_l;            // buffer row r: position
  const int span = net.tile + net.halo_l + net.halo_r;
  const int c_last = net.c_out[net.n_conv - 1];

  stage_tap(s.w0, net.conv_w[0], net.c_in, net.c_out[0]);
  fill(s.buf0, span, net.ldc, base);
  for (int i = tid; i < net.n_conv * net.ldc; i += kThreads) {
    const int l = i / net.ldc, c = i - l * net.ldc;
    s.bias[i] = c < net.c_out[l] ? ld(net.conv_b[l] + c) : 0.f;
  }

  float* in = s.buf0;
  float* nxt = s.buf1;
  int lo = 0, hi = span, c_in = net.c_in, g = 0;
  for (int l = 0; l < net.n_conv; ++l) {
    const int fs = net.fs[l], c_out = net.c_out[l];
    const int olo = lo + (fs - 1) / 2, ohi = hi - fs / 2;
    for (int k = 0; k < fs; ++k, ++g) {
      cp_async_wait_all();
      __syncthreads();           // tap g staged; tap g-1's buffer is free
      float* const cur = (g & 1) ? s.w1 : s.w0;
      float* const next = (g & 1) ? s.w0 : s.w1;
      if (k + 1 < fs)
        stage_tap(next, net.conv_w[l] + (size_t)(k + 1) * c_in * c_out, c_in,
                  c_out);
      else if (l + 1 < net.n_conv)
        stage_tap(next, net.conv_w[l + 1], c_out, net.c_out[l + 1]);
      conv_tap(net, l, k, c_in, in, nxt, cur, s.bias + l * net.ldc, olo, ohi,
               base, S);
    }
    float* t = in;
    in = nxt;
    nxt = t;
    lo = olo;
    hi = ohi;
    c_in = c_out;
  }
  __syncthreads();

  // rows [lo, hi) are the tile's own positions; its max per channel,
  // split over up to kThreads / c_last threads a channel
  const int parts = c_last < kThreads ? kThreads / c_last : 1;
  float* part_out = net.partials + ((size_t)row * net.n_tiles + tile) * c_last;
  for (int i = tid; i < parts * c_last; i += kThreads) {
    const int c = i % c_last;
    float m = -INFINITY;
    for (int r = lo + i / c_last; r < hi && base + r < S; r += parts)
      if (valid(base + r)) m = fmaxf(m, in[r * net.ldc + c]);
    if (parts == 1)
      part_out[c] = m;
    else
      s.scratch[i] = m;
  }
  if (parts > 1) {
    __syncthreads();
    for (int c = tid; c < c_last; c += kThreads) {
      float m = s.scratch[c];
      for (int q = 1; q < parts; ++q) m = fmaxf(m, s.scratch[q * c_last + c]);
      part_out[c] = m;
    }
  }

  // the row's last block to arrive reduces every tile's partial
  __shared__ int is_last;
  __threadfence();
  __syncthreads();
  if (tid == 0)
    is_last = atomicAdd(net.counters + row, 1u) == (unsigned)net.n_tiles - 1;
  __syncthreads();
  if (!is_last) return false;
  __threadfence();
  const float* row_parts = net.partials + (size_t)row * net.n_tiles * c_last;
  for (int c = tid; c < c_last; c += kThreads) {
    float m = __ldcg(row_parts + c);
    for (int t = 1; t < net.n_tiles; ++t)
      m = fmaxf(m, __ldcg(row_parts + (size_t)t * c_last + c));
    s.pooled[c] = m;
  }
  __syncthreads();
  return true;
}

// Fill the Tower fields common to both kernels from a plan, and the
// workspace pointers.
template <typename T>
void fill_tower(Tower<T>& net, const Plan& p, int c_in, int n_conv,
                const void* const* conv_w, const void* const* conv_b,
                const int* fs, const int* c_out, int B, void* workspace) {
  net.c_in = c_in;
  net.n_conv = n_conv;
  for (int l = 0; l < n_conv; ++l) {
    net.conv_w[l] = static_cast<const T*>(conv_w[l]);
    net.conv_b[l] = static_cast<const T*>(conv_b[l]);
    net.fs[l] = fs[l];
    net.c_out[l] = c_out[l];
  }
  net.ldc = p.ldc;
  net.wsize = p.wsize;
  net.halo_l = p.halo_l;
  net.halo_r = p.halo_r;
  net.tile = p.tile;
  net.n_tiles = p.n_tiles;
  net.counters = static_cast<unsigned*>(workspace);
  net.partials = reinterpret_cast<float*>(
      static_cast<char*>(workspace) + (size_t)round4(B) * sizeof(unsigned));
}

// Zero the row counters on the stream, then launch kernel on B * n_tiles
// blocks. Returns 0 or a cudaError_t.
template <typename Kernel, typename... Args>
int launch_tiles(Kernel kernel, const Plan& p, int B, void* workspace,
                 cudaStream_t stream, Args... args) {
  // the opt-in is per device, so it is set on every launch (it is cheap)
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
  if (e != cudaSuccess) return (int)e;
  e = cudaMemsetAsync(workspace, 0, (size_t)B * sizeof(unsigned), stream);
  if (e != cudaSuccess) return (int)e;
  kernel<<<(unsigned)B * p.n_tiles, kThreads, p.smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace conv_tile
