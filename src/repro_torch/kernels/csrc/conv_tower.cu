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
// The tower, what bounds it and how the tiles of a row meet are in
// conv_tile.cuh, which conv_forward.cu shares. Here the tile's input is x
// as given, masked or not (the mask only decides which positions enter
// the pool), and the row's last block floors the pool at 0 and stores it.
// One launch is one cudaMemsetAsync (the row counters) and one kernel.
#include "conv_tile.cuh"

namespace {

using namespace conv_tile;

template <typename T>
__global__ void __launch_bounds__(kThreads, 3)
conv_tower_kernel(const T* __restrict__ x, const float* __restrict__ mask,
                  int S, const __grid_constant__ Tower<T> net,
                  T* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  const Smem s = carve(net, smem);
  const int row = blockIdx.x / net.n_tiles, tile = blockIdx.x % net.n_tiles;
  const int C0 = net.c_in, C4 = round4(C0);
  const T* row_x = x + (size_t)row * S * C0;
  const float* row_m = mask + (size_t)row * S;

  // positions outside [0, S) are zero rows
  auto load = [&](float* buf, int span, int ldc, int base) {
    for (int i = threadIdx.x; i < span * C4; i += kThreads) {
      const int r = i / C4, e = i - r * C4;
      const int p = base + r;
      buf[r * ldc + e] = e < C0 && p >= 0 && p < S
                             ? ld(row_x + (size_t)p * C0 + e)
                             : 0.f;
    }
  };
  auto valid = [&](int p) { return row_m[p] > 0.f; };
  if (!tower_tile(net, s, S, row, tile, load, valid)) return;

  const int c_last = net.c_out[net.n_conv - 1];
  for (int c = threadIdx.x; c < c_last; c += kThreads)
    st(out + (size_t)row * c_last + c, fmaxf(s.pooled[c], 0.f));
}

// Returns 0, a cudaError_t, -1 (unsupported layer counts or sizes), -2
// (not even one position per tile fits in shared memory) or -3 (the
// workspace is smaller than the plan's).
template <typename T>
int launch(const void* x, const float* mask, int B, int S, int c_in,
           int n_conv, const void* const* conv_w, const void* const* conv_b,
           const int* fs, const int* c_out, void* out, void* workspace,
           size_t workspace_bytes, void* stream) {
  const Plan p = tile_plan(B, S, c_in, n_conv, fs, c_out, 0);
  if (p.tile < 0) return -1;
  if (p.tile == 0) return -2;
  if (B == 0) return 0;
  if (workspace_bytes < p.workspace) return -3;
  Tower<T> net = {};
  fill_tower(net, p, c_in, n_conv, conv_w, conv_b, fs, c_out, B, workspace);
  return launch_tiles(conv_tower_kernel<T>, p, B, workspace,
                      static_cast<cudaStream_t>(stream),
                      static_cast<const T*>(x), mask, S, net,
                      static_cast<T*>(out));
}

}  // namespace

#define CONV_TOWER_ARGS                                                    \
  const void *x, const float *mask, int B, int S, int c_in, int n_conv,   \
      const void *const *conv_w, const void *const *conv_b, const int *fs, \
      const int *c_out, void *out, void *workspace, size_t workspace_bytes, \
      void *stream

#define CONV_TOWER_PASS                                                   \
  x, mask, B, S, c_in, n_conv, conv_w, conv_b, fs, c_out, out, workspace, \
      workspace_bytes, stream

extern "C" int conv_tower_f32(CONV_TOWER_ARGS) {
  return launch<float>(CONV_TOWER_PASS);
}

extern "C" int conv_tower_bf16(CONV_TOWER_ARGS) {
  return launch<__nv_bfloat16>(CONV_TOWER_PASS);
}

// The plan for these sizes, as conv_forward_plan gives it.
extern "C" int conv_tower_plan(int B, int S, int c_in, int n_conv,
                               const int* fs, const int* c_out,
                               long long* info) {
  const Plan p = tile_plan(B, S, c_in, n_conv, fs, c_out, 0);
  if (p.tile < 1) return p.tile == 0 ? -2 : -1;
  info[0] = p.tile;
  info[1] = p.n_tiles;
  info[2] = (long long)B * p.n_tiles;
  info[3] = (long long)p.smem;
  info[4] = (long long)p.workspace;
  return 0;
}

extern "C" const char* conv_tower_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
