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
// What bounds it, and the tiled tower (a row's sequence tiles on
// independent blocks, weights staged in shared memory a tap at a time, a
// 4 x 4 register block a thread, the pool met once by the row's last
// block), are in conv_tile.cuh, which conv_tower.cu shares. Here:
//  * The gather: the embedding table (2 MiB f32 at COSTMODEL_BASE) stays
//    in global memory, resident in L2; each tile gathers its own rows and
//    halo. An id outside [0, V) reads as PAD, so the kernel never reads
//    outside the table; the wrapper rejects such ids (on the host for the
//    service's ids, by default with a device check).
//  * The epilogue in the row's last block: each FC output's k is split
//    over up to kThreads / Fout threads (coalesced weight reads from L2),
//    and the parts are summed in part order, so a row's bits never depend
//    on B or on the order the tiles arrived in.
// One served batch is one cudaMemsetAsync (the row counters) and one
// kernel launch.
#include "conv_tile.cuh"

namespace {

using namespace conv_tile;

constexpr int kMaxFc = 4;          // hidden FC layers

template <typename T>
struct Net {
  Tower<T> tower;
  const T* emb;
  int vocab;
  int n_fc;
  const T* fc_w[kMaxFc];           // (Fin, Fout)
  const T* fc_b[kMaxFc];
  int fc_out[kMaxFc];
  const T* head_w;                 // (F, n_heads), heads stacked
  const T* head_b;                 // (n_heads,)
  int n_heads;
  int f_max;                       // widest hidden FC layer
};

// hout[o] = act(b[o] + sum_k hin[k] w[k][o]) with k split over parts
// threads an output; the parts add up in part order
template <typename T>
__device__ void dense(const float* hin, int f_in, const T* __restrict__ w,
                      const T* __restrict__ b, int f_out, float* scratch,
                      bool relu, float* hout, float* gout) {
  const int tid = threadIdx.x;
  int parts = f_out < kThreads ? kThreads / f_out : 1;
  if (parts > f_in) parts = f_in;
  const int chunk = (f_in + parts - 1) / parts;
  for (int i = tid; i < parts * f_out; i += kThreads) {
    const int o = i % f_out, k0 = (i / f_out) * chunk;
    const int k1 = k0 + chunk < f_in ? k0 + chunk : f_in;
    float acc = parts == 1 ? ld(b + o) : 0.f;
#pragma unroll 16
    for (int k = k0; k < k1; ++k)
      acc = fmaf(hin[k], ld(w + (size_t)k * f_out + o), acc);
    if (parts == 1) {
      const float v = relu ? fmaxf(acc, 0.f) : acc;
      if (hout) hout[o] = v;
      if (gout) gout[o] = v;
    } else {
      scratch[i] = acc;
    }
  }
  if (parts > 1) {
    __syncthreads();
    for (int o = tid; o < f_out; o += kThreads) {
      float acc = ld(b + o);
      for (int q = 0; q < parts; ++q) acc += scratch[q * f_out + o];
      const float v = relu ? fmaxf(acc, 0.f) : acc;
      if (hout) hout[o] = v;
      if (gout) gout[o] = v;
    }
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 3)
conv_forward_kernel(const int* __restrict__ ids, int S,
                    const __grid_constant__ Net<T> net,
                    float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  const Tower<T>& tw = net.tower;
  const Smem s = carve(tw, smem);
  const int row = blockIdx.x / tw.n_tiles, tile = blockIdx.x % tw.n_tiles;
  const int* row_ids = ids + (size_t)row * S;
  const int E = tw.c_in, E4 = round4(E);

  // gather: positions outside [0, S) and PAD ids give zero rows
  auto gather = [&](float* buf, int span, int ldc, int base) {
    for (int i = threadIdx.x; i < span * E4; i += kThreads) {
      const int r = i / E4, e = i - r * E4;
      const int p = base + r;
      const int id = (p >= 0 && p < S) ? row_ids[p] : 0;
      buf[r * ldc + e] = e < E && id > 0 && id < net.vocab
                             ? ld(net.emb + (size_t)id * E + e)
                             : 0.f;
    }
  };
  auto every = [](int) { return true; };
  if (!tower_tile(tw, s, S, row, tile, gather, every)) return;

  // hidden FC stack, then every head as one matmul
  const float* hin = s.pooled;
  int f_in = tw.c_out[tw.n_conv - 1];
  float* h0 = s.tail;
  float* h1 = s.tail + net.f_max;
  for (int l = 0; l < net.n_fc; ++l) {
    float* hout = (l & 1) ? h1 : h0;
    dense(hin, f_in, net.fc_w[l], net.fc_b[l], net.fc_out[l], s.scratch, true,
          hout, nullptr);
    hin = hout;
    f_in = net.fc_out[l];
  }
  dense(hin, f_in, net.head_w, net.head_b, net.n_heads, s.scratch, false,
        nullptr, out + (size_t)row * net.n_heads);
}

Plan plan(int B, int S, int embed, int n_conv, const int* fs,
          const int* c_out, int n_fc, const int* fc_out, int* f_max) {
  *f_max = 1;
  if (n_fc < 0 || n_fc > kMaxFc) return Plan();
  for (int l = 0; l < n_fc; ++l) {
    if (fc_out[l] < 1) return Plan();
    if (fc_out[l] > *f_max) *f_max = fc_out[l];
  }
  return tile_plan(B, S, embed, n_conv, fs, c_out, 2L * *f_max);
}

// Returns 0, a cudaError_t, -1 (unsupported layer counts or sizes), -2
// (not even one position per tile fits in shared memory) or -3 (the
// workspace is smaller than the plan's).
template <typename T>
int launch(const int* ids, int B, int S, const void* emb, int vocab,
           int embed, int n_conv, const void* const* conv_w,
           const void* const* conv_b, const int* fs, const int* c_out,
           int n_fc, const void* const* fc_w, const void* const* fc_b,
           const int* fc_out, const void* head_w, const void* head_b,
           int n_heads, float* out, void* workspace, size_t workspace_bytes,
           void* stream) {
  int f_max;
  const Plan p = plan(B, S, embed, n_conv, fs, c_out, n_fc, fc_out, &f_max);
  if (p.tile < 0 || B < 0 || n_heads < 1 || vocab < 1) return -1;
  if (p.tile == 0) return -2;
  if (B == 0) return 0;
  if (workspace_bytes < p.workspace) return -3;
  Net<T> net = {};
  fill_tower(net.tower, p, embed, n_conv, conv_w, conv_b, fs, c_out, B,
             workspace);
  net.emb = static_cast<const T*>(emb);
  net.vocab = vocab;
  net.n_fc = n_fc;
  for (int l = 0; l < n_fc; ++l) {
    net.fc_w[l] = static_cast<const T*>(fc_w[l]);
    net.fc_b[l] = static_cast<const T*>(fc_b[l]);
    net.fc_out[l] = fc_out[l];
  }
  net.head_w = static_cast<const T*>(head_w);
  net.head_b = static_cast<const T*>(head_b);
  net.n_heads = n_heads;
  net.f_max = f_max;
  return launch_tiles(conv_forward_kernel<T>, p, B, workspace,
                      static_cast<cudaStream_t>(stream), ids, S, net, out);
}

}  // namespace

#define CONV_FORWARD_ARGS                                                  \
  const int *ids, int B, int S, const void *emb, int vocab, int embed,    \
      int n_conv, const void *const *conv_w, const void *const *conv_b,   \
      const int *fs, const int *c_out, int n_fc, const void *const *fc_w, \
      const void *const *fc_b, const int *fc_out, const void *head_w,     \
      const void *head_b, int n_heads, float *out, void *workspace,       \
      size_t workspace_bytes, void *stream

#define CONV_FORWARD_PASS                                                  \
  ids, B, S, emb, vocab, embed, n_conv, conv_w, conv_b, fs, c_out, n_fc,   \
      fc_w, fc_b, fc_out, head_w, head_b, n_heads, out, workspace,         \
      workspace_bytes, stream

extern "C" int conv_forward_f32(CONV_FORWARD_ARGS) {
  return launch<float>(CONV_FORWARD_PASS);
}

extern "C" int conv_forward_bf16(CONV_FORWARD_ARGS) {
  return launch<__nv_bfloat16>(CONV_FORWARD_PASS);
}

// The plan for these sizes (see conv_tile::tile_plan): info receives
// tile, n_tiles, blocks, shared memory bytes a block and workspace bytes.
// Returns 0, or launch()'s codes -1 (unsupported sizes) and -2 (not even
// one position fits).
extern "C" int conv_forward_plan(int B, int S, int embed, int n_conv,
                                 const int* fs, const int* c_out, int n_fc,
                                 const int* fc_out, long long* info) {
  int f_max;
  const Plan p = plan(B, S, embed, n_conv, fs, c_out, n_fc, fc_out, &f_max);
  if (p.tile < 1) return p.tile == 0 ? -2 : -1;
  info[0] = p.tile;
  info[1] = p.n_tiles;
  info[2] = (long long)B * p.n_tiles;
  info[3] = (long long)p.smem;
  info[4] = (long long)p.workspace;
  return 0;
}

extern "C" const char* conv_forward_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
