// Masked LSTM recurrence of the cost model: precomputed input gates in,
// final hidden state out, in one kernel launch.
//
// Replaces the TPU kernel src/repro/kernels/lstm_scan.py::lstm_scan_fused
// (body _lstm_kernel). Per batch row, for t = 0 .. S-1:
//   gates = xw[t] + h @ wh                  (4H columns, i, f, g, o order)
//   i = sigmoid(i), f = sigmoid(f + 1), g = tanh(g), o = sigmoid(o)
//   c' = f * c + i * g,  h' = o * tanh(c')
// and where mask[t] == 0 the step leaves (h, c) as they were. Returns the
// final h in float32, and, when it is given heads (H, n_heads) and their
// biases, the predictions h @ head_w + head_b of every head in the same
// launch. xw, wh and the heads are all float32 or all bfloat16 (widened
// with __bfloat162float); the carry and all gate math are float32, with
// precise expf/tanhf and IEEE division (never --use_fast_math).
//
// What bounds it on an H100 (SXM): at COSTMODEL_BASE (H=128), B=64, S=256
// the recurrence is B*S*2*H*4H ~= 2.15 GFLOP, ~32 us at the published
// 67 TFLOP/s of float32 outside the tensor cores, against ~34 MB of xw,
// mask, wh and h to move, ~10 us at 3.35 TB/s: bound by operations. The S
// steps depend on each other, so a row also has a latency floor of S
// steps that this roofline does not show.
//
// Design (simple and right first; making it fast -- wh split across a
// 2-block cluster with h swapped through DSMEM, bf16 wgmma, several rows
// a block -- is later work):
//  * One thread block per batch row, one thread per gate column (4H
//    threads). A row's arithmetic never depends on B or on another row,
//    so its output is bit-identical for every batch size.
//  * wh stays on chip for the whole sequence. A float32 wh at H=128 is
//    256 KB, more than the 227 KB a block may have in shared memory, so
//    each thread keeps the first kRegRows rows of its own column in
//    registers and the remaining rows live in shared memory (128 KB at
//    H=128). When all of wh fits in shared memory (H <= 119), it all goes
//    there. plan() decides; hidden sizes above kMaxHidden are refused.
//  * h lives in shared memory (read as a broadcast), c in a register of
//    the thread that owns its column. Each step: every thread sums its
//    column over k in one fixed order (k = 0 .. H-1), adds xw, applies
//    its gate's nonlinearity and stores it; __syncthreads; H threads
//    update (c, h); __syncthreads.
//  * The mask is per row, so a masked step is skipped by the whole block
//    at once: (h, c) are left bit for bit, and an all-PAD row ends at
//    exactly 0. (A select, never h' * m + h * (1 - m) with its rounding.)
//  * The heads run in the block on its final h, each a sum over k in one
//    fixed order. cuBLAS picks its algorithm by the batch's shape, and at
//    B=1 gives other bits than at larger B (measured on the H100), so
//    heads applied after the kernel would break the bit-identity.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxHidden = 128;     // 4H threads per block, at most 512
constexpr int kThreadsMax = 4 * kMaxHidden;
constexpr int kRegRows = 64;        // rows of wh kept in registers when
                                    // wh does not fit in shared memory
constexpr int kSmemLimit = 232448;  // 227 KB a block may opt in to

__device__ __forceinline__ float ld(const float* p) { return __ldg(p); }

__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

// kReg rows [0, kReg) of wh sit in registers (thread j holds column j),
// rows [kReg, H) in shared memory. kReg is 0 or kRegRows.
template <typename T, int kReg>
__global__ void __launch_bounds__(kThreadsMax, 1)
lstm_scan_kernel(const T* __restrict__ xw, const float* __restrict__ mask,
                 const T* __restrict__ wh, int S, int H,
                 const T* __restrict__ head_w, const T* __restrict__ head_b,
                 int n_heads, float* __restrict__ out,
                 float* __restrict__ pred) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int G = 4 * H;
  float* h_s = smem;                              // (H,), 16-byte aligned
  float* a_s = h_s + ((H + 3) & ~3);              // (G,) activated gates
  float* w_s = a_s + G;                           // (H - kReg) x G
  const int j = threadIdx.x;                      // this thread's column
  const int gate = j / H;                         // 0 i, 1 f, 2 g, 3 o

  float wr[kReg > 0 ? kReg : 1];
#pragma unroll
  for (int k = 0; k < kReg; ++k) wr[k] = ld(wh + (size_t)k * G + j);
  for (int i = j; i < (H - kReg) * G; i += blockDim.x)
    w_s[i] = ld(wh + (size_t)kReg * G + i);
  if (j < H) h_s[j] = 0.f;
  float c = 0.f;
  __syncthreads();

  const size_t row = blockIdx.x;
  const T* x_row = xw + row * S * G + j;
  const float* m_row = mask + row * S;
  for (int t = 0; t < S; ++t) {
    if (m_row[t] == 0.f) continue;                // uniform in the block
    const float xv = ld(x_row + (size_t)t * G);
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < kReg; k += 4) {
      const float4 hv = *reinterpret_cast<const float4*>(h_s + k);
      acc = fmaf(hv.x, wr[k], acc);
      acc = fmaf(hv.y, wr[k + 1], acc);
      acc = fmaf(hv.z, wr[k + 2], acc);
      acc = fmaf(hv.w, wr[k + 3], acc);
    }
    const float* w = w_s + j;
    int k = kReg;
    for (; k + 4 <= H; k += 4) {
      const float4 hv = *reinterpret_cast<const float4*>(h_s + k);
      const float* wk = w + (size_t)(k - kReg) * G;
      acc = fmaf(hv.x, wk[0], acc);
      acc = fmaf(hv.y, wk[G], acc);
      acc = fmaf(hv.z, wk[2 * G], acc);
      acc = fmaf(hv.w, wk[3 * G], acc);
    }
    for (; k < H; ++k) acc = fmaf(h_s[k], w[(size_t)(k - kReg) * G], acc);
    const float pre = xv + acc;
    a_s[j] = gate == 2 ? tanhf(pre) : sigmoid(gate == 1 ? pre + 1.f : pre);
    __syncthreads();
    if (j < H) {
      c = a_s[H + j] * c + a_s[j] * a_s[2 * H + j];
      h_s[j] = a_s[3 * H + j] * tanhf(c);
    }
    __syncthreads();
  }
  if (j < H) out[row * H + j] = h_s[j];
  if (head_w == nullptr) return;
  for (int o = j; o < n_heads; o += blockDim.x) {
    float acc = ld(head_b + o);
    for (int k = 0; k < H; ++k)
      acc = fmaf(h_s[k], ld(head_w + (size_t)k * n_heads + o), acc);
    pred[row * n_heads + o] = acc;
  }
}

// Shared-memory layout for hidden size H with kReg rows of wh in
// registers: h (padded to 4 floats), the 4H activated gates, and the
// other H - kReg rows of wh.
size_t smem_bytes(int H, int kReg) {
  return (size_t)(((H + 3) & ~3) + 4 * H + (size_t)(H - kReg) * 4 * H) *
         sizeof(float);
}

// The plan: kReg (0 or kRegRows), or -1 for a hidden size the kernel
// does not take.
int plan(int H) {
  if (H < 1 || H > kMaxHidden) return -1;
  if (smem_bytes(H, 0) <= (size_t)kSmemLimit) return 0;
  return kRegRows;  // 120 <= H <= 128: the other rows fit
}

template <typename T, int kReg>
int run(const T* xw, const float* mask, const T* wh, int B, int S, int H,
        const T* head_w, const T* head_b, int n_heads, float* out,
        float* pred, cudaStream_t stream) {
  const size_t smem = smem_bytes(H, kReg);
  // the opt-in is per device, so it is set on every launch (it is cheap)
  const cudaError_t attr = cudaFuncSetAttribute(
      lstm_scan_kernel<T, kReg>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  lstm_scan_kernel<T, kReg><<<B, 4 * H, smem, stream>>>(
      xw, mask, wh, S, H, head_w, head_b, n_heads, out, pred);
  return (int)cudaGetLastError();
}

// Returns 0, a cudaError_t, or -1 (sizes the kernel does not take). A
// null head_w means no heads (pred is not written).
template <typename T>
int launch(const void* xw, const float* mask, const void* wh,
           const void* head_w, const void* head_b, int n_heads, int B, int S,
           int H, float* out, float* pred, void* stream) {
  const int kReg = plan(H);
  if (kReg < 0 || B < 0 || S < 0 || (head_w != nullptr && n_heads < 1))
    return -1;
  if (B == 0) return 0;
  const T* x = static_cast<const T*>(xw);
  const T* w = static_cast<const T*>(wh);
  const T* hw = static_cast<const T*>(head_w);
  const T* hb = static_cast<const T*>(head_b);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return kReg == 0
             ? run<T, 0>(x, mask, w, B, S, H, hw, hb, n_heads, out, pred, s)
             : run<T, kRegRows>(x, mask, w, B, S, H, hw, hb, n_heads, out,
                                pred, s);
}

}  // namespace

#define LSTM_SCAN_ARGS                                                     \
  const void *xw, const float *mask, const void *wh, const void *head_w,  \
      const void *head_b, int n_heads, int B, int S, int H, float *out,   \
      float *pred, void *stream

#define LSTM_SCAN_PASS \
  xw, mask, wh, head_w, head_b, n_heads, B, S, H, out, pred, stream

extern "C" int lstm_scan_f32(LSTM_SCAN_ARGS) {
  return launch<float>(LSTM_SCAN_PASS);
}

extern "C" int lstm_scan_bf16(LSTM_SCAN_ARGS) {
  return launch<__nv_bfloat16>(LSTM_SCAN_PASS);
}

extern "C" int lstm_scan_max_hidden() { return kMaxHidden; }

extern "C" const char* lstm_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
