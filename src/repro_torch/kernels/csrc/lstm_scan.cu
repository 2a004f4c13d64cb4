// Masked LSTM recurrence of the cost model: input gates in, final hidden
// state (or the stacked heads' predictions) out, in one kernel launch.
//
// Replaces the TPU kernel src/repro/kernels/lstm_scan.py::lstm_scan_fused
// (body _lstm_kernel). Per batch row, for t = 0 .. S-1:
//   gates = x_t + h @ wh                    (4H columns, i, f, g, o order)
//   i = sigmoid(i), f = sigmoid(f + 1), g = tanh(g), o = sigmoid(o)
//   c' = f * c + i * g,  h' = o * tanh(c')
// and where step t is masked the step leaves (h, c) as they were. Returns
// the final h in float32, and, when it is given heads (H, n_heads) and
// their biases, the predictions h @ head_w + head_b of every head in the
// same launch. Two entries share one kernel template and differ only in
// how a step finds its gate row x_t:
//   lstm_scan_*      x_t = xw[b, t] (B, S, 4H), valid where mask[b, t] != 0
//   lstm_scan_ids_*  x_t = table[ids[b, t]] (V, 4H), valid where the id is
//                    in [1, V); PAD (0) and an id outside the table are
//                    masked, so the kernel never reads outside the table.
// The gates, wh and the heads are all float32 or all bfloat16 (widened
// with __bfloat162float); the carry and all gate math are float32, with
// precise expf/tanhf and IEEE division (never --use_fast_math).
//
// What bounds it on an H100 (SXM): at COSTMODEL_BASE (H=128), B=64, S=256
// the recurrence is B*S*2*H*4H ~= 2.15 GFLOP, ~32 us at the published
// 67 TFLOP/s of float32 outside the tensor cores, against a few MB of
// gates, ids, wh and h to move: bound by operations. The S steps of a row
// depend on each other, so a row also has a latency floor of S steps that
// the roofline does not show; at B=64 that floor is what the kernel
// meets, and the design shortens the dependent step.
//
// Design (the measured effect of each choice is in PERF.md, from
// python -m repro_torch.kernels.lstm_scan_variants):
//  * One 2-block thread-block cluster per row when H > 64 (plan()).
//    Block r owns hidden units [r*U, (r+1)*U), U = ceil(H/2), and all four
//    gate columns of each, so (c, h) are updated where the gates are
//    computed and only the new h crosses between the two SMs. A row has
//    two SMs, not one (B=1 runs on two), and B=64 fills 128 of 132 SMs.
//    For H <= 64 one block holds the whole row (a plan chosen by H: its
//    wh fits the registers of one block, and a __syncthreads is the step's
//    barrier).
//  * All of wh in registers, none read in the loop. 8 lanes per unit,
//    unit-major, 4 units a warp: lane j of unit u holds wh[k][g*H + u] for
//    the four gates g and the j-th slice of k, kSlice = 16 rows at H=128
//    (8 for H <= 64): 64 floats, widened from bf16 once (a bf16 wh costs
//    no conversion in the loop). 512 threads at H=128 with
//    __launch_bounds__(512, 1), so up to 128 registers a thread (the
//    build's ptxas report shows the count and any spills). A lane reads
//    only its kSlice values of h a step, once for four gates (with one
//    gate column and half of k a lane, each lane would read 64 values, 4x
//    as many, through the same 128 bytes a clock of shared memory).
//  * Each lane sums its slice in 4 independent chains, one per gate. A
//    reduce-scatter over the unit's 8 lanes (shuffles xor 4, 2, 1) leaves
//    lanes 2g and 2g+1 with gate g's whole sum, in one fixed order (the
//    last step adds a + b in one lane and b + a in the other: the same
//    bits). Then the gate input. No order depends on B, so each row is
//    bit-identical for every batch size and batch position.
//  * The four gates of a unit meet inside one warp through shuffles: no
//    __syncthreads between the gate pass and the cell update. Every lane
//    of a unit updates (c, h) with the same bits; one lane stores h'.
//  * h lives in shared memory, double-buffered by the parity of the valid
//    step, read as float4 broadcasts; each slice of 16 sits 4 floats after
//    the one before, so a warp's 8 slices fall in different banks. Each
//    block sends its units' h' into both blocks' buffer as st.async
//    stores through distributed shared memory (mapa addresses); the
//    receiving block's mbarrier for that buffer counts their bytes, and a
//    thread reads the buffer after waiting on the mbarrier's phase.
//  * One cluster barrier a valid step, split and relaxed: a thread arrives
//    after its stores and waits just before its next stores, which go to
//    the buffer the step before read. The mbarriers carry h's visibility;
//    the barrier keeps every thread of both blocks within one step of the
//    others, which the mbarriers alone do not: an idle lane (units rounded
//    up to whole warps, block 1's missing unit at odd H; at H=65 a whole
//    warp of block 1) stores nothing, so no mbarrier phase waits for it,
//    and one that fell two phases behind would take a later phase for the
//    one it waits on (a hang after the last step). For a live lane the
//    mbarriers would order the reuse too, but only through a data
//    dependency: its reads feed the unit's shuffles, which feed h', whose
//    store the peer's mbarrier counts. The barrier's order is one of
//    execution, with the same footing: the relaxed arrival releases
//    nothing, and a thread's reads come before it because the shuffles
//    that consume them do. The release form of the arrival compiles to a
//    GPU-wide MEMBAR.ALL.GPU, which adds half a step again.
//  * Nothing from device memory on the critical path: the row's valid
//    steps are compacted into shared memory up front (kChunk at a time,
//    as their gate-row indices: t for xw, the id for the table), and
//    each thread loads its gate input for the next valid step at the top
//    of the current one, so the load's latency hides behind a whole
//    step. wh is read from device memory once per block.
//  * The mask is per row, so a masked step is skipped by both blocks: it
//    does no barrier and (h, c) keep their bits; an all-PAD row ends at
//    exactly 0. (A select, never h' * m + h * (1 - m) with its rounding.)
//  * The heads run in block 0 on the final h, each a sum over k in one
//    fixed order. cuBLAS picks its algorithm by the batch's shape, and at
//    B=1 gives other bits than at larger B (measured on the H100), so
//    heads applied after the kernel would break the bit-identity.
//  * A cluster launch the card refuses returns its CUDA error, which the
//    wrapper raises: nothing falls back to another plan.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxHidden = 128;
constexpr int kOneBlockMax = 64;    // H up to this: one block a row
constexpr int kLanes = 8;           // lanes a unit: 4 gates x 2 halves of k
constexpr int kThreadsMax = 512;    // 8 lanes x 64 units
constexpr int kChunk = 1024;        // steps staged in shared memory at once
constexpr int kPad = 4;             // floats between the two halves of h

__device__ __forceinline__ float ld(const float* p) { return __ldg(p); }

__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

// Where hidden unit k sits in an h buffer: each slice of kSlice units
// starts kPad floats after the previous one ends.
template <int kSlice>
__device__ __forceinline__ int h_slot(int k) {
  return k + kPad * (k / kSlice);
}

// Steps of the xw entry: gates xw (B, S, 4H), valid where mask != 0.
template <typename T>
struct XwSteps {
  const T* xw;
  const float* mask;
  int S;
  __device__ const T* gates(size_t row, int G) const {
    return xw + row * (size_t)S * G;
  }
  // the gate row of step t, or -1 where the step is masked
  __device__ int index(size_t row, int t) const {
    return mask[row * S + t] != 0.f ? t : -1;
  }
};

// Steps of the ids entry: gates table[id] (V, 4H), valid for 0 < id < V.
template <typename T>
struct IdSteps {
  const T* table;
  const int* ids;
  int S;
  int V;
  __device__ const T* gates(size_t, int) const { return table; }
  __device__ int index(size_t row, int t) const {
    const int id = ids[row * S + t];
    return id > 0 && id < V ? id : -1;      // PAD, or outside the table
  }
};

// Compacts the valid steps of [t0, t0 + n) of this row into list_s (their
// gate-row indices, in step order) and returns how many there are: the
// same count in every thread of the block and, since the mask is per row,
// in both blocks of a cluster.
template <typename Steps>
__device__ int stage(const Steps& steps, size_t row, int t0, int n,
                     int* list_s, int* warp_s) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;
  int total = 0;
  __syncthreads();                 // every thread is done with the old list
  for (int p = 0; p < n; p += blockDim.x) {
    const int idx = p + tid < n ? steps.index(row, t0 + p + tid) : -1;
    const unsigned ballot = __ballot_sync(0xffffffffu, idx >= 0);
    if (lane == 0) warp_s[warp] = __popc(ballot);
    __syncthreads();
    int before = total, pass = 0;
    for (int w = 0; w < n_warps; ++w) {
      if (w == warp) before += pass;
      pass += warp_s[w];
    }
    if (idx >= 0)
      list_s[before + __popc(ballot & ((1u << lane) - 1u))] = idx;
    total += pass;
    __syncthreads();               // list written, warp_s free again
  }
  return total;
}

// Distributed shared memory (cluster plan). h moves between the two
// blocks as st.async stores, each counted (its bytes) by the receiving
// block's mbarrier for that buffer; a thread that waits on the mbarrier's
// phase sees every store of the step, its own block's included.
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// address a of this block's shared memory, in block `rank` of the cluster
__device__ __forceinline__ uint32_t cluster_addr(uint32_t a, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(r) : "r"(a), "r"(rank));
  return r;
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

// the one arrival of a phase, with the bytes the phase's stores bring
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" :: "r"(smem_addr(bar)), "r"(parity) : "memory");
}

// v into shared::cluster address a; its 4 bytes complete on mbarrier bar
// (a shared::cluster address in the same block as a)
__device__ __forceinline__ void st_async(uint32_t a, float v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 "
      "[%0], %1, [%2];" :: "r"(a), "f"(v), "r"(bar) : "memory");
}

// The step's cluster barrier, split: a thread arrives when it has stored
// its step's h' (and so has read the step's h: the shuffles between
// consumed the reads), and waits just before its next stores, which go
// into the buffer that step read. The arrival is relaxed: the release form
// puts a GPU-wide memory barrier (MEMBAR.ALL.GPU) on every step, and h's
// visibility comes from the mbarriers instead.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
}

// kCtas blocks per row (1 or 2); kSlice rows of wh per lane (a lane's
// slice of k); `units` hidden units per block.
template <typename T, int kCtas, int kSlice, typename Steps>
__global__ void __launch_bounds__(kThreadsMax, 1)
lstm_scan_kernel(Steps steps, const T* __restrict__ wh, int H, int units,
                 const T* __restrict__ head_w, const T* __restrict__ head_b,
                 int n_heads, float* __restrict__ out,
                 float* __restrict__ pred) {
  constexpr int kHLen = kLanes * (kSlice + kPad);  // one h buffer
  __shared__ __align__(16) float h_s[2 * kHLen];   // by parity of the step
  __shared__ __align__(8) uint64_t bar_s[2];       // one per h buffer
  __shared__ int list_s[kChunk];
  __shared__ int warp_s[kThreadsMax / 32];

  const int G = 4 * H;
  const int tid = threadIdx.x, lane = tid & 31;
  const int rank = kCtas > 1 ? (int)cg::this_cluster().block_rank() : 0;
  const size_t row = blockIdx.x / kCtas;
  const int local = tid / kLanes;                  // unit within the block
  const int slice = tid % kLanes;                  // this lane's rows of k
  const int gate = (slice >> 1) & 3;               // gate after the reduce
  const int u = rank * units + local;              // hidden unit
  const bool live = local < units && u < H;        // else a filler lane

  // wh[k][g*H + u] for the four gates g and k in this lane's slice
  float w[4][kSlice];
#pragma unroll
  for (int g = 0; g < 4; ++g) {
#pragma unroll
    for (int r = 0; r < kSlice; ++r) {
      const int k = slice * kSlice + r;
      w[g][r] = live && k < H ? ld(wh + (size_t)k * G + g * H + u) : 0.f;
    }
  }
  for (int i = tid; i < 2 * kHLen; i += blockDim.x) h_s[i] = 0.f;
  const T* x_col = steps.gates(row, G) + (live ? gate * H + u : 0);
  const int slot = h_slot<kSlice>(u);
  const bool hi4 = slice & 4, hi2 = slice & 2;
  const int src = lane & ~(kLanes - 1);            // the unit's lane 0
  // lane 0 of a unit stores its h' into this block, lane 2 into the peer
  const bool store = live && (slice == 0 || (kCtas > 1 && slice == 2));
  const int dest = slice == 0 ? rank : rank ^ 1;
  uint32_t h_at = 0, bar_at = 0;                   // in block `dest`
  if constexpr (kCtas > 1) {
    h_at = cluster_addr(smem_addr(h_s + slot), dest);
    bar_at = cluster_addr(smem_addr(bar_s), dest);
    // the zeros above come before the async stores into the same words
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    if (tid == 0) {
      mbar_init(&bar_s[0], 1);
      mbar_init(&bar_s[1], 1);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    // the peer has started, zeroed its h and set up its mbarriers before
    // any store into it
    cg::this_cluster().sync();
  }

  float c = 0.f;
  int n = 0;                                       // valid steps so far
  for (int t0 = 0; t0 < steps.S; t0 += kChunk) {
    const int count = stage(steps, row, t0, min(kChunk, steps.S - t0),
                            list_s, warp_s);
    float x_next = 0.f;                            // the next step's input
    if (live && count > 0) x_next = ld(x_col + (size_t)list_s[0] * G);
    for (int e = 0; e < count; ++e) {
      const float xv = x_next;
      if (live && e + 1 < count)
        x_next = ld(x_col + (size_t)list_s[e + 1] * G);
      // buffer n & 1 holds h after step n - 1: wait for all H of its
      // values, the peer's and this block's (phase (n - 1) / 2 of its
      // mbarrier)
      if (kCtas > 1 && n > 0) mbar_wait(&bar_s[n & 1], ((n - 1) >> 1) & 1);
      const float* hb = h_s + (n & 1) * kHLen + slice * (kSlice + kPad);
      float a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int r = 0; r < kSlice; r += 4) {
        const float4 hv = *reinterpret_cast<const float4*>(hb + r);
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          a[g] = fmaf(hv.x, w[g][r], a[g]);
          a[g] = fmaf(hv.y, w[g][r + 1], a[g]);
          a[g] = fmaf(hv.z, w[g][r + 2], a[g]);
          a[g] = fmaf(hv.w, w[g][r + 3], a[g]);
        }
      }
      // reduce-scatter over the unit's 8 lanes: lanes 4-7 keep gates
      // g, o and lanes 0-3 keep i, f (xor 4); then one gate each (xor 2);
      // then the pair's two sums (xor 1; a + b == b + a, same bits)
      const float r0 = __shfl_xor_sync(0xffffffffu, hi4 ? a[0] : a[2], 4);
      const float r1 = __shfl_xor_sync(0xffffffffu, hi4 ? a[1] : a[3], 4);
      const float b0 = (hi4 ? a[2] : a[0]) + r0;
      const float b1 = (hi4 ? a[3] : a[1]) + r1;
      const float r2 = __shfl_xor_sync(0xffffffffu, hi2 ? b0 : b1, 2);
      float s = (hi2 ? b1 : b0) + r2;
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      const float pre = s + xv;
      const float act =
          gate == 2 ? tanhf(pre) : sigmoid(gate == 1 ? pre + 1.f : pre);
      const float ig = __shfl_sync(0xffffffffu, act, src);
      const float fg = __shfl_sync(0xffffffffu, act, src + 2);
      const float gg = __shfl_sync(0xffffffffu, act, src + 4);
      const float og = __shfl_sync(0xffffffffu, act, src + 6);
      c = fg * c + ig * gg;
      const float hn = og * tanhf(c);
      const int q = (n + 1) & 1;                   // the buffer h' goes to
      if constexpr (kCtas > 1) {
        // buffer q was read in step n - 1: every thread of both blocks has
        // finished that step (the cluster barrier step n - 1 arrived on)
        if (n > 0) cluster_wait();
        // phase n / 2 of buffer q's mbarrier: its one arrival brings the
        // byte count; it comes after phase n / 2 - 1 completed (this
        // thread waited for it at the top of step n - 1)
        if (tid == 0) mbar_expect(&bar_s[q], 4u * H);
        if (store)
          st_async(h_at + 4u * q * kHLen, hn, bar_at + 8u * q);
        cluster_arrive();          // done with buffer n & 1 for this step
      } else {
        if (store) h_s[q * kHLen + slot] = hn;
        __syncthreads();
      }
      ++n;
    }
  }
  if constexpr (kCtas > 1) {
    // every store into this block has landed, and (the last step's
    // barrier) no block exits while a store of its peer's may still be on
    // its way
    if (n > 0) {
      mbar_wait(&bar_s[n & 1], ((n - 1) >> 1) & 1);
      cluster_wait();
    }
  }
  if (rank != 0) return;
  const float* hf = h_s + (n & 1) * kHLen;
  for (int k = tid; k < H; k += blockDim.x)
    out[row * H + k] = hf[h_slot<kSlice>(k)];
  if (head_w == nullptr) return;
  for (int o = tid; o < n_heads; o += blockDim.x) {
    float acc = ld(head_b + o);
    for (int k = 0; k < H; ++k)
      acc = fmaf(hf[h_slot<kSlice>(k)], ld(head_w + (size_t)k * n_heads + o),
                 acc);
    pred[row * n_heads + o] = acc;
  }
}

// The plan for hidden size H: blocks per row, rows of k per lane (kSlice),
// units per block and threads per block. False for a size the kernel does not
// take.
struct Plan {
  int ctas, rows, units, threads;
};

bool plan(int H, Plan* p) {
  if (H < 1 || H > kMaxHidden) return false;
  p->ctas = H <= kOneBlockMax ? 1 : 2;
  p->rows = (H <= kOneBlockMax ? kOneBlockMax : kMaxHidden) / kLanes;
  p->units = (H + p->ctas - 1) / p->ctas;
  p->threads = kLanes * ((p->units + 3) & ~3);     // whole warps
  return true;
}

template <typename T, int kCtas, int kSlice, typename Steps>
int run(const Steps& steps, const T* wh, int B, int H, const Plan& p,
        const T* head_w, const T* head_b, int n_heads, float* out,
        float* pred, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)B * kCtas);
  cfg.blockDim = dim3(p.threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCtas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = kCtas > 1 ? 1 : 0;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, lstm_scan_kernel<T, kCtas, kSlice, Steps>,
                         steps, wh, H, p.units, head_w, head_b, n_heads,
                         out, pred);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Returns 0, a cudaError_t, or -1 (sizes the kernel does not take). A
// null head_w means no heads (pred is not written).
template <typename T, typename Steps>
int launch(const Steps& steps, const void* wh, const void* head_w,
           const void* head_b, int n_heads, int B, int H, float* out,
           float* pred, void* stream) {
  Plan p;
  if (!plan(H, &p) || B < 0 || steps.S < 0 ||
      (head_w != nullptr && n_heads < 1))
    return -1;
  if (B == 0) return 0;
  const T* w = static_cast<const T*>(wh);
  const T* hw = static_cast<const T*>(head_w);
  const T* hb = static_cast<const T*>(head_b);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return p.ctas == 1
             ? run<T, 1, kOneBlockMax / kLanes>(steps, w, B, H, p, hw, hb,
                                                n_heads, out, pred, s)
             : run<T, 2, kMaxHidden / kLanes>(steps, w, B, H, p, hw, hb,
                                              n_heads, out, pred, s);
}

template <typename T>
int launch_xw(const void* xw, const float* mask, const void* wh,
              const void* head_w, const void* head_b, int n_heads, int B,
              int S, int H, float* out, float* pred, void* stream) {
  const XwSteps<T> steps{static_cast<const T*>(xw), mask, S};
  return launch<T>(steps, wh, head_w, head_b, n_heads, B, H, out, pred,
                   stream);
}

template <typename T>
int launch_ids(const void* table, const int* ids, int V, const void* wh,
               const void* head_w, const void* head_b, int n_heads, int B,
               int S, int H, float* out, float* pred, void* stream) {
  if (V < 1) return -1;
  const IdSteps<T> steps{static_cast<const T*>(table), ids, S, V};
  return launch<T>(steps, wh, head_w, head_b, n_heads, B, H, out, pred,
                   stream);
}

}  // namespace

#define LSTM_SCAN_ARGS                                                     \
  const void *xw, const float *mask, const void *wh, const void *head_w,  \
      const void *head_b, int n_heads, int B, int S, int H, float *out,   \
      float *pred, void *stream
#define LSTM_SCAN_PASS \
  xw, mask, wh, head_w, head_b, n_heads, B, S, H, out, pred, stream

#define LSTM_SCAN_IDS_ARGS                                                 \
  const void *table, const int *ids, int V, const void *wh,               \
      const void *head_w, const void *head_b, int n_heads, int B, int S,  \
      int H, float *out, float *pred, void *stream
#define LSTM_SCAN_IDS_PASS \
  table, ids, V, wh, head_w, head_b, n_heads, B, S, H, out, pred, stream

extern "C" int lstm_scan_f32(LSTM_SCAN_ARGS) {
  return launch_xw<float>(LSTM_SCAN_PASS);
}

extern "C" int lstm_scan_bf16(LSTM_SCAN_ARGS) {
  return launch_xw<__nv_bfloat16>(LSTM_SCAN_PASS);
}

extern "C" int lstm_scan_ids_f32(LSTM_SCAN_IDS_ARGS) {
  return launch_ids<float>(LSTM_SCAN_IDS_PASS);
}

extern "C" int lstm_scan_ids_bf16(LSTM_SCAN_IDS_ARGS) {
  return launch_ids<__nv_bfloat16>(LSTM_SCAN_IDS_PASS);
}

extern "C" int lstm_scan_max_hidden() { return kMaxHidden; }

// The plan for hidden size H into out[4] = {blocks per row, rows of k per
// lane, units per block, threads per block}; 0, or -1 for a size the
// kernel does not take.
extern "C" int lstm_scan_plan(int H, int* out) {
  Plan p;
  if (!plan(H, &p)) return -1;
  out[0] = p.ctas;
  out[1] = p.rows;
  out[2] = p.units;
  out[3] = p.threads;
  return 0;
}

extern "C" const char* lstm_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
