// The table gradient of the conv1d encoder's masked embedding lookup, in
// two kernel launches and no atomics.
//
// Replaces no TPU kernel. On the TPU the lookup's gradient is XLA's
// scatter-add; in the port, autograd's backward of table[ids] is
// index_put_ with accumulate, whose indexing_backward_kernel took 22.4 of
// the 24.8 ms of card time a step of B=512 training on one H100 (SXM,
// 700 W). This is the backward
// of kernels/embed_grad.py::MaskedGather, y[p] = table[ids[p]] * (ids[p]
// != 0): for each id v in [1, V) and channel e,
//   dtable[v][e] = sum of dy[p][e] over the positions p with ids[p] == v,
// summed in float32 (float64 for float64 rows) and stored in dy's dtype
// (float32, bfloat16 or float64). The caller hands in dtable zeroed, and
// the ids sorted stably with PAD included: keys[k] = ids[perm[k]]
// ascending, and within one id's segment of keys the positions ascend.
// Rows the kernel does not write (PAD's, ids that do not occur, ids
// outside [1, V)) stay zero.
//
// What bounds it on an H100 (SXM): bytes. At B=512 rows in a bucket of
// S=128, E=64, float32, it reads the real positions' rows (~28,000 of
// the 65,536 positions in a training batch: ~7 MB), 12 bytes of key and
// position a position and writes the 2 MB table gradient: ~10 MB, ~3 us
// at 3.35 TB/s. It does no arithmetic to speak of. What made autograd's
// kernel thousands of times slower is a serial chain: it walks each
// id's rows one after another, so PAD, which fills every padded position
// of a bucketed batch, and an op name that fills much of a batch become
// chains of thousands of dependent loads and adds on one SM.
//
// Design:
//  * chunk_sums: one block per kChunk consecutive sorted positions and
//    kSlab channels. All its threads load the chunk's rows into shared
//    memory at once (channels along the threads, so a row is one coalesced
//    read), then one thread per channel walks the chunk in order and sums
//    each run of equal keys. A run that lies inside the chunk is that
//    id's whole segment: its sum goes straight into dtable. A run cut by a
//    chunk edge goes into the chunk's partial slots, first[c] for the run
//    that comes in from chunk c - 1, last[c] for the run that starts in c
//    and goes on. PAD and ids outside [1, V) are never loaded: the walk
//    starts at the chunk's first key >= 1 and stops at its first key >= V,
//    and a chunk of PAD alone returns after reading its keys.
//  * segment_sums: the block of chunk c goes on only where c's last run
//    starts in c and goes on into c + 1, so each cut segment has exactly
//    one owner. It finds the segment's end by a binary search over the
//    keys, and sums last[c] and first[c + 1 .. c_end]: kGroups groups of
//    threads each take every kGroups-th chunk in order, and the groups'
//    sums are added to last[c] in group order.
// No dependent chain is longer than kChunk rows, or a cut segment's
// chunks over kGroups partials, and each (id, channel) is written by one
// thread, so every sum's order is fixed by the positions alone: the bits
// are the same on every run and on every stream. The grid is sized by the
// positions and the width, never by the ids, and nothing is read back, so
// the host never waits for the card.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kChunk = 64;     // sorted positions a chunk_sums block sums
                               // (CHUNK in kernels/embed_grad.py)
constexpr int kSlab = 64;      // channels a block covers
constexpr int kThreads = 256;  // a block's threads, kGroups x kSlab
constexpr int kGroups = kThreads / kSlab;

// the sums' type: float32, or float64 for float64 rows
template <typename T> struct Acc { using type = float; };
template <> struct Acc<double> { using type = double; };

__device__ __forceinline__ float ld(const float* p) { return __ldg(p); }
__device__ __forceinline__ double ld(const double* p) { return __ldg(p); }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(double* p, double v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__host__ __device__ inline int n_chunks(int N) {
  return (N + kChunk - 1) / kChunk;
}

// part holds two slots of E sums a chunk: first (0) and last (1)
template <typename F>
__device__ __forceinline__ F* slot(F* part, int c, int which, int E) {
  return part + ((size_t)c * 2 + which) * E;
}

template <typename T, typename A = typename Acc<T>::type>
__global__ void __launch_bounds__(kThreads)
chunk_sums(const T* __restrict__ grad, const int* __restrict__ keys,
           const long long* __restrict__ perm, int N, int E, int V,
           T* __restrict__ out, A* __restrict__ part) {
  __shared__ A rows[kChunk][kSlab];
  __shared__ int s_keys[kChunk + 2];   // keys[a - 1 .. b], -1 off the ends
  __shared__ long long s_perm[kChunk];
  const int c = blockIdx.x, e0 = blockIdx.y * kSlab;
  const int a = c * kChunk, n = min(kChunk, N - a), b = a + n;
  const int t = threadIdx.x;

  if (t < n + 2) {
    const int k = a - 1 + t;
    s_keys[t] = k >= 0 && k < N ? keys[k] : -1;
  }
  if (t < n) s_perm[t] = perm[a + t];
  __syncthreads();

  // keys ascend: [lo, hi) are the chunk's keys in [1, V)
  int lo = 0, hi = n;
  while (lo < hi && s_keys[1 + lo] < 1) ++lo;
  while (hi > lo && s_keys[hi] >= V) --hi;
  if (lo == hi) return;                // PAD or outside the table only

  for (int i = t; i < (hi - lo) * kSlab; i += kThreads) {
    const int r = lo + i / kSlab, e = e0 + i % kSlab;
    rows[r][i % kSlab] =
        e < E ? ld(grad + (size_t)s_perm[r] * E + e) : A(0);
  }
  __syncthreads();
  if (t >= kSlab) return;

  const int e = e0 + t;
  A acc = 0;
  int start = lo;                      // the current run's first row
  for (int r = lo; r < hi; ++r) {
    acc += rows[r][t];
    const int key = s_keys[1 + r], next = s_keys[2 + r];
    if (r + 1 < n && next == key) continue;
    // the run [start, r] of `key` ends in this chunk; it was cut on the
    // left if it starts the chunk and the key before is the same, on the
    // right if it ends the chunk and the key after is the same
    const bool left = start == 0 && s_keys[0] == key;
    const bool right = next == key;
    if (e < E) {
      if (left)
        slot(part, c, 0, E)[e] = acc;
      else if (right)
        slot(part, c, 1, E)[e] = acc;
      else
        st(out + (size_t)key * E + e, acc);
    }
    acc = 0;
    start = r + 1;
  }
}

template <typename T, typename A = typename Acc<T>::type>
__global__ void __launch_bounds__(kThreads)
segment_sums(const int* __restrict__ keys, int N, int E, int V,
             T* __restrict__ out, const A* __restrict__ part) {
  __shared__ A sums[kGroups][kSlab];
  const int c = blockIdx.x, e0 = blockIdx.y * kSlab;
  const int a = c * kChunk, b = a + kChunk;
  if (b >= N) return;                  // the last chunk cuts nothing
  const int key = keys[b - 1];
  if (key < 1 || key >= V || keys[b] != key) return;
  if (a > 0 && keys[a - 1] == key) return;   // owned by an earlier chunk

  // the segment ends before the first key above `key`
  int lo = b + 1, hi = N;
  while (lo < hi) {
    const int mid = lo + (hi - lo) / 2;
    if (keys[mid] <= key)
      lo = mid + 1;
    else
      hi = mid;
  }
  const int c_end = (lo - 1) / kChunk;

  const int g = threadIdx.x / kSlab, lane = threadIdx.x % kSlab;
  const int e = e0 + lane;
  A s = 0;
  if (e < E)
    for (int j = c + 1 + g; j <= c_end; j += kGroups)
      s += slot(part, j, 0, E)[e];
  sums[g][lane] = s;
  __syncthreads();
  if (g != 0 || e >= E) return;
  A total = slot(part, c, 1, E)[e];
  for (int h = 0; h < kGroups; ++h) total += sums[h][lane];
  st(out + (size_t)key * E + e, total);
}

// Returns 0, a cudaError_t, or -1 (the workspace holds fewer than
// n_chunks(N) x 2 x E sums).
template <typename T>
int launch(const void* grad, const int* keys, const long long* perm, int N,
           int E, int V, void* out, void* workspace, size_t workspace_bytes,
           void* stream) {
  using A = typename Acc<T>::type;
  if (N <= 0 || E <= 0) return 0;
  if (workspace_bytes < (size_t)n_chunks(N) * 2 * E * sizeof(A)) return -1;
  const dim3 grid(n_chunks(N), (E + kSlab - 1) / kSlab);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  A* part = static_cast<A*>(workspace);
  chunk_sums<T><<<grid, kThreads, 0, s>>>(static_cast<const T*>(grad), keys,
                                          perm, N, E, V,
                                          static_cast<T*>(out), part);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  segment_sums<T><<<grid, kThreads, 0, s>>>(keys, N, E, V,
                                            static_cast<T*>(out), part);
  return (int)cudaGetLastError();
}

}  // namespace

#define EMBED_GRAD_ARGS                                                    \
  const void *grad, const int *keys, const long long *perm, int N, int E, \
      int V, void *out, void *workspace, size_t workspace_bytes,          \
      void *stream
#define EMBED_GRAD_PASS \
  grad, keys, perm, N, E, V, out, workspace, workspace_bytes, stream

extern "C" int embed_grad_f32(EMBED_GRAD_ARGS) {
  return launch<float>(EMBED_GRAD_PASS);
}

extern "C" int embed_grad_bf16(EMBED_GRAD_ARGS) {
  return launch<__nv_bfloat16>(EMBED_GRAD_PASS);
}

extern "C" int embed_grad_f64(EMBED_GRAD_ARGS) {
  return launch<double>(EMBED_GRAD_PASS);
}

extern "C" const char* embed_grad_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
