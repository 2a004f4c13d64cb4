// The selective scan of a Mamba-1 mixer, forward and backward, in float32.
//
// Replaces no TPU kernel: the reference's mamba block runs its scan as
// XLA ops. In the port, models/mamba.py's chunked scan builds
// (B, c, di, N) tensors for every chunk and autograd keeps ~30 of them;
// at Jamba2-3B's widths (di 5,120, N 16) and S 4,096 that cannot train.
// This is kernels/selective_scan.py::SelectiveScan. For each row b,
// channel d and state n, from s = 0:
//   s[t][n] = exp(dt[t] A[n]) s[t-1][n] + dt[t] B[t][n] x[t]
//   y[t]    = sum_n C[t][n] s[t][n] + D x[t]
// x, dt, y are (rows, L, channels); B, C are (rows, L, N); A is
// (channels, N); D is (channels). Everything is float32, the state too.
//
// What bounds it on an H100 (SXM): at the cell's size (4 rows, L 4,096,
// 5,120 channels, N 16) the forward moves ~1.0 GB (x, dt, y and the saved
// states; B and C are small), ~0.3 ms at 3.35 TB/s, and takes 1.3e9
// exponentials, ~0.3 ms at the SFUs' 16 a clock an SM. The backward
// moves ~1.7 GB and takes twice the exponentials.
//
// Design:
//  * kPer = 4 states a thread, N / kPer threads (lanes) a channel, in
//    registers: a thread walks the sequence in order, so the recurrence
//    needs no scan across threads. y's sum over n is a shuffle over a
//    channel's lanes. A block is kThreads threads, one row's
//    kThreads / lanes consecutive channels; the grid is channel blocks x
//    rows (640 blocks at the cell's 4 rows, one wave of 4-5 a SM).
//  * Each chunk of kT steps is staged in shared memory (cp.async, two
//    buffers): the block's channels of x, dt (and dy), the row's B and C,
//    fetched while the chunk before is computed, so the sequential walk
//    waits on shared memory, not on HBM.
//  * The forward stores the state before every chunk of kT steps
//    (rows x chunks x channels x N), and nothing else besides y.
//  * The backward walks the chunks from the last: it takes the chunk's
//    first state, recomputes the chunk's kT states into registers (the
//    loops are unrolled, so the history is kT x kPer registers), then
//    walks the chunk backwards with the adjoint g[t] = dy[t] C[t] +
//    exp(dt[t+1] A) g[t+1], carried across chunks. dx, ddt are sums over
//    n (a shuffle over the channel's lanes); dA and dD sum over t in
//    registers; dB and dC sum over channels: a reduce-scatter over the
//    warp's channels (3 shuffles of 4, 2 and 1 values), the warps' sums
//    in shared memory, and one partial a block, step and value in a
//    workspace. A second kernel (sums) adds the blocks' partials, and the
//    rows' dA and dD, in block and row order.
// No float atomics: every sum has one order fixed by the shapes, so two
// runs give the same bits.
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kPer = 4;        // states a thread holds
constexpr int kT = 16;         // steps a chunk (CHUNK in selective_scan.py)
constexpr int kThreads = 128;  // a block's threads (THREADS there)
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ inline int n_chunks(int L) { return (L + kT - 1) / kT; }

template <int LANES>
__device__ __forceinline__ float lane_sum(float v) {
#pragma unroll
  for (int m = 1; m < LANES; m <<= 1) v += __shfl_xor_sync(kFull, v, m);
  return v;
}

// One float from global into shared memory without the registers
// (cp.async); zero where !ok (the source is then not read).
__device__ __forceinline__ void cp4(float* dst, const float* src, bool ok) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(a),
               "l"(src), "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait until at most one group (the chunk being fetched) is in flight
__device__ __forceinline__ void cp_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// A chunk's kT steps of one row, staged in shared memory: the block's CH
// channels of the (rows, L, channels) inputs and the row's N-wide B and C
// (zeros past L or the last channel); with DY also dy; with STATE the
// chunk's first state of the block's channels.
template <int CH, int N, bool DY>
struct __align__(16) Tile {
  float x[kT][CH], dt[kT][CH], dy[DY ? kT : 1][CH];
  float B[kT][N], C[kT][N];
  float s0[DY ? CH * N : 1];

  __device__ __forceinline__ void fetch(const float* x_, const float* dt_,
                                        const float* dy_, const float* B_,
                                        const float* C_, const float* st,
                                        size_t row, int c, int L, int D,
                                        int d0) {
    const int t0 = c * kT;
    for (int e = threadIdx.x; e < kT * CH; e += kThreads) {
      const int i = e / CH, j = e % CH;
      const bool ok = t0 + i < L && d0 + j < D;
      const size_t o = ok ? (row + t0 + i) * D + d0 + j : 0;
      cp4(&x[i][j], x_ + o, ok);
      cp4(&dt[i][j], dt_ + o, ok);
      if (DY) cp4(&dy[i][j], dy_ + o, ok);
    }
    for (int e = threadIdx.x; e < kT * N; e += kThreads) {
      const int i = e / N, n = e % N;
      const bool ok = t0 + i < L;
      const size_t o = ok ? (row + t0 + i) * N + n : 0;
      cp4(&B[i][n], B_ + o, ok);
      cp4(&C[i][n], C_ + o, ok);
    }
    if (DY) {
      const int nc = (D - d0 < CH ? D - d0 : CH) * N;
      for (int e = threadIdx.x; e < CH * N; e += kThreads)
        cp4(&s0[e], e < nc ? st + e : st, e < nc);
    }
    cp_commit();
  }
};

template <int LANES>
__global__ void __launch_bounds__(kThreads)
selective_scan_fwd_k(const float* __restrict__ x,
                     const float* __restrict__ dt,
                     const float* __restrict__ A,
                     const float* __restrict__ Bm,
                     const float* __restrict__ Cm,
                     const float* __restrict__ Dv, float* __restrict__ y,
                     float* __restrict__ states, int L, int D) {
  constexpr int N = LANES * kPer;
  constexpr int CH = kThreads / LANES;
  __shared__ __align__(16) Tile<CH, N, false> tile[2];
  const int b = blockIdx.y, ng = threadIdx.x % LANES;
  const int j = threadIdx.x / LANES, d0 = blockIdx.x * CH, d = d0 + j;
  const bool active = d < D;
  const int dd = active ? d : 0;       // reads stay in bounds
  float a_[kPer], s[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    a_[k] = A[(size_t)dd * N + ng * kPer + k];
    s[k] = 0.f;
  }
  const float Dd = Dv[dd];
  const int nC = n_chunks(L);
  const size_t row = (size_t)b * L;
  tile[0].fetch(x, dt, nullptr, Bm, Cm, nullptr, row, 0, L, D, d0);
  for (int c = 0; c < nC; ++c) {
    const Tile<CH, N, false>& tl = tile[c & 1];
    if (c + 1 < nC)
      tile[(c + 1) & 1].fetch(x, dt, nullptr, Bm, Cm, nullptr, row, c + 1,
                              L, D, d0);
    else
      cp_commit();                     // an empty group: the wait is uniform
    cp_wait_one();
    __syncthreads();
    if (active)
      *reinterpret_cast<float4*>(
          states + (((size_t)b * nC + c) * D + d) * N + ng * kPer) =
          make_float4(s[0], s[1], s[2], s[3]);
#pragma unroll
    for (int i = 0; i < kT; ++i) {
      const int t = c * kT + i;
      if (t >= L) break;               // the same t for the whole block
      const float xv = tl.x[i][j], dv = tl.dt[i][j];
      const float4 bq = *reinterpret_cast<const float4*>(&tl.B[i][ng * kPer]);
      const float4 cq = *reinterpret_cast<const float4*>(&tl.C[i][ng * kPer]);
      const float bv[kPer] = {bq.x, bq.y, bq.z, bq.w};
      const float cv[kPer] = {cq.x, cq.y, cq.z, cq.w};
      const float dx = dv * xv;
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        s[k] = expf(dv * a_[k]) * s[k] + dx * bv[k];
        acc += cv[k] * s[k];
      }
      acc = lane_sum<LANES>(acc);
      if (active && ng == 0) y[(row + t) * D + d] = acc + Dd * xv;
    }
    __syncthreads();                   // the tile is refilled two chunks on
  }
}

// v[0..7] (dB for k = 0..3, then dC) summed over the warp's channels: the
// lane keeps value j = 4 (lane bit 4) + 2 (bit 3) + (bit 2) of its n group
// (lane bits below log2(LANES)); with fewer than 4 lanes a channel, the
// channel bits under bit 2 are summed by a butterfly after.
template <int LANES>
__device__ __forceinline__ float channel_sum(float (&v)[8], int lane) {
  const bool u4 = lane & 16, u3 = lane & 8, u2 = lane & 4;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float send = u4 ? v[k] : v[k + 4];
    v[k] = (u4 ? v[k + 4] : v[k]) + __shfl_xor_sync(kFull, send, 16);
  }
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const float send = u3 ? v[k] : v[k + 2];
    v[k] = (u3 ? v[k + 2] : v[k]) + __shfl_xor_sync(kFull, send, 8);
  }
  const float send = u2 ? v[0] : v[1];
  float r = (u2 ? v[1] : v[0]) + __shfl_xor_sync(kFull, send, 4);
#pragma unroll
  for (int m = LANES; m < 4; m <<= 1) r += __shfl_xor_sync(kFull, r, m);
  return r;
}

template <int LANES>
__global__ void __launch_bounds__(kThreads, 4)
selective_scan_bwd_k(const float* __restrict__ x,
                     const float* __restrict__ dt,
                     const float* __restrict__ A,
                     const float* __restrict__ Bm,
                     const float* __restrict__ Cm,
                     const float* __restrict__ Dv,
                     const float* __restrict__ states,
                     const float* __restrict__ dy, float* __restrict__ dx,
                     float* __restrict__ ddt, float* __restrict__ part,
                     float* __restrict__ dA_part,
                     float* __restrict__ dD_part, int L, int D) {
  constexpr int N = LANES * kPer;
  constexpr int CH = kThreads / LANES;
  constexpr int WARPS = kThreads / 32;
  __shared__ __align__(16) Tile<CH, N, true> tile[2];
  __shared__ float red[kT][WARPS][2 * N];
  const int b = blockIdx.y, ng = threadIdx.x % LANES;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int j = threadIdx.x / LANES, d0 = blockIdx.x * CH, d = d0 + j;
  const bool active = d < D;
  const int dd = active ? d : 0;
  const int NB = gridDim.x, blk = blockIdx.x;
  // this lane's slot of the warp's 2N channel sums (writer lanes only)
  const int jr = ((lane >> 4) & 1) * 4 + ((lane >> 3) & 1) * 2 +
                 ((lane >> 2) & 1);
  const int slot = (jr >> 2) * N + ng * kPer + (jr & 3);
  const bool writer = (lane % 4) < LANES;

  float a_[kPer], g[kPer], an[kPer], dA_acc[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    a_[k] = A[(size_t)dd * N + ng * kPer + k];
    g[k] = an[k] = dA_acc[k] = 0.f;
  }
  const float Dd = Dv[dd];
  float dD_acc = 0.f;
  const int nC = n_chunks(L);
  const size_t row = (size_t)b * L;
  auto fetch = [&](int c) {
    tile[c & 1].fetch(x, dt, dy, Bm, Cm,
                      states + (((size_t)b * nC + c) * D + d0) * N, row, c,
                      L, D, d0);
  };
  fetch(nC - 1);
  for (int c = nC - 1; c >= 0; --c) {
    const Tile<CH, N, true>& tl = tile[c & 1];
    if (c > 0)
      fetch(c - 1);
    else
      cp_commit();                     // an empty group: the wait is uniform
    cp_wait_one();
    __syncthreads();
    float s0[kPer], hist[kT][kPer];
    {
      const float4 q =
          *reinterpret_cast<const float4*>(&tl.s0[j * N + ng * kPer]);
      s0[0] = q.x; s0[1] = q.y; s0[2] = q.z; s0[3] = q.w;
    }
    // the chunk's states, recomputed
#pragma unroll
    for (int i = 0; i < kT; ++i) {
      const float xv = tl.x[i][j], dv = tl.dt[i][j];
      const float4 bq = *reinterpret_cast<const float4*>(&tl.B[i][ng * kPer]);
      const float bv[kPer] = {bq.x, bq.y, bq.z, bq.w};
#pragma unroll
      for (int k = 0; k < kPer; ++k)
        hist[i][k] = expf(dv * a_[k]) * (i == 0 ? s0[k] : hist[i - 1][k]) +
                     dv * xv * bv[k];
    }
    // backwards through the chunk (steps past L have x, dt, dy zero)
#pragma unroll
    for (int i = kT - 1; i >= 0; --i) {
      const int t = c * kT + i;
      if (t < L) {                     // the same t for the whole block
        const float xv = tl.x[i][j], dv = tl.dt[i][j], dyv = tl.dy[i][j];
        const float4 bq =
            *reinterpret_cast<const float4*>(&tl.B[i][ng * kPer]);
        const float4 cq =
            *reinterpret_cast<const float4*>(&tl.C[i][ng * kPer]);
        const float bv[kPer] = {bq.x, bq.y, bq.z, bq.w};
        const float cv[kPer] = {cq.x, cq.y, cq.z, cq.w};
        float px = 0.f, pdt = 0.f, v[8];
#pragma unroll
        for (int k = 0; k < kPer; ++k) {
          const float a = expf(dv * a_[k]);
          // a_t s_{t-1}: the state carried into step t
          const float carried = a * (i == 0 ? s0[k] : hist[i - 1][k]);
          g[k] = dyv * cv[k] + an[k] * g[k];
          an[k] = a;
          px += g[k] * bv[k];
          pdt += g[k] * (bv[k] * xv + a_[k] * carried);
          dA_acc[k] += g[k] * dv * carried;
          v[k] = g[k] * dv * xv;
          v[4 + k] = dyv * hist[i][k];
        }
        dD_acc += dyv * xv;
        px = lane_sum<LANES>(px);
        pdt = lane_sum<LANES>(pdt);
        if (active && ng == 0) {
          const size_t o = (row + t) * D + d;
          dx[o] = dv * px + Dd * dyv;
          ddt[o] = pdt;
        }
        const float r = channel_sum<LANES>(v, lane);
        if (writer) red[i][warp][slot] = r;
      }
    }
    __syncthreads();
    for (int q = threadIdx.x; q < kT * 2 * N; q += kThreads) {
      const int i = q / (2 * N), jj = q % (2 * N), t = c * kT + i;
      if (t >= L) continue;
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) sum += red[i][w][jj];
      part[((row + t) * NB + blk) * (2 * N) + jj] = sum;
    }
    __syncthreads();                   // red and the tile are free again
  }
  if (active) {
#pragma unroll
    for (int k = 0; k < kPer; ++k)
      dA_part[((size_t)b * D + d) * N + ng * kPer + k] = dA_acc[k];
    if (ng == 0) dD_part[(size_t)b * D + d] = dD_acc;
  }
}

// dB and dC: each (row, step, value)'s partials summed over the channel
// blocks in order; dA and dD: the rows' sums in row order.
__global__ void __launch_bounds__(kThreads)
selective_scan_sums_k(const float* __restrict__ part,
                      const float* __restrict__ dA_part,
                      const float* __restrict__ dD_part, int rows, int L,
                      int D, int N, int NB, float* __restrict__ dB,
                      float* __restrict__ dC, float* __restrict__ dA,
                      float* __restrict__ dD) {
  const size_t n_bc = (size_t)rows * L * 2 * N, n_a = (size_t)D * N;
  const size_t total = n_bc + n_a + D;
  for (size_t q = (size_t)blockIdx.x * blockDim.x + threadIdx.x; q < total;
       q += (size_t)gridDim.x * blockDim.x) {
    if (q < n_bc) {
      const size_t bt = q / (2 * N);
      const int jj = (int)(q % (2 * N));
      float sum = 0.f;
      for (int k = 0; k < NB; ++k) sum += part[(bt * NB + k) * (2 * N) + jj];
      if (jj < N)
        dB[bt * N + jj] = sum;
      else
        dC[bt * N + jj - N] = sum;
    } else if (q < n_bc + n_a) {
      const size_t e = q - n_bc;
      float sum = 0.f;
      for (int r = 0; r < rows; ++r) sum += dA_part[(size_t)r * n_a + e];
      dA[e] = sum;
    } else {
      const size_t e = q - n_bc - n_a;
      float sum = 0.f;
      for (int r = 0; r < rows; ++r) sum += dD_part[(size_t)r * D + e];
      dD[e] = sum;
    }
  }
}

// the channel blocks of a row: kThreads / (N / kPer) channels each
inline int n_blocks(int D, int N) {
  return (D + kThreads * kPer / N - 1) / (kThreads * kPer / N);
}

inline bool sizes_ok(int rows, int L, int D, int N) {
  return rows > 0 && rows <= 65535 && L > 0 && D > 0 && (N == 8 || N == 16);
}

}  // namespace

// Returns 0, a cudaError_t, or -1 (N not 8 or 16, or an empty or
// too large shape).
extern "C" int selective_scan_fwd(const float* x, const float* dt,
                                  const float* A, const float* Bm,
                                  const float* Cm, const float* Dv, float* y,
                                  float* states, int rows, int L, int D,
                                  int N, void* stream) {
  if (!sizes_ok(rows, L, D, N)) return -1;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(n_blocks(D, N), rows);
  if (N == 16)
    selective_scan_fwd_k<4><<<grid, kThreads, 0, s>>>(
        x, dt, A, Bm, Cm, Dv, y, states, L, D);
  else
    selective_scan_fwd_k<2><<<grid, kThreads, 0, s>>>(
        x, dt, A, Bm, Cm, Dv, y, states, L, D);
  return (int)cudaGetLastError();
}

// The workspace holds rows x L x n_blocks x 2N partials of dB and dC,
// then rows x D x N of dA and rows x D of dD. Returns 0, a cudaError_t,
// -1 as the forward, or -2 (the workspace is smaller).
extern "C" int selective_scan_bwd(const float* x, const float* dt,
                                  const float* A, const float* Bm,
                                  const float* Cm, const float* Dv,
                                  const float* states, const float* dy,
                                  float* dx, float* ddt, float* dA, float* dB,
                                  float* dC, float* dD, float* work,
                                  size_t work_bytes, int rows, int L, int D,
                                  int N, void* stream) {
  if (!sizes_ok(rows, L, D, N)) return -1;
  const int NB = n_blocks(D, N);
  const size_t n_part = (size_t)rows * L * NB * 2 * N;
  const size_t n_work = n_part + (size_t)rows * D * N + (size_t)rows * D;
  if (work_bytes < n_work * sizeof(float)) return -2;
  float* part = work;
  float* dA_part = work + n_part;
  float* dD_part = dA_part + (size_t)rows * D * N;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(NB, rows);
  if (N == 16)
    selective_scan_bwd_k<4><<<grid, kThreads, 0, s>>>(
        x, dt, A, Bm, Cm, Dv, states, dy, dx, ddt, part, dA_part, dD_part,
        L, D);
  else
    selective_scan_bwd_k<2><<<grid, kThreads, 0, s>>>(
        x, dt, A, Bm, Cm, Dv, states, dy, dx, ddt, part, dA_part, dD_part,
        L, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t total = (size_t)rows * L * 2 * N + (size_t)D * N + D;
  const size_t want = (total + kThreads - 1) / kThreads;
  const int blocks = (int)(want < 4096 ? want : 4096);
  selective_scan_sums_k<<<blocks, kThreads, 0, s>>>(
      part, dA_part, dD_part, rows, L, D, N, NB, dB, dC, dA, dD);
  return (int)cudaGetLastError();
}

extern "C" const char* selective_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
