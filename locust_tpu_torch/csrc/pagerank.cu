// PageRank's ordered gather-add: one sum per node of its in-edges'
// contributions, added in edge order onto a shared initial value.
//
// No TPU kernel corresponds to this one.  The JAX package's PageRank step
// is a scatter-add whose CPU compile adds each node's contributions in
// edge order; torch's index_add_ does the same on the CPU but in no fixed
// order on CUDA, so the card's ranks drifted in their last bits.  This
// kernel restores the CPU's order on the card:
//
//   total[v] = init;  for each in-edge e of v, in edge order:
//       total[v] = total[v] + (ranks[src[e]] * inv_deg[src[e]])
//
// with the product rounded to float32 before the add.  __fmul_rn and
// __fadd_rn keep nvcc from contracting the two into an FMA, which would
// round once and change the bits.  No atomics: every total[v] is written
// once, by the one thread or warp that adds its row.
//
// Bounds on this card.  The bytes: the CSR offsets and sources, the ranks
// and inverse degrees read once, the totals written once
// (utils/roofline.pagerank_gather_min_bytes).  And a chain: a row's adds
// are one dependent chain whatever the layout (partial sums merged
// afterwards round differently from the left fold), so the longest row
// takes its in-degree times the latency of a dependent float add
// (utils/roofline.pagerank_chain_min_ms).  On skewed graphs, with rows of
// thousands of edges, the chain is the larger bound.
//
// Layout (ops/kernels/pagerank.in_edges): the rows in the node schedule's
// order, the node ids by in-degree, largest first (``schedule``); row i is
// node schedule[i]'s in-edges, ``src_by_dst[offsets[i] .. offsets[i+1]]``,
// in edge order (a stable sort); its first ``warp_rows`` rows are long.
// Indices are int32 where the graph fits (one template, instantiated for
// int32 and int64, each weighted and unweighted).
//
// Sources and rows may be two index spaces: ``ranks`` and ``inv_deg`` are
// indexed by source (``num_src`` of them), ``total`` by row node
// (``num_nodes``).  One device's PageRank has one space; the sharded
// PageRank's two sums have two (a rank's local nodes into its send slots,
// then the received slots into its local nodes).  A null ``inv_deg`` makes
// the sum unweighted, each contribution ranks[src[e]] itself: the
// sharded receive sum, whose received slots are already products.
//
// One cooperative launch of persistent blocks, two phases:
//   1. every source's contribution ranks[v] * inv_deg[v] into ``contrib``
//      (unweighted: none, the thread rows gather ``ranks`` itself),
//      and every edge of the warp rows' its own product into ``prod``
//      (the warp rows' edges are the first offsets[warp_rows] of the
//      layout, so the grid shares the long rows' gathers evenly); then a
//      grid-wide barrier.
//   2. the schedule, heaviest first, over two pools of warps, so the warp
//      with the longest chain owns no share of the short rows.  Warp rows
//      round robin over the first pool, sized to give each of its warps
//      about the longest row's work (and no more warps than the warp
//      rows' share of the edges): a warp streams its row's products,
//      contiguous, two groups of 256 ahead, stages each group in shared
//      memory and one lane adds it in order from 16-byte reads issued a
//      batch ahead, so the chain waits on the adds alone.  Thread rows
//      over the other pool's threads: neighbouring threads take
//      neighbouring rows of nearly equal length, whose offsets and sources
//      lie side by side; each walks its row in order, 8 edges a step, the
//      next step's sources loading while this step's contributions are
//      gathered, one gather of ``contrib`` an edge.  A row with no edges
//      writes init.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>
#include <mutex>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;  // 8 warps a block
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 8;      // products a lane holds for one group of a warp row
constexpr int kSpan = 32 * kGroup;
constexpr int kUnroll = 8;     // edges a thread row holds in flight
// A warp row's start (its offsets, then its first products, two dependent
// loads) counted in edges of its chain: what sizes the pool of warps
// that take the warp rows.
constexpr long long kRowStart = 512;

// Group g of a warp row: lane ``lane`` holds its edges 32 k + lane.
__device__ __forceinline__ void load_group(float (&c)[kGroup], const float* p, long long left,
                                           int lane) {
#pragma unroll
  for (int k = 0; k < kGroup; ++k) c[k] = 32 * k + lane < left ? p[32 * k + lane] : 0.0f;
}

__device__ __forceinline__ float add4(float acc, const float4 (&x)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    acc = __fadd_rn(acc, x[j].x);
    acc = __fadd_rn(acc, x[j].y);
    acc = __fadd_rn(acc, x[j].z);
    acc = __fadd_rn(acc, x[j].w);
  }
  return acc;
}

// Adds one group of a warp row in edge order: the lanes stage it in the
// warp's shared buffer and lane 0 adds it from 16-byte reads, each batch
// of 16 read while the one before it adds, so the chain waits on the
// adds alone.
__device__ __forceinline__ float add_group(float acc, const float (&c)[kGroup], long long left,
                                           float* buf, int lane) {
  __syncwarp();
#pragma unroll
  for (int k = 0; k < kGroup; ++k) buf[32 * k + lane] = c[k];
  __syncwarp();
  if (lane == 0) {
    const float4* b4 = reinterpret_cast<const float4*>(buf);
    if (left >= kSpan) {
      float4 x[4], y[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) x[j] = b4[j];
#pragma unroll
      for (int q = 0; q < kSpan / 4; q += 8) {
#pragma unroll
        for (int j = 0; j < 4; ++j) y[j] = b4[q + 4 + j];
        acc = add4(acc, x);
        if (q + 8 < kSpan / 4) {
#pragma unroll
          for (int j = 0; j < 4; ++j) x[j] = b4[q + 8 + j];
        }
        acc = add4(acc, y);
      }
    } else {
      const int n = (int)left;
      int q = 0;
#pragma unroll 8
      for (; q < n / 4; ++q) {
        const float4 x = b4[q];
        acc = __fadd_rn(acc, x.x);
        acc = __fadd_rn(acc, x.y);
        acc = __fadd_rn(acc, x.z);
        acc = __fadd_rn(acc, x.w);
      }
      for (int j = 4 * q; j < n; ++j) acc = __fadd_rn(acc, buf[j]);
    }
  }
  return acc;
}

template <typename I>
__device__ void warp_row(long long i, float acc, const I* __restrict__ offsets,
                         const I* __restrict__ schedule, const float* prod,
                         float* __restrict__ total, float* buf) {
  const int lane = threadIdx.x % 32;
  const long long begin = __ldg(offsets + i);
  const long long len = __ldg(offsets + i + 1) - begin;
  const float* p = prod + begin;
  float c[kGroup], next[kGroup], after[kGroup];
  load_group(c, p, len, lane);
  load_group(next, p + kSpan, len - kSpan, lane);
  for (long long done = 0; done < len; done += kSpan) {
    load_group(after, p + done + 2 * kSpan, len - done - 2 * kSpan, lane);
    acc = add_group(acc, c, len - done, buf, lane);
#pragma unroll
    for (int k = 0; k < kGroup; ++k) {
      c[k] = next[k];
      next[k] = after[k];
    }
  }
  if (lane == 0) total[__ldg(schedule + i)] = acc;
}

template <typename I>
__device__ __forceinline__ void load_sources(I (&s)[kUnroll], const I* row, long long left) {
#pragma unroll
  for (int k = 0; k < kUnroll; ++k) s[k] = k < left ? __ldg(row + k) : I(0);
}

// A thread row in order, kUnroll edges a step: the sources of the next
// step load while this step's contributions are gathered, so a step
// waits on one round trip, not two.
template <typename I>
__device__ void thread_row(long long i, float acc, const I* __restrict__ offsets,
                           const I* __restrict__ src_by_dst, const I* __restrict__ schedule,
                           const float* contrib, float* __restrict__ total) {
  const long long begin = __ldg(offsets + i);
  const long long len = __ldg(offsets + i + 1) - begin;
  const I* row = src_by_dst + begin;
  I s[kUnroll], next[kUnroll];
  load_sources(s, row, len);
  for (long long done = 0; done < len; done += kUnroll) {
    const long long left = len - done;
    float c[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) c[k] = k < left ? contrib[s[k]] : 0.0f;
    load_sources(next, row + done + kUnroll, left - kUnroll);
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      if (k < left) acc = __fadd_rn(acc, c[k]);
      s[k] = next[k];
    }
  }
  total[__ldg(schedule + i)] = acc;
}

template <typename I, bool kWeighted>
__global__ void __launch_bounds__(kThreads) gather_add_kernel(
    const float* __restrict__ init, const I* __restrict__ offsets,
    const I* __restrict__ src_by_dst, const I* __restrict__ schedule,
    const float* __restrict__ ranks, const float* __restrict__ inv_deg, float* contrib,
    float* prod, float* __restrict__ total, long long num_nodes, long long num_src,
    long long warp_rows) {
  __shared__ __align__(16) float stage[kWarps][kSpan];
  cg::grid_group grid = cg::this_grid();
  const long long threads = (long long)gridDim.x * kThreads;
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long warp_edges = __ldg(offsets + warp_rows);
#pragma unroll 4
  for (long long e = t; e < warp_edges; e += threads) {
    const I s = __ldg(src_by_dst + e);
    prod[e] = kWeighted ? __fmul_rn(__ldg(ranks + s), __ldg(inv_deg + s)) : __ldg(ranks + s);
  }
  if constexpr (kWeighted) {
#pragma unroll 4
    for (long long v = t; v < num_src; v += threads)
      contrib[v] = __fmul_rn(__ldg(ranks + v), __ldg(inv_deg + v));
  }
  const float* gathered = kWeighted ? contrib : ranks;
  grid.sync();  // every product written; plain loads read them from here on
  // Two pools of warps.  The first takes the warp rows, sized so that
  // its warps' rows, each counted with a start of kRowStart edges, add up
  // to about the longest row each (the warp with the longest chain owns
  // no share of the short rows), and to no more than the warp rows' share
  // of the edges.  The rest take the thread rows.
  const float acc = __ldg(init);
  const long long warps = threads / 32, w = t / 32;
  const long long num_edges = __ldg(offsets + num_nodes);
  long long pool = 0;
  if (warp_rows > 0) {
    const long long longest = __ldg(offsets + 1) - __ldg(offsets);
    const long long share = num_edges > 0 ? warps * warp_edges / num_edges : warps;
    pool = (warp_edges + kRowStart * warp_rows + longest + kRowStart - 1) / (longest + kRowStart);
    pool = pool > share ? share : pool;
    pool = pool < 1 ? 1 : pool > warp_rows ? warp_rows : pool;
    if (warps > 1 && pool > warps - 1) pool = warps - 1;
  }
  // A grid of one warp takes the thread rows after the warp rows.
  const long long first = pool < warps ? pool : 0;
  if (w < pool) {
    // Round robin, every other round backwards, so the warp of the
    // longest row takes the shortest of the next round.
    for (long long r = 0; r * pool < warp_rows; ++r) {
      const long long i = r * pool + (r % 2 == 0 ? w : pool - 1 - w);
      if (i < warp_rows) warp_row(i, acc, offsets, schedule, prod, total, stage[threadIdx.x / 32]);
    }
  }
  if (w >= first) {
    const long long pool_threads = threads - 32 * first;
    for (long long i = warp_rows + t - 32 * first; i < num_nodes; i += pool_threads)
      thread_row(i, acc, offsets, src_by_dst, schedule, gathered, total);
  }
}

// The cooperative grid: as many blocks as the card holds at once, asked
// once per device.
template <typename I, bool kWeighted>
cudaError_t grid_size(int dev, unsigned* grid) {
  static std::mutex mu;
  static int cap[16] = {};
  if (dev < 0 || dev >= 16) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(mu);
  if (cap[dev] == 0) {
    int sms = 0, per_sm = 0, coop = 0;
    cudaError_t err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
            cudaSuccess ||
        (err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev)) !=
            cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, gather_add_kernel<I, kWeighted>, kThreads, 0)) != cudaSuccess)
      return err;
    if (!coop || per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
    cap[dev] = sms * per_sm;
  }
  *grid = (unsigned)cap[dev];
  return cudaSuccess;
}

template <typename I, bool kWeighted>
int launch(const void* init, const void* offsets, const void* src_by_dst,
           const void* schedule, const void* ranks, const void* inv_deg, void* scratch,
           void* total, long long num_nodes, long long num_src, long long warp_rows, int dev,
           cudaStream_t stream) {
  unsigned grid = 0;
  cudaError_t err = grid_size<I, kWeighted>(dev, &grid);
  if (err != cudaSuccess) return (int)err;
  const float* in = static_cast<const float*>(init);
  const I* off = static_cast<const I*>(offsets);
  const I* src = static_cast<const I*>(src_by_dst);
  const I* sch = static_cast<const I*>(schedule);
  const float* rk = static_cast<const float*>(ranks);
  const float* inv = static_cast<const float*>(inv_deg);
  float* contrib = static_cast<float*>(scratch);
  float* prod = contrib + num_src;
  float* out = static_cast<float*>(total);
  void* args[] = {&in, &off, &src, &sch, &rk, &inv, &contrib, &prod, &out, &num_nodes,
                  &num_src, &warp_rows};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(gather_add_kernel<I, kWeighted>), grid,
                                    kThreads, args, 0, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// init: float32 [1] on the device (the dangling share); offsets: [num_nodes
// + 1] by schedule position, src_by_dst: [offsets[num_nodes]], schedule:
// [num_nodes], all of ``index_bytes`` (4: int32, 8: int64); warp_rows: how
// many of the schedule's first rows a warp takes; ranks, inv_deg: float32
// [num_src] indexed by source, inv_deg null for an unweighted sum;
// scratch: float32 [num_src +
// offsets[warp_rows]] at least, overwritten; total: float32 [num_nodes],
// every element written.  dev: the current device's index.  Returns 0
// when launched, else a cudaError_t.
extern "C" int locust_pagerank_gather_add(const void* init, const void* offsets,
                                          const void* src_by_dst, const void* schedule,
                                          const void* ranks, const void* inv_deg,
                                          void* scratch, void* total, long long num_nodes,
                                          long long num_src, long long warp_rows,
                                          int index_bytes, int dev, void* stream) {
  if (num_nodes < 0 || num_src < 0 || warp_rows < 0 || warp_rows > num_nodes)
    return (int)cudaErrorInvalidValue;
  if (num_nodes == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  auto go = [&](auto fn) {
    return fn(init, offsets, src_by_dst, schedule, ranks, inv_deg, scratch, total, num_nodes,
              num_src, warp_rows, dev, s);
  };
  if (index_bytes == 4)
    return inv_deg ? go(launch<int32_t, true>) : go(launch<int32_t, false>);
  if (index_bytes == 8)
    return inv_deg ? go(launch<long long, true>) : go(launch<long long, false>);
  return (int)cudaErrorInvalidValue;
}
