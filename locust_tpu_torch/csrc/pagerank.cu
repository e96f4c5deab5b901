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
// thousands of edges, the chain is the larger bound.  Past both, every
// edge gathers one 4-byte contribution at random, a miss in its SM's L1
// (and, past the 50 MB L2, in L2): an SM takes its gathers' misses a few
// cycles each, so the gathers have to be spread evenly over the SMs, and
// a long row's chain runs at about 8 cycles an edge, twice the add's
// latency.
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
//   1. every source's contribution ranks[v] * inv_deg[v] into ``contrib``,
//      coalesced, then a grid-wide barrier (unweighted: nothing to write
//      and no barrier; the rows gather ``ranks`` itself).  No per-edge
//      product is written: an edge's product is contrib[src[e]], the same
//      __fmul_rn of the same two floats.
//   2. the schedule, heaviest first, over two pools of warps, so the warp
//      with the longest chain owns no share of the short rows; the warps
//      are dealt across the blocks, so every SM holds its share of each
//      pool and of its gathers.  Warp rows round robin over the first
//      pool, sized to give each of its warps about the longest row's work
//      (and no more warps than the warp rows' share of the edges): a warp
//      walks its rows as one stream of groups of 256 edges (each row's
//      groups in order, then its next row's), a lane holding 8 edges of a
//      group, in a pipeline across row ends: a group's sources load four
//      groups ahead of its adds and its contributions are gathered three
//      groups ahead, the rows' offsets and nodes 32 rows at a time, so a
//      short row's dependent loads (offsets, sources, contributions) are
//      in flight while the groups before it add; it stages each group in
//      shared memory and one lane adds it in order from 16-byte reads
//      issued a batch ahead, so the chain waits on the adds alone.  Thread
//      rows over the other pool's threads: neighbouring threads take
//      neighbouring rows of nearly equal length, whose offsets and sources
//      lie side by side; each walks its row in order, 8 edges a step, the
//      next step's sources loading while this step's contributions are
//      gathered.  Every edge, in either pool, reads one contribution.  A
//      row with no edges writes init.
//
// Plain loads throughout.  Evict-first loads of the sources and an L2
// evict-last policy on the contributions' stores and gathers
// (createpolicy, ld/st.global.L2::cache_hint) measured no faster on an
// H100 at Graph500 SCALE 24 (16.8 M sources, 537 M edges), and 0-2%
// slower.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>
#include <mutex>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;  // 8 warps a block
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 8;      // edges a lane holds for one group of a warp row
constexpr int kSpan = 32 * kGroup;
constexpr int kUnroll = 8;     // edges a thread row holds in flight
// A warp row's start counted in edges of its chain: what sizes the pool
// of warps that take the warp rows.
constexpr long long kRowStart = 512;

// Group g of a warp row: lane ``lane`` holds its edges 32 k + lane, the
// ones before the row's end.  Their sources:
template <typename I>
__device__ __forceinline__ void load_group_sources(I (&s)[kGroup], const I* row, long long left,
                                                   int lane) {
#pragma unroll
  for (int k = 0; k < kGroup; ++k) s[k] = 32 * k + lane < left ? __ldg(row + 32 * k + lane) : I(0);
}

// ... and their contributions, gathered.
template <typename I>
__device__ __forceinline__ void gather_group(float (&c)[kGroup], const I (&s)[kGroup],
                                             const float* contrib, long long left, int lane) {
#pragma unroll
  for (int k = 0; k < kGroup; ++k) c[k] = 32 * k + lane < left ? contrib[s[k]] : 0.0f;
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

// Stages one group of a warp row in the warp's shared buffer, in edge
// order; the first barrier waits for lane 0 to have added the group
// before it.  The group's registers are free again once this returns.
__device__ __forceinline__ void stage_group(const float (&c)[kGroup], float* buf, int lane) {
  __syncwarp();
#pragma unroll
  for (int k = 0; k < kGroup; ++k) buf[32 * k + lane] = c[k];
  __syncwarp();
}

// Lane 0 adds the staged group's first min(left, kSpan) edges in edge
// order, from 16-byte reads, each batch of 16 read while the one before
// it adds, so the chain waits on the adds alone.
__device__ __forceinline__ float add_staged(float acc, long long left, const float* buf,
                                            int lane) {
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

// One group of a warp's stream: its row's node (-1 past the warp's last
// row) and the row's edges from the group's first on (the group holds the
// first kSpan of them; it is the row's last group when left <= kSpan).
template <typename I>
struct Group {
  I node, left;
};

// The warp rows a warp of the pool takes, round robin, every other round
// backwards (so the warp of the longest row takes the shortest of the
// next round), as one stream of groups: each row's groups in order, then
// the next row's.  The rows' offsets and nodes load 32 rows at a time, a
// lane a row, a batch ahead; the cursor reads its row's from the lane
// that holds it, so no row's start waits on memory.
template <typename I>
struct RowStream {
  const I *offsets, *schedule;
  long long pool, w, warp_rows, round, base;
  int lane;
  I begin, len, node, done;  // the cursor's row, and its edges taken
  I cb, cl, cn, nb, nl, nn;  // this lane's row of the batch (round base + lane), and of the next

  __device__ void load(long long r, I& b, I& l, I& n) const {
    const long long i = r * pool + (r % 2 == 0 ? w : pool - 1 - w);
    if (i < warp_rows) {
      b = __ldg(offsets + i);
      l = __ldg(offsets + i + 1) - b;
      n = __ldg(schedule + i);
    } else {
      b = l = 0;
      n = -1;
    }
  }

  __device__ void at_round() {
    const int from = (int)(round - base);
    begin = __shfl_sync(0xffffffffu, cb, from);
    len = __shfl_sync(0xffffffffu, cl, from);
    node = __shfl_sync(0xffffffffu, cn, from);
    done = 0;
  }

  __device__ RowStream(const I* off, const I* sched, long long pool_, long long w_,
                       long long rows, int lane_)
      : offsets(off), schedule(sched), pool(pool_), w(w_), warp_rows(rows), round(0), base(0),
        lane(lane_) {
    load(lane, cb, cl, cn);
    load(32 + lane, nb, nl, nn);
    at_round();
  }

  // The stream's next group, and where its sources start.
  __device__ Group<I> take(const I*& sources, const I* src_by_dst) {
    sources = src_by_dst + begin + done;
    const Group<I> g{node, node < 0 ? I(0) : (I)(len - done)};
    if (node < 0) return g;
    done += kSpan;
    if (done >= len) {
      if (++round - base == 32) {
        base += 32;
        cb = nb;
        cl = nl;
        cn = nn;
        load(base + 32 + lane, nb, nl, nn);
      }
      at_round();
    }
    return g;
  }
};

// A pool warp's rows as one pipeline over its stream of groups, across
// row ends, in kAhead register buffers of a group each: a step stages the
// group of its buffer for lane 0's adds, gathers into the buffer the
// contributions of the group kAhead ahead (whose sources loaded the step
// before) and loads the sources of the group after that.  So a group's
// sources load kAhead + 1 steps before its adds and its contributions
// kAhead steps before, and a short row's loads overlap the rows before
// it; the buffers are indexed by constants, so no register move waits on
// a load in flight.  A row's total is written after its last group.
constexpr int kAhead = 3;

template <typename I>
__device__ void warp_rows_of(long long pool, long long w, long long warp_rows, float init,
                             const I* __restrict__ offsets, const I* __restrict__ src_by_dst,
                             const I* __restrict__ schedule, const float* contrib,
                             float* __restrict__ total, float* buf) {
  const int lane = threadIdx.x % 32;
  RowStream<I> rows(offsets, schedule, pool, w, warp_rows, lane);
  const I* p;
  I s[kGroup];
  float v[kAhead][kGroup];
  Group<I> gv[kAhead];
#pragma unroll
  for (int j = 0; j < kAhead; ++j) {
    gv[j] = rows.take(p, src_by_dst);
    load_group_sources(s, p, gv[j].left, lane);
    gather_group(v[j], s, contrib, gv[j].left, lane);
  }
  Group<I> gs = rows.take(p, src_by_dst);
  load_group_sources(s, p, gs.left, lane);
  float acc = init;
  for (;;) {
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      if (gv[j].node < 0) return;
      stage_group(v[j], buf, lane);
      const Group<I> g = gv[j];
      gather_group(v[j], s, contrib, gs.left, lane);
      gv[j] = gs;
      gs = rows.take(p, src_by_dst);
      load_group_sources(s, p, gs.left, lane);
      acc = add_staged(acc, g.left, buf, lane);
      if (g.left <= kSpan) {
        if (lane == 0) total[g.node] = acc;
        acc = init;
      }
    }
  }
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
    float* __restrict__ total, long long num_nodes, long long num_src, long long warp_rows) {
  __shared__ __align__(16) float stage[kWarps][kSpan];
  const long long threads = (long long)gridDim.x * kThreads;
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if constexpr (kWeighted) {
#pragma unroll 4
    for (long long v = t; v < num_src; v += threads)
      contrib[v] = __fmul_rn(__ldg(ranks + v), __ldg(inv_deg + v));
    cg::this_grid().sync();  // every contribution written; plain loads read them from here on
  }
  const float* gathered = kWeighted ? contrib : ranks;
  // Two pools of warps.  The first takes the warp rows, sized so that
  // its warps' rows, each counted with a start of kRowStart edges, add up
  // to about the longest row each (the warp with the longest chain owns
  // no share of the short rows), and to no more than the warp rows' share
  // of the edges.  The rest take the thread rows.  The warps are dealt
  // across the blocks (warp k of every block, then warp k + 1), so that
  // each SM holds its share of the pool and of the pool's gathers.
  const float acc = __ldg(init);
  const long long warps = threads / 32;
  const long long w = (long long)(threadIdx.x / 32) * gridDim.x + blockIdx.x;
  const long long num_edges = __ldg(offsets + num_nodes);
  const long long warp_edges = __ldg(offsets + warp_rows);
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
  if (w < pool)
    warp_rows_of(pool, w, warp_rows, acc, offsets, src_by_dst, schedule, gathered, total,
                 stage[threadIdx.x / 32]);
  if (w >= first) {
    const long long pool_threads = threads - 32 * first;
    for (long long i = warp_rows + 32 * (w - first) + threadIdx.x % 32; i < num_nodes;
         i += pool_threads)
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
  float* out = static_cast<float*>(total);
  void* args[] = {&in, &off, &src, &sch, &rk, &inv, &contrib, &out, &num_nodes, &num_src,
                  &warp_rows};
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
// scratch: float32 [num_src] at least, the contributions, overwritten
// (unread by an unweighted sum); total: float32 [num_nodes], every
// element written.  dev: the current device's index.  Returns 0
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
