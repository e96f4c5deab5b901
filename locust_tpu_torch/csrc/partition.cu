// The shuffle's stable counting partition: every valid row of a batch
// written once into its slot of ``n_bins`` bins of ``cap`` slots, in the
// layout the all-to-all sends.
//
// No TPU kernel corresponds to this one.  The JAX package's
// ``parallel/shuffle.partition_to_bins`` is a jnp stable sort of the
// buckets and a scatter, which XLA lowers to its own sort; the port ran
// the same as torch ops (a stable int64 sort, ``bincount``, six
// ``index_put_``s, a ``cat`` of the bins and a gather of the payload by
// the binned values).  This kernel computes the same slots:
//
//   bin b, slot j:  the j-th valid row of bucket b in input order, j < cap;
//   leftover row:   valid rows past their bin's capacity, in (bucket,
//                   input) order, up to ``lcap``; what fits neither is
//                   counted in ``overflow``;
//   empty slots:    zero lanes and value, valid word 0.
//
// Bound: bytes.  A row is a bucket (8 bytes), a valid byte, L lanes
// and a value (4 bytes each) and, where given, a payload (the sample
// sort's 100-byte records); it is read twice for the bucket and valid
// (once per pass) and once for the rest, and written once, as L + 2
// int32 words (lanes, value, a valid word) and its payload.  The bins'
// empty slots are written too (zeros; their payload is left unwritten).
// At 80 M rows, 3 lanes and 100-byte records in one bin that is 20.3 GB,
// 6.1 ms at 3.35 TB/s (utils/roofline.partition_min_bytes).
//
// Three launches on the caller's stream, no host sync:
//   1. histogram: a block takes a tile of kTile rows, counts its valid
//      rows per bucket in shared memory (one shared add per bucket and
//      warp chunk of 32 rows, from __match_any_sync), and writes one
//      count per bucket, bucket-major over the tiles;
//   2. scan: a block per bucket turns its counts into each tile's first
//      rank in the bin (an exclusive prefix over the tiles) and writes
//      the bucket's total; the last block to finish (a ticket) turns the
//      totals into each bin's first leftover row, the prefix of max(0,
//      total - cap), and the overflow;
//   3. scatter: a block re-reads its tile's buckets and ranks each row
//      stably: inside a warp's chunk of 32 rows its rank among the same
//      bucket's lanes below it (the match mask and a popc), across the
//      warp's chunks in order by a running count per bucket, across the
//      block's warps by a prefix in shared memory, across tiles by the
//      scan.  Each row's slot lands in shared memory at the row's place in
//      the tile's bucket order, and the block then copies its rows out in
//      that order, word by word, neighbouring threads on neighbouring
//      words (lanes, value and valid word; then the payload): a bin's
//      rows of the tile fill consecutive slots, so the stores run
//      coalesced at any number of bins, and the reads stay inside the
//      tile.  Last, the block zeroes its share of the slots no row filled.
// Nothing is atomic in global memory but the scan's one ticket.  The
// bucket stays as the caller computes it; a row whose bucket lies outside
// [0, n_bins) is dropped like an invalid row.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // 8 warps a block
constexpr int kWarps = kThreads / 32;
constexpr int kChunks = 8;  // chunks of 32 rows a warp takes in a tile
constexpr int kWarpRows = 32 * kChunks;
constexpr int kTile = kWarps * kWarpRows;  // 2,048 rows a block
constexpr int kMaxBins = 1024;  // ops/kernels/partition.MAX_BINS
constexpr int kScanThreads = 1024;
constexpr int kUnroll = 8;  // words a thread holds in flight in the copies

__device__ __forceinline__ long long lmin(long long a, long long b) { return a < b ? a : b; }
__device__ __forceinline__ long long lmax(long long a, long long b) { return a > b ? a : b; }

// Row r's bucket, or n_bins for a row that goes nowhere (past the end,
// invalid, or its bucket outside [0, n_bins)).
__device__ __forceinline__ int bucket_of(const long long* __restrict__ bucket,
                                         const uint8_t* __restrict__ valid, long long r,
                                         long long n, int n_bins) {
  if (r >= n) return n_bins;
  const uint8_t ok = valid[r];  // both loads in flight before either is used
  const long long b = bucket[r];
  return ok && b >= 0 && b < n_bins ? (int)b : n_bins;
}

// The tile's buckets: lane ``lane`` of warp ``w`` holds rows w * kWarpRows
// + 32 c + lane, c < kChunks, all loads in flight before any is used.
__device__ __forceinline__ void load_tile(int (&bk)[kChunks],
                                          const long long* __restrict__ bucket,
                                          const uint8_t* __restrict__ valid, long long n,
                                          int n_bins) {
  const long long first = (long long)blockIdx.x * kTile + (threadIdx.x / 32) * kWarpRows +
                          threadIdx.x % 32;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) bk[c] = bucket_of(bucket, valid, first + 32 * c, n, n_bins);
}

__global__ void __launch_bounds__(kThreads) partition_hist_kernel(
    const long long* __restrict__ bucket, const uint8_t* __restrict__ valid, long long n,
    int n_bins, int tiles, int* __restrict__ counts, unsigned* __restrict__ ticket) {
  __shared__ int hist[kMaxBins];
  for (int b = threadIdx.x; b < n_bins; b += kThreads) hist[b] = 0;
  if (blockIdx.x == 0 && threadIdx.x == 0) *ticket = 0;  // the scan's, read after this kernel
  int bk[kChunks];
  load_tile(bk, bucket, valid, n, n_bins);
  __syncthreads();
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const unsigned peers = __match_any_sync(0xffffffffu, bk[c]);
    if (bk[c] < n_bins && lane == __ffs(peers) - 1) atomicAdd(&hist[bk[c]], __popc(peers));
  }
  __syncthreads();
  for (int b = threadIdx.x; b < n_bins; b += kThreads)
    counts[(long long)b * tiles + blockIdx.x] = hist[b];
}

// Inclusive prefix sum of x over the block's threads (blockDim.x a
// multiple of 32, at most 1,024); every thread of the block calls it.
__device__ int block_inclusive_scan(int x, int* warp_sums) {
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
#pragma unroll
  for (int d = 1; d < 32; d *= 2) {
    const int y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp_sums[w] = x;
  __syncthreads();
  if (w == 0) {
    int s = lane < (int)blockDim.x / 32 ? warp_sums[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d *= 2) {
      const int y = __shfl_up_sync(0xffffffffu, s, d);
      if (lane >= d) s += y;
    }
    warp_sums[lane] = s;
  }
  __syncthreads();
  if (w > 0) x += warp_sums[w - 1];
  __syncthreads();  // warp_sums free for the next call
  return x;
}

__global__ void __launch_bounds__(kScanThreads) partition_scan_kernel(
    int* __restrict__ counts, int tiles, int n_bins, long long cap, long long lcap,
    int* __restrict__ totals, int* __restrict__ spill_base, int* __restrict__ overflow,
    unsigned* __restrict__ ticket) {
  __shared__ int warp_sums[32];
  __shared__ bool last;
  // This bucket's counts over the tiles, a contiguous run a thread.
  int* row = counts + (long long)blockIdx.x * tiles;
  const int per = (tiles + kScanThreads - 1) / kScanThreads;
  const int lo = min(tiles, (int)threadIdx.x * per), hi = min(tiles, lo + per);
  int sum = 0;
  for (int t = lo; t < hi; ++t) sum += row[t];
  const int incl = block_inclusive_scan(sum, warp_sums);
  int run = incl - sum;
  for (int t = lo; t < hi; ++t) {
    const int c = row[t];
    row[t] = run;
    run += c;
  }
  if (threadIdx.x == kScanThreads - 1) totals[blockIdx.x] = incl;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  // Every bucket's total is in: each bin's first leftover row.
  __threadfence();
  const volatile int* tot = totals;
  int spill = 0;
  if ((int)threadIdx.x < n_bins) {
    const long long over = tot[threadIdx.x] - cap;
    spill = over > 0 ? (int)over : 0;
  }
  const int spilled = block_inclusive_scan(spill, warp_sums);
  if ((int)threadIdx.x < n_bins) spill_base[threadIdx.x] = spilled - spill;
  if (threadIdx.x == kScanThreads - 1) {
    spill_base[n_bins] = spilled;
    *overflow = spilled > lcap ? (int)(spilled - lcap) : 0;
  }
}

// Copies ``words`` words of each of the tile's ``rows`` placed rows to
// their slots, in bucket order: word k (position p = k / words, column
// k % words) is word column of tile row src[p], and goes to word column
// of row slot[p] of ``dst``, rows of ``words`` words, where slot[p] lies in
// [0, slot_end); ``word(row, col)`` reads it.  Neighbouring threads take
// neighbouring words, so a bucket's rows, whose slots follow each other,
// store as one run; a thread loads kUnroll words before it stores any.
template <typename F>
__device__ __forceinline__ void copy_rows(int* __restrict__ dst, int words, int rows,
                                          const int* slot, const uint16_t* src,
                                          long long slot_end, F word) {
  const long long total = (long long)rows * words;
  const int dp = kThreads / words, dc = kThreads % words;
  int p = threadIdx.x / words, col = threadIdx.x % words;
  for (long long k0 = threadIdx.x; k0 < total; k0 += kUnroll * kThreads) {
    int v[kUnroll];
    long long at[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      at[u] = -1;
      if (k0 + u * kThreads < total) {
        const int d = slot[p];
        if (d >= 0 && d < slot_end) {
          at[u] = (long long)d * words + col;
          v[u] = word(src[p], col);
        }
      }
      p += dp;
      col += dc;
      if (col >= words) {
        col -= words;
        ++p;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (at[u] >= 0) dst[at[u]] = v[u];
  }
}

// Shared memory of a scatter block at ``n_bins`` bins.
__host__ __device__ constexpr size_t scatter_smem(int n_bins) {
  return sizeof(int) * ((kWarps + 2) * (size_t)n_bins + kTile) + sizeof(uint16_t) * kTile;
}

__global__ void __launch_bounds__(kThreads) partition_scatter_kernel(
    const long long* __restrict__ bucket, const uint8_t* __restrict__ valid,
    const int* __restrict__ lanes, const int* __restrict__ values, int n_lanes,
    const int* __restrict__ payload, int words, int* __restrict__ pay_out,
    const int* __restrict__ tile_base, const int* __restrict__ totals,
    const int* __restrict__ spill_base, long long n, int n_bins, int tiles, long long cap,
    long long lcap, int* __restrict__ out) {
  extern __shared__ int smem[];
  int* warp_cnt = smem;                   // [kWarps][n_bins] the warp's first tile rank
  int* first = warp_cnt + kWarps * n_bins;  // [n_bins] the bucket's first tile position
  int* base = first + n_bins;             // [n_bins] the tile's first rank in the bin
  int* slot = base + n_bins;              // [kTile] by tile position, -1 for none
  uint16_t* src = reinterpret_cast<uint16_t*>(slot + kTile);  // [kTile] tile row by position
  __shared__ int warp_sums[32];
  __shared__ int placed;
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  const long long start = (long long)blockIdx.x * kTile;
  for (int i = threadIdx.x; i < kWarps * n_bins; i += kThreads) warp_cnt[i] = 0;
  int bk[kChunks], rank[kChunks];
  load_tile(bk, bucket, valid, n, n_bins);
  __syncthreads();
  // Ranks inside the warp's rows: below this lane in its chunk, then the
  // warp's earlier chunks (a running count a bucket; one lane a bucket
  // writes it, after every peer has read it).
  const unsigned below = (1u << lane) - 1u;
  int* cnt = warp_cnt + w * n_bins;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const unsigned peers = __match_any_sync(0xffffffffu, bk[c]);
    const bool live = bk[c] < n_bins;
    const int before = live ? cnt[bk[c]] : 0;
    __syncwarp();
    if (live && lane == __ffs(peers) - 1) cnt[bk[c]] = before + __popc(peers);
    __syncwarp();
    rank[c] = before + __popc(peers & below);
  }
  __syncthreads();
  // A bucket's earlier warps' rows give each warp its first rank in the
  // tile; the tile's count goes to ``first`` for the scan below.
  for (int b = threadIdx.x; b < n_bins; b += kThreads) {
    int run = 0;
    for (int k = 0; k < kWarps; ++k) {
      const int c = warp_cnt[k * n_bins + b];
      warp_cnt[k * n_bins + b] = run;
      run += c;
    }
    first[b] = run;
    base[b] = tile_base[(long long)b * tiles + blockIdx.x];
  }
  __syncthreads();
  // The tile's rows in bucket order: a bucket's first position is the
  // earlier buckets' rows of the tile (a run of buckets a thread).
  const int per = (n_bins + kThreads - 1) / kThreads;
  const int b0 = min(n_bins, (int)threadIdx.x * per), b1 = min(n_bins, b0 + per);
  int sum = 0;
  for (int b = b0; b < b1; ++b) sum += first[b];
  const int incl = block_inclusive_scan(sum, warp_sums);
  int run = incl - sum;
  for (int b = b0; b < b1; ++b) {
    const int c = first[b];
    first[b] = run;
    run += c;
  }
  if (threadIdx.x == kThreads - 1) placed = incl;
  __syncthreads();
  // Each row's slot: its rank j in the bin below cap, else its leftover
  // row, else none (overflow).
  const long long bins_rows = (long long)n_bins * cap;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    if (bk[c] < n_bins) {
      const int jt = cnt[bk[c]] + rank[c];
      const long long j = (long long)base[bk[c]] + jt;
      int d = -1;
      if (j < cap) {
        d = (int)(bk[c] * cap + j);
      } else {
        const long long s = spill_base[bk[c]] + (j - cap);
        if (s < lcap) d = (int)(bins_rows + s);
      }
      const int p = first[bk[c]] + jt;
      slot[p] = d;
      src[p] = (uint16_t)(w * kWarpRows + 32 * c + lane);
    }
  }
  __syncthreads();
  // The rows out: lanes, value, valid word.
  const int row_words = n_lanes + 2;
  const int* tile_lanes = lanes + start * n_lanes;
  const int* tile_values = values + start;
  copy_rows(out, row_words, placed, slot, src, bins_rows + lcap, [&](int r, int col) {
    return col < n_lanes ? tile_lanes[(long long)r * n_lanes + col]
                         : col == n_lanes ? tile_values[r] : 1;
  });
  // The payload beside them, bin slots only.
  if (words > 0) {
    const int* tile_payload = payload + start * words;
    copy_rows(pay_out, words, placed, slot, src, bins_rows,
              [&](int r, int col) { return tile_payload[(long long)r * words + col]; });
  }
  // This block's share of the output rows: zero those no row filled (a
  // bin's slots past its total, the leftover's past the spill).
  const long long out_rows = bins_rows + lcap;
  const long long share = (out_rows + gridDim.x - 1) / gridDim.x;
  const long long lo = (long long)blockIdx.x * share;
  const long long hi = lmin(lo + share, out_rows);
  for (long long b = cap > 0 ? lmin(lo / cap, n_bins) : n_bins; b <= n_bins && lo < hi; ++b) {
    const long long seg = b * cap;
    if (seg >= hi) break;
    const long long size = b < n_bins ? cap : lcap;
    const long long fill = b < n_bins ? totals[b] : spill_base[n_bins];
    const long long z0 = lmax(lo, seg + lmin(fill, size)), z1 = lmin(hi, seg + size);
    for (long long k = z0 * row_words + threadIdx.x; k < z1 * row_words; k += kThreads) out[k] = 0;
  }
}

int launch(const void* bucket, const void* valid, const void* lanes, int n_lanes,
           const void* values, const void* payload, int words, void* pay_out, void* out,
           void* overflow, void* workspace, long long n, int n_bins, long long cap,
           long long lcap, cudaStream_t stream) {
  const int tiles = (int)((n + kTile - 1) / kTile) > 0 ? (int)((n + kTile - 1) / kTile) : 1;
  int* counts = static_cast<int*>(workspace);
  int* totals = counts + (long long)n_bins * tiles;
  int* spill_base = totals + n_bins;
  unsigned* ticket = reinterpret_cast<unsigned*>(spill_base + n_bins + 1);
  const long long* bk = static_cast<const long long*>(bucket);
  const uint8_t* ok = static_cast<const uint8_t*>(valid);
  partition_hist_kernel<<<tiles, kThreads, 0, stream>>>(bk, ok, n, n_bins, tiles, counts, ticket);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  partition_scan_kernel<<<n_bins, kScanThreads, 0, stream>>>(
      counts, tiles, n_bins, cap, lcap, totals, spill_base, static_cast<int*>(overflow), ticket);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const size_t smem = scatter_smem(n_bins);
  if (smem > 48 * 1024 &&
      (err = cudaFuncSetAttribute(partition_scatter_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)) !=
          cudaSuccess)
    return (int)err;
  partition_scatter_kernel<<<tiles, kThreads, smem, stream>>>(
      bk, ok, static_cast<const int*>(lanes), static_cast<const int*>(values), n_lanes,
      static_cast<const int*>(payload), words, static_cast<int*>(pay_out), counts, totals,
      spill_base, n, n_bins, tiles, cap, lcap, static_cast<int*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

// The tile size (rows a block takes), for the wrapper's workspace.
extern "C" int locust_partition_tile_rows() { return kTile; }

// bucket: int64 [n]; valid: [n] bytes (0 or 1); lanes: int32 [n,
// n_lanes]; values: int32 [n]; payload: int32 [n, words], or null with
// words 0 (or with n 0); pay_out: int32 [n_bins * cap, words], the bin
// slots' payload (empty slots left unwritten); out: int32 [n_bins * cap +
// lcap, n_lanes + 2], the bins then the leftover, every word written;
// overflow: int32 [1]; workspace: int32 [n_bins * tiles + 2 * n_bins + 2],
// tiles = ceil(n / tile rows) and at least 1, overwritten.  n, n_bins *
// cap + lcap < 2^31, 1 <= n_bins <= 1,024.  Returns 0 when launched, else
// a cudaError_t.
extern "C" int locust_partition(const void* bucket, const void* valid, const void* lanes,
                                int n_lanes, const void* values, const void* payload,
                                int words, void* pay_out, void* out, void* overflow,
                                void* workspace, long long n, int n_bins, long long cap,
                                long long lcap, void* stream) {
  if (n < 0 || n_bins < 1 || n_bins > kMaxBins || cap < 0 || lcap < 0 || n_lanes < 1 ||
      words < 0 || (n > 0 && words > 0 && payload == nullptr))
    return (int)cudaErrorInvalidValue;
  return launch(bucket, valid, lanes, n_lanes, values, payload, words, pay_out, out, overflow,
                workspace, n, n_bins, cap, lcap, (cudaStream_t)stream);
}
