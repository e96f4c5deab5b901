// Bitonic sort for Hopper (sm_90a): one 64-bit word per element, the
// network run in registers, warp shuffles and shared memory.
//
// Replaces the TPU kernel locust_tpu/ops/pallas/sort.py
// (_local_stages_kernel, launched by _run_local from bitonic_sort, and
// its cross-tile passes _run_cross, which run as XLA code there).  Same
// contract as bitonic_sort: an ascending, not stable sort of a uint32
// key padded to a power of two (at least 1024) with 0xFFFFFFFF, payload
// rows moved alongside.  It runs the same Batcher network, and a
// compare-exchange swaps only when the keys differ, so the output
// permutation is the TPU kernel's.
//
// What bounds it on the card: launches and on-chip latency, not bytes.
// At the main path's 2^18 elements the words (2 MiB) stay in the 50 MB
// L2, and the network's k(k+1)/2 substages each do little work.  The
// design:
//   * an element is one word, the key in the high half and the row
//     index in the low half; a compare looks at the high half only, so
//     ties never swap.  A compare-exchange is one load and one store per
//     side;
//   * a thread holds 4 words.  A block holds 2^B words in one of two
//     layouts: "low" (local index bits 0..1 in registers, 2..6 across
//     the warp's lanes) or "high" (bits B-2..B-1 in registers, B-7..B-3
//     across lanes).  A substage on a register bit is a compare in
//     registers, on a lane bit one __shfl_xor_sync per word; only a
//     change of layout goes through shared memory (two barriers);
//   * the launches follow config.bitonic_launch_plan.  A tile launch
//     (bitonic_tile_kernel, 2^B consecutive words) runs every substage
//     of distance below the tile, unrolled at compile time for its B:
//     stages 1..B in the first launch, one merge stage in later ones.
//     A cross launch (bitonic_cross_kernel) gathers coalesced runs of
//     2^L words at the 2^c positions that differ in the next c
//     cross-tile bits and runs those c substages on chip: one cross
//     launch per stage above the tile instead of one per substage.  In
//     both a merge and a cross launch the direction bit lies outside
//     the block, so the whole block sorts one way;
//   * the first launch reads the caller's key and numbers the rows; the
//     last writes the sorted key and gathers the payload rows below n,
//     coalesced, so there is no separate gather launch;
//   * one C entry point runs the whole plan on the caller's stream.
//     Where every step has the same block size and the grid fits on the
//     card at once (2^12 to 2^18 elements with 2^11 tiles), the steps run
//     in one cooperative launch (bitonic_coop_kernel) with a grid-wide
//     barrier between them: the same device work, one host launch
//     instead of 15.  Otherwise one launch per step.

#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

using u64 = unsigned long long;

// 4 words a thread, so that at 2^18 elements each SM holds 16 warps to
// hide the latency of the shuffles and compares.
constexpr int kRegBits = 2;
constexpr int kWords = 1 << kRegBits;
constexpr int kFastBits = kRegBits + 5;          // register and lane bits of a layout
constexpr uint32_t kAllWords = (1u << kWords) - 1;
constexpr int kMinBlockBits = 8;
constexpr int kMaxBlockBits = 12;                // 2^12 words = 32 KB of shared memory
static_assert(kMinBlockBits >= kFastBits, "a block holds at least one warp's words");
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ uint32_t key_of(u64 w) { return (uint32_t)(w >> 32); }

// Shared-memory slot of local index i.  XORing the low 4 bits with the
// next 4 spreads both layouts' accesses of 8-byte words over distinct
// banks within each half-warp.
__device__ __forceinline__ uint32_t slot(uint32_t i) { return i ^ ((i >> 4) & 15u); }

struct Block {
  int B, L, g0;     // block bits, low bits, global bit of local bit L
  uint32_t fixed;   // the global index bits that blockIdx sets
  uint32_t warp, lane;

  __device__ __forceinline__ Block(int B_, int L_, int g0_) : B(B_), L(L_), g0(g0_) {
    const int lo_bits = g0 - L;  // block index bits between the low run and the cross bits
    fixed = ((blockIdx.x & ((1u << lo_bits) - 1u)) << L) |
            ((blockIdx.x >> lo_bits) << (g0 + B - L));
    warp = threadIdx.x >> 5;
    lane = threadIdx.x & 31;
  }
  __device__ __forceinline__ uint32_t global(uint32_t i) const {
    return (i & ((1u << L) - 1u)) | ((i >> L) << g0) | fixed;
  }
  // Local index of register r in the low (hi == 0) or high layout.
  __device__ __forceinline__ uint32_t local(int hi, int r) const {
    return hi ? (warp | (lane << (B - kFastBits)) | ((uint32_t)r << (B - kRegBits)))
              : ((uint32_t)r | (lane << kRegBits) | (warp << kFastBits));
  }
  // Bit r set: register r's word lies in a descending block of stage s.
  __device__ __forceinline__ uint32_t descending(int hi, int s) const {
    uint32_t m = 0;
#pragma unroll
    for (int r = 0; r < kWords; ++r) m |= ((global(local(hi, r)) >> s) & 1u) << r;
    return m;
  }
};

// Substage on register bit RB: words r and r | 2^RB.
template <int RB>
__device__ __forceinline__ void cx_regs(u64 (&v)[kWords], uint32_t desc) {
#pragma unroll
  for (int r = 0; r < kWords; ++r) {
    if (r & (1 << RB)) continue;
    const int q = r | (1 << RB);
    const u64 lo = v[r], up = v[q];
    const bool swap = (desc >> r) & 1u ? key_of(up) > key_of(lo) : key_of(up) < key_of(lo);
    v[r] = swap ? up : lo;
    v[q] = swap ? lo : up;
  }
}

// Substage on lane bit lb: each side takes its partner's word where the
// lower side must keep the min (ascending block) or the max.
__device__ __forceinline__ void cx_lanes(u64 (&v)[kWords], uint32_t lane, uint32_t desc,
                                         int lb) {
  // Bit r set: this side keeps the max of pair r.
  const uint32_t keep_max = desc ^ (((lane >> lb) & 1u) ? kAllWords : 0u);
#pragma unroll
  for (int r = 0; r < kWords; ++r) {
    const u64 p = __shfl_xor_sync(kFull, v[r], 1 << lb);
    const bool take = (keep_max >> r) & 1u ? key_of(p) > key_of(v[r]) : key_of(p) < key_of(v[r]);
    v[r] = take ? p : v[r];
  }
}

// The substage on register bit rb, if rb is one (RB .. kRegBits-1).
template <int RB>
__device__ __forceinline__ bool cx_reg_bit(u64 (&v)[kWords], uint32_t desc, int rb) {
  if constexpr (RB < kRegBits) {
    if (rb == RB) {
      cx_regs<RB>(v, desc);
      return true;
    }
    return cx_reg_bit<RB + 1>(v, desc, rb);
  } else {
    return false;
  }
}

// Moves the words from shared memory (layout lay, or -1 when they are in
// shared memory) into the layout `want`.
__device__ __forceinline__ void relayout(u64* sm, u64 (&v)[kWords], const Block& b, int lay,
                                         int want) {
  if (lay >= 0) {
    __syncthreads();  // every read of the previous layout is done
#pragma unroll
    for (int r = 0; r < kWords; ++r) sm[slot(b.local(lay, r))] = v[r];
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kWords; ++r) v[r] = sm[slot(b.local(want, r))];
}

// The substage on local bit lb.  Keeps the layout while it holds the
// bit; else takes the one that does, the low one first (the next
// substages' bits are lower).  uniform: desc holds for every layout.
__device__ __forceinline__ void substage(u64* sm, u64 (&v)[kWords], const Block& b, int& lay,
                                         uint32_t& desc, int lb, int s, bool uniform) {
  const bool in_low = lb < kFastBits, in_high = lb >= b.B - kFastBits;
  const int want = (lay == 0 && in_low) || (lay == 1 && in_high) ? lay : (in_low ? 0 : 1);
  if (want != lay) {
    relayout(sm, v, b, lay, want);
    lay = want;
    if (!uniform) desc = b.descending(lay, s);
  }
  if (!cx_reg_bit<0>(v, desc, lay ? lb - (b.B - kRegBits) : lb))
    cx_lanes(v, b.lane, desc, lay ? lb - (b.B - kFastBits) : lb - kRegBits);
}

// Leaves the words of layout lay in shared memory, in local order.
__device__ __forceinline__ void park(u64* sm, const u64 (&v)[kWords], const Block& b, int lay) {
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kWords; ++r) sm[slot(b.local(lay, r))] = v[r];
  __syncthreads();
}

// A tile launch: 2^B consecutive words per block.  merge_s == 0: the
// first launch, stages 1..B; else stage merge_s > B, substages B..1.
// first: read the caller's key (pad 0xFFFFFFFF beyond n) and number the
// rows; else read `words`.  last: write out_key and the gathered rows
// below n; else write `words`.
template <int B>
__device__ __forceinline__ void tile_step(u64* sm, u64* __restrict__ words,
                                          const uint32_t* __restrict__ in_key,
                                          const int32_t* __restrict__ rows,
                                          uint32_t* __restrict__ out_key,
                                          int32_t* __restrict__ out_rows, uint32_t n,
                                          uint32_t width, int merge_s, int first, int last) {
  constexpr uint32_t kThreads = 1u << (B - kRegBits);
  const Block b(B, B, B);
  const uint32_t base = b.fixed;
  u64 v[kWords];
  // Thread t moves words t + k * kThreads: coalesced, all loads in flight.
#pragma unroll
  for (int k = 0; k < kWords; ++k) {
    const uint32_t g = base + threadIdx.x + k * kThreads;
    v[k] = first ? ((u64)(g < n ? in_key[g] : 0xFFFFFFFFu) << 32) | g : words[g];
  }
#pragma unroll
  for (int k = 0; k < kWords; ++k) sm[slot(threadIdx.x + k * kThreads)] = v[k];

  int lay = -1;  // -1: the words are in shared memory
  uint32_t desc = 0;
  if (merge_s == 0) {
#pragma unroll
    for (int s = 1; s <= B; ++s) {
      if (lay >= 0) desc = b.descending(lay, s);
#pragma unroll
      for (int t = s; t >= 1; --t) substage(sm, v, b, lay, desc, t - 1, s, false);
    }
  } else {
    desc = ((base >> merge_s) & 1u) ? kAllWords : 0u;
#pragma unroll
    for (int t = B; t >= 1; --t) substage(sm, v, b, lay, desc, t - 1, merge_s, true);
  }
  park(sm, v, b, lay);

  if (!last) {
#pragma unroll
    for (int k = 0; k < kWords; ++k) {
      const uint32_t i = threadIdx.x + k * kThreads;
      words[base + i] = sm[slot(i)];
    }
    return;
  }
  // A pad row (index >= n) reaches the first n only where a real key is
  // 0xFFFFFFFF; its payload is 0, as in the TPU kernel.
  const uint32_t here = base < n ? min(1u << B, n - base) : 0u;
#pragma unroll
  for (int k = 0; k < kWords; ++k) {
    const uint32_t i = threadIdx.x + k * kThreads;
    if (i < here) out_key[base + i] = key_of(sm[slot(i)]);
  }
  // The block's output rows are here * width consecutive ints: thread t
  // writes ints f = t + j * kThreads, kGather source loads in flight at
  // once, each from a valid address (row 0 where f or its source is
  // past the end), selected afterwards.  (r, col) = divmod(f, width)
  // advances by divmod(kThreads, width): no division in the loop.
  constexpr int kGather = 3 * kWords;
  if (here == 0 || width == 0) return;
  const uint32_t total = here * width, step_r = kThreads / width, step_c = kThreads % width;
  int32_t* out = out_rows + (size_t)base * width;
  uint32_t r = threadIdx.x / width, col = threadIdx.x % width;
  for (uint32_t f0 = threadIdx.x; f0 < total; f0 += kGather * kThreads) {
    int32_t val[kGather];
#pragma unroll
    for (int k = 0; k < kGather; ++k) {
      const bool live = f0 + k * kThreads < total;
      const uint32_t src = (uint32_t)sm[slot(live ? r : 0u)];
      const bool real = live && src < n;
      val[k] = rows[(size_t)(real ? src : 0u) * width + (real ? col : 0u)];
      val[k] = real ? val[k] : 0;
      col += step_c;
      r += step_r;
      if (col >= width) {
        col -= width;
        ++r;
      }
    }
#pragma unroll
    for (int k = 0; k < kGather; ++k) {
      const uint32_t f = f0 + k * kThreads;
      if (f < total) out[f] = val[k];
    }
  }
}

// A cross step: substages t_hi..t_lo of stage s on 2^B words per
// block, local bits below L at global bits 0..L-1, the others from g0.
// Bit s lies above the block's bits, so the block has one direction.
__device__ __forceinline__ void cross_step(u64* sm, u64* __restrict__ words, int B, int L,
                                           int g0, int s, int t_hi, int t_lo) {
  const uint32_t threads = 1u << (B - kRegBits);
  const Block b(B, L, g0);
  u64 v[kWords];
#pragma unroll
  for (int k = 0; k < kWords; ++k) v[k] = words[b.global(threadIdx.x + k * threads)];
#pragma unroll
  for (int k = 0; k < kWords; ++k) sm[slot(threadIdx.x + k * threads)] = v[k];
  int lay = -1;
  uint32_t desc = ((b.fixed >> s) & 1u) ? kAllWords : 0u;
  for (int t = t_hi; t >= t_lo; --t) substage(sm, v, b, lay, desc, L + (t - 1) - g0, s, true);
  park(sm, v, b, lay);
#pragma unroll
  for (int k = 0; k < kWords; ++k) {
    const uint32_t i = threadIdx.x + k * threads;
    words[b.global(i)] = sm[slot(i)];
  }
}

template <int B>
__global__ void __launch_bounds__(1 << (B - kRegBits))
bitonic_tile_kernel(u64* __restrict__ words, const uint32_t* __restrict__ in_key,
                    const int32_t* __restrict__ rows, uint32_t* __restrict__ out_key,
                    int32_t* __restrict__ out_rows, uint32_t n, uint32_t width, int merge_s,
                    int first, int last) {
  extern __shared__ u64 sm[];
  tile_step<B>(sm, words, in_key, rows, out_key, out_rows, n, width, merge_s, first, last);
}

__global__ void __launch_bounds__(1 << (kMaxBlockBits - kRegBits))
bitonic_cross_kernel(u64* __restrict__ words, int B, int L, int g0, int s, int t_hi, int t_lo) {
  extern __shared__ u64 sm[];
  cross_step(sm, words, B, L, g0, s, t_hi, t_lo);
}

constexpr int kMaxCoopSteps = 32;

struct CoopPlan {
  int steps;
  int tile[kMaxCoopSteps], L[kMaxCoopSteps], g0[kMaxCoopSteps], s[kMaxCoopSteps];
  int t_hi[kMaxCoopSteps], t_lo[kMaxCoopSteps];
};

// Every step of a plan whose steps all have 2^B-word blocks, in one
// cooperative launch with a grid-wide barrier between steps (which also
// orders each step's writes of `words` before the next step's reads).
template <int B>
__global__ void __launch_bounds__(1 << (B - kRegBits))
bitonic_coop_kernel(u64* __restrict__ words, const uint32_t* __restrict__ in_key,
                    const int32_t* __restrict__ rows, uint32_t* __restrict__ out_key,
                    int32_t* __restrict__ out_rows, uint32_t n, uint32_t width, CoopPlan plan) {
  extern __shared__ u64 sm[];
  cg::grid_group grid = cg::this_grid();
  for (int k = 0; k < plan.steps; ++k) {
    if (k) grid.sync();
    if (plan.tile[k])
      tile_step<B>(sm, words, in_key, rows, out_key, out_rows, n, width, k ? plan.s[k] : 0,
                   k == 0, k == plan.steps - 1);
    else
      cross_step(sm, words, B, plan.L[k], plan.g0[k], plan.s[k], plan.t_hi[k], plan.t_lo[k]);
  }
}

template <int B>
void* coop_kernel() { return reinterpret_cast<void*>(&bitonic_coop_kernel<B>); }

// The cooperative kernel for 2^B-word blocks if its grid of 2^(kbits-B)
// blocks fits on the current device at once, else null.  The occupancy
// is asked once per device and block size.
void* coop_kernel_if_fits(int B, int kbits) {
  static int max_grid[16][kMaxBlockBits + 1];  // 0: not asked yet; -1: no cooperative launch
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= 16) return nullptr;
  void* fn = B == 8 ? coop_kernel<8>() : B == 9 ? coop_kernel<9>() : B == 10 ? coop_kernel<10>()
           : B == 11 ? coop_kernel<11>() : coop_kernel<12>();
  int& cap = max_grid[dev][B];
  if (cap == 0) {
    int sms = 0, coop = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, 1 << (B - kRegBits),
                                                  sizeof(u64) << B);
    cap = coop && per_sm > 0 ? per_sm * sms : -1;
  }
  return cap > 0 && (1ll << (kbits - B)) <= cap ? fn : nullptr;
}

struct Step {
  int B, L, g0, count, s, t_hi, t_lo;  // t_*: the first stage triple
  bool tile, first_kind;                // tile launch; stages 1..B
};

// Reads one launch of the plan (block_bits, low_bits, cross_at, count,
// then count triples (s, t_hi, t_lo)); false if it is not one the
// kernels run: a first tile launch of stages 1..B, a tile launch of one
// stage s > B over substages B..1, or a cross launch of one stage's
// substages on bits of the block.
bool read_step(const int* p, int kbits, int k, int launches, Step* st) {
  st->B = p[0];
  st->L = p[1];
  st->g0 = p[2];
  st->count = p[3];
  const int B = st->B, L = st->L, g0 = st->g0, c = B - L;
  if (B < kMinBlockBits || B > kMaxBlockBits || B > kbits || L < 0 || L > B || g0 < L ||
      g0 + c > kbits || st->count < 1)
    return false;
  st->s = p[4];
  st->t_hi = p[5];
  st->t_lo = p[6];
  st->tile = c == 0 && g0 == B;
  st->first_kind = st->tile && st->count == B;
  if (st->first_kind) {
    for (int q = 0; q < B; ++q)
      if (p[4 + 3 * q] != q + 1 || p[5 + 3 * q] != q + 1 || p[6 + 3 * q] != 1) return false;
    return k == 0;
  }
  if (st->count != 1 || k == 0 || st->s > kbits) return false;
  if (st->tile) return st->s > B && st->t_hi == B && st->t_lo == 1;
  return k != launches - 1 && st->t_lo >= 1 && st->t_lo <= st->t_hi && st->t_hi <= st->s &&
         st->t_lo - 1 >= g0 && st->t_hi - 1 < g0 + c && st->s >= g0 + c;
}

template <int B>
void launch_tile(unsigned grid, cudaStream_t stream, u64* words, const uint32_t* in_key,
                 const int32_t* rows, uint32_t* out_key, int32_t* out_rows, uint32_t n,
                 uint32_t width, int merge_s, int first, int last) {
  bitonic_tile_kernel<B><<<grid, 1 << (B - kRegBits), sizeof(u64) << B, stream>>>(
      words, in_key, rows, out_key, out_rows, n, width, merge_s, first, last);
}

}  // namespace

// Sorts n rows by key on `stream`, every step of `plan` (config.
// bitonic_launch_plan flattened, `launches` steps) for 2^kbits padded
// elements.  words: u64 [2^kbits] scratch (unused when the plan is one
// step); in_key: uint32 [n]; rows: int32 [n, width]; out_key: uint32
// [n]; out_rows: int32 [n, width].  *cuda_launches: the kernel launches
// made (1 for a cooperative launch).  Returns the first launch error,
// or cudaErrorInvalidValue, before any launch, for a plan it cannot run.
extern "C" int locust_bitonic_sort(void* words, const void* in_key, const void* rows,
                                   void* out_key, void* out_rows, long long n, int width,
                                   int kbits, const int* plan, int launches, void* stream,
                                   int* cuda_launches) {
  *cuda_launches = 0;
  if (kbits < kMinBlockBits || kbits > 31 || n < 0 || n > (1ll << kbits) || width < 0 ||
      width > (1 << 19) || launches < 1)
    return (int)cudaErrorInvalidValue;
  Step st;
  CoopPlan cp;
  cp.steps = launches;
  bool uniform = launches > 1 && launches <= kMaxCoopSteps;
  const int* p = plan;
  for (int k = 0; k < launches; ++k) {
    if (!read_step(p, kbits, k, launches, &st) || (k == launches - 1 && !st.tile))
      return (int)cudaErrorInvalidValue;
    p += 4 + 3 * st.count;
    uniform = uniform && st.B == plan[0];
    if (uniform) {
      cp.tile[k] = st.tile;
      cp.L[k] = st.L;
      cp.g0[k] = st.g0;
      cp.s[k] = st.s;
      cp.t_hi[k] = st.t_hi;
      cp.t_lo[k] = st.t_lo;
    }
  }
  if (void* fn = uniform ? coop_kernel_if_fits(plan[0], kbits) : nullptr) {
    u64* a_words = static_cast<u64*>(words);
    const uint32_t* a_key = static_cast<const uint32_t*>(in_key);
    const int32_t* a_rows = static_cast<const int32_t*>(rows);
    uint32_t* a_out_key = static_cast<uint32_t*>(out_key);
    int32_t* a_out_rows = static_cast<int32_t*>(out_rows);
    uint32_t a_n = (uint32_t)n, a_width = (uint32_t)width;
    void* args[] = {&a_words, &a_key, &a_rows, &a_out_key, &a_out_rows, &a_n, &a_width, &cp};
    const int B = plan[0];
    const cudaError_t err = cudaLaunchCooperativeKernel(
        fn, 1u << (kbits - B), 1u << (B - kRegBits), args, sizeof(u64) << B,
        (cudaStream_t)stream);
    if (err != cudaSuccess) return (int)err;
    *cuda_launches = 1;
    return (int)cudaGetLastError();
  }
  auto* w = static_cast<u64*>(words);
  const auto* ik = static_cast<const uint32_t*>(in_key);
  const auto* rw = static_cast<const int32_t*>(rows);
  auto* ok = static_cast<uint32_t*>(out_key);
  auto* orows = static_cast<int32_t*>(out_rows);
  const auto strm = (cudaStream_t)stream;
  p = plan;
  for (int k = 0; k < launches; ++k) {
    read_step(p, kbits, k, launches, &st);
    p += 4 + 3 * st.count;
    const unsigned grid = 1u << (kbits - st.B);
    if (st.tile) {
      const int merge_s = st.first_kind ? 0 : st.s, first = k == 0, last = k == launches - 1;
      switch (st.B) {
        case 8: launch_tile<8>(grid, strm, w, ik, rw, ok, orows, n, width, merge_s, first, last); break;
        case 9: launch_tile<9>(grid, strm, w, ik, rw, ok, orows, n, width, merge_s, first, last); break;
        case 10: launch_tile<10>(grid, strm, w, ik, rw, ok, orows, n, width, merge_s, first, last); break;
        case 11: launch_tile<11>(grid, strm, w, ik, rw, ok, orows, n, width, merge_s, first, last); break;
        default: launch_tile<12>(grid, strm, w, ik, rw, ok, orows, n, width, merge_s, first, last); break;
      }
    } else {
      bitonic_cross_kernel<<<grid, 1 << (st.B - kRegBits), sizeof(u64) << st.B, strm>>>(
          w, st.B, st.L, st.g0, st.s, st.t_hi, st.t_lo);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    ++*cuda_launches;
  }
  return (int)cudaSuccess;
}
