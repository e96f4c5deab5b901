// Fused map->aggregate kernel for Hopper (sm_90a): tokenize a block, total
// each tile's distinct keys, and fold them into one block-wide hash table,
// without writing the [L, E, K] token tensor to device memory.  One
// device op per call.
//
// Replaces the TPU kernel locust_tpu/ops/pallas/fused_fold.py
// (_fused_kernel, launched by fused_block_preagg).  Same contract: the
// rows of the table and of the residual hold exactly the block's distinct
// keys with exact totals (a key may sit in the table and in several
// tiles' residual rows; the settlement fold re-merges duplicates);
// `overflow` is the tokenizer's count of dropped tokens; `flag` is set
// when a tile stranded more keys than its residual rows hold, and the
// caller then discards table and residual and re-folds the block.  The
// slot layout inside the table is free: the engine settles table and
// residual through hash_table.aggregate_exact, whose result depends only
// on the set of keys and their totals.
//
// What bounds it on the card: bytes and latency, not operations.  It reads
// the block once (L * W bytes) and writes the table and residual (about
// (K + 9) bytes per slot and per residual row); the table's 8,192 slots
// stay in the 50 MB L2.  The TPU kernel spells every table access as a
// one-hot f32 matrix product and de-duplicates a tile by a Gram matrix,
// because a TPU has no cheap gather or atomics; here both are hash tables
// with atomics.
//
// Design: one cooperative launch of persistent blocks, grid = min(tiles,
// blocks that fit on the card at once); block b takes tiles b, b + grid,
// ... of `tile_lines` lines each.
// 0. Each block zeroes its share of the table (lanes, counts, slot
//    states) and block 0 the overflow and flag words; a grid-wide barrier
//    after the first tile's local phase orders this before any probe.
// 1. All lines of a tile are tokenized at once: group_tokenize
//    (tokenize.cuh, the tokenizer kernel's own code) with G lanes per line,
//    512 threads = up to 64 lines of 128 bytes per pass.  Each emit's key
//    goes to shared memory as big-endian 32-bit lanes, assembled in
//    registers.
// 2. Every valid emit is hashed (hash_pair's h1) and inserted into a
//    shared open-addressed table of at least 2x the tile's emits (so it
//    never fills): atomicCAS claims an empty slot for the emit's index,
//    a full-key compare finds the same key, and a shared atomicAdd counts
//    it.  The claimer of a slot is its key's leader; a ballot over the
//    slots then lists the leaders.
// 3. Each leader (one thread each, the list strided over the block)
//    walks hash_pair's probe sequence
//    slot_p = (h1 + p * (h2 | 1)) & (slots - 1), p < probes, over the
//    block table in global memory, h1 and the step computed once.  A
//    slot's state goes empty -> writing -> ready: one atomicCAS with
//    acquire semantics claims an empty slot or reads its state; the
//    claimer writes the key lanes and publishes ready with a release
//    store; a prober that reads writing waits for ready with acquire
//    loads (the writer waits on nothing, so this ends), then compares the
//    whole key with 16-byte loads and no early exit, and adds its count.
// 4. A leader that no probe resolves takes a residual row of its tile
//    through a shared counter; past `resid_rows` it sets the flag word.
//    Then the block writes the tile's other residual rows as zeros and
//    the `valid` byte of every residual row.
// After a second grid-wide barrier each block writes the `valid` byte of
// its share of the table slots and block 0 the flag byte.  So every
// output row is written by the launch: no memset, no comparison op.
// Counts are int32 and exact at any size.

#include <algorithm>
#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <mutex>

#include "tokenize.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxWidth = 2048;    // bytes per line
constexpr int kMaxEmits = 256;     // tokens per line
constexpr int kEmpty = 0, kWriting = 1, kReady = 2;

struct FusedArgs {
  const uint8_t* lines;
  long long n_tiles;
  int width, aligned, tile_lines, emits, nl, slots, probes, resid_rows, dd_slots;
  int g_log, chunks, unit_words;
  // Shared memory carving (byte offsets): keys at 0, then these.
  int off_h1, off_dd_head, off_dd_count, off_leaders, off_rows, off_slots, off_valid;
  int32_t *tab_lanes, *tab_count, *tab_state, *res_lanes, *res_count, *overflow, *flag_word;
  uint8_t *tab_valid, *res_valid, *flag;
  unsigned long long d[4];
};

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// core/packing._salted_fold over one key's big-endian lanes.
__device__ __forceinline__ uint32_t salted_fold(const uint32_t* lanes, int nl,
                                                uint32_t salt_prime, uint32_t pre_mul) {
  uint32_t acc = 0;
  for (int j = 0; j < nl; ++j)
    acc += fmix32((lanes[j] * pre_mul) ^ ((uint32_t)(j + 1) * salt_prime));
  return fmix32(acc);
}

__device__ __forceinline__ bool same_key(const uint32_t* a, const uint32_t* b, int nl) {
  uint32_t diff = 0;
  for (int j = 0; j < nl; ++j) diff |= a[j] ^ b[j];
  return diff == 0;
}

__device__ __forceinline__ int cas_acquire(int32_t* p, int expect, int want) {
  int old;
  asm volatile("atom.acquire.gpu.global.cas.b32 %0, [%1], %2, %3;"
               : "=r"(old) : "l"(p), "r"(expect), "r"(want) : "memory");
  return old;
}

__device__ __forceinline__ int load_acquire(const int32_t* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_release(int32_t* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;" :: "l"(p), "r"(v) : "memory");
}

// Writes nl lanes; 16-byte stores when nl is a multiple of 4.
__device__ __forceinline__ void put_lanes(int32_t* dst, const uint32_t* key, int nl) {
  if ((nl & 3) == 0) {
    for (int j = 0; j < nl; j += 4)
      *reinterpret_cast<uint4*>(dst + j) = *reinterpret_cast<const uint4*>(key + j);
  } else {
    for (int j = 0; j < nl; ++j) dst[j] = (int32_t)key[j];
  }
}

// Does the table row at `src` (written by another block) hold `key`?  All
// loads issued together through L2, no early exit.
__device__ __forceinline__ bool row_matches(const int32_t* src, const uint32_t* key, int nl) {
  uint32_t diff = 0;
  if ((nl & 3) == 0) {
    for (int j = 0; j < nl; j += 4) {
      const int4 v = __ldcg(reinterpret_cast<const int4*>(src + j));
      const uint4 k = *reinterpret_cast<const uint4*>(key + j);
      diff |= ((uint32_t)v.x ^ k.x) | ((uint32_t)v.y ^ k.y) | ((uint32_t)v.z ^ k.z) |
              ((uint32_t)v.w ^ k.w);
    }
  } else {
    for (int j = 0; j < nl; ++j) diff |= (uint32_t)__ldcg(src + j) ^ key[j];
  }
  return diff == 0;
}

__global__ void __launch_bounds__(kThreads)
fused_preagg_kernel(FusedArgs a) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ uint32_t s_dm[8];
  __shared__ int s_ovf, s_resid, s_nlead;
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nl = a.nl, emits = a.emits, n_emit = a.tile_lines * emits;
  uint32_t* keys = reinterpret_cast<uint32_t*>(smem);
  uint32_t* h1s = reinterpret_cast<uint32_t*>(smem + a.off_h1);
  int* dd_head = reinterpret_cast<int*>(smem + a.off_dd_head);
  int* dd_count = reinterpret_cast<int*>(smem + a.off_dd_count);
  int* leaders = reinterpret_cast<int*>(smem + a.off_leaders);
  uint8_t* valid = smem + a.off_valid;

  locust_tok::load_delims(s_dm, a.d[0], a.d[1], a.d[2], a.d[3]);
  if (tid == 0) s_ovf = 0;
  // 0. Zero this block's share of the table: lanes, counts and states are
  // one run of slots * (nl + 2) ints.
  {
    const long long n = (long long)a.slots * (nl + 2);
    const long long stride = (long long)gridDim.x * kThreads;
    const long long n4 = n >> 2;
    int4* t4 = reinterpret_cast<int4*>(a.tab_lanes);
    for (long long i = (long long)blockIdx.x * kThreads + tid; i < n4; i += stride)
      t4[i] = make_int4(0, 0, 0, 0);
    for (long long i = (n4 << 2) + (long long)blockIdx.x * kThreads + tid; i < n; i += stride)
      a.tab_lanes[i] = 0;
    if (blockIdx.x == 0 && tid == 0) *a.overflow = *a.flag_word = 0;
  }

  const int G = 1 << a.g_log, per_warp = 32 >> a.g_log;
  const int grp = lane >> a.g_log, g = lane & (G - 1);
  const int my = warp * per_warp + grp, pass_lines = kWarps * per_warp;
  const int rb = locust_tok::row_bytes(a.g_log, a.chunks);
  uint8_t* row = smem + a.off_rows + (size_t)my * rb;
  int* slot = reinterpret_cast<int*>(smem + a.off_slots) + (size_t)my * emits;
  const int unit_words = a.unit_words, unit = 4 * unit_words, units = 4 * nl / unit;
  const int step_e = G / units, step_u = G % units;

  bool synced = false;
  for (long long tile = blockIdx.x; tile < a.n_tiles; tile += gridDim.x) {
    for (int i = tid; i < a.dd_slots; i += kThreads) {
      dd_head[i] = -1;
      dd_count[i] = 0;
    }
    if (tid == 0) s_resid = s_nlead = 0;
    __syncthreads();  // the tables and counters are reset; s_dm is loaded

    // 1. Tokenize every line of the tile, pass_lines at a time.
    const uint8_t* src = a.lines + (size_t)tile * a.tile_lines * a.width;
    for (int l0 = 0; l0 < a.tile_lines; l0 += pass_lines) {
      const int l = l0 + my;
      const bool live_line = l < a.tile_lines;
      const int ntok = locust_tok::group_tokenize(
          live_line ? src + (size_t)l * a.width : nullptr, a.aligned, a.width, emits, 4 * nl,
          a.g_log, a.chunks, s_dm, row, slot);
      __syncwarp();
      if (live_line) {
        const int live = min(ntok, emits);
        uint32_t* out = keys + (size_t)l * emits * nl;
        int e = g / units, u = g % units;
        for (; e < emits; e += step_e, u += step_u) {
          if (u >= units) {
            u -= units;
            ++e;
            if (e >= emits) break;
          }
          uint32_t w[4];
          locust_tok::gather_unit(row, e < live ? slot[e] : 0, u * unit, unit_words, w);
          uint32_t* dst = out + e * nl + u * unit_words;
          // Little-endian bytes -> big-endian lanes.
          if (unit_words == 4)
            *reinterpret_cast<uint4*>(dst) =
                make_uint4(__byte_perm(w[0], 0, 0x0123), __byte_perm(w[1], 0, 0x0123),
                           __byte_perm(w[2], 0, 0x0123), __byte_perm(w[3], 0, 0x0123));
          else if (unit_words == 2)
            *reinterpret_cast<uint2*>(dst) =
                make_uint2(__byte_perm(w[0], 0, 0x0123), __byte_perm(w[1], 0, 0x0123));
          else
            *dst = __byte_perm(w[0], 0, 0x0123);
        }
        for (int s = g; s < emits; s += G) valid[l * emits + s] = s < live;
        if (g == 0 && ntok > emits) atomicAdd(&s_ovf, ntok - emits);
      }
      __syncwarp();  // the group's row and slots are reused in the next pass
    }
    __syncthreads();

    // 2. Exact within-tile dedupe: one leader per distinct key, with its count.
    for (int i = tid; i < n_emit; i += kThreads) {
      if (!valid[i]) continue;
      const uint32_t* key = keys + (size_t)i * nl;
      const uint32_t h1 = salted_fold(key, nl, 0x9E3779B9u, 1u);
      h1s[i] = h1;
      int d = h1 & (a.dd_slots - 1);
      for (;;) {
        const int cur = atomicCAS(&dd_head[d], -1, i);
        if (cur == -1 || same_key(keys + (size_t)cur * nl, key, nl)) {
          atomicAdd(&dd_count[d], 1);
          break;
        }
        d = (d + 1) & (a.dd_slots - 1);
      }
    }
    __syncthreads();
    // The leaders' list: the claimed dedupe slots, one shared atomic per
    // warp and 32 slots.
    for (int base = warp * 32; base < a.dd_slots; base += kThreads) {
      const int d = base + lane;
      const bool lead = dd_head[d] >= 0;
      const unsigned m = __ballot_sync(locust_tok::kFull, lead);
      int pos0 = 0;
      if (lane == 0 && m) pos0 = atomicAdd(&s_nlead, __popc(m));
      pos0 = __shfl_sync(locust_tok::kFull, pos0, 0);
      if (lead) leaders[pos0 + __popc(m & ((1u << lane) - 1u))] = d;
    }
    if (!synced) {
      grid.sync();  // every block's share of the table is zero
      synced = true;
    } else {
      __syncthreads();
    }

    // 3. Fold each leader into the block table; 4. strand to the residual.
    const int n_lead = s_nlead;
    for (int k = tid; k < n_lead; k += kThreads) {
      const int d = leaders[k];
      const int lead = dd_head[d], count = dd_count[d];
      const uint32_t* key = keys + (size_t)lead * nl;
      const uint32_t h1 = h1s[lead];
      const uint32_t step = salted_fold(key, nl, 0xC2B2AE3Du, 0x01000193u) | 1u;
      bool done = false;
      for (int p = 0; p < a.probes && !done; ++p) {
        const int t = (int)((h1 + (uint32_t)p * step) & (uint32_t)(a.slots - 1));
        int32_t* state = a.tab_state + t;
        int32_t* lanes = a.tab_lanes + (size_t)t * nl;
        int st = cas_acquire(state, kEmpty, kWriting);
        if (st == kEmpty) {  // claimed: write the key, then publish it
          put_lanes(lanes, key, nl);
          store_release(state, kReady);
          done = true;
        } else {
          while (st == kWriting) st = load_acquire(state);
          done = row_matches(lanes, key, nl);
        }
        if (done) atomicAdd(&a.tab_count[t], count);
      }
      if (!done) {
        const int r = atomicAdd(&s_resid, 1);
        if (r < a.resid_rows) {
          const size_t row_id = (size_t)tile * a.resid_rows + r;
          put_lanes(a.res_lanes + row_id * nl, key, nl);
          a.res_count[row_id] = count;
        } else {
          atomicOr(a.flag_word, 1);
        }
      }
    }
    __syncthreads();

    // The tile's unused residual rows are zero; every row's valid byte.
    const int used = min(s_resid, a.resid_rows);
    const size_t base = (size_t)tile * a.resid_rows;
    for (int i = used * nl + tid; i < a.resid_rows * nl; i += kThreads)
      a.res_lanes[base * nl + i] = 0;
    for (int r = tid; r < a.resid_rows; r += kThreads) {
      if (r >= used) a.res_count[base + r] = 0;
      a.res_valid[base + r] = r < used;
    }
    __syncthreads();  // s_resid, s_nlead and the tables are reset next
  }
  if (!synced) grid.sync();
  if (tid == 0 && s_ovf) atomicAdd(a.overflow, s_ovf);
  grid.sync();  // every count and the flag word are final

  for (long long t = (long long)blockIdx.x * kThreads + tid; t < a.slots;
       t += (long long)gridDim.x * kThreads)
    a.tab_valid[t] = __ldcg(a.tab_count + t) > 0;
  if (blockIdx.x == 0 && tid == 0) *a.flag = __ldcg(a.flag_word) != 0;
}

int dedupe_slots(int n_emit) {
  int d = 64;
  while (d < 2 * n_emit) d <<= 1;
  return d;
}

int align16(long long x) { return (int)((x + 15) & ~15LL); }

// Per device: the opt-in shared memory bound, set once as the kernel's
// dynamic bound; the SM count; and blocks per SM for a few shared-memory
// sizes.  Asked once per device and size.
struct DeviceInfo {
  int smem_max = -1, sms = 0;
  size_t smem[8] = {};
  int per_sm[8] = {};
  int next = 0;
};

cudaError_t grid_cap(int dev, size_t smem, int* cap) {
  static std::mutex mu;
  static DeviceInfo info[16];
  if (dev < 0 || dev >= 16) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(mu);
  DeviceInfo& di = info[dev];
  cudaError_t err;
  if (di.smem_max < 0) {
    int coop = 0, smem_max = 0;
    if ((err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                      dev)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&di.sms, cudaDevAttrMultiProcessorCount, dev)) !=
            cudaSuccess ||
        (err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev)) != cudaSuccess)
      return err;
    if (!coop) return cudaErrorCooperativeLaunchTooLarge;
    // Static shared memory (a few words) comes out of the same budget.
    if ((err = cudaFuncSetAttribute(fused_preagg_kernel,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    smem_max - 256)) != cudaSuccess)
      return err;
    di.smem_max = smem_max - 256;
  }
  if (smem > (size_t)di.smem_max) return cudaErrorInvalidConfiguration;
  for (int i = 0; i < 8; ++i)
    if (di.per_sm[i] > 0 && di.smem[i] == smem) {
      *cap = di.per_sm[i] * di.sms;
      return cudaSuccess;
    }
  int per_sm = 0;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_preagg_kernel,
                                                           kThreads, smem)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  di.smem[di.next] = smem;
  di.per_sm[di.next] = per_sm;
  di.next = (di.next + 1) % 8;
  *cap = per_sm * di.sms;
  return cudaSuccess;
}

}  // namespace

extern "C" int locust_fused_max_width() { return kMaxWidth; }
extern "C" int locust_fused_max_emits() { return kMaxEmits; }

// lines: uint8 [num_lines, width], num_lines a multiple of tile_lines.
// out: one buffer, every byte written by the launch, holding in order the
// int32 arrays
//   table lanes [slots, nl], table counts [slots], table states [slots],
//   residual lanes [n_res, nl], residual counts [n_res], overflow [1],
//   flag word [1]
// and then the bytes table valid [slots], residual valid [n_res], flag [1],
// with nl = key_width / 4 and n_res = num_lines / tile_lines * resid_rows;
// `slots` is a power of two; `out` is 16-byte aligned.  g_log, chunks: the
// line geometry (tokenize.cuh).  dev: the current device's index.
// Returns 0 when launched, else a cudaError_t.
extern "C" int locust_fused_preagg(const void* lines, long long num_lines, int width,
                                   int tile_lines, int emits, int key_width, int slots,
                                   int probes, int resid_rows, int g_log, int chunks, void* out,
                                   unsigned long long d0, unsigned long long d1,
                                   unsigned long long d2, unsigned long long d3, int dev,
                                   void* stream) {
  if (width < 1 || width > kMaxWidth || emits < 1 || emits > kMaxEmits ||
      key_width < 4 || key_width % 4 != 0 || tile_lines < 1 || num_lines < 0 ||
      num_lines % tile_lines != 0 || slots < 2 || (slots & (slots - 1)) != 0 ||
      probes < 1 || resid_rows < 0 || (long long)tile_lines * emits > (1 << 20) ||
      g_log < 0 || g_log > 5 || chunks < 1 || chunks > 4 || (16 * chunks << g_log) < width ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int nl = key_width / 4;
  const long long n_tiles = num_lines / tile_lines;
  if (n_tiles > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  const long long n_res = n_tiles * resid_rows;

  FusedArgs a;
  a.lines = static_cast<const uint8_t*>(lines);
  a.n_tiles = n_tiles;
  a.width = width;
  a.aligned = width % 16 == 0 && reinterpret_cast<uintptr_t>(lines) % 16 == 0;
  a.tile_lines = tile_lines;
  a.emits = emits;
  a.nl = nl;
  a.slots = slots;
  a.probes = probes;
  a.resid_rows = resid_rows;
  a.g_log = g_log;
  a.chunks = chunks;
  a.unit_words = key_width % 16 == 0 ? 4 : key_width % 8 == 0 ? 2 : 1;
  const int n_emit = tile_lines * emits;
  a.dd_slots = dedupe_slots(n_emit);
  const int pass_lines = kWarps * (32 >> g_log);
  long long off = (long long)n_emit * nl * 4;
  a.off_h1 = align16(off);
  a.off_dd_head = align16(a.off_h1 + 4LL * n_emit);
  a.off_dd_count = a.off_dd_head + 4 * a.dd_slots;
  a.off_leaders = a.off_dd_count + 4 * a.dd_slots;
  a.off_rows = align16(a.off_leaders + 4LL * n_emit);
  a.off_slots = a.off_rows + pass_lines * locust_tok::row_bytes(g_log, chunks);
  a.off_valid = a.off_slots + 4 * pass_lines * emits;
  const size_t smem = (size_t)align16(a.off_valid + (long long)n_emit);

  int32_t* o = static_cast<int32_t*>(out);
  a.tab_lanes = o;
  a.tab_count = a.tab_lanes + (size_t)slots * nl;
  a.tab_state = a.tab_count + slots;
  a.res_lanes = a.tab_state + slots;
  a.res_count = a.res_lanes + (size_t)n_res * nl;
  a.overflow = a.res_count + n_res;
  a.flag_word = a.overflow + 1;
  a.tab_valid = reinterpret_cast<uint8_t*>(a.flag_word + 1);
  a.res_valid = a.tab_valid + slots;
  a.flag = a.res_valid + n_res;
  a.d[0] = d0;
  a.d[1] = d1;
  a.d[2] = d2;
  a.d[3] = d3;

  int cap = 0;
  cudaError_t err = grid_cap(dev, smem, &cap);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = (unsigned)std::max(1LL, std::min<long long>(n_tiles, cap));
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(fused_preagg_kernel), grid,
                                    kThreads, args, smem, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
