// Fused map->aggregate kernel for Hopper (sm_90a): tokenize a block, total
// each tile's distinct keys, and fold them into one block-wide hash table,
// without writing the [L, E, K] token tensor to device memory.
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
// (K + 8) bytes per slot and per residual row); the table's 8,192 slots
// stay in the 50 MB L2.  The TPU kernel spells every table access as a
// one-hot f32 matrix product and de-duplicates a tile by a Gram matrix,
// because a TPU has no cheap gather or atomics; here both are hash tables
// with atomics.
//
// Design, one thread block per tile of `tile_lines` lines:
// 1. Each warp tokenizes lines with warp_tokenize_row (tokenize.cuh, the
//    tokenizer kernel's own code) and writes each emit's key as big-endian
//    32-bit lanes into shared memory.
// 2. Every valid emit is hashed (hash_pair's h1) and inserted into a
//    shared open-addressed table of at least 2x the tile's emits (so it
//    never fills): atomicCAS claims an empty slot for the emit's index,
//    a full-key compare finds the same key, and a shared atomicAdd counts
//    it.  Each claimed slot's emit is a leader carrying its tile count.
// 3. Each leader walks hash_pair's probe sequence
//    slot_p = (h1 + p * (h2 | 1)) & (slots - 1), p < probes, over the
//    block table in global memory.  A slot's state word goes
//    empty -> writing -> ready: the claimer (atomicCAS empty->writing)
//    writes the key lanes, fences, and publishes ready; a prober that
//    finds writing waits for ready (the writer waits on nothing, so this
//    ends), fences, compares the full key and atomicAdds its count.
// 4. A leader that no probe resolves takes a residual row of its tile
//    through a shared counter; past `resid_rows` it sets the sticky flag.
// The host zeroes the table and counters with cudaMemsetAsync before the
// launch; there is no grid-wide ordering inside it.  Counts are int32 and
// exact at any size.

#include <cstdint>
#include <cuda_runtime.h>

#include "tokenize.cuh"

namespace {

using locust_tok::DelimMask;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxWidth = 2048;    // bytes per line
constexpr int kMaxEmits = 256;     // tokens per line
constexpr int kEmpty = 0, kWriting = 1, kReady = 2;

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
  for (int j = 0; j < nl; ++j)
    if (a[j] != b[j]) return false;
  return true;
}

__device__ __forceinline__ int load_state(const int32_t* p) {
  return *reinterpret_cast<const volatile int32_t*>(p);
}

// Shared memory of one tile, carved in this order (4-byte aligned first).
struct TileSmem {
  uint32_t* keys;     // [n_emit * nl] big-endian key lanes
  uint32_t* h1;       // [n_emit]
  int* dd_head;       // [dd_slots] emit index of the slot's leader, -1 empty
  int* dd_count;      // [dd_slots] the leader's count in this tile
  int* slot_start;    // [kWarps * emits]
  int* slot_len;      // [kWarps * emits]
  uint8_t* rows;      // [kWarps * row_bytes]
  uint8_t* valid;     // [n_emit]
};

size_t tile_smem_bytes(int n_emit, int nl, int dd_slots, int emits, int row_bytes) {
  return (size_t)n_emit * nl * 4 + (size_t)n_emit * 4 + (size_t)dd_slots * 8 +
         (size_t)kWarps * emits * 8 + (size_t)kWarps * row_bytes + (size_t)n_emit;
}

__global__ void __launch_bounds__(kThreads)
fused_preagg_kernel(const uint8_t* __restrict__ lines, int width, int tile_lines,
                    int emits, int nl, int slots, int probes, int resid_rows,
                    int dd_slots, int32_t* tab_lanes, int32_t* tab_count,
                    int32_t* tab_state, int32_t* __restrict__ res_lanes,
                    int32_t* __restrict__ res_count, int32_t* overflow,
                    int32_t* flag, DelimMask dm) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int s_overflow, s_resid;
  const int n_emit = tile_lines * emits;
  const int row_bytes = (width + 3) & ~3;
  TileSmem s;
  s.keys = reinterpret_cast<uint32_t*>(smem);
  s.h1 = s.keys + (size_t)n_emit * nl;
  s.dd_head = reinterpret_cast<int*>(s.h1 + n_emit);
  s.dd_count = s.dd_head + dd_slots;
  s.slot_start = s.dd_count + dd_slots;
  s.slot_len = s.slot_start + kWarps * emits;
  s.rows = reinterpret_cast<uint8_t*>(s.slot_len + kWarps * emits);
  s.valid = s.rows + (size_t)kWarps * row_bytes;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < dd_slots; i += kThreads) {
    s.dd_head[i] = -1;
    s.dd_count[i] = 0;
  }
  if (threadIdx.x == 0) s_overflow = s_resid = 0;
  __syncthreads();  // the counters are zero before any warp adds to them

  // 1. Tokenize: warp w takes lines w, w + kWarps, ...
  uint8_t* row = s.rows + (size_t)warp * row_bytes;
  int* slot_start = s.slot_start + warp * emits;
  int* slot_len = s.slot_len + warp * emits;
  const uint8_t* tile = lines + (size_t)blockIdx.x * tile_lines * width;
  for (int l = warp; l < tile_lines; l += kWarps) {
    const uint8_t* src = tile + (size_t)l * width;
    for (int i = lane; i < width; i += 32) row[i] = src[i];
    __syncwarp();
    const int ntok = locust_tok::warp_tokenize_row(row, width, emits, nl * 4, dm,
                                                   slot_start, slot_len);
    const int live = min(ntok, emits);
    uint32_t* out = s.keys + (size_t)l * emits * nl;
    for (int w = lane; w < emits * nl; w += 32) {
      const int e = w / nl;
      const uint32_t word =
          e < live ? locust_tok::token_word(row, slot_start[e], slot_len[e], (w - e * nl) * 4)
                   : 0u;
      out[w] = __byte_perm(word, 0, 0x0123);  // little-endian bytes -> big-endian lane
    }
    for (int e = lane; e < emits; e += 32) s.valid[l * emits + e] = e < live;
    if (lane == 0 && ntok > emits) atomicAdd(&s_overflow, ntok - emits);
    __syncwarp();  // the row buffer is reused for the warp's next line
  }
  __syncthreads();

  // 2. Exact within-tile dedupe: one leader per distinct key, with its count.
  for (int i = threadIdx.x; i < n_emit; i += kThreads) {
    if (!s.valid[i]) continue;
    const uint32_t* key = s.keys + (size_t)i * nl;
    const uint32_t h1 = salted_fold(key, nl, 0x9E3779B9u, 1u);
    s.h1[i] = h1;
    int d = h1 & (dd_slots - 1);
    for (;;) {
      const int cur = atomicCAS(&s.dd_head[d], -1, i);
      if (cur == -1 || same_key(s.keys + (size_t)cur * nl, key, nl)) {
        atomicAdd(&s.dd_count[d], 1);
        break;
      }
      d = (d + 1) & (dd_slots - 1);
    }
  }
  __syncthreads();
  if (threadIdx.x == 0 && s_overflow) atomicAdd(overflow, s_overflow);

  // 3. Fold each leader into the block table; 4. strand to the residual.
  for (int d = threadIdx.x; d < dd_slots; d += kThreads) {
    const int lead = s.dd_head[d];
    if (lead < 0) continue;
    const int count = s.dd_count[d];
    const uint32_t* key = s.keys + (size_t)lead * nl;
    const uint32_t h1 = s.h1[lead];
    const uint32_t step = salted_fold(key, nl, 0xC2B2AE3Du, 0x01000193u) | 1u;
    bool done = false;
    for (int p = 0; p < probes && !done; ++p) {
      const int t = (int)((h1 + (uint32_t)p * step) & (uint32_t)(slots - 1));
      int st = load_state(&tab_state[t]);
      if (st == kEmpty) {
        st = atomicCAS(&tab_state[t], kEmpty, kWriting);
        if (st == kEmpty) {  // claimed: write the key, then publish it
          for (int j = 0; j < nl; ++j) tab_lanes[(size_t)t * nl + j] = (int32_t)key[j];
          __threadfence();
          atomicExch(&tab_state[t], kReady);
          atomicAdd(&tab_count[t], count);
          done = true;
          break;
        }
      }
      while (st == kWriting) st = load_state(&tab_state[t]);
      __threadfence();  // the key lanes published before `ready` are visible
      bool match = true;
      for (int j = 0; j < nl && match; ++j)
        match = (uint32_t)__ldcg(&tab_lanes[(size_t)t * nl + j]) == key[j];
      if (match) {
        atomicAdd(&tab_count[t], count);
        done = true;
      }
    }
    if (!done) {
      const int r = atomicAdd(&s_resid, 1);
      if (r < resid_rows) {
        const size_t row_id = (size_t)blockIdx.x * resid_rows + r;
        for (int j = 0; j < nl; ++j) res_lanes[row_id * nl + j] = (int32_t)key[j];
        res_count[row_id] = count;
      } else {
        atomicOr(flag, 1);
      }
    }
  }
}

int dedupe_slots(int n_emit) {
  int d = 64;
  while (d < 2 * n_emit) d <<= 1;
  return d;
}

}  // namespace

extern "C" int locust_fused_max_width() { return kMaxWidth; }
extern "C" int locust_fused_max_emits() { return kMaxEmits; }

// lines: uint8 [num_lines, width], num_lines a multiple of tile_lines.
// out: one int32 buffer, zeroed here, holding in order
//   table lanes [slots, nl], table counts [slots], table states [slots],
//   residual lanes [n_res, nl], residual counts [n_res], overflow [1],
//   flag [1]
// with nl = key_width / 4 and n_res = num_lines / tile_lines * resid_rows;
// `slots` is a power of two.
// Returns 0 when launched, else a cudaError_t.
extern "C" int locust_fused_preagg(const void* lines, long long num_lines, int width,
                                   int tile_lines, int emits, int key_width, int slots,
                                   int probes, int resid_rows, void* out,
                                   unsigned long long d0, unsigned long long d1,
                                   unsigned long long d2, unsigned long long d3,
                                   void* stream) {
  if (width < 1 || width > kMaxWidth || emits < 1 || emits > kMaxEmits ||
      key_width < 4 || key_width % 4 != 0 || tile_lines < 1 || num_lines < 0 ||
      num_lines % tile_lines != 0 || slots < 2 || (slots & (slots - 1)) != 0 ||
      probes < 1 || resid_rows < 0 ||
      (long long)tile_lines * emits > (1 << 20))
    return (int)cudaErrorInvalidValue;
  const int nl = key_width / 4;
  const long long n_tiles = num_lines / tile_lines;
  if (n_tiles > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  const long long n_res = n_tiles * resid_rows;
  int32_t* tab_lanes = static_cast<int32_t*>(out);
  int32_t* tab_count = tab_lanes + (size_t)slots * nl;
  int32_t* tab_state = tab_count + slots;
  int32_t* res_lanes = tab_state + slots;
  int32_t* res_count = res_lanes + (size_t)n_res * nl;
  int32_t* overflow = res_count + n_res;
  int32_t* flag = overflow + 1;
  const size_t out_bytes = ((size_t)slots * (nl + 2) + (size_t)n_res * (nl + 1) + 2) * 4;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(out, 0, out_bytes, st);
  if (err != cudaSuccess || n_tiles == 0) return (int)err;

  const int n_emit = tile_lines * emits;
  const int dd = dedupe_slots(n_emit);
  const size_t smem = tile_smem_bytes(n_emit, nl, dd, emits, (width + 3) & ~3);
  int dev = 0, smem_max = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                    dev)) != cudaSuccess)
    return (int)err;
  // Static shared memory (two ints) comes out of the same budget.
  if (smem + 64 > (size_t)smem_max) return (int)cudaErrorInvalidConfiguration;
  if ((err = cudaFuncSetAttribute(fused_preagg_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem)) != cudaSuccess)
    return (int)err;
  DelimMask dm{{d0, d1, d2, d3}};
  fused_preagg_kernel<<<(unsigned)n_tiles, kThreads, smem, st>>>(
      static_cast<const uint8_t*>(lines), width, tile_lines, emits, nl, slots, probes,
      resid_rows, dd, tab_lanes, tab_count, tab_state, res_lanes, res_count, overflow,
      flag, dm);
  return (int)cudaGetLastError();
}
