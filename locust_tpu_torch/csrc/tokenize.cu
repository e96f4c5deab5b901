// Map-stage tokenizer for Hopper (sm_90a): one warp per line.
//
// Replaces the TPU kernel locust_tpu/ops/pallas/tokenize.py
// (_tokenize_kernel, launched by tokenize_block_pallas).  Same contract:
// for each line of a [L, W] uint8 block, the e-th token (e < E) goes to
// emit slot e as its first <= K bytes, NUL-padded; valid[l, e] says the
// slot holds a token; overflow[l] = max(ntok - E, 0) counts the dropped
// tokens.  A byte ends a token when it is in the delimiter set passed in
// `delim` (the strtok set plus NUL, CR and LF); bytes past the row end
// count as NUL.
//
// What bounds it on the card: bytes.  Each line reads W bytes and writes
// E*K + E bytes plus one int, and does a few integer operations per byte,
// far below the card's rate of operations.  The TPU kernel is a masked
// reduction over the whole line for every (slot, byte) pair, because a
// TPU has no cheap scalar gather; here a lane reads the bytes it needs.
//
// Design: the warp copies its line into shared memory (coalesced byte
// loads).  Lane j owns ceil(W/32) consecutive bytes, counts the token
// starts in them, and a warp shuffle scan turns the counts into token
// ids.  The lane holding a start with token id < E measures that token
// (up to K bytes) and records (start, length) for its slot in shared
// memory.  Then the whole warp writes the line's E*K key bytes as
// coalesced 32-bit words, zero past each token's end and in every slot
// without a token.  No 3-D intermediate and no second pass over memory.
// The TPU's 64-line tile and 128-multiple width are layout rules of the
// TPU and do not apply: any L, any W <= kMaxWidth, any E <= kMaxEmits and
// K a multiple of 4.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;          // lines per block
constexpr int kMaxWidth = 2048;    // bytes per line
constexpr int kMaxEmits = 256;     // slots per line

struct DelimMask {
  unsigned long long w[4];         // bit b set: byte b ends a token
};

__device__ __forceinline__ bool is_delim(const DelimMask& m, unsigned b) {
  return (m.w[b >> 6] >> (b & 63)) & 1ull;
}

__global__ void tokenize_kernel(const uint8_t* __restrict__ lines,
                                long long num_lines, int width, int emits,
                                int key_width, uint8_t* __restrict__ keys,
                                uint8_t* __restrict__ valid,
                                int32_t* __restrict__ overflow, DelimMask dm) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long line = (long long)blockIdx.x * kWarps + warp;
  if (line >= num_lines) return;  // warp-uniform: only __syncwarp below

  const int row_bytes = (width + 3) & ~3;
  uint8_t* row = smem + (size_t)warp * (row_bytes + 8 * emits);
  int* slot_start = reinterpret_cast<int*>(row + row_bytes);
  int* slot_len = slot_start + emits;

  const uint8_t* src = lines + line * width;
  for (int i = lane; i < width; i += 32) row[i] = src[i];
  __syncwarp();

  // Lane j owns bytes [b0, b1).
  const int per_lane = (width + 31) / 32;
  const int b0 = min(lane * per_lane, width);
  const int b1 = min(b0 + per_lane, width);
  const bool in0 = b0 > 0 && !is_delim(dm, row[b0 - 1]);

  int count = 0;
  bool prev_in = in0;
  for (int p = b0; p < b1; ++p) {
    const bool in = !is_delim(dm, row[p]);
    count += in && !prev_in;
    prev_in = in;
  }
  int incl = count;  // inclusive warp scan of the start counts
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += v;
  }
  const int ntok = __shfl_sync(0xffffffffu, incl, 31);

  int tid = incl - count;
  prev_in = in0;
  for (int p = b0; p < b1; ++p) {
    const bool in = !is_delim(dm, row[p]);
    if (in && !prev_in) {
      if (tid < emits) {
        int len = 0;
        while (len < key_width && p + len < width && !is_delim(dm, row[p + len])) ++len;
        slot_start[tid] = p;
        slot_len[tid] = len;
      }
      ++tid;
    }
    prev_in = in;
  }
  __syncwarp();

  const int live = min(ntok, emits);
  const int words = key_width / 4;
  uint32_t* out = reinterpret_cast<uint32_t*>(keys + line * emits * key_width);
  for (int w = lane; w < emits * words; w += 32) {
    const int e = w / words;
    const int kb = (w - e * words) * 4;
    uint32_t word = 0;
    if (e < live) {
      const int st = slot_start[e];
      const int len = slot_len[e];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (kb + i < len) word |= (uint32_t)row[st + kb + i] << (8 * i);
    }
    out[w] = word;
  }
  for (int e = lane; e < emits; e += 32) valid[line * emits + e] = e < live;
  if (lane == 0) overflow[line] = max(ntok - emits, 0);
}

}  // namespace

extern "C" int locust_tokenize_max_width() { return kMaxWidth; }
extern "C" int locust_tokenize_max_emits() { return kMaxEmits; }

// lines: uint8 [num_lines, width]; keys: uint8 [num_lines, emits, key_width];
// valid: bool [num_lines, emits]; overflow: int32 [num_lines].
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int locust_tokenize(const void* lines, long long num_lines, int width,
                               int emits, int key_width, void* keys, void* valid,
                               void* overflow, unsigned long long d0,
                               unsigned long long d1, unsigned long long d2,
                               unsigned long long d3, void* stream) {
  if (width < 1 || width > kMaxWidth || emits < 1 || emits > kMaxEmits ||
      key_width < 4 || key_width % 4 != 0)
    return (int)cudaErrorInvalidValue;
  if (num_lines <= 0) return (int)cudaGetLastError();
  DelimMask dm{{d0, d1, d2, d3}};
  const int row_bytes = (width + 3) & ~3;
  const size_t smem = (size_t)kWarps * (row_bytes + 8 * emits);
  const long long blocks = (num_lines + kWarps - 1) / kWarps;
  tokenize_kernel<<<(unsigned)blocks, kWarps * 32, smem, (cudaStream_t)stream>>>(
      static_cast<const uint8_t*>(lines), num_lines, width, emits, key_width,
      static_cast<uint8_t*>(keys), static_cast<uint8_t*>(valid),
      static_cast<int32_t*>(overflow), dm);
  return (int)cudaGetLastError();
}
