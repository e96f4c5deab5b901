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
// loads) and tokenizes it with warp_tokenize_row (tokenize.cuh, shared
// with the fused kernel).  Then the whole warp writes the line's E*K key
// bytes as coalesced 32-bit words, zero past each token's end and in
// every slot without a token.  No 3-D intermediate and no second pass over
// memory.  The TPU's 64-line tile and 128-multiple width are layout rules
// of the TPU and do not apply: any L, any W <= kMaxWidth, any
// E <= kMaxEmits and K a multiple of 4.

#include <cstdint>
#include <cuda_runtime.h>

#include "tokenize.cuh"

namespace {

using locust_tok::DelimMask;

constexpr int kWarps = 8;          // lines per block
constexpr int kMaxWidth = 2048;    // bytes per line
constexpr int kMaxEmits = 256;     // slots per line

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

  const int ntok = locust_tok::warp_tokenize_row(row, width, emits, key_width, dm,
                                                 slot_start, slot_len);
  const int live = min(ntok, emits);
  const int words = key_width / 4;
  uint32_t* out = reinterpret_cast<uint32_t*>(keys + line * emits * key_width);
  for (int w = lane; w < emits * words; w += 32) {
    const int e = w / words;
    const int kb = (w - e * words) * 4;
    out[w] = e < live ? locust_tok::token_word(row, slot_start[e], slot_len[e], kb) : 0u;
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
