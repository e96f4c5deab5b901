// Warp-per-line tokenizer, shared by the tokenizer kernel (tokenize.cu) and
// the fused map->aggregate kernel (fused_fold.cu), so that both cut the
// same tokens and count the same overflow.
//
// Contract of one line: the e-th token (e < E) is its first <= K bytes; a
// byte ends a token when it is in the delimiter set (the strtok set plus
// NUL, CR and LF); bytes past the row end count as NUL; the line drops
// max(ntok - E, 0) tokens.
//
// Design: the line sits in shared memory.  Lane j owns ceil(W/32)
// consecutive bytes, counts the token starts in them, and a warp shuffle
// scan turns the counts into token ids.  The lane holding a start with
// token id < E measures that token (up to K bytes) and records (start,
// length) for its slot.

#pragma once

#include <cstdint>

namespace locust_tok {

struct DelimMask {
  unsigned long long w[4];         // bit b set: byte b ends a token
};

__device__ __forceinline__ bool is_delim(const DelimMask& m, unsigned b) {
  return (m.w[b >> 6] >> (b & 63)) & 1ull;
}

// The whole warp calls this for one line held in shared memory (`row`,
// `width` bytes).  Writes slot_start[e] and slot_len[e] for every
// e < min(ntok, emits), then syncs the warp.  Returns ntok on every lane.
__device__ __forceinline__ int warp_tokenize_row(const uint8_t* row, int width,
                                                 int emits, int key_width,
                                                 const DelimMask& dm,
                                                 int* slot_start, int* slot_len) {
  const int lane = threadIdx.x & 31;
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
  return ntok;
}

// Key bytes [kb, kb + 4) of the token at `start` of length `len` as one
// little-endian word (byte kb in the low 8 bits), zero past the token.
__device__ __forceinline__ uint32_t token_word(const uint8_t* row, int start,
                                               int len, int kb) {
  uint32_t word = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (kb + i < len) word |= (uint32_t)row[start + kb + i] << (8 * i);
  return word;
}

}  // namespace locust_tok
