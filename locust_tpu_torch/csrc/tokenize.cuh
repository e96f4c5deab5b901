// Line tokenizer on bit masks, shared by the tokenizer kernel (tokenize.cu)
// and the fused map->aggregate kernel (fused_fold.cu), so that both cut the
// same tokens and count the same overflow.
//
// Contract of one line of `width` bytes: the e-th token (e < emits) is its
// first <= key_width bytes; a byte ends a token when it is in the
// delimiter set (the strtok set plus NUL, CR and LF); bytes past the row
// end count as NUL; the line drops max(ntok - emits, 0) tokens.
//
// Layout: a group of G = 2^g_log lanes (G <= 32, lanes aligned to G within
// the warp) takes one line; lane g owns the `chunks` 16-byte chunks at
// bytes [g * 16 * chunks, (g + 1) * 16 * chunks), at most 64 bytes, so
// that one 64-bit mask holds a bit per byte.  The wrapper picks G and
// chunks (ops/kernels/tokenize.line_geometry) with 16 * chunks * G >= width.
// A 128-byte line is 8 lanes x 16 bytes: a warp holds 4 lines at once.
//
// Steps, with no loop over bytes past the load:
//   * load the chunks as 16-byte vectors (bytes when the line is not
//     16-byte aligned) into registers and into the group's row in shared
//     memory; classify each byte through the 256-bit delimiter set in
//     shared memory into `in`, bit i = byte i is inside a token;
//   * starts = in & ~(in << 1 | carry), carry the previous lane's last bit;
//   * token ids: a __popc prefix over the group (shuffle scan);
//   * a token's end: __ffs of the delimiter bits after its start in the
//     lane's mask, else the first delimiter of a later lane (a suffix-min
//     shuffle scan); its length is capped at key_width;
//   * the lane holding a start with id < emits records (start | len << 16)
//     in slot[id].  A writer then assembles any 4-, 8- or 16-byte unit of a
//     slot's key from the row with __funnelshift_r (gather_unit).

#pragma once

#include <cstdint>

namespace locust_tok {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kNoDelim = 1 << 30;

// Bytes of the group's row buffer: the lanes' chunks plus room for
// gather_unit to read a 16-byte unit and one more word past any byte of a
// token.  A multiple of 16.
__host__ __device__ __forceinline__ int row_bytes(int g_log, int chunks) {
  return (16 * chunks << g_log) + 32;
}

// Copies the 256-bit delimiter set into shared memory (bit b of the eight
// words: byte b ends a token).  Every thread of the block calls it; the
// caller syncs the block before use.
__device__ __forceinline__ void load_delims(uint32_t* s_dm, unsigned long long d0,
                                            unsigned long long d1, unsigned long long d2,
                                            unsigned long long d3) {
  if (threadIdx.x < 8) {
    const unsigned long long d = threadIdx.x < 2 ? d0 : threadIdx.x < 4 ? d1
                               : threadIdx.x < 6 ? d2 : d3;
    s_dm[threadIdx.x] = (uint32_t)(d >> (32 * (threadIdx.x & 1)));
  }
}

// Bits of the 4 bytes of w that are inside a token (bit i: byte i).
__device__ __forceinline__ uint32_t in_bits(const uint32_t* s_dm, uint32_t w) {
  uint32_t m = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t b = (w >> (8 * i)) & 0xFFu;
    m |= ((~s_dm[b >> 5] >> (b & 31)) & 1u) << i;
  }
  return m;
}

// Tokenizes one line per group of G lanes; every lane of the warp calls
// it.  src: the line in global memory, or null when the group has no line
// (it then tokenizes an empty line and writes nothing but its row).
// aligned: src and width are multiples of 16.  Writes the line's bytes
// (zero from `width` to the end of the lanes' chunks) to `row` and
// slot[e] = start | len << 16 for every e < min(ntok, emits).  Returns
// ntok on every lane of the group.  The caller syncs the warp before it
// reads row or slot.
__device__ __forceinline__ int group_tokenize(const uint8_t* __restrict__ src, bool aligned,
                                              int width, int emits, int key_width, int g_log,
                                              int chunks, const uint32_t* s_dm, uint8_t* row,
                                              int* slot) {
  const int G = 1 << g_log;
  const int g = threadIdx.x & (G - 1);
  const int span = 16 * chunks;  // bytes of this lane, <= 64
  const int b0 = g * span;
  unsigned long long in = 0;
  for (int c = 0; c < chunks; ++c) {
    const int p = b0 + 16 * c;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (src != nullptr && p < width) {
      if (aligned) {
        v = __ldg(reinterpret_cast<const uint4*>(src + p));
      } else {
        uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int i = 0; i < 16; ++i)
          if (p + i < width) w[i >> 2] |= (uint32_t)__ldg(src + p + i) << (8 * (i & 3));
        v = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
    *reinterpret_cast<uint4*>(row + p) = v;
    const uint32_t m = in_bits(s_dm, v.x) | in_bits(s_dm, v.y) << 4 |
                       in_bits(s_dm, v.z) << 8 | in_bits(s_dm, v.w) << 12;
    in |= (unsigned long long)m << (16 * c);
  }
  const unsigned long long span_mask = span == 64 ? ~0ull : (1ull << span) - 1ull;
  // Bytes past the row end are NUL, whatever the set says of NUL.
  const int live_bytes = min(max(width - b0, 0), span);
  in &= live_bytes == 64 ? ~0ull : (1ull << live_bytes) - 1ull;

  // Token starts, with the previous lane's last byte as carry.
  unsigned long long carry = __shfl_up_sync(kFull, (in >> (span - 1)) & 1ull, 1, G);
  if (g == 0) carry = 0;
  const unsigned long long starts = in & ~((in << 1) | carry);
  const int count = __popcll(starts);
  int incl = count;
  for (int off = 1; off < G; off <<= 1) {
    const int v = __shfl_up_sync(kFull, incl, off, G);
    if (g >= off) incl += v;
  }
  const int ntok = __shfl_sync(kFull, incl, G - 1, G);

  // The first delimiter at or after each lane's first byte (suffix min;
  // the end of the lanes' bytes counts as one), and after this lane's last
  // byte (the next lane's).
  const unsigned long long delims = ~in & span_mask;
  int first = delims ? b0 + __ffsll((long long)delims) - 1 : g == G - 1 ? G * span : kNoDelim;
  for (int off = 1; off < G; off <<= 1) {
    const int v = __shfl_down_sync(kFull, first, off, G);
    if (g + off < G) first = min(first, v);
  }
  int after = __shfl_down_sync(kFull, first, 1, G);
  if (g == G - 1) after = G * span;

  int id = incl - count;
  unsigned long long s = starts;
  while (s && id < emits) {
    const int p = __ffsll((long long)s) - 1;
    s &= s - 1ull;
    const unsigned long long rest = delims >> p;
    const int end = rest ? b0 + p + __ffsll((long long)rest) - 1 : after;
    slot[id++] = (b0 + p) | min(end - b0 - p, key_width) << 16;
  }
  return ntok;
}

// Key bytes [kb, kb + 4 * nw) (nw = 1, 2 or 4) of the token in slot word
// `sw` as little-endian words (byte kb in the low 8 bits of w[0]), zero
// past the token's end.
__device__ __forceinline__ void gather_unit(const uint8_t* row, int sw, int kb, int nw,
                                            uint32_t (&w)[4]) {
  const int n = (sw >> 16) - kb;  // bytes of the token left at kb
#pragma unroll
  for (int i = 0; i < 4; ++i) w[i] = 0u;
  if (n <= 0) return;
  const int a = (sw & 0xFFFF) + kb;
  const uint32_t* rw = reinterpret_cast<const uint32_t*>(row) + (a >> 2);
  const uint32_t sh = 8u * (uint32_t)(a & 3);
  uint32_t x[5];
#pragma unroll
  for (int i = 0; i < 5; ++i) x[i] = i <= nw ? rw[i] : 0u;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int nb = n - 4 * i;
    const uint32_t v = __funnelshift_r(x[i], x[i + 1], sh);
    w[i] = i >= nw || nb <= 0 ? 0u : nb >= 4 ? v : v & ((1u << (8 * nb)) - 1u);
  }
}

}  // namespace locust_tok
