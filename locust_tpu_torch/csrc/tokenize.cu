// Map-stage tokenizer for Hopper (sm_90a): bit-mask tokenizing, one device
// op per call.
//
// Replaces the TPU kernel locust_tpu/ops/pallas/tokenize.py
// (_tokenize_kernel, launched by tokenize_block_pallas).  Same contract:
// for each line of a [L, W] uint8 block, the e-th token (e < E) goes to
// emit slot e as its first <= K bytes, NUL-padded; valid[l, e] says the
// slot holds a token; the block's overflow, sum over lines of
// max(ntok - E, 0), counts the dropped tokens.  A byte ends a token when
// it is in the delimiter set passed in `d0..d3` (the strtok set plus NUL,
// CR and LF); bytes past the row end count as NUL.
//
// What bounds it on the card: bytes.  Each line reads W bytes and writes
// E*K + E bytes, with a few integer operations per byte, far below the
// card's rate of operations.  The TPU kernel is a masked reduction over
// the whole line for every (slot, byte) pair, because a TPU has no cheap
// scalar gather; here a lane reads the bytes it needs.
//
// Design:
//   * group_tokenize (tokenize.cuh, shared with the fused kernel): a group
//     of G lanes per line loads it as 16-byte vectors, classifies bytes
//     into bit masks and finds starts, ids and ends with __popc, __ffs and
//     shuffle scans; no loop over bytes;
//   * the group then writes the line's E*K key bytes as 16-, 8- or 4-byte
//     units (the largest that divides K), each assembled in registers from
//     the row in shared memory (gather_unit), zero past each token's end
//     and in every slot without a token; (slot, unit) advance by a fixed
//     step, without a division;
//   * the overflow total is summed in the same launch: each block adds a
//     ticket and its lines' overflow, as one 64-bit atomic, to one of 16
//     group words; the last block of a group adds the group's sum to a top
//     word, and the last of those writes the total.  Every last adder sets
//     its word back to 0, and the wrapper keeps one zeroed scratch per
//     device and stream, so a call is one device op and needs no memset.
//     Two levels, so that no word takes more than 16 of the blocks'
//     atomics in turn: atomics on one word serialize in L2.
// The TPU's 64-line tile and 128-multiple width are layout rules of the
// TPU and do not apply: any L, any W <= kMaxWidth, any E <= kMaxEmits and
// K a multiple of 4.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

#include "tokenize.cuh"

namespace {

constexpr int kMaxWarps = 4;       // warps per block
constexpr int kMaxWidth = 2048;    // bytes per line
constexpr int kMaxEmits = 256;     // slots per line
constexpr int kSmemBudget = 47 * 1024;  // dynamic shared memory, under the 48 KB default
constexpr int kTicketGroups = 16;      // first-level words of the overflow total

__global__ void __launch_bounds__(kMaxWarps * 32)
tokenize_kernel(const uint8_t* __restrict__ lines, long long num_lines, int width,
                bool aligned, int emits, int key_width, int g_log, int chunks, int unit_words,
                uint8_t* __restrict__ keys, uint8_t* __restrict__ valid,
                int32_t* __restrict__ total, unsigned long long* scratch,
                unsigned long long d0,
                unsigned long long d1, unsigned long long d2, unsigned long long d3) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ uint32_t s_dm[8];
  __shared__ int s_ovf;
  locust_tok::load_delims(s_dm, d0, d1, d2, d3);
  if (threadIdx.x == 0) s_ovf = 0;
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int G = 1 << g_log, per_warp = 32 >> g_log, grp = lane >> g_log, g = lane & (G - 1);
  const int rb = locust_tok::row_bytes(g_log, chunks);
  const int warps = blockDim.x >> 5;
  // This group's row and slots: rows of all groups first, then slots.
  const int my = warp * per_warp + grp;
  uint8_t* row = smem + (size_t)my * rb;
  int* slot = reinterpret_cast<int*>(smem + (size_t)warps * per_warp * rb) + (size_t)my * emits;

  const long long line = (long long)blockIdx.x * warps * per_warp + my;
  const bool live_line = line < num_lines;
  const int ntok = locust_tok::group_tokenize(live_line ? lines + line * width : nullptr,
                                              aligned, width, emits, key_width, g_log, chunks,
                                              s_dm, row, slot);
  __syncwarp();
  int ovf = 0;
  if (live_line) {
    const int live = min(ntok, emits);
    const int unit = 4 * unit_words, units = key_width / unit;  // units per slot
    uint8_t* out = keys + line * emits * key_width;
    // Unit f = g + j * G is (slot e, unit u) = divmod(f, units).
    const int step_e = G / units, step_u = G % units;
    int e = g / units, u = g % units;
    for (; e < emits; e += step_e, u += step_u) {
      if (u >= units) {
        u -= units;
        ++e;
        if (e >= emits) break;
      }
      uint32_t w[4];
      locust_tok::gather_unit(row, e < live ? slot[e] : 0, u * unit, unit_words, w);
      uint8_t* dst = out + e * key_width + u * unit;
      if (unit_words == 4)
        *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
      else if (unit_words == 2)
        *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
      else
        *reinterpret_cast<uint32_t*>(dst) = w[0];
    }
    for (int s = g; s < emits; s += G) valid[line * emits + s] = s < live;
    if (g == 0) ovf = max(ntok - emits, 0);
  }
  ovf = __reduce_add_sync(locust_tok::kFull, ovf);
  if (lane == 0 && ovf) atomicAdd(&s_ovf, ovf);
  __syncthreads();
  if (threadIdx.x == 0) {
    // Two levels of tickets, each word (count << 32 | sum): block b adds
    // to group word b % kTicketGroups; a group's last block adds the
    // group's sum to the top word, whose last adder writes the total.
    // Each last adder sets its word back to 0.
    const unsigned grp = blockIdx.x % kTicketGroups;
    const unsigned in_grp = (gridDim.x - grp + kTicketGroups - 1) / kTicketGroups;
    const unsigned long long old = atomicAdd(&scratch[grp], (1ull << 32) | (unsigned)s_ovf);
    if ((unsigned)(old >> 32) == in_grp - 1) {
      const unsigned sum = (unsigned)old + (unsigned)s_ovf;
      scratch[grp] = 0;
      const unsigned groups = min(gridDim.x, (unsigned)kTicketGroups);
      const unsigned long long top = atomicAdd(&scratch[kTicketGroups], (1ull << 32) | sum);
      if ((unsigned)(top >> 32) == groups - 1) {
        *total = (int32_t)((unsigned)top + sum);
        scratch[kTicketGroups] = 0;
      }
    }
  }
}

}  // namespace

extern "C" int locust_tokenize_max_width() { return kMaxWidth; }
extern "C" int locust_tokenize_max_emits() { return kMaxEmits; }

// lines: uint8 [num_lines, width]; keys: uint8 [num_lines, emits, key_width];
// valid: bool [num_lines, emits]; total: int32 [1], the overflow total;
// scratch: uint64 [kTicketGroups + 1], zero before the call and left zero
// by it (one per device and stream).  g_log, chunks: the line geometry
// (16 * chunks * 2^g_log >= width, chunks <= 4).
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int locust_tokenize(const void* lines, long long num_lines, int width,
                               int emits, int key_width, int g_log, int chunks, void* keys,
                               void* valid, void* total, void* scratch,
                               unsigned long long d0, unsigned long long d1,
                               unsigned long long d2, unsigned long long d3, void* stream) {
  if (width < 1 || width > kMaxWidth || emits < 1 || emits > kMaxEmits ||
      key_width < 4 || key_width % 4 != 0 || num_lines < 0 ||
      g_log < 0 || g_log > 5 || chunks < 1 || chunks > 4 || (16 * chunks << g_log) < width)
    return (int)cudaErrorInvalidValue;
  const int per_warp = 32 >> g_log;
  const size_t per_warp_smem =
      (size_t)per_warp * (locust_tok::row_bytes(g_log, chunks) + 4 * (size_t)emits);
  const int warps = (int)std::min<size_t>(kMaxWarps, std::max<size_t>(1, kSmemBudget / per_warp_smem));
  const long long per_block = (long long)warps * per_warp;
  const long long blocks = std::max(1LL, (num_lines + per_block - 1) / per_block);
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  const int unit_words = key_width % 16 == 0 ? 4 : key_width % 8 == 0 ? 2 : 1;
  const bool aligned = width % 16 == 0 && reinterpret_cast<uintptr_t>(lines) % 16 == 0;
  tokenize_kernel<<<(unsigned)blocks, warps * 32, warps * per_warp_smem,
                    (cudaStream_t)stream>>>(
      static_cast<const uint8_t*>(lines), num_lines, width, aligned, emits, key_width, g_log,
      chunks, unit_words, static_cast<uint8_t*>(keys), static_cast<uint8_t*>(valid),
      static_cast<int32_t*>(total), static_cast<unsigned long long*>(scratch), d0, d1,
      d2, d3);
  return (int)cudaGetLastError();
}
