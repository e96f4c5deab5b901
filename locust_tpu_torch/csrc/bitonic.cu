// Bitonic sort for Hopper (sm_90a): shared-memory tiles plus global passes.
//
// Replaces the TPU kernel locust_tpu/ops/pallas/sort.py
// (_local_stages_kernel, launched by _run_local from bitonic_sort; the
// TPU version runs its cross-tile passes _run_cross as XLA code, here
// they are bitonic_cross_kernel).  Same contract as bitonic_sort: an
// ascending, not stable sort of a uint32 key padded to a power of two
// (at least 1024) with 0xFFFFFFFF, payloads moved alongside.  It runs the
// same Batcher network, and a compare-exchange swaps only when the keys
// differ, so the output permutation is the TPU kernel's.
//
// What bounds it on the card: bytes.  A compare-exchange is two loads,
// one compare and at most two stores, so every pass over device memory
// is bandwidth-bound.  The design cuts those passes:
//   * the network carries (key, row index), 8 bytes per element, instead
//     of the key and all payload operands (40 bytes at key_width 32);
//     the payload rows are gathered once at the end (bitonic_gather);
//   * a block holds a tile of 2^tile_bits elements in shared memory and
//     runs every substage whose distance is below the tile back to back
//     (bitonic_local_kernel): one read and one write of the tile for up
//     to tile_bits*(tile_bits+1)/2 substages;
//   * only substages with distance >= tile touch device memory, one
//     coalesced pass each (bitonic_cross_kernel).
// The launch plan (which substages each launch runs) is the Python
// wrapper's bitonic_schedule, the port's copy of the JAX launch plan.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxStages = 32;
constexpr int kMaxTileBits = 12;   // 2^12 * 8 bytes = 32 KB shared memory

struct Stages {
  int count;
  int s[kMaxStages];
  int t_hi[kMaxStages];
  int t_lo[kMaxStages];
};

__device__ __forceinline__ void compare_exchange(uint32_t& klo, uint32_t& khi,
                                                 uint32_t& ilo, uint32_t& ihi,
                                                 bool asc) {
  const bool swap = asc ? (khi < klo) : (khi > klo);
  if (swap) {
    const uint32_t k = klo; klo = khi; khi = k;
    const uint32_t i = ilo; ilo = ihi; ihi = i;
  }
}

// One block per tile.  init != 0: the first launch reads the caller's key
// (n elements; the pad beyond n is 0xFFFFFFFF) and numbers the rows.
__global__ void bitonic_local_kernel(uint32_t* __restrict__ key,
                                     uint32_t* __restrict__ idx,
                                     const uint32_t* __restrict__ in_key,
                                     long long n, int tile_bits, Stages st,
                                     int init) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int tile = 1 << tile_bits;
  uint32_t* sk = smem;
  uint32_t* si = smem + tile;
  const long long base = (long long)blockIdx.x << tile_bits;

  for (int i = threadIdx.x; i < tile; i += blockDim.x) {
    const long long g = base + i;
    if (init) {
      sk[i] = g < n ? in_key[g] : 0xFFFFFFFFu;
      si[i] = (uint32_t)g;
    } else {
      sk[i] = key[g];
      si[i] = idx[g];
    }
  }
  __syncthreads();

  for (int q = 0; q < st.count; ++q) {
    const int s = st.s[q];
    for (int t = st.t_hi[q]; t >= st.t_lo[q]; --t) {
      const int d = 1 << (t - 1);
      for (int p = threadIdx.x; p < tile / 2; p += blockDim.x) {
        const int lo = ((p >> (t - 1)) << t) | (p & (d - 1));
        const int hi = lo + d;
        const bool asc = (((base + lo) >> s) & 1) == 0;
        uint32_t klo = sk[lo], khi = sk[hi], ilo = si[lo], ihi = si[hi];
        compare_exchange(klo, khi, ilo, ihi, asc);
        sk[lo] = klo; sk[hi] = khi; si[lo] = ilo; si[hi] = ihi;
      }
      __syncthreads();
    }
  }

  for (int i = threadIdx.x; i < tile; i += blockDim.x) {
    key[base + i] = sk[i];
    idx[base + i] = si[i];
  }
}

// One thread per compare-exchange pair of substage (s, t), distance
// 2^(t-1) >= tile.
__global__ void bitonic_cross_kernel(uint32_t* __restrict__ key,
                                     uint32_t* __restrict__ idx,
                                     long long half, int s, int t) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= half) return;
  const long long d = 1ll << (t - 1);
  const long long lo = ((p >> (t - 1)) << t) | (p & (d - 1));
  const long long hi = lo + d;
  const bool asc = ((lo >> s) & 1) == 0;
  uint32_t klo = key[lo], khi = key[hi], ilo = idx[lo], ihi = idx[hi];
  compare_exchange(klo, khi, ilo, ihi, asc);
  key[lo] = klo; key[hi] = khi; idx[lo] = ilo; idx[hi] = ihi;
}

// out_key[r] = key[r]; out_rows[r, :] = rows[idx[r], :] for r < n.  A
// pad row (idx >= n) reaches the first n only when a real key is
// 0xFFFFFFFF; its payload is 0, as in the TPU kernel.
__global__ void bitonic_gather_kernel(const uint32_t* __restrict__ key,
                                      const uint32_t* __restrict__ idx,
                                      const int32_t* __restrict__ rows,
                                      long long n, int width,
                                      uint32_t* __restrict__ out_key,
                                      int32_t* __restrict__ out_rows) {
  const int w = width > 0 ? width : 1;  // width 0: keys only
  const long long total = n * w;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (long long)gridDim.x * blockDim.x) {
    const long long r = e / w;
    const int c = (int)(e - r * w);
    if (width > 0) {
      const long long src = idx[r];
      out_rows[e] = src < n ? rows[src * width + c] : 0;
    }
    if (c == 0) out_key[r] = key[r];
  }
}

}  // namespace

extern "C" int locust_bitonic_max_tile_bits() { return kMaxTileBits; }
extern "C" int locust_bitonic_max_stages() { return kMaxStages; }

// stages: host array of count triples (s, t_hi, t_lo).  key/idx: uint32
// [n_tiles << tile_bits] scratch; in_key: the caller's uint32 [n] key.
extern "C" int locust_bitonic_local(void* key, void* idx, const void* in_key,
                                    long long n, int tile_bits, long long n_tiles,
                                    const int* stages, int count, int init,
                                    void* stream) {
  if (tile_bits < 1 || tile_bits > kMaxTileBits || count < 0 || count > kMaxStages)
    return (int)cudaErrorInvalidValue;
  Stages st;
  st.count = count;
  for (int q = 0; q < count; ++q) {
    st.s[q] = stages[3 * q];
    st.t_hi[q] = stages[3 * q + 1];
    st.t_lo[q] = stages[3 * q + 2];
  }
  const int tile = 1 << tile_bits;
  const int threads = tile / 2 < 1024 ? tile / 2 : 1024;
  const size_t smem = (size_t)tile * 2 * sizeof(uint32_t);
  bitonic_local_kernel<<<(unsigned)n_tiles, threads, smem, (cudaStream_t)stream>>>(
      static_cast<uint32_t*>(key), static_cast<uint32_t*>(idx),
      static_cast<const uint32_t*>(in_key), n, tile_bits, st, init);
  return (int)cudaGetLastError();
}

extern "C" int locust_bitonic_cross(void* key, void* idx, long long n_pad, int s,
                                    int t, void* stream) {
  const long long half = n_pad / 2;
  const int threads = 256;
  const long long blocks = (half + threads - 1) / threads;
  bitonic_cross_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      static_cast<uint32_t*>(key), static_cast<uint32_t*>(idx), half, s, t);
  return (int)cudaGetLastError();
}

extern "C" int locust_bitonic_gather(const void* key, const void* idx,
                                     const void* rows, long long n, int width,
                                     void* out_key, void* out_rows, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const int threads = 256;
  long long blocks = (n * (width > 0 ? width : 1) + threads - 1) / threads;
  if (blocks > 65535ll * 32) blocks = 65535ll * 32;
  bitonic_gather_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      static_cast<const uint32_t*>(key), static_cast<const uint32_t*>(idx),
      static_cast<const int32_t*>(rows), n, width, static_cast<uint32_t*>(out_key),
      static_cast<int32_t*>(out_rows));
  return (int)cudaGetLastError();
}
