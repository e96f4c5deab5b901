// PageRank's ordered gather-add: one sum per node of its in-edges'
// contributions, added in edge order onto a shared initial value.
//
// No TPU kernel corresponds to this one.  The JAX package's PageRank step
// is a scatter-add whose CPU compile adds each node's contributions in
// edge order; torch's index_add_ does the same on the CPU but in no fixed
// order on CUDA, so the card's ranks drifted in their last bits.  This
// kernel restores the CPU's order on the card:
//
//   total[v] = init;  for each in-edge e of v, in edge order:
//       total[v] = total[v] + (ranks[src[e]] * inv_deg[src[e]])
//
// with the product rounded to float32 before the add.  __fmul_rn and
// __fadd_rn keep nvcc from contracting the two into an FMA, which would
// round once and change the bits.
//
// Layout: the in-edges grouped by destination (a stable sort of dst, so
// each group keeps edge order), ``offsets[v] .. offsets[v + 1]`` the
// group of node v in ``src_by_dst``, both int64 (graphs past 2^31 edges
// index safely).  One warp per node: the 32 lanes gather 32 sources'
// ranks and inverse degrees and form their products in parallel, then
// every lane adds the 32 products in order (broadcast by shuffles), so
// the sum is the sequential one whatever the node's in-degree.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void gather_add_kernel(const float* __restrict__ init,
                                  const long long* __restrict__ offsets,
                                  const long long* __restrict__ src_by_dst,
                                  const float* __restrict__ ranks,
                                  const float* __restrict__ inv_deg,
                                  float* __restrict__ total, long long num_nodes) {
  const long long node = (long long)blockIdx.x * kWarpsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (node >= num_nodes) return;
  const long long begin = offsets[node];
  const long long end = offsets[node + 1];
  float acc = *init;
  for (long long base = begin; base < end; base += 32) {
    const long long e = base + lane;
    float prod = 0.0f;
    if (e < end) {
      const long long s = src_by_dst[e];
      prod = __fmul_rn(ranks[s], inv_deg[s]);
    }
    const int n = (int)(end - base < 32 ? end - base : 32);
    for (int j = 0; j < n; ++j) acc = __fadd_rn(acc, __shfl_sync(0xFFFFFFFFu, prod, j));
  }
  if (lane == 0) total[node] = acc;
}

}  // namespace

// init: float32 [1] on the device (the dangling share); offsets: int64
// [num_nodes + 1]; src_by_dst: int64 [offsets[num_nodes]]; ranks, inv_deg:
// float32 [num_nodes] indexed by source; total: float32 [num_nodes], every
// element written.  Returns cudaGetLastError() after the launch (0 =
// launched).
extern "C" int locust_pagerank_gather_add(const void* init, const void* offsets,
                                          const void* src_by_dst, const void* ranks,
                                          const void* inv_deg, void* total,
                                          long long num_nodes, void* stream) {
  if (num_nodes < 0) return (int)cudaErrorInvalidValue;
  if (num_nodes == 0) return (int)cudaGetLastError();
  const long long blocks = (num_nodes + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  gather_add_kernel<<<(unsigned)blocks, kWarpsPerBlock * 32, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(init), static_cast<const long long*>(offsets),
      static_cast<const long long*>(src_by_dst), static_cast<const float*>(ranks),
      static_cast<const float*>(inv_deg), static_cast<float*>(total), num_nodes);
  return (int)cudaGetLastError();
}
