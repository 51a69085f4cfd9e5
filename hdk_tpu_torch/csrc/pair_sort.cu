// The (group, value) pairs of exact per-group quantiles, sorted group by
// group, for Hopper (sm_90a).
//
//     out[starts[g] .. starts[g] + count[g]) = the orderable keys of the
//     values of group g, ascending
//
// for the rows r with 0 <= gid[r] < G and valid[r] (no validity: every
// row).  A key is the value's 64-bit orderable image, bit for bit what
// kernels/pairsort.py::orderable_int64 gives a float64: +-0.0 -> 0, NaN ->
// 0x7FF8000000000000, a negative pattern with all but its sign bit
// flipped, so that signed order is value order.  `starts` are the
// exclusive prefix sums of the groups' counts, which the caller has
// already (the histogram of the rows a group).  The kernels allocate
// nothing; the caller hands `cursor` (G 64-bit words), `work` (G + 1
// int32) and `out` (n_rows keys: the first sum-of-counts hold the answer,
// the rest are left as they were).  The C entry point returns the first
// CUDA error.
//
//   hdk_pair_sort   kernels/pairsort.py::group_sorted_keys
//
// Replaces no TPU kernel.  The JAX package (and, before this kernel, the
// port) sorts the pairs with two stable device-wide sorts and moves the
// values through an int64 permutation, which a quantile throws away: it
// reads two positions of each group's run.  The least this route moves
// is 8 + 4 (+1) bytes read and 8 written a row to bucket the keys, 8 and
// 8 to sort each group.  On one H100 neither step reaches that: the
// scatter is bound by its atomics and scattered 8-byte writes, the block
// sort by its warps' ranking (PERF.md).  Its design:
//   * pair_scatter_kernel: one pass computes each row's key and writes it
//     at its group's next slot (a 64-bit atomic cursor a group, from
//     `starts`), so the key itself travels, never an index.  Order inside
//     a group is arbitrary; the sort below fixes it.  Rows of no group are
//     never written.
//   * pair_sort_warp_kernel: a group of at most kWarpMax keys is sorted by
//     one warp, a bitonic network in shared memory (8 groups a block, so
//     1e6 groups of ~100 rows run 125,000 full blocks, not 1e6 idle ones);
//     larger groups go onto a work list.
//   * pair_sort_block_kernel: one block of kBlockThreads sorts a listed
//     group of up to kCapacity keys, held in registers, by an LSD radix
//     sort of 8-bit digits through dynamic shared memory (the scatter
//     buffer, the per-warp digit counts and each key's rank in its warp:
//     10 bytes a key + 32 KB).  A key's rank among its warp's keys of
//     the same digit comes from eight ballots; digits equal across the
//     whole group are skipped.  Persistent blocks walk the list, so no
//     block launches for a group of the warp kernel.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarpMax = 512;       // keys a warp sorts (a power of two)
constexpr int kWarpGroups = 8;      // warps, so groups, a warp-kernel block
constexpr int kBlockThreads = 1024;
constexpr int kItems = 16;          // keys a thread of the block kernel
constexpr int kCapacity = kBlockThreads * kItems;  // 16384 keys a group
constexpr int kWarps = kBlockThreads / 32;
constexpr int kOctets = kWarps / 8;  // the digit scan's groups of 8 warps
constexpr int kRadix = 256;
constexpr int kScatterThreads = 256;
constexpr uint64_t kSign = 1ull << 63;  // signed order as unsigned order

__device__ __forceinline__ long long orderable(double x) {
  if (x != x) return 0x7FF8000000000000LL;
  if (x == 0.0) return 0;
  const long long b = __double_as_longlong(x);
  return b ^ ((b >> 63) & 0x7FFFFFFFFFFFFFFFLL);
}

__global__ void __launch_bounds__(kScatterThreads)
pair_scatter_kernel(const double* __restrict__ vals,
                    const int32_t* __restrict__ gid,
                    const uint8_t* __restrict__ valid, int64_t n_rows,
                    int64_t n_groups, unsigned long long* cursor,
                    long long* __restrict__ out) {
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n_rows; i += step) {
    const int32_t g = gid[i];
    if (g < 0 || g >= n_groups || (valid != nullptr && !valid[i])) continue;
    const long long key = orderable(vals[i]);
    const unsigned long long pos = atomicAdd(&cursor[g], 1ull);
    if (pos < static_cast<unsigned long long>(n_rows)) out[pos] = key;
  }
}

// One warp a group of at most kWarpMax keys; a larger group goes onto the
// block kernel's list (work[0] its length, work[1..] the groups).
__global__ void __launch_bounds__(kWarpGroups * 32)
pair_sort_warp_kernel(long long* keys, const long long* __restrict__ starts,
                      const long long* __restrict__ counts,
                      int64_t n_groups, int* work) {
  __shared__ unsigned long long buf[kWarpGroups][kWarpMax];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t g = static_cast<int64_t>(blockIdx.x) * kWarpGroups + w;
  if (g >= n_groups) return;
  const long long start = starts[g];
  const long long m = counts[g];
  if (m <= 1) return;
  if (m > kWarpMax) {
    if (lane == 0) work[1 + atomicAdd(work, 1)] = static_cast<int>(g);
    return;
  }
  int p = 2;
  while (p < m) p <<= 1;
  unsigned long long* a = buf[w];
  for (int i = lane; i < p; i += 32)
    a[i] = i < m ? static_cast<unsigned long long>(keys[start + i]) ^ kSign
                 : ~0ull;  // padding sorts last
  __syncwarp();
  for (int k = 2; k <= p; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int t = lane; t < (p >> 1); t += 32) {
        const int lo = ((t & ~(j - 1)) << 1) | (t & (j - 1));
        const int hi = lo + j;
        const bool up = (lo & k) == 0;
        const unsigned long long x = a[lo], y = a[hi];
        if ((x > y) == up) {
          a[lo] = y;
          a[hi] = x;
        }
      }
      __syncwarp();
    }
  }
  for (int i = lane; i < m; i += 32)
    keys[start + i] = static_cast<long long>(a[i] ^ kSign);
}

__device__ __forceinline__ unsigned long long warp_and(unsigned long long v) {
  for (int o = 16; o > 0; o >>= 1) v &= __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ unsigned long long warp_or(unsigned long long v) {
  for (int o = 16; o > 0; o >>= 1) v |= __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The lanes of `mask` whose 8-bit digit equals this lane's, from eight
// ballots (on the card, a sixth faster in the block kernel than
// __match_any_sync).
__device__ __forceinline__ unsigned match_digit(unsigned mask, unsigned d) {
  unsigned peers = mask;
#pragma unroll
  for (int b = 0; b < 8; ++b) {
    const unsigned set = __ballot_sync(mask, (d >> b) & 1);
    peers &= ((d >> b) & 1) ? set : ~set;
  }
  return peers;
}

// Dynamic shared memory: `cap` keys (the scatter buffer), kWarps x kRadix
// digit counts, `cap` 16-bit ranks.
size_t block_smem_bytes(int cap) {
  return static_cast<size_t>(cap) * 10 + kWarps * kRadix * 4;
}

// One block a listed group of at most `cap` (<= kCapacity) keys.  Thread t
// of warp w holds the keys at positions w * 32 * per + j * 32 + lane, j <
// per = ceil(m / kBlockThreads), so a warp's positions are contiguous and
// ranking its items in order j, then lane, keeps each pass stable.  What
// bounds it is that ranking: a warp ranks its items one after another
// (eight ballots, the leader's read and write of the digit's count, a
// shuffle), 57% of the kernel's clocks at 1e4 keys a group on the card;
// keeping the keys in shared memory instead of registers changed
// nothing.
__global__ void __launch_bounds__(kBlockThreads, 1)
pair_sort_block_kernel(long long* keys, const long long* __restrict__ starts,
                       const long long* __restrict__ counts,
                       const int* __restrict__ work, int cap) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned long long* sk = reinterpret_cast<unsigned long long*>(smem);
  unsigned* hist = reinterpret_cast<unsigned*>(sk + cap);
  unsigned short* rank = reinterpret_cast<unsigned short*>(
      hist + kWarps * kRadix);
  __shared__ unsigned octet[kOctets][kRadix];  // a digit's count an octet
  __shared__ unsigned scan_tot[kRadix / 32];
  __shared__ unsigned long long s_and, s_or;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  unsigned* wh = hist + w * kRadix;
  const int n_listed = work[0];
  for (int b = blockIdx.x; b < n_listed; b += gridDim.x) {
    const int g = work[1 + b];
    const long long start = starts[g];
    const int m = static_cast<int>(counts[g]);
    if (m > cap) continue;  // past the caller's largest count: not ours
    const int per = (m + kBlockThreads - 1) / kBlockThreads;
    const int base = w * 32 * per;
    __syncthreads();  // the last group's reads of s_and, s_or are done
    if (tid == 0) {
      s_and = ~0ull;
      s_or = 0;
    }
    unsigned long long key[kItems];
    unsigned long long k_and = ~0ull, k_or = 0;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      key[j] = ~0ull;
      const int p = base + j * 32 + lane;
      if (j < per && p < m) {
        key[j] = static_cast<unsigned long long>(keys[start + p]) ^ kSign;
        k_and &= key[j];
        k_or |= key[j];
      }
    }
    k_and = warp_and(k_and);
    k_or = warp_or(k_or);
    __syncthreads();
    if (lane == 0) {
      atomicAnd(&s_and, k_and);
      atomicOr(&s_or, k_or);
    }
    __syncthreads();
    const unsigned long long varies = s_and ^ s_or;
    for (int shift = 0; shift < 64; shift += 8) {
      if (((varies >> shift) & 0xFF) == 0) continue;  // one digit for all
      for (int i = tid; i < kWarps * kRadix; i += kBlockThreads) hist[i] = 0;
      __syncthreads();
      // each key's rank among its warp's keys of the same digit, in
      // position order; the warp's counts by digit in wh
#pragma unroll
      for (int j = 0; j < kItems; ++j) {
        if (j >= per || base + j * 32 >= m) break;  // the same for the warp
        const int p = base + j * 32 + lane;
        const bool live = p < m;
        const unsigned mask = __ballot_sync(0xffffffffu, live);
        if (live) {
          const unsigned d = static_cast<unsigned>(key[j] >> shift) & 0xFF;
          const unsigned peers = match_digit(mask, d);
          const int leader = __ffs(peers) - 1;
          unsigned before = 0;
          if (lane == leader) {
            before = wh[d];
            wh[d] = before + __popc(peers);
          }
          before = __shfl_sync(mask, before, leader);
          rank[p] = static_cast<unsigned short>(
              before + __popc(peers & ((1u << lane) - 1)));
        }
        __syncwarp();
      }
      __syncthreads();
      // wh[d] becomes where warp w's keys of digit d start: the digit's
      // start, then the counts of the warps before w.  First the scan over
      // the 8 warps of an octet, then over the octets and the digits.
      const int d = tid & (kRadix - 1), q = tid >> 8;
      {
        unsigned run = 0;
        for (int v = q * 8; v < q * 8 + 8; ++v) {
          const unsigned c = hist[v * kRadix + d];
          hist[v * kRadix + d] = run;
          run += c;
        }
        octet[q][d] = run;
      }
      __syncthreads();
      unsigned part[kOctets];
      unsigned tot = 0, incl = 0;
      if (tid < kRadix) {
#pragma unroll
        for (int o = 0; o < kOctets; ++o) {
          part[o] = octet[o][tid];
          tot += part[o];
        }
        incl = tot;
        for (int o = 1; o < 32; o <<= 1) {
          const unsigned v = __shfl_up_sync(0xffffffffu, incl, o);
          if (lane >= o) incl += v;
        }
        if (lane == 31) scan_tot[w] = incl;
      }
      __syncthreads();
      if (tid < kRadix) {
        unsigned off = incl - tot;
        for (int v = 0; v < w; ++v) off += scan_tot[v];
#pragma unroll
        for (int o = 0; o < kOctets; ++o) {
          octet[o][tid] = off;
          off += part[o];
        }
      }
      __syncthreads();
      {
        const unsigned off = octet[q][d];
        for (int v = q * 8; v < q * 8 + 8; ++v) hist[v * kRadix + d] += off;
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < kItems; ++j) {
        if (j >= per) break;
        const int p = base + j * 32 + lane;
        if (p < m) {
          const unsigned dj = static_cast<unsigned>(key[j] >> shift) & 0xFF;
          sk[wh[dj] + rank[p]] = key[j];
        }
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < kItems; ++j) {
        if (j >= per) break;
        const int p = base + j * 32 + lane;
        if (p < m) key[j] = sk[p];
      }
    }
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      if (j >= per) break;
      const int p = base + j * 32 + lane;
      if (p < m) keys[start + p] = static_cast<long long>(key[j] ^ kSign);
    }
  }
}

cudaError_t pair_sort(const double* vals, const int32_t* gid,
                      const uint8_t* valid, int64_t n_rows, int64_t n_groups,
                      int64_t max_count, const long long* starts,
                      const long long* counts, unsigned long long* cursor,
                      int* work, long long* out, cudaStream_t stream) {
  if (max_count > kCapacity || n_groups >= (1ll << 31))
    return cudaErrorInvalidValue;
  if (n_rows <= 0 || n_groups <= 0) return cudaSuccess;
  cudaError_t err = cudaMemcpyAsync(cursor, starts, n_groups * 8,
                                    cudaMemcpyDeviceToDevice, stream);
  if (err != cudaSuccess) return err;
  err = cudaMemsetAsync(work, 0, sizeof(int), stream);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  int64_t grid = (n_rows + kScatterThreads - 1) / kScatterThreads;
  if (grid > static_cast<int64_t>(sms) * 16)
    grid = static_cast<int64_t>(sms) * 16;
  pair_scatter_kernel<<<static_cast<unsigned>(grid), kScatterThreads, 0,
                        stream>>>(vals, gid, valid, n_rows, n_groups, cursor,
                                  out);
  err = cudaGetLastError();
  if (err != cudaSuccess || max_count <= 1) return err;
  const int64_t warp_blocks = (n_groups + kWarpGroups - 1) / kWarpGroups;
  pair_sort_warp_kernel<<<static_cast<unsigned>(warp_blocks),
                          kWarpGroups * 32, 0, stream>>>(out, starts, counts,
                                                         n_groups, work);
  err = cudaGetLastError();
  if (err != cudaSuccess || max_count <= kWarpMax) return err;
  const int cap = static_cast<int>((max_count + 7) & ~7ll);
  const size_t smem = block_smem_bytes(cap);
  err = cudaFuncSetAttribute(pair_sort_block_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, pair_sort_block_kernel, kBlockThreads, smem);
  if (err != cudaSuccess) return err;
  // resident blocks walk the list; never more than the groups
  int64_t blocks = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  if (blocks > n_groups) blocks = n_groups;
  pair_sort_block_kernel<<<static_cast<unsigned>(blocks), kBlockThreads,
                           smem, stream>>>(out, starts, counts, work, cap);
  return cudaGetLastError();
}

}  // namespace

// One part: the build compiles this file once, -DHDK_PART=0.
#ifndef HDK_PART
#error "compile with -DHDK_PART=<part> (kernels/build.py does)"
#endif

extern "C" {

int hdk_pair_sort(const double* vals, const int32_t* gid,
                  const uint8_t* valid, int64_t n_rows, int64_t n_groups,
                  int64_t max_count, const long long* starts,
                  const long long* counts, void* cursor, int* work,
                  long long* out, void* stream) {
  return pair_sort(vals, gid, valid, n_rows, n_groups, max_count, starts,
                   counts, static_cast<unsigned long long*>(cursor), work,
                   out, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
