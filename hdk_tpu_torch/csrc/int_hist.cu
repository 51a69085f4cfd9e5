// Integer histograms of the perfect-hash GROUP BY, for Hopper (sm_90a):
// K4, K3 and K2 of hdk_tpu, one kernel.
//
//   hdk_count_hist           hdk_tpu/ops/pallas_hist2.py::count_hist
//                            out[e] = rows with gid == e
//   hdk_seg_sums_exact_{i8,i16,i32,i64}
//                            hdk_tpu/ops/pallas_hist.py::seg_sums_exact
//                            out[s, e] = int64 sum of column s over the
//                            rows with gid == e
//   hdk_groupby_sums2_b8     hdk_tpu/ops/pallas_groupby.py::groupby_sums2
//                            out[s, e] = rows with gid == e whose bool
//                            column s is true
//
// Rows whose gid lies outside [0, E), negative included, drop out.  Sums
// wrap like int64 addition (u64 two's-complement adds), so they are exact
// and equal the plain versions bit for bit.  The TPU kernels were one-hot
// MXU contractions with f32 or int32 accumulators, E <= 4096 and N < 2^24
// a call; none of those limits applies here.  K4 is K3 with an implicit
// column of ones: `int_hist_kernel<CountTag, 1, ...>` reads the ids
// alone.  K2 is K3 over 0/1 bytes (`int_hist_kernel<uint8_t, S, ...>`): a
// bool column is read as bytes, any nonzero byte counting one.
//
// The group ids come from an int32 gid array or, on the perfect-hash route
// and for scalar aggregates, from the raw key columns (dense_gid.cuh): a
// template flag, kKeyed, picks the source, and the C entry points take a
// DenseKeys pointer, null for the array.
//
// What bounds them: device-memory bytes, 4 B of gid (or each key at its
// width) plus each column at its own width per row, read once; 8 B per
// output sum.  The first,
// generic template (K2's until it moved here) read 4 B of gid a thread, the
// slots row-major from a stacked (N, S) copy, and sent one atomic per row
// and slot to a handful of shared addresses at small E.  This kernel follows
// K1's design (hist.cu::k1_kernel) with what integers allow:
//   * 16 bytes of gid a lane (4 rows, 128 rows a warp step) and each
//     column's 4 values at their width (bool and int8: 4 B, int16: 8 B,
//     int32: 16 B, int64: 2 x 16 B), streaming loads, from up to kMaxCols
//     column pointers passed by value: the caller's columns, never stacked;
//   * a run of equal gids inside a lane's 4 rows adds up in registers;
//   * where the partials go (the wrapper picks from S, E and the type):
//       kLanePrivate    a copy per lane in shared memory, laid out so that
//                       lane l of every warp hits bank l: plain read-
//                       modify-write, no vote, no atomics (small S x E);
//       kBlockShared    one copy per block of 512-1024 threads, native
//                       32-bit shared atomics (ATOMS.ADD; the 64-bit add is
//                       a compare-and-swap loop); E beyond shared memory
//                       is split into ranges, a launch each, every launch
//                       reading gid (on one H100 this beat both global
//                       atomics and a thread-block cluster whose blocks
//                       each held a slice of E in distributed shared
//                       memory: PERF.md);
//       kGlobalAtomics  adds into the int64 output in device memory (RED).
//     The atomic modes match lanes only where a lane's gid equals its
//     lower neighbour's (sorted ids, a handful of entries): one vote
//     tells.  Then __match_any_sync groups the lanes and the lowest peer
//     adds the group's total alone: for counts and bools (a lane's run
//     sums to 0..4) popc(peers & ballot(bit b of the run's sum)) << b
//     over 3 bits, one ballot triple a slot; for other values a shuffle
//     tree.
//     In global mode a warp step whose 128 gids do not decrease (the sort
//     route's buffers, ~2 rows a gid) instead carries each gid's sum
//     across lanes with a segmented scan and issues one add per distinct
//     gid from consecutive lanes, so that a RED covers consecutive
//     entries (add_sorted_step; on one H100 this cut K4 over 50M sorted
//     entries from 0.86 to 0.67 ms: PERF.md).
//   * Partials are 32-bit for counts, bools, int8 and int16: each copy
//     sees at most INT32_MAX / max|v| rows (the launcher raises the grid to
//     keep under it), so no 32-bit partial overflows before it is
//     sign-extended into the u64 flush.  int32 and int64 columns keep
//     64-bit partials.
// Every block stays resident (or, under a row budget, as many as it takes)
// and walks the tiles, so its shared copy is zeroed and flushed once.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "dense_gid.cuh"

namespace {

using hdk::DenseKeys;

constexpr int kTileRows = 128;  // a warp step: 4 rows a lane
constexpr int kMaxCols = 8;
constexpr unsigned kFull = 0xffffffffu;
constexpr size_t kMaxSharedBytes = 232448;  // a block's most on sm_90

enum IntMode : int { kGlobalAtomics = 0, kBlockShared = 1, kLanePrivate = 2 };

// COUNT reads no column: every live row adds one.
struct CountTag {};

// P: the type of a partial sum, in registers and shared memory;
// kMaxAbs: the largest |value| of a row, which sets the row budget of a
// 32-bit partial.
template <typename T> struct Traits;
template <> struct Traits<CountTag> {
  using P = unsigned;
  static constexpr long long kMaxAbs = 1;
};
// bool columns as bytes: 0 or 1 a row, the row budget of counts
template <> struct Traits<uint8_t> {
  using P = unsigned;
  static constexpr long long kMaxAbs = 1;
};
template <> struct Traits<int8_t> {
  using P = unsigned;
  static constexpr long long kMaxAbs = 128;
};
template <> struct Traits<int16_t> {
  using P = unsigned;
  static constexpr long long kMaxAbs = 32768;
};
template <> struct Traits<int32_t> {
  using P = unsigned long long;
  static constexpr long long kMaxAbs = 0;  // 64-bit partials: no budget
};
template <> struct Traits<int64_t> {
  using P = unsigned long long;
  static constexpr long long kMaxAbs = 0;
};

template <typename T> struct Cols { const T* p[kMaxCols]; };

// Threads of a block.  A lane-private copy per thread keeps blocks small;
// a shared copy that fills shared memory leaves one block an SM, so those
// blocks are large enough to keep loads in flight (512 threads where a
// row's partials need more than 8 bytes, so that no thread spills).
template <typename T, int S, int kMode>
__host__ __device__ constexpr int threads_of() {
  return kMode == kBlockShared
             ? (S * sizeof(typename Traits<T>::P) <= 8 ? 1024 : 512)
             : 256;
}

// A partial as an int64 addend: a 32-bit partial holds the bit pattern of
// a sum that fits in int32 (the row budget sees to it), so it sign-extends.
__device__ __forceinline__ unsigned long long widen(unsigned p) {
  return static_cast<unsigned long long>(
      static_cast<long long>(static_cast<int>(p)));
}
__device__ __forceinline__ unsigned long long widen(unsigned long long p) {
  return p;
}

// four consecutive values of a column, sign-extended into partial type;
// a bool byte counts one when nonzero
__device__ __forceinline__ void load4(const uint8_t* p, unsigned (&v)[4]) {
  const uchar4 q = __ldcs(reinterpret_cast<const uchar4*>(p));
  v[0] = q.x != 0;
  v[1] = q.y != 0;
  v[2] = q.z != 0;
  v[3] = q.w != 0;
}
__device__ __forceinline__ void load4(const int8_t* p, unsigned (&v)[4]) {
  const char4 q = __ldcs(reinterpret_cast<const char4*>(p));
  v[0] = static_cast<unsigned>(static_cast<int>(q.x));
  v[1] = static_cast<unsigned>(static_cast<int>(q.y));
  v[2] = static_cast<unsigned>(static_cast<int>(q.z));
  v[3] = static_cast<unsigned>(static_cast<int>(q.w));
}
__device__ __forceinline__ void load4(const int16_t* p, unsigned (&v)[4]) {
  const short4 q = __ldcs(reinterpret_cast<const short4*>(p));
  v[0] = static_cast<unsigned>(static_cast<int>(q.x));
  v[1] = static_cast<unsigned>(static_cast<int>(q.y));
  v[2] = static_cast<unsigned>(static_cast<int>(q.z));
  v[3] = static_cast<unsigned>(static_cast<int>(q.w));
}
__device__ __forceinline__ void load4(const int32_t* p,
                                      unsigned long long (&v)[4]) {
  const int4 q = __ldcs(reinterpret_cast<const int4*>(p));
  v[0] = static_cast<unsigned long long>(static_cast<long long>(q.x));
  v[1] = static_cast<unsigned long long>(static_cast<long long>(q.y));
  v[2] = static_cast<unsigned long long>(static_cast<long long>(q.z));
  v[3] = static_cast<unsigned long long>(static_cast<long long>(q.w));
}
__device__ __forceinline__ void load4(const int64_t* p,
                                      unsigned long long (&v)[4]) {
  const longlong2 a = __ldcs(reinterpret_cast<const longlong2*>(p));
  const longlong2 b = __ldcs(reinterpret_cast<const longlong2*>(p) + 1);
  v[0] = static_cast<unsigned long long>(a.x);
  v[1] = static_cast<unsigned long long>(a.y);
  v[2] = static_cast<unsigned long long>(b.x);
  v[3] = static_cast<unsigned long long>(b.y);
}

__device__ __forceinline__ unsigned one(const uint8_t* p) { return *p != 0; }
__device__ __forceinline__ unsigned one(const int8_t* p) {
  return static_cast<unsigned>(static_cast<int>(*p));
}
__device__ __forceinline__ unsigned one(const int16_t* p) {
  return static_cast<unsigned>(static_cast<int>(*p));
}
__device__ __forceinline__ unsigned long long one(const int32_t* p) {
  return static_cast<unsigned long long>(static_cast<long long>(*p));
}
__device__ __forceinline__ unsigned long long one(const int64_t* p) {
  return static_cast<unsigned long long>(*p);
}

// one run's or group's sum of slot s into entry key: the block's shared
// copy, or the output in device memory
template <int kMode, typename P>
__device__ __forceinline__ void add(P* acc, unsigned long long* out, int s,
                                    int key, int n_entries, int64_t out_stride,
                                    P x) {
  if constexpr (kMode == kBlockShared) {
    atomicAdd(acc + s * n_entries + key, x);
  } else {
    atomicAdd(out + s * out_stride + key, widen(x));
  }
}

// A warp step of non-decreasing gids in global mode: one add per distinct
// gid, the step's adds issued from consecutive lanes in gid order, so a
// warp's RED instruction covers consecutive entries.  k holds the lane's
// keys after the lane fold (-1: none), in increasing order, v their sums.
// A key's rows may run across lanes: a segmented scan carries its sum up
// to the last lane that holds it, which alone writes it.  skey and sval
// are this warp's scratch of kTileRows entries.
template <int S, typename P>
__device__ __forceinline__ void add_sorted_step(
    const int (&k)[4], const P (&v)[S][4], int lane, int* skey, P* sval,
    unsigned long long* out, int64_t out_stride) {
  int nrun = 0, first = -1, last = -1;
  P c[S];  // the last run's sum, then its key's sum up to this lane
#pragma unroll
  for (int s = 0; s < S; ++s) c[s] = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (k[j] >= 0) {
      if (nrun == 0) first = k[j];
      last = k[j];
#pragma unroll
      for (int s = 0; s < S; ++s) c[s] = v[s][j];
      ++nrun;
    }
  }
  // does this lane's first key continue the lane below's last one?  (Every
  // lane takes part in each shuffle: none sits behind a && that may skip it.)
  const int below_last = __shfl_up_sync(kFull, last, 1);
  const bool cont = lane > 0 && first >= 0 && first == below_last;
  const int above_cont = __shfl_down_sync(kFull, cont ? 1 : 0, 1);
  const bool next_cont = lane < 31 && above_cont != 0;
  // segmented inclusive scan: a lane whose only key continues the lane
  // below adds that lane's carry
  bool head = !(cont && nrun == 1);
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    P up[S];
#pragma unroll
    for (int s = 0; s < S; ++s) up[s] = __shfl_up_sync(kFull, c[s], off);
    const int up_head = __shfl_up_sync(kFull, head ? 1 : 0, off);
    if (lane >= off && !head) {
#pragma unroll
      for (int s = 0; s < S; ++s) c[s] += up[s];
      head = up_head != 0;
    }
  }
  P below[S];  // the carry of the lane below, for a first run that ends here
#pragma unroll
  for (int s = 0; s < S; ++s) below[s] = __shfl_up_sync(kFull, c[s], 1);
  // this lane's adds: every run but a last one that the lane above goes on
  const int w = nrun - (nrun > 0 && next_cont ? 1 : 0);
  int pos = w;  // exclusive scan of w: this lane's first scratch slot
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int t = __shfl_up_sync(kFull, pos, off);
    if (lane >= off) pos += t;
  }
  const int total = __shfl_sync(kFull, pos, 31);
  pos -= w;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    int m = 0, p = pos;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (k[j] >= 0) {
        const bool is_last = m == nrun - 1;
        if (!(is_last && next_cont)) {
          P x = is_last ? c[s] : v[s][j];
          if (m == 0 && !is_last && cont) x += below[s];
          sval[p] = x;
          if (s == 0) skey[p] = k[j];
          ++p;
        }
        ++m;
      }
    }
    __syncwarp();
    for (int i = lane; i < total; i += 32)
      atomicAdd(out + s * out_stride + skey[i], widen(sval[i]));
    __syncwarp();
  }
}

// out[s * out_stride + e] += the sums of the rows with gid == e_lo + e,
// for 0 <= e < n_entries; `out` points at the range's first entry.  The
// ids come from `gid`, or with kKeyed from `keys` (dense_gid.cuh): a
// launch over one range of E derives them again, as it reads gid again.
template <typename T, int S, int kMode, bool kKeyed>
__global__ void __launch_bounds__(threads_of<T, S, kMode>())
    int_hist_kernel(const int32_t* __restrict__ gid, const DenseKeys keys,
                    const Cols<T> cols, int64_t n_rows, int e_lo,
                    int n_entries, int64_t out_stride,
                    unsigned long long* __restrict__ out) {
  constexpr bool kCount = std::is_same<T, CountTag>::value;
  // 0/1 values (counts, bools): group totals by ballots, not shuffles
  constexpr bool kUnit = Traits<T>::kMaxAbs == 1;
  constexpr int kThreads = threads_of<T, S, kMode>();
  constexpr int kWarps = kThreads / 32;
  using P = typename Traits<T>::P;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  P* acc = reinterpret_cast<P*>(smem_raw);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int cells = S * n_entries;  // one (S x E) copy, slot-major
  // global mode: each warp's scratch for a sorted step's adds
  P* sval = acc + warp * kTileRows;
  int* skey = reinterpret_cast<int*>(acc + kWarps * kTileRows) +
              warp * kTileRows;
  if (kMode != kGlobalAtomics) {
    const int copies = kMode == kLanePrivate ? kThreads : 1;
    for (int i = threadIdx.x; i < cells * copies; i += kThreads) acc[i] = 0;
    __syncthreads();
  }
  const unsigned below = (1u << lane) - 1u;  // lanes under this one
  const int64_t n_tiles = (n_rows + kTileRows - 1) / kTileRows;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kWarps;
  for (int64_t tile = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
       tile < n_tiles; tile += stride) {
    const int64_t r0 = tile * kTileRows + 4 * lane;
    int k[4];
    P v[S][4];
    if (r0 + 4 <= n_rows) {
      hdk::load_gid4<kKeyed, true>(gid, keys, r0, n_rows, k);
      if constexpr (!kCount) {
#pragma unroll
        for (int s = 0; s < S; ++s) load4(cols.p[s] + r0, v[s]);
      }
    } else {  // the ragged end
      hdk::load_gid4<kKeyed, false>(gid, keys, r0, n_rows, k);
      if constexpr (!kCount) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
          for (int s = 0; s < S; ++s)
            v[s][j] = r0 + j < n_rows ? one(cols.p[s] + r0 + j) : P(0);
        }
      }
    }
    if constexpr (kCount) {
#pragma unroll
      for (int j = 0; j < 4; ++j) v[0][j] = 1;
    }
    bool sorted_step = false;  // the step's 128 gids non-decreasing
    if constexpr (kMode == kGlobalAtomics) {
      const int below_last = __shfl_up_sync(kFull, k[3], 1);
      sorted_step = __all_sync(kFull, k[0] <= k[1] && k[1] <= k[2] &&
                                          k[2] <= k[3] &&
                                          (lane == 0 || below_last <= k[0]));
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {  // into [0, E) of this range, else -1
      const unsigned d =
          static_cast<unsigned>(k[j]) - static_cast<unsigned>(e_lo);
      k[j] = d < static_cast<unsigned>(n_entries) ? static_cast<int>(d) : -1;
    }
    // a run of equal gids in the lane adds into its first row
#pragma unroll
    for (int j = 3; j > 0; --j) {
      if (k[j] == k[j - 1]) {
#pragma unroll
        for (int s = 0; s < S; ++s) v[s][j - 1] += v[s][j];
        k[j] = -1;
      }
    }
    if constexpr (kMode == kLanePrivate) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (k[j] >= 0) {
#pragma unroll
          for (int s = 0; s < S; ++s)
            acc[(s * n_entries + k[j]) * kThreads + threadIdx.x] += v[s][j];
        }
      }
    } else if (sorted_step) {
      add_sorted_step<S>(k, v, lane, skey, sval, out, out_stride);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k[j];
        if (!__any_sync(kFull, key >= 0)) continue;  // warp-uniform
        const int prev = __shfl_up_sync(kFull, key, 1);
        if (!__any_sync(kFull, lane > 0 && key >= 0 && key == prev)) {
          if (key >= 0) {  // no run across lanes: each adds alone
#pragma unroll
            for (int s = 0; s < S; ++s)
              add<kMode>(acc, out, s, key, n_entries, out_stride, v[s][j]);
          }
          continue;
        }
        const unsigned peers = __match_any_sync(kFull, key);
        P x[S];
        if constexpr (kUnit) {
          // a lane's run sums to 0..4: the group's total, bit by bit
#pragma unroll
          for (int s = 0; s < S; ++s) {
            const unsigned c = v[s][j];
            x[s] = __popc(peers & __ballot_sync(kFull, c & 1u)) +
                   2u * __popc(peers & __ballot_sync(kFull, c & 2u)) +
                   4u * __popc(peers & __ballot_sync(kFull, c & 4u));
          }
        } else {
          // shuffle tree: each lane adds the value of its next remaining
          // peer above it; a lane whose rank among its peers is odd at a
          // level is done, so the lowest lane ends with the group's sum
          unsigned rest = peers & ~below & ~(1u << lane);
          unsigned rank = __popc(peers & below);
#pragma unroll
          for (int s = 0; s < S; ++s) x[s] = v[s][j];
          while (__any_sync(kFull, rest != 0)) {
            const int next = __ffs(rest);  // 1 + lane index, 0 if none
#pragma unroll
            for (int s = 0; s < S; ++s) {
              const P t = __shfl_sync(kFull, x[s], (next - 1) & 31);
              if (next) x[s] += t;
            }
            rest &= ~__ballot_sync(kFull, rank & 1u);
            rank >>= 1;
          }
        }
        if (key >= 0 && (peers & below) == 0) {
#pragma unroll
          for (int s = 0; s < S; ++s)
            add<kMode>(acc, out, s, key, n_entries, out_stride, x[s]);
        }
      }
    }
  }
  if constexpr (kMode == kLanePrivate) {
    __syncthreads();
    // a warp a cell: its lanes sum kThreads / 32 copies, then a shuffle
    for (int i = warp; i < cells; i += kWarps) {
      unsigned long long sum = 0;
      for (int t = lane; t < kThreads; t += 32)
        sum += widen(acc[i * kThreads + t]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_down_sync(kFull, sum, off);
      if (lane == 0 && sum != 0)
        atomicAdd(out + (i / n_entries) * out_stride + i % n_entries, sum);
    }
  } else if constexpr (kMode == kBlockShared) {
    __syncthreads();
    for (int i = threadIdx.x; i < cells; i += kThreads) {
      const unsigned long long sum = widen(acc[i]);
      if (sum != 0)
        atomicAdd(out + (i / n_entries) * out_stride + i % n_entries, sum);
    }
  }
}

template <typename T, int S, int kMode, bool kKeyed>
int launch_mode(const int32_t* gid, const DenseKeys& keys, const Cols<T>& cols,
                int64_t n_rows, int e_lo, int n_entries, int64_t out_stride,
                unsigned long long* out, cudaStream_t stream) {
  using P = typename Traits<T>::P;
  constexpr int kThreads = threads_of<T, S, kMode>();
  constexpr int kWarps = kThreads / 32;
  auto* kernel = int_hist_kernel<T, S, kMode, kKeyed>;
  const int64_t copy = static_cast<int64_t>(S) * n_entries * sizeof(P);
  const int64_t copies = kMode == kLanePrivate ? kThreads : 1;
  // global mode: a scratch of kTileRows keys and sums a warp
  const int64_t bytes =
      kMode == kGlobalAtomics
          ? static_cast<int64_t>(kWarps) * kTileRows * (sizeof(P) + 4)
          : copy * copies;
  if (bytes > static_cast<int64_t>(kMaxSharedBytes))
    return cudaErrorInvalidValue;
  const size_t smem = static_cast<size_t>(bytes);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return err;
  // every block stays resident and walks the tiles: its shared copy is
  // zeroed and flushed once
  int64_t grid = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  const int64_t n_tiles = (n_rows + kTileRows - 1) / kTileRows;
  const int64_t wanted = (n_tiles + kWarps - 1) / kWarps;
  if (grid > wanted) grid = wanted;
  if constexpr (Traits<T>::kMaxAbs > 0) {
    if (kMode != kGlobalAtomics) {
      // a warp walks at most ceil(n_tiles / (grid * kWarps)) tiles; keep
      // a block's rows under what a 32-bit partial can sum
      const int64_t budget_rows = INT32_MAX / Traits<T>::kMaxAbs;
      const int64_t tiles_per_warp = budget_rows / (kWarps * kTileRows);
      const int64_t at_least = (n_tiles + kWarps * tiles_per_warp - 1) /
                               (kWarps * tiles_per_warp);
      if (grid < at_least) grid = at_least;
    }
  }
  kernel<<<static_cast<unsigned>(grid), kThreads, smem, stream>>>(
      gid, keys, cols, n_rows, e_lo, n_entries, out_stride, out);
  return cudaGetLastError();
}

// the ids from `keys` where it is given, else from `gid`
template <typename T, int S>
int launch_s(const int32_t* gid, const DenseKeys* keys, const Cols<T>& cols,
             int64_t n_rows, int e_lo, int n_entries, int64_t out_stride,
             unsigned long long* out, int mode, cudaStream_t stream) {
  if (keys != nullptr) {
    const int err = hdk::check_keys(*keys);
    if (err != cudaSuccess) return err;
  }
  switch (mode) {
#define HDK_INT_MODE(M)                                                     \
  case M:                                                                   \
    return keys != nullptr                                                  \
               ? launch_mode<T, S, M, true>(gid, *keys, cols, n_rows, e_lo, \
                                            n_entries, out_stride, out,     \
                                            stream)                         \
               : launch_mode<T, S, M, false>(gid, DenseKeys{}, cols, n_rows, \
                                             e_lo, n_entries, out_stride,   \
                                             out, stream);
    HDK_INT_MODE(kLanePrivate)
    HDK_INT_MODE(kBlockShared)
    HDK_INT_MODE(kGlobalAtomics)
#undef HDK_INT_MODE
    default:
      return cudaErrorInvalidValue;
  }
}

bool bad_range(int64_t e_lo, int64_t n_entries) {
  return e_lo < 0 || n_entries > INT32_MAX || e_lo > INT32_MAX - n_entries;
}

// gid (or the key source's columns) and every column 16-byte aligned (the
// wrapper sees to it)
template <typename T>
int launch(const int32_t* gid, const void* const* ptrs, int64_t n_rows,
           int64_t n_slots, int64_t e_lo, int64_t n_entries,
           int64_t out_stride, unsigned long long* out, int mode,
           const DenseKeys* keys, cudaStream_t stream) {
  if (n_rows <= 0 || n_slots <= 0 || n_entries <= 0) return cudaSuccess;
  if (n_slots > kMaxCols || bad_range(e_lo, n_entries))
    return cudaErrorInvalidValue;
  Cols<T> cols{};
  for (int s = 0; s < n_slots; ++s) cols.p[s] = static_cast<const T*>(ptrs[s]);
  const int lo = static_cast<int>(e_lo);
  const int e = static_cast<int>(n_entries);
  switch (n_slots) {
#define HDK_INT_SLOTS(N)                                                    \
  case N:                                                                   \
    return launch_s<T, N>(gid, keys, cols, n_rows, lo, e, out_stride, out, \
                          mode, stream);
    HDK_INT_SLOTS(1)
    HDK_INT_SLOTS(2)
    HDK_INT_SLOTS(3)
    HDK_INT_SLOTS(4)
    HDK_INT_SLOTS(5)
    HDK_INT_SLOTS(6)
    HDK_INT_SLOTS(7)
    HDK_INT_SLOTS(8)
#undef HDK_INT_SLOTS
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Every entry point takes its ids from `gid`, or, where `keys` is not
// null, from the dense-key source it points at (gid is then not read).
// The build compiles this file once a part, -DHDK_PART=0..5 (counts,
// bool, int8, int16, int32, int64), each instantiating its own kernels.
#ifndef HDK_PART
#error "compile with -DHDK_PART=<part> (kernels/build.py does)"
#endif

extern "C" {

#if HDK_PART == 0
// counts of gid - e_lo in [0, n_entries) into out[0 .. n_entries)
int hdk_count_hist(const int32_t* gid, int64_t n_rows, int64_t e_lo,
                   int64_t n_entries, unsigned long long* out, int mode,
                   const DenseKeys* keys, void* stream) {
  if (n_rows <= 0 || n_entries <= 0) return cudaSuccess;
  if (bad_range(e_lo, n_entries)) return cudaErrorInvalidValue;
  return launch_s<CountTag, 1>(gid, keys, Cols<CountTag>{}, n_rows,
                               static_cast<int>(e_lo),
                               static_cast<int>(n_entries), n_entries, out,
                               mode, static_cast<cudaStream_t>(stream));
}
#endif

#define HDK_SEG_SUMS_EXACT(SUFFIX, T)                                       \
  int hdk_seg_sums_exact_##SUFFIX(                                          \
      const int32_t* gid, const void* const* cols, int64_t n_rows,          \
      int64_t n_slots, int64_t e_lo, int64_t n_entries, int64_t out_stride, \
      unsigned long long* out, int mode, const DenseKeys* keys,             \
      void* stream) {                                                       \
    return launch<T>(gid, cols, n_rows, n_slots, e_lo, n_entries,           \
                     out_stride, out, mode, keys,                           \
                     static_cast<cudaStream_t>(stream));                    \
  }
#if HDK_PART == 2
HDK_SEG_SUMS_EXACT(i8, int8_t)
#endif
#if HDK_PART == 3
HDK_SEG_SUMS_EXACT(i16, int16_t)
#endif
#if HDK_PART == 4
HDK_SEG_SUMS_EXACT(i32, int32_t)
#endif
#if HDK_PART == 5
HDK_SEG_SUMS_EXACT(i64, int64_t)
#endif
#undef HDK_SEG_SUMS_EXACT

#if HDK_PART == 1
// K2: bool columns (bytes 0 or 1), counts of true per entry
int hdk_groupby_sums2_b8(const int32_t* gid, const void* const* cols,
                         int64_t n_rows, int64_t n_slots, int64_t e_lo,
                         int64_t n_entries, int64_t out_stride,
                         unsigned long long* out, int mode,
                         const DenseKeys* keys, void* stream) {
  return launch<uint8_t>(gid, cols, n_rows, n_slots, e_lo, n_entries,
                         out_stride, out, mode, keys,
                         static_cast<cudaStream_t>(stream));
}
#endif

}  // extern "C"
