// K1 of the perfect-hash GROUP BY, for Hopper (sm_90a): per-gid float64
// sums of float columns.
//
//     out[s, e] = sum of column s over the rows r with gid[r] == e
//
// for columns s < S and entries 0 <= e < E.  Rows whose gid lies outside
// [0, E), negative included, are skipped: there are no dead-row sentinels.
// The kernel allocates nothing; the caller zeroes `out`.  Each C entry
// point returns cudaGetLastError() after the launch.
//
//   hdk_groupby_sums_cols_{f32,f64}   ops/pallas_groupby.py::groupby_sums
//
// The integer histograms, K2 (bool counts), K3 (exact integer sums) and K4
// (counts), are one kernel of their own in int_hist.cu.
//
// The group ids come from an int32 gid array or, on the perfect-hash route
// and for scalar aggregates, from the raw key columns (dense_gid.cuh): the
// template flag kKeyed picks the source, and the C entry points take a
// DenseKeys pointer, null for the array.

#include <cuda_runtime.h>

#include <cstdint>

#include "dense_gid.cuh"

namespace {

using hdk::DenseKeys;

__device__ __forceinline__ void atomic_add(double* p, double v) {
  atomicAdd(p, v);
}

// -- K1: per-gid float64 sums of float columns --------------------------------
//
// Replaces hdk_tpu/ops/pallas_groupby.py::groupby_sums, a one-hot MXU
// contraction with float32 accumulators.  What it computes stays: per-gid
// float64 sums of S float32 or float64 columns, rows with gid outside [0, E)
// dropped.  The mechanism is Hopper's.
//
// What bounds it: bytes, 4 (or the keys' bytes) + S * sizeof(T) per row
// read once, plus 8 * S * E written.  The first, generic histogram
// template lost to contention instead: at E = 7 or 10 every lane of every
// warp added into a handful of shared addresses, and it read rows
// row-major, so the caller stacked the columns into an (N, S) copy first.
// This kernel:
//   * reads the caller's columns where they lie: up to kMaxCols pointers in a
//     by-value parameter struct (more columns take several launches);
//   * loads 16 bytes a lane (an int4 of gid, a float4 or two double2 of each
//     column), so a warp covers kTileRows = 128 consecutive rows a step;
//   * adds a run of equal gids inside a lane's 4 rows in registers;
//   * aggregates the warp: __match_any_sync groups the lanes by gid, a
//     shuffle tree sums each group into its lowest lane, and that lane alone
//     writes: one write per distinct gid per warp step per slot, not 32;
//   * at small E gives each warp a private (S x E) copy in shared memory,
//     written without atomics (the lanes that write in one step hold distinct
//     gids); the copies merge once at the end of the block and flush to
//     global memory with atomics.  Larger E shares one copy per block
//     (shared atomics), and beyond shared memory the writes go to global
//     memory (atomics).
// Where warps rarely hold equal gids (random ids over many entries), the
// match costs more than the writes it saves.  So with shared or global
// atomics a warp step first asks whether any lane's gid equals its lower
// neighbour's (a run across lanes: sorted ids, or a handful of entries);
// if none does, each lane writes its own runs.  Warp-private copies always
// match: their writes are plain.  The wrapper picks the mode from S and E.
// Sums are slot-major, out[s * E + e], in shared memory too: a warp's
// gids spread over the banks, and a sorted warp's global writes coalesce.
// Hopper has no shared-memory f64 add: a shared atomicAdd compiles to a
// compare-and-swap loop (ATOMS.CAST.SPIN.64); the global one is native
// (REDG.E.ADD.F64).  The summation order varies from run to run.

constexpr int kMaxCols = 8;
constexpr int kK1Threads = 256;
constexpr int kTileRows = 128;  // a warp step: 4 rows a lane
constexpr unsigned kFull = 0xffffffffu;
constexpr size_t kMaxSharedBytes = 232448;  // a block's most on sm_90

// where the warps' partial sums go
enum K1Mode : int { kGlobalAtomics = 0, kBlockShared = 1, kWarpPrivate = 2 };

template <typename T> struct Cols { const T* p[kMaxCols]; };

// four consecutive values of a column as doubles, in 16-byte streaming loads
__device__ __forceinline__ void load4(const float* p, double (&v)[4]) {
  const float4 q = __ldcs(reinterpret_cast<const float4*>(p));
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}
__device__ __forceinline__ void load4(const double* p, double (&v)[4]) {
  const double2 a = __ldcs(reinterpret_cast<const double2*>(p));
  const double2 b = __ldcs(reinterpret_cast<const double2*>(p) + 1);
  v[0] = a.x;
  v[1] = a.y;
  v[2] = b.x;
  v[3] = b.y;
}

template <typename T, int S, int kMode, bool kKeyed>
__global__ void __launch_bounds__(kK1Threads)
    k1_kernel(const int32_t* __restrict__ gid, const DenseKeys keys,
              const Cols<T> cols, int64_t n_rows, int64_t n_entries,
              double* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* acc = reinterpret_cast<double*>(smem_raw);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int64_t cells = n_entries * S;  // one (S x E) copy, slot-major
  if (kMode != kGlobalAtomics) {
    const int64_t total = kMode == kWarpPrivate ? cells * warps : cells;
    for (int64_t i = threadIdx.x; i < total; i += blockDim.x) acc[i] = 0.0;
    __syncthreads();
  }
  double* dst = kMode == kWarpPrivate   ? acc + warp * cells
                : kMode == kBlockShared ? acc
                                        : out;
  const unsigned below = (1u << lane) - 1u;  // lanes under this one
  const int64_t n_tiles = (n_rows + kTileRows - 1) / kTileRows;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * warps;
  for (int64_t tile = static_cast<int64_t>(blockIdx.x) * warps + warp;
       tile < n_tiles; tile += stride) {
    const int64_t r0 = tile * kTileRows + 4 * lane;
    int k[4];
    double v[S][4];
    if (r0 + 4 <= n_rows) {
      hdk::load_gid4<kKeyed, true>(gid, keys, r0, n_rows, k);
#pragma unroll
      for (int s = 0; s < S; ++s) load4(cols.p[s] + r0, v[s]);
    } else {  // the ragged end
      hdk::load_gid4<kKeyed, false>(gid, keys, r0, n_rows, k);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool in = r0 + j < n_rows;
#pragma unroll
        for (int s = 0; s < S; ++s)
          v[s][j] = in ? static_cast<double>(cols.p[s][r0 + j]) : 0.0;
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (k[j] < 0 || k[j] >= n_entries) k[j] = -1;  // drops out
    // a run of equal gids in the lane adds into its first row
#pragma unroll
    for (int j = 3; j > 0; --j) {
      if (k[j] == k[j - 1]) {
#pragma unroll
        for (int s = 0; s < S; ++s) v[s][j - 1] += v[s][j];
        k[j] = -1;
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key = k[j];
      if (!__any_sync(kFull, key >= 0)) continue;  // warp-uniform
      if (kMode != kWarpPrivate) {
        const int prev = __shfl_up_sync(kFull, key, 1);
        if (!__any_sync(kFull, lane > 0 && key >= 0 && key == prev)) {
          if (key >= 0) {  // no run across lanes: each writes alone
#pragma unroll
            for (int s = 0; s < S; ++s)
              atomic_add(dst + s * n_entries + key, v[s][j]);
          }
          continue;
        }
      }
      const unsigned peers = __match_any_sync(kFull, key);
      // shuffle tree: each lane adds the value of its next remaining peer
      // above it; a lane whose rank among its peers is odd at a level is
      // done, so the lowest lane ends with the group's sum
      unsigned rest = peers & ~below & ~(1u << lane);
      unsigned rank = __popc(peers & below);
      double x[S];
#pragma unroll
      for (int s = 0; s < S; ++s) x[s] = v[s][j];
      while (__any_sync(kFull, rest != 0)) {
        const int next = __ffs(rest);  // 1 + lane index, 0 if none
#pragma unroll
        for (int s = 0; s < S; ++s) {
          const double t = __shfl_sync(kFull, x[s], (next - 1) & 31);
          if (next) x[s] += t;
        }
        rest &= ~__ballot_sync(kFull, rank & 1u);
        rank >>= 1;
      }
      if (key >= 0 && (peers & below) == 0) {
#pragma unroll
        for (int s = 0; s < S; ++s) {
          double* p = dst + s * n_entries + key;
          if (kMode == kWarpPrivate) {
            *p += x[s];  // this warp's copy; one writer per gid per step
          } else {
            atomic_add(p, x[s]);
          }
        }
      }
      if (kMode == kWarpPrivate) __syncwarp();
    }
  }
  if (kMode != kGlobalAtomics) {
    __syncthreads();
    const int copies = kMode == kWarpPrivate ? warps : 1;
    for (int64_t i = threadIdx.x; i < cells; i += blockDim.x) {
      double sum = 0.0;
      for (int w = 0; w < copies; ++w) sum += acc[w * cells + i];
      if (sum != 0.0) atomic_add(&out[i], sum);
    }
  }
}

template <typename T, int S, int kMode, bool kKeyed>
int k1_launch_mode(const int32_t* gid, const DenseKeys& keys,
                   const Cols<T>& cols, int64_t n_rows, int64_t n_entries,
                   double* out, cudaStream_t stream) {
  auto* kernel = k1_kernel<T, S, kMode, kKeyed>;
  const int warps = kK1Threads / 32;
  const int64_t copy = static_cast<int64_t>(S) * n_entries * sizeof(double);
  const size_t smem = static_cast<size_t>(
      kMode == kWarpPrivate ? copy * warps : kMode == kBlockShared ? copy : 0);
  if (smem > kMaxSharedBytes) return cudaErrorInvalidValue;
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
                                                      kK1Threads, smem);
  if (err != cudaSuccess) return err;
  // every block stays resident and walks the tiles: its shared copy is
  // zeroed and flushed once
  int64_t grid = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  const int64_t n_tiles = (n_rows + kTileRows - 1) / kTileRows;
  const int64_t wanted = (n_tiles + warps - 1) / warps;
  if (grid > wanted) grid = wanted;
  kernel<<<static_cast<unsigned>(grid), kK1Threads, smem, stream>>>(
      gid, keys, cols, n_rows, n_entries, out);
  return cudaGetLastError();
}

// the ids from `keys` where it is given, else from `gid`
template <typename T, int S, int kMode>
int k1_launch_source(const int32_t* gid, const DenseKeys* keys,
                     const Cols<T>& cols, int64_t n_rows, int64_t n_entries,
                     double* out, cudaStream_t stream) {
  return keys != nullptr
             ? k1_launch_mode<T, S, kMode, true>(gid, *keys, cols, n_rows,
                                                 n_entries, out, stream)
             : k1_launch_mode<T, S, kMode, false>(gid, DenseKeys{}, cols,
                                                  n_rows, n_entries, out,
                                                  stream);
}

template <typename T, int S>
int k1_launch_s(const int32_t* gid, const DenseKeys* keys,
                const Cols<T>& cols, int64_t n_rows, int64_t n_entries,
                double* out, int mode, cudaStream_t stream) {
  switch (mode) {
    case kWarpPrivate:
      return k1_launch_source<T, S, kWarpPrivate>(gid, keys, cols, n_rows,
                                                  n_entries, out, stream);
    case kBlockShared:
      return k1_launch_source<T, S, kBlockShared>(gid, keys, cols, n_rows,
                                                  n_entries, out, stream);
    case kGlobalAtomics:
      return k1_launch_source<T, S, kGlobalAtomics>(gid, keys, cols, n_rows,
                                                    n_entries, out, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// gid (or the key source's columns) and every column 16-byte aligned (the
// wrapper sees to it)
template <typename T>
int k1_launch(const int32_t* gid, const void* const* ptrs, int64_t n_rows,
              int64_t n_slots, int64_t n_entries, double* out, int mode,
              const DenseKeys* keys, cudaStream_t stream) {
  if (n_rows <= 0 || n_slots <= 0 || n_entries <= 0) return cudaSuccess;
  if (n_slots > kMaxCols || n_entries > INT32_MAX) return cudaErrorInvalidValue;
  if (keys != nullptr) {
    const int err = hdk::check_keys(*keys);
    if (err != cudaSuccess) return err;
  }
  Cols<T> cols{};
  for (int s = 0; s < n_slots; ++s) cols.p[s] = static_cast<const T*>(ptrs[s]);
  switch (n_slots) {
#define HDK_K1_SLOTS(N) \
  case N:               \
    return k1_launch_s<T, N>(gid, keys, cols, n_rows, n_entries, out, mode, \
                             stream);
    HDK_K1_SLOTS(1)
    HDK_K1_SLOTS(2)
    HDK_K1_SLOTS(3)
    HDK_K1_SLOTS(4)
    HDK_K1_SLOTS(5)
    HDK_K1_SLOTS(6)
    HDK_K1_SLOTS(7)
    HDK_K1_SLOTS(8)
#undef HDK_K1_SLOTS
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// The ids come from `gid`, or, where `keys` is not null, from the
// dense-key source it points at (gid is then not read).  The build
// compiles this file once a part, -DHDK_PART=0 (f32) and 1 (f64), each
// instantiating its own kernels.
#ifndef HDK_PART
#error "compile with -DHDK_PART=<part> (kernels/build.py does)"
#endif

extern "C" {

#define HDK_GROUPBY_SUMS_COLS(SUFFIX, T)                                       \
  int hdk_groupby_sums_cols_##SUFFIX(                                          \
      const int32_t* gid, const void* const* cols, int64_t n_rows,            \
      int64_t n_slots, int64_t n_entries, double* out, int mode,              \
      const DenseKeys* keys, void* stream) {                                  \
    return k1_launch<T>(gid, cols, n_rows, n_slots, n_entries, out, mode,     \
                        keys, static_cast<cudaStream_t>(stream));             \
  }
#if HDK_PART == 0
HDK_GROUPBY_SUMS_COLS(f32, float)
#endif
#if HDK_PART == 1
HDK_GROUPBY_SUMS_COLS(f64, double)
#endif
#undef HDK_GROUPBY_SUMS_COLS

}  // extern "C"
