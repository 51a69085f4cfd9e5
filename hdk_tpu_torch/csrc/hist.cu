// Dense-histogram kernels of the perfect-hash GROUP BY, for Hopper (sm_90a).
//
// Each kernel computes
//
//     out[s, e] = sum of slot s over the rows r with gid[r] == e
//
// for slots s < L and entries 0 <= e < E.  Rows whose gid lies outside
// [0, E), negative included, are skipped: there are no dead-row sentinels.
// The kernels allocate nothing; the caller zeroes `out`.  Each C entry
// point returns cudaGetLastError() after the launch.
//
// `hist_kernel`, a generic scatter-add template, now serves one TPU kernel
// of hdk_tpu:
//
//   hdk_groupby_sums2_u8   ops/pallas_groupby.py::groupby_sums2  0/1 slots,
//                          32-bit shared counters flushed to u64
//
// (K3 and K4, seg_sums_exact and count_hist, moved to int_hist.cu.)
//
// What bounds it: device-memory bytes.  One pass over gid (4 B/row) and
// the slots (L B/row, read row-major: vals[r * L + s]); the output is
// L * E accumulators, slot-major: out[s * E + e].  The TPU kernels turned the scatter-add into
// one-hot matrix products for the MXU.  Here the scatter-add is native: each
// block keeps an (L x E) partial in shared memory, adds its rows into it with
// shared-memory atomics, and flushes the non-zero partials to global memory
// with atomics.  When L * E accumulators do not fit in shared memory, rows
// add straight into global memory.  A small E sends every row of a block to
// a handful of addresses: correct, but contended.
//
// The other, K1 (`k1_kernel`, entry points hdk_groupby_sums_cols_{f32,f64},
// replacing ops/pallas_groupby.py::groupby_sums), is its own design; see the
// comment above it.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

// Shared-memory and global accumulator types per value type.
template <typename T> struct Acc;
template <> struct Acc<uint8_t> { using S = unsigned int; using G = unsigned long long; };

// One row's addend for one slot, in accumulator type A.
template <typename T, typename A> struct Addend {
  __device__ __forceinline__ static A get(const T* vals, int64_t i) {
    return static_cast<A>(vals[i]);
  }
};

__device__ __forceinline__ void atomic_add(unsigned int* p, unsigned int v) {
  atomicAdd(p, v);
}
__device__ __forceinline__ void atomic_add(unsigned long long* p,
                                           unsigned long long v) {
  atomicAdd(p, v);
}
__device__ __forceinline__ void atomic_add(double* p, double v) {
  atomicAdd(p, v);
}

template <typename T, bool kShared>
__global__ void __launch_bounds__(kThreads)
    hist_kernel(const int32_t* __restrict__ gid, const T* __restrict__ vals,
                int64_t n_rows, int n_slots, int64_t n_entries,
                typename Acc<T>::G* __restrict__ out) {
  using S = typename Acc<T>::S;
  using G = typename Acc<T>::G;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  S* acc = reinterpret_cast<S*>(smem_raw);
  const int64_t cells = n_entries * n_slots;
  if (kShared) {
    for (int64_t i = threadIdx.x; i < cells; i += blockDim.x) acc[i] = S(0);
    __syncthreads();
  }
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       r < n_rows; r += stride) {
    const int32_t g = gid[r];
    if (g < 0 || g >= n_entries) continue;
    for (int s = 0; s < n_slots; ++s) {
      const int64_t vi = r * n_slots + s;
      if (kShared) {
        const S v = Addend<T, S>::get(vals, vi);
        if (v != S(0)) atomic_add(&acc[s * n_entries + g], v);
      } else {
        const G v = Addend<T, G>::get(vals, vi);
        if (v != G(0)) atomic_add(&out[s * n_entries + g], v);
      }
    }
  }
  if (kShared) {
    __syncthreads();
    for (int64_t i = threadIdx.x; i < cells; i += blockDim.x) {
      const S v = acc[i];
      if (v != S(0)) atomic_add(&out[i], static_cast<G>(v));
    }
  }
}

template <typename T>
int launch(const int32_t* gid, const T* vals, int64_t n_rows, int64_t n_slots,
           int64_t n_entries, typename Acc<T>::G* out, int use_shared,
           cudaStream_t stream) {
  if (n_rows <= 0 || n_slots <= 0 || n_entries <= 0) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int64_t wanted = (n_rows + kThreads - 1) / kThreads;
  // a 32-bit shared counter must not see 2^32 rows: keep every block under
  // 2^31 rows of the grid-stride loop
  const int64_t at_least = (n_rows + (int64_t(1) << 31) - 1) >> 31;
  int64_t grid = 0;
  size_t smem = 0;
  if (use_shared) {
    smem = static_cast<size_t>(n_slots * n_entries) * sizeof(typename Acc<T>::S);
    err = cudaFuncSetAttribute(hist_kernel<T, true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, hist_kernel<T, true>, kThreads, smem);
    if (err != cudaSuccess) return err;
    grid = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  } else {
    grid = static_cast<int64_t>(sms) * 16;
  }
  if (grid > wanted) grid = wanted;
  if (grid < at_least) grid = at_least;
  if (use_shared) {
    hist_kernel<T, true><<<static_cast<unsigned>(grid), kThreads, smem, stream>>>(
        gid, vals, n_rows, static_cast<int>(n_slots), n_entries, out);
  } else {
    hist_kernel<T, false><<<static_cast<unsigned>(grid), kThreads, 0, stream>>>(
        gid, vals, n_rows, static_cast<int>(n_slots), n_entries, out);
  }
  return cudaGetLastError();
}

// -- K1: per-gid float64 sums of float columns --------------------------------
//
// Replaces hdk_tpu/ops/pallas_groupby.py::groupby_sums, a one-hot MXU
// contraction with float32 accumulators.  What it computes stays: per-gid
// float64 sums of S float32 or float64 columns, rows with gid outside [0, E)
// dropped.  The mechanism is Hopper's.
//
// What bounds it: bytes, 4 + S * sizeof(T) per row read once, plus 8 * S * E
// written.  The template above loses to contention instead: at E = 7 or 10
// every lane of every warp adds into a handful of shared addresses, and its
// rows are read row-major, so the caller stacks the columns into an (N, S)
// copy first.  This kernel:
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
//     memory (atomics), as the template does.
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

template <typename T, int S, int kMode>
__global__ void __launch_bounds__(kK1Threads)
    k1_kernel(const int32_t* __restrict__ gid, const Cols<T> cols,
              int64_t n_rows, int64_t n_entries, double* __restrict__ out) {
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
      const int4 g = __ldcs(reinterpret_cast<const int4*>(gid + r0));
      k[0] = g.x;
      k[1] = g.y;
      k[2] = g.z;
      k[3] = g.w;
#pragma unroll
      for (int s = 0; s < S; ++s) load4(cols.p[s] + r0, v[s]);
    } else {  // the ragged end
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool in = r0 + j < n_rows;
        k[j] = in ? gid[r0 + j] : -1;
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

template <typename T, int S, int kMode>
int k1_launch_mode(const int32_t* gid, const Cols<T>& cols, int64_t n_rows,
                   int64_t n_entries, double* out, cudaStream_t stream) {
  auto* kernel = k1_kernel<T, S, kMode>;
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
      gid, cols, n_rows, n_entries, out);
  return cudaGetLastError();
}

template <typename T, int S>
int k1_launch_s(const int32_t* gid, const Cols<T>& cols, int64_t n_rows,
                int64_t n_entries, double* out, int mode,
                cudaStream_t stream) {
  switch (mode) {
    case kWarpPrivate:
      return k1_launch_mode<T, S, kWarpPrivate>(gid, cols, n_rows, n_entries,
                                                out, stream);
    case kBlockShared:
      return k1_launch_mode<T, S, kBlockShared>(gid, cols, n_rows, n_entries,
                                                out, stream);
    case kGlobalAtomics:
      return k1_launch_mode<T, S, kGlobalAtomics>(gid, cols, n_rows,
                                                  n_entries, out, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// gid and every column 16-byte aligned (the wrapper sees to it)
template <typename T>
int k1_launch(const int32_t* gid, const void* const* ptrs, int64_t n_rows,
              int64_t n_slots, int64_t n_entries, double* out, int mode,
              cudaStream_t stream) {
  if (n_rows <= 0 || n_slots <= 0 || n_entries <= 0) return cudaSuccess;
  if (n_slots > kMaxCols || n_entries > INT32_MAX) return cudaErrorInvalidValue;
  Cols<T> cols{};
  for (int s = 0; s < n_slots; ++s) cols.p[s] = static_cast<const T*>(ptrs[s]);
  switch (n_slots) {
#define HDK_K1_SLOTS(N) \
  case N:               \
    return k1_launch_s<T, N>(gid, cols, n_rows, n_entries, out, mode, stream);
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

extern "C" {

int hdk_groupby_sums2_u8(const int32_t* gid, const uint8_t* vals,
                         int64_t n_rows, int64_t n_slots, int64_t n_entries,
                         unsigned long long* out, int use_shared,
                         void* stream) {
  return launch<uint8_t>(gid, vals, n_rows, n_slots, n_entries, out,
                         use_shared, static_cast<cudaStream_t>(stream));
}

#define HDK_GROUPBY_SUMS_COLS(SUFFIX, T)                                       \
  int hdk_groupby_sums_cols_##SUFFIX(const int32_t* gid,                       \
                                     const void* const* cols, int64_t n_rows, \
                                     int64_t n_slots, int64_t n_entries,      \
                                     double* out, int mode, void* stream) {   \
    return k1_launch<T>(gid, cols, n_rows, n_slots, n_entries, out, mode,     \
                        static_cast<cudaStream_t>(stream));                   \
  }
HDK_GROUPBY_SUMS_COLS(f32, float)
HDK_GROUPBY_SUMS_COLS(f64, double)
#undef HDK_GROUPBY_SUMS_COLS

}  // extern "C"
