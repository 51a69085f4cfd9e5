// Dense-histogram kernels of the perfect-hash GROUP BY, for Hopper (sm_90a).
//
// One templated kernel computes
//
//     out[s, e] = sum of vals[r, s] over the rows r with gid[r] == e
//
// for slots s < L and entries 0 <= e < E.  Rows whose gid lies outside
// [0, E), negative included, are skipped: there are no dead-row sentinels.
// It is instantiated once per TPU kernel it replaces in hdk_tpu:
//
//   hdk_count_hist         ops/pallas_hist2.py::count_hist       no value
//                          stream, 32-bit shared counters flushed to u64
//   hdk_groupby_sums2_u8   ops/pallas_groupby.py::groupby_sums2  0/1 slots,
//                          32-bit shared counters flushed to u64
//   hdk_seg_sums_exact_*   ops/pallas_hist.py::seg_sums_exact    int8..int64
//                          slots read at native width, int64 sums (u64
//                          atomics: two's-complement wrap keeps them exact)
//   hdk_groupby_sums_*     ops/pallas_groupby.py::groupby_sums   f32/f64
//                          slots, f64 sums
//
// What bounds it: device-memory bytes.  The kernel makes one pass over gid
// (4 B/row) and the slots (L * sizeof(T) B/row); the output is L * E
// accumulators.  The TPU kernels turned the scatter-add into one-hot matrix
// products for the MXU.  Here the scatter-add is native: each block keeps an
// (L x E) partial in shared memory, adds its rows into it with shared-memory
// atomics, and flushes the non-zero partials to global memory with atomics.
// When L * E accumulators do not fit in shared memory, rows add straight into
// global memory.  A small E sends every row of a block to a handful of
// addresses: correct, but contended (warp-level pre-aggregation is later
// work).  The kernel allocates nothing; the caller zeroes `out`.
//
// Output layout is slot-major: out[s * E + e].  Values are read row-major:
// vals[r * L + s].  Each C entry point returns cudaGetLastError() after the
// launch.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

// COUNT has no value stream: every live row adds one.
struct CountTag {};

// Shared-memory and global accumulator types per value type.
template <typename T> struct Acc;
template <> struct Acc<CountTag> { using S = unsigned int; using G = unsigned long long; };
template <> struct Acc<uint8_t> { using S = unsigned int; using G = unsigned long long; };
template <> struct Acc<int8_t> { using S = unsigned long long; using G = unsigned long long; };
template <> struct Acc<int16_t> { using S = unsigned long long; using G = unsigned long long; };
template <> struct Acc<int32_t> { using S = unsigned long long; using G = unsigned long long; };
template <> struct Acc<int64_t> { using S = unsigned long long; using G = unsigned long long; };
template <> struct Acc<float> { using S = double; using G = double; };
template <> struct Acc<double> { using S = double; using G = double; };

// One row's addend for one slot, in accumulator type A.
template <typename T, typename A> struct Addend {
  __device__ __forceinline__ static A get(const T* vals, int64_t i) {
    return static_cast<A>(vals[i]);
  }
};
template <typename A> struct Addend<CountTag, A> {
  __device__ __forceinline__ static A get(const CountTag*, int64_t) { return A(1); }
};
// signed integers widen to int64 first, then wrap into u64
#define HDK_SIGNED_ADDEND(T)                                                  \
  template <> struct Addend<T, unsigned long long> {                         \
    __device__ __forceinline__ static unsigned long long get(const T* vals,  \
                                                             int64_t i) {    \
      return static_cast<unsigned long long>(static_cast<long long>(vals[i])); \
    }                                                                         \
  };
HDK_SIGNED_ADDEND(int8_t)
HDK_SIGNED_ADDEND(int16_t)
HDK_SIGNED_ADDEND(int32_t)
HDK_SIGNED_ADDEND(int64_t)
#undef HDK_SIGNED_ADDEND

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

}  // namespace

extern "C" {

int hdk_count_hist(const int32_t* gid, int64_t n_rows, int64_t n_entries,
                   unsigned long long* out, int use_shared, void* stream) {
  return launch<CountTag>(gid, nullptr, n_rows, 1, n_entries, out, use_shared,
                          static_cast<cudaStream_t>(stream));
}

int hdk_groupby_sums2_u8(const int32_t* gid, const uint8_t* vals,
                         int64_t n_rows, int64_t n_slots, int64_t n_entries,
                         unsigned long long* out, int use_shared,
                         void* stream) {
  return launch<uint8_t>(gid, vals, n_rows, n_slots, n_entries, out,
                         use_shared, static_cast<cudaStream_t>(stream));
}

#define HDK_SEG_SUMS_EXACT(SUFFIX, T)                                          \
  int hdk_seg_sums_exact_##SUFFIX(const int32_t* gid, const T* vals,          \
                                  int64_t n_rows, int64_t n_slots,            \
                                  int64_t n_entries, unsigned long long* out, \
                                  int use_shared, void* stream) {             \
    return launch<T>(gid, vals, n_rows, n_slots, n_entries, out, use_shared,  \
                     static_cast<cudaStream_t>(stream));                      \
  }
HDK_SEG_SUMS_EXACT(i8, int8_t)
HDK_SEG_SUMS_EXACT(i16, int16_t)
HDK_SEG_SUMS_EXACT(i32, int32_t)
HDK_SEG_SUMS_EXACT(i64, int64_t)
#undef HDK_SEG_SUMS_EXACT

#define HDK_GROUPBY_SUMS(SUFFIX, T)                                            \
  int hdk_groupby_sums_##SUFFIX(const int32_t* gid, const T* vals,            \
                                int64_t n_rows, int64_t n_slots,              \
                                int64_t n_entries, double* out,               \
                                int use_shared, void* stream) {               \
    return launch<T>(gid, vals, n_rows, n_slots, n_entries, out, use_shared,  \
                     static_cast<cudaStream_t>(stream));                      \
  }
HDK_GROUPBY_SUMS(f32, float)
HDK_GROUPBY_SUMS(f64, double)
#undef HDK_GROUPBY_SUMS

}  // extern "C"
