// The group id of a row for the histogram kernels K1-K4 (hist.cu,
// int_hist.cu), from one of two sources:
//
//   * an int32 array, gid[r]: the sort route's ids and every other caller;
//   * DenseKeys: the perfect-hash GROUP BY's dense id, computed in
//     registers from the raw key columns, as exec/groupby.py::perfect_gid
//     computes it with PyTorch passes:
//
//         gid = sum over keys i of (key_i - min_i) * stride_i    (int64)
//
//     where a NULL key (its validity byte 0) takes its last slot,
//     size_i - 1; the row drops out unless 0 <= gid < n_entries and its
//     row-mask byte is set.  No keys: every live row is entry 0 (a scalar
//     aggregate).  The adds and products wrap like int64 arithmetic (u64
//     two's complement), so ids equal perfect_gid's bit for bit.
//
// What it saves: perfect_gid is a chain of int64 passes over every row
// (a cast, a subtraction, a product and an add a key, then the range test,
// the row mask and a cast to int32), each reading and writing 8 bytes a
// row, before the kernel reads 4 bytes of gid; from keys the kernel reads
// each key at its stored width (a byte for bools, int8 and dictionary codes
// of small dictionaries), the validity and row-mask bytes where there are
// any, and nothing else.
//
// Loads follow the kernels' row layout: a lane takes 4 consecutive rows
// with one streaming load a key (4 x width bytes: char4, short4, int4 or
// two longlong2), the columns 16-byte aligned (the wrapper sees to it);
// the ragged end reads row by row.  The width is a runtime value, the same
// for every thread of a launch, so the switch on it does not diverge and a
// kernel is instantiated once for keys of any type.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace hdk {

constexpr int kMaxKeys = 4;

// By value into the kernel.  Every field is 8 bytes, so the layout has no
// padding; kernels/build.py::DenseKeysC mirrors it field for field.
struct DenseKeys {
  const void* key[kMaxKeys];       // each key's column
  const uint8_t* valid[kMaxKeys];  // its validity bytes; null: no NULLs
  const uint8_t* row_mask;         // live rows' bytes; null: every row
  int64_t width[kMaxKeys];         // bytes a value: 1, 2, 4 or 8, signed
  int64_t min[kMaxKeys];
  int64_t size[kMaxKeys];    // slots of the key, its NULL slot included
  int64_t stride[kMaxKeys];  // entries a slot of the key, below 2^31
  int64_t n_keys;            // 0 .. kMaxKeys
  int64_t n_entries;         // the layout's E = product of the sizes
};

// cudaSuccess where a launch may read `keys`, else cudaErrorInvalidValue
inline int check_keys(const DenseKeys& keys) {
  if (keys.n_keys < 0 || keys.n_keys > kMaxKeys || keys.n_entries <= 0 ||
      keys.n_entries > INT32_MAX)
    return cudaErrorInvalidValue;
  for (int i = 0; i < keys.n_keys; ++i) {
    const int64_t w = keys.width[i];
    if ((w != 1 && w != 2 && w != 4 && w != 8) || keys.key[i] == nullptr ||
        keys.stride[i] < 0 || keys.stride[i] > INT32_MAX)
      return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}

// four consecutive values of a key column, sign-extended
__device__ __forceinline__ void load_key4(const void* p, int64_t width,
                                          int64_t r0, long long (&x)[4]) {
  switch (width) {
    case 1: {
      const char4 q = __ldcs(
          reinterpret_cast<const char4*>(static_cast<const int8_t*>(p) + r0));
      x[0] = q.x;
      x[1] = q.y;
      x[2] = q.z;
      x[3] = q.w;
      break;
    }
    case 2: {
      const short4 q = __ldcs(
          reinterpret_cast<const short4*>(static_cast<const int16_t*>(p) + r0));
      x[0] = q.x;
      x[1] = q.y;
      x[2] = q.z;
      x[3] = q.w;
      break;
    }
    case 4: {
      const int4 q = __ldcs(
          reinterpret_cast<const int4*>(static_cast<const int32_t*>(p) + r0));
      x[0] = q.x;
      x[1] = q.y;
      x[2] = q.z;
      x[3] = q.w;
      break;
    }
    default: {
      const longlong2* v = reinterpret_cast<const longlong2*>(
          static_cast<const int64_t*>(p) + r0);
      const longlong2 a = __ldcs(v);
      const longlong2 b = __ldcs(v + 1);
      x[0] = a.x;
      x[1] = a.y;
      x[2] = b.x;
      x[3] = b.y;
    }
  }
}

__device__ __forceinline__ long long load_key1(const void* p, int64_t width,
                                               int64_t r) {
  switch (width) {
    case 1:
      return static_cast<const int8_t*>(p)[r];
    case 2:
      return static_cast<const int16_t*>(p)[r];
    case 4:
      return static_cast<const int32_t*>(p)[r];
    default:
      return static_cast<const int64_t*>(p)[r];
  }
}

// four consecutive bytes (validity or row mask) as flags
__device__ __forceinline__ void load_flags4(const uint8_t* p, int64_t r0,
                                            bool (&f)[4]) {
  const uchar4 q = __ldcs(reinterpret_cast<const uchar4*>(p + r0));
  f[0] = q.x != 0;
  f[1] = q.y != 0;
  f[2] = q.z != 0;
  f[3] = q.w != 0;
}

// the ids of rows r0 .. r0 + 3 from the keys, -1 where a row drops out;
// kFull: all four rows lie below n_rows (one load a key), else the ragged
// end, row by row
template <bool kFull>
__device__ __forceinline__ void dense_gid4(const DenseKeys& keys, int64_t r0,
                                           int64_t n_rows, int (&k)[4]) {
  unsigned long long g[4] = {0, 0, 0, 0};
  bool live[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) live[j] = kFull || r0 + j < n_rows;
#pragma unroll
  for (int i = 0; i < kMaxKeys; ++i) {
    if (i >= keys.n_keys) break;
    long long x[4];
    bool ok[4] = {true, true, true, true};
    if constexpr (kFull) {
      load_key4(keys.key[i], keys.width[i], r0, x);
      if (keys.valid[i] != nullptr) load_flags4(keys.valid[i], r0, ok);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        x[j] = live[j] ? load_key1(keys.key[i], keys.width[i], r0 + j) : 0;
        if (keys.valid[i] != nullptr && live[j])
          ok[j] = keys.valid[i][r0 + j] != 0;
      }
    }
    const unsigned long long mn = static_cast<unsigned long long>(keys.min[i]);
    const unsigned long long null_slot =
        static_cast<unsigned long long>(keys.size[i] - 1);
    // below 2^31: a 64 x 32-bit product
    const unsigned long long stride =
        static_cast<unsigned>(keys.stride[i]);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const unsigned long long idx =
          ok[j] ? static_cast<unsigned long long>(x[j]) - mn : null_slot;
      g[j] += idx * stride;
    }
  }
  if (keys.row_mask != nullptr) {
    if constexpr (kFull) {
      bool m[4];
      load_flags4(keys.row_mask, r0, m);
#pragma unroll
      for (int j = 0; j < 4; ++j) live[j] = live[j] && m[j];
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        live[j] = live[j] && keys.row_mask[r0 + j] != 0;
    }
  }
  const unsigned long long e = static_cast<unsigned long long>(keys.n_entries);
#pragma unroll
  for (int j = 0; j < 4; ++j)  // as unsigned: a negative id is >= e too
    k[j] = live[j] && g[j] < e ? static_cast<int>(g[j]) : -1;
}

// the ids of rows r0 .. r0 + 3 from the kernel's source: kKeyed, the keys;
// else the int32 array, rows at or past n_rows -1
template <bool kKeyed, bool kFull>
__device__ __forceinline__ void load_gid4(const int32_t* __restrict__ gid,
                                          const DenseKeys& keys, int64_t r0,
                                          int64_t n_rows, int (&k)[4]) {
  if constexpr (kKeyed) {
    dense_gid4<kFull>(keys, r0, n_rows, k);
  } else if constexpr (kFull) {
    const int4 g = __ldcs(reinterpret_cast<const int4*>(gid + r0));
    k[0] = g.x;
    k[1] = g.y;
    k[2] = g.z;
    k[3] = g.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) k[j] = r0 + j < n_rows ? gid[r0 + j] : -1;
  }
}

}  // namespace hdk
