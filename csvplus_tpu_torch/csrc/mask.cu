// Fused multi-column equality / IN-list mask, by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel csvplus_tpu/ops/pallas_mask.py::_fused_mask_call
// (its pl.pallas_call is at pallas_mask.py:66).  It computes
//
//     mask[i] = OP_j ( OR_{t in T_j} codes_j[i] == t )
//
// over k <= 8 int32 columns, with OP = AND ("all") or OR ("any").  A
// column holds dictionary codes (-1 marks an absent cell, and targets are
// slots >= 0, so an absent cell never matches) or the value lanes of a
// typed column (any int32, negative values and targets included).  The
// kernel compares values only and gives no value a meaning of its own.
//
// What bounds it: memory.  Each row reads k int32 codes once and writes one
// byte, (4k + 1) * n bytes in all: at 3.35 TB/s (H100 SXM) that is about
// 27 us for k = 2 at n = 10M.  The compares, sum_j |T_j| per row, stay well
// under the integer rate for the IN-lists that filters produce.
//
// Design, against the TPU kernel:
// - The TPU kernel baked the targets in as compile-time constants, one
//   executable per predicate, and padded the rows with -2 to (8, 128)
//   tiles.  Here the targets are runtime data: one flat int32 array, k + 1
//   column offsets in front of the targets, which every block stages into
//   shared memory once.  One build serves every predicate.
// - A grid-stride loop walks the rows.  When every column pointer is
//   16-byte aligned, a thread reads 4 rows of each column as one int4 and
//   writes their 4 mask bytes as one 32-bit word; the ragged tail
//   (n % 4 rows, or all rows when a pointer is unaligned) runs one row at
//   a time, so no padding is needed.
// - The column loop is unrolled to MAX_COLS with a k guard, so the column
//   pointers stay in the kernel's parameter space and never spill.
//
// C interface, for ctypes: csvplus_fused_mask() launches on the given
// stream, does not synchronise, and returns the error of its device query
// or cudaGetLastError() after the launch (0 = ok).

#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_COLS 8
#define THREADS 256
// Targets up to this count are staged in shared memory (48 KB minus the
// offsets); longer IN-lists are read from global memory through the cache.
#define MAX_STAGED ((48 * 1024) / 4 - (MAX_COLS + 1))

struct MaskCols {
  const int32_t* col[MAX_COLS];
};

__device__ __forceinline__ bool in_list(int32_t v, const int32_t* t, int lo,
                                        int hi) {
  bool hit = false;
  for (int i = lo; i < hi; ++i) hit |= (v == t[i]);
  return hit;
}

template <bool ALL>
__device__ __forceinline__ bool combine(bool acc, bool hit) {
  return ALL ? (acc && hit) : (acc || hit);
}

template <bool ALL>
__global__ void __launch_bounds__(THREADS)
    fused_mask_kernel(MaskCols cols, int k, const int32_t* __restrict__ table,
                      int n_targets, int staged, int vec, int64_t n,
                      uint8_t* __restrict__ out) {
  extern __shared__ int32_t smem[];
  // table = [offsets (k + 1) | targets (n_targets)]
  const int n_stage = (k + 1) + (staged ? n_targets : 0);
  for (int i = threadIdx.x; i < n_stage; i += blockDim.x) smem[i] = table[i];
  __syncthreads();
  const int32_t* off = smem;
  const int32_t* t = staged ? smem + (k + 1) : table + (k + 1);

  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t n_vec = vec ? n / 4 : 0;

  for (int64_t g = tid; g < n_vec; g += stride) {
    bool a0 = ALL, a1 = ALL, a2 = ALL, a3 = ALL;
#pragma unroll
    for (int j = 0; j < MAX_COLS; ++j) {
      if (j < k) {
        const int4 v = __ldg(reinterpret_cast<const int4*>(cols.col[j]) + g);
        const int lo = off[j], hi = off[j + 1];
        a0 = combine<ALL>(a0, in_list(v.x, t, lo, hi));
        a1 = combine<ALL>(a1, in_list(v.y, t, lo, hi));
        a2 = combine<ALL>(a2, in_list(v.z, t, lo, hi));
        a3 = combine<ALL>(a3, in_list(v.w, t, lo, hi));
      }
    }
    const uint32_t word = (uint32_t)a0 | ((uint32_t)a1 << 8) |
                          ((uint32_t)a2 << 16) | ((uint32_t)a3 << 24);
    reinterpret_cast<uint32_t*>(out)[g] = word;
  }

  for (int64_t i = n_vec * 4 + tid; i < n; i += stride) {
    bool a = ALL;
#pragma unroll
    for (int j = 0; j < MAX_COLS; ++j) {
      if (j < k) a = combine<ALL>(a, in_list(__ldg(cols.col[j] + i), t, off[j], off[j + 1]));
    }
    out[i] = (uint8_t)a;
  }
}

extern "C" int csvplus_fused_mask(const void* const* col_ptrs, int k,
                                  const void* table, int n_targets,
                                  long long n, int mode_all, void* out,
                                  void* stream) {
  if (k < 1 || k > MAX_COLS || n <= 0 || n_targets < k) {
    return (int)cudaErrorInvalidValue;
  }
  MaskCols cols = {};
  int vec = (reinterpret_cast<uintptr_t>(out) % 4) == 0;
  for (int j = 0; j < k; ++j) {
    cols.col[j] = static_cast<const int32_t*>(col_ptrs[j]);
    vec &= (reinterpret_cast<uintptr_t>(col_ptrs[j]) % 16) == 0;
  }
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int staged = n_targets <= MAX_STAGED;
  const size_t smem = sizeof(int32_t) * ((k + 1) + (staged ? n_targets : 0));
  const int64_t work = vec ? n / 4 + n % 4 : n;
  int64_t blocks = (work + THREADS - 1) / THREADS;
  const int64_t cap = (int64_t)sms * 8;
  if (blocks > cap) blocks = cap;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* tab = static_cast<const int32_t*>(table);
  uint8_t* o = static_cast<uint8_t*>(out);
  cudaGetLastError();  // clear any earlier, unrelated error
  if (mode_all) {
    fused_mask_kernel<true><<<(unsigned)blocks, THREADS, smem, s>>>(
        cols, k, tab, n_targets, staged, vec, (int64_t)n, o);
  } else {
    fused_mask_kernel<false><<<(unsigned)blocks, THREADS, smem, s>>>(
        cols, k, tab, n_targets, staged, vec, (int64_t)n, o);
  }
  return (int)cudaGetLastError();
}
