// Fused multi-column equality / IN-list mask, by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel csvplus_tpu/ops/pallas_mask.py::_fused_mask_call
// (its pl.pallas_call is at pallas_mask.py:66).  It computes
//
//     mask[i] = OP_j ( codes_j[i] in T_j )
//
// over k <= 8 int32 columns, with OP = AND ("all") or OR ("any").  A
// column holds dictionary codes (-1 marks an absent cell, and targets are
// slots >= 0, so an absent cell never matches) or the value lanes of a
// typed column (any int32, negative values and targets included).  The
// kernel compares values only and gives no value a meaning of its own.
//
// What bounds it: memory.  Each row reads k int32 codes once and writes one
// byte, (4k + 1) * n bytes in all: at 3.35 TB/s (H100 SXM) that is about
// 27 us for k = 2 at n = 10M.  Membership needs at most ceil(log2 |T_j|) + 1
// compares a row and column, well under the integer rate.
//
// Design, against the TPU kernel and against a linear scan of the targets:
// - The TPU kernel baked the targets in as compile-time constants, one
//   executable per predicate.  Here they are runtime data, one flat int32
//   table per predicate that the wrapper (ops/mask.py) builds once and
//   caches on the device, so one build serves every predicate and a
//   repeated predicate uploads nothing.
// - Membership by structure, not by scan.  The wrapper sorts and dedupes
//   each column's IN-list and picks one test a column:
//     ONE     one target: a compare against a value held in the header;
//     BITMAP  span = max - min + 1 at most max(2^16, 32 |T|) bits: one
//             unsigned range check on v - min, one word load, a shift;
//     SEARCH  otherwise: a branchless search of the sorted list,
//             ceil(log2 |T|) steps, for all of a thread's rows in lockstep.
//   Table = [header: MAX_COLS x {kind, offset, count, value} | bodies].
//   Bodies that fit the block's shared memory (227 KB with the header,
//   dynamic shared memory raised by cudaFuncSetAttribute) come first and
//   every block stages them once; a body past that is read from global
//   memory through __ldg (kind | KIND_GLOBAL).
// - Every column's loads in flight before any compare.  A thread loads
//   U int4 of each of the k columns (4U rows; U = 2 for k <= 4, 1 above)
//   into registers, and only then tests them and stores one 32-bit word
//   of mask bytes per int4.  The k column count is a template argument,
//   so the loads unroll with no guard.  The ragged tail (n % 4 rows), or
//   every row when a pointer is not 16-byte aligned, runs one row at a
//   time, so no padding is needed.
// - A persistent grid: SMs x the occupancy that
//   cudaOccupancyMaxActiveBlocksPerMultiprocessor gives for the kernel and
//   its shared memory, both cached per device (and the shared-memory
//   attribute set once), so a launch makes no device query.
//
// C interface, for ctypes: csvplus_fused_mask() launches on the given
// stream, does not synchronise, and returns a CUDA error code (0 = ok):
// its own query's or cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#define MAX_COLS 8
#define THREADS 256
#define HDR_WORDS (4 * MAX_COLS)
// the most dynamic shared memory a block may have on sm_90 (232,448 bytes)
#define SMEM_MAX_WORDS (232448 / 4)
#define MAX_DEVICES 64

enum { KIND_ONE = 0, KIND_BITMAP = 1, KIND_SEARCH = 2, KIND_GLOBAL = 4 };

struct MaskCols {
  const int32_t* col[MAX_COLS];
};

template <bool GLOBAL>
__device__ __forceinline__ int32_t ld_table(const int32_t* p) {
  if (GLOBAL) return __ldg(p);
  return *p;
}

// hit[r] = v[r] in the column's set, for R values at once.  kind is uniform
// across the block, so the branches never diverge.
template <int R, bool GLOBAL>
__device__ __forceinline__ void member(int kind, const int32_t* body, int count,
                                       int32_t value, const int32_t (&v)[R],
                                       bool (&hit)[R]) {
  if (kind == KIND_ONE) {
#pragma unroll
    for (int r = 0; r < R; ++r) hit[r] = v[r] == value;
  } else if (kind == KIND_BITMAP) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const uint32_t d = (uint32_t)v[r] - (uint32_t)value;  // v - min, mod 2^32
      const bool in = d < (uint32_t)count;
      const uint32_t w = in ? (uint32_t)ld_table<GLOBAL>(body + (d >> 5)) : 0u;
      hit[r] = (w >> (d & 31)) & 1u;
    }
  } else {
    // the last index whose target is <= v (index 0 when none is)
    int base[R];
#pragma unroll
    for (int r = 0; r < R; ++r) base[r] = 0;
    for (int n = count; n > 1;) {
      const int half = n >> 1;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int32_t t = ld_table<GLOBAL>(body + base[r] + half);
        base[r] = (t <= v[r]) ? base[r] + half : base[r];
      }
      n -= half;
    }
#pragma unroll
    for (int r = 0; r < R; ++r) hit[r] = ld_table<GLOBAL>(body + base[r]) == v[r];
  }
}

template <int R>
__device__ __forceinline__ void column_test(const int32_t* hdr, const int32_t* smem,
                                            const int32_t* __restrict__ table,
                                            const int32_t (&v)[R], bool (&hit)[R]) {
  const int kind = hdr[0], off = hdr[1], count = hdr[2];
  const int32_t value = hdr[3];
  if (kind & KIND_GLOBAL) {
    member<R, true>(kind & 3, table + off, count, value, v, hit);
  } else {
    member<R, false>(kind, smem + off, count, value, v, hit);
  }
}

template <int K, bool ALL>
__global__ void __launch_bounds__(THREADS)
    fused_mask_kernel(MaskCols cols, const int32_t* __restrict__ table, int n_stage,
                      int vec, int64_t n, uint8_t* __restrict__ out) {
  extern __shared__ int4 smem4[];
  int32_t* smem = reinterpret_cast<int32_t*>(smem4);
  // stage the header and the staged bodies: int4 loads, then the rest
  for (int i = threadIdx.x; i < n_stage / 4; i += THREADS)
    smem4[i] = __ldg(reinterpret_cast<const int4*>(table) + i);
  for (int i = (n_stage / 4) * 4 + threadIdx.x; i < n_stage; i += THREADS)
    smem[i] = __ldg(table + i);
  __syncthreads();

  constexpr int U = K <= 4 ? 2 : 1;
  constexpr int R = 4 * U;
  const int64_t n4 = vec ? n / 4 : 0;
  const int64_t step = (int64_t)gridDim.x * THREADS * U;
  for (int64_t g0 = (int64_t)blockIdx.x * THREADS * U + threadIdx.x; g0 < n4; g0 += step) {
    int4 v[K][U];
#pragma unroll
    for (int j = 0; j < K; ++j) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int64_t g = g0 + (int64_t)u * THREADS;
        v[j][u] = g < n4 ? __ldg(reinterpret_cast<const int4*>(cols.col[j]) + g)
                         : make_int4(0, 0, 0, 0);
      }
    }
    bool acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = ALL;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      int32_t x[R];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        x[4 * u] = v[j][u].x;
        x[4 * u + 1] = v[j][u].y;
        x[4 * u + 2] = v[j][u].z;
        x[4 * u + 3] = v[j][u].w;
      }
      bool hit[R];
      column_test<R>(smem + 4 * j, smem, table, x, hit);
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = ALL ? (acc[r] && hit[r]) : (acc[r] || hit[r]);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int64_t g = g0 + (int64_t)u * THREADS;
      if (g < n4) {
        reinterpret_cast<uint32_t*>(out)[g] =
            (uint32_t)acc[4 * u] | ((uint32_t)acc[4 * u + 1] << 8) |
            ((uint32_t)acc[4 * u + 2] << 16) | ((uint32_t)acc[4 * u + 3] << 24);
      }
    }
  }

  for (int64_t i = n4 * 4 + (int64_t)blockIdx.x * THREADS + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * THREADS) {
    int32_t x[K][1];
#pragma unroll
    for (int j = 0; j < K; ++j) x[j][0] = __ldg(cols.col[j] + i);
    bool a = ALL;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      bool hit[1];
      column_test<1>(smem + 4 * j, smem, table, x[j], hit);
      a = ALL ? (a && hit[0]) : (a || hit[0]);
    }
    out[i] = (uint8_t)a;
  }
}

typedef void (*MaskKernel)(MaskCols, const int32_t*, int, int, int64_t, uint8_t*);

#define KERNEL_PAIR(K) fused_mask_kernel<K, false>, fused_mask_kernel<K, true>
static const MaskKernel KERNELS[2 * MAX_COLS] = {
    KERNEL_PAIR(1), KERNEL_PAIR(2), KERNEL_PAIR(3), KERNEL_PAIR(4),
    KERNEL_PAIR(5), KERNEL_PAIR(6), KERNEL_PAIR(7), KERNEL_PAIR(8)};

// Per device: the SM count, and per kernel the shared-memory attribute
// (set once) and the occupancy of its last shared-memory size, packed as
// (bytes << 16) | blocks.  Relaxed atomics: a racing thread at worst
// repeats a query, and every query gives the same answer.
static std::atomic<int> g_sms[MAX_DEVICES];
static std::atomic<int> g_smem_attr[MAX_DEVICES][2 * MAX_COLS];
static std::atomic<long long> g_occupancy[MAX_DEVICES][2 * MAX_COLS];

static cudaError_t grid_size(int dev, int which, size_t smem, int* blocks_per_sm, int* sms) {
  const void* fn = reinterpret_cast<const void*>(KERNELS[which]);
  cudaError_t err = cudaSuccess;
  if (dev < 0 || dev >= MAX_DEVICES) {
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess && smem > 48 * 1024)
      err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 SMEM_MAX_WORDS * 4);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, fn, THREADS, smem);
    return err;
  }
  *sms = g_sms[dev].load(std::memory_order_relaxed);
  if (*sms == 0) {
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    g_sms[dev].store(*sms, std::memory_order_relaxed);
  }
  if (smem > 48 * 1024 && !g_smem_attr[dev][which].load(std::memory_order_relaxed)) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_MAX_WORDS * 4);
    if (err != cudaSuccess) return err;
    g_smem_attr[dev][which].store(1, std::memory_order_relaxed);
  }
  const long long packed = g_occupancy[dev][which].load(std::memory_order_relaxed);
  if (packed != 0 && (size_t)(packed >> 16) == smem) {
    *blocks_per_sm = (int)(packed & 0xffff);
    return cudaSuccess;
  }
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, fn, THREADS, smem);
  if (err == cudaSuccess && *blocks_per_sm > 0)
    g_occupancy[dev][which].store(((long long)smem << 16) | *blocks_per_sm,
                                  std::memory_order_relaxed);
  return err;
}

extern "C" int csvplus_fused_mask(const void* const* col_ptrs, int k, const void* table,
                                  int n_stage, long long n, int mode_all, void* out,
                                  void* stream) {
  if (k < 1 || k > MAX_COLS || n <= 0 || n_stage < HDR_WORDS || n_stage > SMEM_MAX_WORDS) {
    return (int)cudaErrorInvalidValue;
  }
  MaskCols cols = {};
  int vec = (reinterpret_cast<uintptr_t>(out) % 4) == 0;
  for (int j = 0; j < k; ++j) {
    cols.col[j] = static_cast<const int32_t*>(col_ptrs[j]);
    vec &= (reinterpret_cast<uintptr_t>(col_ptrs[j]) % 16) == 0;
  }
  if (reinterpret_cast<uintptr_t>(table) % 16 != 0) return (int)cudaErrorMisalignedAddress;
  const int which = 2 * (k - 1) + (mode_all ? 1 : 0);
  const size_t smem = sizeof(int32_t) * (size_t)n_stage;
  int dev = 0, per_sm = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = grid_size(dev, which, smem, &per_sm, &sms);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int u = k <= 4 ? 2 : 1;
  const int64_t tiles = vec ? (n / 4 + (int64_t)THREADS * u - 1) / ((int64_t)THREADS * u)
                            : (n + THREADS - 1) / THREADS;
  int64_t blocks = (int64_t)sms * per_sm;
  if (blocks > tiles) blocks = tiles;
  if (blocks < 1) blocks = 1;
  cudaGetLastError();  // clear any earlier, unrelated error
  const int32_t* tab = static_cast<const int32_t*>(table);
  int64_t rows = (int64_t)n;
  uint8_t* o = static_cast<uint8_t*>(out);
  void* args[] = {&cols, &tab, &n_stage, &vec, &rows, &o};
  err = cudaLaunchKernel(reinterpret_cast<const void*>(KERNELS[which]), dim3((unsigned)blocks),
                         dim3(THREADS), args, smem, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
