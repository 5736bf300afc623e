// Field gather-and-pack for the device dictionary encode, by hand for
// Hopper (sm_90a).
//
// Replaces the gather-and-pack of csvplus_tpu/ops/parse.py::
// _encode_column_kernel (parse.py:90-103), an XLA-jitted kernel.  For each
// of m fields (a start offset and a length into a uint8 buffer of n bytes)
// it writes `lanes` (2, 4 or 8) big-endian int32 words of the field's
// NUL-padded bytes, each XOR 0x80000000 so that signed int32 order equals
// byte order, lane-major into out[lanes][m]:
//
//     out[w][i] = (b[4w] << 24 | b[4w+1] << 16 | b[4w+2] << 8 | b[4w+3])
//                 ^ 0x80000000,   b[j] = j < len[i] ? data[start[i] + j] : 0
//
// These are exactly the reference's `words`.  Written as tensor ops the
// same function materializes an m x 4*lanes int64 index matrix and an
// m x 4*lanes byte matrix (1.9 GB at m = 10M, 16 bytes) and makes
// 4*lanes shift-or passes; here it is one pass with nothing in between.
//
// What bounds it: memory.  Each field reads its start and length (8
// bytes) and its own bytes once and writes 4*lanes bytes, so
// m * (8 + 4*lanes) + sum(len) bytes in all; at 3.35 TB/s (H100 SXM) that
// is about 80 us for m = 10M, lanes = 4, 8-byte fields.
//
// Design: one thread per field, a grid-stride loop over the fields.  The
// field's bytes are read one at a time through the read-only cache (the
// fields of one column are spread over the whole buffer, one per record,
// so neighbouring threads read neighbouring records); the writes of one
// lane by neighbouring threads are neighbouring words.  A byte is read only
// when it lies inside its field and inside the buffer, so a field that
// ends at the buffer's last byte never reads past it.
//
// C interface, for ctypes: csvplus_pack_field_lanes() launches on the
// given stream, does not synchronise, and returns the error of its device
// query or cudaGetLastError() after the launch (0 = ok).

#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 256

template <int LANES>
__global__ void pack_field_lanes(const uint8_t* __restrict__ data, long long n,
                                 const int32_t* __restrict__ starts,
                                 const int32_t* __restrict__ lens, long long m,
                                 int32_t* __restrict__ out) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < m;
       i += stride) {
    const long long start = __ldg(starts + i);
    const int len = __ldg(lens + i);
    // bytes of the field that lie inside the buffer: never read past it
    long long avail = n - start;
    if (avail < 0) avail = 0;
    const int have = (long long)len < avail ? len : (int)avail;
#pragma unroll
    for (int w = 0; w < LANES; ++w) {
      uint32_t word = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int j = 4 * w + b;
        const uint32_t byte = (j < have && start >= 0) ? __ldg(data + start + j) : 0u;
        word |= byte << (8 * (3 - b));
      }
      out[(long long)w * m + i] = (int32_t)(word ^ 0x80000000u);
    }
  }
}

extern "C" int csvplus_pack_field_lanes(const void* data, long long n,
                                        const void* starts, const void* lens,
                                        long long m, int lanes, void* out,
                                        void* stream) {
  if (m <= 0) return 0;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  long long blocks = (m + THREADS - 1) / THREADS;
  const long long cap = (long long)sms * 16;
  if (blocks > cap) blocks = cap;
  cudaStream_t s = (cudaStream_t)stream;
  const uint8_t* d = (const uint8_t*)data;
  const int32_t* st = (const int32_t*)starts;
  const int32_t* ln = (const int32_t*)lens;
  int32_t* o = (int32_t*)out;
  switch (lanes) {
    case 2:
      pack_field_lanes<2><<<(unsigned)blocks, THREADS, 0, s>>>(d, n, st, ln, m, o);
      break;
    case 4:
      pack_field_lanes<4><<<(unsigned)blocks, THREADS, 0, s>>>(d, n, st, ln, m, o);
      break;
    case 8:
      pack_field_lanes<8><<<(unsigned)blocks, THREADS, 0, s>>>(d, n, st, ln, m, o);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
