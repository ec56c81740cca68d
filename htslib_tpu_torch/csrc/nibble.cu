// BAM 4-bit sequence codes -> ASCII bases on Hopper (kernel B1).
//
// Replaces: htslib_tpu/ops/seqfmt.py:_nibble_kernel (launched by
// nibble_to_base_pallas): packed u8 [rows, W] -> u8 [rows, 2W] through
// "=ACMGRSVTWYHKDBN", high nibble first.
//
// What bounds it: bytes.  Each packed byte is read once and two bytes are
// written, against a handful of integer operations, so the card's memory
// rate sets the time.
//
// Design: a grid-stride loop in which each thread loads 16 packed bytes as
// one 16-byte vector and stores 32 output bytes as two, so neighbouring
// threads touch neighbouring addresses at full width.  The 16-entry table
// lives in two 64-bit immediates (no memory lookup, no divergent constant
// reads).  A scalar kernel handles the tail, and the whole input when
// either pointer is not 16-byte aligned.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr char kNt16[] = "=ACMGRSVTWYHKDBN";

constexpr uint64_t pack8(const char* s) {
  uint64_t v = 0;
  for (int i = 7; i >= 0; --i) v = (v << 8) | static_cast<uint8_t>(s[i]);
  return v;
}

constexpr uint64_t kLo = pack8(kNt16);
constexpr uint64_t kHi = pack8(kNt16 + 8);

__device__ __forceinline__ uint32_t nt16(uint32_t code) {
  const uint64_t w = code < 8 ? kLo : kHi;
  return static_cast<uint32_t>(w >> ((code & 7) * 8)) & 0xFFu;
}

// One packed byte -> its two bases as a little-endian u16 (high nibble's
// base in the low byte, i.e. first in memory).
__device__ __forceinline__ uint32_t expand(uint32_t p) {
  return nt16(p >> 4) | (nt16(p & 15) << 8);
}

// Four packed bytes (LE in a u32) -> eight bases as two u32.
__device__ __forceinline__ void expand4(uint32_t w, uint32_t& a, uint32_t& b) {
  a = expand(w & 0xFF) | (expand((w >> 8) & 0xFF) << 16);
  b = expand((w >> 16) & 0xFF) | (expand(w >> 24) << 16);
}

__global__ void nibble_vec16(const uint4* __restrict__ in,
                             uint4* __restrict__ out, int64_t n16) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n16;
       i += stride) {
    const uint4 v = in[i];
    uint4 o0, o1;
    expand4(v.x, o0.x, o0.y);
    expand4(v.y, o0.z, o0.w);
    expand4(v.z, o1.x, o1.y);
    expand4(v.w, o1.z, o1.w);
    out[2 * i] = o0;
    out[2 * i + 1] = o1;
  }
}

__global__ void nibble_scalar(const uint8_t* __restrict__ in,
                              uint8_t* __restrict__ out, int64_t start,
                              int64_t n) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = start + (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const uint32_t e = expand(in[i]);
    out[2 * i] = static_cast<uint8_t>(e & 0xFF);
    out[2 * i + 1] = static_cast<uint8_t>(e >> 8);
  }
}

unsigned grid_for(int64_t items, int threads) {
  const int64_t cap = 132 * 16;  // 16 blocks per SM; the loop strides on
  const int64_t g = (items + threads - 1) / threads;
  return static_cast<unsigned>(g < 1 ? 1 : (g > cap ? cap : g));
}

}  // namespace

// packed: n bytes; out: 2n bytes.  Returns cudaGetLastError().
extern "C" int nibble_to_base_launch(const void* packed, void* out,
                                     long long n, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = 256;
  const bool aligned = (reinterpret_cast<uintptr_t>(packed) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  int64_t done = 0;
  if (aligned && n >= 16) {
    const int64_t n16 = n / 16;
    nibble_vec16<<<grid_for(n16, threads), threads, 0, s>>>(
        static_cast<const uint4*>(packed), static_cast<uint4*>(out), n16);
    done = n16 * 16;
  }
  if (done < n)
    nibble_scalar<<<grid_for(n - done, threads), threads, 0, s>>>(
        static_cast<const uint8_t*>(packed), static_cast<uint8_t*>(out), done,
        n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int rc) {
  return cudaGetErrorString(static_cast<cudaError_t>(rc));
}
