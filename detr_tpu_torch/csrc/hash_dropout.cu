// Hash dropout, for Hopper (sm_90a), CUDA C++: one launch a call each way.
//
// Replaces no Pallas kernel: in the JAX package the element dropout
// (detr_tpu/ops/dropout.py::hash_dropout) is XLA elementwise code.  The
// plain version, ops/dropout.py::hash_dropout_reference, runs the uint32
// hash as int64 PyTorch ops (~32 launches a call, ~450 bytes moved an
// element); the CPU runs it and this kernel is held to it bit for bit.
//
//   y[e] = keep(e) ? x[e] * scale : +0
//   keep(e) = murmur_mix(seed * 0x9E3779B9 + g(e) * 0x27D4EB2F) >= thresh
//
// with thresh = int(rate * 2^32) and scale = 1 / (1 - rate) rounded to x's
// dtype, the product taken in fp32 and rounded to x's dtype as PyTorch's
// multiply does.  g(e) is the element's flat C-order index in the global
// array mod 2^32: e itself for one process's array, else
// (row + row_off) * width + col + col_off with (row, col) = divmod(e, cols),
// a block of batch rows (data parallelism) or of FFN hidden columns (tensor
// parallelism) of a global array `width` wide.  A select, not a multiply by
// the mask, so that a dropped NaN or inf becomes +0 as torch.where gives.
//
// The backward is the same map over dy: keep ? dy * scale : +0 is the
// gradient autograd gives where(keep, x * scale, 0), bit for bit.  So the
// mask is regenerated from (seed, rate, shape, offsets) in the backward and
// never stored: the forward keeps no tensor alive for it.
//
// What bounds it: bytes.  A call reads one tensor and writes one, 4 bytes an
// element in bf16 (8 in fp32).  The hash is ~12 integer instructions an
// element, which the card's integer rate covers in about half the time of
// the bf16 traffic.
//
// Design: each thread moves 16 bytes (8 bf16 or 4 fp32) at a step of a
// grid-stride loop over at most four waves of resident blocks (the device's
// size read once per device); the global index of a vector's first element
// is computed once and stepped across the vector.  One index path serves
// one process's array too (row_off = col_off = 0, width = cols gives e mod
// 2^32).  A ragged tail, or an input that does not start on 16 bytes, goes
// element by element.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dropout_hash.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWaves = 4;
constexpr int kMaxDevices = 64;

struct Index {       // g(e) of the note above
  long long cols;    // the local array's last dim
  uint32_t row_off;  // batch_offset * rows per batch item
  uint32_t width;    // the global array's last dim
  uint32_t col_off;
};

struct F32 {
  using Bits = float;
  __device__ static float load(Bits b) { return b; }
  __device__ static Bits store(float f) { return f; }
};

struct BF16 {
  using Bits = unsigned short;
  __device__ static float load(Bits b) { return __uint_as_float((uint32_t)b << 16); }
  __device__ static Bits store(float f) { return __bfloat16_as_ushort(__float2bfloat16(f)); }
};

// g(e) and e's column, for the element that starts a run.
__device__ __forceinline__ uint32_t first_index(long long e, const Index& ix, long long& col) {
  long long row;
  if (e <= 0xFFFFFFFFll && ix.cols <= 0xFFFFFFFFll) {  // 32-bit division where it will do
    row = (uint32_t)e / (uint32_t)ix.cols;
  } else {
    row = e / ix.cols;
  }
  col = e - row * ix.cols;
  return ((uint32_t)row + ix.row_off) * ix.width + (uint32_t)col + ix.col_off;
}

// g(e + 1) from g(e): the next column, or the first of the next row.
__device__ __forceinline__ uint32_t next_index(uint32_t g, const Index& ix, long long& col) {
  if (++col == ix.cols) {
    col = 0;
    return g + ix.width - (uint32_t)ix.cols + 1u;
  }
  return g + 1u;
}

template <typename T>
__device__ __forceinline__ typename T::Bits apply(typename T::Bits b, uint32_t g, uint32_t base,
                                                   uint32_t thresh, float scale) {
  const bool keep = dropout_murmur_mix(base + g * 0x27D4EB2Fu) >= thresh;
  return keep ? T::store(T::load(b) * scale) : typename T::Bits(0);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    dropout_kernel(const typename T::Bits* __restrict__ in, typename T::Bits* __restrict__ out,
                   long long n, long long nvec, uint32_t base, uint32_t thresh, float scale,
                   Index ix) {
  using Bits = typename T::Bits;
  constexpr int V = 16 / sizeof(Bits);
  union Pack {
    uint4 u;
    Bits b[V];
  };
  const long long stride = (long long)gridDim.x * kThreads;
  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  for (long long v = tid; v < nvec; v += stride) {
    Pack p;
    p.u = reinterpret_cast<const uint4*>(in)[v];
    long long col = 0;
    uint32_t g = first_index(v * V, ix, col);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      p.b[j] = apply<T>(p.b[j], g, base, thresh, scale);
      g = next_index(g, ix, col);
    }
    reinterpret_cast<uint4*>(out)[v] = p.u;
  }
  for (long long e = nvec * V + tid; e < n; e += stride) {
    long long col = 0;
    out[e] = apply<T>(in[e], first_index(e, ix, col), base, thresh, scale);
  }
}

// kWaves waves of resident blocks on the current device, read from the
// runtime on a device's first launch only.
cudaError_t grid_cap(long long* cap) {
  static long long caps[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (caps[device] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxThreadsPerMultiProcessor, device);
    if (err != cudaSuccess) return err;
    caps[device] = (long long)sms * (per_sm / kThreads) * kWaves;
  }
  *cap = caps[device];
  return cudaSuccess;
}

template <typename T>
cudaError_t launch(const void* in, void* out, long long n, uint32_t base, uint32_t thresh,
                   float scale, Index ix, cudaStream_t stream) {
  using Bits = typename T::Bits;
  constexpr int V = 16 / sizeof(Bits);
  const bool aligned = (((uintptr_t)in | (uintptr_t)out) & 15) == 0;
  const long long nvec = aligned ? n / V : 0;
  const long long work = nvec > n - nvec * V ? nvec : n - nvec * V;
  long long cap = 0;
  cudaError_t err = grid_cap(&cap);
  if (err != cudaSuccess) return err;
  long long blocks = (work + kThreads - 1) / kThreads;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  dropout_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const Bits*>(in), static_cast<Bits*>(out), n, nvec, base, thresh, scale, ix);
  return cudaGetLastError();
}

}  // namespace

// in, out: n contiguous elements of dtype (0 fp32, 1 bf16); base = seed *
// 0x9E3779B9 mod 2^32; thresh and scale as in the note; cols, row_off, width
// and col_off give g(e) (one process's array: its last dim, 0, the same dim,
// 0).  Returns the launch's cudaError_t.
extern "C" int hash_dropout(const void* in, void* out, long long n, int dtype, uint32_t base,
                            uint32_t thresh, float scale, long long cols, uint32_t row_off,
                            uint32_t width, uint32_t col_off, cudaStream_t stream) {
  if (n <= 0 || cols <= 0) return (int)cudaErrorInvalidValue;
  const Index ix{cols, row_off, width, col_off};
  if (dtype == 0) return (int)launch<F32>(in, out, n, base, thresh, scale, ix, stream);
  if (dtype == 1) return (int)launch<BF16>(in, out, n, base, thresh, scale, ix, stream);
  return (int)cudaErrorInvalidValue;
}
