// Counter-hash dropout mask shared by the attention kernels.
//
// The keep decision for attention probability (row, col) of head bh is a
// pure function of (seed, bh, absolute row, absolute col): a murmur3
// finalizer over a linear mix, compared against thresh = int(rate * 2^32).
// It is detr_tpu/ops/pallas_attention.py::_dropout_keep bit for bit, so the
// forward and both backward kernels regenerate one mask however they tile.
// All arithmetic is uint32: it wraps, and the shifts are logical.
#pragma once

#include <stdint.h>

__device__ __forceinline__ uint32_t dropout_murmur_mix(uint32_t h) {
  h ^= h >> 16;
  h *= 0x7FEB352Du;
  h ^= h >> 15;
  h *= 0x846CA68Bu;
  return h ^ (h >> 16);
}

// The hash's head index of local head (b, h): (b_off + b) * H_total + h_off + h,
// the head's index in the global (batch, heads) array when this launch holds a
// block of its batch rows (data parallelism) or of its heads (tensor
// parallelism).  The kernels take hash_base = b_off * H_total + h_off and
// hash_heads = H_total; one process has 0 and H, giving b * H + h.
__device__ __forceinline__ uint32_t dropout_head(uint32_t hash_base, uint32_t hash_heads, int b,
                                                 int h) {
  return hash_base + (uint32_t)b * hash_heads + (uint32_t)h;
}

// The part of the hash that depends on the row only.
__device__ __forceinline__ uint32_t dropout_row_hash(uint32_t seed, uint32_t bh, uint32_t row) {
  return seed * 0x9E3779B9u + bh * 0x85EBCA6Bu + row * 0x27D4EB2Fu;
}

__device__ __forceinline__ bool dropout_keep(uint32_t row_hash, uint32_t col, uint32_t thresh) {
  return dropout_murmur_mix(row_hash ^ (col * 0x165667B1u)) >= thresh;
}
