// What both kernel sources share: the limits of the C interfaces and the
// one on-card implementation of BLCO field extraction
// (fused_mttkrp.cu: K1/K2; phases.cu: K3).
#ifndef REPRO_TORCH_FIELDS_CUH
#define REPRO_TORCH_FIELDS_CUH

#include <stdint.h>

#define MAX_ORDER 8                    // modes of a tensor the kernels take
#define STASH_MAX_BYTES (227 * 1024)   // one CTA's shared memory on Hopper

// Bits [shift, shift + width) of (hi << 32) | lo with 32-bit operations only
// (port of extract_field_words, src/repro/kernels/delinearize.py:22).
static __device__ __forceinline__ uint32_t extract_field_words(
    uint32_t hi, uint32_t lo, int shift, int width) {
  if (width == 0) return 0u;
  const uint32_t mask = width >= 32 ? 0xffffffffu : ((1u << width) - 1u);
  if (shift >= 32) return (hi >> (shift - 32)) & mask;   // entirely in hi
  if (shift + width <= 32) return (lo >> shift) & mask;  // entirely in lo
  // straddles the two words: stitch (here 1 <= shift, shift + width < 64)
  const int lo_bits = 32 - shift;
  const uint32_t lo_part = lo >> shift;
  const uint32_t hi_part = hi & ((1u << (shift + width - 32)) - 1u);
  return (lo_part | (hi_part << lo_bits)) & mask;
}

#endif  // REPRO_TORCH_FIELDS_CUH
