// Attention-dropout keep mask shared by the flash forward and backward
// kernels, so the backward regenerates exactly the mask the forward drew.
//
// apex_tpu/contrib/multihead_attn/flash.py `_dropout_keep`: a uint32
// squirrel3-style mix of the global (bh, row, col) coordinates and the
// seed; an element is kept when the hash is >= rate * 2^32.
#pragma once

#include <stdint.h>

__device__ __forceinline__ bool dropout_keep(uint32_t seed, uint32_t bh,
                                             uint32_t row, uint32_t col,
                                             uint32_t threshold) {
  uint32_t x = row * 0x9E3779B1u + col * 0x85EBCA77u + seed * 0xC2B2AE3Du;
  x = x * 0xB5297A4Du;
  x = x ^ (bh * 0x27D4EB2Fu);
  x = x ^ (x >> 8);
  x = x + 0x68E31DA4u;
  x = x ^ (x << 8);
  x = x * 0x1B56C4E9u;
  x = x ^ (x >> 8);
  return x >= threshold;
}
