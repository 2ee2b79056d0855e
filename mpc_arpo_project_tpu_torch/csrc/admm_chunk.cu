// The fp32 'pallas' chunk with one slot or a group of 2, 4 or 8 slots a
// block
// (the kernel and its design: admm_chunk.cuh).

#define ADMM_LAYOUTS(X) X(1, 1) X(1, 2) X(1, 4) X(1, 8)

#include "admm_chunk.cuh"

ADMM_CHUNK_ENTRY(admm_chunk_f32, float)
