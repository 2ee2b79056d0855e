// The fp64 'pallas' chunk: one slot or two a block, or a cluster of 8
// blocks a slot
// (the kernel and its design: admm_chunk.cuh).

#define ADMM_LAYOUTS(X) X(1, 1) X(1, 2) X(8, 1)

#include "admm_chunk.cuh"

ADMM_CHUNK_ENTRY(admm_chunk_f64, double)
