// The fp32 'pallas' chunk with a cluster of 2 or 8 blocks a slot
// (the kernel and its design: admm_chunk.cuh).

#define ADMM_LAYOUTS(X) X(2, 1) X(8, 1)

#include "admm_chunk.cuh"

ADMM_CHUNK_ENTRY(admm_cluster_f32, float)
