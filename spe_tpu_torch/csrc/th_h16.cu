// The talking-heads training row passes (th_rows.cuh) at the M36/M48
// backbones' 16 heads, at rows of up to 1024 and 2048 keys: the mixes in
// shared memory, the H x H partials summed over the warp. A compilation
// unit of its own (the longest of the row passes' to compile), so nvcc
// builds it beside th_train.cu and th_wide.cu.
#include "th_rows.cuh"

int th_rows_h16(const THBwdParams* p, int backward, cudaStream_t s) {
  return p->row.N <= 4 * TH_NT ? launch_th_rows<16, 1>(p, backward, s)
                               : launch_th_rows<16, 2>(p, backward, s);
}
