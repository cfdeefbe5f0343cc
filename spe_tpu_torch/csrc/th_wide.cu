// The talking-heads training row passes (th_rows.cuh) past the stock
// step's instantiations at rows of 1025-2048 keys (two units of 4 columns a
// thread: the multi-scale buckets up to max_size 640, 1600 patches) at
// every H <= 8. A compilation unit of its own, so nvcc builds it beside
// th_train.cu and th_h16.cu (the 16 heads' own kernels, passed on from
// here); spe_th_rows (th_train.cu) dispatches here.
#include "th_rows.cuh"

int th_rows_wide(const THBwdParams* p, int backward, cudaStream_t s) {
  if (p->row.H == 16) return th_rows_h16(p, backward, s);
  switch (p->row.N > 4 * TH_NT ? p->row.H : 0) {
    case 1: return launch_th_rows<1, 2>(p, backward, s);
    case 2: return launch_th_rows<2, 2>(p, backward, s);
    case 3: return launch_th_rows<3, 2>(p, backward, s);
    case 4: return launch_th_rows<4, 2>(p, backward, s);
    case 5: return launch_th_rows<5, 2>(p, backward, s);
    case 6: return launch_th_rows<6, 2>(p, backward, s);
    case 7: return launch_th_rows<7, 2>(p, backward, s);
    case 8: return launch_th_rows<8, 2>(p, backward, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
