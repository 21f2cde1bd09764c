// The row kernel of probe_nhwc_mma.cu (nhwc_mma_kernel.cuh) in its walk in
// runs: block b takes slabs b * n .. b * n + n - 1 (probe_conv's
// slabs_per_block n; B9.8's block a frame and grid of chunks), a source of
// its own so that nvcc builds it beside the persistent one, whose code, and
// so whose registers, stay as they were.
#include "nhwc_mma_kernel.cuh"

namespace yf_nhwc {

Kernel fast_runs_instantiation(int nt, int kc) {
  return fast_table<true>(nt, kc);
}

}  // namespace yf_nhwc
