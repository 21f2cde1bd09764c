// The any-K kernel of probe_nhwc_mma_any.cu (nhwc_mma_any_kernel.cuh) in
// its walk in runs (probe_nhwc_mma_runs.cu says why a source of its own).
#include "nhwc_mma_any_kernel.cuh"

namespace yf_nhwc {

Kernel any_runs_instantiation(int nt, int kc) {
  return any_table<true>(nt, kc);
}

}  // namespace yf_nhwc
