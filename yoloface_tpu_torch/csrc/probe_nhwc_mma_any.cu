// The NHWC 1x1 on the int8 tensor cores in row slabs (probe_nhwc_mma.cu)
// for any K and Nout up to 144: nhwc_mma_any_kernel (nhwc_mma_any_kernel.cuh;
// its walk in runs, probe_nhwc_mma_any_runs.cu).
//
// Every K from 1 to 64 and Nout up to 144 (B9.5's shapes: K 4 to 40, 6 and
// 18 among them, Nout up to 72) takes a second kernel of the same design,
// nhwc_mma_any_kernel ("any" below), where K is not a multiple of 4 or
// Nout passes 64 (the first keeps B9.1's and B9.3's code as it was):
//  * a row of K bytes lies at any byte offset of the slab, so each A word
//    is two aligned 4-byte shared loads and a __funnelshift_r by the row's
//    byte offset; bytes past K (the next row's) are masked to zero, since
//    the bumped B bytes there are r, not zero; the ragged slab's tail and
//    the over-read of the last row land in staged bytes or the B table,
//    never past the block's shared memory;
//  * the n-tiles run in groups of at most eight (Nout 72: two of five;
//    144: three of six), each group's B fragments read from a table the
//    block builds once in shared memory (W's words at any K, zero past
//    Nout and K), bumped by __vadd4 between the R passes and read again for
//    the next group and slab; the A words of a slab load once and serve
//    every group;
//  * a wide RAW slab buffer (256 rows of 144 int32: 147,456 B) takes the
//    ring down to two stages and the block to one an SM
//    (kernels/probes.py mma_rows_plan says how many blocks fit).
#include "nhwc_mma_any_kernel.cuh"

namespace yf_nhwc {

Kernel any_instantiation(int nt, int kc) { return any_table<false>(nt, kc); }

}  // namespace yf_nhwc
