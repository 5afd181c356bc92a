// Routed SpMV (B8) for Hopper (sm_90a): a row walk over a CSR view.
//
// Replaces the TPU kernels matrel_tpu/ops/spmv_routed.py::
// _make_gather_kernel (spmv_routed.py:232, pallas_call at :311) and
// ::_make_scatter_kernel (spmv_routed.py:261, pallas_call at :328), both
// launched by _routed_runner (:304), together with the bf16 split of x
// that routed_apply does in XLA before them (:357-361).
//
// Function: y[r] = sum over the slots of row r of
//   split(split(x[col]) * val),
// where split(v) is the sum of the first `passes` parts of v's bf16
// mantissa-mask split (ops/spmv_routed.py::_bf16_split): passes = 3
// adds x*val exactly; passes = 2 truncates each side to its leading 16
// significant bits, as the TPU kernels' two bf16 passes do. Products and
// parts are f32 (no TF32), each row's sum f64, rounded to f32 once. The
// overflow COO is summed outside, in f64.
//
// Input: the plan's CSR view (ops/csr_view.py, RoutedSpMVPlan.csr_on),
// built once per plan: row_ptr int32 (n_rows + 1) and one 8-byte record
// a real slot, {int32 column, f32 value bits}, ordered by output row
// (within a row by source group, then slot). The view holds only the
// slots the function adds: the plan's padding (val = 0) and out-of-range
// offsets are dropped when it is built.
//
// The walk itself, what bounds it on this card and its design are in
// csr_walk.cuh, which B2 (spmv_compact.cu) shares: B8 instantiates it
// with SPLIT_X = true. At BASELINE row 5 a sub-warp of 8 lanes walks a
// row; the floor is x's ~10 M random 32-byte L2 sector reads, not HBM.

#include "csr_walk.cuh"

// Launches one kernel on `stream`, never synchronises, and returns
// cudaGetLastError() (0 on success). cv must be 8-byte aligned; lanes is
// 1, 2, 4, 8, 16 or 32.
extern "C" int matrel_spmv_routed(const void* row_ptr, const void* cv,
                                  const void* x, void* y, long long n_rows,
                                  long long n_cols, int passes, int lanes,
                                  int device, void* stream) {
  return csr_walk::launch<true>(row_ptr, cv, x, y, n_rows, n_cols, passes,
                                lanes, device, stream);
}
