// Temporal-blocked bit-packed life-like (B/S) stencil for Hopper (sm_90a):
// kernel B1.
//
// Replaces the TPU kernel gameoflifewithactors_tpu/ops/pallas_stencil.py::
// _make_kernel in full-grid mode, as built by _build_runner and driven by
// multi_step_pallas: `gens` generations of a binary 3x3 B/S rule per launch
// on the (H, W/32) packed grid (bit i of word j in row r is cell
// (r, 32*j + i)), TORUS or DEAD.
//
// The kernel is the full-grid form (kGrid, one grid, no mask) of the body
// in life_packed_body.cuh, which says what bounds it on this card and what
// its design does about it; B2 (life_slab.cu) is the same body's slab and
// lane forms. A Pallas block holds whole rows (about 1 MB at 16384^2), far
// beyond an SM's shared memory, so here both axes are tiled, and TORUS
// reads source rows and words modulo H and W/32 (the unrolled torus),
// exact for any grid and tile size; DEAD keeps the rows and words outside
// the grid zero, the counterpart of the per-generation _zero_edge_rows.

#include "life_packed_body.cuh"

extern "C" {

// Launches one call of `gens` generations from `in` to `out` (distinct
// (H, Wp) uint32 buffers) on `stream`. Returns the CUDA error code of the
// launch (0 on success), or cudaErrorInvalidValue for a geometry the
// kernel does not take.
int life_packed_launch(const void* in, void* out, int H, int Wp, int gens,
                       int th, int tw, unsigned born, unsigned survive,
                       int dead, void* stream) {
  const life_packed::Launch l = {in, out, 1, H, Wp, gens, th, tw, born,
                                 survive, dead, 0, nullptr, nullptr, stream};
  return life_packed::launch<life_packed::kGrid>(l);
}

// The rule path a launch takes for these born and survive masks: the
// number of counts the equality path tests (1..4), or 0 for the table.
int life_packed_rule_path(unsigned born, unsigned survive) {
  return life::rule_path(born, survive);
}

const char* life_packed_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
