// Temporal-blocked bit-packed B/S stencil on row bands, for Hopper
// (sm_90a): kernel B2, in two forms.
//
// Replaces the TPU kernel gameoflifewithactors_tpu/ops/pallas_stencil.py::
// _make_kernel in slab mode (with and without dead_band), as built by
// _build_slab_runner and driven by make_pallas_slab_step -- the step of
// the JAX package's batched lanes (make_multi_step_pallas_batched) and of
// its sharded band runner:
//
// - the slab form (life_slab_launch): `gens` generations of a binary 3x3
//   B/S rule on a batch of (He, W/32) packed bands, He = band rows +
//   2*gens, where the caller has put `gens` rows of halo above and below
//   each band and keeps rows [gens, He - gens) of the result. For each
//   band, rows outside [0, He) are zero when the slab is loaded and then
//   evolve freely (_zero_edge_rows once, at k == 0); with edge code bit 0
//   (bit 1), rows with extended index < gens (>= He - gens) are zero
//   before every generation, the permanently dead exterior of a band at
//   the grid's top (bottom) edge under a DEAD vertical closure
//   (_zero_band_exterior). The code is one for the whole batch or one per
//   band, read from a device array (the bands of a mesh on one device: 1
//   for the top band, 2 for the bottom one, 0 between). Horizontally,
//   TORUS wraps words modulo W/32 and DEAD zeroes the words outside the
//   grid before every generation. The whole (He, W/32) result is defined
//   this way, halo rows included, and does not depend on the tile size;
// - the lane form (life_slab_lane_launch): `gens` generations of a batch
//   of whole (H, W/32) grids, each with a mask entry, with no extended
//   copy: the rows beyond a grid read as its own rows modulo H under
//   TORUS and as zero under DEAD, which is what the row exchange, the
//   slab form (edge code 3 under DEAD) and the crop of rows [gens, He -
//   gens) compute, the chunk of a serving lane. A grid whose mask entry
//   is 0 comes out unchanged.
//
// One launch covers the whole batch, blockIdx.z being the band: Pallas
// issued one kernel call per universe (a manual-DMA pallas_call cannot be
// vmapped), a CUDA grid has no such limit. Both forms are the body in
// life_packed_body.cuh (the slab form kSlab, the lane form B1's kGrid with
// a band per blockIdx.z and a mask), which says what bounds it on this
// card and what its design does about it.

#include "life_packed_body.cuh"

extern "C" {

// Launches one slab-form call of `gens` generations from `in` to `out`
// (distinct (B, He, Wp) uint32 buffers) on `stream`. `edge_codes`, when
// not null, is a device array of B int32 edge codes, one per band, in
// place of `edge_code` for all of them. Returns the CUDA error code of
// the launch (0 on success), or cudaErrorInvalidValue for a geometry the
// kernel does not take.
int life_slab_launch(const void* in, void* out, int B, int He, int Wp,
                     int gens, int th, int tw, unsigned born, unsigned survive,
                     int dead_cols, int edge_code, const void* edge_codes,
                     void* stream) {
  const life_packed::Launch l = {in, out, B, He, Wp, gens, th, tw, born,
                                 survive, dead_cols, edge_code, edge_codes,
                                 nullptr, stream};
  return life_packed::launch<life_packed::kSlab>(l);
}

// Launches one lane-form call of `gens` generations from `in` to `out`
// (distinct (B, H, Wp) uint32 buffers) on `stream`; `dead` closes both
// axes of every grid, `mask` (a device array of B int32 entries, or null
// for all live) freezes the grids whose entry is 0. Returns as
// life_slab_launch does.
int life_slab_lane_launch(const void* in, void* out, int B, int H, int Wp,
                          int gens, int th, int tw, unsigned born,
                          unsigned survive, int dead, const void* mask,
                          void* stream) {
  const life_packed::Launch l = {in, out, B, H, Wp, gens, th, tw, born,
                                 survive, dead, 0, nullptr, mask, stream};
  return life_packed::launch<life_packed::kGrid>(l);
}

const char* life_slab_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
