// Native host-side batch packer of tsdiff_tpu_torch (a copy of the JAX
// package's native/graphbuild.cpp).
//
// Every training step, sampled batch and served round is a fixed-shape
// padded batch (B graphs, N-atom bucket; batch 200 in production).  Packing
// scatters small per-graph arrays into big padded buffers: pure memory
// movement, which in Python costs one fancy-indexing pass per field per
// graph.  This C++ code does the whole batch in tight loops;
// tsdiff_tpu_torch/data/native.py builds it with g++ at first use and binds
// it with ctypes.
//
// Layout contract (see from_numpy_graphs):
//   inputs are per-batch concatenations with prefix-offset arrays;
//   outputs are zero-initialized by the caller.

#include <cstdint>
#include <cstring>

extern "C" {

// Pack one batch of graphs into padded dense buffers.
//   atom_cat   : (sum_n,)        int32
//   rf_cat     : (sum_n, F)      float32
//   pf_cat     : (sum_n, F)      float32
//   pos_cat    : (sum_n, 3)      float32
//   ei_cat     : (2, sum_e) flattened as src then dst? NO: (sum_e, 2) pairs
//   et_cat     : (sum_e,)        int32
//   node_off   : (B+1,)          int64 prefix offsets into atom/feat/pos
//   edge_off   : (B+1,)          int64 prefix offsets into edges
// Outputs (caller zero-fills):
//   out_atom (B,N) i32; out_rf/out_pf (B,N,F) f32; out_pos (B,N,3) f32;
//   out_bond (B,N,N) i32; out_mask (B,N) u8
// Returns 0 on success, -1 if any graph exceeds N.
int32_t pack_batch(
    const int32_t* atom_cat,
    const float* rf_cat,
    const float* pf_cat,
    const float* pos_cat,
    const int32_t* ei_cat,
    const int32_t* et_cat,
    const int64_t* node_off,
    const int64_t* edge_off,
    int64_t B,
    int64_t N,
    int64_t F,
    int32_t* out_atom,
    float* out_rf,
    float* out_pf,
    float* out_pos,
    int32_t* out_bond,
    uint8_t* out_mask) {
  for (int64_t b = 0; b < B; ++b) {
    const int64_t n0 = node_off[b];
    const int64_t n = node_off[b + 1] - n0;
    if (n > N) return -1;

    std::memcpy(out_atom + b * N, atom_cat + n0, n * sizeof(int32_t));
    std::memcpy(out_rf + (b * N) * F, rf_cat + n0 * F, n * F * sizeof(float));
    std::memcpy(out_pf + (b * N) * F, pf_cat + n0 * F, n * F * sizeof(float));
    std::memcpy(out_pos + (b * N) * 3, pos_cat + n0 * 3, n * 3 * sizeof(float));
    std::memset(out_mask + b * N, 1, n);

    const int64_t e0 = edge_off[b];
    const int64_t e1 = edge_off[b + 1];
    int32_t* bond = out_bond + b * N * N;
    for (int64_t e = e0; e < e1; ++e) {
      const int32_t src = ei_cat[2 * e];
      const int32_t dst = ei_cat[2 * e + 1];
      if (src >= n || dst >= n) return -1;
      bond[src * N + dst] = et_cat[e];
    }
  }
  return 0;
}

// Parse a concatenated-xyz corpus in one pass: counts atoms per block and
// extracts coordinates.  Returns the number of blocks found, or -1 on parse
// error.  `pos_out` must hold at least `max_atoms_total * 3` floats;
// `natoms_out` at least `max_blocks` entries.  Symbols are left to the
// (cheap) Python side; this accelerates the float-heavy part.
int32_t count_xyz_blocks(const char* text, int64_t len, int64_t* natoms_out,
                         int64_t max_blocks) {
  int64_t i = 0, nb = 0;
  while (i < len) {
    // skip blank lines
    while (i < len && (text[i] == '\n' || text[i] == '\r')) ++i;
    if (i >= len) break;
    // parse atom count
    int64_t n = 0;
    bool any = false;
    while (i < len && text[i] != '\n') {
      const char c = text[i];
      if (c >= '0' && c <= '9') {
        n = n * 10 + (c - '0');
        any = true;
      } else if (any) {
        break;
      } else if (c != ' ' && c != '\t') {
        return -1;
      }
      ++i;
    }
    if (!any) return -1;
    if (nb >= max_blocks) return -1;
    natoms_out[nb++] = n;
    // skip to end of count line, then n+1 more lines (comment + atoms)
    for (int64_t line = 0; line < n + 2 && i < len; ++line) {
      while (i < len && text[i] != '\n') ++i;
      ++i;
    }
  }
  return (int32_t)nb;
}

}  // extern "C"
