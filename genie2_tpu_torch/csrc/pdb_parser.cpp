// CA-only PDB parser for the training data pipeline, bound by ctypes
// (genie2_tpu_torch/features/pdb_native.py).
//
// Semantics mirror the numpy parser (features/pdb.py:parse_pdb): fixed-column
// ATOM records, CA atoms only (columns 13-14), chains split where the chain
// id (column 21) changes, coordinates from columns 30-53, read as float32.
// A copy of genie2_tpu's csrc/pdb_parser.cpp; the caller sizes the buffers
// from the file's line count, so the capacity guard never truncates.
//
// Build: g++ -O3 -shared -fPIC -o pdb_parser.so pdb_parser.cpp
// (driven by genie2_tpu_torch/features/pdb_native.py into build/host/)

#include <cstdint>
#include <cstring>
#include <cstdlib>

namespace {

// Residue order matching genie2_tpu_torch.features.residues.RESTYPES.
constexpr const char* kRestypes3[20] = {
    "ALA", "ARG", "ASN", "ASP", "CYS", "GLN", "GLU", "GLY", "HIS", "ILE",
    "LEU", "LYS", "MET", "PHE", "PRO", "SER", "THR", "TRP", "TYR", "VAL",
};

int restype_index(const char* p) {
  for (int i = 0; i < 20; ++i) {
    if (p[0] == kRestypes3[i][0] && p[1] == kRestypes3[i][1] &&
        p[2] == kRestypes3[i][2]) {
      return i;
    }
  }
  return -1;
}

// strtof on a bounded, non-NUL-terminated column.
float parse_float(const char* p, int width) {
  char buf[16];
  int n = width < 15 ? width : 15;
  std::memcpy(buf, p, n);
  buf[n] = '\0';
  return std::strtof(buf, nullptr);
}

}  // namespace

extern "C" {

// Parse decompressed PDB text.
//
// Outputs (caller-allocated, capacity max_atoms):
//   coords    [max_atoms * 3] floats
//   restypes  [max_atoms] residue-type indices
//   chain_ids [max_atoms] dense chain indices (0, 1, ... in encounter order
//             of chain-id CHANGES, matching the Python parser's splitting)
//
// Returns the number of CA atoms parsed, or -(line_number) on a malformed
// record (unknown residue type).
int64_t parse_pdb_ca(const char* data, int64_t len, float* coords,
                     int32_t* restypes, int32_t* chain_ids,
                     int64_t max_atoms) {
  int64_t n = 0;
  int32_t chain_index = -1;
  char current_chain = '\0';
  bool have_chain = false;

  const char* p = data;
  const char* end = data + len;
  int64_t line_no = 0;

  while (p < end) {
    const char* nl = static_cast<const char*>(std::memchr(p, '\n', end - p));
    const char* line_end = nl ? nl : end;
    int64_t line_len = line_end - p;
    ++line_no;

    // ATOM record with CA in columns 13-14 (line[13:15].strip() == "CA":
    // accept "CA " and exclude e.g. "CB "; column 12 may hold an altloc
    // digit in nonstandard files — the Python parser slices [13:15], so we
    // match exactly that).
    if (line_len >= 54 && p[0] == 'A' && p[1] == 'T' && p[2] == 'O' &&
        p[3] == 'M' && p[13] == 'C' && p[14] == 'A') {
      if (n >= max_atoms) return n;  // capacity guard
      int rt = restype_index(p + 17);
      if (rt < 0) return -line_no;
      char chain = p[21];
      if (!have_chain || chain != current_chain) {
        ++chain_index;
        current_chain = chain;
        have_chain = true;
      }
      restypes[n] = rt;
      chain_ids[n] = chain_index;
      coords[n * 3 + 0] = parse_float(p + 30, 8);
      coords[n * 3 + 1] = parse_float(p + 38, 8);
      coords[n * 3 + 2] = parse_float(p + 46, 8);
      ++n;
    }
    p = line_end + 1;
  }
  return n;
}

}  // extern "C"
