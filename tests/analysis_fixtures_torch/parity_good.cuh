// CUDA twin of parity_twin.py, first of its two files (read as one twin
// with parity_good.cu): the shared constants, dtypes, state and the fill
// phase. Never compiled — fixture only.
//
// parity: const kBig = 2**20
// parity: dtype float32
// parity: dtype int32
// parity: dtype bool
// parity: state c_used, c_npods
// parity: state overflow
// parity: phase fill
// parity: tiebreak argmin
