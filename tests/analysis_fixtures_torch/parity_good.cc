// Host-core twin of parity_twin.py with every anchor in sync: the PAR5xx
// pass must stay silent. It has no tiled mode, so no tile-rows phase.
// Never compiled — fixture only.
//
// parity: dtype float32
// parity: dtype int32
// parity: dtype bool
// parity: const kBig = 2**20
// parity: const 0.25
// parity: tiebreak argmin
// parity: tiebreak cumsum
// parity: state c_used, c_npods, overflow
// parity: phase fill
// parity: phase settle
