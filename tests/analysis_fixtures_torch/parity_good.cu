// CUDA twin of parity_twin.py, second file: the settle phase and the tiled
// mode's row build. Never compiled — fixture only.
//
// parity: phase tile-rows
// parity: phase settle
// parity: const 0.25
// parity: tiebreak cumsum
