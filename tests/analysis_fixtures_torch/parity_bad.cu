// Seeded-bad second file of the CUDA twin (read after parity_good.cuh):
// the tiled mode's phase is gone and the settle phase runs twice. Expected
// findings:
//
//   PAR501 x2 — tier sequence drift (settle twice), and the mode phase
//               tile-rows missing from a twin that has the tiled mode
//   PAR504    — tiebreak cumsum missing here
//
// parity: phase settle
// parity: phase settle
// parity: const 0.25
