// Seeded-bad host-core twin of parity_twin.py: every anchor failure mode
// the extractor must survive (finding, not crash). Expected findings:
//
//   PAR506 x3 — malformed anchors: empty argument, unevaluable const
//               expression, unknown anchor kind
//   PAR501    — phase 'settle' missing (sequence drift)
//   PAR502    — const 2**19 has no Python twin; const 0.25 missing here
//   PAR503    — dtype bool missing here
//   PAR504    — tiebreak argmax has no Python twin; cumsum missing here
//   PAR505    — state field 'c_oldname' is stale after a rename;
//               'c_npods'/'overflow' never declared here
//
// parity: const
// parity: const banana
// parity: flavor mango
// parity: phase fill
// parity: const 2**20
// parity: const 2**19
// parity: dtype float32
// parity: dtype int32
// parity: tiebreak argmin
// parity: tiebreak argmax
// parity: state c_used, c_oldname
