"""Mini twin of the port's kernel-arg registry, seeded with one drift per
ARG12xx rule the port runs (the other surfaces live in the sibling files,
mirroring encode/native/residency/ops.solve/parallel.mesh)."""

SOLVE_ARG_NAMES = ("g_count", "g_req", "t_def", "gk_w")


class EncodedSnapshot:
    def solve_args(self, gk_w):
        return (self.g_count, self.g_req, self.t_def, gk_w)
