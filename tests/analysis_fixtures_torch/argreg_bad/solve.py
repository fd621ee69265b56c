# n_ghost is no solve argument -> ARG1201
SCENARIO_BATCHED_ARGS = ("g_count", "n_ghost")
