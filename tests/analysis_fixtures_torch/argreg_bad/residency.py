GROUP_ARGS = frozenset({"g_req"})
GCOUNT_ARGS = frozenset({"g_count"})

# gk_w is not in GROUP_ARGS -> ARG1203
NO_ROW_DELTA = frozenset({"gk_w"})
