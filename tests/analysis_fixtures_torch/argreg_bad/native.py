def solve_core_native(g_count, t_def, g_req, gk_w, nmax=0):
    # t_def / g_req swapped vs SOLVE_ARG_NAMES -> ARG1202
    return (g_count, g_req, t_def, gk_w, nmax)
