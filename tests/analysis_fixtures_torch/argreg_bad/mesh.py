"""The mesh surface of the mini registry (the port's parallel/mesh.py):
t_def is sharded on 'model' but pad_args_for_mesh never pads it, the
ARG1204 drift."""

AXIS_DATA = "data"
AXIS_MODEL = "model"

ARG_SPECS = {
    "g_count": (),
    "g_req": (),
    "t_def": (AXIS_MODEL,),
    "gk_w": (AXIS_DATA,),
}


def pad_axis(arr, axis, mult, fill=0):
    return arr


def pad_args_for_mesh(args, mesh):
    data = mesh.devices.shape[1]
    byname = dict(zip(("g_count", "g_req", "t_def", "gk_w"), args))
    byname["gk_w"] = pad_axis(byname["gk_w"], 0, data)
    return tuple(byname[name] for name in ("g_count", "g_req", "t_def", "gk_w"))
