"""``enqueue_ms``: host ms a call spends inside the program's value+grad
(the copy of the point, the graph's replay, the clones; no wait), over the
measured window, which the profiler does not touch."""


def read(run):
    w = run.window
    if run.device.type != "cuda" or not w["calls"]:
        return None
    return w["inside_s"] * 1e3 / w["calls"]
