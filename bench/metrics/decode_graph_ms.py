"""Device time of the decode graph, from its input copy to its last node
(a CUDA event pair on the engine's stream): the mean of
``graph_device_s`` over the window's forwards that no profiler has
touched (``ServingLoop.step_log``; entries marked ``profiled`` are left
out, as in ``step_launch_ms``: a slowed launch leaves the device waiting
inside the interval).  None where the log has no such field."""


def read(rec):
    t = [e["graph_device_s"] for e in rec.get("step_log") or ()
         if "graph_device_s" in e and not e.get("profiled")]
    return 1e3 * sum(t) / len(t) if t else None
