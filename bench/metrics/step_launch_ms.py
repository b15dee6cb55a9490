"""Host time of a decode step's graph launch (the replay call and its
launch counters): the mean of ``host_launch_s`` over the window's steps
that no profiler has touched (``ServingLoop.step_log`` entries without
``profiled``: in a traced run the steps before its profiled stretch,
since after ``torch.profiler`` has traced the card every launch of the
process stays slower).  None where the log has no such field."""


def read(rec):
    steps = [e for e in rec.get("step_log") or ()
             if "host_launch_s" in e and not e.get("profiled")]
    if not steps:
        return None
    return 1e3 * sum(e["host_launch_s"] for e in steps) / len(steps)
