"""Host time of a decode step outside its wait on the device: the mean,
over the window's steps that no profiler has touched, of ``host_step_s -
host_wait_s`` on each step's last ``ServingLoop.step_log`` entry (the
step's phases, timed inside the program; entries marked ``profiled`` are
left out, as in ``step_launch_ms``).  None where the log has no such
fields."""


def read(rec):
    steps = [e for e in rec.get("step_log") or ()
             if "host_step_s" in e and not e.get("profiled")]
    if not steps:
        return None
    return 1e3 * sum(e["host_step_s"] - e["host_wait_s"]
                     for e in steps) / len(steps)
