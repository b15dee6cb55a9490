"""Host time of an admission outside its waits on the device (the
scatter's index upload and the first tokens' readback): the mean, over
the window's admitting ``admit`` calls that no profiler has touched, of
``host_admit_s - host_wait_s`` on each call's last ``engine.prefill_log``
entry (entries marked ``profiled`` are left out, as in
``step_launch_ms``).  None where the log has no such fields."""


def read(rec):
    calls = [e for e in rec.get("prefill_log") or ()
             if "host_admit_s" in e and not e.get("profiled")]
    if not calls:
        return None
    return 1e3 * sum(e["host_admit_s"] - e["host_wait_s"]
                     for e in calls) / len(calls)
