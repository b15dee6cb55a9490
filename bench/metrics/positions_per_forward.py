"""Mean of active rows x width over the window's decode forwards
(``ServingLoop.step_log``)."""


def read(rec):
    log = rec.get("step_log")
    if not log:
        return None
    return sum(e["positions"] for e in log) / len(log)
