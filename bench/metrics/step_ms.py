"""Host clock around every ``ServingLoop.step`` of the window (each ends
in its tokens' readback): total over count."""


def read(rec):
    s = rec.get("step_s")
    return 1e3 * sum(s) / len(s) if s else None
