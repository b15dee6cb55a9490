"""Host clock around every ``ServingLoop.admit`` of the window that
admitted at least one request (it ends in the first tokens' readback):
total over count."""


def read(rec):
    s = rec.get("admit_s")
    return 1e3 * sum(s) / len(s) if s else None
