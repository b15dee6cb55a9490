"""One reader per metric, ``read(record) -> value or None``, found by the
metric's name."""
