"""The plain float32 reference: the model (``model``) and the comparison
that decides a serving run's ``correct`` (``check``).  Imports nothing of
the program."""
