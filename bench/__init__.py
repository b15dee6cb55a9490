"""The benchmark of the PyTorch/CUDA port (``repro_torch``) on NVIDIA H100s.

``python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace
<0|1>`` runs one cell of ``BENCHMARK.json`` once and prints its result as
the last line of standard output.  Everything a cell needs is found by
name: its configuration in ``configs/<config>.json``, its traffic mix or
job in ``traffic/<traffic>.json`` (which names its driver,
``drivers/<driver>.py``), the limits of its output check in
``limits/<cell>.json``, and each metric's reader in
``metrics/<metric>.py``.  The plain float32 reference that decides
``correct`` is ``reference/``; peaks and operation / byte counts are
``roofline/``.  Nothing here imports JAX or the JAX package ``repro``.
"""
