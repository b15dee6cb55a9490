"""The reference's four example drivers, run on the port.

The reference keeps its drivers in ``examples/`` beside its package and
runs them as scripts.  Here each is a module of the package, run as

  PYTHONPATH=src python -m repro_torch.examples.<name> [--device cpu] ...

so the repository's documented one-liners (all ``python -m``, which the
doc-snippet test runs) reach them, and tests and ``chip_smoke.py`` can
import them.  Each ``main(argv=None)`` parses its own flags, prints what
the reference's driver prints, and returns its numbers:

  nfp_survey             the paper's Table 24 as a lookup over the
                         architectures x hardware x batch x context
  quickstart             the NFP prediction, the simulated T(N) curve and
                         one multi-position decode forward of a tiny MoE
  serve_parallel_decode  AR greedy against speculative (with its lossless
                         check) against diffusion-block decoding
  train_lm               a ~100M dense LM with checkpoint / restart and a
                         step watchdog

They run on ``cuda`` unless given ``--device cpu``; weights come from a
``torch.Generator`` seeded by ``--seed`` and prompts from a numpy
generator with the same seed.
"""
