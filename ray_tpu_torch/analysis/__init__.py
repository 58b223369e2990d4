"""Runtime analysis of the port (the port of ray_tpu/analysis/).

- :mod:`ray_tpu_torch.analysis.sanitizers` — dev-mode runtime sanitizers
  (``RAY_TPU_SANITIZE=1``): lock-order cycle detection over the named
  core-plane locks, an io-loop watchdog, thread-affinity assertions.

The reference's AST linter, its rules and its generated docs
(``linter``, ``rules``, ``docs``) are not ported yet (ROADMAP Queue A).
"""
