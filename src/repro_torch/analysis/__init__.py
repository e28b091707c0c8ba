"""Invariant plane of the port: repo-specific static analysis and
runtime sanitizers. Counterpart of `repro/analysis/`.

The port's load-bearing guarantees — bit-identical replay across
sync/prefetch/fused-K/resume, seeded-only randomness, lock-guarded
shared state in `WorkerPool` / `ClientRegistry`, and kernel↔oracle
parity — are enforced here as machine-checked rules:

  * `repro_torch.analysis.lint` — the AST lint pass
    (``python -m repro_torch.analysis.lint --strict``) with four rule
    families: RNG discipline (``rng-*``, torch's global generator
    included), determinism (``det-*``), thread safety (``thread-*``)
    and kernel packaging (``kernel-*``).
  * `repro_torch.analysis.sanitizers` — the opt-in runtime half: a
    lock-assert proxy that records unguarded cross-thread access to
    shared state, and a tensor-leak guard for the experiment plane.
"""
from repro_torch.analysis.core import (LintReport, Violation, lint_paths,
                                       lint_source)

__all__ = ["LintReport", "Violation", "lint_paths", "lint_source"]
