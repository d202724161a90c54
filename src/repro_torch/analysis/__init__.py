"""repro_torch.analysis: the port's repo-aware static-analysis gate.

Port of ``repro/analysis``, run over the port's own files and registries:

* ``contracts``: plugin-metadata conformance by import and inspection
  (CONTRACT001-009, 011, 012) and the kernel caps against the CUDA sources
  (PALLAS003);
* ``telemetry_kinds``: the record kind at each ``.log``/``.emit`` call
  site is registered in ``repro_torch/obs/schema.py`` (CONTRACT010);
* ``axes``: mesh axis-name literals and ``spawn``'s rank-function arity
  (AXIS001, AXIS002);
* ``prng``: seed provenance (PRNG003, PRNG004);
* ``layout``: each kernel cap assigned only in its owning module
  (PALLAS002).

Run it as ``python -m repro_torch.analysis [paths]`` (non-zero exit on
errors), or call :func:`run_analysis`.  Audited false positives are
suppressed in place with ``# repro: noqa[RULE]  -- reason``.  It imports
neither JAX nor the reference package.
"""
from repro_torch.analysis.engine import run_analysis
from repro_torch.analysis.findings import RULES, Finding

__all__ = ["run_analysis", "Finding", "RULES"]
