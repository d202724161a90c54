"""repro_torch.faults — the fault model for training (port of
``repro.faults``, DESIGN.md §13).

The paper proves resilience against workers that send *arbitrary* values;
this package models workers that send *nothing* (crash/omission), send late
(stragglers), or send over lossy transport (flaky).  ``spec.py`` holds the
declarative side (:class:`FaultSpec` and the fault-kind registry),
``injector.py`` the deterministic per-round deadline-quorum collection and
the b/q re-resolution the topology loops call each round.  Both are numpy
and plain Python, copies of the reference's, so a fault sequence is the same
in both packages.
"""
from repro_torch.faults.injector import (FaultInjector,  # noqa: F401
                                         FaultRound, make_injector,
                                         resolve_quorum)
from repro_torch.faults.spec import (FaultError, FaultSpec,  # noqa: F401
                                     available_fault_kinds, expand_faults,
                                     fault_kind_names, get_fault_kind,
                                     register_fault, validate_fault,
                                     validate_faults)
