"""Declarative scenarios and the ``run_experiment`` entry point."""
from repro_torch.experiment.runner import (ExperimentResult, Plan,  # noqa: F401
                                           plan_from_parts, resolve,
                                           resolve_device, run_experiment)
from repro_torch.experiment.spec import (CompressionSpec, DataSpec,  # noqa: F401
                                         ModelSpec, ScenarioSpec, SpecError)
from repro_torch.experiment.sweep import (apply_overrides,  # noqa: F401
                                          run_cached, run_sweep,
                                          scenario_key, sweep)
from repro_torch.experiment.topology import (Topology,  # noqa: F401
                                             available_topologies,
                                             get_topology, make_topology,
                                             register_topology)
