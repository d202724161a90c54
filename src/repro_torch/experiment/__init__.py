"""Declarative scenarios and the ``run_experiment`` entry point."""
from repro_torch.experiment.runner import (ExperimentResult, Plan,  # noqa: F401
                                           resolve, resolve_device,
                                           run_experiment)
from repro_torch.experiment.spec import (CompressionSpec, DataSpec,  # noqa: F401
                                         ModelSpec, ScenarioSpec, SpecError)
from repro_torch.experiment.topology import (Topology,  # noqa: F401
                                             get_topology, make_topology,
                                             register_topology)
