"""Aggregation rules, attacks, and the local robust-aggregation engine.

The package-level names are the reference's ``repro.core`` exports, each
the port's own object (the registry, the built-in rules, the single-file
rule plugins, the attacks and the robust engine)."""
from repro_torch.core import registry, selection  # noqa: F401
from repro_torch.core.registry import (  # noqa: F401
    AggregatorRule, RuleParams, register_rule, register_attack,
    available_rules, available_attacks, make_rule,
)
from repro_torch.core.aggregators import (  # noqa: F401
    mean, median, trmean, phocas, krum, multikrum, geomedian, krum_scores,
    get_aggregator, COORDINATE_WISE, VECTOR_WISE,
)
from repro_torch.core.attacks import AttackConfig, make_attack  # noqa: F401
from repro_torch.core import rules  # noqa: F401  (single-file rule plugins)
from repro_torch.core.robust import (  # noqa: F401
    RobustConfig, aggregate_matrix, aggregate_stacked_tree, gate_matrix,
    robust_aggregate_dist,
)
from repro_torch.core import bounds  # noqa: F401
