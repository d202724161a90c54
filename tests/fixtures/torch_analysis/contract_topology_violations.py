"""Seeded topology contract violations (CONTRACT006, CONTRACT008,
CONTRACT011).  ``ReadsThroughAlias`` is the drift serve had: its keys read
through an alias of ``plan.topology_params``, which the check cannot see."""
from repro_torch.experiment.topology import Topology


class ReadsUndeclaredParam(Topology):        # VIOLATION CONTRACT006
    name = "fx_reads_undeclared"
    param_names = ()

    def run(self, plan, init_state=None):
        return plan.topology_params.get("staleness", 2)


class DeclaresUnreadParam(Topology):         # VIOLATION CONTRACT006
    name = "fx_declares_unread"
    param_names = ("ghost_knob",)

    def run(self, plan, init_state=None):
        return None


class ReadsThroughAlias(Topology):           # VIOLATION CONTRACT006
    name = "fx_reads_through_alias"
    param_names = ("max_slots", "prompt_len")

    def run(self, plan, init_state=None):
        tp = plan.topology_params
        return int(tp.get("max_slots", 8)), int(tp.get("prompt_len", 8))


class AllowsUnknownAttack(Topology):         # VIOLATION CONTRACT008
    name = "fx_allows_unknown_attack"
    attack_allowlist = ("gaussian", "fx_not_an_attack")

    def run(self, plan, init_state=None):
        return None


class AllowsUnknownFaultKind(Topology):      # VIOLATION CONTRACT011
    name = "fx_allows_unknown_fault"
    fault_allowlist = ("crash", "fx_not_a_fault")

    def run(self, plan, init_state=None):
        return plan.faults


class InjectsUndeclaredFaults(Topology):     # VIOLATION CONTRACT011
    name = "fx_injects_undeclared_faults"
    fault_allowlist = ()

    def run(self, plan, init_state=None):
        return plan.faults


class DeclaresUninjectedFaults(Topology):    # VIOLATION CONTRACT011
    name = "fx_declares_uninjected_faults"
    fault_allowlist = ("crash",)

    def run(self, plan, init_state=None):
        return None
