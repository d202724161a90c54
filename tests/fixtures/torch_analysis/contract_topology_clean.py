"""Clean twin of contract_topology_violations.py."""
from repro_torch.experiment.topology import Topology


class ReadsLiterally(Topology):
    name = "fx_reads_literally"
    param_names = ("max_slots", "prompt_len")
    attack_allowlist = ("gaussian", "none")

    def run(self, plan, init_state=None):
        return (int(plan.topology_params.get("max_slots", 8)),
                int(plan.topology_params["prompt_len"]))


class InjectsFaults(Topology):
    name = "fx_injects_faults"
    fault_allowlist = ("crash", "straggler")

    def run(self, plan, init_state=None):
        return plan.faults
