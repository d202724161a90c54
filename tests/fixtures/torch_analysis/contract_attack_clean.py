"""Clean twin of contract_attack_violations.py."""
from repro_torch.core.registry import AttackSpec


def _plain_factory(cfg):
    return lambda gen, u: -u


def _step_factory(cfg):
    def attack(gen, u, step=None):
        return u if step is None else -u
    return attack


plain = AttackSpec(name="fx_plain", factory=_plain_factory, kind="classic")
stepped = AttackSpec(name="fx_stepped", factory=_step_factory,
                     kind="adaptive", step_aware=True)
