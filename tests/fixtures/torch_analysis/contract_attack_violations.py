"""Seeded attack-closure contract violations (CONTRACT005).

Plain AttackSpec instances (NOT register_attack'd): check_module audits
any AttackSpec value a scanned module defines.
"""
from repro_torch.core.registry import AttackSpec


def _too_few_args_factory(cfg):              # VIOLATION CONTRACT005
    return lambda gen: gen                   # contract is (gen, u[, step])


def _step_aware_without_step_factory(cfg):   # VIOLATION CONTRACT005
    return lambda gen, u: u                  # declared step_aware below


def _required_extra_factory(cfg):            # VIOLATION CONTRACT005
    return lambda gen, u, strength: u * strength  # no default, not step


bad_too_few = AttackSpec(
    name="fx_too_few", factory=_too_few_args_factory, kind="classic")

bad_stepless = AttackSpec(
    name="fx_stepless", factory=_step_aware_without_step_factory,
    kind="adaptive", step_aware=True)

bad_extra = AttackSpec(
    name="fx_extra", factory=_required_extra_factory, kind="classic")
