"""Seeded rule-metadata contract violations (CONTRACT001-004, 007).

Deliberately broken AggregatorRule subclasses, NOT registered (no
``@register_rule``) so that a scan never adds to the process-wide
registry.  ``InheritsKernelHook`` is the drift mediam had: a trim-family
rule that declares no kernel but inherits the family's ``_reduce_kernel``.
"""
from repro_torch.core.aggregators import _TrimKernelRule
from repro_torch.core.registry import AggregatorRule


class ScoresWithoutHook(AggregatorRule):     # VIOLATION CONTRACT001
    name = "fx_scores_without_hook"
    emits_scores = True                      # ...but no override below

    def _reduce_plain(self, u):
        return u.mean(dim=0)


class HookWithoutScores(AggregatorRule):     # VIOLATION CONTRACT001
    name = "fx_hook_without_scores"
    emits_scores = False

    def _reduce_plain(self, u):
        return u.mean(dim=0)

    def reduce_sharded_with_scores(self, mat, psum_axes=()):
        return mat.mean(dim=0), mat.sum(dim=1)


class KernelWithoutHook(AggregatorRule):     # VIOLATION CONTRACT002
    name = "fx_kernel_without_hook"
    has_kernel = True                        # ...but no _reduce_kernel

    def _reduce_plain(self, u):
        return u.mean(dim=0)


class KernelBadDispatch(AggregatorRule):     # VIOLATION CONTRACT002
    name = "fx_kernel_bad_dispatch"
    has_kernel = True

    def _reduce_plain(self, u):
        return u.mean(dim=0)

    def _reduce_kernel(self, u):
        from repro_torch.kernels import ops
        return ops.nonexistent(u)


class InheritsKernelHook(_TrimKernelRule):   # VIOLATION CONTRACT002
    name = "fx_inherits_kernel_hook"
    trim_kind = "mediam"
    has_kernel = False

    def _baseline(self, m):
        return float(self.params.b) / m


class KernelOfMissingOp(_TrimKernelRule):    # VIOLATION CONTRACT002
    name = "fx_kernel_of_missing_op"
    trim_kind = "mediam"                     # kernels.ops has no mediam

    def _baseline(self, m):
        return float(self.params.b) / m


class StreamingUnimplemented(AggregatorRule):  # VIOLATION CONTRACT003
    name = "fx_streaming_unimplemented"
    supports_streaming = True                # not in STREAMING_IMPL_RULES

    def _reduce_plain(self, u):
        return u.mean(dim=0)


class DeclaresUnreadB(AggregatorRule):       # VIOLATION CONTRACT004
    name = "fx_declares_unread_b"
    uses_b = True                            # never reads params.b

    def _reduce_plain(self, u):
        return u.mean(dim=0)


class ReadsUndeclaredQ(AggregatorRule):      # VIOLATION CONTRACT004
    name = "fx_reads_undeclared_q"
    uses_q = False

    def _reduce_plain(self, u):
        return u[self.params.q:].mean(dim=0)


class FusedGateUnfused(AggregatorRule):      # VIOLATION CONTRACT007
    name = "fx_fused_gate_unfused"
    fused_gate = True                        # base two-pass composition

    def _reduce_plain(self, u):
        return u.mean(dim=0)


class FusedWithoutFlag(AggregatorRule):      # VIOLATION CONTRACT007
    name = "fx_fused_without_flag"
    fused_gate = False

    def _reduce_plain(self, u):
        return u.mean(dim=0)

    def reduce_sharded_gated_with_scores(self, mat, active, psum_axes=()):
        return mat.mean(dim=0), mat.sum(dim=1)
