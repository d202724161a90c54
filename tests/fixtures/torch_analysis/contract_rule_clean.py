"""Clean twin of contract_rule_violations.py: rule metadata that matches
the implementation gives no finding under check_module."""
from repro_torch.core.aggregators import _TrimFamilyRule, _TrimKernelRule
from repro_torch.core.registry import AggregatorRule


class MeanWithScores(AggregatorRule):
    name = "fx_mean_with_scores"
    emits_scores = True

    def _reduce_plain(self, u):
        return u.mean(dim=0)

    def reduce_sharded_with_scores(self, mat, psum_axes=()):
        return mat.mean(dim=0), mat.sum(dim=1)


class TrimWithKernel(_TrimKernelRule):
    name = "fx_trim_with_kernel"
    trim_kind = "phocas"

    def _baseline(self, m):
        return float(self.params.b) / m


class MediamLike(_TrimFamilyRule):
    name = "fx_mediam_like"
    trim_kind = "mediam"
    has_kernel = False

    def _baseline(self, m):
        return float(self.params.b) / m


class KrumLike(AggregatorRule):
    name = "fx_krum_like"
    coordinate_wise = False
    uses_q = True
    has_kernel = True

    def _reduce_plain(self, u):
        return u[self.params.q]

    def _reduce_kernel(self, u):
        from repro_torch.kernels import ops
        return ops.krum(u.reshape(u.shape[0], -1), self.params.q)
