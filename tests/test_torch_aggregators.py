"""repro_torch aggregation rules and kernel wrappers against the JAX reference.

The port's plain rules (``repro_torch.core.aggregators``) and its kernel
wrappers, which take their plain versions for a CPU tensor, are held to
``repro.core.aggregators`` (the XLA selection path) at atol 1e-4, with the
boundary-tie allowance of ``tests/test_kernels.py`` for phocas.  Inputs come
from a numpy seed.  Rows at +-1e20 and NaN rows are held to the XLA path
only: the reference's Pallas extraction variants subtract the dropped values
from a total and let NaN through, which the port does not copy.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_kernels import _assert_phocas_close

from repro.core import aggregators as ragg
from repro.kernels.phocas.kernel import phocas_pallas
from repro.kernels.phocas.ref import phocas_ref as jphocas_oracle
from repro.kernels.trmean.kernel import trmean_pallas
from repro_torch.core import aggregators as tagg
from repro_torch.core.registry import RuleParams, make_rule
from repro_torch.kernels import build
from repro_torch.kernels import ops as tops
from repro_torch.kernels.phocas.kernel import phocas_hopper
from repro_torch.kernels.phocas.ref import phocas_ref
from repro_torch.kernels.trmean.kernel import trmean_hopper
from repro_torch.kernels.trmean.ref import trmean_ref

ATOL = 1e-4


def _matrix(m, d, seed):
    return (10.0 * np.random.default_rng(seed).standard_normal((m, d))
            ).astype(np.float32)


def _port_paths(name, u, b):
    """Every port path for rule ``name``: plain rule, the kernel facade, the
    kernel wrapper and its plain version, and the registered rule under each
    backend (all on the CPU)."""
    t = torch.tensor(u)
    plain = {"trmean": tagg.trmean, "phocas": tagg.phocas}[name]
    facade = {"trmean": tops.trmean, "phocas": tops.phocas}[name]
    outs = {"plain": plain(t, b), "ops": facade(t, b)}
    for backend in ("auto", "pallas", "xla"):
        rule = make_rule(name, RuleParams(b=b, backend=backend))
        outs[f"rule-{backend}"] = rule.reduce(t)
    wrapper = {"trmean": trmean_hopper, "phocas": phocas_hopper}[name]
    ref = {"trmean": trmean_ref, "phocas": phocas_ref}[name]
    outs["wrapper"] = wrapper(t, b)
    outs["ref"] = ref(t, b)
    return {k: v.numpy() for k, v in outs.items()}


@pytest.mark.parametrize("m", [3, 4, 7, 20])
@pytest.mark.parametrize("name", ["trmean", "phocas"])
def test_trim_rules_match_reference(m, name):
    u = _matrix(m, 257, m)
    ref_fn = {"trmean": ragg.trmean, "phocas": ragg.phocas}[name]
    for b in range((m + 1) // 2):
        want = np.asarray(ref_fn(jnp.asarray(u), b))
        for path, got in _port_paths(name, u, b).items():
            assert got.dtype == np.float32, path
            if name == "phocas":
                _assert_phocas_close(jnp.asarray(u), b, got, want, atol=ATOL)
            else:
                np.testing.assert_allclose(got, want, atol=ATOL,
                                           err_msg=f"{path} b={b}")


@pytest.mark.parametrize("m", [3, 4, 7, 20])
def test_mean_and_median_match_reference(m):
    u = _matrix(m, 257, 100 + m)
    t = torch.tensor(u)
    np.testing.assert_allclose(tagg.mean(t).numpy(),
                               np.asarray(ragg.mean(jnp.asarray(u))),
                               atol=ATOL)
    np.testing.assert_allclose(tagg.median(t).numpy(),
                               np.asarray(ragg.median(jnp.asarray(u))),
                               atol=ATOL)
    for name in ("mean", "median"):
        rule = make_rule(name, RuleParams(backend="auto"))
        assert rule.backend == "xla"
        np.testing.assert_allclose(
            rule.reduce(t).numpy(),
            np.asarray(ragg.get_aggregator(name)(jnp.asarray(u))), atol=ATOL)


def test_duplicate_value_ties():
    """The exact-tie matrices of test_kernel_with_duplicate_values_ties: the
    port picks the leftmost window as the XLA path does, and differs from the
    stable-argsort oracle only at boundary ties."""
    u = np.array([[0.0, 2.0], [2.0, 0.0], [1.0, 1.0], [1.0, 1.0]], np.float32)
    for got in _port_paths("phocas", u, 1).values():
        np.testing.assert_allclose(
            got, np.asarray(ragg.phocas(jnp.asarray(u), 1)), atol=1e-6)
        _assert_phocas_close(jnp.asarray(u), 1, got,
                             jphocas_oracle(jnp.asarray(u), 1), atol=1e-6)
    u2 = np.tile(np.array([[1.0], [1.0], [1.0], [2.0], [0.0]], np.float32),
                 (1, 200))
    for got in _port_paths("trmean", u2, 2).values():
        np.testing.assert_allclose(
            got, np.asarray(ragg.trmean(jnp.asarray(u2), 2)), atol=1e-6)


def _extreme(kind):
    """m=20 matrices around 3 +- 1 with an adversarial row (the reference
    Pallas kernels' cancellation and NaN cases)."""
    rng = np.random.default_rng(7)
    u = (3.0 + rng.uniform(-1.0, 1.0, (20, 64))).astype(np.float32)
    if kind == "neg1e20":
        u[3, :4] = -1e20
    elif kind == "pos1e20":
        u[3, :4] = 1e20
        u[8, 10:14] = -1e20
    elif kind == "nan":
        u[5, :5] = np.nan
    elif kind == "inf":
        u[5, :5] = np.inf
        u[6, 5:9] = -np.inf
    return u


@pytest.mark.parametrize("kind", ["neg1e20", "pos1e20", "nan", "inf"])
@pytest.mark.parametrize("name", ["trmean", "phocas"])
def test_extreme_rows_match_xla_path(kind, name):
    u = _extreme(kind)
    ref_fn = {"trmean": ragg.trmean, "phocas": ragg.phocas}[name]
    for b in (1, 2, 6):
        want = np.asarray(ref_fn(jnp.asarray(u), b))
        assert np.all(np.abs(want - 3.0) < 1.0)     # the rule trims the row
        for path, got in _port_paths(name, u, b).items():
            np.testing.assert_allclose(got, want, atol=ATOL,
                                       err_msg=f"{path} b={b}")


@pytest.mark.parametrize("m,d", [(4, 300), (20, 700)])
def test_plain_versions_match_pallas_interpret(m, d):
    """On finite, moderate inputs the port also agrees with the reference
    Pallas kernels (interpret mode on the CPU)."""
    u = _matrix(m, d, 11 * m)
    bmax = (m + 1) // 2 - 1
    for b in sorted(b for b in {1, 2, bmax} if b <= bmax):
        got_t = trmean_hopper(torch.tensor(u), b).numpy()
        np.testing.assert_allclose(got_t, trmean_pallas(jnp.asarray(u), b),
                                   atol=ATOL)
        got_p = phocas_hopper(torch.tensor(u), b).numpy()
        _assert_phocas_close(jnp.asarray(u), b, got_p,
                             phocas_pallas(jnp.asarray(u), b), atol=ATOL)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_low_precision_inputs_give_f32(dtype):
    u = torch.tensor(_matrix(16, 512, 3)).to(dtype)
    ref_u = jnp.asarray(u.float().numpy())
    for fn, ref_fn in ((trmean_hopper, ragg.trmean),
                       (phocas_hopper, ragg.phocas)):
        out = fn(u, 3)
        assert out.dtype == torch.float32
        np.testing.assert_allclose(out.numpy(), ref_fn(ref_u, 3), atol=1e-2)


@pytest.mark.parametrize("m", [3, 4, 20])
def test_b_out_of_range_raises(m):
    t = torch.tensor(_matrix(m, 8, 0))
    for b in (-1, (m + 1) // 2):
        for fn in (tagg.trmean, tagg.phocas, tops.trmean, tops.phocas,
                   trmean_hopper, phocas_hopper):
            with pytest.raises(ValueError, match="out of range"):
                fn(t, b)


@pytest.mark.parametrize("name", ["trmean", "phocas"])
def test_ops_b0_is_the_plain_mean(name, monkeypatch):
    """The rules' kernel entry point routes b = 0 to the plain mean, as the
    reference's kernels/ops.py does, without reaching the kernel wrapper."""
    def unreachable(u, b):
        raise AssertionError("b = 0 reached the kernel wrapper")

    monkeypatch.setattr(tops, f"{name}_hopper", unreachable)
    u = _matrix(8, 33, 5)
    u[2, :3] = np.nan
    t = torch.tensor(u)
    got = {"trmean": tops.trmean, "phocas": tops.phocas}[name](t, 0)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), t.mean(dim=0).numpy())
    assert np.isnan(got.numpy()[:3]).all()


def test_kernel_wrappers_refuse_what_the_kernels_do_not_take():
    with pytest.raises(ValueError, match="m <= 64"):
        trmean_hopper(torch.zeros((65, 4)), 2)
    with pytest.raises(ValueError, match="m <= 64"):
        phocas_hopper(torch.zeros((65, 4)), 2)
    with pytest.raises(ValueError, match="dtype|take"):
        trmean_hopper(torch.zeros((5, 4), dtype=torch.float64), 1)
    with pytest.raises(ValueError, match="CUDA"):
        build.launch("trmean", torch.zeros((5, 4)), 1)


def test_backend_resolution():
    with pytest.raises(ValueError, match="declares no"):
        make_rule("mean", RuleParams(backend="pallas"))
    with pytest.raises(ValueError, match="unknown backend"):
        make_rule("phocas", RuleParams(backend="tpu"))
    assert make_rule("phocas", RuleParams(backend="auto")).backend == "auto"
    with pytest.raises(NotImplementedError, match="queue 1 item 13"):
        make_rule("signvote")


def test_plain_cpu_path_never_counts_as_a_launch():
    before = (trmean_hopper.launches, phocas_hopper.launches)
    t = torch.tensor(_matrix(8, 16, 1))
    trmean_hopper(t, 2)
    phocas_hopper(t, 2)
    assert (trmean_hopper.launches, phocas_hopper.launches) == before
