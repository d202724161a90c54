"""repro_torch attacks against ``repro.core.attacks``.

Deterministic attacks are bit-exact (``bitflip``/``bitplane_flip`` compared on
the int32 view); ``omniscient``/``innerprod``/the slow-burn strike reduce over
rows in another order and are held at rtol 1e-6.  The random attacks cannot
reproduce ``jax.random`` streams and are checked by distribution and by the
entries they touch.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import attacks as ratk
from repro.core import registry as rreg
from repro_torch.core import attacks as tatk
from repro_torch.core import registry as treg

KEY = jax.random.PRNGKey(0)


def _u(m=10, d=64, seed=0):
    return np.random.default_rng(seed).standard_normal((m, d)).astype(
        np.float32)


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


@pytest.mark.parametrize("name", ["signflip", "zero", "bitplane_flip",
                                  "scale_inflate"])
def test_deterministic_attacks_bit_exact(name):
    u = _u()
    cfg_kw = dict(name=name, num_byzantine=3)
    want = ratk.make_attack(ratk.AttackConfig(**cfg_kw))(KEY, jnp.asarray(u))
    got = tatk.make_attack(tatk.AttackConfig(**cfg_kw))(_gen(), torch.tensor(u))
    assert np.array_equal(_bits(got.numpy()), _bits(want))


@pytest.mark.parametrize("name", ["omniscient", "innerprod"])
def test_row_reducing_attacks_match(name):
    u = _u()
    cfg_kw = dict(name=name, num_byzantine=3)
    want = ratk.make_attack(ratk.AttackConfig(**cfg_kw))(KEY, jnp.asarray(u))
    got = tatk.make_attack(tatk.AttackConfig(**cfg_kw))(_gen(), torch.tensor(u))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    assert np.array_equal(got.numpy()[3:], u[3:])


def test_attacks_leave_the_input_untouched():
    u = torch.tensor(_u())
    before = u.clone()
    for name in treg.available_attacks():
        fn = tatk.make_attack(tatk.AttackConfig(name=name, num_byzantine=2))
        fn(_gen(), u, 3)
    assert torch.equal(u, before)


def test_flip_bits_bit_exact_on_special_values():
    x = np.array([0.0, -0.0, 1.0, -2.5, 3e-39, 1e20, -1e-20, np.inf],
                 np.float32)
    for bits in ((22, 30, 31, 32), (32,), (1,), (24, 31)):
        want = ratk._flip_bits_f32(jnp.asarray(x), bits)
        got = tatk._flip_bits_f32(torch.tensor(x), bits)
        assert np.array_equal(_bits(got.numpy()), _bits(want)), bits


def test_bitflip_touches_q_rows_per_attacked_dim():
    m, d, q, nd = 12, 300, 4, 200
    u = _u(m, d, 1)
    got = tatk.bitflip_attack(_gen(3), torch.tensor(u), q, num_dims=nd)
    got_bits, u_bits = _bits(got.numpy()), _bits(u)
    hit = got_bits != u_bits
    assert np.all(hit[:, :nd].sum(axis=0) == q)
    assert not hit[:, nd:].any()
    flipped = _bits(ratk._flip_bits_f32(jnp.asarray(u), (22, 30, 31, 32)))
    assert np.array_equal(got_bits[hit], flipped[hit])
    # uniform choice of rows: each row is hit in about q/m of the columns
    frac = hit[:, :nd].mean(axis=1)
    assert np.all(np.abs(frac - q / m) < 0.15)
    ref = np.asarray(ratk.bitflip_attack(KEY, jnp.asarray(u), q,
                                         num_dims=nd))
    assert np.all((_bits(ref) != u_bits)[:, :nd].sum(axis=0) == q)


def test_gaussian_replaces_first_q_rows_with_noise():
    m, d, q = 10, 20000, 3
    u = _u(m, d, 2)
    got = tatk.gaussian_attack(_gen(5), torch.tensor(u), q, 200.0).numpy()
    ref = np.asarray(ratk.gaussian_attack(KEY, jnp.asarray(u), q, 200.0))
    assert np.array_equal(got[q:], u[q:])
    for x in (got[:q], ref[:q]):
        assert abs(x.mean()) < 5.0
        assert abs(x.std() - 200.0) < 5.0


def test_gambler_hits_only_the_first_server_slice():
    m, d, servers, prob = 16, 4000, 20, 0.05
    u = _u(m, d, 3)
    got = tatk.gambler_attack(_gen(7), torch.tensor(u), servers, prob,
                              -1e20).numpy()
    size = d // servers
    hit = got != u
    assert not hit[:, size:].any()
    np.testing.assert_array_equal(got[hit], np.float32(-1e20) * u[hit])
    ref = np.asarray(ratk.gambler_attack(KEY, jnp.asarray(u), servers, prob,
                                         -1e20))
    ref_frac = (ref != u)[:, :size].mean()
    for frac in (hit[:, :size].mean(), ref_frac):
        assert abs(frac - prob) < 0.02


def test_slowburn_phases():
    u = _u(10, 5000, 4)
    q, kw = 3, dict(trigger=5, scale=100.0, mimic_std=0.01)
    strike = tatk.slowburn_attack(_gen(), torch.tensor(u), q, 7, **kw)
    ref = ratk.slowburn_attack(KEY, jnp.asarray(u), q, jnp.asarray(7), **kw)
    np.testing.assert_allclose(strike.numpy(), np.asarray(ref), rtol=1e-6)
    worst = tatk.slowburn_attack(_gen(), torch.tensor(u), q, None, **kw)
    np.testing.assert_allclose(worst.numpy(), strike.numpy(), rtol=0)
    mimic = tatk.slowburn_attack(_gen(), torch.tensor(u), q, 2, **kw).numpy()
    dev = mimic[:q] - u[q:].mean(axis=0, keepdims=True)
    assert abs(dev.std() - 0.01) < 1e-3
    assert np.array_equal(mimic[q:], u[q:])


def test_attack_registry_matches_reference():
    assert treg.available_attacks() == rreg.available_attacks()
    for name in rreg.available_attacks():
        r, t = rreg.get_attack_spec(name), treg.get_attack_spec(name)
        assert (t.kind, t.paper_q, t.step_aware) == (r.kind, r.paper_q,
                                                    r.step_aware)
    import dataclasses
    rf = {f.name: f.default for f in dataclasses.fields(ratk.AttackConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(tatk.AttackConfig)}
    assert rf == tf
    assert tatk.make_attack(tatk.AttackConfig()) is None
