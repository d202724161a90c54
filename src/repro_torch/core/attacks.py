"""Byzantine attack suite (paper §5 + beyond-paper extensions).

Port of ``repro/core/attacks.py``.  Every attack is a function
``(gen, u) -> u_tilde`` over the worker-gradient matrix ``u`` of shape
``(m, d)`` (f32), where ``gen`` is a ``torch.Generator`` on ``u``'s device
(unused by the deterministic attacks).  Attacks return a new tensor and
leave ``u`` untouched; inside :func:`writing_in_place` the built-in ones
write into ``u`` and return it instead, for a caller that owns an (m, d)
matrix too large to hold twice (an LM's).  The random attacks cannot
reproduce ``jax.random``
streams; they match the reference in distribution and in which entries they
touch.

Classic attacks corrupt whole rows (workers); dimensional attacks corrupt
individual coordinates anywhere in the matrix (Definition 4).
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import zlib
from typing import Callable, Optional

import torch

from repro_torch.core.registry import get_attack_spec, register_attack

Attack = Callable[..., torch.Tensor]   # (gen, u, step=None) -> u_tilde


@dataclasses.dataclass(frozen=True)
class AttackConfig:
    """Configuration of the injected failure model."""
    name: str = "none"                 # attack kind
    num_byzantine: int = 0             # q: rows, or values per dim (dimensional)
    gaussian_std: float = 200.0        # paper: std 200
    omniscient_scale: float = 1e20     # paper: 1e20
    bitflip_dims: int = 1000           # paper: first 1000 dimensions
    bitflip_bits: tuple = (22, 30, 31, 32)  # 1-indexed from the LSB
    gambler_servers: int = 20          # paper: 20 servers
    gambler_prob: float = 0.0005       # paper: 0.05%
    gambler_scale: float = -1e20
    innerprod_scale: float = 2.0       # Fall-of-Empires epsilon
    slowburn_trigger: int = 50         # step at which the colluders strike
    slowburn_scale: float = 100.0      # strike magnitude
    slowburn_mimic_std: float = 0.01   # trust-building mimicry noise
    inflate_scale: float = 100.0       # scale_inflate: payload-scale factor


def fold_seed(seed: int, data: int) -> int:
    """A generator seed derived from ``seed`` and ``data`` (the port's
    analogue of ``jax.random.fold_in``): stable across processes."""
    return zlib.crc32(f"{seed}:{data}".encode())


_IN_PLACE = threading.local()


@contextlib.contextmanager
def writing_in_place():
    """Inside, the built-in attacks write into the matrix they are given
    (whose caller owns it and reads only the result) instead of a copy."""
    prev = getattr(_IN_PLACE, "on", False)
    _IN_PLACE.on = True
    try:
        yield
    finally:
        _IN_PLACE.on = prev


def _writable(u: torch.Tensor) -> torch.Tensor:
    return u if getattr(_IN_PLACE, "on", False) else u.clone()


def _with_rows(u: torch.Tensor, q: int, rows: torch.Tensor) -> torch.Tensor:
    """``u`` with its first q rows replaced by ``rows``, which the callers
    compute from ``u`` beforehand, so a write in place reads nothing
    stale."""
    out = _writable(u)
    out[:q] = rows
    return out


# ---------------------------------------------------------------------------
# Classic (row-wise) attacks
# ---------------------------------------------------------------------------

def gaussian_attack(gen, u: torch.Tensor, q: int,
                    std: float = 200.0) -> torch.Tensor:
    """Replace the first q rows with N(0, std²) noise (§5.1.1)."""
    noise = torch.randn((q, u.shape[1]), generator=gen, dtype=u.dtype,
                        device=u.device)
    return _with_rows(u, q, std * noise)


def omniscient_attack(gen, u: torch.Tensor, q: int,
                      scale: float = 1e20) -> torch.Tensor:
    """Replace the first q rows with -scale * sum(correct grads) (§5.1.2)."""
    # scaled in place: at an LM's width the sum is gigabytes, and a scaled
    # copy beside it is the step's peak
    bad = u[q:].sum(dim=0, keepdim=True).mul_(-scale)
    return _with_rows(u, q, bad.expand(q, -1))


def signflip_attack(gen, u: torch.Tensor, q: int,
                    scale: float = 10.0) -> torch.Tensor:
    """Beyond-paper: first q rows flipped in sign and scaled."""
    return _with_rows(u, q, -scale * u[:q])


def zero_attack(gen, u: torch.Tensor, q: int) -> torch.Tensor:
    """Beyond-paper: first q rows zeroed (crash-stop workers)."""
    return _with_rows(u, q, torch.zeros_like(u[:q]))


def innerprod_attack(gen, u: torch.Tensor, q: int,
                     scale: float = 2.0) -> torch.Tensor:
    """Inner-product manipulation ("Fall of Empires", Xie et al. 2019): each
    of the q colluders submits ``-scale * mean(correct gradients)``."""
    correct_mean = u[q:].mean(dim=0, keepdim=True)
    return _with_rows(u, q, (-scale * correct_mean).expand(q, -1))


def bitplane_flip_attack(gen, u: torch.Tensor, q: int) -> torch.Tensor:
    """Wire-level sign-plane flip: the first q workers XOR the sign bit of
    every value they send (exact negation on a dense f32 payload)."""
    return _with_rows(u, q, _flip_bits_f32(u[:q], (32,)).to(u.dtype))


def scale_inflate_attack(gen, u: torch.Tensor, q: int,
                         scale: float = 100.0) -> torch.Tensor:
    """Wire-level scale inflation: the first q rows scaled by ``scale``."""
    return _with_rows(u, q, u[:q] * scale)


# ---------------------------------------------------------------------------
# Adaptive (step-aware) attacks
# ---------------------------------------------------------------------------

def slowburn_attack(gen, u: torch.Tensor, q: int, step,
                    trigger: int = 50, scale: float = 100.0,
                    mimic_std: float = 0.01) -> torch.Tensor:
    """Reputation-EMA slow burn: before ``trigger`` the q colluders submit
    the benign mean plus tiny noise; from ``trigger`` on they strike with
    ``-scale * mean(correct)``.  ``step=None`` assumes the strike phase."""
    d = u.shape[1]
    correct_mean = u[q:].mean(dim=0, keepdim=True)
    noise = torch.randn((q, d), generator=gen, dtype=u.dtype,
                        device=u.device)
    mimic = correct_mean.expand(q, d) + mimic_std * noise
    strike = (-scale * correct_mean).expand(q, d)
    if step is None or int(step) >= trigger:
        return _with_rows(u, q, strike)
    return _with_rows(u, q, mimic)


# ---------------------------------------------------------------------------
# Dimensional (generalized) attacks
# ---------------------------------------------------------------------------

def _flip_bits_f32(x: torch.Tensor, bits: tuple) -> torch.Tensor:
    """XOR the given bits (1-indexed from the LSB) of each fp32 value, on
    the int32 view of the floats (bit-exact with the reference's uint32
    bitcast)."""
    mask = 0
    for bit in bits:
        mask |= 1 << (bit - 1)
    if mask >= 1 << 31:              # the same 32 bits as a signed int32
        mask -= 1 << 32
    xi = x.float().contiguous().view(torch.int32)
    return (xi ^ mask).view(torch.float32)


def bitflip_attack(gen, u: torch.Tensor, q: int, num_dims: int = 1000,
                   bits: tuple = (22, 30, 31, 32)) -> torch.Tensor:
    """§5.1.3: for each of the first ``num_dims`` dimensions, q uniformly
    chosen distinct rows of the m get their bits flipped."""
    m, d = u.shape
    nd = min(num_dims, d)
    scores = torch.rand((m, nd), generator=gen, device=u.device)
    ranks = torch.argsort(torch.argsort(scores, dim=0), dim=0)
    hit = ranks < q                                  # exactly q per column
    head = u[:, :nd]
    out = _writable(u)
    out[:, :nd] = torch.where(hit, _flip_bits_f32(head, bits).to(u.dtype),
                              head)
    return out


def gambler_attack(gen, u: torch.Tensor, num_servers: int = 20,
                   prob: float = 0.0005, scale: float = -1e20
                   ) -> torch.Tensor:
    """§5.1.4: the attacker owns server 0 of ``num_servers`` (a contiguous
    1/num_servers slice of the dimensions) and multiplies each value it
    relays by ``scale`` with probability ``prob``."""
    m, d = u.shape
    server_size = max(1, d // num_servers)
    hit = torch.rand((m, server_size), generator=gen,
                     device=u.device) < prob
    head = u[:, :server_size]
    out = _writable(u)
    out[:, :server_size] = torch.where(hit, scale * head, head)
    return out


# ---------------------------------------------------------------------------
# Registration + dispatch
# ---------------------------------------------------------------------------

@register_attack("gaussian", kind="classic", paper_q=6)
def _gaussian(cfg: AttackConfig) -> Attack:
    return lambda g, u: gaussian_attack(g, u, cfg.num_byzantine,
                                        cfg.gaussian_std)


@register_attack("omniscient", kind="classic", paper_q=6)
def _omniscient(cfg: AttackConfig) -> Attack:
    return lambda g, u: omniscient_attack(g, u, cfg.num_byzantine,
                                          cfg.omniscient_scale)


@register_attack("signflip", kind="classic", paper_q=6)
def _signflip(cfg: AttackConfig) -> Attack:
    return lambda g, u: signflip_attack(g, u, cfg.num_byzantine)


@register_attack("zero", kind="classic", paper_q=6)
def _zero(cfg: AttackConfig) -> Attack:
    return lambda g, u: zero_attack(g, u, cfg.num_byzantine)


@register_attack("innerprod", kind="classic", paper_q=6)
def _innerprod(cfg: AttackConfig) -> Attack:
    return lambda g, u: innerprod_attack(g, u, cfg.num_byzantine,
                                         cfg.innerprod_scale)


@register_attack("bitplane_flip", kind="classic", paper_q=4)
def _bitplane_flip(cfg: AttackConfig) -> Attack:
    return lambda g, u: bitplane_flip_attack(g, u, cfg.num_byzantine)


@register_attack("scale_inflate", kind="classic", paper_q=4)
def _scale_inflate(cfg: AttackConfig) -> Attack:
    return lambda g, u: scale_inflate_attack(g, u, cfg.num_byzantine,
                                             cfg.inflate_scale)


@register_attack("slowburn", kind="adaptive", paper_q=6, step_aware=True)
def _slowburn(cfg: AttackConfig) -> Attack:
    return lambda g, u, step=None: slowburn_attack(
        g, u, cfg.num_byzantine, step, cfg.slowburn_trigger,
        cfg.slowburn_scale, cfg.slowburn_mimic_std)


@register_attack("bitflip", kind="dimensional", paper_q=1)
def _bitflip(cfg: AttackConfig) -> Attack:
    return lambda g, u: bitflip_attack(g, u, cfg.num_byzantine,
                                       cfg.bitflip_dims, cfg.bitflip_bits)


@register_attack("gambler", kind="dimensional", paper_q=0)
def _gambler(cfg: AttackConfig) -> Attack:
    return lambda g, u: gambler_attack(g, u, cfg.gambler_servers,
                                       cfg.gambler_prob, cfg.gambler_scale)


def make_attack(cfg: AttackConfig) -> Optional[Attack]:
    """Build a ``(gen, u, step=None) -> u_tilde`` closure from the config
    (None = clean)."""
    name = cfg.name.lower()
    if name in ("none", ""):
        return None
    spec = get_attack_spec(name)
    fn = spec.factory(cfg)
    if spec.step_aware:
        return fn
    return lambda gen, u, step=None: fn(gen, u)
