"""``ScenarioSpec`` — one frozen, JSON-round-trippable experiment.

Port of ``repro/experiment/spec.py``.  The port reads the reference's JSON
unchanged (``examples/scenarios/*.json``), so every field is kept; ``defense``
parses into :class:`repro_torch.defense.DefenseConfig`, ``faults`` into
:class:`repro_torch.faults.FaultSpec` and ``compression`` into
:class:`repro_torch.compress.CompressionSpec`.  The axes this package does not
run yet are refused with ``NotImplementedError`` naming the ROADMAP queue
item that brings them.  A ``mesh`` (``"DxM"``, data x model) runs on
``sync_ps`` as one ``torch.distributed`` rank per mesh device
(``experiment/runner.py``); faults and compression refuse a mesh, as in the
reference.  An arch model trains on the token stream on every training
topology and serves on the ``serve`` topology.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Optional, Tuple

from repro_torch.compress.spec import (CompressError, CompressionSpec,
                                       validate_compression)
from repro_torch.core.attacks import AttackConfig
from repro_torch.core.robust import RobustConfig
from repro_torch.defense.reputation import DefenseConfig
from repro_torch.faults.spec import FaultError, FaultSpec, validate_faults
from repro_torch.optim.optimizers import OptConfig

SCHEDULES = ("", "constant", "cosine_decay", "warmup_cosine")


class SpecError(ValueError):
    """A scenario failed validation (actionable message, raised pre-run)."""


def not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP queue 1 {item})")


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """What to train: the paper's MLP/CNN, or a zoo arch (``kind="arch"``)."""
    kind: str = "mlp"             # mlp | cnn | arch
    arch: str = ""
    dims: Tuple[int, ...] = ()    # MLP layer dims; () = (dim, 128, 128, C)
    cnn_size: int = 16            # CNN input is (size, size, channels)
    cnn_channels: int = 3
    remat: str = "none"


@dataclasses.dataclass(frozen=True)
class DataSpec:
    """What to train on: the Gaussian-mixture classification substrate."""
    kind: str = "classification"  # classification | tokens
    dim: int = 64
    num_classes: int = 10
    noise: float = 0.8
    seq_len: int = 64
    batch_per_worker: int = 20    # global batch = num_workers * this
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class ScenarioSpec:
    """One experiment, as declarative data."""
    name: str = "scenario"
    topology: str = "sync_ps"
    topology_params: Dict[str, Any] = dataclasses.field(default_factory=dict)
    model: ModelSpec = dataclasses.field(default_factory=ModelSpec)
    data: DataSpec = dataclasses.field(default_factory=DataSpec)
    robust: RobustConfig = dataclasses.field(default_factory=RobustConfig)
    attack: AttackConfig = dataclasses.field(default_factory=AttackConfig)
    defense: Optional[DefenseConfig] = None
    opt: OptConfig = dataclasses.field(default_factory=OptConfig)
    schedule: str = ""
    schedule_params: Dict[str, Any] = dataclasses.field(default_factory=dict)
    num_workers: int = 20
    steps: int = 100
    seed: int = 0
    mesh: str = ""
    log_every: int = 0            # history/eval cadence; 0 = steps//20
    checkpoint_path: str = ""
    checkpoint_every: int = 0
    telemetry_path: str = ""
    faults: Tuple[FaultSpec, ...] = ()
    compression: CompressionSpec = dataclasses.field(
        default_factory=CompressionSpec)

    # -- resolution helpers ------------------------------------------------

    def effective_attack(self) -> AttackConfig:
        """``attack`` wins; a legacy attack inside ``robust`` is honored when
        ``attack`` is clean."""
        if self.attack.name not in ("none", ""):
            return self.attack
        return self.robust.attack

    def effective_robust(self) -> RobustConfig:
        return dataclasses.replace(self.robust,
                                   attack=self.effective_attack())

    def record_every(self) -> int:
        return self.log_every if self.log_every > 0 else max(
            self.steps // 20, 1)

    # -- JSON round-trip ---------------------------------------------------

    def to_dict(self) -> dict:
        return _encode(self)

    @classmethod
    def from_dict(cls, d: dict) -> "ScenarioSpec":
        return _decode_dataclass(cls, d)

    def to_json(self) -> str:
        """Canonical JSON (sorted keys, 2-space indent)."""
        return json.dumps(self.to_dict(), indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "ScenarioSpec":
        return cls.from_dict(json.loads(s))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json() + "\n")

    @classmethod
    def load(cls, path: str) -> "ScenarioSpec":
        with open(path) as f:
            return cls.from_json(f.read())

    # -- validation --------------------------------------------------------

    def validate(self) -> "ScenarioSpec":
        """Check this spec against the port's registries.

        Raises :class:`SpecError` for a bad spec and ``NotImplementedError``
        for an axis the port does not run yet.  Returns ``self``.
        """
        from repro_torch.core import registry
        from repro_torch.experiment.topology import make_topology

        if self.steps < 1:
            raise SpecError(f"steps must be >= 1, got {self.steps}")
        m = self.num_workers
        if m < 2:
            raise SpecError(f"num_workers must be >= 2, got {m}")
        if self.data.batch_per_worker < 1:
            raise SpecError("data.batch_per_worker must be >= 1, got "
                            f"{self.data.batch_per_worker}")

        if self.model.kind not in ("mlp", "cnn", "arch"):
            raise SpecError(f"model.kind {self.model.kind!r} unknown; "
                            "valid: mlp | cnn | arch")
        if self.data.kind not in ("classification", "tokens"):
            raise SpecError(f"data.kind {self.data.kind!r} unknown; "
                            "valid: classification | tokens")
        if self.model.kind == "arch":
            if not self.model.arch:
                raise SpecError("model.kind='arch' needs model.arch "
                                "(see repro_torch.configs.list_archs())")
            if self.data.kind != "tokens":
                raise SpecError("arch models train on data.kind='tokens', "
                                f"got {self.data.kind!r}")
            from repro_torch.configs import get_arch
            try:
                get_arch(self.model.arch)
            except KeyError as e:
                raise SpecError(str(e)) from None
        elif self.data.kind != "classification":
            raise SpecError(f"model.kind={self.model.kind!r} trains on "
                            "data.kind='classification', got "
                            f"{self.data.kind!r}")
        if self.model.kind == "cnn":
            want = self.model.cnn_size ** 2 * self.model.cnn_channels
            if self.data.dim != want:
                raise SpecError(
                    f"cnn model needs data.dim == cnn_size^2 * cnn_channels "
                    f"= {want}, got {self.data.dim}")
        if self.model.kind == "mlp" and self.model.dims:
            if self.model.dims[0] != self.data.dim:
                raise SpecError(f"model.dims[0]={self.model.dims[0]} must "
                                f"equal data.dim={self.data.dim}")
            if self.model.dims[-1] != self.data.num_classes:
                raise SpecError(
                    f"model.dims[-1]={self.model.dims[-1]} must equal "
                    f"data.num_classes={self.data.num_classes}")

        try:
            rule_cls = registry.get_rule(self.robust.rule)
            registry.resolve_backend(rule_cls, self.robust.backend)
        except ValueError as e:
            raise SpecError(str(e)) from None
        bmax = (m + 1) // 2 - 1
        if rule_cls.uses_b and not 0 <= self.robust.b <= bmax:
            raise SpecError(
                f"rule {self.robust.rule!r} needs 0 <= b <= (m+1)//2-1 = "
                f"{bmax} for m={m} workers, got b={self.robust.b}")
        if rule_cls.uses_q and not 0 <= self.robust.q <= m - 3:
            raise SpecError(
                f"rule {self.robust.rule!r} needs 0 <= q <= m-3 = {m - 3} "
                f"(Krum selection needs m-q-2 > 0), got q={self.robust.q}")

        if (self.attack.name not in ("none", "")
                and self.robust.attack.name not in ("none", "")):
            raise SpecError(
                "both spec.attack and spec.robust.attack are set "
                f"({self.attack.name!r} vs {self.robust.attack.name!r}); "
                "the scenario's attack axis is spec.attack")
        atk = self.effective_attack()
        if atk.name not in ("none", ""):
            try:
                registry.get_attack_spec(atk.name)
            except ValueError as e:
                raise SpecError(str(e)) from None

        if self.defense is not None:
            if self.robust.rule not in registry.score_rules():
                raise SpecError(
                    f"defense needs a score-emitting rule (emits_scores); "
                    f"{self.robust.rule!r} is not one of "
                    f"{registry.score_rules()}")
            if self.defense.adapt_b and not (rule_cls.uses_b
                                             or rule_cls.uses_q):
                raise SpecError(
                    f"defense.adapt_b tunes the rule's b/q, but rule "
                    f"{self.robust.rule!r} consumes neither")
        if self.faults:
            try:
                validate_faults(self.faults, m)
            except FaultError as e:
                raise SpecError(str(e)) from None
            if self.defense is not None and self.defense.adapt_b:
                raise SpecError(
                    "faults and defense.adapt_b both re-resolve the rule's "
                    "trim width (quorum vs suspicion); pick one per run")
            if self.mesh:
                raise SpecError(
                    "faults model whole-worker absence; a dim-sharded mesh "
                    "splits each worker across devices and cannot drop one "
                    "— run faults without mesh")
        if self.compression.enabled:
            try:
                validate_compression(self.compression)
            except CompressError as e:
                raise SpecError(str(e)) from None
            if self.mesh:
                raise SpecError(
                    "compression encodes each worker's full gradient row; "
                    "a dim-sharded mesh splits rows across devices and the "
                    "codec wire model no longer applies — run compression "
                    "without mesh")

        if not isinstance(self.opt.lr, (int, float)):
            raise SpecError("spec.opt.lr must be a number; express "
                            "schedules via spec.schedule + schedule_params")
        if self.schedule not in SCHEDULES:
            raise SpecError(f"unknown schedule {self.schedule!r}; "
                            f"valid: {SCHEDULES[1:]}")
        if self.mesh:
            from repro_torch.dist.mesh import parse_mesh
            try:
                d, _ = parse_mesh(self.mesh)
            except ValueError as e:
                raise SpecError(str(e)) from None
            if d != m:
                raise SpecError(
                    f"mesh={self.mesh!r} has a data axis of {d} but "
                    f"num_workers={m}; the mesh data axis plays the worker "
                    "role and the two must agree")

        try:
            topo = make_topology(self.topology)
        except ValueError as e:
            raise SpecError(str(e)) from None
        topo.validate_spec(self)
        return self


# ---------------------------------------------------------------------------
# JSON codec: nested dataclasses <-> plain dicts, tuples <-> lists
# ---------------------------------------------------------------------------

_NESTED_FIELDS = {
    "model": ModelSpec,
    "data": DataSpec,
    "robust": RobustConfig,
    "attack": AttackConfig,
    "defense": DefenseConfig,
    "opt": OptConfig,
    "inner": FaultSpec,   # FaultSpec's pod-wrapped kind
    "compression": CompressionSpec,
}


def _encode(v):
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return {f.name: _encode(getattr(v, f.name))
                for f in dataclasses.fields(v)}
    if isinstance(v, (list, tuple)):
        return [_encode(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _encode(x) for k, x in v.items()}
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    raise SpecError(
        f"value {v!r} of type {type(v).__name__} is not JSON-serializable; "
        "scenario specs hold plain data only")


def _decode_value(v):
    if isinstance(v, list):
        return tuple(_decode_value(x) for x in v)
    if isinstance(v, dict):
        return {k: _decode_value(x) for k, x in v.items()}
    return v


def _decode_dataclass(cls, d):
    if d is None:
        return None
    if not isinstance(d, dict):
        raise SpecError(f"expected a JSON object for {cls.__name__}, "
                        f"got {type(d).__name__}")
    valid = {f.name for f in dataclasses.fields(cls)}
    unknown = sorted(set(d) - valid)
    if unknown:
        raise SpecError(f"unknown field(s) {unknown} for {cls.__name__}; "
                        f"valid fields: {sorted(valid)}")
    kwargs = {}
    for name, v in d.items():
        if name in _NESTED_FIELDS and isinstance(v, (dict, type(None))):
            kwargs[name] = _decode_dataclass(_NESTED_FIELDS[name], v)
        elif name in ("topology_params", "schedule_params"):
            kwargs[name] = dict(v) if v else {}
        elif name == "faults":
            kwargs[name] = tuple(_decode_dataclass(FaultSpec, x)
                                 for x in (v or ()))
        else:
            kwargs[name] = _decode_value(v)
    return cls(**kwargs)
