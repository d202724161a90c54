"""The port's train CLI (``repro_torch.launch.train``) against the reference's
on the CPU: the spec its flags build (JSON equal over a grid of flag sets),
``--dump-scenario`` files byte for byte, a scenario run's metrics snapshot
(series names, counters and deterministic gauges equal to the reference
run's), every example scenario to ``[train] done``, a ``--mesh 2x1`` run
(the ``--workers`` override, rank 0's snapshot, one profiler trace a rank,
the spawner's backend line), the spawner's backend rule
(``dist/launch.py::plan_world``) on a table of hosts, and a ``torchrun``
world joined in this process (``join_torchrun``).
``tests/test_torch_import.py`` imports these modules, as every module of the
port, with JAX blocked."""
import dataclasses
import glob
import json
import os
import sys

import pytest
import torch

from repro.launch import train as r_cli
from repro_torch.launch import train as cli
from repro_torch.obs import parse_exposition

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENARIOS = os.path.join(REPO, "examples", "scenarios")
ARCH = ["--arch", "gemma2-2b-reduced"]


def _ref_main(monkeypatch, argv):
    monkeypatch.setattr(sys, "argv", ["train"] + list(argv))
    r_cli.main()


FLAG_SETS = {
    "defaults": ARCH,
    "mesh": ARCH + ["--mesh", "4x2", "--global-batch", "8", "--rule",
                    "trmean", "--b", "1", "--attack", "gaussian", "--q",
                    "1"],
    "faults": ARCH + ["--fault", "crash,workers=7+8,step=40", "--fault",
                      "straggler,workers=5,delay_steps=2,jitter=1",
                      "--fault", "pod,workers=0-3,inner=crash,step=60",
                      "--fault", "flaky,workers=9,p_drop=0.25"],
    "compress": ARCH + ["--compress", "topk,ratio=0.05", "--attack",
                        "bitflip", "--q", "2"],
    "signbit": ARCH + ["--compress", "signbit", "--rule", "signvote"],
    "topology": ARCH + ["--topology", "async_ps", "--topology-param",
                        "staleness=3", "--topology-param",
                        "update_clip=2.5", "--workers", "8",
                        "--global-batch", "16"],
    "defense": ARCH + ["--defense", "--adapt-b", "--reputation-decay",
                       "0.7", "--telemetry", "t.jsonl", "--attack",
                       "signflip", "--q", "3", "--rule", "krum",
                       "--multikrum-k", "5"],
    "other_arch": ["--arch", "deepseek-v2-lite-16b-reduced", "--remat",
                   "full", "--seq-len", "32", "--optimizer", "adam",
                   "--lr", "0.01", "--checkpoint", "ck.pt",
                   "--checkpoint-every", "7", "--seed", "3",
                   "--backend", "xla", "--layout", "replicated"],
}


@pytest.mark.parametrize("name", sorted(FLAG_SETS))
def test_build_spec_json_equals_reference(name, capsys):
    args = cli.make_parser().parse_args(FLAG_SETS[name])
    got = cli.build_spec(args).to_json()
    port_out = capsys.readouterr().out
    want = r_cli.build_spec(args).to_json()
    assert got == want
    assert port_out == capsys.readouterr().out
    if name == "mesh":
        assert "overriding --workers to mesh data size 4" in port_out


@pytest.mark.parametrize("name", ["defaults", "faults", "defense"])
def test_dump_scenario_files_are_byte_equal(name, tmp_path, monkeypatch,
                                            capsys):
    ours, theirs = tmp_path / "port.json", tmp_path / "ref.json"
    cli.main(FLAG_SETS[name] + ["--dump-scenario", str(ours)])
    _ref_main(monkeypatch, FLAG_SETS[name] + ["--dump-scenario",
                                              str(theirs)])
    assert ours.read_bytes() == theirs.read_bytes()
    out = capsys.readouterr().out.splitlines()
    assert out[0].replace(str(ours), "F") == out[-1].replace(str(theirs),
                                                             "F")


def test_deprecated_flag_and_missing_arch(tmp_path, capsys, monkeypatch):
    path = tmp_path / "s.json"
    cli.main(ARCH + ["--use-kernels", "--dump-scenario", str(path)])
    assert "--use-kernels is deprecated" in capsys.readouterr().out
    assert json.loads(path.read_text())["robust"]["backend"] == "pallas"
    with pytest.raises(SystemExit):
        cli.main(["--steps", "2"])
    assert "--arch is required" in capsys.readouterr().err
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["--scenario", os.path.join(SCENARIOS,
                                             "sync_ps_gaussian.json")])


def _series(path) -> dict:
    """{(series, labels): value} of a snapshot."""
    with open(path) as fh:
        fams = parse_exposition(fh.read())
    return {(s, tuple(sorted(lab.items()))): v
            for fam in fams.values() for s, lab, v in fam["samples"]}


def test_scenario_snapshot_matches_reference(tmp_path, monkeypatch, capsys):
    """``sync_ps_gaussian.json`` with a deterministic attack and the
    defense on, through both CLIs: the same series; equal counters, span
    counts and gauges that depend on no random draw (q̂, the margin, the
    Δ bound); the report of the port's JSONL prints its timeline."""
    from repro_torch.core.attacks import AttackConfig
    from repro_torch.defense import DefenseConfig
    from repro_torch.experiment import DataSpec, ModelSpec, ScenarioSpec
    from repro_torch.obs.report import main as report_main
    spec = dataclasses.replace(
        ScenarioSpec.load(os.path.join(SCENARIOS, "sync_ps_gaussian.json")),
        steps=8, model=ModelSpec(kind="mlp", dims=(32, 32, 10)),
        data=DataSpec(dim=32, batch_per_worker=16, seed=1),
        attack=AttackConfig(name="signflip", num_byzantine=2),
        defense=DefenseConfig(reputation_decay=0.6, warmup_steps=1),
        telemetry_path=str(tmp_path / "run.jsonl"))
    scenario = tmp_path / "s.json"
    spec.save(str(scenario))
    ours, theirs = tmp_path / "port.prom", tmp_path / "ref.prom"
    cli.main(["--scenario", str(scenario), "--device", "cpu", "--metrics",
              str(ours)])
    out = capsys.readouterr().out
    assert f"[train] wrote metrics snapshot {ours}" in out
    assert "[train] defense: q_hat=2 active=6/8" in out
    assert out.rstrip().endswith("[train] done")
    assert report_main([spec.telemetry_path]) == 0
    report = capsys.readouterr().out
    assert "worker 0 ejected (train)" in report
    assert "worker 1 ejected (train)" in report
    _ref_main(monkeypatch, ["--scenario", str(scenario), "--metrics",
                            str(theirs)])
    got, want = _series(ours), _series(theirs)
    assert set(got) == set(want)
    exact = ("repro_steps", "repro_ejections", "repro_span_ms_count",
             "repro_q_hat", "repro_resilience_margin",
             "repro_delta_bound_unit_var", "repro_train_q_hat")
    compared = [k for k in want if k[0] in exact]
    assert len(compared) >= 7
    for key in compared:
        assert got[key] == want[key], key
    assert got[("repro_step_flops", ())] > 0
    assert got[("repro_step_bytes", ())] > 0


@pytest.mark.parametrize("path", sorted(
    p for p in glob.glob(os.path.join(SCENARIOS, "*.json"))
    if not p.endswith("sync_ps_gaussian.json")))
def test_every_example_scenario_runs(path, capsys):
    cli.main(["--scenario", path, "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.rstrip().endswith("[train] done")
    with open(path) as fh:
        assert f"topology={json.load(fh)['topology']}" in out


def test_mesh_run_overrides_workers_and_rank0_writes(tmp_path, capfd):
    """Two spawned CPU ranks: the override line, rank 0's snapshot and
    JSONL, a profiler trace from each rank."""
    from repro_torch.defense import read_jsonl
    snap, jsonl = tmp_path / "m.prom", tmp_path / "t.jsonl"
    prof = tmp_path / "prof"
    cli.main(ARCH + ["--workers", "4", "--mesh", "2x1", "--global-batch",
                     "2", "--seq-len", "8", "--steps", "2", "--b", "0",
                     "--device", "cpu", "--metrics", str(snap),
                     "--telemetry", str(jsonl), "--profile-dir",
                     str(prof)])
    out = capfd.readouterr().out
    assert "mesh: 2 ranks, gloo, on cpu" in out
    assert "[train] overriding --workers to mesh data size 2" in out
    assert "mesh=2x1" in out and out.rstrip().endswith("[train] done")
    # one step line a step: rank 0 alone prints
    assert sum(line.startswith("step ") for line in out.splitlines()) == 2
    series = _series(snap)
    assert series[("repro_steps", (("topology", "sync_ps"),))] == 2
    assert series[("repro_step_flops", ())] > 0
    assert sorted(os.listdir(prof)) == ["rank0", "rank1"]
    for r in ("rank0", "rank1"):
        assert (prof / r / "trace.json").stat().st_size > 0
    spans = [r for r in read_jsonl(str(jsonl)) if r["kind"] == "span"]
    assert len(spans) == 2


def test_only_rank0_keeps_the_snapshot_path():
    from repro_torch.experiment.topologies import _rank_obs
    from repro_torch.obs import ObsConfig
    obs = ObsConfig(metrics_path="m.prom", profile_dir="p")
    plan = type("P", (), {"obs": obs})
    assert _rank_obs(plan, True) is obs
    other = _rank_obs(plan, False)
    assert other.metrics_path is None and other.profile_dir == "p"
    assert other.enabled and other.profile_cost


# (caller's device, cards on the host, world) -> (backend, each rank's device)
WORLDS = {
    "CPU ranks": (("cpu", 0, 4), ("gloo", ("cpu",) * 4)),
    "1 card, world 8": (("cuda", 1, 8), ("gloo", ("cuda",) * 8)),
    "4 cards, world 4": (("cuda", 4, 4),
                         ("nccl", ("cuda:0", "cuda:1", "cuda:2", "cuda:3"))),
    "2 cards, world 4": (("cuda", 2, 4), ("gloo", ("cuda",) * 4)),
    "4 cards, world 2": (("cuda:0", 4, 2), ("nccl", ("cuda:0", "cuda:1"))),
    "no device": ((None, 4, 4), ("gloo", (None,) * 4)),
}


@pytest.mark.parametrize("key", list(WORLDS))
def test_spawn_backend_rule(key):
    """NCCL with rank r on ``cuda:r`` where the caller's device is CUDA and
    the host has a card a rank; gloo on the caller's device otherwise."""
    from repro_torch.dist.launch import plan_world, rank_device
    (device, cards, world), want = WORLDS[key]
    assert plan_world(device, cards, world) == want
    # outside a spawned rank and a world, a rank's device is the caller's
    assert rank_device(device) == device


def test_make_mesh_refuses_unknown_forms():
    from repro_torch.dist.mesh import make_mesh
    with pytest.raises(ValueError, match="forms 'mpi'"):
        make_mesh((1, 1), ("data", "model"), forms="mpi")


def test_join_torchrun_makes_this_process_its_rank(monkeypatch):
    """With ``torchrun``'s variables set (a world of one rank here), the
    launch CLIs' ``join_torchrun`` makes the world this process is a rank
    of: gloo for a CPU device, and a rank's device is the caller's; with
    no such variables it makes none."""
    import socket

    import torch.distributed as dist

    from repro_torch.dist.launch import join_torchrun, rank_device
    assert not dist.is_initialized()
    monkeypatch.delenv("TORCHELASTIC_RUN_ID", raising=False)
    assert not join_torchrun("cpu") and not dist.is_initialized()
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    for k, v in dict(TORCHELASTIC_RUN_ID="test", RANK="0", LOCAL_RANK="0",
                     WORLD_SIZE="1", LOCAL_WORLD_SIZE="1",
                     MASTER_ADDR="localhost", MASTER_PORT=str(port)).items():
        monkeypatch.setenv(k, v)
    try:
        assert join_torchrun("cpu")
        assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
        assert rank_device("cpu") == "cpu"
        assert not join_torchrun("cpu")             # the world is made
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
