"""The dry run (``repro_torch/launch/dryrun.py``) against the reference's
``repro/launch/dryrun.py``.

Without a trace: every arch's parameter counts, and on the production
meshes every pair's per-rank bytes of parameters, SGD state, batch and
cache, against the reference's ``tree_pspecs`` / ``cache_pspec`` /
``input_specs`` on a ``jax.sharding.AbstractMesh``, and in streaming mode
each rank's FSDP shards against ``param_pspec_fsdp``'s blocks; ``pairs()``
and ``LONG_SKIP``.  With a trace: the reduced gemma2-2b, deepseek-v2-lite
and mamba2-2.7b train and decode pairs, rank 0 of a fake (4, 2) world (a
subprocess, JAX blocked), against the reference's ``build_lowerable`` and
``analyze_hlo`` compiled for 8 fake XLA devices (another subprocess); the
same train pairs in streaming mode on a fake (8, 1) world and, but the
MoE's, on the (4, 2) one (a subprocess of their own); a train pair on
(2, 4) and a prefill pair on (1, 8), whose
model axes do not split the heads (a third subprocess holds the
reference's streaming and head pairs); and the reference's own CLI pair
at full width, in both modes.  The subprocesses start together, once for
the module.

The gaps are exact and have their causes (ROADMAP.md, queue 3):
- mamba2's SSD einsums contract in another order than XLA's (786,432
  dot FLOPs in the (4, 2) train pair's gradient);
- the port cuts a Mamba2 SSM state's heads over the model axis
  (``dist/sharding.py::cache_pspec``), the reference leaves them whole;
- the reference's streaming step computes each worker's loss in a second
  forward beside ``jax.grad`` (``repro/train/streaming.py``'s pass 1):
  on the (8, 1) mesh its dot FLOPs exceed the port's by m forwards of a
  worker's rows (and, for mamba2, by the SSD's order in each of the 2m
  gradients).  On the (4, 2) mesh GSPMD's partition of its scan adds more
  (ROADMAP.md, queue 3), so there the port's streaming step is held to m
  times its own vmap step's gradient, which matches the reference's.
XLA's argument bytes also hold the SGD step count (an int here) and the
decode position (an int here), and leave out what the program does not
read (the unused PRNG key, an SSM's position, a prefill's labels).
"""
import json
import math
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.configs import get_arch, list_archs
from repro_torch.dist.sharding import Mesh
from repro_torch.launch import dryrun

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")
ARCHS = list_archs()
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
# the reduced pairs: name -> (seq_len, global batch, kind); the streaming
# train pairs' batches give each worker one row a data rank
SHAPES = {"dryrun_train": (64, 8, "train"), "dryrun_decode": (64, 8, "decode")}
STREAM_SHAPES = {(8, 1): ("dryrun_stream8", 64, 64),
                 (4, 2): ("dryrun_stream4", 64, 16)}
# pairs whose model axis does not split the reduced configs' 4/2 heads:
# "kv" on (2, 4) (q heads split, K/V heads not), "pad" on (1, 8)
HEAD_PAIRS = {"train on (2, 4)": ("dryrun_train", (2, 4)),
              "prefill on (1, 8)": ("dryrun_prefill", (1, 8))}
REDUCED = ("gemma2-2b-reduced", "deepseek-v2-lite-16b-reduced",
           "mamba2-2.7b-reduced")
# the archs whose streaming pair on (4, 2) is held (not the MoE's:
# test_streaming_on_a_model_axis_is_m_vmap_gradients)
MODEL_AXIS_STREAM = ("gemma2-2b-reduced", "mamba2-2.7b-reduced")
# the port's dot FLOPs above the reference's (module docstring)
# The collective forms' pair: gemma2-2b-reduced's train pair with
# ``SEQ_SHARD`` on FORMS_GRID, traced under each form with the gloo forms'
# pieces cut to FORMS_STAGE_BYTES, so that they show on a reduced pair.
FORMS_GRID = (2, 4)
FORMS_STAGE_BYTES = 4096
REMAT_GAP = {"mamba2-2.7b-reduced": 786_432}
# the reference's streaming dot FLOPs on (8, 1) above the port's, besides
# its m extra forwards: mamba2's SSD order, 262,144 in each of the 2m = 16
# one-row gradients (module docstring)
STREAM_GAP = {"mamba2-2.7b-reduced": 16 * 262_144}

_PORT = r"""
import json, sys
sys.modules["jax"] = None
from repro_torch.launch import fake
fake.prepare_host()
from repro_torch.configs import InputShape
from repro_torch.dist.sharding import Mesh
from repro_torch.launch import dryrun
from repro_torch.launch.trace_analysis import trace_cost
fake.init_fake_world(8)
mesh = Mesh(("data", "model"), (4, 2))
out = {}
KEYS = ("dot_flops", "argument_bytes", "peak_bytes", "kernels",
        "collective_counts", "bytes_accessed", "collective_bytes")
def traced(key, arch, shape, mesh, fold=True, b=1, **kw):
    with dryrun.fake_tensors():
        fn, args, meta = dryrun.build_traced(
            arch, shape, mesh, layout="sharded", rule="phocas", b=b,
            remat="full", **kw)
        cost = trace_cost(fn, *args, fold_loops=fold)
    out[key] = dict(meta, **{k: cost[k] for k in KEYS})
if %(part)r == "streaming":
    for arch in %(archs)r:
        for grid, (name, S, B) in %(stream)r.items():
            if grid == (8, 1) or arch in %(model_axis)r:
                traced(arch + "/" + name, arch,
                       InputShape(name, S, B, "train"),
                       Mesh(("data", "model"), grid), mode="streaming")
    name, S, B = %(stream)r[(4, 2)]
    traced("unfolded", "gemma2-2b-reduced", InputShape(name, S, B, "train"),
           mesh, fold=False, mode="streaming")
    print("RESULT " + json.dumps(out))
    sys.exit()
for arch in %(archs)r:
    for name, (S, B, kind) in %(shapes)r.items():
        traced(arch + "/" + name, arch, InputShape(name, S, B, kind), mesh)
for key, (name, grid) in %(heads)r.items():
    S, B, kind = dict(%(shapes)r, dryrun_prefill=(64, 8, "prefill"))[name]
    traced(key, "gemma2-2b-reduced", InputShape(name, S, B, kind),
           Mesh(("data", "model"), grid), b=0)
from repro_torch.dist import collectives
from repro_torch.models import stack
stage, collectives.STAGE_BYTES = collectives.STAGE_BYTES, %(stage)r
stack.SEQ_SHARD = True          # reduce-scatters out of the layers
for forms in ("nccl", "gloo"):
    S, B, kind = %(shapes)r["dryrun_train"]
    traced("forms/" + forms, "gemma2-2b-reduced",
           InputShape("dryrun_train", S, B, kind),
           Mesh(("data", "model"), %(forms_grid)r), b=0, forms=forms)
stack.SEQ_SHARD, collectives.STAGE_BYTES = False, stage
import os
for flag in ("0", "1"):          # K6 takes the prefill only under the flag
    os.environ["REPRO_FLASH_ATTN"] = flag
    with dryrun.fake_tensors():
        fn, args, _ = dryrun.build_traced(
            "gemma2-2b-reduced", InputShape("p", 64, 8, "prefill"), mesh)
        out["flash" + flag] = trace_cost(fn, *args)["kernels"]
print("RESULT " + json.dumps(out))
"""

_REFERENCE = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ["JAX_PLATFORMS"] = "cpu"
import jax, numpy as np
from jax.sharding import Mesh
import repro.configs as C
from repro.configs.base import InputShape
from repro.launch.hlo_analysis import analyze_hlo
for name, (S, B, kind) in %(shapes)r.items():
    C.INPUT_SHAPES[name] = InputShape(name, S, B, kind)
from repro.launch.dryrun import build_lowerable
mesh = Mesh(np.asarray(jax.devices()[:8]).reshape(4, 2), ("data", "model"))
out = {}
for arch in %(archs)r:
    for name in %(shapes)r:
        with jax.set_mesh(mesh):
            fn, args, meta = build_lowerable(arch, name, mesh,
                                             layout="sharded", rule="phocas",
                                             b=1, remat="full")
            compiled = fn.lower(*args).compile()
        ma = compiled.memory_analysis()
        out[arch + "/" + name] = dict(
            meta, dot_flops=analyze_hlo(compiled.as_text())["dot_flops"],
            argument_bytes=ma.argument_size_in_bytes)
print("RESULT " + json.dumps(out))
"""

# the reference's streaming pairs on (8, 1), a forward of a rank's row
# there (its prefill of one row a rank), and the head pairs
_REFERENCE_STREAMING = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ["JAX_PLATFORMS"] = "cpu"
import jax, numpy as np
from jax.sharding import Mesh
import repro.configs as C
from repro.configs.base import InputShape
from repro.launch.hlo_analysis import analyze_hlo
name, S, B = %(stream)r[(8, 1)]
SH = {name: (S, B, "train"), "dryrun_prefill": (64, 8, "prefill"),
      "dryrun_train": (64, 8, "train")}
for n, (s, b, kind) in SH.items():
    C.INPUT_SHAPES[n] = InputShape(n, s, b, kind)
from repro.launch.dryrun import build_lowerable
out = {}
def lowered(key, arch, shape, grid, b=1, **kw):
    mesh = Mesh(np.asarray(jax.devices()[:8]).reshape(*grid),
                ("data", "model"))
    with jax.set_mesh(mesh):
        fn, args, meta = build_lowerable(arch, shape, mesh, layout="sharded",
                                         rule="phocas", b=b, remat="full",
                                         **kw)
        compiled = fn.lower(*args).compile()
    out[key] = dict(meta,
                    dot_flops=analyze_hlo(compiled.as_text())["dot_flops"],
                    argument_bytes=compiled.memory_analysis()
                    .argument_size_in_bytes)
for arch in %(archs)r:
    lowered(arch + "/stream", arch, name, (8, 1), mode="streaming")
    lowered(arch + "/forward", arch, "dryrun_prefill", (8, 1))
for key, (shape, grid) in %(heads)r.items():
    lowered(key, "gemma2-2b-reduced", shape, grid, b=0)
print("RESULT " + json.dumps(out))
"""


def _cli(argv, out_dir):
    code = ("import runpy, sys\nsys.modules['jax'] = None\n"
            f"sys.argv = ['dryrun'] + {argv!r} + ['--out', {out_dir!r}]\n"
            "runpy.run_module('repro_torch.launch.dryrun', "
            "run_name='__main__')\n")
    return [sys.executable, "-c", code]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every subprocess of the module, started together; each test waits
    for its own."""
    out = str(tmp_path_factory.mktemp("dryrun"))
    env = dict(os.environ, PYTHONPATH=SRC)
    env.pop("XLA_FLAGS", None)
    args = {"archs": REDUCED, "shapes": SHAPES, "stream": STREAM_SHAPES,
            "heads": HEAD_PAIRS, "model_axis": MODEL_AXIS_STREAM,
            "stage": FORMS_STAGE_BYTES, "forms_grid": FORMS_GRID}
    cmds = {"port": [sys.executable, "-c", _PORT % dict(args, part="vmap")],
            "port_streaming": [sys.executable, "-c",
                               _PORT % dict(args, part="streaming")],
            "reference": [sys.executable, "-c", _REFERENCE % args],
            "reference_streaming": [sys.executable, "-c",
                                    _REFERENCE_STREAMING % args],
            "cli": _cli(["--arch", "gemma2-2b", "--shape", "decode_32k"],
                        out),
            "streaming": _cli(["--arch", "gemma2-2b", "--shape", "decode_32k",
                               "--mode", "streaming"], out)}
    procs = {k: subprocess.Popen(c, env=env, cwd=REPO, text=True,
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE)
             for k, c in cmds.items()}
    done = {}

    def wait(key):
        if key not in done:
            so, se = procs[key].communicate(timeout=400)
            done[key] = (procs[key].returncode, so, se)
        return done[key]

    yield wait, out
    for p in procs.values():
        if p.poll() is None:
            p.kill()
            p.wait()


def _run(runs, key):
    return runs[0](key)


def _result(run):
    rc, so, se = run
    assert rc == 0, se[-3000:]
    line = [x for x in so.splitlines() if x.startswith("RESULT ")][-1]
    return json.loads(line[len("RESULT "):])


@pytest.fixture(scope="module")
def reference_dryrun():
    """The reference's dryrun module: it sets XLA_FLAGS when imported (for
    its own process), which is put back."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun as ref
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return ref


_TREES = {}


def _trees(arch):
    """(the port's abstract params, the reference's eval_shape params)."""
    if arch not in _TREES:
        import jax

        from repro.configs import get_arch as ref_arch
        from repro.models import build_model as ref_build
        from repro_torch.models.registry import build_model
        rm = ref_build(ref_arch(arch))
        _TREES[arch] = (build_model(get_arch(arch)).abstract_params(),
                        jax.eval_shape(
                            lambda: rm.init(jax.random.PRNGKey(0))))
    return _TREES[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_active_params_match_reference(arch, reference_dryrun):
    port, ref = _trees(arch)
    assert dryrun._active_params(get_arch(arch), port) == \
        reference_dryrun._active_params(get_arch(arch), ref)


def test_pairs_and_long_skip_match_reference(reference_dryrun):
    assert list(dryrun.pairs()) == list(reference_dryrun.pairs())
    assert dryrun.LONG_SKIP == reference_dryrun.LONG_SKIP


def _ref_block_bytes(leaf, spec, mesh) -> int:
    shape = list(leaf.shape)
    for dim, entry in enumerate(spec):
        if entry is not None:
            names = (entry,) if isinstance(entry, str) else tuple(entry)
            shape[dim] //= math.prod(mesh.shape[n] for n in names)
    return math.prod(shape) * leaf.dtype.itemsize


def _ref_reckon(arch, shape, am) -> dict:
    """The reference's per-device bytes of the pair (``shape`` a name or
    an ``InputShape``), as its ``build_lowerable`` shards them, and under
    ``ssm_cut`` the SSM state bytes that the port's own cut (the state's
    heads over the model axes) takes away."""
    import jax

    from repro.configs import get_arch as ref_arch
    from repro.configs import get_shape
    from repro.dist.sharding import cache_pspec, tree_pspecs, worker_axes_of
    from repro.models import build_model as ref_build
    from repro.optim import OptConfig, init_opt_state
    shape = get_shape(shape) if isinstance(shape, str) else shape
    model = ref_build(ref_arch(arch))
    params = _trees(arch)[1]
    leaves = jax.tree_util.tree_leaves
    out = {"params": sum(_ref_block_bytes(x, p, am) for x, p in zip(
        leaves(params), leaves(tree_pspecs(params, am),
                               is_leaf=lambda x: isinstance(
                                   x, jax.sharding.PartitionSpec))))}
    opt = jax.eval_shape(lambda p: init_opt_state(
        OptConfig(name="sgd", lr=0.01), p), params)
    out["opt_state"] = sum(x.size * x.dtype.itemsize for x in leaves(opt))
    wa = worker_axes_of(am)
    m = math.prod(am.shape[a] for a in wa)
    out["batch"] = 0
    for s in model.input_specs(shape).values():
        B = s.shape[0]
        rows = B // m if (shape.kind == "train" or B % m == 0) else B
        out["batch"] += rows * math.prod(s.shape[1:]) * s.dtype.itemsize
    out["cache"] = out["ssm_cut"] = 0
    if shape.is_decode:
        cache = jax.eval_shape(lambda: model.init_cache(shape.global_batch,
                                                        shape.seq_len))
        tp = am.shape["model"]
        for path, leaf in jax.tree_util.tree_flatten_with_path(cache)[0]:
            n = _ref_block_bytes(leaf, cache_pspec(path, leaf, am), am)
            if str(getattr(path[-1], "key", "")) == "ssm" and \
                    leaf.shape[-3] % tp == 0:
                out["ssm_cut"] += n - n // tp
            out["cache"] += n
    return out


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_rank_bytes_match_reference(arch, mesh_name):
    from jax.sharding import AbstractMesh
    sizes, names = MESHES[mesh_name]
    am = AbstractMesh(sizes, names)
    mesh = Mesh(names, sizes)
    for a, shape_name in dryrun.pairs():
        if a != arch:
            continue
        got = dryrun.reckon(arch, shape_name, mesh)
        want = _ref_reckon(arch, shape_name, am)
        assert got["params"] == want["params"], shape_name
        # the reference's step count is an int32 scalar, the port's an int
        assert got["opt_state"] == want["opt_state"] - 4, shape_name
        assert got["batch"] == want["batch"], shape_name
        assert got["cache"] == want["cache"] - want["ssm_cut"], shape_name


def test_input_specs_match_reference():
    from repro.configs import INPUT_SHAPES
    from repro.configs import get_arch as ref_arch
    from repro.models import build_model as ref_build
    from repro_torch.models.registry import build_model
    for arch in ARCHS:
        port, ref = build_model(get_arch(arch)), ref_build(ref_arch(arch))
        for shape in INPUT_SHAPES.values():
            got = port.input_specs(shape)
            want = ref.input_specs(shape)
            assert list(got) == list(want)
            for k in got:
                assert tuple(got[k].shape) == tuple(want[k].shape)
                assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype)


@pytest.mark.parametrize("arch", REDUCED)
@pytest.mark.parametrize("kind", ["train", "decode"])
def test_reduced_pairs_match_reference(runs, arch, kind):
    port, ref = _result(_run(runs, "port")), _result(_run(runs, "reference"))
    key = f"{arch}/dryrun_{kind}"
    got, want = port[key], ref[key]
    assert (got["total_params"], got["active_params"]) == \
        (want["total_params"], want["active_params"])
    gap = REMAT_GAP.get(arch, 0) if kind == "train" else 0
    assert got["dot_flops"] == want["dot_flops"] + gap
    mesh = Mesh(("data", "model"), (4, 2))
    from repro_torch.configs import InputShape
    S, B, k = SHAPES[f"dryrun_{kind}"]
    rank = dryrun.reckon(arch, InputShape(f"dryrun_{kind}", S, B, k), mesh)
    assert got["argument_bytes"] == sum(rank.values())
    if kind == "train":
        # the step count; the PRNG key is unused without an attack
        assert got["argument_bytes"] == want["argument_bytes"] - 4
        D = rank["params"] // 4                      # f32 reduced params
        assert got["kernels"] == [["phocas", [4, -(-D // 4)]]]
    else:
        # XLA's position scalar, or for the SSM (which reads no position)
        # the heads of its state that the port cuts
        gap = _ssm_cut(arch, S, B) if arch.startswith("mamba2") else 4
        assert got["argument_bytes"] == want["argument_bytes"] - gap
        assert got["kernels"] == []


def _ssm_cut(arch, S, B):
    """The per-device SSM state bytes the port's cache_pspec cuts away on
    the (4, 2) mesh."""
    from jax.sharding import AbstractMesh

    from repro.configs.base import InputShape
    return _ref_reckon(arch, InputShape("d", S, B, "decode"),
                       AbstractMesh((4, 2), ("data", "model")))["ssm_cut"]


def test_prefill_reaches_k6_only_under_repro_flash_attn(runs):
    port = _result(_run(runs, "port"))
    # gemma2-2b-reduced's 2 layers; (B/4, S, H, hd) on the (4, 2) mesh
    assert port["flash0"] == []
    assert port["flash1"] == [["flash_attn", [2, 64, 2, 64]]] * 2


def test_reference_pair_runs_through_the_cli(runs):
    rc, so, se = _run(runs, "cli")
    assert rc == 0, se[-3000:]
    assert "OK" in so and "[dryrun] 1/1 OK" in so


def test_streaming_mode_runs_through_the_cli(runs):
    """``--mode streaming`` traces the reference's CLI pair on the FSDP
    shards and tags its record ``__streaming``, as the reference does."""
    rc, so, se = _run(runs, "streaming")
    assert rc == 0, se[-3000:]
    assert "[dryrun] 1/1 OK" in so
    tag = "gemma2-2b__decode_32k__16x16__sharded__phocas__full__streaming"
    with open(os.path.join(runs[1], tag + ".json")) as f:
        rec = json.load(f)
    assert rec["ok"] and rec["mode"] == "streaming"
    # each rank's FSDP shards of the params (the reference's
    # param_pspec_fsdp bytes) and its cache blocks
    rank = dryrun.reckon("gemma2-2b", "decode_32k",
                         Mesh(("data", "model"), (16, 16)))
    assert rec["argument_size_in_bytes"] == (
        _fsdp_bytes("gemma2-2b", MESHES["16x16"]) + rank["batch"]
        + rank["cache"])


def test_build_traced_refuses_no_world():
    import torch.distributed as dist
    assert not dist.is_initialized()
    for mode in ("vmap", "streaming"):
        with pytest.raises(RuntimeError, match="fake world"):
            dryrun.build_traced("gemma2-2b-reduced", "decode_32k",
                                Mesh(("data", "model"), (4, 2)), mode=mode)
    with pytest.raises(ValueError, match="mode"):
        dryrun.build_traced("gemma2-2b-reduced", "train_4k",
                            Mesh(("data", "model"), (4, 2)), mode="scan")


def _fsdp_bytes(arch, mesh_def) -> int:
    """A device's bytes of the reference's params under
    ``param_pspec_fsdp`` on an ``AbstractMesh``."""
    import jax
    from jax.sharding import AbstractMesh, PartitionSpec

    from repro.dist.sharding import param_pspec_fsdp, tree_pspecs
    sizes, names = mesh_def
    am = AbstractMesh(sizes, names)
    params = _trees(arch)[1]
    leaves = jax.tree_util.tree_leaves
    specs = leaves(tree_pspecs(params, am, leaf_rule=param_pspec_fsdp),
                   is_leaf=lambda x: isinstance(x, PartitionSpec))
    return sum(_ref_block_bytes(x, p, am)
               for x, p in zip(leaves(params), specs))


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_each_streaming_rank_holds_its_fsdp_share(arch, mesh_name):
    """Every leaf's FSDP shard (``dist/sharding.py::FsdpLayout``: the
    model-axis block the layers compute on, cut into equal runs over the
    rest of ``param_pspec_fsdp``'s axes, a period at a time where it
    cuts) holds as many bytes as the reference's ``param_pspec_fsdp``
    block; summed, a rank's params."""
    from repro_torch.dist.sharding import fsdp_leaf
    from repro_torch.models.registry import build_model
    sizes, names = MESHES[mesh_name]
    mesh = Mesh(names, sizes)
    full = build_model(get_arch(arch)).abstract_params()
    total = 0
    for name, leaf in dryrun._walk(full):
        plan = fsdp_leaf(name, leaf, mesh, True)
        runs = math.prod(mesh.shape[a] for a in plan.axes)
        n = math.prod(plan.block) // runs
        total += n * (leaf.shape[0] if plan.per_period else 1) \
            * leaf.dtype.itemsize
    assert total == _fsdp_bytes(arch, MESHES[mesh_name])


@pytest.mark.parametrize("arch", REDUCED)
def test_streaming_train_pairs_match_reference(runs, arch):
    """On a fake (8, 1) world (m = 8, one row a worker a rank): a rank's
    arguments are the reference's but for its int step count; its dot
    FLOPs are the reference's less the reference's m extra forwards (its
    own forward of one row a rank, ``dryrun_prefill``) and mamba2's SSD
    order; no kernel runs (the streaming statistics are sorts)."""
    port = _result(_run(runs, "port_streaming"))
    ref = _result(_run(runs, "reference_streaming"))
    name = STREAM_SHAPES[(8, 1)][0]
    got, want = port[f"{arch}/{name}"], ref[f"{arch}/stream"]
    assert (got["total_params"], got["active_params"]) == \
        (want["total_params"], want["active_params"])
    assert got["argument_bytes"] == want["argument_bytes"] - 4
    forward = ref[f"{arch}/forward"]["dot_flops"]
    assert want["dot_flops"] - got["dot_flops"] == \
        8 * forward + STREAM_GAP.get(arch, 0)
    assert got["kernels"] == []


@pytest.mark.parametrize("arch", MODEL_AXIS_STREAM)
def test_streaming_on_a_model_axis_is_m_vmap_gradients(runs, arch):
    """On the fake (4, 2) world (m = 4, one row a worker a data rank,
    tensor-parallel on the gathered blocks): the two passes' 2m one-row
    gradients are m times the vmap step's one gradient of two rows (whose
    dot FLOPs match the reference's, test_reduced_pairs_match_reference);
    a rank's arguments are its ``param_pspec_fsdp`` bytes and its rows of
    every worker.  (Not the MoE: the streaming step dispatches each data
    rank's tokens as a group, as the reference's streaming step does on a
    mesh, where the vmap step turns the grouping off, so the experts'
    capacity differs.)"""
    from repro.configs import get_arch as ref_arch
    from repro.configs.base import InputShape as RShape
    from repro.models import build_model as ref_build
    port = _result(_run(runs, "port"))
    name, S, B = STREAM_SHAPES[(4, 2)]
    got = _result(_run(runs, "port_streaming"))[f"{arch}/{name}"]
    vmap = port[f"{arch}/dryrun_train"]
    assert got["dot_flops"] == 4 * vmap["dot_flops"]
    specs = ref_build(ref_arch(arch)).input_specs(RShape(name, S, B,
                                                         "train"))
    # the (m, B/m, ...) stack's rows cut over the 4 data ranks
    rows = sum(B // 4 * math.prod(s.shape[1:]) * s.dtype.itemsize
               for s in specs.values())
    assert got["argument_bytes"] == _fsdp_bytes(
        arch, ((4, 2), ("data", "model"))) + rows


def test_folded_trace_equals_the_whole_trace(runs):
    """``trace_cost(fold_loops=True)`` (the dry run's) traces the two
    passes over the workers as two iterations each, the second standing
    for the rest: on gemma2's (4, 2) streaming pair its counts are the
    whole trace's but for the workers' loss and mass scalars it leaves
    out (a few bytes a worker)."""
    port = _result(_run(runs, "port_streaming"))
    folded = port["gemma2-2b-reduced/" + STREAM_SHAPES[(4, 2)][0]]
    whole = port["unfolded"]
    for k in ("dot_flops", "kernels", "collective_counts", "argument_bytes"):
        assert folded[k] == whole[k], k
    assert 0 <= whole["peak_bytes"] - folded["peak_bytes"] <= 8 * 4
    for k in ("bytes_accessed",):
        assert 0 <= whole[k] - folded[k] <= 256 * 4
    for k, v in whole["collective_bytes"].items():
        assert 0 <= v - folded["collective_bytes"][k] <= 8 * 4


@pytest.mark.parametrize("key", list(HEAD_PAIRS))
def test_heads_that_do_not_split_match_reference(runs, key):
    """gemma2-2b-reduced's 4/2 heads on a model axis of 4 (train: q heads
    split, K/V heads not) and of 8 (prefill: padded to 8, one a rank, the
    last four ranks none): dot FLOPs exactly the reference's padded-heads
    branch's; arguments the reference's but for the step count (train)
    or the labels a forward does not read (prefill)."""
    port = _result(_run(runs, "port"))
    ref = _result(_run(runs, "reference_streaming"))
    got, want = port[key], ref[key]
    assert got["dot_flops"] == want["dot_flops"]
    name, (d, _) = HEAD_PAIRS[key]
    if name == "dryrun_train":
        assert got["argument_bytes"] == want["argument_bytes"] - 4
    else:
        labels = 8 // d * 64 * 4
        assert got["argument_bytes"] == want["argument_bytes"] + labels


def test_production_meshes_and_the_cards_constants():
    from repro_torch.launch import mesh as M
    one, two = M.make_production_mesh(), M.make_production_mesh(
        multi_pod=True)
    assert (one.axis_names, one.axis_sizes, one.size) == \
        (("data", "model"), (16, 16), 256)
    assert (two.axis_names, two.axis_sizes, two.size) == \
        (("pod", "data", "model"), (2, 16, 16), 512)
    assert (M.PEAK_FLOPS_BF16, M.HBM_BW, M.NVLINK_BW) == \
        (989e12, 3.35e12, 450e9)


def test_trace_cost_counts_storages_products_and_frees():
    """On CPU tensors: a view adds nothing, a freed temporary leaves the
    peak, the products are counted, the outputs' storages measured."""
    from repro_torch.launch.trace_analysis import trace_cost
    a = torch.ones((64, 32))
    b = torch.ones((32, 16))

    def fn(a, b):
        t = torch.zeros((1024,))          # 4 KiB, freed before the return
        del t
        v = a[:8]                         # a view of an argument
        c = a @ b                         # (64, 16) f32: 4 KiB
        return c, v

    cost = trace_cost(fn, a, b)
    args = 64 * 32 * 4 + 32 * 16 * 4
    assert cost["argument_bytes"] == args
    assert cost["peak_bytes"] == args + 4096
    assert cost["output_bytes"] == 64 * 16 * 4 + 64 * 32 * 4
    assert cost["dot_flops"] == 2 * 64 * 32 * 16
    assert cost["write_bytes"] == 4096 + 4096   # zeros, then the product
    assert cost["kernels"] == [] and cost["collective_total_bytes"] == 0


def _freed_flags(tensors) -> list:
    """One flag a tensor, set when its storage is freed."""
    import weakref
    flags = []
    for t in tensors:
        flag = []
        weakref.finalize(t.untyped_storage(), flag.append, True)
        flags.append(flag)
    return flags


def test_a_dropped_tree_is_freed_without_the_garbage_collector():
    """``tree.map``'s result is freed when the caller drops it: phase 13's
    predicted peak found its leaves held by a reference cycle until the
    collector ran (a gradient tree live beside the optimizer's update)."""
    import gc

    from repro_torch import tree as tree_util
    gc.collect()
    gc.disable()
    try:
        out = tree_util.map(lambda x: x * 2, {"a": torch.ones(4),
                                              "b": [torch.ones(2)]})
        flags = _freed_flags(tree_util.leaves(out))
        del out
        assert all(flags)
    finally:
        gc.enable()


def test_sync_ps_drops_the_first_params_after_the_first_step():
    """The run keeps no reference to its first params once the first step
    has replaced them (phase 13 found them live all run)."""
    import dataclasses
    import gc

    from repro_torch.core.robust import RobustConfig
    from repro_torch.experiment.runner import plan_from_parts
    from repro_torch.experiment.topologies import SyncPS
    from repro_torch.models.mlp import build_mlp_model
    from repro_torch.optim import OptConfig
    from repro_torch.tree import leaves
    model = build_mlp_model((6, 5, 3))
    first, seen = [], []

    def init(gen):
        params = model.init(gen)
        first.extend(_freed_flags(leaves(params)))
        return params

    def batch_fn(step):
        seen.append(all(first))
        g = torch.Generator().manual_seed(step)
        return {"x": torch.randn((8, 6), generator=g),
                "y": torch.randint(0, 3, (8,), generator=g)}

    plan = plan_from_parts(
        model=dataclasses.replace(model, init=init), batch_fn=batch_fn,
        robust_cfg=RobustConfig(rule="phocas", b=1, q=1),
        opt_cfg=OptConfig(name="sgd", lr=0.1), num_workers=4, steps=3,
        device="cpu")
    SyncPS().run(plan)        # torch.func's first call leaves garbage
    first.clear()
    seen.clear()
    gc.collect()
    gc.disable()
    try:
        SyncPS().run(plan)
    finally:
        gc.enable()
    assert seen == [False, True, True]


def test_nccl_forms_trace_reduce_scatters_where_gloo_all_reduced(runs):
    """gemma2-2b-reduced's ``SEQ_SHARD`` train pair on (2, 4) traced under
    each form: the NCCL forms count a reduce-scatter exactly where the gloo
    forms counted an all-reduce, with 1/4 (the model axis) of its output
    bytes; they gather and exchange the same bytes in whole calls where
    the gloo forms' CUDA pieces (cut to FORMS_STAGE_BYTES here) take more;
    and the NCCL forms' predicted peak is no higher."""
    port = _result(_run(runs, "port"))
    nccl, gloo = port["forms/nccl"], port["forms/gloo"]
    counts = {k: (nccl["collective_counts"][k], gloo["collective_counts"][k])
              for k in nccl["collective_counts"]}
    sizes = {k: (nccl["collective_bytes"][k], gloo["collective_bytes"][k])
             for k in nccl["collective_bytes"]}
    assert counts["reduce-scatter"][1] == 0 < counts["reduce-scatter"][0]
    assert counts["all-reduce"][0] + counts["reduce-scatter"][0] == \
        counts["all-reduce"][1]
    assert sizes["all-reduce"][0] + FORMS_GRID[1] * \
        sizes["reduce-scatter"][0] == sizes["all-reduce"][1]
    for kind in ("all-gather", "all-to-all"):
        assert sizes[kind][0] == sizes[kind][1], kind
    assert counts["all-gather"][0] < counts["all-gather"][1]
    assert nccl["peak_bytes"] <= gloo["peak_bytes"]
    assert nccl["dot_flops"] == gloo["dot_flops"]
