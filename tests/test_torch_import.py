"""repro_torch stands alone: it imports without JAX, never imports the
reference package, and its entry points refuse to run without a GPU unless
the caller asks for the CPU."""
import ast
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "src", "repro_torch")


def _port_files():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(PKG):
        files += [os.path.join(root, n) for n in sorted(names)
                  if n.endswith(".py")]
    return files


def test_every_module_imports_with_jax_blocked():
    code = (
        "import importlib, pkgutil, sys\n"
        "sys.modules['jax'] = None\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = [k for k, v in sys.modules.items() if v is not None and\n"
        "       (k == 'repro' or k.startswith(('repro.', 'jax')))]\n"
        "assert not bad, bad\n"
        "print(len(names))\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 25


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_reference_or_jax_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            mods = [node.module or ""]
        else:
            continue
        for mod in mods:
            top = mod.split(".")[0]
            assert top not in ("repro", "jax", "jaxlib"), (
                f"{path}:{node.lineno} imports {mod}")


@pytest.mark.parametrize("path", [p for p in _port_files()
                                  if not p.endswith("chip_smoke.py")],
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_library_attention_or_compile(path):
    """The port's attention is its own kernel (K6) or its plain version:
    no PyTorch fused attention, no torch.compile, no cuDNN call.
    (chip_smoke.py times SDPA as a yardstick only.)"""
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if not isinstance(node, ast.Attribute):
            continue
        on_torch = (isinstance(node.value, ast.Name)
                    and node.value.id == "torch")
        assert node.attr not in ("scaled_dot_product_attention", "cudnn"), (
            f"{path}:{node.lineno} uses .{node.attr}")
        assert not (on_torch and node.attr == "compile"), (
            f"{path}:{node.lineno} uses torch.compile")


def test_run_experiment_needs_a_gpu_by_default(monkeypatch):
    from repro_torch.experiment import ScenarioSpec, run_experiment
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = ScenarioSpec(steps=1, num_workers=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_experiment(spec)
    assert run_experiment(spec, device="cpu").history


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    from repro_torch.kernels import build
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(build.KernelCompileError, match="nvcc not found"):
        build._Kernels().build_all()


def test_chip_smoke_refuses_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU; chip_smoke.py would run")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_flash_tiles_script_substitutes_the_sources_tiles():
    """tools/flash_tiles.py rebuilds K6 with other MmaTiles constants by
    text substitution: its template must be the source's own, and without a
    GPU it refuses to run."""
    import importlib.util
    path = os.path.join(REPO, "tools", "flash_tiles.py")
    spec = importlib.util.spec_from_file_location("flash_tiles", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    with open(os.path.join(PKG, "kernels", "csrc", "flash_attn.cu")) as f:
        src = f.read()
    assert src.count(mod.TILES) == 1
    assert (64, 64) in mod.VARIANTS
    for bq, bk in mod.VARIANTS:
        assert f"BQ = {bq};" in mod.tiles(bq, bk)
        assert f"BK = {bk};" in mod.tiles(bq, bk)
    if not torch.cuda.is_available():
        assert mod.main() != 0
