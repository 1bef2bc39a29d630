"""The port stands alone: with JAX, flax, PIL and ``divshot_tpu`` blocked,
every module of ``divshot_tpu_torch`` imports and ``chip_smoke.py``'s
kernel and main-path phases run on the CPU at a tiny scale. Also checks on
the port's files: no JAX or ``divshot_tpu`` import outside docstrings, no
file over 200 KB, and the kernel build directory ignored by git."""

import ast
import os
import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "divshot_tpu_torch"
BLOCKED = ("jax", "jaxlib", "flax", "PIL", "divshot_tpu")

_BLOCKED_RUN = r"""
import contextlib, importlib, io, pkgutil, sys
for m in %r:
    sys.modules[m] = None
import torch
torch.set_num_threads(1)
import divshot_tpu_torch
names = [m.name for m in pkgutil.walk_packages(divshot_tpu_torch.__path__,
                                               "divshot_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    dev = torch.device("cpu")
    checks = chip_smoke.phase_kernels_vs_plain(dev, chip_smoke.TINY)
    records = chip_smoke.phase_main_path(dev, chip_smoke.TINY)
out = buf.getvalue()
assert '"ok"' not in out, out
assert checks["expand_err"] == 0.0 and checks["forward_err"] == 0.0
assert [(r["scene"], r["name"]) for r in records] == [
    (s, k) for s in ("tpu_bricks_mcmc", "random_1500")
    for k in ("expand", "forward")]
for m in %r:
    assert sys.modules.get(m) is None, m
print("MODULES", len(names))
""" % (BLOCKED, BLOCKED)


def _run(args, **kw):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    return subprocess.run([sys.executable, *args], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300, **kw)


def test_port_runs_with_jax_and_reference_blocked():
    res = _run(["-c", _BLOCKED_RUN])
    assert res.returncode == 0, res.stderr[-4000:]
    assert "MODULES" in res.stdout
    assert int(res.stdout.split("MODULES")[1]) >= 15


def test_chip_smoke_fails_without_a_card():
    res = _run(["chip_smoke.py"])
    assert res.returncode != 0
    assert "no CUDA device" in res.stderr
    assert '"ok"' not in res.stdout


def _port_files():
    files = sorted(p for p in PORT.rglob("*") if p.is_file()
                   and "__pycache__" not in p.parts)
    files += [REPO / "chip_smoke.py"]
    files += sorted((REPO / "tests").glob("test_torch_*.py"))
    return files


def _code_without_docstrings(path: Path) -> str:
    src = path.read_text()
    lines = src.splitlines()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)) and node.body:
            first = node.body[0]
            if (isinstance(first, ast.Expr)
                    and isinstance(first.value, ast.Constant)
                    and isinstance(first.value.value, str)):
                for i in range(first.lineno - 1, first.end_lineno):
                    lines[i] = ""
    return "\n".join(lines)


def test_port_imports_no_jax_or_reference():
    pattern = re.compile(r"\bimport\s+(jax|flax|PIL)\b|\bfrom\s+(jax|flax|PIL)"
                         r"\b|\bdivshot_tpu\.")
    modules = [p for p in _port_files()
               if p.suffix == ".py" and not p.name.startswith("test_")]
    assert len(modules) >= 16
    for path in modules:
        code = _code_without_docstrings(path)
        assert not pattern.search(code), f"{path}: {pattern.search(code)}"


def test_port_files_are_small_text():
    for path in _port_files():
        assert path.stat().st_size <= 200_000, path
        path.read_text(encoding="utf-8")


def test_build_directory_is_ignored():
    lines = (REPO / ".gitignore").read_text().splitlines()
    assert "build/" in [ln.strip() for ln in lines]
