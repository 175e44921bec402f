"""Nothing that `benchmark/run.py` imports has the top-level name `jax`,
`jaxlib`, `flax` or `gen_fvgn_tpu` (the part before the first dot,
compared whole: the program's name begins with the JAX package's)."""

import ast
import os
import subprocess
import sys

from benchmark.harness import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "gen_fvgn_tpu"}


def test_no_source_of_the_harness_imports_jax():
    for path in spec.BENCH_DIR.rglob("*.py"):
        if "tests" in path.parts:
            continue
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in FORBIDDEN, (path, n)


def test_a_run_loads_no_jax(tmp_path):
    """A whole run of a cut-down cell on the CPU, in a fresh process; then
    the top-level names of every module it loaded."""
    code = f"""
import importlib.util, sys
sys.path.insert(0, {str(spec.ROOT)!r})
from benchmark.tests.bench_common import tiny_cell
s = importlib.util.spec_from_file_location("bench_run", {str(spec.BENCH_DIR / 'run.py')!r})
run = importlib.util.module_from_spec(s); s.loader.exec_module(run)
name = "transfvgn_v2.rollout.segment.n201.b8"
res, _ = run.execute(name, 2**31 + 17, 0.5, True, device="cpu", cell=tiny_cell(name))
assert "correct" in res
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""
    env = dict(os.environ, JAX_PLATFORMS="cpu", TMPDIR=str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    tops = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "gen_fvgn_tpu_torch" in tops
    assert not tops & FORBIDDEN


def test_without_a_card_the_run_refuses():
    import pytest
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would measure")
    out = subprocess.run(
        [sys.executable, str(spec.BENCH_DIR / "run.py"), "--workload",
         "transfvgn_v2.train.segment.n201.b8", "--seed", "1", "--seconds",
         "1", "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=str(spec.ROOT))
    assert out.returncode != 0
    assert out.stdout.strip() == ""
