"""Nothing that a run loads is JAX or the JAX package (top-level module
names compared whole: ``fragnet_tpu_torch`` begins with ``fragnet_tpu``),
and the reference loads nothing of the program."""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
FORBIDDEN = {"jax", "jaxlib", "flax", "fragnet_tpu"}


def _modules(code: str):
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_neither_jax_nor_the_jax_package():
    mods = _modules(
        "import sys, json, torch\n"
        "torch.set_num_threads(1)\n"
        "from perfbench.tests import tiny\n"
        "res, _ = tiny.run('dta_screen', 1)\n"
        "assert res['correct']\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    assert "fragnet_tpu_torch" in mods
    assert not mods & FORBIDDEN, mods & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    mods = _modules(
        "import sys, json\n"
        "import perfbench.reference.model, perfbench.reference.layout\n"
        "import perfbench.costs.flops, perfbench.costs.kernels\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    assert not mods & (FORBIDDEN | {"fragnet_tpu_torch"})
