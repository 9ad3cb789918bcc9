"""No run loads JAX, flax or the JAX package: the check compares each
module's top-level name whole, and a whole run (on the CPU, in a fresh
interpreter) leaves none in ``sys.modules``."""

import subprocess
import sys

import pytest

from conftest import CELLS, ROOT

from gpubench import common


def test_names_compared_whole(monkeypatch):
    fake = {"multimodal_isic_tpu_torch.ops": 1, "jaxtyping": 1,
            "flaxen": 1}
    monkeypatch.setattr(sys, "modules", {**sys.modules, **fake})
    assert not [m for m in common.forbidden_modules() if m in fake]
    monkeypatch.setitem(sys.modules, "jax.numpy", 1)
    monkeypatch.setitem(sys.modules, "multimodal_isic_tpu.ops", 1)
    assert {"jax.numpy", "multimodal_isic_tpu.ops"} <= \
        set(common.forbidden_modules())


@pytest.mark.parametrize("cell", CELLS)
def test_run_loads_no_jax(cell):
    code = f"""
import sys, time
sys.path.insert(0, {str(ROOT)!r})
sys.path.insert(0, {str(ROOT / 'gpubench' / 'tests')!r})
from conftest import tiny
from gpubench import common, harness
out = harness.run_cell({cell!r}, 7, 0.2, False, time.perf_counter(),
                       device="cpu", resolved=tiny({cell!r}))
print("FOUND", common.forbidden_modules())
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=ROOT, env={"PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "FOUND []" in proc.stdout
