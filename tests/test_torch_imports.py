"""The port stands alone: importing every module of
``ska_sdp_func_python_torch`` with ``jax`` blocked succeeds and loads
nothing of the JAX package; that includes ``io`` (the native store and
the gain files) and ``streaming``, and the native store's library is the
port's own build of ``native/visio.cpp``."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import pkgutil, sys
sys.modules["jax"] = None
import ska_sdp_func_python_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    __import__(name)
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib",
             "ska_sdp_func_python_tpu") and sys.modules[m] is not None)
print(len(names), bad)
assert not bad, bad
for mod in ("pipeline", "ops.accuracy", "ops.gridding_tiled", "ops.imaging",
            "io", "io.visio", "io.gainio", "streaming", "ops.image_iterators",
            "ops.imaging_helpers", "utils.arrays", "parallel", "parallel.mesh",
            "parallel.collectives", "parallel.multihost", "parallel.distributed",
            "parallel.selfcal", "parallel.fused", "parallel.redistribute"):
    assert "ska_sdp_func_python_torch." + mod in names, mod
for attr in ("io", "models", "ops", "pipeline", "streaming", "parallel"):
    assert hasattr(pkg, attr), attr
from ska_sdp_func_python_torch.io import visio
lib = visio._load_lib()
assert "build/torch_native/libvisio_" in lib._name, lib._name
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib",
             "ska_sdp_func_python_tpu") and sys.modules[m] is not None)
assert not bad, bad
"""


def test_port_imports_without_jax():
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE],
        cwd=REPO,
        env={**os.environ, "PYTHONPATH": REPO},
        capture_output=True,
        text=True,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
