"""Persistent compile cache placement (utils.enable_persistent_compile_cache).

Each case runs in a fresh interpreter: the suite itself pins the CPU, and
the helper must be seen deciding before any backend exists.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

PROBE = """
import json
import jax
from jax._src import xla_bridge
from metagenomic_deepfri_tpu.utils import enable_persistent_compile_cache
d = enable_persistent_compile_cache()
print(json.dumps({"dir": d, "jax_dir": jax.config.jax_compilation_cache_dir,
                  "backend_initialised": xla_bridge.backends_are_initialized()}))
"""


def _probe(**env_overrides) -> dict:
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env.update(env_overrides)
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_env_dir_is_honoured(tmp_path):
    res = _probe(JAX_PLATFORMS="", JAX_COMPILATION_CACHE_DIR=str(tmp_path))
    assert res["dir"] == str(tmp_path)
    assert res["jax_dir"] == str(tmp_path)


def test_default_is_fixed_in_checkout_path():
    res = _probe(JAX_PLATFORMS="")
    assert res["dir"] == str(REPO / ".jax_cache")
    assert res["jax_dir"] == str(REPO / ".jax_cache")


def test_decides_without_initialising_a_backend(tmp_path):
    for env in ({"JAX_PLATFORMS": ""},
                {"JAX_PLATFORMS": "", "JAX_COMPILATION_CACHE_DIR":
                 str(tmp_path)},
                {"JAX_PLATFORMS": "cpu"}):
        res = _probe(**env)
        assert res["backend_initialised"] is False, env
    assert _probe(JAX_PLATFORMS="cpu")["dir"] is None
