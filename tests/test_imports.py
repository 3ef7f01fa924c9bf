"""The query path imports with JAX and numpy alone: PyYAML (config
files) and aiohttp (the HTTP layer) load only where they are used."""

import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def test_core_imports_without_yaml_and_aiohttp():
    code = (
        "import sys\n"
        "sys.modules['yaml'] = None\n"
        "sys.modules['aiohttp'] = None\n"
        "import fugu_tpu\n"
        "import fugu_tpu.server.batcher\n"
        "import fugu_tpu.engine.manager\n"
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True,
        text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_compile_cache_follows_env_or_checkout(tmp_path):
    """JAX_COMPILATION_CACHE_DIR wins when set; otherwise the cache is a
    fixed directory inside the checkout."""
    code = (
        "import jax\n"
        "from fugu_tpu import jax_setup\n"
        "jax_setup.configure()\n"
        "print(jax.config.jax_compilation_cache_dir)\n"
    )
    env_set = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True,
        text=True, timeout=120,
        env={**_base_env(), "JAX_COMPILATION_CACHE_DIR": str(tmp_path)},
    )
    assert env_set.stdout.strip() == str(tmp_path), env_set.stderr
    unset = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True,
        text=True, timeout=120, env=_base_env(),
    )
    assert unset.stdout.strip() == str(REPO / ".jax_cache"), unset.stderr


def _base_env():
    import os

    env = dict(os.environ)
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    env.pop("FUGU_NO_COMPILE_CACHE", None)
    env["JAX_PLATFORMS"] = "cpu"
    return env
