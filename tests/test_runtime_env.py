"""What the program needs from its environment: the compile-cache directory it
picks, the packages the main path imports, and ``chip_smoke.py``'s refusal to
run without a GPU."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from tests.conftest import tiny_config
from vietvoice_tts_tpu.runtime.engine_core import (
    DEFAULT_COMPILE_CACHE_DIR,
    compile_cache_dir,
)

REPO = Path(__file__).resolve().parents[1]


def _cpu_env() -> dict:
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    return env


class TestCompileCacheDir:
    def test_environment_variable_wins_and_sets_nothing(self):
        cfg = tiny_config(jax_compilation_cache_dir="/elsewhere")
        env = {"JAX_COMPILATION_CACHE_DIR": "/from/env"}
        assert compile_cache_dir(cfg, env) is None

    def test_config_field_when_no_environment_variable(self):
        cfg = tiny_config(jax_compilation_cache_dir="/from/config")
        assert compile_cache_dir(cfg, {}) == "/from/config"

    def test_checkout_default(self):
        assert compile_cache_dir(tiny_config(), {}) == str(DEFAULT_COMPILE_CACHE_DIR)
        assert DEFAULT_COMPILE_CACHE_DIR == REPO / ".jax_cache"
        assert ".jax_cache/" in (REPO / ".gitignore").read_text().split()


def test_main_path_imports_no_optional_packages(tmp_path):
    """Loading a pack and synthesizing through ``TTSApi`` needs numpy, scipy
    and JAX alone: none of flax, msgpack, pydantic, anyio or orbax."""
    code = f"""
import json, sys
import vietvoice_tts_tpu
from vietvoice_tts_tpu import TTSApi
from tests.conftest import tiny_config
api = TTSApi(tiny_config(model_cache_dir={str(tmp_path)!r}))
wave, _ = api.synthesize("Xin chào.")
assert wave.size > 0
print(json.dumps(sorted(m for m in ("flax", "msgpack", "pydantic", "anyio", "orbax")
                        if m in sys.modules)))
"""
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=_cpu_env(),
        capture_output=True, text=True, timeout=600,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


@pytest.mark.parametrize("args", [[], ["--multi"]])
def test_chip_smoke_refuses_cpu(args):
    out = subprocess.run(
        [sys.executable, "chip_smoke.py", *args], cwd=REPO, env=_cpu_env(),
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "no GPU" in out.stderr
