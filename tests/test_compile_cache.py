"""Where the package puts JAX's persistent compilation cache: nowhere when
JAX_COMPILATION_CACHE_DIR is set (JAX reads it itself) or the platform is
pinned to the CPU; otherwise the fixed <checkout>/.jax_cache, never a path
that depends on the process, the time or a temporary name."""

import os
import subprocess
import sys

import pytest

import resnet_tpu
from resnet_tpu import CHECKOUT_CACHE_DIR, compile_cache_dir

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_env_var_set_means_nothing_set_in_code():
    env = {"JAX_COMPILATION_CACHE_DIR": "/some/where", "JAX_PLATFORMS": ""}
    assert compile_cache_dir(env) is None
    assert compile_cache_dir(env, configured_platforms="cuda") is None


@pytest.mark.parametrize("env,configured", [
    ({"JAX_PLATFORMS": "cpu"}, None),
    ({}, "cpu"),
    ({"JAX_PLATFORMS": "CPU"}, "cuda"),
])
def test_cpu_only_platforms_get_no_cache(env, configured):
    assert compile_cache_dir(env, configured_platforms=configured) is None


@pytest.mark.parametrize("env,configured", [
    ({}, None),
    ({"JAX_PLATFORMS": "cuda"}, None),
    ({"JAX_PLATFORMS": "gpu,cpu"}, None),
    ({}, "cuda,cpu"),
])
def test_otherwise_the_fixed_checkout_path(env, configured):
    assert compile_cache_dir(env, configured_platforms=configured) == (
        CHECKOUT_CACHE_DIR
    )


def test_checkout_path_is_fixed():
    assert CHECKOUT_CACHE_DIR == os.path.join(REPO, ".jax_cache")
    assert os.path.isabs(CHECKOUT_CACHE_DIR)
    assert os.path.dirname(resnet_tpu.__file__).startswith(
        os.path.dirname(CHECKOUT_CACHE_DIR)
    )


def _configured_dir(env_overrides):
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "JAX_COMPILATION_CACHE_DIR")}
    env.update(env_overrides)
    code = ("import jax, resnet_tpu; "
            "print(jax.config.jax_compilation_cache_dir)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300,
                         check=True).stdout
    return out.strip().splitlines()[-1]


def test_package_import_applies_it(tmp_path):
    # two separate processes agree on the path: nothing in it depends on
    # the pid, the time or a temporary name
    first = _configured_dir({"JAX_PLATFORMS": "cuda"})
    second = _configured_dir({"JAX_PLATFORMS": "cuda"})
    assert first == second == CHECKOUT_CACHE_DIR
    # JAX's own variable wins, untouched
    assert _configured_dir(
        {"JAX_COMPILATION_CACHE_DIR": str(tmp_path)}
    ) == str(tmp_path)
    assert _configured_dir({"JAX_PLATFORMS": "cpu"}) == "None"
