"""Test configuration: force an 8-virtual-device CPU platform before JAX
initializes, and enable x64 so kernels can be validated against the
reference's double-precision semantics.  The GPU runs the same kernels in
float32; tests marked `gpu` run their card leg in a child process (the
`gpu_env` fixture), so no pytest process ever holds the card."""

import os
import subprocess
import sys

import pytest

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)


@pytest.fixture(scope="session")
def default_platform_env():
    """(platform, env): the environment of a child process that uses
    JAX's default backend (this process's CPU forcing and virtual devices
    dropped), and the platform of that backend's first device, probed in
    a child so that this process never opens a card."""
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    env["XLA_FLAGS"] = " ".join(
        f for f in env.get("XLA_FLAGS", "").split()
        if "xla_force_host_platform_device_count" not in f)
    env["PYTHONPATH"] = REPO
    r = subprocess.run(
        [sys.executable, "-c",
         "import jax; print(jax.devices()[0].platform)"],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=300)
    lines = r.stdout.split()
    return (lines[-1] if r.returncode == 0 and lines else None), env


@pytest.fixture(scope="session")
def gpu_env(default_platform_env):
    """Environment for a child process that runs on the GPU; skips the
    test where JAX finds no GPU."""
    platform, env = default_platform_env
    if platform != "gpu":
        pytest.skip(f"JAX finds no GPU here (default device: {platform})")
    return env


def expected_indel_symbol(ref, rpos, length, is_del):
    """Expected LINK_{I,D}{1,2,3P} symbol for an indel at reference position
    rpos (ref is the contig sequence string): classification uses the
    STR-unit-normalized n_units from ref_to_phredvalue (main.hpp:917-921,
    2076, 2191), not the raw length."""
    import numpy as np
    from uvc_tpu.pileup import strscan
    from uvc_tpu.constants import Symbol, CHAR_TO_SYMBOL
    from uvc_tpu.config import UVCConfig
    cfg = UVCConfig()
    ref_syms = CHAR_TO_SYMBOL[np.frombuffer(ref.encode(), dtype=np.uint8)]
    tracks = strscan.scan_repeats(
        ref_syms, cfg.indel_str_repeatsize_max, cfg.indel_vntr_repeatsize_max,
        cfg.indel_BQ_max, cfg.indel_polymerase_slip_rate,
        cfg.indel_del_to_ins_err_ratio)
    _, n_units, _, _ = strscan.ref_to_phredvalue(
        tracks, np.array([rpos]),
        np.array([length]), np.array([bool(is_del)]))
    n = int(n_units[0])
    if is_del:
        return int(Symbol.LINK_D1 if n == 1
                   else Symbol.LINK_D2 if n == 2 else Symbol.LINK_D3P)
    return int(Symbol.LINK_I1 if n == 1
               else Symbol.LINK_I2 if n == 2 else Symbol.LINK_I3P)
