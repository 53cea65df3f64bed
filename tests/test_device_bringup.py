"""Where the model runs, and what happens when the device is missing.

The CPU tests pin the rules that keep a GPU run honest: one compile-cache
setting, a CLI that stops when its backend cannot start (and never
computes on the CPU instead), chip_smoke.py refusing a CPU-only run, and
an exit summary that names the model device.  The `gpu` tests compare
the two jitted device programs with their references on the card, each
card leg in a child process.
"""

import json
import os
import re
import subprocess
import sys

import pytest

from uvc_tpu import devcheck
from uvc_tpu.io import simulate

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("env_set", [True, False],
                         ids=["env_set", "env_unset"])
def test_compile_cache_rule(monkeypatch, tmp_path, env_set):
    """JAX_COMPILATION_CACHE_DIR set: the code sets no cache directory.
    Unset: the cache goes to <repo>/.jax_cache."""
    import jax
    from uvc_tpu.utils import jaxcache
    if env_set:
        monkeypatch.setenv(jaxcache.ENV_VAR, str(tmp_path))
    else:
        monkeypatch.delenv(jaxcache.ENV_VAR, raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        got = jaxcache.configure()
        after = jax.config.jax_compilation_cache_dir
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    if env_set:
        assert jaxcache.cache_dir() is None
        assert got == str(tmp_path) and after == before
    else:
        assert got == after == os.path.join(REPO, ".jax_cache")


def _tiny_bam(d):
    ref = simulate.random_ref(3000, 7)
    variants = [simulate.Variant(1500, f"{ref[1500]}>"
                                 + ("A" if ref[1500] != "A" else "C"), 0.3)]
    bam = os.path.join(d, "t.bam")
    simulate.build_bam(bam, ref, depth=40, variants=variants, seed=5)
    fa = os.path.join(d, "ref.fa")
    with open(fa, "w") as fh:
        fh.write(">chr1\n" + ref + "\n")
    return bam, fa


def test_cli_without_gpu_backend_fails(tmp_path, default_platform_env):
    """Under JAX_PLATFORMS=cuda with no GPU, the CLI exits non-zero before
    writing a VCF or evaluating anything on the CPU."""
    platform, env = default_platform_env
    if platform == "gpu":
        pytest.skip("a GPU is present: JAX_PLATFORMS=cuda would start")
    bam, fa = _tiny_bam(str(tmp_path))
    out = str(tmp_path / "out.vcf.gz")
    r = subprocess.run(
        [sys.executable, "-m", "uvc_tpu.cli.uvc1", "-f", fa, "-o", out,
         "-t", "1", bam], env=dict(env, JAX_PLATFORMS="cuda"), cwd=REPO,
        capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert not os.path.exists(out)
    assert "the JAX backend did not start" in r.stderr
    assert "model device:" not in r.stderr


def test_chip_smoke_refuses_cpu():
    """JAX_PLATFORMS=cpu python chip_smoke.py exits non-zero before any
    phase and prints no result."""
    r = subprocess.run(
        [sys.executable, "chip_smoke.py"],
        env=dict(os.environ, JAX_PLATFORMS="cpu"), cwd=REPO,
        capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "phase" not in r.stdout


def test_cli_summary_names_model_device(tmp_path, capsys):
    import jax
    from uvc_tpu.cli import uvc1 as uvc1_cli
    bam, fa = _tiny_bam(str(tmp_path))
    assert uvc1_cli.run(["-f", fa, "-o", str(tmp_path / "o.vcf.gz"),
                         "-t", "1", bam]) == 0
    err = capsys.readouterr().err
    d = jax.local_devices()
    m = re.search(r"model device: (\S+) (.+) x(\d+); (\d+) requests, "
                  r"(\d+) rows; (\d+) XLA compiles", err)
    assert m, err
    assert m.group(1) == d[0].platform == "cpu"
    assert m.group(2) == d[0].device_kind
    assert int(m.group(3)) == len(d)
    assert int(m.group(4)) > 0 and int(m.group(5)) > 0


def _devcheck(argv, env):
    r = subprocess.run([sys.executable, "-m", "uvc_tpu.devcheck", *argv],
                       env=env, cwd=REPO, capture_output=True, text=True,
                       timeout=900)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1][len("devcheck "):])


@pytest.mark.gpu
def test_packed_model_gpu_matches_cpu_x64(gpu_env, tmp_path):
    """The packed quality model on the GPU against the same request in
    float64 on the CPU, under the model contract of uvc_tpu/devcheck.py."""
    leaves = {}
    for leg, env in (("gpu", gpu_env),
                     ("cpu", dict(gpu_env, JAX_PLATFORMS="cpu"))):
        out = str(tmp_path / f"{leg}.npz")
        rep = _devcheck(["model", "--rows", "16384", "--out", out], env)
        assert rep["platform"] == leg
        leaves[leg] = devcheck.load_leaves(out)
    errs, _ = devcheck.compare_model(leaves["cpu"][0], leaves["gpu"][0],
                                     leaves["gpu"][1])
    assert not errs, errs[:20]


@pytest.mark.gpu
def test_device_consensus_gpu_exact(gpu_env, tmp_path):
    """device_reduce_consensus on the GPU, on the real fragment event
    stream of a 300x region, is bit-exact with pileup/consensus.py."""
    ref = simulate.random_ref(20000, 5)
    variants = [simulate.Variant(p, f"{ref[p]}>"
                                 + ("A" if ref[p] != "A" else "C"), 0.2)
                for p in range(1000, 19000, 2500)]
    bam = str(tmp_path / "c.bam")
    simulate.build_bam_multi(bam, [("chr1", ref, variants)], depth=300,
                             seed=1)
    fa = str(tmp_path / "c.fa")
    with open(fa, "w") as fh:
        fh.write(">chr1\n" + ref + "\n")
    rep = _devcheck(["consensus", bam, fa], gpu_env)
    assert rep["platform"] == "gpu"
    assert rep["exact"] and sum(c["rows"] for c in rep["calls"]) > 10 ** 6


def test_packed_model_builds_once_across_threads(monkeypatch, tmp_path):
    """CLI worker threads share the jit cache: many threads asking for the
    same new program mode at two row shapes build it once, compile each
    shape once, and evaluate identically."""
    from concurrent.futures import ThreadPoolExecutor
    import jax
    import numpy as np
    from jax.experimental.compilation_cache import compilation_cache
    from uvc_tpu import calling
    from uvc_tpu.config import UVCConfig
    from uvc_tpu.model.example import example_packed_request

    calling.init_model_device()
    packed, _ = example_packed_request(rows=512)
    half = (packed[0][:256],) + packed[1:]
    cfg = UVCConfig()
    cfg.vqual = 15.25          # a config no other test has compiled
    builds = []
    build = calling._build_packed_model
    monkeypatch.setattr(calling, "_build_packed_model",
                        lambda *a: builds.append(1) or build(*a))
    # an empty persistent cache, so that each shape's program is compiled
    # here and not loaded from an earlier run
    cache_before = jax.config.jax_compilation_cache_dir
    jax.config.update("jax_compilation_cache_dir", str(tmp_path))
    compilation_cache.reset_cache()
    compiles = calling.MODEL_STATS["compiles"]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(max_workers=16) as pool:
            outs = list(pool.map(
                lambda i: calling.model_eval_packed(
                    (packed, half)[i % 2], cfg), range(32), timeout=600))
        compiles = calling.MODEL_STATS["compiles"] - compiles
    finally:
        sys.setswitchinterval(old)
        jax.config.update("jax_compilation_cache_dir", cache_before)
        compilation_cache.reset_cache()
    assert len(builds) == 1
    assert compiles == 2
    for i, (oi, of, _) in enumerate(outs[2:], 2):
        np.testing.assert_array_equal(oi, outs[i % 2][0])
        np.testing.assert_array_equal(of, outs[i % 2][1])
