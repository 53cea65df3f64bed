"""Golden-output regression: the full CLI VCF body for a fixed dataset is
pinned to a committed snapshot, catching unintended behavior drift.  The
workloads live in uvc_tpu/io/goldens.py, shared with chip_smoke.py.

Regenerate after INTENTIONAL behavior changes with:
    UPDATE_GOLDEN=1 python -m pytest tests/test_golden.py -q
"""

import os
import subprocess
import sys

from uvc_tpu.io import bgzf, goldens

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _body(text):
    # skip ##-meta (carries date/cmdline); keep #CHROM + records
    return [l for l in text.splitlines() if not l.startswith("##")]


def _golden_check(name, body):
    path = os.path.join(os.path.dirname(__file__), "data",
                        goldens.GOLDEN_FILES[name])
    if os.environ.get("UPDATE_GOLDEN"):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        open(path, "w").write("\n".join(body) + "\n")
    assert os.path.exists(path), f"{path} missing; run with UPDATE_GOLDEN=1"
    assert body == open(path).read().splitlines()


def _run_golden(tmp_path, name):
    argv, out = goldens.build(name, str(tmp_path))
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    subprocess.run([sys.executable, "-m", *argv], check=True, env=env,
                   capture_output=True)
    _golden_check(name, _body(bgzf.decompress(open(out, "rb").read())
                              .decode()))


def test_golden_vcf_body(tmp_path):
    _run_golden(tmp_path, "small")


def test_golden_umi_duplex(tmp_path):
    """Pinned VCF body for a duplex-UMI dataset (cDP2/SSCS/duplex tiers)."""
    _run_golden(tmp_path, "umi_duplex")


def test_golden_iontorrent(tmp_path):
    """Pinned VCF body with the IonTorrent (TIsProton) branches forced."""
    _run_golden(tmp_path, "iontorrent")


def test_golden_tumor_normal(tmp_path):
    """Pinned VCF body for the tumor-normal joint mode (uvctn driver)."""
    from uvc_tpu.cli import uvctn
    argv, out = goldens.build("tumor_normal", str(tmp_path))
    assert argv[0] == "uvc_tpu.cli.uvctn"
    rc = uvctn.run(argv[1:])
    assert rc == 0 or rc is None
    _golden_check("tumor_normal",
                  _body(bgzf.decompress(open(out, "rb").read()).decode()))
