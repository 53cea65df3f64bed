"""Accelerator-regime record parity: f32/i32 model vs the f64 goldens.

An accelerator computes the model without x64, on a request cast
f64->f32 / i64->i32 (calling._MODEL_CAST_F32); the goldens are pinned on
CPU x64.  This test runs the SAME CLI workload in both regimes
(UVC_TPU_MODEL_F32=1 emulates the accelerator number regime exactly on
CPU) and holds the f32 run to the contract of
uvc_tpu/vcfout/compare.py.  chip_smoke.py holds the GPU to the same
contract.
"""

import os
import subprocess
import sys

import pytest

from uvc_tpu.io import bgzf, goldens
from uvc_tpu.vcfout import compare

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_cli(tmp_path, tag, extra_env):
    argv, out = goldens.build("f32_parity", str(tmp_path / tag))
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO,
               **extra_env)
    r = subprocess.run([sys.executable, "-m", *argv], env=env, cwd=REPO,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    body = bgzf.decompress(open(out, "rb").read()).decode()
    return [l for l in body.splitlines() if not l.startswith("#")]


def test_f32_records_match_f64(tmp_path):
    recs64 = _run_cli(tmp_path, "f64", {})
    recs32 = _run_cli(tmp_path, "f32", {"UVC_TPU_MODEL_F32": "1"})
    assert len(compare.parse_records(recs64)) >= 4, "workload too small"
    errs = compare.f32_contract_diffs(recs64, recs32)
    assert not errs, f"{len(errs)} divergences:\n" + "\n".join(errs[:30])


_REC = ("chr1\t100\t.\tA\tC\t45.000000\tPASS\tANY_VAR\t"
        "GT:DP:FTS\t0/1:30,12:nonref")


def _edit(col, value):
    c = _REC.split("\t")
    c[col] = value
    return "\t".join(c)


@pytest.mark.parametrize("got,ok", [
    (_REC, True),
    (_edit(5, "45.600000"), False),                   # QUAL off by 0.6
    (_edit(6, "Q10"), False),                         # FILTER differs
    (_edit(9, "0/1:30,12:other"), False),             # string differs
], ids=["identical", "qual_off_0.6", "filter_differs", "string_differs"])
def test_record_comparator(got, ok):
    assert (compare.f32_contract_diffs([_REC], [got]) == []) is ok


def test_germline_same_on_int32_model_outputs(tmp_path):
    """An f32 device returns the model's integer planes as int32; the host
    germline stage must give the same NLODQ and alleles as on int64
    (its int64-min sentinel once wrapped to 0 on int32 gVQ1)."""
    import numpy as np
    from uvc_tpu import calling
    from uvc_tpu.config import UVCConfig
    from uvc_tpu.constants import CHAR_TO_SYMBOL
    from uvc_tpu.io.native import read_bam_native
    from uvc_tpu.io import simulate
    from uvc_tpu.model import germline

    ref = simulate.random_ref(3000, 2024)
    variants = [simulate.Variant(1500, f"{ref[1500]}>"
                                 + ("A" if ref[1500] != "A" else "C"), 0.1)]
    bam = str(tmp_path / "g.bam")
    simulate.build_bam(bam, ref, depth=300, variants=variants, seed=3)
    _, batch = read_bam_native(bam)
    cfg = UVCConfig()
    ref_syms = CHAR_TO_SYMBOL[np.frombuffer(ref.encode(), np.uint8) & 0x7F]
    ctx = calling.prepare_region(batch, ref_syms, 0, cfg)
    calling.model_stage_batched([ctx], cfg)
    F = ctx["F"]
    F32 = {k: (v.astype(np.int32) if isinstance(v, np.ndarray)
               and v.dtype == np.int64 else v) for k, v in F.items()}
    g64 = germline.germline_nlodq(F, F["_cand"], cfg)
    g32 = germline.germline_nlodq(F32, F["_cand"], cfg)
    for st in (0, 1):
        for k, v in g64[st].items():
            np.testing.assert_array_equal(np.asarray(g32[st][k]),
                                          np.asarray(v), err_msg=f"{st} {k}")
