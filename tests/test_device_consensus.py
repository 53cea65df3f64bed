"""On-device consensus reduction vs the host reference implementation.

ops/device_consensus.py is the device analog of the host sort+reduce
consensus (pileup/consensus.py, itself parity-pinned to
native/rowpile.cpp): one jitted lax.sort + segment_* program.  These
tests pin it row-for-row on random tables (all rule variants) and on the
REAL fragment event stream of a simulated BAM.
"""

import numpy as np
import pytest

from uvc_tpu.ops import device_consensus as dc
from uvc_tpu.pileup import consensus as cns


def _py_ref(group, pos, sym, val, P, mode, ovr):
    if mode == "max":
        uniq = cns.segment_reduce_max(group, pos, sym, val, P)
    else:
        uniq = cns.segment_reduce_sum(group, pos, sym, val, P)
    c = cns.consensus_by_group(*uniq, P, link_m_overridden=ovr)
    return uniq, (c.group, c.pos, c.st, c.con_sym, c.con_cnt, c.tot)


def _check(group, pos, sym, val, P, mode, ovr):
    uniq_d, cons_d = dc.device_reduce_consensus(group, pos, sym, val, P,
                                                mode, ovr)
    uniq_p, cons_p = _py_ref(group, pos, sym, val, P, mode, ovr)
    for a, b, nm in zip(uniq_d, uniq_p, ("ug", "up", "us", "uv")):
        np.testing.assert_array_equal(a, b, err_msg=f"uniq.{nm}")
    for a, b, nm in zip(cons_d, cons_p,
                        ("group", "pos", "st", "con_sym", "con_cnt", "tot")):
        np.testing.assert_array_equal(a, b, err_msg=f"cons.{nm}")


@pytest.mark.parametrize("mode", ["max", "sum"])
@pytest.mark.parametrize("ovr", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_random_tables(mode, ovr, seed):
    rng = np.random.default_rng(seed)
    n, P, G = 5000, 300, 40
    group = rng.integers(0, G, n).astype(np.int64)
    pos = rng.integers(0, P, n).astype(np.int64)
    sym = rng.integers(0, 14, n).astype(np.int64)
    val = rng.integers(0, 60, n).astype(np.int64)
    _check(group, pos, sym, val, P, mode, ovr)


def test_empty_and_tiny():
    z = np.zeros(0, dtype=np.int64)
    _check(z, z, z, z, 16, "max", False)
    _check(np.array([0]), np.array([3]), np.array([6]), np.array([9]),
           16, "sum", True)


def test_real_fragment_stream(tmp_path):
    """The real pileup event stream (fragment MAX-merge keys) through the
    device program equals the host reference."""
    from uvc_tpu.io import simulate, bam as bam_mod
    from uvc_tpu.pileup import events as ev_mod

    ref = simulate.random_ref(3000, 3)
    variants = [simulate.Variant(900, f"{ref[900]}>"
                                 + ("A" if ref[900] != "A" else "C"), 0.3),
                simulate.Variant(1500, "+CT", 0.3)]
    path = str(tmp_path / "d.bam")
    simulate.build_bam(path, ref, depth=60, variants=variants, seed=4)
    _, batch = bam_mod.read_bam(path)
    table = ev_mod.expand(batch)
    b = table.bases
    P = 3000
    group = b.read.astype(np.int64) // 2     # fragment-ish grouping
    pos = b.rpos.astype(np.int64)
    sym = b.sym.astype(np.int64)
    val = b.bq.astype(np.int64)
    assert len(group) > 50000
    _check(group, pos, sym, val, P, "max", True)
    _check(group, pos, sym, val, P, "sum", False)
