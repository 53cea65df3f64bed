"""The two jitted device programs against their references at real widths.

Each leg runs in a process of its own, so that one process at a time
holds a card:

    python -m uvc_tpu.devcheck model --rows 65536 --out leaves.npz
        Evaluate the packed quality model (calling._get_packed_model) on
        one request of real prepared planes, ``rows`` distinct positions
        that are all candidate rows, on this process's default backend,
        and save every output leaf.  Run it on the GPU and under
        JAX_PLATFORMS=cpu (float64), then hold the two to the model
        contract with compare_model().  Also prints what the compiled
        program contains (dot/convolution count, library calls), its
        memory analysis and its mean time per call.

    python -m uvc_tpu.devcheck consensus BAM FASTA
        Prepare the work unit of BAM with the most reads with
        UVC_TPU_DEVICE_PREPARE=1, check every device_reduce_consensus
        call of that region bit-exactly against pileup/consensus.py, and
        print the memory analysis of the program at the largest row
        bucket it ran.

Both print one JSON line (prefixed "devcheck ") with what they found.
"""

import argparse
import json
import os
import re
import sys
import time

import numpy as np

# Model contract between the f32 device and the float64 CPU reference.
# Integer leaves are deciphred or x100 fixed-point values rounded from
# float math, so one f32 ulp can move a rounding by 1 unit.  Float leaves
# are qualities in phred units built from log/pow chains; float32 carries
# ~7 significant digits and each transcendental step adds a few ulp, so
# they are held to a relative 1e-4 (and an absolute 1e-3 phred near 0).
INT_TOL = 1
FLOAT_RTOL = 1e-4
FLOAT_ATOL = 1e-3

MODEL_ROWS = 65536

# Input planes of the request that the bounds of int_tolerance() read.
BOUND_PLANES = ("bIADb", "aDPff", "aDPfr", "aDPrf", "aDPrr")


def int_tolerance(name, planes):
    """The bound an integer leaf is held to, broadcastable to [rows, NS].

    Most integer leaves hold at most one rounding of float math: INT_TOL.
    A few multiply or add up such roundings, and are held to what the
    product or the sum allows:
      - bIAQ = pb2 * nb2 // 1000 - ipb2 (model/qual.py): one unit in the
        rounded pb2 moves bIAQ by ceil(nb2 / 1000), with nb2 <= nb1 =
        bIADb * 100 + 1; the floor division, the unit of cDP1v in nb2 and
        the floored ipb2 add one each.
      - aBQQ = prior + max(q_2d, q_fw, q_rv) (calling._model_core), each q
        a truncated rss minus minABQa * D // 10 with D = aDPf + aDPr:
        minABQa holds two truncated squares, so two units move each q by
        2 * ceil(D / 10); the rss truncation and the floor divisions add
        four.
      - CDP{1,2}{v,w,x}, the sums over the candidate symbols of one type
        (model/dpv.sum_dpv): one unit per summed symbol, 6 for the base
        symbols and 8 for the link symbols."""
    if name == "bIAQ":
        nb1 = planes["bIADb"].astype(np.int64) * 100 + 1
        return INT_TOL * (-(-nb1 // 1000) + 3)
    if name == "aBQQ":
        D = sum(planes[k].astype(np.int64)
                for k in ("aDPff", "aDPfr", "aDPrf", "aDPrr"))
        return INT_TOL * (2 * -(-D // 10) + 4)
    if re.fullmatch(r"CDP[12][vwx]", name):
        return INT_TOL * np.where(np.arange(14) < 6, 6, 8)
    return INT_TOL


def _leaf_name(pk):
    return "/".join(str(k) for _, k in pk)


def _memory(compiled):
    ma = compiled.memory_analysis()
    return {k: int(getattr(ma, k)) for k in (
        "argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes", "generated_code_size_in_bytes")
        if ma is not None and hasattr(ma, k)}


def model_run(rows=MODEL_ROWS, n_iter=10):
    """(report, {leaf name: array}, {plane: array}) for one packed
    request of ``rows``
    distinct positions (model/example.example_packed_request) evaluated
    on the default backend.  report["run_s"] is the mean seconds per call
    of n_iter calls after a warm one, with the inputs resident on the
    device (the bench's device-model time).  The planes are the request's
    BOUND_PLANES."""
    import jax
    from . import calling
    from .model.example import example_packed_request
    from .utils.profiling import maybe_trace

    plat, kind, ndev = calling.init_model_device()
    (pi, pf, ispec, _, _), cfg = example_packed_request(rows)
    fn, ospec = calling._get_packed_model(cfg, True, False, ispec, "<f8")
    t0 = time.time()
    compiled = fn.lower(pi, pf).compile()
    compile_s = time.time() - t0
    hlo = compiled.as_text()
    targets = sorted(set(re.findall(r'custom_call_target="([^"]+)"', hlo)))
    pi_d = jax.device_put(pi)
    out = jax.block_until_ready(compiled(pi_d, pf))    # warm
    with maybe_trace("device_quality_model"):          # UVC_TPU_JAX_TRACE_DIR
        t0 = time.time()
        for _ in range(n_iter):
            out = compiled(pi_d, pf)
        oi, of = jax.block_until_ready(out)
        run_s = (time.time() - t0) / n_iter
    tree = calling.unpack_model_response((np.asarray(oi), np.asarray(of),
                                          ospec))
    leaves = {_leaf_name(calling._path_key(p)): np.asarray(v)
              for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}
    planes, off = {}, 0
    for k, w, _, _ in ispec:
        if k in BOUND_PLANES:
            planes[k] = pi[:, off:off + w]
        off += w
    report = dict(
        platform=plat, device_kind=kind, devices=ndev, rows=rows,
        wire_dtype=str(pi.dtype), leaves=len(leaves),
        hlo_dot=len(re.findall(r"\bdot\(", hlo)),
        hlo_convolution=len(re.findall(r"\bconvolution\(", hlo)),
        hlo_library_calls=[t for t in targets
                           if re.search("cublas|cudnn|gemm|conv", t, re.I)],
        memory_analysis=_memory(compiled), compile_s=round(compile_s, 3),
        run_s=round(run_s, 6))
    return report, leaves, planes


def compare_model(ref, got, planes):
    """Hold ``got`` (the device's leaves) to the model contract against
    ``ref`` (float64 CPU) on every row; every row of the request is a
    candidate row.  ``planes`` are the request's BOUND_PLANES.  Returns
    (errors, table) with table[leaf] = (max difference, rows beyond the
    tolerance)."""
    errs, table = [], {}
    if set(ref) != set(got):
        errs.append(f"leaf sets differ: {sorted(set(ref) ^ set(got))}")
    n_rows = max(max(v.shape[:2]) for v in ref.values())
    for name in sorted(set(ref) & set(got)):
        r, g = ref[name], got[name]
        if r.shape != g.shape:
            errs.append(f"{name}: shape {r.shape} vs {g.shape}")
            continue
        if r.dtype.kind == "f" or g.dtype.kind == "f":
            r64, g64 = r.astype(np.float64), g.astype(np.float64)
            fin = np.isfinite(r64) & np.isfinite(g64)
            d = np.where(fin, np.abs(r64 - g64), 0.0)
            beyond = (d > FLOAT_ATOL + FLOAT_RTOL * np.abs(np.where(
                fin, r64, 0.0))) | (~fin & (r64 != g64)
                                    & ~(np.isnan(r64) & np.isnan(g64)))
            maxd = float(d.max()) if d.size else 0.0
        else:
            d = np.abs(r.astype(np.int64) - g.astype(np.int64))
            beyond = d > int_tolerance(name, planes)
            maxd = int(d.max()) if d.size else 0
        row_axis = 0 if r.shape[0] == n_rows else 1
        rows = np.moveaxis(beyond, row_axis, 0).reshape(n_rows, -1).any(1)
        table[name] = (maxd, int(rows.sum()))
        if table[name][1]:
            errs.append(f"{name}: {table[name][1]} rows beyond the "
                        f"tolerance, max diff {maxd}")
    return errs, table


def consensus_check(bam, fasta):
    """Report of the bit-exact device-vs-reference check of every
    fragment-consensus call of BAM's largest work unit, with the memory
    analysis of the program at the largest row bucket it ran."""
    from unittest import mock

    from . import calling
    from .cli import uvc1 as uvc1_cli
    from .config import UVCConfig
    from .constants import CHAR_TO_SYMBOL
    from .io.bam import filter_batch
    from .io.fasta import FastaFile
    from .io.native import read_bam_native
    from .ops import device_consensus as devcons
    from .pileup import consensus as cns
    from .schedule import regions as regions_mod

    os.environ["UVC_TPU_DEVICE_PREPARE"] = "1"
    plat, kind, _ = calling.init_model_device()
    cfg = UVCConfig()
    cfg.bam_input_fname = bam
    header, batch = read_bam_native(bam)
    batch = filter_batch(batch, cfg)
    cfg.self_update_by_platform(*uvc1_cli.infer_platform(batch, cfg))
    ref_lens = dict(enumerate(header.ref_lens))
    plans = regions_mod.split_plans_into_units(
        regions_mod.plan(batch, ref_lens, cfg.mem_per_thread), batch,
        ref_lens)
    plan = max(plans, key=lambda p: p.read_end - p.read_beg)
    sub = regions_mod.region_read_filter(
        regions_mod.slice_batch(batch, plan), plan, cfg)
    refstring = FastaFile(fasta).fetch(header.ref_names[plan.tid],
                                       plan.ext_beg, plan.ext_end)
    ref_syms = CHAR_TO_SYMBOL[np.frombuffer(refstring, np.uint8) & 0x7F]

    device_fn = devcons.device_reduce_consensus
    calls, statics = [], []

    def checked(group, pos, sym, val, P, mode, link_m_overridden):
        t0 = time.time()
        uniq_d, cons_d = device_fn(group, pos, sym, val, P, mode,
                                   link_m_overridden)
        dev_s = time.time() - t0
        reduce = (cns.segment_reduce_max if mode == "max"
                  else cns.segment_reduce_sum)
        uniq_r = reduce(group, pos, sym, val, P)
        c = cns.consensus_by_group(*uniq_r, P,
                                   link_m_overridden=link_m_overridden)
        cons_r = (c.group, c.pos, c.st, c.con_sym, c.con_cnt, c.tot)
        exact = all(np.array_equal(a, b) for a, b in
                    zip(uniq_d + cons_d, tuple(uniq_r) + cons_r))
        calls.append(dict(rows=len(group), exact=exact,
                          consensus_rows=len(cons_r[0]),
                          device_s=round(dev_s, 4)))
        statics.append((int(P), mode, bool(link_m_overridden)))
        return uniq_d, cons_d

    with mock.patch.object(devcons, "device_reduce_consensus", checked):
        calling.prepare_region(sub, ref_syms, plan.ext_beg, cfg)
    report = dict(platform=plat, device_kind=kind, reads=int(sub.n),
                  region=f"{header.ref_names[plan.tid]}:{plan.beg + 1}-"
                         f"{plan.end}", calls=calls,
                  exact=bool(calls) and all(c["exact"] for c in calls))
    if calls:
        import jax
        i = max(range(len(calls)), key=lambda i: calls[i]["rows"])
        N = devcons._bucket(calls[i]["rows"])
        col = jax.ShapeDtypeStruct((N,), np.int32)
        compiled = devcons._device_reduce_consensus.lower(
            col, col, col, col, jax.ShapeDtypeStruct((N,), np.bool_),
            *statics[i]).compile()
        report.update(bucket_rows=N, memory_analysis=_memory(compiled))
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m uvc_tpu.devcheck")
    sub = ap.add_subparsers(dest="leg", required=True)
    m = sub.add_parser("model")
    m.add_argument("--rows", type=int, default=MODEL_ROWS)
    m.add_argument("--out", required=True)
    c = sub.add_parser("consensus")
    c.add_argument("bam")
    c.add_argument("fasta")
    args = ap.parse_args(argv)
    if args.leg == "model":
        report, leaves, planes = model_run(args.rows)
        np.savez(args.out, **leaves,
                 **{"in:" + k: v for k, v in planes.items()})
        print("devcheck " + json.dumps(report), flush=True)
        return 0
    report = consensus_check(args.bam, args.fasta)
    print("devcheck " + json.dumps(report), flush=True)
    return 0 if report["exact"] else 1


def load_leaves(path):
    """(leaves, planes) saved by the model leg."""
    with np.load(path) as z:
        leaves = {k: z[k] for k in z.files if not k.startswith("in:")}
        planes = {k[3:]: z[k] for k in z.files if k.startswith("in:")}
    return leaves, planes


if __name__ == "__main__":
    sys.exit(main())
