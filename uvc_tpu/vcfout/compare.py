"""Record comparison under the f32 contract.

The model runs in float64 on a CPU backend (the goldens) and in
float32/int32 on an accelerator.  Two runs of the same workload in the two
regimes must agree as follows:

- identical record sets (CHROM, POS, REF, ALT): a borderline candidate
  crossing the vqual gate under f32 rounding fails loudly;
- identical FILTER strings;
- QUAL within 0.51 (band edges stay identical through the FILTER check);
- every numeric FORMAT value within 1 unit (integer fields are deciphred
  or x100 fixed point, so one f32 ulp can move a rounding by 1);
- string FORMAT values byte-identical.
"""

QUAL_TOL = 0.51
FORMAT_TOL = 1


def parse_records(lines):
    """{(CHROM, POS, REF, ALT): (QUAL, FILTER, {FORMAT tag: value})} for
    the record lines of a VCF body (header lines are skipped)."""
    out = {}
    for line in lines:
        if not line or line.startswith("#"):
            continue
        c = line.split("\t")
        key = (c[0], c[1], c[3], c[4])
        out[key] = (c[5], c[6], dict(zip(c[8].split(":"),
                                         c[9].split(":"))))
    return out


def _num_close(a, b, tol=FORMAT_TOL):
    """True/False for numeric (comma-separated) values, None when either
    is not numeric."""
    try:
        va = [float(x) if x not in (".", "") else 0.0 for x in a.split(",")]
        vb = [float(x) if x not in (".", "") else 0.0 for x in b.split(",")]
    except ValueError:
        return None
    if len(va) != len(vb):
        return False
    return all(abs(x - y) <= tol for x, y in zip(va, vb))


def f32_contract_diffs(ref_lines, got_lines):
    """Every way the records of ``got_lines`` break the f32 contract
    against ``ref_lines``; an empty list means they agree."""
    ref, got = parse_records(ref_lines), parse_records(got_lines)
    errs = []
    if set(ref) != set(got):
        errs.append(f"record sets differ: only-ref={sorted(set(ref) - set(got))} "
                    f"only-got={sorted(set(got) - set(ref))}")
    for key in sorted(set(ref) & set(got)):
        qr, fr, mr = ref[key]
        qg, fg, mg = got[key]
        if fr != fg:
            errs.append(f"{key} FILTER {fr} != {fg}")
        if qr == "." or qg == ".":            # aux records (MGVCF etc.)
            if qr != qg:
                errs.append(f"{key} QUAL {qr} vs {qg}")
        elif abs(float(qr) - float(qg)) > QUAL_TOL:
            errs.append(f"{key} QUAL {qr} vs {qg}")
        if set(mr) != set(mg):
            errs.append(f"{key} FORMAT keys differ")
            continue
        for tag, vr in mr.items():
            vg = mg[tag]
            if vr == vg:
                continue
            ok = _num_close(vr, vg)
            if ok is None:
                errs.append(f"{key} {tag} string {vr!r} != {vg!r}")
            elif not ok:
                errs.append(f"{key} {tag} {vr} vs {vg}")
    return errs
