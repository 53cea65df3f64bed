"""The seeded workloads behind tests/data/golden_*.vcf and the f32-parity
test, in one place so that the CPU tests and chip_smoke.py run the same
inputs.

``build(name, d)`` simulates the workload's BAM(s) and FASTA under ``d``
and returns ``(argv, out)``: the arguments of ``python -m`` that call it
through the normal CLI, and the VCF that run writes.
"""

import os

from . import simulate

# workload name -> committed golden VCF body (tests/data); f32_parity has
# none: it is compared with a CPU-x64 run of itself
GOLDEN_FILES = {
    "small": "golden_small.vcf",
    "umi_duplex": "golden_umi_duplex.vcf",
    "iontorrent": "golden_iontorrent.vcf",
    "tumor_normal": "golden_tn.vcf",
}
NAMES = tuple(GOLDEN_FILES) + ("f32_parity",)


def _snv(ref, p, alt, other):
    return f"{ref[p]}>" + (alt if ref[p] != alt else other)


def _fasta(d, ref):
    fa = os.path.join(d, "ref.fa")
    with open(fa, "w") as fh:
        fh.write(">chr1\n" + ref + "\n")
    return fa


def build(name, d):
    os.makedirs(d, exist_ok=True)
    bam = os.path.join(d, f"{name}.bam")
    out = os.path.join(d, f"{name}.vcf.gz")
    uvc1 = "uvc_tpu.cli.uvc1"
    if name == "small":
        ref = simulate.random_ref(6000, 42)
        variants = [simulate.Variant(1000, _snv(ref, 1000, "A", "G"), 0.3),
                    simulate.Variant(2500, "+CT", 0.3),
                    simulate.Variant(4200, "-2", 0.3)]
        simulate.build_bam(bam, ref, depth=100, variants=variants,
                           seed=1234)
        return [uvc1, "-f", _fasta(d, ref), "-o", out, "-t", "1", bam], out
    if name == "umi_duplex":
        ref = simulate.random_ref(4000, 91)
        variants = [simulate.Variant(1200, _snv(ref, 1200, "A", "G"), 0.4),
                    simulate.Variant(2800, "+TG", 0.4)]
        simulate.build_bam(bam, ref, depth=160, variants=variants, seed=77,
                           umi=True, duplex=True, n_umi_families=60)
        return [uvc1, "-f", _fasta(d, ref), "-t", "1", bam, "-o", out], out
    if name == "iontorrent":
        ref = simulate.random_ref(4000, 92)
        variants = [simulate.Variant(1500, _snv(ref, 1500, "C", "T"), 0.35),
                    simulate.Variant(2600, "-2", 0.35)]
        simulate.build_bam(bam, ref, depth=120, variants=variants, seed=78)
        return [uvc1, "-f", _fasta(d, ref), "-t", "1", bam,
                "--sequencing-platform", "2", "-o", out], out
    if name == "tumor_normal":
        ref = simulate.random_ref(4000, 93)
        tvars = [simulate.Variant(1100, _snv(ref, 1100, "A", "C"), 0.3),
                 simulate.Variant(2400, _snv(ref, 2400, "G", "T"), 0.5)]
        nvars = [tvars[1]]   # germline
        tbam, nbam = os.path.join(d, "t.bam"), os.path.join(d, "n.bam")
        simulate.build_bam(tbam, ref, depth=140, variants=tvars, seed=81)
        simulate.build_bam(nbam, ref, depth=140, variants=nvars, seed=82)
        pref = os.path.join(d, "o")
        return (["uvc_tpu.cli.uvctn", _fasta(d, ref), tbam, nbam, pref,
                 "TS,NS"], pref + ".normal.vcf.gz")
    if name == "f32_parity":
        ref = simulate.random_ref(12000, 99)
        variants = [
            simulate.Variant(1500, _snv(ref, 1500, "A", "G"), 0.35),
            simulate.Variant(3000, "+CT", 0.30),
            simulate.Variant(4500, "-2", 0.30),
            simulate.Variant(6000, _snv(ref, 6000, "C", "T"), 0.12),
            simulate.Variant(8000, _snv(ref, 8000, "T", "A"), 0.06),
        ]
        simulate.build_bam(bam, ref, depth=120, variants=variants, seed=77)
        return [uvc1, "-f", _fasta(d, ref), "-o", out, "-t", "1", bam], out
    raise ValueError(f"unknown golden workload {name!r}")
