"""Bring-up check: the normal entry points run on an NVIDIA GPU and agree
with the float64 CPU reference.

    python chip_smoke.py               # phases a-f, one card
    python chip_smoke.py --four-cards  # phase d on four visible cards,
                                       # plus dryrun_multichip(4)

This process never starts a JAX backend.  Every leg that computes on the
card runs as a child process, one at a time, and every float64 CPU leg
runs as a JAX_PLATFORMS=cpu child, which never opens the card.  Any failed
phase ends the run with a non-zero exit; nothing is caught and carried
on.  Each phase prints its seconds on a line of its own, and the last line
is one JSON object:

    {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": 1}}

Phases:
  a. environment: nvidia-smi, JAX version and device, compile cache;
  b. native build: `make -C native -B`, so nothing built elsewhere loads;
  c. the golden workloads (tests/data/golden_*.vcf) and the f32-parity
     workload through the CLI on the GPU, under the f32 contract
     (uvc_tpu/vcfout/compare.py);
  d. a 200-kb tumor-only capture panel (4 contigs x 50 kb, 300x) through
     `python -m uvc_tpu.cli.uvc1` on the GPU against a CPU-x64 run;
  e. the packed quality model and the fragment consensus against their
     references at real widths, and the CLI with UVC_TPU_DEVICE_PREPARE=1
     against the same run with the gate at 0;
  f. the gpu-marked tests.
"""

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
CHILD_TIMEOUT_S = 900


class SmokeFailure(Exception):
    pass


def _check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def _env(cpu=False, **extra):
    env = dict(os.environ, PYTHONPATH=REPO, **extra)
    if cpu:
        env["JAX_PLATFORMS"] = "cpu"
    return env


def _run(argv, cpu=False, env_extra=None, check=True):
    """Run one child to its end; returns (stdout, stderr, seconds)."""
    t0 = time.time()
    r = subprocess.run(argv, cwd=REPO, env=_env(cpu, **(env_extra or {})),
                       capture_output=True, text=True,
                       timeout=CHILD_TIMEOUT_S)
    dt = time.time() - t0
    if check and r.returncode != 0:
        sys.stderr.write(r.stdout[-3000:] + r.stderr[-6000:])
        raise SmokeFailure(f"{' '.join(argv[:4])} ... exited {r.returncode}")
    return r.stdout, r.stderr, dt


def _cli(argv, cpu=False, env_extra=None):
    """`python -m <argv>`; returns (stderr, seconds).  A GPU leg must name
    the GPU as its model device in every exit summary."""
    _, err, dt = _run([sys.executable, "-m", *argv], cpu, env_extra)
    devs = re.findall(r"model device: (\S+)", err)
    want = "cpu" if cpu else "gpu"
    _check(devs and all(d == want for d in devs),
           f"{argv[0]}: model device {devs}, expected {want}")
    return err, dt


def _devcheck(argv, cpu=False):
    """`python -m uvc_tpu.devcheck <argv>`; returns its JSON report."""
    out, _, _ = _run([sys.executable, "-m", "uvc_tpu.devcheck", *argv], cpu)
    return json.loads(out.strip().splitlines()[-1][len("devcheck "):])


def _records(path):
    from uvc_tpu.io import bgzf
    return bgzf.decompress(open(path, "rb").read()).decode().splitlines()


def _body(lines):
    return [l for l in lines if not l.startswith("##")]


def _contract(ref_lines, got_lines, what):
    """Hold got_lines to the f32 contract against ref_lines; returns the
    number of VCF record lines (variants and aux lines) compared."""
    from uvc_tpu.vcfout import compare
    errs = compare.f32_contract_diffs(ref_lines, got_lines)
    n = len(compare.parse_records(ref_lines))
    for e in errs[:20]:
        print("   ", e)
    _check(not errs, f"{what}: {len(errs)} f32-contract divergences")
    return n


def phase_env(want_count):
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    _check(smi.returncode == 0, "nvidia-smi failed")
    for line in smi.stdout.strip().splitlines():
        print(f"card: {line.strip()}")
    probe = ("import json, jax\n"
             "from uvc_tpu.utils import jaxcache\n"
             "d = jax.devices()\n"
             "print(json.dumps(dict(jax=jax.__version__, "
             "platform=d[0].platform, kind=d[0].device_kind, "
             "count=len(d), cache=jaxcache.cache_dir() or "
             "'JAX_COMPILATION_CACHE_DIR=' + "
             "__import__('os').environ['JAX_COMPILATION_CACHE_DIR'])))\n")
    out, _, _ = _run([sys.executable, "-c", probe])
    info = json.loads(out.strip().splitlines()[-1])
    print(f"jax {info['jax']}: {info['platform']} {info['kind']} "
          f"x{info['count']}; compile cache {info['cache']}")
    _check(info["platform"] == "gpu", "no GPU backend")
    if want_count:
        _check(info["count"] == want_count,
               f"{info['count']} devices visible, expected {want_count}")
    return {"platform": info["platform"], "kind": info["kind"],
            "count": info["count"]}


def phase_native():
    cxx = subprocess.run(["c++", "--version"], capture_output=True,
                         text=True).stdout.splitlines()
    print(f"compiler: {cxx[0] if cxx else 'unknown'}")
    r = subprocess.run(["make", "-C", os.path.join(REPO, "native"), "-B"],
                       capture_output=True, text=True, timeout=600)
    for line in r.stdout.splitlines():
        if line.startswith(("g++", "c++", "cc", "clang")):
            print(f"  {line}")
    _check(r.returncode == 0, f"native build failed:\n{r.stderr[-3000:]}")
    from uvc_tpu.io import native as native_io
    from uvc_tpu.ops import native_rowpile
    _check(native_rowpile.available(), "native rowpile kernels unavailable")
    _check(native_io.available(), "native BAM decoder unavailable")
    print("native kernels: rowpile.so and bamdec.so load")


def phase_goldens(work):
    from uvc_tpu.io import goldens
    for name in goldens.NAMES:
        argv, out = goldens.build(name, os.path.join(work, "golden", name))
        _, dt = _cli(argv)
        got = _body(_records(out))
        if name in goldens.GOLDEN_FILES:
            ref = open(os.path.join(REPO, "tests", "data",
                                    goldens.GOLDEN_FILES[name])
                       ).read().splitlines()
            against = goldens.GOLDEN_FILES[name]
        else:
            cpu_argv, cpu_out = goldens.build(
                name, os.path.join(work, "golden", name + "_cpu"))
            _cli(cpu_argv, cpu=True)
            ref = _body(_records(cpu_out))
            against = "CPU-x64 run"
        n = _contract(ref, got, name)
        print(f"  {name}: {n} VCF lines match {against} under the f32 "
              f"contract (byte-identical body: {ref == got}); GPU leg "
              f"{dt:.1f} s")


def build_panel(d, seed=2024):
    """The phase-d panel: 4 contigs x 50,000 bp at 300x, 100-bp paired
    reads, 8 SNVs and 2 indels per contig at VAF 0.05-0.30."""
    from uvc_tpu.io import simulate
    os.makedirs(d, exist_ok=True)
    vafs = (0.05, 0.10, 0.15, 0.20, 0.25, 0.30)
    contigs = []
    for ci in range(4):
        ref = simulate.random_ref(50000, seed + ci)
        vs = []
        for i in range(8):
            p = 2500 + 5800 * i
            alt = "A" if ref[p] != "A" else "C"
            vs.append(simulate.Variant(p, f"{ref[p]}>{alt}",
                                       vafs[(ci + i) % len(vafs)]))
        vs.append(simulate.Variant(20200, "+CT", vafs[ci]))
        vs.append(simulate.Variant(38300, "-2", vafs[ci + 2]))
        contigs.append((f"chr{ci + 1}", ref, vs))
    bam, fa = os.path.join(d, "tumor.bam"), os.path.join(d, "ref.fa")
    n_reads = simulate.build_bam_multi(bam, contigs, depth=300, seed=seed)
    with open(fa, "w") as fh:
        for name, ref, _ in contigs:
            fh.write(f">{name}\n{ref}\n")
    return bam, fa, n_reads


_SUMMARY = re.compile(
    r"uvc_tpu: (\d+) reads, (\d+) regions, (\d+) records in ([\d.]+)s .*"
    r"cpu-s: (prepare=[\d.]+ model=[\d.]+ emit=[\d.]+)")


def _panel_cli(bam, fa, out, cpu=False, env_extra=None):
    """The panel through the CLI with one worker per core."""
    return _cli(["uvc_tpu.cli.uvc1", "-f", fa, "-o", out, "-t",
                 str(os.cpu_count() or 1), bam], cpu, env_extra)


def phase_panel(work):
    t0 = time.time()
    bam, fa, n_bam = build_panel(os.path.join(work, "panel"))
    print(f"  simulated the panel ({n_bam} reads in the BAM) in "
          f"{time.time() - t0:.1f} s")
    gpu_out = os.path.join(work, "panel", "gpu.vcf.gz")
    err, dt = _panel_cli(bam, fa, gpu_out)
    m = _SUMMARY.search(err)
    dev = re.search(r"model device: .*", err)
    _check(m and dev, "CLI exit summary missing")
    print(f"  CLI counts {m.group(1)} reads (reads in the overlap of two "
          f"tier-1 windows count twice), {m.group(2)} regions, "
          f"{m.group(3)} records")
    print(f"  smoke timing (not a metric): GPU leg wall {dt:.2f} s, CLI "
          f"{m.group(4)} s; cpu-s {m.group(5)}")
    print(f"  {dev.group(0)}")
    reqs = re.search(r"(\d+) requests, (\d+) rows", dev.group(0))
    _check(reqs and int(reqs.group(1)) > 0 and int(reqs.group(2)) > 0,
           "no model rows were evaluated on the GPU")
    cpu_out = os.path.join(work, "panel", "cpu.vcf.gz")
    _, cdt = _panel_cli(bam, fa, cpu_out, cpu=True)
    n = _contract(_records(cpu_out), _records(gpu_out), "panel")
    print(f"  {n} VCF lines match the CPU-x64 run under the f32 contract "
          f"(CPU leg {cdt:.1f} s)")
    return bam, fa, gpu_out, dt


def phase_device_programs(work, bam, fa, gpu_out, gpu_dt):
    import numpy as np
    from uvc_tpu import devcheck
    leaves = {}
    for leg, cpu in (("gpu", False), ("cpu_x64", True)):
        path = os.path.join(work, f"model_{leg}.npz")
        rep = _devcheck(["model", "--rows", str(devcheck.MODEL_ROWS),
                         "--out", path], cpu)
        print(f"  packed model on {leg}: {json.dumps(rep)}")
        if not cpu:
            _check(rep["platform"] == "gpu", "model leg did not run on GPU")
            _check(rep["hlo_dot"] == 0 and rep["hlo_convolution"] == 0
                   and not rep["hlo_library_calls"],
                   "the compiled model holds a dot/convolution/library call")
        leaves[leg] = devcheck.load_leaves(path)
    planes = leaves["gpu"][1]
    _check(all(np.array_equal(v, leaves["cpu_x64"][1][k])
               for k, v in planes.items()),
           "the two legs built different requests")
    errs, table = devcheck.compare_model(leaves["cpu_x64"][0],
                                         leaves["gpu"][0], planes)
    print(f"  packed model: {len(table)} leaves on {devcheck.MODEL_ROWS} "
          f"distinct candidate rows; "
          f"{sum(1 for v in table.values() if v[0] == 0)} leaves exact on "
          f"every row")
    print("  leaf: max |GPU - CPU x64|, rows beyond its bound "
          "(devcheck.int_tolerance), for the other leaves:")
    for name, (maxd, n_rows) in table.items():
        if maxd:
            print(f"    {name}: {maxd} {n_rows}")
    for e in errs[:20]:
        print("   ", e)
    _check(not errs, f"packed model: {len(errs)} leaves break the contract")

    rep = _devcheck(["consensus", bam, fa])
    print(f"  fragment consensus: {json.dumps(rep)}")
    _check(rep["platform"] == "gpu" and rep["exact"],
           "device consensus is not bit-exact with pileup/consensus.py")

    gate_out = os.path.join(work, "panel", "gpu_gate1.vcf.gz")
    err, dt = _panel_cli(bam, fa, gate_out,
                         env_extra={"UVC_TPU_DEVICE_PREPARE": "1"})
    _check("device-prepare:" in err, "the gate did not engage")
    same = _body(_records(gate_out)) == _body(_records(gpu_out))
    print(f"  UVC_TPU_DEVICE_PREPARE=1 vs 0: VCF bodies byte-identical: "
          f"{same}; walls (information only) gate=1 {dt:.2f} s, gate=0 "
          f"{gpu_dt:.2f} s")
    _check(same, "device-prepare VCF differs from the host path")


def phase_gpu_tests():
    out, err, _ = _run([sys.executable, "-m", "pytest", "-m", "gpu",
                        "tests/", "-q", "-rs", "-p", "no:cacheprovider"],
                       check=False)
    tail = (out + err).strip().splitlines() or ["(no output)"]
    print("  " + tail[-1])
    _check(re.search(r"\d+ passed", tail[-1])
           and not re.search(r"failed|error|skipped", tail[-1]),
           "gpu-marked tests did not all pass:\n" + "\n".join(tail[-30:]))


def dryrun_four():
    code = ("import __graft_entry__ as g\n"
            "g.dryrun_multichip(4)\n")
    out, _, _ = _run([sys.executable, "-c", code])
    print("  " + out.strip().splitlines()[-1])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run phase d on four visible cards and "
                         "dryrun_multichip(4), and nothing else")
    args = ap.parse_args(argv)
    plats = os.environ.get("JAX_PLATFORMS", "")
    if plats and not re.search(r"cuda|gpu", plats):
        sys.exit(f"chip_smoke: JAX_PLATFORMS={plats!r} names no GPU")
    import uvc_tpu  # noqa: F401  (fails outside a checkout of the repo)

    work = tempfile.mkdtemp(prefix="chip_smoke_")
    state = {}
    phases = [
        ("a. environment", lambda: state.update(
            device=phase_env(4 if args.four_cards else None))),
        ("b. native build", phase_native),
    ]
    if args.four_cards:
        phases += [("d. panel on four cards", lambda: phase_panel(work)),
                   ("dryrun_multichip(4)", dryrun_four)]
    else:
        phases += [
            ("c. goldens", lambda: phase_goldens(work)),
            ("d. panel", lambda: state.update(panel=phase_panel(work))),
            ("e. device programs",
             lambda: phase_device_programs(work, *state["panel"])),
            ("f. gpu tests", phase_gpu_tests),
        ]
    try:
        for name, fn in phases:
            print(f"phase {name}", flush=True)
            t0 = time.time()
            fn()
            print(f"phase {name}: {time.time() - t0:.1f} s", flush=True)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", flush=True)
        return 1
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(json.dumps({"ok": True, "device": state["device"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
