"""Multi-host distribution: contig-interval ownership + collective VCF merge.

Replaces the reference's share-nothing GNU-parallel/qsub per-chromosome
scale-out with filesystem hand-off (bin/uvcTN.sh, SURVEY.md §2): each host
owns a static partition of the region plans (deterministic global order),
calls its shard, bgzf-compresses its records locally, and host 0 gathers
the independently-compressed BGZF blocks over a JAX collective and
concatenates them raw — valid because BGZF members are independently
decompressible (tested in test_io.test_bgzf_block_concat_property).

Halo correctness needs no cross-host traffic during compute: every region
fetch over-reads MAX_INSERT_SIZE and analysis windows extend
MAX_STR_N_BASES (the reference's tiling rules, grouping.cpp:664,730,
main.cpp:529-530), so families and STR context never straddle an ownership
boundary unseen.

One process per host, each owning its local cards (calling's row sharding
spreads its requests over them).  This mode is tested with CPU processes
only; it has not run on GPUs.
"""

import os

import numpy as np

import jax


def initialize_if_requested():
    """jax.distributed.initialize from env (no-op single-host)."""
    if os.environ.get("UVC_TPU_COORDINATOR"):
        jax.distributed.initialize(
            coordinator_address=os.environ["UVC_TPU_COORDINATOR"],
            num_processes=int(os.environ.get("UVC_TPU_NUM_PROCESSES", "1")),
            process_id=int(os.environ.get("UVC_TPU_PROCESS_ID", "0")))


def my_plans(plans, process_id=None, process_count=None):
    """Static interval partition of the global region-plan list.

    Deterministic: every host computes the same global order and takes a
    contiguous stripe, balanced by read count."""
    pid = jax.process_index() if process_id is None else process_id
    pcount = jax.process_count() if process_count is None else process_count
    if pcount == 1:
        return list(plans), 0, len(plans)
    weights = np.array([max(p.read_end - p.read_beg, 1) for p in plans],
                      dtype=np.float64)
    cum = np.cumsum(weights) / weights.sum()
    bounds = np.searchsorted(cum, np.arange(1, pcount) / pcount, side="left")
    bounds = [0] + [int(b) + 1 for b in bounds] + [len(plans)]
    lo, hi = bounds[pid], bounds[pid + 1]
    return list(plans[lo:hi]), lo, hi


def allgather_bytes(blob: bytes, max_len: int = None):
    """Gather one byte blob from every process; returns list of blobs in
    process order. Rides a JAX collective; single-host returns
    [blob]."""
    if jax.process_count() == 1:
        return [blob]
    from jax.experimental import multihost_utils
    n = len(blob)
    # process_allgather stacks along a new leading axis: [pcount, ...]
    # (verified by the real 2-process CLI test in test_parallel.py)
    lens = np.asarray(multihost_utils.process_allgather(
        np.array([n], dtype=np.int64))).reshape(jax.process_count())
    cap = int(lens.max()) if max_len is None else max_len
    padded = np.zeros(cap, dtype=np.uint8)
    padded[:n] = np.frombuffer(blob, dtype=np.uint8)
    gathered = np.asarray(multihost_utils.process_allgather(padded))
    return [gathered[i, :int(lens[i])].tobytes()
            for i in range(jax.process_count())]


# (merge_vcf_shards was deleted: the CLI's per-window streaming gather
# writes the header/EOF inline, leaving this as dead duplicate logic —
# round-3 advisor finding #4)
