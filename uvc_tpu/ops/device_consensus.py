"""On-device segmented consensus reduction (prepare stage).

The hot loop of the reference's pileup ("updateByRegion3Aln",
main.hpp:3665-3742) reduces flat (group, pos, symbol, value) event tables
into per-(group, pos, symboltype) consensus rows — host-side this is
native/rowpile.cpp's sort+reduce.  This module is the device analog: ONE
jitted program of static shape that sorts with the multi-operand
`jax.lax.sort` (stable lexicographic, no wide-integer key packing, so it
runs in i32 with x64 off) and reduces with `jax.ops.segment_*`, left to
XLA — the building block for moving pileup tensorization onto the device.

Semantics are pinned against pileup/consensus.py (the behavioral
reference for native/rowpile.cpp) by tests/test_device_consensus.py on
random tables and on real pipeline event streams:
  - BASE consensus: first-maximum argmax over symbols 0..5, tot = sum;
  - LINK with link_m_overridden: non-LINK_M symbols override LINK_M,
    tot = winner count only;
  - plain LINK: argmax over 6..13 with full sum.

Production use is gated behind UVC_TPU_DEVICE_PREPARE=1 (wired in
pileup/region.py: the fragment MAX-merge routes through
device_reduce_consensus instead of the native host kernel, with
bit-identical output).  Whether the gate pays on a GPU is not measured
yet.  STATS counts the production calls/rows for the CLI exit summary.
"""

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp

from ..constants import NUM_SYMBOLS, Symbol

NS = NUM_SYMBOLS

# production-gate usage counters (reset-free; read by cli/uvc1.py's exit
# summary when UVC_TPU_DEVICE_PREPARE=1)
STATS = {"calls": 0, "rows": 0}


def _bucket(n):
    b = 1024
    while b < n:
        b *= 2
    return b


@partial(jax.jit, static_argnames=("P", "mode", "link_m_overridden"))
def _device_reduce_consensus(group, pos, sym, val, valid, P, mode,
                             link_m_overridden):
    """Padded static-shape reduce+consensus over [N] int32 columns.
    Pad rows sort last via a leading invalid key; outputs are fixed-[N]
    with (n_uniq, n_grp) row counts and zeros beyond them."""
    N = group.shape[0]
    i32 = jnp.int32
    inval = (~valid).astype(i32)
    # stage 1: collapse duplicate (group,pos,sym) rows
    o_inv, o_g, o_p, o_s, o_v = jax.lax.sort(
        (inval, group.astype(i32), pos.astype(i32), sym.astype(i32),
         val.astype(i32)), num_keys=4)
    ok = o_inv == 0
    same = (ok[1:] & ok[:-1] & (o_g[1:] == o_g[:-1])
            & (o_p[1:] == o_p[:-1]) & (o_s[1:] == o_s[:-1]))
    seg_start = jnp.concatenate([ok[:1], ok[1:] & ~same])
    seg_id = jnp.cumsum(seg_start.astype(i32)) - 1
    n_uniq = jnp.maximum(seg_id[-1] + 1, 0) * jnp.where(ok.any(), 1, 0)
    seg_id_c = jnp.where(ok, seg_id, N - 1)
    vz = jnp.where(ok, o_v, 0)
    if mode == "max":
        red = jax.ops.segment_max(vz, seg_id_c, num_segments=N)
    else:
        red = jax.ops.segment_sum(vz, seg_id_c, num_segments=N)

    def seg_field(x):
        return jax.ops.segment_max(jnp.where(ok, x, 0), seg_id_c,
                                   num_segments=N)

    u_g, u_p, u_s = seg_field(o_g), seg_field(o_p), seg_field(o_s)
    uvalid = jnp.arange(N) < n_uniq
    u_g = jnp.where(uvalid, u_g, 0)
    u_p = jnp.where(uvalid, u_p, 0)
    u_s = jnp.where(uvalid, u_s, 0)
    u_v = jnp.where(uvalid, red, 0)

    # stage 2: consensus per (group,pos,symboltype) over the unique rows
    u_st = (u_s >= 6).astype(i32)
    cvalid = uvalid & (u_v > 0)
    if link_m_overridden:
        link_cls = ((u_s == int(Symbol.LINK_M)) & (u_st == 1)).astype(i32)
    else:
        link_cls = jnp.zeros_like(u_s)
    c_inv = (~cvalid).astype(i32)
    (s_inv, s_g, s_p, s_st, s_cls, s_negv, s_s, s_v) = jax.lax.sort(
        (c_inv, u_g, u_p, u_st, link_cls, -u_v, u_s, u_v), num_keys=7)
    ok2 = s_inv == 0
    same2 = (ok2[1:] & ok2[:-1] & (s_g[1:] == s_g[:-1])
             & (s_p[1:] == s_p[:-1]) & (s_st[1:] == s_st[:-1]))
    gstart = jnp.concatenate([ok2[:1], ok2[1:] & ~same2])
    gid = jnp.cumsum(gstart.astype(i32)) - 1
    n_grp = jnp.maximum(gid[-1] + 1, 0) * jnp.where(ok2.any(), 1, 0)
    gid_c = jnp.where(ok2, gid, N - 1)
    tot = jax.ops.segment_sum(jnp.where(ok2, s_v, 0), gid_c,
                              num_segments=N)
    first = jnp.where(gstart, jnp.arange(N, dtype=i32), N)
    first_idx = jax.ops.segment_min(first, gid_c, num_segments=N)
    gvalid = jnp.arange(N) < n_grp
    first_idx = jnp.where(gvalid, jnp.minimum(first_idx, N - 1), 0)
    con_sym = jnp.where(gvalid, s_s[first_idx], 0)
    con_cnt = jnp.where(gvalid, s_v[first_idx], 0)
    c_grp = jnp.where(gvalid, s_g[first_idx], 0)
    c_pos = jnp.where(gvalid, s_p[first_idx], 0)
    c_st = jnp.where(gvalid, s_st[first_idx], 0)
    tot = jnp.where(gvalid, tot, 0)
    if link_m_overridden:
        tot = jnp.where((c_st == 1) & gvalid, con_cnt, tot)
    return (n_uniq, u_g, u_p, u_s, u_v, n_grp, c_grp, c_pos, c_st,
            con_sym, con_cnt, tot)


def device_reduce_consensus(group, pos, sym, val, P, mode,
                            link_m_overridden):
    """Host wrapper: pad to a power-of-two bucket, run the jitted program,
    slice to the true counts.  Returns ((ugroup,upos,usym,uval),
    (group,pos,st,con_sym,con_cnt,tot)) matching
    pileup/consensus.reduce_and_consensus row-for-row."""
    n = len(group)
    STATS["calls"] += 1
    STATS["rows"] += n
    N = _bucket(max(n, 1))

    # int32 on the wire: the program computes in i32 (x64 off on
    # accelerators), and positions, ids, symbols and counts fit
    def pad(a):
        return np.pad(np.asarray(a, dtype=np.int32), (0, N - n))

    valid = np.zeros(N, dtype=bool)
    valid[:n] = True
    out = _device_reduce_consensus(pad(group), pad(pos), pad(sym), pad(val),
                                   valid, int(P), mode,
                                   bool(link_m_overridden))
    (n_uniq, u_g, u_p, u_s, u_v, n_grp, c_grp, c_pos, c_st, con_sym,
     con_cnt, tot) = [np.asarray(x) for x in out]
    nu, ng = int(n_uniq), int(n_grp)
    uniq = tuple(x[:nu].astype(np.int64) for x in (u_g, u_p, u_s, u_v))
    cons = tuple(x[:ng].astype(np.int64)
                 for x in (c_grp, c_pos, c_st, con_sym, con_cnt, tot))
    return uniq, cons
