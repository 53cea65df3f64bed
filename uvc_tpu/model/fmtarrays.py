"""Dense per-(position, symbol) FORMAT tensors for the variant-call model.

Builds the [P,14] struct-of-arrays equivalent of bcfrec::BcfFormat
(BcfFormat_symboltype_init + BcfFormat_symbol_init + fill_symbol_VQ_fmts,
main.hpp:3745-4251): lowercase arrays are per-allele, capitalized arrays
are the symboltype sums broadcast back to [P,14], and *_nn arrays carry the
ambiguous-symbol (BASE_NN/LINK_NN) values.

The reference fills these per emitted candidate; this design
computes them densely for every (pos, symbol) so the downstream quality
model is pure elementwise tensor math.
"""

import numpy as np

from ..constants import Symbol, NUM_SYMBOLS
from ..pileup.consensus import sum_by_symboltype

NS = NUM_SYMBOLS
FLT_EPSILON = 1.1920928955078125e-07


def tdiv(a, b):
    """C-style integer division truncating toward zero (vectorized)."""
    a = np.asarray(a, dtype=np.int64)
    b = np.asarray(b, dtype=np.int64)
    q = np.abs(a) // np.abs(b)
    return np.where((a < 0) != (b < 0), -q, q)


def nn_broadcast(arr):
    """Value of the type's NN symbol broadcast to all symbols [P,14]."""
    base_nn = arr[:, int(Symbol.BASE_NN)][:, None]
    link_nn = arr[:, int(Symbol.LINK_NN)][:, None]
    return np.concatenate([np.repeat(base_nn, 6, axis=1),
                           np.repeat(link_nn, 8, axis=1)], axis=1)


def build(res, cfg, minABQ_snv, minABQ_indel):
    """res: pileup.region.RegionResult -> dict of dense arrays."""
    P = len(res.ref_syms)
    info = res.bq.seginfo
    fq = res.fq
    F = {}
    F["P"] = P
    F["ref_syms"] = res.ref_syms

    # all symboltype sums computed in ONE stacked pass (the ~60 separate
    # [P,14] reductions were dispatch-dominated)
    F["a1BQf"] = res.bq.vq_a1BQ[:, :, 0]
    F["a1BQr"] = res.bq.vq_a1BQ[:, :, 1]
    F["a2BQf_raw"] = res.bq.vq_a2BQ[:, :, 0]
    F["a2BQr_raw"] = res.bq.vq_a2BQ[:, :, 1]
    F["bDPf"] = res.bq.bdp[:, :, 0]
    F["bDPr"] = res.bq.bdp[:, :, 1]
    F["bTAf"] = res.bq.bta[:, :, 0]
    F["bTAr"] = res.bq.bta[:, :, 1]
    F["bTBf"] = res.bq.btb[:, :, 0]
    F["bTBr"] = res.bq.btb[:, :, 1]

    tiers = (("cDP1", fq.cdp1), ("cDP12", fq.cdp12), ("cDP2", fq.cdp2),
             ("cDP3", fq.cdp3), ("cDP21", fq.cdp21), ("cDPM", fq.cdpM),
             ("cDPm", fq.cdpm), ("cDPD", fq.cdpD))
    for tier, arr in tiers:
        F[tier + "f"] = arr[:, :, 0]
        F[tier + "r"] = arr[:, :, 1]
    for nm, arr in fq.c2info.items():
        F[nm] = arr
    F["dDP1"] = fq.ddp1
    F["dDP2"] = fq.ddp2

    for nm in info.names:
        F[nm] = getattr(info, nm)

    # The ~45 capital type-sum planes (ADPff, A1BQf, CDP1b_l, ...) are
    # derived INSIDE the jitted model (calling._derive_capitals) and come
    # back as model outputs at candidate rows -- every host consumer of a
    # capital reads it at an emitted-record row.  Only the planes needed
    # DENSELY on the host stay here: BDP feeds the candidate gate, CDP1 /
    # CDP1d feed the MGVCF emitter (aux_records) at every position.
    F["BDP"] = sum_by_symboltype(res.bq.bdp.sum(axis=2))
    F["CDP1"] = sum_by_symboltype(fq.cdp1.sum(axis=2))
    # padded-deletion-allele depth (fill_symboltype_nn_fmt quirk: the
    # reference passes strand 0 twice, main.hpp:3775-3786, so the emitted
    # pair is this value printed twice; BDPd/CDP2d are never filled by the
    # reference and print their {{0,0}} defaults)
    F["CDP1d"] = nn_broadcast(fq.cdp1[:, :, 0])

    F["bIAQb"] = res.bq.vq_bIAQ
    F["bIADb"] = res.bq.vq_bIAD
    F["bIDQb"] = res.bq.vq_bIDQ
    F["cIAQf"] = fq.vq_cIAQ[:, :, 0]
    F["cIADf"] = fq.vq_cIAD[:, :, 0]
    F["cIDQf"] = fq.vq_cIDQ[:, :, 0]
    F["cIAQr"] = fq.vq_cIAQ[:, :, 1]
    F["cIADr"] = fq.vq_cIAD[:, :, 1]
    F["cIDQr"] = fq.vq_cIDQ[:, :, 1]

    prep = res.bq.prep
    F["APDP"] = np.stack([
        prep.a_dp, prep.a_near_ins_dp, prep.a_near_del_dp,
        prep.a_near_RTR_ins_dp, prep.a_near_RTR_del_dp, prep.a_pcr_dp,
        prep.a_snv_dp, prep.a_dnv_dp, prep.a_highBQ_dp,
        prep.a_near_pcr_clip_dp, prep.a_near_long_clip_dp, prep.a_umi_dp],
        axis=1)
    F["APXM"] = np.stack([
        prep.a_XM1500, prep.a_GO1500, prep.a_qlen, prep.a_GAPLEN,
        prep.a_near_ins_pow2len, prep.a_near_del_pow2len,
        prep.a_near_ins_inv100len, prep.a_near_del_inv100len], axis=1)
    F["APLRID"] = np.stack([
        prep.a_near_ins_l_pow2len, prep.a_near_ins_r_pow2len,
        prep.a_near_del_l_pow2len, prep.a_near_del_r_pow2len], axis=1)
    F["APLRI"] = np.stack([prep.a_LI, prep.a_LIDP, prep.a_RI, prep.a_RIDP],
                          axis=1)
    F["APLRP"] = np.stack([prep.a_l_dist_sum, prep.a_r_dist_sum,
                           prep.a_inslen_sum, prep.a_dellen_sum], axis=1)

    # repeat-track context at +-indel_adj_tracklen_dist and +-3 (DPv/qual use
    # rtr at distance 3, append_vcf_record at distance 6)
    tr = res.tracks
    n_tr = len(tr.tracklen)
    for dist, tag in ((3, "3"), (cfg.indel_adj_tracklen_dist, "6")):
        i1 = np.maximum(np.arange(P), dist) - dist
        i2 = np.minimum(np.arange(P) + dist, n_tr - 1)
        F["rtr1_tracklen_" + tag] = tr.tracklen[i1]
        F["rtr1_unitlen_" + tag] = tr.unitlen[i1]
        F["rtr1_begpos_" + tag] = tr.begpos[i1]
        F["rtr2_tracklen_" + tag] = tr.tracklen[i2]
        F["rtr2_unitlen_" + tag] = tr.unitlen[i2]
        F["rtr2_begpos_" + tag] = tr.begpos[i2]
        F["rtr2_anyTR_tracklen_" + tag] = tr.anyTR_tracklen[i2]

    # per-position STR context of the emission loop (indelpos_to_context)
    F["ctx_repeatnum"] = tr.ctx_repeatnum
    F["ctx_unitlen"] = tr.ctx_unitlen

    # ---- per-allele exact-indel majority (bDPa / cDP0a / gapSa) and the
    # per-strand gap FORMAT tables
    (F["bDPa"], F["cDP0a"], F["gapLen"], F["gapSa"], F["gapTab"],
     F["gapMaj"]) = _indel_majority_arrays(res, P, F["ref_syms"])

    # inputs of the in-model fill_symbol_VQ_fmts (calling._vq_fmts_traced)
    F["bMQ_raw"] = res.bq.vq_bMQ
    F["minABQ_snv_p"] = np.full(P, minABQ_snv, dtype=np.int64)
    F["minABQ_indel_p"] = np.full(P, minABQ_indel, dtype=np.int64)
    # homopolymer minABQ reduction (main.cpp:623-626, 909-910, 927):
    # computed HOST-side per region so it sees the region's own reference
    # context -- inside the jitted model, candidate rows from different
    # regions are packed adjacently and row-neighbor logic would read
    # another region's bases (output would depend on request packing).
    # Out-of-window neighbors are BASE_NN in the reference: sentinels
    # -1/-2 can never match a real base
    c = np.asarray(res.ref_syms, dtype=np.int64)
    rp = np.concatenate([np.full(2, -1, np.int64), c,
                         np.full(2, -2, np.int64)])
    hp1 = (rp[1:-3] == c) & (rp[3:-1] == c)
    hp2 = (rp[:-4] == c) & (rp[4:] == c)
    F["hp_red"] = np.where(hp1 & hp2, 20,
                           np.where(hp1, 10, 0)).astype(np.int64)
    return F


def _indel_majority_arrays(res, P, ref_syms):
    """Per-(pos,sym): majority exact-indel allele depths/length, plus the
    full per-strand gap FORMAT tables.

    For non-indel symbols: bDPa = bDP, cDP0a = max(cDP1,cDP12) summed over
    strands (the "cdepth" of main.cpp:812-816); gapLen = 0.
    For indel symbols: the majority exact allele per indel_get_majority
    (main.hpp:5406-5455): per-string (bAD, cAD) summed over strands,
    strings with bAD >= (max_bAD+3)/4 kept, ranked by bAD^2 * len(seq)
    descending; the top entry fills bDPa/cDP0a/gapLen/gapSa.

    gap_tab[(pos,sym)] = (gapNf, gapNr, seqs, bADs, cADs, c2ADs, c2dADs):
    the fill_by_indel_info tables (instcode.hpp:12-90), strand 0 entries
    followed by strand 1, each strand sorted by
    (cAD, bAD, c2AD, c2dAD, seq) descending and emitted only when that
    strand has FRAG_bDP > 0 (main.cpp:855-864).
    """
    bdp = res.bq.bdp.sum(axis=2)
    cdepth = (np.maximum(res.fq.cdp1[:, :, 0], res.fq.cdp12[:, :, 0])
              + np.maximum(res.fq.cdp1[:, :, 1], res.fq.cdp12[:, :, 1]))
    bDPa = bdp.copy()
    cDP0a = cdepth.copy()
    gapLen = np.zeros((P, NS), dtype=np.int64)
    gapSa = {}
    gap_tab = {}
    gap_maj = {}
    refbytes = b"ACGTN"
    # frag-level exact counts give bAD per strand; fam-level give the
    # cAD / c2AD / c2dAD per-strand sextuple
    for (pos, sym), d in res.bq.frag_indel.items():
        camap = res.fq.fam_indel.get((pos, sym), {})

        def seq_of(key):
            if isinstance(key, bytes):
                return key
            if isinstance(key, str):
                return key.encode()
            # deletion: length -> deleted reference bases at pos
            dl = int(key)
            return bytes(refbytes[min(int(c), 4)]
                         for c in ref_syms[pos:pos + dl])

        # per-strand sorted tables (fill_by_indel_info)
        nf = nr = 0
        seqs, bads, cads, c2ads, c2dads = [], [], [], [], []
        for strand in (0, 1):
            if res.bq.bdp[pos, sym, strand] <= 0:
                continue
            rows = []
            for key, bcnt in d.items():
                if isinstance(key, tuple) or bcnt[strand] <= 0:
                    continue
                fam6 = camap.get(key, (0, 0, 0, 0, 0, 0))
                rows.append((fam6[strand], bcnt[strand], fam6[2 + strand],
                             fam6[4 + strand], seq_of(key)))
            rows.sort(reverse=True)
            if strand == 0:
                nf = len(rows)
            else:
                nr = len(rows)
            for cad, bad, c2ad, c2dad, seq in rows:
                seqs.append(seq)
                bads.append(bad)
                cads.append(cad)
                c2ads.append(c2ad)
                c2dads.append(c2dad)
        if seqs:
            gap_tab[(pos, sym)] = (nf, nr, seqs, bads, cads, c2ads, c2dads)

        # indel_get_majority over the emitted table entries
        agg = {}
        for i, seq in enumerate(seqs):
            a = agg.setdefault(seq, [0, 0])
            a[0] += bads[i]
            a[1] += cads[i]
        if not agg:
            continue
        max_bad = max(a[0] for a in agg.values())
        cand = [((a[0] * a[0]) * len(seq), a[0], a[1], seq)
                for seq, a in agg.items() if a[0] >= (max_bad + 3) // 4]
        cand.sort(key=lambda t: (t[0], t[3]), reverse=True)
        _, bad, cad, key = cand[0]
        bDPa[pos, sym] = bad
        cDP0a[pos, sym] = cad
        gapLen[pos, sym] = len(key)
        gapSa[(pos, sym)] = key
        if len(cand) > 1:   # extra qualifying exact alleles -> own records
            gap_maj[(pos, sym)] = [(b, c, sq) for _, b, c, sq in cand]
    return bDPa, cDP0a, gapLen, gapSa, gap_tab, gap_maj


# fill_symbol_VQ_fmts moved into the jitted model
# (calling._vq_fmts_traced); tdiv stays here for record-level host joins.
