"""Core statistical kernels of the "universality" quality model.

Pure, shape-polymorphic jnp functions designed to be vmapped/jitted over
[positions, symbols] tensors — the VPU-bound inner loop of the caller.

Behavioral references (formulas, not code):
  - Phred/nat/frac conversions:        /root/reference/common.hpp:80-88,
                                       /root/reference/main_conversion.hpp:875-898
  - binomial log-likelihood ratio:     /root/reference/main_conversion.hpp:222-254
  - dp4_to_pcFA (Bayes-factor bias):   /root/reference/main_conversion.hpp:798-849
  - IID max-quality bucket scan:       /root/reference/main_conversion.hpp:920-974
  - softplus floor (calc_non_negative):/root/reference/main_conversion.hpp:163-171

All kernels compute in the dtype of their (floating) inputs; tests run them in
float64 on CPU to check golden values, the GPU path runs float32.
"""

import math

import jax
import jax.numpy as jnp

DBL_EPSILON = 2.220446049250313e-16
INV_LOG10 = 10.0 / math.log(10.0)   # nat -> phred multiplier
LOG10_DIV = math.log(10.0) / 10.0   # phred -> nat multiplier
NUM_BUCKETS = 16
SQR_QUAL_DIV = 32


# ---------------------------------------------------------------------------
# scalar conversions


def phred2nat(x):
    return LOG10_DIV * x


def nat2phred(x):
    return INV_LOG10 * x


def frac2phred(x):
    return -INV_LOG10 * jnp.log(x)


def phred2frac(x):
    return jnp.power(10.0, -x / 10.0)


def numstates2phred(x):
    return INV_LOG10 * jnp.log(x)


def phred2numstates(x):
    return jnp.power(10.0, x / 10.0)


def numstates2deciphred(x):
    """Rounds to nearest int in deciphred (common.hpp:88)."""
    return jnp.round((100.0 / math.log(10.0)) * jnp.log(x)).astype(jnp.int32)


def phred2prob(phred):
    return jnp.power(10.0, -phred / 10.0)


def prob2phred(prob):
    """floor(-10*log(p)/log(10)) as int (main_conversion.hpp:890-893).

    Computed with numpy float64 so the floor at representation boundaries
    (libm gives 89.999... for p=1e-9, i.e. 89) bit-matches the compiled
    reference — verified by the tests/test_math_oracle.py sweep.
    """
    import numpy as _np
    return _np.floor(-INV_LOG10 * _np.log(_np.asarray(prob, dtype=_np.float64))).astype(_np.int64)


def prob2realphred(prob):
    return -INV_LOG10 * jnp.log(prob)


def prob2odds(p):
    return p / (1.0 - p)


def odds2prob(odds):
    return odds / (odds + 1.0)


def logit(p):
    return jnp.log(prob2odds(p))


def logit2(a, b):
    """Log-odds of a vs b with epsilon guard (main_conversion.hpp:216-219)."""
    return logit((a + DBL_EPSILON) / (a + b + 2.0 * DBL_EPSILON))


def calc_non_negative(v, base=10.0 ** 0.1, thres=10.0):
    """Softplus-in-base floor: smooth max(v, 0) below `thres`, identity above
    (main_conversion.hpp:163-171)."""
    soft = jnp.log1p(jnp.power(base, v)) / math.log(base)
    return jnp.where(v < thres, soft, v)


def non_neg_minus(a, b):
    """max(a - b, 0) keeping integer dtype (common.hpp:195-200)."""
    return jnp.where(a > b, a - b, jnp.zeros_like(a - b))


def mathsquare(x):
    return x * x


def mathcube(x):
    return x * x * x


# ---------------------------------------------------------------------------
# binomial log-likelihood-ratio quality


def binom_10log10_likeratio(prob, a, b, bidirectional=False,
                            set_max_prob_to_one=False):
    """Phred-scaled binomial LR of observing (a successes, b failures) vs the
    null success-rate `prob` (main_conversion.hpp:222-237).

    One-directional form returns 0 unless a exceeds its expectation.
    Always >= 0. Static flags select the template variant.
    """
    prob = jnp.asarray(prob)
    if set_max_prob_to_one:
        prob = jnp.minimum(1.0, prob)
    prob = (prob + DBL_EPSILON) / (1.0 + 2.0 * DBL_EPSILON)
    a = a + DBL_EPSILON
    b = b + DBL_EPSILON
    expected_a = prob * (a + b)
    expected_b = (1.0 - prob) * (a + b)
    lr = INV_LOG10 * (a * jnp.log(a / expected_a) + b * jnp.log(b / expected_b))
    if bidirectional:
        return lr
    return jnp.where(a > expected_a, lr, 0.0)


# ---------------------------------------------------------------------------
# dp4_to_pcFA: the Bayes-factor bias-reduction primitive


def dp4_to_pcFA(overseq_frac, aADpass, aADfail, aDPpass, aDPfail,
                pl_exponent=3.0, n_nats=math.log(500 + 1),
                aADavgKeyVal=-1.0, aDPavgKeyVal=-1.0,
                priorAD=0.5, priorDP=1.0,
                bidirectional=True, overseq_frac_disabled=False):
    """Bias-corrected allele fraction from a pass/fail depth 4-tuple
    (main_conversion.hpp:798-849).

    Given allele depth and total depth split into a bias-pass and a bias-fail
    stratum, decides via an information-gain (Bayes-factor) test whether the
    pass/fail split carries more than `n_nats` of evidence of bias; if so the
    allele fraction is shrunk toward the pass stratum with a power-law
    exponent. Returns (pcFA, nobiasFA).

    `bidirectional`/`overseq_frac_disabled` are static (template) flags.
    Vectorizes over leading dims of the numeric arguments.
    """
    if not overseq_frac_disabled:
        aDPfail = aDPfail * overseq_frac
        aDPpass = aDPpass * overseq_frac
        aADfail = aADfail * overseq_frac
        aADpass = aADpass * overseq_frac
    aDPfail = aDPfail + priorDP
    aDPpass = aDPpass + priorDP
    aADfail = aADfail + priorAD
    aADpass = aADpass + priorAD
    nobiasFA = (aADfail + aADpass) / (aDPfail + aDPpass)
    pass_ge_fail = (aADpass / aDPpass) >= (aADfail / aDPfail)

    if bidirectional:
        # orient so that "fail" is the better stratum, then run the test
        dp_lo = jnp.where(pass_ge_fail, aDPfail, aDPpass)
        dp_hi = jnp.where(pass_ge_fail, aDPpass, aDPfail)
        ad_lo = jnp.where(pass_ge_fail, aADfail, aADpass)
        ad_hi = jnp.where(pass_ge_fail, aADpass, aADfail)
        aDPpass, aDPfail = dp_lo, dp_hi
        aADpass, aADfail = ad_lo, ad_hi

    aBDfail = aDPfail * 2 - aADfail
    aBDpass = aDPpass * 2 - aADpass
    aADpassfrac = aADpass / (aADpass + aADfail)
    aBDpassfrac = aBDpass / (aBDpass + aBDfail)
    if not bidirectional:
        use_interp = jnp.logical_and(jnp.asarray(aADavgKeyVal) >= 0,
                                     jnp.asarray(aDPavgKeyVal) >= 0)
        interp = aADavgKeyVal / (aADavgKeyVal + aDPavgKeyVal * 0.9)
        aADpassfrac = jnp.where(use_interp, interp, aADpassfrac)
        aBDpassfrac = jnp.where(use_interp, 1.0 - aADpassfrac, aBDpassfrac)

    infogain = aADfail * jnp.log((1.0 - aADpassfrac) / (1.0 - aBDpassfrac))
    if bidirectional:
        infogain = infogain + aADpass * jnp.log(aADpassfrac / aBDpassfrac)

    fail_fa = aADfail / aDPfail
    pass_fa = aADpass / aDPpass
    shrunk = jnp.maximum(pass_fa, fail_fa * jnp.exp((n_nats - infogain) / pl_exponent))
    pcFA = jnp.where(infogain <= n_nats, fail_fa, shrunk)
    if not bidirectional:
        # early return branch: no bias detected in this direction at all
        pcFA = jnp.where(pass_ge_fail, pass_fa, pcFA)
    return pcFA, nobiasFA


# ---------------------------------------------------------------------------
# IID max-quality over BQ bucket histogram


def infer_max_qual_assuming_independence(max_qual, dec_qual, qual_distr, totDP):
    """Scan a 16-bucket descending-BQ histogram maximizing AD*(BQ - expBQ)
    (main_conversion.hpp:943-974).

    qual_distr[..., 16]: bucket k holds the count of bases with quality
    max_qual - dec_qual*k. Returns (maxvqual, argmaxAD, argmaxBQ) int32
    tensors, replicating the reference's first-strict-maximum tie-break and
    int truncation.
    """
    qual_distr = jnp.asarray(qual_distr)
    idx = jnp.arange(NUM_BUCKETS, dtype=jnp.int32)
    n_eval = jnp.minimum(NUM_BUCKETS, max_qual // dec_qual)
    curr_ad = jnp.cumsum(qual_distr, axis=-1)
    curr_bq = max_qual - dec_qual * idx
    tot = jnp.asarray(totDP)[..., None].astype(jnp.float64
              if jax.config.jax_enable_x64 else jnp.float32)
    exp_bq = INV_LOG10 * jnp.log(tot / curr_ad.astype(tot.dtype) + DBL_EPSILON)
    vqual = (curr_ad.astype(tot.dtype) * (curr_bq - exp_bq)).astype(jnp.int32)
    valid = (qual_distr > 0) & (idx < n_eval)
    vqual = jnp.where(valid, vqual, jnp.iinfo(jnp.int32).min)
    best = jnp.argmax(vqual, axis=-1)
    maxv = jnp.take_along_axis(vqual, best[..., None], axis=-1)[..., 0]
    found = maxv > 0
    maxvqual = jnp.where(found, maxv, 0)
    argmaxAD = jnp.where(
        found, jnp.take_along_axis(curr_ad, best[..., None], axis=-1)[..., 0], 0)
    argmaxBQ = jnp.where(found, max_qual - dec_qual * best.astype(jnp.int32), 0)
    return maxvqual, argmaxAD.astype(jnp.int32), argmaxBQ.astype(jnp.int32)


# ---------------------------------------------------------------------------
# misc model kernels


_PROTON_OPLEN2PHRED = tuple(
    round(INV_LOG10 * math.log(i ** 3)) if i > 0 else 0 for i in range(13))


def proton_cigarlen2phred(cigarlen):
    """IonTorrent homopolymer indel-length phred table
    (main_conversion.hpp:922-941): round(10*log10(len^3)), capped at len 12."""
    table = jnp.asarray(_PROTON_OPLEN2PHRED, dtype=jnp.int32)
    return table[jnp.minimum(cigarlen, 12)]


def calc_indel_weight(indelsize, borderlen):
    """1M * indelsize^3 / max(borderlen, 8)^3, int64
    (main_conversion.hpp:608-612)."""
    indelsize = jnp.asarray(indelsize, dtype=jnp.int64
                            if jax.config.jax_enable_x64 else jnp.int32)
    b = jnp.maximum(jnp.asarray(borderlen), 8).astype(indelsize.dtype)
    return (1024 * 1024) * mathcube(indelsize) // mathcube(b)
