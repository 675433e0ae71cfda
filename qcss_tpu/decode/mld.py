"""Exact maximum-likelihood decoding by matmul-batched coset enumeration.

Every practical decoder in this package approximates: LUT and MWPM pick
a MINIMUM-WEIGHT representative, union-find approximates that, BP
approximates marginals on a loopy graph. The maximum-likelihood (ML)
decision — the information-theoretic optimum any decoder is measured
against — sums the probability of EVERY error consistent with the
syndrome, per logical class, and picks the heaviest class:

    score(c) = sum_{g in stabilizer group} Pr[e0 + L_c + g]

(e0 any error with syndrome s; for X-error decoding the degeneracy
group is the X-STABILIZERS — the rowspace of h_x — and L_c ranges over
the 2^k X-logical combinations). Min-weight decoding ignores
degeneracy: a class with many medium-weight representatives can
outweigh the class holding the single lightest one, so ML is strictly
better on degenerate codes, and the measured ML-vs-LUT/UF gap says how
much room a better approximate decoder has.

The device shape: for independent priors, log Pr[e] = const + e . llr
with llr_j = log(p_j / (1 - p_j)), and

    (eL xor g) . llr  =  eL . llr  +  g . llr  -  2 * (eL * llr) . g

so ONE [B, n] @ [n, G] matmul per logical class hands every coset
log-probability to the whole batch at once, followed by a logsumexp
over the coset axis — one large, static, batched matmul (float32 at
``Precision.HIGHEST``: lower-precision products flip near-tie
argmaxes against the f64 brute force). The coset axis is chunked (2^16 per step) so r ~ 20
stabilizer generators stay in memory; per-qubit or per-shot priors
ride the same matmul for free, so soft-input EXACT decoding comes out
of the same kernel.

The reference has no ML machinery at all — its only decoder is the
min-weight syndrome LUT inside the emitted program (reference:
css_code.py:649-685).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from qcss_tpu.ops import gf2

__all__ = ["MLDecoder", "mld_logical_error_rate"]

_CHUNK = 1 << 16


def _span_table(rows: np.ndarray) -> np.ndarray:
    """[2^r, n] uint8 table of every GF(2) combination of `rows`."""
    rows = np.asarray(rows, np.uint8) & 1
    r, n = rows.shape
    if r > 22:
        raise ValueError(
            f"{r} stabilizer generators -> 2^{r} cosets; ML enumeration "
            "is exponential — use BP/UF/MWPM at this scale")
    idx = np.arange(1 << r, dtype=np.uint32)
    bits = ((idx[:, None] >> np.arange(r)[None, :]) & 1).astype(np.uint8)
    return (bits @ rows) & 1


class MLDecoder:
    """Exact ML decoder for one CSS error sector.

    h:        [r_h, n] checks measuring the decoded errors (X errors:
              the Z-type checks, ``code.parity_check_c2``).
    stab:     [r_s, n] stabilizer generators of the SAME type as the
              decoded errors (X errors: ``code.parity_check_c1``) —
              the degeneracy group the class sums enumerate.
    logicals_err: [k, n] logical representatives of the decoded error
              type (X errors: ``code.x_operator_matrix()``).
    logicals_obs: [k, n] dual logicals defining the scored observables
              (X errors: ``code.z_operator_matrix()``).

    ``decode_flips(syndromes, llr=None)`` returns the ML estimate of
    each observable's flip, [B, k] uint8 — the same contract as the
    LUT/UF/BP observable outputs. ``llr`` overrides the uniform prior
    with per-qubit ``[n]`` or per-shot ``[B, n]`` log-odds.
    """

    def __init__(self, h, stab, logicals_err, logicals_obs, *,
                 p: float = 1e-2):
        self.h = np.asarray(h, np.uint8) & 1
        self.n = self.h.shape[1]
        self.lerr = np.atleast_2d(np.asarray(logicals_err, np.uint8) & 1)
        self.lobs = np.atleast_2d(np.asarray(logicals_obs, np.uint8) & 1)
        self.k = self.lerr.shape[0]
        if self.k > 6:
            raise ValueError("2^k class enumeration; k <= 6 supported")
        self.p = float(p)
        stab = np.atleast_2d(np.asarray(stab, np.uint8) & 1)
        self._coset = _span_table(stab[gf2.row_basis(stab)])
        # syndrome -> representative: reduce [h | I]; rows whose pivot
        # stays in the h block give rref_h = T @ h, so a consistent
        # syndrome maps to s_rref = T s and e0 = sum_i s_rref_i * unit
        # vector on rref pivot column i satisfies h e0 = s.
        aug = np.concatenate(
            [self.h, np.eye(self.h.shape[0], dtype=np.uint8)], axis=1)
        rref_aug = gf2.rref(aug)
        piv, t_rows = [], []
        for row in rref_aug:
            nz = np.nonzero(row[: self.n])[0]
            if nz.size:
                piv.append(int(nz[0]))
                t_rows.append(row[self.n:])
        self._piv = np.asarray(piv, np.int32)
        self._t = np.asarray(t_rows, np.uint8)
        self._fn = None

    @classmethod
    def for_code(cls, code, *, sector: str = "x_errors", p: float = 1e-2):
        """X errors (`sector='x_errors'`, checked by the Z-type checks,
        scored against Z̄) or Z errors (`'z_errors'`)."""
        if sector == "x_errors":
            return cls(code.parity_check_c2, code.parity_check_c1,
                       code.x_operator_matrix(), code.z_operator_matrix(),
                       p=p)
        if sector == "z_errors":
            return cls(code.parity_check_c1, code.parity_check_c2,
                       code.z_operator_matrix(), code.x_operator_matrix(),
                       p=p)
        raise ValueError(sector)

    def _representatives(self, syndromes: np.ndarray) -> np.ndarray:
        s = np.asarray(syndromes, np.uint8) & 1
        s_r = (s @ self._t.T) & 1
        e0 = np.zeros((s.shape[0], self.n), np.uint8)
        e0[:, self._piv] = s_r
        return e0

    def _chunks(self):
        coset_np = self._coset
        return [jnp.asarray(coset_np[i:i + _CHUNK].T, jnp.float32)
                for i in range(0, coset_np.shape[0], _CHUNK)]

    @staticmethod
    def _class_lse(eL, llr, chunks):
        """eL [B, n] uint8, llr [B, n] f32 -> [B] coset log score."""
        eLf = eL.astype(jnp.float32)
        base = jnp.sum(eLf * llr, axis=1)
        cross_in = eLf * llr
        out = jnp.full(base.shape, -jnp.inf, jnp.float32)
        hp = jax.lax.Precision.HIGHEST  # no TF32: near-tie argmaxes
        for ch in chunks:                             # static, few
            tot = (base[:, None] + jnp.matmul(llr, ch, precision=hp)
                   - 2.0 * jnp.matmul(cross_in, ch, precision=hp))
            out = jnp.logaddexp(
                out, jax.scipy.special.logsumexp(tot, axis=1))
        return out

    def _scorer(self):
        if self._fn is None:
            chunks = self._chunks()
            self._fn = jax.jit(
                lambda eL, llr: self._class_lse(eL, llr, chunks))
        return self._fn

    def device_decode_fn(self):
        """Jittable pure-device decode: (syndromes [B, r_h] uint8,
        llr [B, n] f32) -> ML observable flips [B, k] uint8. The
        representative solve, coset scoring and class selection all
        trace into the caller's program — used by the fused/sharded
        pipelines (`parallel.sharded_mld_memory`)."""
        from qcss_tpu.ops import gf2_jax

        chunks = self._chunks()
        t_j = jnp.asarray(self._t)
        piv = self._piv
        n, kk = self.n, self.k
        cls_idx = np.arange(1 << kk, dtype=np.uint32)
        cls_bits = ((cls_idx[:, None] >> np.arange(kk)[None, :]) & 1
                    ).astype(np.uint8)
        cls_vecs = jnp.asarray((cls_bits @ self.lerr) & 1)
        par_cls = jnp.asarray((cls_bits @ (self.lerr @ self.lobs.T)) & 1)
        lobs_t = jnp.asarray(self.lobs.T)

        def decode(syn, llr):
            s_r = gf2_jax.mod2_matmul(syn.astype(jnp.uint8), t_j.T)
            e0 = jnp.zeros((syn.shape[0], n), jnp.uint8)
            e0 = e0.at[:, piv].set(s_r)
            scores = jnp.stack([
                self._class_lse(e0 ^ cls_vecs[c], llr, chunks)
                for c in range(1 << kk)])
            best = jnp.argmax(scores, axis=0)
            par0 = gf2_jax.mod2_matmul(e0, lobs_t)
            return (par0 ^ par_cls[best]) & 1

        return decode

    def decode_flips(self, syndromes, llr=None, *,
                     return_scores: bool = False):
        e0 = self._representatives(syndromes)
        B = e0.shape[0]
        if llr is None:
            llr = np.full(self.n, np.log(self.p / (1 - self.p)), np.float32)
        llr = np.broadcast_to(np.asarray(llr, np.float32),
                              (B, self.n))
        llr_j = jnp.asarray(llr)
        scorer = self._scorer()
        kk = self.k
        cls_idx = np.arange(1 << kk, dtype=np.uint32)
        cls_bits = ((cls_idx[:, None] >> np.arange(kk)[None, :]) & 1
                    ).astype(np.uint8)                       # [C, k]
        cls_vecs = (cls_bits @ self.lerr) & 1                # [C, n]
        scores = jnp.stack([
            scorer(jnp.asarray(e0 ^ v[None, :]), llr_j) for v in cls_vecs
        ])                                                   # [C, B]
        best = np.asarray(jnp.argmax(scores, axis=0))        # [B]
        # observable estimate of the chosen correction e0 + L_best
        par0 = (e0 @ self.lobs.T) & 1                        # [B, k]
        par_cls = (cls_vecs @ self.lobs.T) & 1               # [C, k]
        flips = (par0 ^ par_cls[best]) & 1
        if return_scores:
            return flips.astype(np.uint8), np.asarray(scores)
        return flips.astype(np.uint8)


def mld_logical_error_rate(code, p: float, *, batch: int = 1 << 12,
                           seed: int = 0):
    """Code-capacity X-sector word failure under exact ML decoding,
    plus the min-weight LUT failure on the SAME shots — the measured
    optimality gap of the reference-style decoder (which, like the
    reference, leaves unknown syndromes uncorrected — above the unique-
    decoding weight that convention is a large part of its gap).
    Returns dict(word_fail_ml, word_fail_lut, n_shots). Measured, d=3
    rotated surface, 16k shots: 8.1% vs 20.7% at p=0.08, 21.0% vs
    32.5% at p=0.15."""
    import jax.random as jr

    from qcss_tpu.decode.lut import decode_corrections

    h = np.asarray(code.parity_check_c2, np.uint8)
    lz = np.asarray(code.z_operator_matrix(), np.uint8)
    n = code.n
    errs = np.asarray(
        (jr.uniform(jr.key(seed), (batch, n)) < p).astype(jnp.uint8))
    syn = (errs @ h.T) & 1
    true_par = (errs @ lz.T) & 1

    ml = MLDecoder.for_code(code, p=p)
    fail_ml = float(np.mean(np.any(
        ml.decode_flips(syn) != true_par, axis=1)))

    lut = code.device.lut_c2
    if lut is None:
        lut = jnp.asarray(gf2.correction_lut(h, gf2.syndrome_table(h)[1]))
    corr = np.asarray(decode_corrections(jnp.asarray(syn), lut))
    res_par = ((errs ^ corr) @ lz.T) & 1
    fail_lut = float(np.mean(np.any(res_par, axis=1)))
    return {"word_fail_ml": fail_ml, "word_fail_lut": fail_lut,
            "n_shots": batch}
