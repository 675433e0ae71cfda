"""Batched belief propagation (+ ordered statistics) ON DEVICE — the
qLDPC decoder.

The matching decoders (`decode.uf`, `decode.mwpm`) require every error
mechanism to flip at most two checks; LUT decoding (`decode.lut`) is
exponential in the check count. Neither covers modern qLDPC memories —
bivariate-bicycle and hypergraph-product codes (`codes.families.bb72`
etc.), whose weight-6 checks overlap three-fold on every qubit — where
the industry-standard decoder is BP+OSD. The reference has no analogue
(its only decoder is the emitted syndrome-table scan, reference:
css_code.py:649-685, exponential in checks and limited to k=1 codes).

Device formulation
------------------

BP is reshaped from the classic sparse message-passing loop into dense
batched tensor algebra:

* messages live in a CHECK-MAJOR padded layout ``[B, r, Dc]`` (Dc = max
  check degree, masked padding) — check updates (min/argmin/sign-parity)
  are tiny last-axis reductions;
* variable-side totals are ONE dense matmul per iteration:
  ``T = lambda + M.reshape(B, r*Dc) @ S`` with S the 0/1 slot-to-variable
  incidence — a segment-sum expressed as a matmul instead of a
  scatter-add (float32 at HIGHEST precision, so the card's TF32 does not
  round the messages);
* variable-to-check messages are one static gather ``T[:, chk_var] - M``.

The check update is normalized min-sum (factor ``alpha``) with the exact
min1/min2/argmin exclusion trick; per-shot estimates FREEZE at their
first syndrome-satisfying iteration (running further can leave it), and
the batch exits early once every shot has converged via
``lax.while_loop``. Non-converged shots fall back to host OSD-0 (ordered
statistics over the final LLRs: most-suspect columns first, one GF(2)
elimination — Panteleev & Kalachev 2021's BP+OSD in its order-0 form),
so the device handles the bulk of the batch and the host only the tail,
preserving the only-failures-cross-the-boundary inversion at operating
noise.

Works on any binary check matrix: code-capacity (H = a code's redundant
check set), phenomenological spacetime Tanner graphs
(`spacetime_tanner`), or externally built detector-error models.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

_BIG = jnp.float32(1e30)


def _osde_py(h: np.ndarray, synd: np.ndarray, soft: np.ndarray,
             osd_order: int, lam1: int, lam2: int) -> np.ndarray:
    """Order-E ordered-statistics decode, pure-numpy reference semantics
    (mirrors `native/osd_decoder.cc::qcss_osde_batch`: same stable
    column order, same pivot scan, same candidate enumeration order —
    singles over the first lam1 free columns then pairs over the first
    lam2 — and strict-< acceptance on the soft-weight score, so OSD-0
    wins ties. Soft-weight scores are accumulated in different float
    orders here (numpy dot) vs the C++ (sequential adds), so candidates
    whose scores tie to within float error can legitimately diverge;
    the contract is same enumeration/tie-break RULE and soft-weight
    agreement, not bitwise solution identity — only OSD-0 carries the
    bit-identity guarantee, per CLAUDE.md)."""
    r, n = h.shape
    out = np.zeros((synd.shape[0], n), dtype=np.uint8)
    for bi in range(synd.shape[0]):
        order = np.argsort(soft[bi], kind="stable")
        hp = h[:, order].astype(np.int8)
        aug = np.concatenate([hp, synd[bi][:, None].astype(np.int8)], axis=1)
        piv_cols: list[int] = []
        row = 0
        for c in range(n):
            nz = np.nonzero(aug[row:, c])[0]
            if nz.size == 0:
                continue
            pr = row + int(nz[0])
            if pr != row:
                aug[[row, pr]] = aug[[pr, row]]
            sel = aug[:, c].astype(bool).copy()
            sel[row] = False
            aug[sel] ^= aug[row]
            piv_cols.append(c)
            row += 1
            if row == r:
                break
        rank = len(piv_cols)
        sv = aug[:rank, n].astype(np.uint8)
        if osd_order <= 0 or rank == 0:
            e_ord = np.zeros(n, np.uint8)
            e_ord[piv_cols] = sv
            out[bi, order] = e_ord
            continue
        w_soft = np.abs(soft[bi][order])
        w_piv = w_soft[piv_cols]
        is_piv = np.zeros(n, bool)
        is_piv[piv_cols] = True
        lam_max = max(lam1, lam2)
        free_cols = np.nonzero(~is_piv)[0][:lam_max]
        col_bits = aug[:rank, free_cols].astype(np.uint8)  # [rank, F]
        best = float(w_piv @ sv)
        best_f = (-1, -1)
        cands = [(f, -1) for f in range(min(lam1, free_cols.size))]
        if osd_order >= 2:
            m2 = min(lam2, free_cols.size)
            cands += [(f1, f2) for f1 in range(m2)
                      for f2 in range(f1 + 1, m2)]
        for f1, f2 in cands:
            v = sv ^ col_bits[:, f1]
            w = float(w_soft[free_cols[f1]])
            if f2 >= 0:
                v = v ^ col_bits[:, f2]
                w += float(w_soft[free_cols[f2]])
            w += float(w_piv @ v)
            if w < best:
                best, best_f = w, (f1, f2)
        v = sv.copy()
        e_ord = np.zeros(n, np.uint8)
        for f in best_f:
            if f >= 0:
                v ^= col_bits[:, f]
                e_ord[free_cols[f]] = 1
        e_ord[piv_cols] = v
        out[bi, order] = e_ord
    return out


def _check_major_layout(h: np.ndarray):
    """[r, n] 0/1 matrix -> (chk_var [r, Dc] int32, mask [r, Dc] bool)."""
    r, n = h.shape
    deg = h.sum(axis=1).astype(np.int64)
    dc = int(deg.max())
    chk_var = np.zeros((r, dc), dtype=np.int32)
    mask = np.zeros((r, dc), dtype=bool)
    for c in range(r):
        sup = np.nonzero(h[c])[0]
        chk_var[c, : sup.size] = sup
        mask[c, : sup.size] = True
    return chk_var, mask


@partial(jax.jit, static_argnames=("C",))
def _osd_eliminate_device(h_t, synd, soft, C: int):
    """Shared elimination core of the device OSD kernels; see
    `_osd0_device_kernel`. Returns (order, aug, sbit, prs, hass,
    e_sorted): the stable-sorted column order, the fully reduced packed
    block, the reduced syndrome lane, per-sorted-column pivot rows and
    their existence mask, and the OSD-0 solution in sorted
    coordinates."""
    return _osd0_device_kernel(h_t, synd, soft, C, _internal=True)


def _osd0_device_kernel(h_t, synd, soft, C: int, _internal: bool = False):
    """Batched OSD-0 elimination ON DEVICE; bit-identical to
    `BPDecoder._osd0` (see its docstring for the algorithm).

    Why bit-identity is free: the pivot COLUMN set is the greedy
    independent set in stable-sorted order — a property of the matrix and
    the order alone, not of which row is chosen as pivot — and the OSD-0
    solution (supported on the pivot columns, which are linearly
    independent) is unique. So this kernel may keep rows in place
    (no per-shot row swaps, which would be per-shot scatters)
    and still produce exactly the host solution.

    Layout: only the first C stable-sorted columns are ever READ by the
    elimination (later columns can't become pivots within the scan and
    the solve needs only the syndrome), so the working set is a packed
    [B, r, ceil(C/32)] uint32 block plus a separate [B, r] syndrome
    lane — ~7x less traffic than packing all n columns at bb144 scale.
    Pivot rows travel by masked reduction (one-hot select), never by
    per-shot dynamic gather (CLAUDE.md device-decoder rules). Shots whose
    rank is not reached within C columns fail the final syndrome check
    and are reported for host fallback.
    """
    n, r = h_t.shape
    B = synd.shape[0]
    W = (C + 31) // 32
    order = jnp.argsort(soft, axis=1, stable=True)[:, :C]  # [B, C]
    order_pad = jnp.pad(order, ((0, 0), (0, W * 32 - C)))
    shifts = jnp.arange(32, dtype=jnp.uint32)

    def pack_word(_, w):
        idx = jax.lax.dynamic_slice(order_pad, (0, w * 32), (B, 32))
        blk = jnp.take(h_t, idx.reshape(-1), axis=0).reshape(B, 32, r)
        valid = (w * 32 + jnp.arange(32)) < C
        bits = jnp.where(valid[None, :, None], blk, 0).astype(jnp.uint32)
        word = jnp.sum(bits << shifts[None, :, None], axis=1,
                       dtype=jnp.uint32)
        return None, word  # [B, r]

    _, words = jax.lax.scan(pack_word, None, jnp.arange(W))
    aug = jnp.transpose(words, (1, 2, 0))  # [B, r, W] uint32
    sbit = synd.astype(jnp.int32)
    marked = jnp.zeros((B, r), bool)
    rows = jnp.arange(r, dtype=jnp.int32)

    # Blocked delayed-update elimination (the GF(2) analogue of blocked
    # LU): per 32-column word block, PHASE 1 runs the inherently
    # sequential pivot scan on the NARROW state only — the block's own
    # column word, the syndrome lane, and a per-row uint32 coefficient
    # mask recording which of the block's original pivot rows each row
    # has absorbed (row_i = S_i ⊕ ⊕_j coef[i,j]·P_j; an elimination by
    # pivot j folds as coef[i] ^= coef[pr_j] ^ (1<<j)) — then PHASE 2
    # replays all 32 eliminations onto the wide matrix as ONE fused
    # XOR-select expression. Sequential full-width updates (the naive
    # form) move 32x this traffic in 32x the sequential steps. The
    # outer block loop is a lax.scan over fixed shapes (processed words
    # keep receiving harmless updates — they are never read again): an
    # unrolled shrinking-suffix variant halves the traffic but unrolls
    # the block loop, and XLA compile time per shape grows with it.

    def p1_step(carry, j):
        wd, sbit, marked, coef = carry
        colbit = ((wd >> j) & 1).astype(bool)
        active = colbit & ~marked
        has = jnp.any(active, axis=1)
        pr = jnp.argmax(active, axis=1).astype(jnp.int32)  # first True
        is_pr = rows[None, :] == pr[:, None]
        # pivot row's narrow state by masked reduction (no gathers)
        pwd = jnp.sum(jnp.where(is_pr, wd, 0), axis=1)
        psyn = jnp.sum(jnp.where(is_pr, sbit, 0), axis=1)
        pcoef = jnp.sum(jnp.where(is_pr, coef, 0), axis=1)
        elim = colbit & ~is_pr & has[:, None]
        wd = jnp.where(elim, wd ^ pwd[:, None], wd)
        sbit = jnp.where(elim, sbit ^ psyn[:, None], sbit)
        coef = jnp.where(
            elim, coef ^ pcoef[:, None] ^ (jnp.uint32(1) << j), coef)
        marked = marked | (is_pr & has[:, None])
        return (wd, sbit, marked, coef), (pr, has)

    def block_step(carry, w):
        aug, sbit, marked = carry
        blockword = jax.lax.dynamic_index_in_dim(aug, w, axis=2,
                                                 keepdims=False)
        coef0 = jnp.zeros((B, r), jnp.uint32)
        (_, sbit, marked, coef), (pr_b, has_b) = jax.lax.scan(
            p1_step, (blockword, sbit, marked, coef0),
            jnp.arange(32, dtype=jnp.uint32))
        # original pivot rows of this block: [B, 32, W]
        p_rows = jnp.take_along_axis(
            aug, pr_b.T[:, :, None].astype(jnp.int32), axis=1)
        p_rows = jnp.where(has_b.T[:, :, None], p_rows, 0)
        upd = jnp.zeros_like(aug)
        for j in range(32):
            sel = ((coef >> jnp.uint32(j)) & 1).astype(bool)
            upd = upd ^ jnp.where(sel[:, :, None], p_rows[:, j][:, None, :],
                                  0)
        return (aug ^ upd, sbit, marked), (pr_b, has_b)

    (aug, sbit, marked), (pr_blocks, has_blocks) = jax.lax.scan(
        block_step, (aug, sbit, marked), jnp.arange(W, dtype=jnp.int32))
    prs = pr_blocks.reshape(W * 32, B)[:C]   # [C, B]
    hass = has_blocks.reshape(W * 32, B)[:C]
    # e in sorted coordinates: final syndrome bit of each pivot row
    vals = jnp.take_along_axis(sbit, prs.T, axis=1)  # [B, C]
    e_sorted = jnp.where(hass.T, vals, 0).astype(jnp.uint8)
    if _internal:
        return order, aug, sbit, prs, hass, e_sorted
    e = jnp.zeros((B, n), jnp.uint8)
    e = e.at[jnp.arange(B)[:, None], order].set(e_sorted)
    chk = (e.astype(jnp.int32) @ h_t.astype(jnp.int32)) & 1
    ok = jnp.all(chk == synd.astype(jnp.int32), axis=1)
    return e, ok


def _osde_device_kernel(h_t, synd, soft, C: int, osd_order: int,
                        lam1: int, lam2: int):
    """Batched order-E OSD combination sweep ON DEVICE (round 5 — the
    VERDICT-4 port): the blocked delayed-update elimination
    (`_osd0_device_kernel`) followed by the candidate sweep of
    `_osde_py` — singles over the first lam1 free columns, pairs over
    the first lam2 (osd_order >= 2), least soft weight wins with
    STRICT-< acceptance (OSD-0 keeps ties) and first-candidate
    tie-break (argmin's first-minimum = the host loop's
    update-on-strict-improvement order).

    Same enumeration order and tie-break RULE as the host/C++ sweep;
    per the module contract (see `_osde_py`), float summation order
    differs, so near-tie candidates can legitimately diverge — only
    OSD-0 carries bitwise identity.

    The candidate re-solves live entirely in the ALREADY-REDUCED block:
    flipping free column f changes the pivot-column solution by that
    column's reduced bits at the pivot rows — one one-hot word
    contraction + one take_along_axis per candidate column, no second
    elimination. All candidate columns lie within the first C sorted
    columns whenever max(lam1, lam2) <= C - rank (C = r + 256 in the
    caller, so any lam <= 256 matches the host's candidate set
    exactly)."""
    n, r = h_t.shape
    B = synd.shape[0]
    order, aug, sbit, prs, hass, e_sorted = _osd_eliminate_device(
        h_t, synd, soft, C)
    piv = hass.T.astype(jnp.float32)                       # [B, C]
    w_sorted = jnp.abs(jnp.take_along_axis(soft, order, axis=1)
                       ).astype(jnp.float32)               # [B, C]
    w_piv = w_sorted * piv
    e_f = e_sorted.astype(jnp.float32)
    base = jnp.sum(w_piv * e_f, axis=1)                    # [B]

    L = max(lam1, lam2 if osd_order >= 2 else 0)
    freem = (1.0 - piv)
    ranks = jnp.cumsum(freem, axis=1)                      # 1-based
    cols = jnp.arange(C, dtype=jnp.int32)
    words = jnp.arange((C + 31) // 32, dtype=jnp.int32)

    # candidate free columns: indices, existence, weights -----------------
    sel_all = ((freem > 0)[:, None, :]
               & (ranks[:, None, :] == (1.0 + jnp.arange(L, dtype=
                                        jnp.float32))[None, :, None]))
    ex_all = jnp.any(sel_all, axis=2)                      # [B, L]
    fc_all = jnp.sum(jnp.where(sel_all, cols[None, None, :], 0),
                     axis=2).astype(jnp.int32)             # [B, L]
    wf_all = jnp.sum(jnp.where(sel_all, w_sorted[:, None, :], 0.0),
                     axis=2)                               # [B, L]
    # extract the L candidate columns' bits in ONE batched contraction:
    # one-hot word select as two f32 einsums (uint32 words split into
    # 16-bit halves — exact in f32, and HIGHEST keeps the products out of
    # TF32, which is exact only up to 2^11; the per-candidate one-hot
    # loop form costs L full passes over [B, r, W])
    w_idx = fc_all // 32                                   # [B, L]
    b_idx = (fc_all % 32).astype(jnp.uint32)
    onew = (words[None, None, :] == w_idx[:, :, None]).astype(jnp.float32)
    lo = (aug & jnp.uint32(0xFFFF)).astype(jnp.float32)
    hi = (aug >> jnp.uint32(16)).astype(jnp.float32)
    hp = jax.lax.Precision.HIGHEST
    cw_lo = jnp.einsum("brw,blw->brl", lo, onew,
                       precision=hp).astype(jnp.uint32)
    cw_hi = jnp.einsum("brw,blw->brl", hi, onew,
                       precision=hp).astype(jnp.uint32)
    colword = cw_lo | (cw_hi << jnp.uint32(16))            # [B, r, L]
    colbits = ((colword >> b_idx[:, None, :]) & 1).astype(jnp.uint8)
    v_all = jnp.take_along_axis(
        colbits, jnp.broadcast_to(prs.T[:, :, None],
                                  (B, C, L)).astype(jnp.int32), axis=1)
    v_all = jnp.where(hass.T[:, :, None], v_all, 0).astype(jnp.float32)
    vals = [v_all[:, :, j] for j in range(L)]
    fcs = [fc_all[:, j] for j in range(L)]
    exists = [ex_all[:, j] for j in range(L)]
    wfree = [wf_all[:, j] for j in range(L)]

    BIG = jnp.float32(3e38)
    cand_scores = []
    cand_f1: list[int] = []
    cand_f2: list[int] = []
    for j in range(lam1):
        xor = e_f + vals[j] - 2.0 * e_f * vals[j]
        s = wfree[j] + jnp.sum(w_piv * xor, axis=1)
        cand_scores.append(jnp.where(exists[j], s, BIG))
        cand_f1.append(j)
        cand_f2.append(-1)
    if osd_order >= 2:
        for j in range(lam2):
            for k in range(j + 1, lam2):
                vj = vals[j] + vals[k] - 2.0 * vals[j] * vals[k]
                xor = e_f + vj - 2.0 * e_f * vj
                s = (wfree[j] + wfree[k]
                     + jnp.sum(w_piv * xor, axis=1))
                cand_scores.append(
                    jnp.where(exists[j] & exists[k], s, BIG))
                cand_f1.append(j)
                cand_f2.append(k)

    scores = jnp.stack(cand_scores, axis=1)                # [B, n_cand]
    best = jnp.argmin(scores, axis=1)                      # first minimum
    best_s = jnp.take_along_axis(scores, best[:, None], axis=1)[:, 0]
    improve = best_s < base
    f1_arr = jnp.asarray(cand_f1, jnp.int32)[best]         # [B]
    f2_arr = jnp.asarray(cand_f2, jnp.int32)[best]

    slot = jnp.arange(L, dtype=jnp.int32)
    sel1 = (slot[None, :] == f1_arr[:, None]).astype(jnp.float32)
    sel2 = (slot[None, :] == f2_arr[:, None]).astype(jnp.float32)
    vstack = jnp.stack(vals, axis=1)                       # [B, L, C]
    v1 = jnp.sum(vstack * sel1[:, :, None], axis=1)
    v2 = jnp.sum(vstack * sel2[:, :, None], axis=1)
    vsel = v1 + v2 - 2.0 * v1 * v2                         # GF(2) xor
    e_new = (e_f + vsel - 2.0 * e_f * vsel)
    fstack = jnp.stack(fcs, axis=1)                        # [B, L]
    fc1 = jnp.sum(fstack * sel1.astype(jnp.int32), axis=1)
    fc2 = jnp.sum(fstack * sel2.astype(jnp.int32), axis=1)
    onec = (cols[None, :] == fc1[:, None]).astype(jnp.float32)
    onec = onec + (cols[None, :] == fc2[:, None]) * (
        f2_arr >= 0)[:, None].astype(jnp.float32)
    e_new = jnp.clip(e_new + onec, 0, 1)   # free cols are never pivots
    e_final = jnp.where(improve[:, None], e_new, e_f).astype(jnp.uint8)

    e = jnp.zeros((B, n), jnp.uint8)
    e = e.at[jnp.arange(B)[:, None], order].set(e_final)
    chk = (e.astype(jnp.int32) @ h_t.astype(jnp.int32)) & 1
    ok = jnp.all(chk == synd.astype(jnp.int32), axis=1)
    return e, ok


#: device-OSD packed-block budget, in bits, where the device reports no
#: memory limit (the CPU backend): 2^32 bits = 512 MiB per chunk
OSD_FALLBACK_BUDGET_BITS = 1 << 32


def osd_chunk(r: int, C: int, bytes_limit: int | None = None) -> int:
    """Shots per device-OSD chunk for an r-row, C-column elimination.

    The live set is ~3x the packed [chunk, r, C] bit block (aug + the
    block-replay update + pivot rows), on top of the caller's
    device-resident BP buffers, so the block is held to a 32nd of the
    device's memory limit (``bytes_limit``; default: the first device's
    ``memory_stats()["bytes_limit"]``), or to
    `OSD_FALLBACK_BUDGET_BITS` on a device that reports none. Large-r
    systems (compiled-program circuit models reach r > 5000) shrink the
    chunk instead of running out of memory. Clamped to [64, 2048].
    """
    if bytes_limit is None:
        stats = jax.devices()[0].memory_stats() or {}
        bytes_limit = stats.get("bytes_limit")
    budget = (OSD_FALLBACK_BUDGET_BITS if not bytes_limit
              else int(bytes_limit) * 8 // 32)
    return min(2048, max(64, budget // max(r * C, 1)))


class BPDecoder:
    """Batched normalized-min-sum BP with optional host OSD-0 fallback.

    Parameters
    ----------
    h : [r, n] binary check matrix (redundant rows welcome — they help).
    priors : scalar or [n] prior error probability per variable, in (0, .5).
    logicals : optional [k, n] binary observable rows; enables
        `decode_obs`.
    iters : max BP iterations (the while_loop exits early when every
        shot in the batch has satisfied its syndrome).
    alpha : min-sum normalization factor.
    osd : apply host OSD-0 to non-converged shots in `decode_batch` /
        `decode_obs` (the device part is unchanged; OSD touches only the
        tail that BP left unconverged). `osd='always'` additionally runs
        OSD-0 on every shot and keeps the lower-prior-weight solution —
        guards against min-sum converging to a wrong-class higher-weight
        estimate on 4-cycle-rich graphs (e.g. hypergraph products).
    layout : 'auto' (default), 'dense', or 'gather' — how variable totals
        are computed ('dense': one matmul against the 0/1 slot
        incidence; 'gather': per-variable static gathers, the layout for
        circuit-level Tanner graphs whose dense incidence would not fit).
        'auto' switches to 'gather' past ~64M incidence entries. The two
        layouts differ only in f32 summation order.
    osd_backend : 'auto' (default), 'host', or 'device' — where OSD-0
        elimination runs. 'device' is the batched blocked-delayed-update
        kernel (`_osd0_device_kernel`), BIT-identical to the host loop;
        'auto' picks it once the tail's elimination work justifies the
        launch (~2^31 bit-ops — e.g. the bb144 circuit-level tail).
    """

    def __init__(self, h, priors, *, logicals=None, iters: int = 64,
                 alpha: float = 0.8, osd: bool = True,
                 layout: str = "auto", osd_backend: str = "auto",
                 gamma: float = 0.0, restarts: int = 0,
                 restart_jitter: float = 0.12,
                 osd_order: int = 0, osd_lambda: tuple = (16, 10)):
        self.h = np.ascontiguousarray(np.asarray(h, dtype=np.uint8) & 1)
        self.r, self.n = self.h.shape
        priors = np.broadcast_to(np.asarray(priors, np.float64), (self.n,))
        if np.any(priors <= 0.0) or np.any(priors >= 0.5):
            raise ValueError("priors must lie in (0, 0.5)")
        self.priors = priors.copy()
        self.iters = int(iters)
        self.alpha = float(alpha)
        if not 0.0 <= gamma < 1.0:
            raise ValueError("gamma must lie in [0, 1)")
        self.gamma = float(gamma)
        self.restarts = int(restarts)
        self.restart_jitter = float(restart_jitter)
        self.osd_order = int(osd_order)
        self.osd_lambda = (int(osd_lambda[0]), int(osd_lambda[1]))
        if osd not in (True, False, "always"):
            raise ValueError(f"osd must be True/False/'always', got {osd!r}")
        self.osd = osd
        if osd_backend not in ("auto", "host", "device"):
            raise ValueError(f"unknown osd_backend {osd_backend!r}")
        self.osd_backend = osd_backend
        self.logicals = (None if logicals is None else
                         np.asarray(logicals, dtype=np.uint8) & 1)

        chk_var, mask = _check_major_layout(self.h)
        dc = chk_var.shape[1]
        self._chk_var = jnp.asarray(chk_var)
        self._mask = jnp.asarray(mask)
        # Variable-side totals: for small graphs ONE dense matmul (slot ->
        # variable 0/1 incidence); past ~64M incidence
        # entries (circuit-level Tanner graphs: tens of thousands of fault
        # variables) the dense matrix is quadratically wasteful, so switch
        # to the transposed layout — per-variable static gathers over the
        # flattened message table (Dv = max variable degree stays small:
        # a fault touches few detectors even when a detector sees many
        # faults).
        if layout not in ("auto", "dense", "gather"):
            raise ValueError(f"unknown layout {layout!r}")
        self._use_gather = (layout == "gather" or (
            layout == "auto" and self.r * dc * self.n > (1 << 26)))
        if self._use_gather:
            var_slots: list[list[int]] = [[] for _ in range(self.n)]
            flat_vars = chk_var.reshape(-1)
            flat_mask = mask.reshape(-1)
            for sl in np.nonzero(flat_mask)[0]:
                var_slots[int(flat_vars[sl])].append(int(sl))
            dv = max(1, max(len(s) for s in var_slots))
            vs = np.zeros((self.n, dv), dtype=np.int32)
            vm = np.zeros((self.n, dv), dtype=bool)
            for v, slots in enumerate(var_slots):
                vs[v, : len(slots)] = slots
                vm[v, : len(slots)] = True
            self._var_slot = jnp.asarray(vs)
            self._var_mask = jnp.asarray(vm)
        else:
            scat = np.zeros((self.r * dc, self.n), dtype=np.float32)
            scat[np.arange(self.r * dc), chk_var.reshape(-1)] = mask.reshape(
                -1).astype(np.float32)
            self._scat = jnp.asarray(scat)
        self._lam = jnp.asarray(
            np.log((1.0 - priors) / priors), dtype=jnp.float32)
        self._run = jax.jit(self._bp_run)

    # -- device kernel ---------------------------------------------------

    def _bp_run(self, synd, lam=None):
        """synd [B, r] uint8 -> (e_hat [B, n] uint8, conv [B] bool,
        soft [B, n] f32 final LLR totals for OSD). `lam` optionally
        overrides the prior LLRs PER SHOT ([B, n] f32) — the hook for
        correlated two-pass decoding."""
        B = synd.shape[0]
        r, n, dc = self.r, self.n, self._chk_var.shape[1]
        synd_i = synd.astype(jnp.int32)
        mask = self._mask
        chk_var = self._chk_var
        lam = self._lam[None, :] if lam is None else lam
        slot = jnp.arange(dc, dtype=jnp.int32)

        if self._use_gather:
            var_slot = self._var_slot
            var_mask = self._var_mask
            dv = var_slot.shape[1]

            def totals(m):
                g = jnp.take(m.reshape(B, r * dc), var_slot.reshape(-1),
                             axis=1).reshape(B, n, dv)
                return lam + jnp.where(var_mask[None], g, 0.0).sum(axis=2)
        else:

            def totals(m):
                # float32 throughout: HIGHEST keeps the segment sum out
                # of TF32 so posteriors match the CPU backend up to
                # summation order
                return lam + jnp.matmul(m.reshape(B, r * dc), self._scat,
                                        precision=jax.lax.Precision.HIGHEST)

        def check_parities(e):
            inc = jnp.take(e, chk_var.reshape(-1), axis=1).reshape(B, r, dc)
            return (jnp.where(mask[None], inc, 0).sum(axis=2) & 1)

        def body(state):
            m, e_fr, conv, soft, i = state
            t = totals(m)                                   # [B, n]
            nmsg = jnp.take(t, chk_var.reshape(-1), axis=1).reshape(
                B, r, dc) - m                               # [B, r, dc]
            mag = jnp.where(mask[None], jnp.abs(nmsg), _BIG)
            neg = jnp.where(mask[None], (nmsg < 0).astype(jnp.int32), 0)
            par = (neg.sum(axis=2) + synd_i) & 1            # [B, r]
            sgn = (par[:, :, None] ^ neg) != 0              # True -> negative
            min1 = mag.min(axis=2)
            am = mag.argmin(axis=2).astype(jnp.int32)
            min2 = jnp.where(slot[None, None, :] == am[:, :, None],
                             _BIG, mag).min(axis=2)
            val = jnp.where(slot[None, None, :] == am[:, :, None],
                            min2[:, :, None], min1[:, :, None])
            m_new = jnp.where(mask[None],
                              jnp.float32(self.alpha)
                              * jnp.where(sgn, -val, val), 0.0)
            if self.gamma:
                # memory-BP (message damping): blend the min-sum update
                # with the previous message — breaks the oscillation /
                # trapping-set limit cycles that collapse deep
                # circuit-Tanner convergence (gamma=0 is bit-identical
                # to the undamped kernel: this branch is not traced)
                g = jnp.float32(self.gamma)
                m_new = g * m + (1.0 - g) * m_new
            t_new = totals(m_new)
            e = (t_new < 0).astype(jnp.int32)
            ok = jnp.all(check_parities(e) == synd_i, axis=1)
            newly = ok & ~conv
            e_fr = jnp.where(newly[:, None], e, e_fr)
            soft = jnp.where(newly[:, None], t_new, soft)
            return m_new, e_fr, conv | ok, soft, i + 1

        def cond(state):
            _, _, conv, _, i = state
            return (i < self.iters) & ~jnp.all(conv)

        m0 = jnp.zeros((B, r, dc), jnp.float32)
        e0 = jnp.zeros((B, n), jnp.int32)
        conv0 = jnp.zeros((B,), bool)
        m, e_fr, conv, soft, _ = jax.lax.while_loop(
            cond, body, (m0, e0, conv0,
                         jnp.broadcast_to(lam, (B, n)).astype(jnp.float32),
                         jnp.int32(0)))
        # Non-converged shots report their final hard decision + LLRs.
        t = totals(m)
        e_fr = jnp.where(conv[:, None], e_fr, (t < 0).astype(jnp.int32))
        soft = jnp.where(conv[:, None], soft, t)
        return e_fr.astype(jnp.uint8), conv, soft

    def _run_restarts(self, synd_j, lam=None):
        """`_bp_run` plus up to ``self.restarts`` perturbed re-decodes of
        the unconverged tail: the tail is gathered on device into a
        power-of-2 bucket (bounded recompiles, same trick as the OSD
        tail) and re-run with prior LLRs multiplied by device-generated
        uniform jitter in [1-restart_jitter, 1+restart_jitter]. Min-sum
        non-convergence at depth is dominated by limit cycles around
        trapping sets; a small prior perturbation breaks the symmetry and
        lets a large fraction of the tail converge — converged restarts
        replace the estimate, everything else is untouched (so
        restarts=0 is exactly the old path)."""
        e, conv, soft = (self._run(synd_j) if lam is None
                         else self._run(synd_j, lam))
        if not self.restarts:
            return e, conv, soft
        conv_np = np.array(conv)  # writable copy — restarts flip entries
        if conv_np.all():
            return e, conv, soft
        B = synd_j.shape[0]
        lam_full = (None if lam is None
                    else jnp.broadcast_to(lam, (B, self.n)))
        for k in range(self.restarts):
            idx = np.nonzero(~conv_np)[0]
            if idx.size == 0:
                break
            bt = idx.size
            pad = 1 << max(6, (bt - 1).bit_length())
            idx_j = jnp.asarray(np.pad(idx, (0, pad - bt)))
            synd_t = jnp.take(synd_j, idx_j, axis=0)
            lam_t = (jnp.broadcast_to(self._lam[None], (pad, self.n))
                     if lam_full is None
                     else jnp.take(lam_full, idx_j, axis=0))
            fac = jax.random.uniform(
                jax.random.key(0xB9C0 + k), (pad, self.n), jnp.float32,
                1.0 - self.restart_jitter, 1.0 + self.restart_jitter)
            e2, c2, s2 = self._run(synd_t, lam_t * fac)
            c2np = np.asarray(c2)[:bt]
            if not c2np.any():
                continue
            acc = np.nonzero(c2np)[0]
            dstj = jnp.asarray(idx[acc])
            srcj = jnp.asarray(acc)
            e = e.at[dstj].set(jnp.take(e2, srcj, axis=0))
            soft = soft.at[dstj].set(jnp.take(s2, srcj, axis=0))
            conv_np[idx[acc]] = True
        return e, jnp.asarray(conv_np), soft

    # -- host OSD-0 -------------------------------------------------------

    def _osd0(self, synd: np.ndarray, soft: np.ndarray) -> np.ndarray:
        """Order-0 ordered-statistics decode: sort columns most-suspect
        first (ascending LLR), GF(2)-eliminate to the first independent
        column set, solve with all other variables at 0. Exact given the
        ordering; O(r^2 n / 64) per shot on bit-packed rows. Runs the
        native kernel (`native/osd_decoder.cc`, bit-identical, ~100x)
        when the toolchain is available; the loop below is the
        pure-Python fallback and the reference semantics."""
        from qcss_tpu import native

        res = native.osd0_batch_native(self.h, synd, soft)
        if res is not None:
            return res
        out = np.zeros((synd.shape[0], self.n), dtype=np.uint8)
        words = (self.n + 1 + 63) // 64
        for bi in range(synd.shape[0]):
            order = np.argsort(soft[bi], kind="stable")
            bits = np.concatenate(
                [self.h[:, order], synd[bi][:, None]], axis=1)
            bits = np.pad(bits, ((0, 0), (0, words * 64 - bits.shape[1])))
            aug = np.ascontiguousarray(
                np.packbits(bits, axis=1, bitorder="little")).view(np.uint64)
            piv_rows: list[int] = []
            piv_cols: list[int] = []
            row = 0
            for c in range(self.n):
                w, b = divmod(c, 64)
                colbit = (aug[row:, w] >> np.uint64(b)) & np.uint64(1)
                nz = np.nonzero(colbit)[0]
                if nz.size == 0:
                    continue
                pr = row + int(nz[0])
                if pr != row:
                    aug[[row, pr]] = aug[[pr, row]]
                sel = ((aug[:, w] >> np.uint64(b)) & np.uint64(1)).astype(bool)
                sel[row] = False
                aug[sel] ^= aug[row]
                piv_rows.append(row)
                piv_cols.append(c)
                row += 1
                if row == self.r:
                    break
            sw, sb = divmod(self.n, 64)
            e_ord = np.zeros(self.n, dtype=np.uint8)
            for pr, pc in zip(piv_rows, piv_cols):
                e_ord[pc] = (aug[pr, sw] >> np.uint64(sb)) & np.uint64(1)
            out[bi, order] = e_ord
        return out

    def _osd0_any(self, synd: np.ndarray, soft: np.ndarray,
                  h: np.ndarray | None = None) -> np.ndarray:
        """OSD-0 via the backend policy: 'device' runs the batched
        on-device elimination (`_osd0_device_kernel`, bit-identical) with
        host fallback for shots whose rank is not reached within the
        column cap; 'auto' picks device once the tail's elimination work
        justifies the launch (~2^31 bit-ops); 'host' is the single-core
        C++/Python path. `h` optionally overrides the check matrix (gap
        decoding's augmented [h; L_j] systems — same columns, extra
        constraint rows)."""
        h_mat = self.h if h is None else h
        r, n = h_mat.shape
        C = min(n, r + 256)
        if self.osd_backend == "device":
            use_dev = True
        elif self.osd_backend == "host":
            use_dev = False
        else:
            use_dev = synd.shape[0] * r * C > (1 << 31)
        if self.osd_order and h is None:
            # order-E sweep: device kernel (round 5 — the combination
            # sweep rides the reduced block of the OSD-0 elimination)
            # under the same backend policy; the gap path's augmented
            # systems (h override) keep OSD-0 — the complementary
            # re-decodes only need a consistent weight proxy, and
            # E-sweeping both classes doubles the cost
            if not use_dev or max(self.osd_lambda) > 256:
                return self._osde_any(synd, soft)
            return self._osde_device(synd, soft, C)

        def host(s, f):
            return (self._osd0(s, f) if h is None
                    else self._osd0_on(h_mat, s, f))

        if not use_dev:
            return host(synd, soft)
        h_t = jnp.asarray(h_mat.T)
        out = np.zeros((synd.shape[0], n), np.uint8)
        chunk = min(osd_chunk(r, C), synd.shape[0])
        for lo in range(0, synd.shape[0], chunk):
            hi = min(lo + chunk, synd.shape[0])
            s_c = np.zeros((chunk, r), synd.dtype)
            f_c = np.zeros((chunk, n), soft.dtype)
            s_c[: hi - lo] = synd[lo:hi]
            f_c[: hi - lo] = soft[lo:hi]
            e, ok = _osd0_device_kernel(h_t, jnp.asarray(s_c),
                                        jnp.asarray(f_c), C)
            out[lo:hi] = np.asarray(e)[: hi - lo]
            ok = np.asarray(ok)[: hi - lo]
            if not ok.all():
                idx = np.nonzero(~ok)[0]
                out[lo + idx] = host(synd[lo + idx], soft[lo + idx])
        return out

    def _osde_device(self, synd: np.ndarray, soft: np.ndarray,
                     C: int) -> np.ndarray:
        """Device order-E sweep (`_osde_device_kernel`) with the same
        chunking as the device OSD-0 and host fallback for shots whose
        rank is not reached within the column cap. Same enumeration
        order and tie-break rule as the host sweep (solutions can
        differ on float-tie candidates; see `_osde_py`)."""
        r, n = self.h.shape
        h_t = jnp.asarray(self.h.T)
        out = np.zeros((synd.shape[0], n), np.uint8)
        chunk = min(osd_chunk(r, C), synd.shape[0])
        for lo in range(0, synd.shape[0], chunk):
            hi = min(lo + chunk, synd.shape[0])
            s_c = np.zeros((chunk, r), synd.dtype)
            f_c = np.zeros((chunk, n), soft.dtype)
            s_c[: hi - lo] = synd[lo:hi]
            f_c[: hi - lo] = soft[lo:hi]
            e, ok = _osde_device_kernel(h_t, jnp.asarray(s_c),
                                        jnp.asarray(f_c), C,
                                        self.osd_order,
                                        *self.osd_lambda)
            out[lo:hi] = np.asarray(e)[: hi - lo]
            ok = np.asarray(ok)[: hi - lo]
            if not ok.all():
                idx = np.nonzero(~ok)[0]
                out[lo + idx] = self._osde_any(synd[lo + idx],
                                               soft[lo + idx])
        return out

    def _osde_any(self, synd: np.ndarray, soft: np.ndarray) -> np.ndarray:
        """Order-E combination-sweep OSD (see `_osde_py` for the exact
        semantics); native kernel when the toolchain is available."""
        from qcss_tpu import native

        res = native.osde_batch_native(self.h, synd, soft, self.osd_order,
                                       *self.osd_lambda)
        if res is not None:
            return res
        return _osde_py(self.h, synd, soft, self.osd_order,
                        *self.osd_lambda)

    # -- public API --------------------------------------------------------

    def decode_batch(self, synd, priors=None):
        """[B, r] syndromes -> ([B, n] uint8 error estimates,
        [B] bool BP-converged mask). With `osd=True` non-converged shots
        are replaced by their OSD-0 solution (which always satisfies the
        syndrome), and the converged mask still reports BP's own reach.
        `priors` optionally overrides the per-variable error priors PER
        SHOT ([B, n], in (0, 0.5)) — correlated second passes condition
        them on a first pass's estimates."""
        synd = jnp.asarray(synd, jnp.uint8)
        if priors is None:
            e_hat, conv, soft = self._run_restarts(synd)
        else:
            pb = np.clip(np.asarray(priors, np.float64), 1e-12, 0.499)
            lam = jnp.asarray(np.log((1.0 - pb) / pb), jnp.float32)
            e_hat, conv, soft = self._run_restarts(synd, lam)
        if not self.osd:
            return np.asarray(e_hat), np.asarray(conv)
        conv_np = np.asarray(conv)
        e_np = np.array(e_hat)  # writable copy — OSD patches the tail in place
        if self.osd == "always":
            # OSD the WHOLE batch and keep the lower-prior-LLR-weight
            # syndrome-satisfying solution. Min-sum BP can CONVERGE to a
            # wrong-class higher-weight solution on 4-cycle-rich graphs
            # (measured: hypergraph-product of Hamming(7,4) mis-decodes
            # 7/58 weight-1 errors to converged weight-4 estimates at any
            # alpha >= 0.6); the weight tie-break restores exactness.
            e_osd = self._osd0_any(np.asarray(synd), np.asarray(soft))
            lam_p = np.log((1.0 - self.priors) / self.priors)
            take = ~conv_np | (e_osd.astype(np.float64) @ lam_p
                               < e_np.astype(np.float64) @ lam_p)
            e_np[take] = e_osd[take]
        elif not conv_np.all():
            idx = np.nonzero(~conv_np)[0]
            e_np[idx] = self._osd0_any(np.asarray(synd)[idx],
                                       np.asarray(soft)[idx])
        return e_np, conv_np

    def posteriors(self, synd, priors=None):
        """[B, r] syndromes -> ([B, n] float32 posterior LLR totals,
        [B] bool BP-converged). The soft marginals a belief-matching
        stage consumes: LLR > 0 means the variable likely did NOT fire.
        Converged shots report totals frozen at first syndrome
        satisfaction (the same values OSD sorts by); non-converged
        shots their final-iteration totals. No OSD is applied — the
        posterior is useful whether or not min-sum converged."""
        synd = jnp.asarray(synd, jnp.uint8)
        if priors is None:
            _, conv, soft = self._run(synd)
        else:
            pb = np.clip(np.asarray(priors, np.float64), 1e-12, 0.499)
            lam = jnp.asarray(np.log((1.0 - pb) / pb), jnp.float32)
            _, conv, soft = self._run(synd, lam)
        return np.asarray(soft), np.asarray(conv)

    def decode_obs(self, synd, priors=None):
        """[B, r] syndromes -> ([B, k] uint8 observable flips, conv)."""
        if self.logicals is None:
            raise ValueError("decoder built without logicals")
        e_hat, conv = self.decode_batch(synd, priors)
        return (e_hat.astype(np.int64)
                @ self.logicals.T.astype(np.int64)) & 1, conv

    def decode_obs_device(self, synd):
        """Device-resident `decode_obs`: [B, r] syndromes (device array
        welcome) -> ([B, k] observable flips ON DEVICE, [B] conv np).

        `decode_obs` pulls the full [B, n] error estimate (and, for the
        OSD tail, the [B, n] float LLRs) to the host — ~350 MB per bb144
        batch. This path keeps everything on device: flips are reduced
        to [B, k] there, the OSD tail is gathered, padded to a power-of-2
        bucket (bounded recompiles) and eliminated by
        `_osd0_device_kernel` in place; only the tiny conv mask, straggler
        rows (rank not reached within the column cap — host re-solve),
        and the final flips cross the boundary. Identical results to
        `decode_obs` (the device OSD is bit-identical)."""
        if self.logicals is None:
            raise ValueError("decoder built without logicals")
        if self.osd == "always":
            raise ValueError("decode_obs_device supports osd=True/False; "
                             "use decode_obs for the whole-batch "
                             "osd='always' tie-break")
        synd_j = jnp.asarray(synd, jnp.uint8)
        e, conv, soft = self._run_restarts(synd_j)
        obs_t = jnp.asarray(self.logicals.T, jnp.int32)
        flips = (e.astype(jnp.int32) @ obs_t) & 1
        if not self.osd:
            return flips, np.asarray(conv)
        conv_np = np.asarray(conv)
        if conv_np.all():
            return flips, conv_np
        idx = np.nonzero(~conv_np)[0]
        bt = idx.size
        if self.osd_order:
            # order-E is host-only: pull the tail (restarts have already
            # shrunk it), sweep, push the flips back
            e_host = self._osde_any(np.asarray(jnp.take(synd_j,
                                                        jnp.asarray(idx),
                                                        axis=0)),
                                    np.asarray(jnp.take(soft,
                                                        jnp.asarray(idx),
                                                        axis=0)))
            fh = (e_host.astype(np.int64) @ self.logicals.T) & 1
            flips = flips.at[jnp.asarray(idx)].set(
                jnp.asarray(fh, flips.dtype))
            return flips, conv_np
        pad = 1 << max(6, (bt - 1).bit_length())  # pow-2 buckets
        idx_j = jnp.asarray(np.pad(idx, (0, pad - bt)))
        synd_t = jnp.take(synd_j, idx_j, axis=0)
        soft_t = jnp.take(soft, idx_j, axis=0)
        C = min(self.n, self.r + 256)
        e_t, ok = _osd0_device_kernel(jnp.asarray(self.h.T), synd_t,
                                      soft_t, C)
        flips_t = (e_t.astype(jnp.int32) @ obs_t) & 1
        ok_np = np.asarray(ok)[:bt]
        if not ok_np.all():
            bad = np.nonzero(~ok_np)[0]
            e_host = self._osd0(np.asarray(synd_t[bad]),
                                np.asarray(soft_t[bad]))
            fh = (e_host.astype(np.int64) @ self.logicals.T) & 1
            flips_t = flips_t.at[jnp.asarray(bad)].set(
                jnp.asarray(fh, flips_t.dtype))
        flips = flips.at[idx_j[:bt]].set(flips_t[:bt])
        return flips, conv_np

    def decode_obs_gap(self, synd):
        """Soft-output decoding: [B, r] syndromes ->
        ([B, k] observable flips, [B] conv, [B] gap).

        Flips are the STANDARD decode (BP hard decision, OSD-0 tail —
        identical to `decode_obs`). The gap is confidence: for every
        logical j the syndrome is re-decoded TWICE under the augmented
        system [h; L_j] with the logical class forced to 0 and to 1
        (OSD-0 over BP's soft ordering), and ``gap`` is the prior-LLR
        weight margin of the least-confident logical,
        min_j |w_j(0) - w_j(1)| — the complementary-gap proxy for
        P(logical error | syndrome). Post-selecting on ``gap >= tau``
        trades abort rate for conditional logical accuracy (measured on
        bb72 code capacity p=0.03: 1.1% -> 0.17% word fail at 13%
        abort). No reference analogue: the reference's LUT decode has no
        confidence information at all (reference: css_code.py:649-685)."""
        if self.logicals is None:
            raise ValueError("decoder built without logicals")
        synd = np.ascontiguousarray(np.asarray(synd), np.uint8)
        e_hat, conv, soft = self._run_restarts(jnp.asarray(synd))
        soft = np.asarray(soft)
        conv = np.asarray(conv)
        e_np = np.array(e_hat)
        if self.osd and not conv.all():
            idx = np.nonzero(~conv)[0]
            e_np[idx] = self._osd0_any(synd[idx], soft[idx])
        flips = ((e_np.astype(np.int64) @ self.logicals.T.astype(np.int64))
                 & 1).astype(np.uint8)
        b = synd.shape[0]
        k = self.logicals.shape[0]
        lam = np.log((1.0 - self.priors) / self.priors)
        gap = np.full(b, np.inf, np.float64)
        for j in range(k):
            h_aug = np.concatenate([self.h, self.logicals[j:j + 1]], axis=0)
            w = np.empty((2, b))
            for cls in (0, 1):
                s_aug = np.concatenate(
                    [synd, np.full((b, 1), cls, np.uint8)], axis=1)
                e = self._osd0_any(s_aug, soft, h=h_aug)
                w[cls] = e.astype(np.float64) @ lam
            gap = np.minimum(gap, np.abs(w[0] - w[1]))
        return flips, conv, gap.astype(np.float32)

    def _osd0_on(self, h_aug: np.ndarray, synd: np.ndarray,
                 soft: np.ndarray) -> np.ndarray:
        """OSD-0 against an augmented check matrix (same columns, extra
        constraint rows); native kernel when available."""
        from qcss_tpu import native

        res = native.osd0_batch_native(h_aug, synd, soft)
        if res is not None:
            return res
        saved_h, saved_r = self.h, self.r
        try:
            self.h, self.r = h_aug, h_aug.shape[0]
            return self._osd0(synd, soft)
        finally:
            self.h, self.r = saved_h, saved_r


def open_window_tanner(h, window: int, p_data: float, p_meas: float):
    """Tanner graph of `window` NOISY detector slices with no terminal
    readout — the mid-stream building block for `bp_streaming`. Variables
    are e_t (fresh data errors before slice t) then m_t (measurement
    flips), t = 0..window-1, with D[t] = H·e_t ^ m_t ^ m_{t-1} and the
    boundary m_{-1} handled by the caller (XORed out of slice 0 as the
    committed carry). Returns (tanner [window*r, window*(n+r)] uint8,
    priors)."""
    h = np.asarray(h, dtype=np.uint8) & 1
    r, n = h.shape
    n_data = window * n
    n_vars = n_data + window * r
    tan = np.zeros((window * r, n_vars), dtype=np.uint8)
    priors = np.empty(n_vars, dtype=np.float64)
    priors[:n_data] = p_data
    priors[n_data:] = p_meas
    eye = np.eye(r, dtype=np.uint8)
    for t in range(window):
        tan[t * r:(t + 1) * r, t * n:(t + 1) * n] = h
        tan[t * r:(t + 1) * r, n_data + t * r:n_data + (t + 1) * r] = eye
        if t > 0:
            tan[t * r:(t + 1) * r, n_data + (t - 1) * r:n_data + t * r] = eye
    return tan, priors


def spacetime_tanner(h, rounds: int, p_data: float, p_meas: float,
                     logicals=None):
    """Phenomenological spacetime Tanner graph for BP decoding.

    Matches the physics of `streaming.sample_phenomenological_stream` /
    `uf.spacetime_graph`: `rounds` noisy extraction rounds (fresh IID
    data errors at rate ``p_data`` before each, measurement flips at rate
    ``p_meas``), one final data layer, then a perfect readout slice.
    Detector (t, c) = syndrome-slice difference; in Tanner form

        D[t] = H · e_t  ^  m_t  ^  m_{t-1}

    with variables e_t (t = 0..rounds, the last the pre-readout layer)
    and m_t (t = 0..rounds-1). Returns (tanner [R', N'] uint8,
    priors [N'], obs [k, N'] or None, n_data_vars) with the observable
    rows acting on every data layer (the decoded flip of L · cumulative
    error)."""
    h = np.asarray(h, dtype=np.uint8) & 1
    r, n = h.shape
    t_layers = rounds + 1
    n_data = t_layers * n
    n_vars = n_data + rounds * r
    rows = t_layers * r
    tan = np.zeros((rows, n_vars), dtype=np.uint8)
    priors = np.empty(n_vars, dtype=np.float64)
    priors[:n_data] = p_data
    priors[n_data:] = p_meas
    for t in range(t_layers):
        tan[t * r:(t + 1) * r, t * n:(t + 1) * n] = h
        if t < rounds:  # m_t in D[t]
            tan[t * r:(t + 1) * r, n_data + t * r:n_data + (t + 1) * r] = (
                np.eye(r, dtype=np.uint8))
        if t > 0:       # m_{t-1} in D[t]
            tan[t * r:(t + 1) * r,
                n_data + (t - 1) * r:n_data + t * r] = np.eye(
                    r, dtype=np.uint8)
    obs = None
    if logicals is not None:
        lg = np.asarray(logicals, dtype=np.uint8) & 1
        obs = np.zeros((lg.shape[0], n_vars), dtype=np.uint8)
        for t in range(t_layers):
            obs[:, t * n:(t + 1) * n] = lg
    return tan, priors, obs, n_data


def bp_phenomenological_error_rate(code, rounds: int, p: float, q: float, *,
                                   batch: int, seed: int = 0,
                                   iters: int = 64, alpha: float = 0.8,
                                   osd: bool = True) -> dict[str, float]:
    """X-sector phenomenological memory with spacetime BP(+OSD) decoding.

    Samples detector histories with `streaming.sample_phenomenological_stream`
    (IID data-X layers at ``p``, measurement flips at ``q``, perfect final
    readout) against the code's Z checks, decodes the full history on the
    spacetime Tanner graph, and scores against the true logical parities.
    This is the qLDPC counterpart of `uf.uf_phenomenological_error_rate`
    for codes whose checks are not matchable (BB / hypergraph-product
    families)."""
    from qcss_tpu.decode.streaming import sample_phenomenological_stream

    # prefer the full redundant set (qLDPC constructors), else the raw
    # pre-reduction rows — the standard-form RREF rows are high-weight
    # and ruin the Tanner graph's sparsity
    h2 = getattr(code, "redundant_parity_check_c2", None)
    if h2 is None:
        h2 = code.raw_parity_check_c2
    lz = code.z_operator_matrix()
    tan, priors, obs, _ = spacetime_tanner(h2, rounds, p, q, logicals=lz)
    dec = BPDecoder(tan, priors, logicals=obs, iters=iters, alpha=alpha,
                    osd=osd)
    dets, par = sample_phenomenological_stream(
        jax.random.key(seed), p, q, batch, rounds, h2, lz)
    syn = np.asarray(dets, np.uint8).reshape(batch, -1)
    flips, conv = dec.decode_obs(syn)
    fail = (flips ^ np.asarray(par, np.uint8)).any(axis=1)
    return {
        "x_fail": float(fail.mean()),
        "bp_converged": float(np.asarray(conv).mean()),
        "samples": batch,
        "rounds": rounds,
    }


def bp_logical_error_rate(code, p, *, batch: int, seed: int = 0,
                          iters: int = 64, alpha: float = 0.8,
                          osd: bool = True) -> dict[str, float]:
    """Code-capacity Monte-Carlo with BP(+OSD) decoding of both Pauli
    sectors — `montecarlo.logical_error_rate`'s conventions (X errors
    checked by C2/Z-type rows against logical Z̄; Z errors by C1/X-type
    rows against X̄) for codes the LUT cannot reach. Uses the redundant
    check sets when the code carries them (qLDPC constructors)."""
    from qcss_tpu.decode.montecarlo import sample_depolarizing
    from qcss_tpu.ops import gf2_jax

    h1 = getattr(code, "redundant_parity_check_c1", code.parity_check_c1)
    h2 = getattr(code, "redundant_parity_check_c2", code.parity_check_c2)
    prior = 2.0 * p / 3.0  # depolarizing: P(X or Y) per qubit
    dec_x = BPDecoder(h2, prior, logicals=code.z_operator_matrix(),
                      iters=iters, alpha=alpha, osd=osd)
    dec_z = BPDecoder(h1, prior, logicals=code.x_operator_matrix(),
                      iters=iters, alpha=alpha, osd=osd)
    key = jax.random.key(seed)
    x_err, z_err = sample_depolarizing(key, batch, code.n, p)
    syn_x = gf2_jax.syndromes_dense(x_err, jnp.asarray(h2))
    syn_z = gf2_jax.syndromes_dense(z_err, jnp.asarray(h1))
    flips_x, conv_x = dec_x.decode_obs(syn_x)
    flips_z, conv_z = dec_z.decode_obs(syn_z)
    err_flip_x = (np.asarray(x_err, np.int64)
                  @ code.z_operator_matrix().T.astype(np.int64)) & 1
    err_flip_z = (np.asarray(z_err, np.int64)
                  @ code.x_operator_matrix().T.astype(np.int64)) & 1
    x_fail = (flips_x ^ err_flip_x).any(axis=1)
    z_fail = (flips_z ^ err_flip_z).any(axis=1)
    return {
        "x_fail": float(x_fail.mean()),
        "z_fail": float(z_fail.mean()),
        "word_fail": float((x_fail | z_fail).mean()),
        "bp_converged": float((np.asarray(conv_x)
                               & np.asarray(conv_z)).mean()),
        "samples": batch,
    }
