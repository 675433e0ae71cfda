"""Circuit-level qLDPC memory experiment: BB / hypergraph-product codes
under full extraction-circuit noise, decoded with circuit-level BP(+OSD).

The schedule and frame sampling are `experiments.memory_xz`'s (both check
sectors extracted every round), run over the code's FULL redundant check
sets — what hardware actually measures, and free information for BP. The
decoder is `decode.bp_dem.circuit_bp_decoder`: every fault mechanism of
the extraction circuit (two-qubit depolarizing on each CNOT, measurement
and reset flips) is an exact Tanner variable with its propagated detector
signature — ancilla hooks that fan into several data qubits stay intact
instead of being decomposed into matching edges.

All k logical qubits are scored (word failure = any of the 2k observables
wrong). No reference analogue: the reference is k=1-only and decodes one
noisy extraction with a LUT (reference: css_code.py:334-339, 649-685)."""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from qcss_tpu.decode.bp_dem import circuit_bp_decoder
from qcss_tpu.decode.spacetime import detector_history
from qcss_tpu.experiments.memory import x_extraction_circuit, z_extraction_circuit
from qcss_tpu.experiments.memory_xz import _sample_two_sector
from qcss_tpu.sim import frame as fr
from qcss_tpu.sim import noise as noise_mod


def qldpc_memory_experiment(code, *, rounds: int,
                            noise: noise_mod.NoiseModel,
                            batch: int = 1 << 12, seed: int = 0,
                            iters: int = 64, alpha: float = 0.8,
                            osd: bool = True, sectors: str = "both",
                            joint: bool = False, alpha_joint: float = 0.6,
                            correlated: bool = False,
                            gap_tau: float | None = None,
                            bp_kwargs: dict | None = None) -> dict[str, float]:
    """Run the two-sector circuit-level memory and decode each sector
    with circuit-level BP. `sectors='z'` decodes X errors only (faster;
    the Z-basis memory), `'both'` adds Z errors and word failure.

    `joint=True` additionally decodes the STACKED two-sector detector
    history with ONE BP over the joint Tanner graph
    (`bp_dem.build_joint_circuit_tanner`) in which Y-type faults are
    single variables exciting both sectors — the exact form of the
    correlation `decode.dem2`'s matching pipeline approximates with
    two-pass reweighting. Reports `*_joint` alongside the independent
    numbers on the SAME shots.

    `correlated=True` additionally runs the two-PASS version (the BP
    analogue of `experiments.memory_xz`'s correlated matching): the
    x-sector decode keeps the per-sector graph but conditions each
    Z-component's prior on whether the z-sector pass decided its
    same-location X-component fired (`bp_dem.two_pass_pair_indices`,
    per-shot priors). Reports `z_fail_corr` / `word_fail_corr`."""
    hz = np.asarray(getattr(code, "redundant_parity_check_c2",
                            code.raw_parity_check_c2), np.uint8) & 1
    hx = np.asarray(getattr(code, "redundant_parity_check_c1",
                            code.raw_parity_check_c1), np.uint8) & 1
    rz, rx = hz.shape[0], hx.shape[0]
    lz = np.asarray(code.z_operator_matrix(), np.uint8) & 1
    lx = np.asarray(code.x_operator_matrix(), np.uint8) & 1
    n = code.n

    z_arrays = tuple(map(jnp.asarray, z_extraction_circuit(
        code, checks=hz).to_arrays()))
    x_arrays = tuple(map(jnp.asarray, x_extraction_circuit(
        code, anc_offset=n + rz, checks=hx).to_arrays()))
    nq = n + rz + rx
    z_comp = fr.maybe_compile(z_arrays, nq)
    x_comp = fr.maybe_compile(x_arrays, nq)

    fn = jax.jit(
        partial(_sample_two_sector, code=code, noise=noise,
                z_arrays=z_arrays, x_arrays=x_arrays,
                z_comp=z_comp, x_comp=x_comp, rz=rz, rx=rx),
        static_argnames=("batch", "rounds"),
    )
    syns_z, syns_x, x_err, z_err = fn(jax.random.key(seed), batch, rounds)

    # Device-resident fast path (the default): detector assembly, BP,
    # observable reduction, and the OSD tail all stay on the accelerator;
    # only [B, k] flips and the conv masks cross the host boundary. The
    # richer analyses below (joint graphs, two-pass priors, gap sweeps)
    # need host arrays, so they pull (~350 MB of syndromes + estimates at
    # bb144 x 8192).
    device_path = not (joint or correlated or gap_tau is not None
                       or osd == "always")
    if device_path:
        final_z_j = (x_err.astype(jnp.int32) @ jnp.asarray(hz.T,
                                                           jnp.int32)) & 1
        dets_z = detector_history(syns_z, final_z_j.astype(jnp.uint8))
        par_x = (x_err.astype(jnp.int32)
                 @ jnp.asarray(lz.T, jnp.int32)) & 1
    else:
        syns_z, syns_x = np.asarray(syns_z), np.asarray(syns_x)
        x_err, z_err = np.asarray(x_err), np.asarray(z_err)
        final_z = ((x_err.astype(np.int64) @ hz.T) & 1).astype(np.uint8)
        dets_z = detector_history(syns_z, final_z)
        par_x = (x_err.astype(np.int64) @ lz.T.astype(np.int64)) & 1

    bp_kwargs = bp_kwargs or {}
    dec_z = circuit_bp_decoder(code, rounds, noise, sector="z",
                               iters=iters, alpha=alpha, osd=osd,
                               hz=hz, hx=hx, **bp_kwargs)
    if gap_tau is not None:
        flips_x, conv_z, gap = dec_z.decode_obs_gap(
            dets_z.reshape(batch, -1))
    elif device_path:
        flips_x, conv_z = dec_z.decode_obs_device(dets_z.reshape(batch, -1))
    else:
        flips_x, conv_z = dec_z.decode_obs(dets_z.reshape(batch, -1))
    xf = np.asarray((flips_x ^ par_x).any(axis=1))
    out = {
        "x_fail": float(xf.mean()),
        "bp_converged_z": float(np.asarray(conv_z).mean()),
        "samples": batch,
        "rounds": rounds,
        "faults_z": dec_z.n,
    }
    if gap_tau is not None:
        # soft-output post-selection on the z-sector decode: abort shots
        # whose complementary gap falls below tau
        keep = gap >= gap_tau
        out.update({
            "gap_tau": float(gap_tau),
            "gap_keep": float(keep.mean()),
            "x_fail_postselected": float(xf[keep].mean())
            if keep.any() else None,
        })
    if sectors == "both":
        dec_x = circuit_bp_decoder(code, rounds, noise, sector="x",
                                   iters=iters, alpha=alpha, osd=osd,
                                   hz=hz, hx=hx, **bp_kwargs)
        if device_path:
            final_x_j = (z_err.astype(jnp.int32)
                         @ jnp.asarray(hx.T, jnp.int32)) & 1
            dets_x = detector_history(syns_x, final_x_j.astype(jnp.uint8))
            par_z = (z_err.astype(jnp.int32)
                     @ jnp.asarray(lx.T, jnp.int32)) & 1
            flips_z, conv_x = dec_x.decode_obs_device(
                dets_x.reshape(batch, -1))
        else:
            final_x = ((z_err.astype(np.int64) @ hx.T) & 1).astype(np.uint8)
            dets_x = detector_history(syns_x, final_x)
            flips_z, conv_x = dec_x.decode_obs(dets_x.reshape(batch, -1))
            par_z = (z_err.astype(np.int64) @ lx.T.astype(np.int64)) & 1
        zf = np.asarray((flips_z ^ par_z).any(axis=1))
        out.update({
            "z_fail": float(zf.mean()),
            "word_fail": float((xf | zf).mean()),
            "bp_converged_x": float(np.asarray(conv_x).mean()),
        })
    if joint:
        from qcss_tpu.decode.bp_dem import joint_circuit_bp_decoder

        if sectors != "both":
            raise ValueError("joint decoding needs sectors='both'")
        dec_j = joint_circuit_bp_decoder(code, rounds, noise, iters=iters,
                                         alpha=alpha_joint, osd=osd,
                                         hz=hz, hx=hx)
        dets_j = np.concatenate(
            [dets_z.reshape(batch, -1), dets_x.reshape(batch, -1)], axis=1)
        flips_j, conv_j = dec_j.decode_obs(dets_j)
        kz = lz.shape[0]
        xf_j = (flips_j[:, :kz] ^ par_x).any(axis=1)
        zf_j = (flips_j[:, kz:] ^ par_z).any(axis=1)
        out.update({
            "x_fail_joint": float(xf_j.mean()),
            "z_fail_joint": float(zf_j.mean()),
            "word_fail_joint": float((xf_j | zf_j).mean()),
            "bp_converged_joint": float(np.asarray(conv_j).mean()),
            "faults_joint": dec_j.n,
        })
    if correlated:
        from qcss_tpu.decode.bp import BPDecoder
        from qcss_tpu.decode.bp_dem import two_pass_pair_indices

        if sectors != "both":
            raise ValueError("correlated decoding needs sectors='both'")
        tz, tx, vx, vz, cond = two_pass_pair_indices(code, rounds, noise,
                                                     hz=hz, hx=hx)
        dz = BPDecoder(tz.checks, np.clip(tz.priors, 1e-12, 0.499),
                       logicals=tz.obs, iters=iters, alpha=alpha, osd=osd)
        e_x, _ = dz.decode_batch(dets_z.reshape(batch, -1))
        # condition each Z-component's prior on its same-location
        # X-component having fired in the first pass
        pb = np.tile(np.clip(tx.priors, 1e-12, 0.499), (batch, 1))
        if vx.size:
            sel = e_x[:, vx].astype(bool)                     # [B, P]
            upd = np.zeros((tx.priors.size, batch))
            np.maximum.at(upd, vz,
                          np.where(sel, cond[None, :], 0.0).T)
            pb = np.maximum(pb, np.clip(upd.T, 0.0, 0.499))
        dxc = BPDecoder(tx.checks, np.clip(tx.priors, 1e-12, 0.499),
                        logicals=tx.obs, iters=iters, alpha=alpha, osd=osd,
                        **bp_kwargs)
        flips_zc, conv_c = dxc.decode_obs(dets_x.reshape(batch, -1),
                                          priors=pb)
        zf_c = (flips_zc ^ par_z).any(axis=1)
        out.update({
            "z_fail_corr": float(zf_c.mean()),
            "word_fail_corr": float((xf | zf_c).mean()),
            "bp_converged_corr": float(np.asarray(conv_c).mean()),
            "pairs": int(vx.size),
        })
    return out


def qldpc_stream_memory_rate(code, noise: noise_mod.NoiseModel, *,
                             rounds: int, batch: int, window: int = 8,
                             commit: int = 4, iters: int = 48,
                             alpha: float = 0.8, osd: bool = True,
                             seed: int = 0,
                             sectors: str = "z") -> dict[str, float]:
    """Unbounded-round CIRCUIT-LEVEL qLDPC Z-memory with O(window) state:
    chunked frame sampling of the two-sector extraction schedule
    interleaved with sliding-window circuit-level BP decodes
    (`decode.bp_streaming.CircuitBPStreamingDecoder`). The qLDPC
    counterpart of `decode.device_streaming.stream_memory_rate_dem` —
    total memory is O(window), so `rounds` can be arbitrarily large.

    Each chunk samples `commit` rounds on device (lax.scan over the real
    two-sector circuit, identical physics and key consumption to
    `qldpc_memory_experiment`); the decoder window slides behind the
    sampler. Returns the X-logical failure rate over all k logicals and
    the end-to-end round-shots/s; `sectors='both'` also streams the
    x-sector detector history through a second window decoder and
    reports `z_fail` / `word_fail`."""
    import time

    from qcss_tpu.decode.bp_streaming import CircuitBPStreamingDecoder

    hz = np.asarray(getattr(code, "redundant_parity_check_c2",
                            code.raw_parity_check_c2), np.uint8) & 1
    hx = np.asarray(getattr(code, "redundant_parity_check_c1",
                            code.raw_parity_check_c1), np.uint8) & 1
    rz, rx = hz.shape[0], hx.shape[0]
    lz = np.asarray(code.z_operator_matrix(), np.uint8) & 1
    n = code.n
    W, C = window, commit
    if rounds < W:
        raise ValueError("need rounds >= window")

    z_arrays = tuple(map(jnp.asarray, z_extraction_circuit(
        code, checks=hz).to_arrays()))
    x_arrays = tuple(map(jnp.asarray, x_extraction_circuit(
        code, anc_offset=n + rz, checks=hx).to_arrays()))
    nq = n + rz + rx
    z_comp = fr.maybe_compile(z_arrays, nq)
    x_comp = fr.maybe_compile(x_arrays, nq)
    zanc = jnp.arange(n, n + rz, dtype=jnp.int32)
    xanc = jnp.arange(n + rz, nq, dtype=jnp.int32)
    data = jnp.arange(n, dtype=jnp.int32)
    hz_j = jnp.asarray(hz)

    dec = CircuitBPStreamingDecoder(code, noise, sector="z", window=W,
                                    commit=C, iters=iters, alpha=alpha,
                                    osd=osd, hz=hz, hx=hx)
    dec_x = None
    if sectors == "both":
        dec_x = CircuitBPStreamingDecoder(code, noise, sector="x", window=W,
                                          commit=C, iters=iters, alpha=alpha,
                                          osd=osd, hz=hz, hx=hx)

    @partial(jax.jit, static_argnames=("m",))
    def sample_chunk(f, prev_syn, key, m):
        """m two-sector rounds; emits both sectors' detector increments
        ([B, m, rz], [B, m, rx])."""
        def body(carry, k):
            f, prev_z, prev_x = carry
            if noise.p_idle:
                # per-round data idle at the round boundary — identical
                # semantics (and decoder species) to _sample_two_sector
                k, ki = jax.random.split(k)
                u = jax.random.uniform(ki, (batch, n), jnp.float32)
                x_hi, z_lo, z_hi = (
                    jnp.float32(v)
                    for v in noise_mod._thresholds_1q(noise.rate_idle))
                dat = jnp.arange(n)
                f = fr.Frames(
                    f.x.at[:, dat].set(f.x[:, dat]
                                       ^ (u < x_hi).astype(jnp.uint8)),
                    f.z.at[:, dat].set(f.z[:, dat]
                                       ^ ((u >= z_lo)
                                          & (u < z_hi)).astype(jnp.uint8)),
                )
            kz, kzm, kzr, kx, kxm, kxr = jax.random.split(k, 6)
            if z_comp is not None:
                f = fr.run_compiled_noisy(f, z_comp, noise, kz)
            else:
                f = fr.run_arrays_noisy(f, *z_arrays, noise, kz)
            f, syn = fr.measure_deviations(f, zanc, kzm, noise.p_meas)
            f = fr.reset_qubits(f, zanc, kzr, noise.p_reset)
            if x_comp is not None:
                f = fr.run_compiled_noisy(f, x_comp, noise, kx)
            else:
                f = fr.run_arrays_noisy(f, *x_arrays, noise, kx)
            f, syn_x = fr.measure_deviations(f, xanc, kxm, noise.p_meas)
            f = fr.reset_qubits(f, xanc, kxr, noise.p_reset)
            return (f, syn, syn_x), (syn ^ prev_z, syn_x ^ prev_x)
        keys = jax.random.split(key, m)
        (f, pz, px), (dz, dx) = jax.lax.scan(body, (f, *prev_syn), keys)
        return f, (pz, px), (jnp.moveaxis(dz, 0, 1), jnp.moveaxis(dx, 0, 1))

    lx = np.asarray(code.x_operator_matrix(), np.uint8) & 1
    key = jax.random.key(seed)
    f = fr.zero_frames(batch, nq)
    prev = (jnp.zeros((batch, rz), jnp.uint8),
            jnp.zeros((batch, rx), jnp.uint8))
    flips = np.zeros((batch, lz.shape[0]), np.uint8)
    carry = np.zeros((batch, W * rz), np.uint8)
    flips_x = np.zeros((batch, lx.shape[0]), np.uint8)
    carry_x = np.zeros((batch, W * rx), np.uint8)
    conv_all = np.ones(batch, bool)

    t0 = time.perf_counter()
    key, k0 = jax.random.split(key)
    f, prev, (buf, buf_x) = sample_chunk(f, prev, k0, W)
    buf = np.asarray(buf, np.uint8)
    buf_x = np.asarray(buf_x, np.uint8)
    sampled, s0 = W, 0  # rounds sampled / layers committed; buf = [s0, sampled)
    while rounds + 1 - s0 > W:
        delta, carry, conv = dec.window_step(buf[:, :W], carry)
        flips ^= delta
        conv_all &= conv
        if dec_x is not None:
            delta, carry_x, conv = dec_x.window_step(buf_x[:, :W], carry_x)
            flips_x ^= delta
            conv_all &= conv
        s0 += C
        m = min(C, rounds - sampled)
        if m:
            key, kc = jax.random.split(key)
            f, prev, fresh = sample_chunk(f, prev, kc, m)
            buf = np.concatenate([buf[:, C:],
                                  np.asarray(fresh[0], np.uint8)], axis=1)
            buf_x = np.concatenate([buf_x[:, C:],
                                    np.asarray(fresh[1], np.uint8)], axis=1)
            sampled += m
        else:
            buf = buf[:, C:]
            buf_x = buf_x[:, C:]
    # perfect final readout of the data deviations
    x_err = np.asarray(f.x, np.uint8)[:, :n]
    final_slice = ((x_err.astype(np.int64) @ hz.T) & 1).astype(np.uint8)
    final_slice ^= np.asarray(prev[0], np.uint8)
    buf = np.concatenate([buf, final_slice[:, None, :]], axis=1)
    fl, conv = dec.final_step(buf, carry)
    flips = (flips ^ fl).astype(np.uint8)
    conv_all &= conv
    if dec_x is not None:
        z_err = np.asarray(f.z, np.uint8)[:, :n]
        final_x = ((z_err.astype(np.int64) @ hx.T) & 1).astype(np.uint8)
        final_x ^= np.asarray(prev[1], np.uint8)
        buf_x = np.concatenate([buf_x, final_x[:, None, :]], axis=1)
        fl, conv = dec_x.final_step(buf_x, carry_x)
        flips_x = (flips_x ^ fl).astype(np.uint8)
        conv_all &= conv
    elapsed = time.perf_counter() - t0

    par = (x_err.astype(np.int64) @ lz.T) & 1
    xf = (flips ^ par).any(axis=1)
    out = {
        "x_fail": float(xf.mean()),
        "bp_all_windows_converged": float(conv_all.mean()),
        "round_shots_per_sec": batch * rounds / elapsed,
        "rounds": rounds,
        "samples": batch,
        "window": W,
        "commit": C,
    }
    if dec_x is not None:
        par_z = (z_err.astype(np.int64) @ lx.T) & 1
        zf = (flips_x ^ par_z).any(axis=1)
        out["z_fail"] = float(zf.mean())
        out["word_fail"] = float((xf | zf).mean())
    return out
