"""Smoke run of the fused sample-and-decode pipelines on one NVIDIA GPU.

Drives the main path once through the package's entry points at the sizes
of the `bench.py` cells, and checks every phase two ways:

(a) the same jitted program, with the same key, on the card and on the CPU
    backend of this process at a reduced batch: integer outputs must be
    bit-identical (Threefry sampling and integer union-find are
    deterministic); BP posteriors agree within a stated tolerance;
(b) the repository's plain reference on a subset of the same shots: host
    union-find (C++), the host streaming decoder, host OSD, and the exact
    Steane failure probability.

Usage (from the repository root, on a machine with a GPU):

    python chip_smoke.py               # phases 1-5 on one card
    python chip_smoke.py --four-cards  # the sharded pipelines, 4-card mesh

Every line but the last describes the run; the last line is one JSON
object ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count":
N}}``. Without a GPU, or if any check fails, the script exits nonzero and
prints no such line.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from functools import partial

import numpy as np

#: per-shot agreement with the host reference, on shots both decoders
#: converged on, and failure-rate difference on the same shots — the bands
#: of tests/test_device_sparse.py and tests/test_device_uf.py
MIN_AGREE = 0.95
MAX_RATE_DIFF = 0.02
#: binomial bands are this many standard deviations wide
Z_BAND = 5.0
#: BP posterior tolerance, card vs CPU, for the 64-iteration decodes:
#: both run float32 at HIGHEST precision, so only the summation order
#: differs; min-sum adds no amplification, so the drift stays far below
#: 1e-3 relative on all but the shots that split at a near-tie
BP_SOFT_RTOL = 1e-3
#: one BP iteration's totals (the scatter matmul alone), card vs CPU:
#: sums of a few float32 messages per variable, so only summation order
#: differs (a few ulp, ~1e-7). Messages rounded to TF32 (10 mantissa
#: bits, ~2^-11 relative) read far above it; the check asserts so.
BP_TOTALS_RTOL = 1e-6
#: OSD-E solutions may differ on float-tied candidates; their soft
#: weights may not (tests/test_bp.py's contract, float32 sums here)
OSDE_WEIGHT_TOL = 1e-4


class CheckFailed(AssertionError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise CheckFailed(msg)


def identical(name: str, a, b) -> int:
    """Assert two integer arrays are bit-identical; return the element
    count compared."""
    a, b = np.asarray(a), np.asarray(b)
    check(a.shape == b.shape, f"{name}: shape {a.shape} vs {b.shape}")
    bad = int(np.count_nonzero(a != b))
    check(bad == 0, f"{name}: {bad} of {a.size} entries differ")
    return int(a.size)


def agreement(name: str, flips_dev, flips_ref, truth, conv=None) -> dict:
    """Per-shot agreement of two decoders' observable flips (any integer
    bitmask per shot) on the shots in ``conv``, and their failure rates
    against ``truth`` on those shots; checks MIN_AGREE / MAX_RATE_DIFF."""
    flips_dev = np.asarray(flips_dev).astype(np.int64)
    flips_ref = np.asarray(flips_ref).astype(np.int64)
    truth = np.asarray(truth).astype(np.int64)
    m = (np.ones(flips_dev.shape[0], bool) if conv is None
         else np.asarray(conv, bool))
    check(m.any(), f"{name}: no converged shots to compare")
    agree = float(np.mean(flips_dev[m] == flips_ref[m]))
    fail_dev = float(np.mean(flips_dev[m] != truth[m]))
    fail_ref = float(np.mean(flips_ref[m] != truth[m]))
    check(agree >= MIN_AGREE,
          f"{name}: agreement {agree} < {MIN_AGREE}")
    check(abs(fail_dev - fail_ref) < MAX_RATE_DIFF,
          f"{name}: failure rates {fail_dev} vs {fail_ref}")
    return {"shots": int(m.sum()), "agree": agree, "fail_dev": fail_dev,
            "fail_ref": fail_ref}


def binomial_band(name: str, k: int, n: int, rate: float) -> dict:
    """Check k failures in n shots against an exact rate, Z_BAND sigma."""
    sigma = float(np.sqrt(rate * (1.0 - rate) / n))
    dev = abs(k / n - rate)
    check(dev <= Z_BAND * sigma + 1.0 / n,
          f"{name}: {k}/{n} = {k / n} vs exact {rate} ({dev / sigma} sigma)")
    return {"rate": k / n, "exact": rate, "sigma": sigma}


def two_sample_band(name: str, k1: int, n1: int, k2: int, n2: int) -> dict:
    """Check two independent failure counts share one rate, Z_BAND sigma
    of the pooled binomial."""
    p = (k1 + k2) / (n1 + n2)
    sigma = float(np.sqrt(max(p * (1 - p), 1.0 / (n1 + n2))
                          * (1.0 / n1 + 1.0 / n2)))
    diff = abs(k1 / n1 - k2 / n2)
    check(diff <= Z_BAND * sigma,
          f"{name}: {k1}/{n1} vs {k2}/{n2} ({diff / sigma} sigma)")
    return {"rate_a": k1 / n1, "rate_b": k2 / n2, "sigma": sigma}


def report(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}, default=_jsonable),
          flush=True)


def _jsonable(x):
    if isinstance(x, (np.ndarray, np.generic)):
        return x.tolist()
    return str(x)


# -- device helpers (JAX imported lazily: importing this module for its
# -- checks must not start a backend) ---------------------------------------


def timed(fn, *args, **kwargs):
    """(result, seconds) with the result ready on its device."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args, **kwargs))
    return out, time.perf_counter() - t0


def cold_warm(fn, *args_cold, args_warm):
    """Call twice with different keys; set-up seconds = the first call
    minus the second (compilation and tracing), run seconds = the
    second."""
    out_c, t_c = timed(fn, *args_cold)
    out_w, t_w = timed(fn, *args_warm)
    return out_c, out_w, {"first_call_s": t_c, "run_s": t_w,
                          "compile_s": max(t_c - t_w, 0.0)}


def memory(jitted, *args) -> dict | None:
    """`compiled.memory_analysis()` of a jitted program, as a dict."""
    ma = jitted.lower(*args).compile().memory_analysis()
    if ma is None:
        return None
    keys = ("argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "alias_size_in_bytes",
            "generated_code_size_in_bytes")
    return {k: int(getattr(ma, k)) for k in keys if hasattr(ma, k)}


def on_cpu(fn, *args):
    """Run ``fn`` with the CPU backend as default device; host results."""
    import jax

    with jax.default_device(jax.devices("cpu")[0]):
        return jax.device_get(fn(*args))


def assert_on(dev, *arrays) -> None:
    for a in arrays:
        check(set(a.devices()) == {dev},
              f"output lives on {a.devices()}, not {dev}")


# -- phase 1: Steane code capacity --------------------------------------------


def steane_exact_word_fail(code, p: float) -> float:
    """Exact word-failure probability of min-weight syndrome decoding of
    both sectors under depolarizing noise p, by enumerating all 4^n
    Pauli errors (n=7: 16384). Independent of the device LUT path: the
    decoder here is 'lightest error with this syndrome', enumerated."""
    n = code.n
    pats = ((np.arange(1 << n)[:, None] >> np.arange(n)[None, :]) & 1
            ).astype(np.int64)                             # [2^n, n]
    w = pats.sum(1)

    def sector_fail(h, logical):
        h = np.asarray(h, np.int64) & 1
        lg = np.asarray(logical, np.int64) & 1
        syn = (pats @ h.T) & 1
        key = syn @ (1 << np.arange(h.shape[0]))
        lightest = {}
        for i in np.argsort(w, kind="stable"):
            lightest.setdefault(int(key[i]), i)
        corr = pats[[lightest[int(k)] for k in key]]
        return (((pats ^ corr) @ lg.T) & 1).any(axis=1)   # [2^n]

    fx = sector_fail(code.parity_check_c2, code.z_operator_matrix())
    fz = sector_fail(code.parity_check_c1, code.x_operator_matrix())
    # weight-1 errors always decode; all weight-2 X patterns flip X̄
    check(not fx[w == 1].any() and fx[w == 2].all(),
          "Steane anchors: weight-1 must decode, weight-2 must fail")
    # P(x pattern, z pattern): per qubit I (1-p), X, Y, Z (p/3 each)
    q = np.array([[1 - p, p / 3], [p / 3, p / 3]])   # q[x bit, z bit]
    probs_x = np.ones((1 << n, 1 << n))
    for j in range(n):
        probs_x *= q[pats[:, j][:, None], pats[:, j][None, :]]
    fail = fx[:, None] | fz[None, :]
    return float(probs_x[fail].sum())


def phase_steane(dev, batch=1 << 22, rounds=64, p=0.01, small=1024):
    import jax
    import jax.numpy as jnp

    from qcss_tpu.codes import families
    from qcss_tpu.decode import montecarlo as mc

    code = families.steane()
    run = partial(mc.mc_decode_rounds, code)
    out, out_w, times = cold_warm(
        run, jax.random.key(1), batch, rounds, p,
        args_warm=(jax.random.key(2), batch, rounds, p))
    assert_on(dev, out["word_fail"])
    d = code.device
    mem = memory(mc._mc_scan, jax.random.key(1), jnp.float32(p), batch,
                 rounds, d.h1, d.h2, d.lut_c1, d.lut_c2, d.logical_x,
                 d.logical_z, d.flip_z_of_lut_c2, d.flip_x_of_lut_c1)

    def small_run():
        res = run(jax.random.key(3), small, rounds, p)
        return {k: v for k, v in res.items()}

    gpu_small = jax.device_get(small_run())
    cpu_small = on_cpu(small_run)
    for k in ("x_fail", "z_fail", "word_fail"):
        identical(f"steane {k}", gpu_small[k], cpu_small[k])
    n = batch * rounds
    exact = steane_exact_word_fail(code, p)
    band = [binomial_band("steane word_fail (cold)", int(out["word_fail"]),
                          n, exact),
            binomial_band("steane word_fail (warm)",
                          int(out_w["word_fail"]), n, exact)]
    report("1 steane code capacity", batch=batch, rounds=rounds, p=p,
           **times, memory=mem, samples_per_s=n / times["run_s"],
           check_a={"cpu_batch": small, "counts": cpu_small},
           check_b=band)


# -- phase 2: d=11 R=11 circuit-level memory, fused sample + decode ----------


def phase_d11(dev, d=11, rounds=11, batch=1 << 14, d_max=48, small=1024,
              host=4096, heavy_groups=3):
    import jax

    from benchmarks.device_uf_bench import build_pipeline
    from qcss_tpu.codes.families import rotated_surface
    from qcss_tpu.decode.uf import UFDecoder
    from qcss_tpu.sim.noise import NoiseModel

    code = rotated_surface(d)
    noise = NoiseModel(p_gate2=2e-3, p_meas=1e-2)
    for decoder in ("sparse", "hybrid"):
        graph, _, fused_j, sample_dets_j, decode_fn = build_pipeline(
            code, rounds, noise, "dem", decoder=decoder, d_max=d_max)
        host_uf = UFDecoder(graph)

        @partial(jax.jit, static_argnames=("b",))
        def per_shot(key, b):
            dets, par = sample_dets_j(key, b, rounds)
            obs, conv = decode_fn(dets)
            return dets, par, obs & 1, conv

        (f_c, conv_c), (f_w, conv_w), times = cold_warm(
            fused_j, jax.random.key(10), batch, rounds,
            args_warm=(jax.random.key(11), batch, rounds))
        assert_on(dev, f_c, conv_c)
        mem = memory(fused_j, jax.random.key(10), batch, rounds)

        # the same shots per shot: the fused count must match exactly
        dets, par, obs, conv = jax.device_get(
            per_shot(jax.random.key(11), batch))
        identical(f"{decoder}: fused count vs per-shot count",
                  int(f_w), int(np.sum(obs ^ par)))
        _, obs_h = host_uf.decode_batch(dets[:host],
                                        want_corrections=False)
        band = agreement(f"d{d} {decoder} vs host UF", obs[:host],
                         np.asarray(obs_h) & 1, par[:host], conv[:host])

        # (a) sampler and decoder, card vs CPU
        samp = jax.device_get(sample_dets_j(jax.random.key(12), small,
                                            rounds))
        samp_c = on_cpu(sample_dets_j, jax.random.key(12), small, rounds)
        n_a = identical(f"{decoder}: detectors", samp[0], samp_c[0])
        identical(f"{decoder}: parities", samp[1], samp_c[1])
        dec_j = jax.jit(decode_fn)
        got = jax.device_get(dec_j(dets[:small]))
        got_c = on_cpu(dec_j, dets[:small])
        identical(f"{decoder}: obs", got[0], got_c[0])
        identical(f"{decoder}: converged", got[1], got_c[1])
        fields = dict(decoder=decoder, batch=batch, d=d, rounds=rounds,
                      detectors=graph.num_nodes, **times, memory=mem,
                      shots_per_s=batch / times["run_s"],
                      fails=int(f_w), all_converged=bool(conv_w),
                      check_a={"cpu_batch": small, "det_bits": n_a},
                      check_b=band)

        if decoder == "hybrid":
            # XOR of independent shots is the detector record of the
            # union of their faults (detectors are linear in faults), so
            # it is a valid heavier-noise batch whose defect counts
            # exceed d_max: the dense rescue must run
            hd, hp = dets.copy(), par.copy()
            for g in range(1, heavy_groups):
                d_g, p_g, _, _ = jax.device_get(
                    per_shot(jax.random.key(20 + g), batch))
                hd ^= d_g
                hp ^= p_g
            over = int(np.sum(hd.sum(axis=1) > d_max))
            check(over > 0, "forced-rescue batch has no overflow shot")
            (obs_r, conv_r), t_r = timed(dec_j, hd)
            _, t_r2 = timed(dec_j, hd)
            assert_on(dev, obs_r)
            obs_r, conv_r = jax.device_get((obs_r & 1, conv_r))
            check(bool(conv_r.all()), "hybrid rescue left shots unconverged")
            got_c = on_cpu(dec_j, hd[:small])
            identical("rescue: obs", obs_r[:small], np.asarray(got_c[0]) & 1)
            identical("rescue: converged", conv_r[:small], got_c[1])
            _, obs_h = host_uf.decode_batch(hd[:host],
                                            want_corrections=False)
            fields["forced_rescue"] = {
                "batch": batch, "overflow_shots": over,
                "mean_defects": float(hd.sum(axis=1).mean()),
                "first_call_s": t_r, "run_s": t_r2,
                "check_b": agreement("rescue vs host UF", obs_r[:host],
                                     np.asarray(obs_h) & 1, hp[:host])}
        report(f"2 d={d} R={rounds} fused {decoder}", **fields)


# -- phase 3: d=11 streaming memory -------------------------------------------


def phase_stream(dev, d=11, batch=1 << 13, rounds=64, p=0.004, small=1024,
                 host=4096):
    import jax

    from qcss_tpu.codes.families import rotated_surface
    from qcss_tpu.decode.device_streaming import (
        DeviceStreamingDecoder,
        stream_memory_rate,
    )
    from qcss_tpu.decode.streaming import (
        StreamingDecoder,
        sample_phenomenological_stream,
    )

    code = rotated_surface(d)
    h, lz = code.raw_parity_check_c2, code.z_operator_matrix()
    run = partial(stream_memory_rate, h, lz, p, p, rounds=rounds)
    out_c, out_w, times = cold_warm(
        lambda s: run(batch=batch, seed=s), 1, args_warm=(2,))

    fa = on_cpu(lambda: run(batch=small, seed=3))
    ga = run(batch=small, seed=3)
    identical("stream fails", round(ga["logical_fail"] * small),
              round(fa["logical_fail"] * small))

    dets, par = sample_phenomenological_stream(
        jax.random.key(4), p, p, host, rounds, h, lz)
    dets, par = np.asarray(dets), np.asarray(par)[:, 0]
    kw = dict(window=8, commit=4, p_space=p, p_time=p)
    dev_dec = DeviceStreamingDecoder(h, lz, **kw)
    obs_d = dev_dec.decode_stream(dets)
    labels, _ = dev_dec._mid_fn(dets[:, :8].reshape(host, -1))
    assert_on(dev, labels[0])
    obs_h = StreamingDecoder(h, lz, **kw).decode_stream(dets)
    band = agreement("stream vs host StreamingDecoder", obs_d & 1,
                     obs_h & 1, par)
    obs_c = on_cpu(lambda: DeviceStreamingDecoder(h, lz, **kw).decode_stream(
        dets[:small // 4]))
    n_win = identical("stream per-shot obs", obs_d[:small // 4], obs_c)
    report(f"3 d={d} streaming memory", batch=batch, rounds=rounds,
           reduced=f"rounds 800 -> {rounds} (window state is independent "
                   "of R)",
           **times, round_shots_per_s=rounds * batch / times["run_s"],
           logical_fail=out_w["logical_fail"],
           check_a={"cpu_batch": small, "fails": round(
               fa["logical_fail"] * small), "per_shot_obs": n_win},
           check_b=band)


# -- phase 4: compiled logical CNOT at d=3 ------------------------------------


def phase_cnot(dev, d=3, batch=1 << 15, reps=4, p=2e-3, small=1024,
               host=4096):
    import jax
    import jax.numpy as jnp

    from qcss_tpu.decode.uf import UFDecoder
    from qcss_tpu.experiments import patches as P
    from qcss_tpu.experiments.logical import LogicalProgram
    from qcss_tpu.experiments.surgery import _sample

    prog = LogicalProgram(d, 2).cnot(0, 1)
    model = prog.build(p=None, q=None)
    for decoder, kind in (("device-uf-sparse", "hybrid"),
                          ("device-uf", "dense")):
        run = partial(prog.run, p, decoder=decoder)
        out_c, out_w, times = cold_warm(
            lambda s: run(batch=batch, reps=reps, seed=s), 0, args_warm=(1,))
        runner = P._device_runner(model, batch, p, p, kind)
        po, _, _ = runner(jax.random.key(1), reps)
        assert_on(dev, po)
        mem = memory(runner, jax.random.key(1), reps)

        keys = [k for k in out_w if k.endswith("_fail")]
        ga = run(batch=small, reps=1, seed=5)
        fa = on_cpu(lambda: run(batch=small, reps=1, seed=5))
        identical(f"cnot {kind} fail counts",
                  [round(ga[k] * small) for k in keys],
                  [round(fa[k] * small) for k in keys])

        # the warm run's first rep, shot by shot, against host union-find
        decode_fn = P.device_decode_fn(model, p, p, kind)
        n_obs = model.obs.shape[0]
        bits = 1 << np.arange(n_obs)

        @jax.jit
        def per_shot(key):
            dets, ob = _sample(
                key, jnp.float32(p), jnp.float32(p), batch,
                jnp.asarray(model.fault_probs_class),
                jnp.asarray(model.F.T.astype(np.int32)),
                jnp.asarray(model.obs.T.astype(np.int32)))
            flips, conv = decode_fn(dets)
            return dets, ob, flips, conv

        dets, ob, flips, conv = jax.device_get(
            per_shot(jax.random.fold_in(jax.random.key(1), 0)))
        truth = (ob.astype(np.int64) * bits[None, :]).sum(axis=1)
        _, flips_h = UFDecoder(model.graph).decode_batch(
            dets[:host], want_corrections=False)
        band = agreement(f"cnot {kind} vs host UF", flips[:host],
                         flips_h, truth[:host], conv[:host])
        report(f"4 d={d} compiled CNOT {decoder}", batch=batch, reps=reps,
               **times, memory=mem,
               shots_per_s=batch * reps / times["run_s"],
               word_fail=out_w["word_fail"],
               check_a={"cpu_batch": small,
                        "counts": [round(fa[k] * small) for k in keys]},
               check_b=band)


# -- phase 5: BP+OSD on the [[144,12,12]] bivariate-bicycle code --------------


def phase_bposd(dev, batch=1 << 12, p=0.06, small=1024, tail_max=1024):
    import jax
    import jax.numpy as jnp

    from qcss_tpu.codes import families
    from qcss_tpu.decode.bp import BPDecoder
    from qcss_tpu.decode.montecarlo import sample_depolarizing
    from qcss_tpu.ops import gf2_jax

    code = families.bb144()
    h = np.asarray(getattr(code, "redundant_parity_check_c2",
                           code.parity_check_c2), np.uint8)
    lz = np.asarray(code.z_operator_matrix(), np.uint8)
    prior = 2.0 * p / 3.0

    def syndromes(seed, b):
        x_err, _ = sample_depolarizing(jax.random.key(seed), b, code.n, p)
        syn = gf2_jax.syndromes_dense(x_err, jnp.asarray(h))
        return syn, (np.asarray(x_err, np.int64) @ lz.T.astype(np.int64)) & 1

    fields = {}
    for name, kw in (("osd0", {}), ("osdE", {"osd_order": 2})):
        dec = BPDecoder(h, prior, logicals=lz, osd_backend="device", **kw)
        (s1, t1), (s2, t2) = syndromes(30, batch), syndromes(31, batch)
        (fl1, _), (fl2, cv2), times = cold_warm(
            dec.decode_obs, s1, args_warm=(s2,))
        fields[name] = {**times, "shots_per_s": batch / times["run_s"],
                        "word_fail": float(np.mean((fl2 != t2).any(1))),
                        "bp_converged": float(np.mean(cv2))}
    mem = memory(dec._run, s2)

    # (a) BP on the card vs the CPU backend, same syndromes
    e_g, conv_g, soft_g = jax.device_get(dec._run(s2[:small]))
    e_c, conv_c, soft_c = on_cpu(dec._run, np.asarray(s2[:small]))
    same_conv = conv_g == conv_c
    both = same_conv & conv_g
    # per shot: max relative posterior difference. Float sums run in
    # another order on the card; a near-tie can then flip one message's
    # sign and send that shot down another min-sum trajectory (frozen at
    # another iteration), so the tolerance holds per shot on all but a
    # few shots, not on every one
    rel = np.max(np.abs(soft_g - soft_c) / (1.0 + np.abs(soft_c)), axis=1)
    soft_agree = float(np.mean(rel[both] <= BP_SOFT_RTOL))
    check(float(same_conv.mean()) >= 0.99,
          f"BP converged flags agree on {same_conv.mean()}")
    check(soft_agree >= MIN_AGREE,
          f"BP posteriors within {BP_SOFT_RTOL} on {soft_agree} of shots")
    dec0 = BPDecoder(h, prior, logicals=lz, osd_backend="device")
    fg = dec0.decode_obs(np.asarray(s2[:small]))[0]
    fc = on_cpu(lambda: dec0.decode_obs(np.asarray(s2[:small]))[0])
    osd_agree = float(np.mean((np.asarray(fg) == np.asarray(fc)).all(1)))
    check(osd_agree >= MIN_AGREE, f"BP+OSD decisions agree on {osd_agree}")

    # (b) device OSD vs host OSD on the BP tail of the warm batch
    _, conv, soft = jax.device_get(dec._run(s2))
    tail = np.nonzero(~np.asarray(conv))[0][:tail_max]
    check(tail.size > 0, "BP converged everywhere: no OSD tail to check")
    syn_t = np.asarray(s2)[tail]
    soft_t = np.asarray(soft)[tail]
    n0 = identical("OSD-0 device vs host", dec0._osd0_any(syn_t, soft_t),
                   dec0._osd0(syn_t, soft_t))
    e_dev = dec._osde_device(syn_t, soft_t, min(dec.n, dec.r + 256))
    e_host = dec._osde_any(syn_t, soft_t)
    check(bool((((e_dev.astype(np.int64) @ h.T) & 1) == syn_t).all()),
          "device OSD-E solution misses the syndrome")
    w = np.abs(soft_t.astype(np.float64))
    wd, wh = (w * e_dev).sum(1), (w * e_host).sum(1)
    werr = float(np.max(np.abs(wd - wh) / (1.0 + wh)))
    check(werr <= OSDE_WEIGHT_TOL, f"OSD-E soft weights differ by {werr}")
    report("5 bb144 BP+OSD code capacity", batch=batch, p=p, **fields,
           memory=mem,
           check_a={"cpu_batch": small,
                    "conv_agree": float(same_conv.mean()),
                    "soft_within_tol": soft_agree,
                    "soft_median_rel": float(np.median(rel[both])),
                    "hard_decision_agree": float(np.mean(
                        (e_g == e_c).all(axis=1))),
                    "osd_decision_agree": osd_agree},
           check_b={"tail": int(tail.size), "osd0_bits_identical": n0,
                    "osdE_solution_agree": float(np.mean(
                        (e_dev == e_host).all(1))),
                    "osdE_weight_max_rel": werr})


# -- the precision-pinned contractions ----------------------------------------


def tf32(x) -> np.ndarray:
    """``x`` rounded to TF32 (10 stored mantissa bits, to nearest), as a
    TF32 matmul reads its float32 inputs."""
    u = np.array(x, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def bp_one_iteration_totals(h, lam, synd, alpha, round_to_tf32=False):
    """Variable totals after one normalized min-sum iteration from zero
    messages (what `BPDecoder` reports with ``iters=1``), summed in
    float64 on the host from the float32 messages; ``round_to_tf32``
    rounds the messages first, as an unpinned matmul on the card would."""
    lam = np.asarray(lam, np.float32)
    synd = np.asarray(synd, np.int64)
    tot = np.tile(lam.astype(np.float64), (synd.shape[0], 1))
    for c in range(h.shape[0]):
        vs = np.nonzero(h[c])[0]
        for j, v in enumerate(vs):
            others = np.delete(vs, j)
            val = np.abs(lam[others]).min()
            neg = (int((lam[others] < 0).sum()) + synd[:, c]) & 1
            m = np.float32(alpha) * np.where(neg == 1, -val, val).astype(
                np.float32)
            tot[:, v] += (tf32(m) if round_to_tf32 else m).astype(np.float64)
    return tot


def phase_contractions(dev) -> dict:
    """Each contraction that must be exact (or near-exact) on the card,
    against an exact host value: the GF(2) matmul, the sparse-UF APSP
    fetch with distances above 2^11, the OSD-E word select with 16-bit
    halves, the ML coset scores, and the BP variable totals."""
    import jax
    import jax.numpy as jnp

    from qcss_tpu.codes.families import rotated_surface
    from qcss_tpu.decode import bp, device_sparse
    from qcss_tpu.decode.mld import MLDecoder
    from qcss_tpu.decode.uf import graph_from_checks

    from qcss_tpu.ops import gf2_jax

    rng = np.random.default_rng(0)
    out = {}

    # GF(2) matmul at the shapes where an int8 GEMM went wrong on the card
    for B, K, N in ((1024, 7, 3), (1024, 3, 7), (4096, 121, 60),
                    (2048, 721, 5)):
        a = (rng.random((B, K)) < 0.3).astype(np.uint8)
        b = (rng.random((K, N)) < 0.5).astype(np.uint8)
        got = jax.device_get(jax.jit(gf2_jax.mod2_matmul)(a, b))
        identical(f"mod2_matmul {B}x{K}x{N}", got,
                  (a.astype(np.int64) @ b.astype(np.int64)) & 1)
    out["mod2_matmul_shapes"] = 4

    # sparse fetch: odd weights near 255 make distances > 2048 that TF32
    # (11 significant bits) cannot hold
    code = rotated_surface(11)
    g = graph_from_checks(code.raw_parity_check_c2, code.z_operator_matrix())
    g = g.__class__(num_nodes=g.num_nodes, edges=g.edges,
                    edge_qubit=g.edge_qubit, edge_obs=g.edge_obs,
                    n_qubits=g.n_qubits,
                    edge_weight=(231 + 2 * rng.integers(0, 13, g.num_edges)
                                 ).astype(np.uint8))
    t = device_sparse.build_sparse_tables(g)
    check(int(t.dist[t.dist < device_sparse.UNREACH].max()) > 2048,
          "test graph has no distance above 2^11")
    tables = (jnp.asarray(t.dist), jnp.asarray(t.phi.astype(np.int32)),
              jnp.asarray(t.bdist), jnp.asarray(t.bside.astype(np.int32)))
    D = 16
    dets = (rng.random((256, g.num_nodes)) < 0.05).astype(np.uint8)
    dm, bdm, phim, bsm, valid, _ = jax.device_get(jax.jit(
        device_sparse._fetch_geometry, static_argnums=1)(tables, D, dets))
    idx = np.full((256, D), -1)
    for b in range(256):
        nz = np.nonzero(dets[b])[0][:D]
        idx[b, :nz.size] = nz
    ok = idx >= 0
    ii = np.where(ok, idx, 0)
    want = np.where(ok[:, :, None] & ok[:, None, :]
                    & ~np.eye(D, dtype=bool)[None],
                    t.dist[ii[:, :, None], ii[:, None, :]],
                    device_sparse.UNREACH)
    out["sparse_fetch_entries"] = identical("sparse APSP fetch", dm, want)
    identical("sparse bdist fetch", bdm,
              np.where(ok, t.bdist[ii], device_sparse.UNREACH))
    identical("sparse phi fetch", np.where(ok, phim, 0),
              np.where(ok, t.phi[ii].astype(np.int64), 0))

    # OSD-E word select: random uint32 words, halves up to 2^16
    r, n, B = 40, 110, 64
    hm = (rng.random((r, n)) < 0.1).astype(np.uint8)
    synd = ((rng.random((B, n)) < 0.06).astype(np.uint8) @ hm.T) & 1
    soft = rng.normal(0, 1, (B, n)).astype(np.float32)
    f = jax.jit(bp._osde_device_kernel, static_argnums=(3, 4, 5, 6))
    args = (jnp.asarray(hm.T), jnp.asarray(synd), jnp.asarray(soft),
            min(n, r + 256), 2, 12, 8)
    e_g = jax.device_get(f(*args))
    e_c = on_cpu(lambda: f(jnp.asarray(hm.T), jnp.asarray(synd),
                           jnp.asarray(soft), *args[3:]))
    out["osde_bits"] = identical("OSD-E card vs CPU", e_g[0], e_c[0])

    # ML coset scores against a float64 host sum
    ml = MLDecoder.for_code(rotated_surface(3), p=0.05)
    syn = (rng.random((128, ml.h.shape[0])) < 0.3).astype(np.uint8)
    eL = ml._representatives(syn)
    llr = np.full((128, ml.n), np.log(0.05 / 0.95), np.float32)
    llr += rng.normal(0, 0.5, llr.shape).astype(np.float32)
    got = np.asarray(ml._scorer()(jnp.asarray(eL), jnp.asarray(llr)))
    cos = ml._coset.astype(np.float64)                    # [G, n]
    tot = ((eL[:, None, :] ^ cos[None].astype(np.uint8)).astype(np.float64)
           * llr[:, None, :].astype(np.float64)).sum(-1)
    ref = np.log(np.exp(tot - tot.max(1, keepdims=True)).sum(1)) + tot.max(1)
    err = float(np.max(np.abs(got - ref) / (1 + np.abs(ref))))
    check(err <= 1e-5, f"ML coset scores off by {err} relative")
    out["ml_score_max_rel"] = err

    # BP totals (the scatter matmul): one iteration, card vs CPU, with
    # random priors so the messages vary; the same totals with the
    # messages rounded to TF32 must read above the limit, so the check
    # tells HIGHEST from TF32
    h5 = np.asarray(rotated_surface(5).raw_parity_check_c2, np.uint8)
    dec = bp.BPDecoder(h5, rng.uniform(0.01, 0.1, h5.shape[1]), iters=1,
                       layout="dense")
    synd = ((rng.random((64, dec.n)) < 0.05).astype(np.uint8) @ h5.T) & 1
    _, _, soft = jax.device_get(dec._run(jnp.asarray(synd)))
    _, _, soft_c = on_cpu(dec._run, synd)

    def rel_to_cpu(x):
        return float(np.max(np.abs(x - soft_c) / (1 + np.abs(soft_c))))

    rel = rel_to_cpu(soft)
    lam = np.asarray(dec._lam)
    rel_host = rel_to_cpu(bp_one_iteration_totals(h5, lam, synd, dec.alpha))
    rel_tf32 = rel_to_cpu(bp_one_iteration_totals(h5, lam, synd, dec.alpha,
                                                  round_to_tf32=True))
    check(rel_host <= BP_TOTALS_RTOL, f"BP totals host model off {rel_host}")
    check(rel_tf32 > BP_TOTALS_RTOL,
          f"BP totals limit {BP_TOTALS_RTOL} passes TF32 ({rel_tf32})")
    check(rel <= BP_TOTALS_RTOL, f"BP totals card vs CPU {rel}")
    out["bp_totals_max_rel"] = rel
    out["bp_totals_tf32_max_rel"] = rel_tf32
    report("0 precision-pinned contractions", **out)
    return out


# -- four cards ---------------------------------------------------------------


def phase_four_cards(devs, d=11, rounds=11, local=1 << 14, d_max=48,
                     steane_local=1 << 20, p=0.01, p_gate2=6e-3):
    import jax
    import jax.numpy as jnp

    from qcss_tpu.codes import families
    from qcss_tpu.decode import montecarlo as mc
    from qcss_tpu.parallel import ShardedFrameMemory, make_mesh
    from qcss_tpu.parallel.mesh import sharded_mc_step
    from qcss_tpu.sim.noise import NoiseModel

    n = len(devs)
    mesh_n, mesh_1 = make_mesh(n), make_mesh(1)
    # three times the operating gate noise: failures to count, and shots
    # past d_max, so the dense rescue's lax.cond runs inside shard_map
    noise = NoiseModel(p_gate2=p_gate2, p_meas=1e-2)
    code = families.rotated_surface(d)
    total = n * local
    mem_n = ShardedFrameMemory(code, noise, mesh_n)
    run_n = partial(mem_n.fused_error_rate, rounds=rounds, batch=total,
                    decoder="hybrid", d_max=d_max)
    res_c, res_w, times = cold_warm(lambda s: run_n(seed=s), 40,
                                    args_warm=(41,))
    fails_n = round(res_w["logical_fail"] * total)
    # exact reference: the same per-shard programs, one after another on
    # one card (shard i samples from fold_in(key, i))
    shard = jax.jit(mem_n.fused_shard_fn(local, rounds, "dem", "hybrid",
                                         d_max))
    key = jax.random.key(41)
    with jax.default_device(devs[0]):
        ref = sum(int(shard(jax.random.fold_in(key, i))[0])
                  for i in range(n))
    identical(f"{n}-card fused count vs per-shard reference", fails_n, ref)
    res_1, t_1 = timed(
        ShardedFrameMemory(code, noise, mesh_1).fused_error_rate,
        rounds=rounds, batch=total, seed=42, decoder="hybrid", d_max=d_max)
    band = two_sample_band("fused hybrid 4-card vs 1-card", fails_n, total,
                           round(res_1["logical_fail"] * total), total)
    report(f"4cards d={d} fused hybrid", cards=n, batch=total, **times,
           shots_per_s=total / times["run_s"],
           one_card={"first_call_s": t_1, "logical_fail":
                     res_1["logical_fail"]},
           exact={"fails": fails_n, "per_shard_reference": ref},
           band=band)

    steane = families.steane()
    sb = n * steane_local
    cn, t_n = timed(sharded_mc_step, steane, mesh_n, jax.random.key(50),
                    sb, p)
    cn2, t_n2 = timed(sharded_mc_step, steane, mesh_n, jax.random.key(50),
                      sb, p)
    dv = steane.device
    ref = {k: 0 for k in cn}
    with jax.default_device(devs[0]):
        for i in range(n):
            c = mc._mc_step(jax.random.fold_in(jax.random.key(50), i),
                            jnp.float32(p), steane_local, dv.h1, dv.h2,
                            dv.lut_c1, dv.lut_c2, dv.logical_x,
                            dv.logical_z, dv.flip_z_of_lut_c2,
                            dv.flip_x_of_lut_c1)
            for k in ref:
                ref[k] += int(c[k])
    identical(f"{n}-card mc counts vs per-shard reference",
              [int(cn[k]) for k in sorted(ref)], [ref[k] for k in sorted(ref)])
    c1, t_1 = timed(sharded_mc_step, steane, mesh_1, jax.random.key(51),
                    sb, p)
    band = two_sample_band("steane mc 4-card vs 1-card",
                           int(cn["word_fail"]), sb, int(c1["word_fail"]), sb)
    report(f"4cards steane sharded_mc_step", cards=n, batch=sb,
           first_call_s=t_n, run_s=t_n2, samples_per_s=sb / t_n2,
           one_card_run_s=t_1, exact=ref, band=band)


# -- entry point --------------------------------------------------------------


def gpu_devices():
    """The process's devices; exits nonzero unless they are GPUs."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"no GPU: JAX found {devs[0].platform} devices only",
              file=sys.stderr)
        sys.exit(2)
    return devs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded pipelines over a 4-card "
                    "mesh and their one-card comparison")
    args = ap.parse_args(argv)
    devs = gpu_devices()
    import jax

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    for line in smi.stdout.strip().splitlines():
        print(f"nvidia-smi: {line}")
    print(f"jax {jax.__version__}; XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}; "
          f"JAX_COMPILATION_CACHE_DIR="
          f"{os.environ.get('JAX_COMPILATION_CACHE_DIR', '')!r}", flush=True)
    t0 = time.perf_counter()
    if args.four_cards:
        check(len(devs) >= 4, f"--four-cards needs 4 GPUs, found {len(devs)}")
        devs = devs[:4]
        phase_four_cards(devs)
    else:
        devs = devs[:1]
        for phase in (phase_contractions, phase_steane, phase_d11,
                      phase_stream, phase_cnot, phase_bposd):
            print(f"[{time.perf_counter() - t0:.1f} s] {phase.__name__}",
                  flush=True)
            phase(devs[0])
    print(f"total {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
