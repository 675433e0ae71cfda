"""`chip_smoke.py` without a card: its refusal to run on the CPU, its
checks and bands, and its phases at toy sizes on the CPU backend (the
card run compares the same programs across backends; here both sides are
the CPU, which exercises the plumbing)."""

from __future__ import annotations

import os
import subprocess
import sys

import jax
import numpy as np
import pytest

import chip_smoke as cs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_exits_nonzero_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_exits_nonzero_alone_in_a_directory(tmp_path):
    """Copied away from the package, the script cannot pass."""
    (tmp_path / "chip_smoke.py").write_text(
        open(os.path.join(ROOT, "chip_smoke.py")).read())
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


@pytest.mark.parametrize("b,ok", [([1, 2, 3], True), ([1, 2, 4], False),
                                  ([1, 2], False)])
def test_identical(b, ok):
    if ok:
        assert cs.identical("x", [1, 2, 3], b) == 3
    else:
        with pytest.raises(cs.CheckFailed):
            cs.identical("x", [1, 2, 3], b)


def _agreement_case(n_disagree, n_wrong_ref):
    truth = np.zeros(1000, np.int64)
    dev = np.zeros(1000, np.int64)
    ref = np.zeros(1000, np.int64)
    ref[:n_disagree] = 1          # ref wrong where it disagrees
    dev[n_disagree:n_disagree + n_wrong_ref] = 1
    ref[n_disagree:n_disagree + n_wrong_ref] = 1
    return dev, ref, truth


@pytest.mark.parametrize("n_disagree,n_wrong,ok", [
    (10, 0, True),        # 99% agreement, rates 0 vs 1%
    (60, 0, False),       # 94% agreement < MIN_AGREE
    (40, 0, False),       # 96% agreement, rate difference 0.04
])
def test_agreement_band(n_disagree, n_wrong, ok):
    dev, ref, truth = _agreement_case(n_disagree, n_wrong)
    if ok:
        res = cs.agreement("t", dev, ref, truth)
        assert res["shots"] == 1000 and res["agree"] == 0.99
    else:
        with pytest.raises(cs.CheckFailed):
            cs.agreement("t", dev, ref, truth)


def test_agreement_masks_unconverged():
    dev, ref, truth = _agreement_case(60, 0)
    conv = np.ones(1000, bool)
    conv[:60] = False
    assert cs.agreement("t", dev, ref, truth, conv)["shots"] == 940


@pytest.mark.parametrize("k,ok", [(1000, True), (1150, True), (1300, False)])
def test_binomial_band(k, ok):
    # n = 1e6 at rate 1e-3: sigma ~ 31.6 failures
    if ok:
        cs.binomial_band("t", k, 10 ** 6, 1e-3)
    else:
        with pytest.raises(cs.CheckFailed):
            cs.binomial_band("t", k, 10 ** 6, 1e-3)


@pytest.mark.parametrize("k2,ok", [(1050, True), (1400, False)])
def test_two_sample_band(k2, ok):
    if ok:
        cs.two_sample_band("t", 1000, 10 ** 6, k2, 10 ** 6)
    else:
        with pytest.raises(cs.CheckFailed):
            cs.two_sample_band("t", 1000, 10 ** 6, k2, 10 ** 6)


def test_steane_exact_rate_anchors():
    """The exact enumeration reproduces the leading order at small p and
    vanishes at p = 0. Leading order: each sector fails on its 21 weight-2
    patterns, P = 21 (2p/3)^2 per sector, and a YY pair fails both, so
    P(word) = 2 * 21 * (2p/3)^2 - 21 (p/3)^2 = 21 * 7 p^2 / 9."""
    from qcss_tpu.codes import families

    code = families.steane()
    assert cs.steane_exact_word_fail(code, 0.0) == 0.0
    p = 1e-4
    lead = 21 * 7 * p ** 2 / 9
    assert abs(cs.steane_exact_word_fail(code, p) / lead - 1) < 0.01


@pytest.mark.parametrize("x,want", [
    (1.0, 1.0),
    (1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10),   # 10 mantissa bits: kept
    (1.0 + 2.0 ** -12, 1.0),                # below half a TF32 ulp
    (1.0 + 3 * 2.0 ** -12, 1.0 + 2.0 ** -10),  # above half: rounds up
    (-3.0 - 2.0 ** -20, -3.0),
])
def test_tf32_rounding(x, want):
    assert float(cs.tf32(np.float32(x))) == want


def test_bp_totals_host_model_and_tf32_reading():
    """The host model of one BP iteration reproduces `BPDecoder`'s
    totals within BP_TOTALS_RTOL, and the same totals from TF32-rounded
    messages fail that limit (the old 1e-3 band would have passed them)."""
    from qcss_tpu.codes.families import rotated_surface
    from qcss_tpu.decode.bp import BPDecoder

    rng = np.random.default_rng(1)
    h = np.asarray(rotated_surface(5).raw_parity_check_c2, np.uint8)
    dec = BPDecoder(h, rng.uniform(0.01, 0.1, h.shape[1]), iters=1,
                    layout="dense")
    synd = ((rng.random((32, dec.n)) < 0.05).astype(np.uint8) @ h.T) & 1
    soft = np.asarray(dec._run(synd)[2], np.float64)
    lam = np.asarray(dec._lam)

    def rel(x):
        return np.max(np.abs(x - soft) / (1 + np.abs(soft)))

    assert rel(cs.bp_one_iteration_totals(h, lam, synd, dec.alpha)) \
        <= cs.BP_TOTALS_RTOL
    assert rel(cs.bp_one_iteration_totals(
        h, lam, synd, dec.alpha, round_to_tf32=True)) > cs.BP_TOTALS_RTOL


def test_phase_contractions_on_cpu(capsys):
    out = cs.phase_contractions(jax.devices()[0])
    assert out["bp_totals_max_rel"] == 0.0  # same backend, same program
    assert out["bp_totals_tf32_max_rel"] > cs.BP_TOTALS_RTOL
    assert "precision-pinned" in capsys.readouterr().out


def test_phase_steane_on_cpu(capsys):
    dev = jax.devices()[0]
    cs.phase_steane(dev, batch=1 << 12, rounds=4, small=256)
    assert '"phase": "1 steane' in capsys.readouterr().out


def test_phase_fused_memory_on_cpu(capsys):
    dev = jax.devices()[0]
    cs.phase_d11(dev, d=3, rounds=3, batch=256, d_max=3, small=64,
                 host=128)
    out = capsys.readouterr().out
    assert "fused sparse" in out and "forced_rescue" in out


@pytest.mark.gpu
def test_main_path_on_gpu(gpu_device):
    """The fused memory phase at toy size on a card: card vs CPU
    bit-identity and the host-UF band."""
    with jax.default_device(gpu_device):
        cs.phase_d11(gpu_device, d=5, rounds=5, batch=1024, d_max=16,
                     small=256, host=512)
