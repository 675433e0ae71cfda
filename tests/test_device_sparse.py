"""Sparse-defect (defect-granular) device UF decoder.

Exactness on all weight <= t errors (unique-decoding regime), statistical
agreement with the host union-find at operating load on weighted
circuit-level DEM graphs, overflow/hybrid composition, and the refusal
path for graphs without an observable potential (toric wrap).
"""

from itertools import combinations

import jax.numpy as jnp
import numpy as np
import pytest

from qcss_tpu.codes.families import rotated_surface, toric
from qcss_tpu.decode.device_sparse import (
    build_sparse_tables,
    make_hybrid_obs_decoder,
    make_sparse_obs_decoder,
)
from qcss_tpu.decode.device_uf import make_obs_decoder
from qcss_tpu.decode.uf import UFDecoder, graph_from_checks, spacetime_graph


def _surface_graph(d):
    code = rotated_surface(d)
    return code, graph_from_checks(
        code.raw_parity_check_c2, code.z_operator_matrix())


@pytest.mark.parametrize("d", [3, 5])
def test_exhaustive_low_weight_exact(d):
    code, g = _surface_graph(d)
    h = np.asarray(code.raw_parity_check_c2, np.uint8)
    lz = np.asarray(code.z_operator_matrix(), np.uint8)
    n = h.shape[1]
    t = (d - 1) // 2
    errs = []
    for w in range(0, t + 1):
        for qs in combinations(range(n), w):
            e = np.zeros(n, np.uint8)
            e[list(qs)] = 1
            errs.append(e)
    errs = np.stack(errs)
    syn = (errs @ h.T) & 1
    par = ((errs @ lz.T) & 1)[:, 0].astype(np.int64)

    decode = make_sparse_obs_decoder(g, d_max=16)
    assert decode is not None
    obs, conv = decode(jnp.asarray(syn))
    assert bool(np.all(np.asarray(conv)))
    np.testing.assert_array_equal(np.asarray(obs) & 1, par)


def _sample_edge_errors(g, p_edge, B, seed):
    """Real matching instances: fire edges IID, detectors = endpoint XOR,
    true observable = XOR of fired edges' labels."""
    rng = np.random.default_rng(seed)
    edges = np.asarray(g.edges)
    obs = np.asarray(g.edge_obs, np.uint32)
    fired = rng.random((B, edges.shape[0])) < p_edge
    dets = np.zeros((B, g.num_nodes), np.uint8)
    for side in (0, 1):
        v = edges[:, side]
        m = v >= 0
        for b in range(B):
            np.bitwise_xor.at(dets[b], v[m], fired[b, m].astype(np.uint8))
    truth = np.bitwise_xor.reduce(
        np.where(fired, obs[None, :], 0), axis=1).astype(np.int64)
    return dets, truth


def test_spacetime_agreement_with_host_uf():
    d, rounds = 7, 7
    code = rotated_surface(d)
    h = np.asarray(code.raw_parity_check_c2, np.uint8)
    g = spacetime_graph(h, code.z_operator_matrix(), rounds)
    B = 512
    dets, truth = _sample_edge_errors(g, 0.005, B, seed=11)
    _, obs_host = UFDecoder(g).decode_batch(dets, want_corrections=False)
    decode = make_sparse_obs_decoder(g, d_max=32)
    assert decode is not None
    obs, conv = decode(jnp.asarray(dets))
    obs = np.asarray(obs)
    conv = np.asarray(conv)
    assert conv.mean() > 0.99
    fail_s = ((obs ^ truth) & 1)[conv].mean()
    fail_h = ((np.asarray(obs_host).astype(np.int64) ^ truth) & 1)[conv].mean()
    # statistically interchangeable at operating load: failure rates agree
    # within a small absolute margin (ties between degenerate matchings may
    # break differently — both are valid min-weight decoders)
    assert abs(fail_s - fail_h) < 0.02
    agree = (obs[conv] & 1) == (np.asarray(obs_host)[conv] & 1)
    assert agree.mean() > 0.95


def test_weighted_dem_graph_agreement():
    from qcss_tpu.decode.dem import circuit_level_graph, extraction_gate_list
    from qcss_tpu.sim.noise import NoiseModel

    d, rounds = 5, 5
    code = rotated_surface(d)
    raw = code.raw_parity_check_c2
    noise = NoiseModel(p_gate2=2e-3, p_meas=1e-2)
    g = circuit_level_graph(
        raw, extraction_gate_list(code, raw), rounds,
        p_gate2=noise.p_gate2, p_meas=noise.p_meas,
        p_reset=noise.p_reset, logicals=code.z_operator_matrix())
    B = 512
    dets, truth = _sample_edge_errors(g, 0.01, B, seed=5)
    _, obs_host = UFDecoder(g).decode_batch(dets, want_corrections=False)
    decode = make_sparse_obs_decoder(g, d_max=32)
    assert decode is not None
    obs, conv = decode(jnp.asarray(dets))
    obs, conv = np.asarray(obs), np.asarray(conv)
    assert conv.mean() > 0.99
    fail_s = ((obs ^ truth) & 1)[conv].mean()
    fail_h = ((np.asarray(obs_host).astype(np.int64) ^ truth) & 1)[conv].mean()
    assert abs(fail_s - fail_h) < 0.02
    agree = (obs[conv] & 1) == (np.asarray(obs_host)[conv] & 1)
    assert agree.mean() > 0.95


def test_overflow_reports_unconverged_and_hybrid_rescues():
    code, g = _surface_graph(5)
    rng = np.random.default_rng(3)
    B = 64
    dets = (rng.random((B, g.num_nodes)) < 0.5).astype(np.uint8)
    # tiny d_max: most shots overflow
    sparse = make_sparse_obs_decoder(g, d_max=2)
    obs_s, conv_s = sparse(jnp.asarray(dets))
    assert not bool(np.all(np.asarray(conv_s)))

    hybrid = make_hybrid_obs_decoder(g, d_max=2)
    dense = make_obs_decoder(g)
    obs_h, conv_h = hybrid(jnp.asarray(dets))
    obs_d, conv_d = dense(jnp.asarray(dets))
    obs_h, conv_h = np.asarray(obs_h), np.asarray(conv_h)
    obs_d, conv_d = np.asarray(obs_d), np.asarray(conv_d)
    np.testing.assert_array_equal(conv_h, conv_d | np.asarray(conv_s))
    # wherever sparse overflowed, the hybrid result is the dense result
    ovf = ~np.asarray(conv_s)
    np.testing.assert_array_equal(obs_h[ovf], obs_d[ovf])


def test_hybrid_quiet_batch_skips_dense():
    # all shots within d_max -> hybrid == sparse exactly
    code, g = _surface_graph(3)
    h = np.asarray(code.raw_parity_check_c2, np.uint8)
    e = np.zeros((4, h.shape[1]), np.uint8)
    e[1, 0] = 1
    e[2, 3] = 1
    syn = (e @ h.T) & 1
    sparse = make_sparse_obs_decoder(g, d_max=8)
    hybrid = make_hybrid_obs_decoder(g, d_max=8)
    obs_s, conv_s = sparse(jnp.asarray(syn))
    obs_h, conv_h = hybrid(jnp.asarray(syn))
    assert bool(np.all(np.asarray(conv_s)))
    np.testing.assert_array_equal(np.asarray(obs_h), np.asarray(obs_s))
    np.testing.assert_array_equal(np.asarray(conv_h), np.asarray(conv_s))


def test_toric_refuses_sparse_path():
    code = toric(4)
    g = graph_from_checks(code.raw_parity_check_c2,
                          code.z_operator_matrix())
    assert build_sparse_tables(g) is None
    assert make_sparse_obs_decoder(g) is None
    # hybrid degrades gracefully to the dense kernel
    hybrid = make_hybrid_obs_decoder(g)
    assert hybrid is not None


def test_zero_defect_shots():
    _, g = _surface_graph(3)
    dets = np.zeros((3, g.num_nodes), np.uint8)
    decode = make_sparse_obs_decoder(g, d_max=4)
    obs, conv = decode(jnp.asarray(dets))
    np.testing.assert_array_equal(np.asarray(obs), 0)
    assert bool(np.all(np.asarray(conv)))


def test_compiled_program_sparse_decoder():
    """The fused logical-program pipeline accepts the defect-granular
    decoder (`decoder='device-uf-sparse'`) and produces failure rates
    statistically compatible with the dense kernel on the same seeds."""
    from qcss_tpu.experiments.logical import LogicalProgram

    prog = LogicalProgram(3, 2).cnot(0, 1)
    dense = prog.run(2e-3, batch=2048, seed=5, decoder="device-uf")
    sparse = prog.run(2e-3, batch=2048, seed=5, decoder="device-uf-sparse")
    assert sparse["samples"] == dense["samples"]
    # same shots, valid decoders: failure rates within a few per mille
    assert abs(sparse["word_fail"] - dense["word_fail"]) < 0.02
