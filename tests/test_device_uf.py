"""Device union-find decoder vs the host kernel.

Exactness on all weight <= t errors (the unique-decoding regime, where
every valid matching decoder must agree on the observable), statistical
agreement with the host union-find at operating error rates, and
convergence on weighted (DEM) graphs.
"""

import jax
import numpy as np
import pytest

from qcss_tpu.codes.families import rotated_surface as surface_code
from qcss_tpu.decode.device_uf import DeviceUFDecoder, make_obs_decoder
from qcss_tpu.decode.uf import UFDecoder, graph_from_checks, spacetime_graph


def _surface_graph(d):
    code = surface_code(d)
    return graph_from_checks(
        code.raw_parity_check_c2, code.z_operator_matrix())


@pytest.mark.parametrize("d", [3, 5])
def test_exhaustive_low_weight_matches_host(d):
    code = surface_code(d)
    g = _surface_graph(d)
    h = np.asarray(code.raw_parity_check_c2, np.uint8)
    lz = np.asarray(code.z_operator_matrix(), np.uint8)
    n = h.shape[1]
    t = (d - 1) // 2
    from itertools import combinations

    errs = []
    for w in range(0, t + 1):
        for qs in combinations(range(n), w):
            e = np.zeros(n, np.uint8)
            e[list(qs)] = 1
            errs.append(e)
    errs = np.stack(errs)
    syn = (errs @ h.T) & 1
    par = ((errs @ lz.T) & 1)[:, 0].astype(np.uint32)

    _, obs_host = UFDecoder(g).decode_batch(syn, want_corrections=False)
    _, obs_dev = DeviceUFDecoder(g).decode_batch(syn)
    # both must decode every weight <= t error exactly
    np.testing.assert_array_equal(obs_host & 1, par)
    np.testing.assert_array_equal(obs_dev & 1, par)


def test_random_agreement_code_capacity():
    d = 7
    code = surface_code(d)
    g = _surface_graph(d)
    h = np.asarray(code.raw_parity_check_c2, np.uint8)
    rng = np.random.default_rng(7)
    errs = (rng.random((4096, h.shape[1])) < 0.05).astype(np.uint8)
    syn = (errs @ h.T) & 1
    _, obs_host = UFDecoder(g).decode_batch(syn, want_corrections=False)
    _, obs_dev = DeviceUFDecoder(g).decode_batch(syn)
    lz = np.asarray(code.z_operator_matrix(), np.uint8)
    par = ((errs @ lz.T) & 1)[:, 0]
    fail_host = np.mean((obs_host & 1) != par)
    fail_dev = np.mean((obs_dev & 1) != par)
    agree = np.mean((obs_host & 1) == (obs_dev & 1))
    # different valid corrections may disagree on heavy shots, but the
    # decoders must be statistically interchangeable
    assert agree > 0.97, agree
    assert abs(fail_host - fail_dev) < 0.01, (fail_host, fail_dev)


def test_spacetime_graph_agreement():
    d = 3
    code = surface_code(d)
    h = np.asarray(code.raw_parity_check_c2, np.uint8)
    lz = code.z_operator_matrix()
    g = spacetime_graph(h, lz, rounds=3)
    rng = np.random.default_rng(11)
    # sparse random detection events (valid and invalid patterns alike —
    # the decoder must terminate and agree statistically on both)
    dets = (rng.random((1024, g.num_nodes)) < 0.04).astype(np.uint8)
    _, obs_host = UFDecoder(g).decode_batch(dets, want_corrections=False)
    _, obs_dev = DeviceUFDecoder(g).decode_batch(dets)
    agree = np.mean((obs_host & 1) == (obs_dev & 1))
    assert agree > 0.95, agree


def test_weighted_dem_graph_converges_and_decodes():
    from qcss_tpu.decode.dem import circuit_level_graph, extraction_gate_list
    from qcss_tpu.experiments.memory import memory_experiment  # noqa: F401
    d = 3
    code = surface_code(d)
    raw = code.raw_parity_check_c2
    g = circuit_level_graph(
        raw, extraction_gate_list(code, raw), rounds=3,
        p_gate2=2e-3, p_meas=1e-2, p_reset=0.0,
        logicals=code.z_operator_matrix(),
    )
    rng = np.random.default_rng(3)
    dets = (rng.random((512, g.num_nodes)) < 0.03).astype(np.uint8)
    _, obs_host = UFDecoder(g).decode_batch(dets, want_corrections=False)
    _, obs_dev = DeviceUFDecoder(g).decode_batch(dets)
    agree = np.mean((obs_host & 1) == (obs_dev & 1))
    assert agree > 0.93, agree


def test_fused_memory_experiment_matches_host_dem():
    """decoder='device-dem' (one fused jit: sample + decode + count) must
    statistically match the host DEM decode of the same shots."""
    from qcss_tpu.experiments.memory import memory_experiment
    from qcss_tpu.sim.noise import NoiseModel

    code = surface_code(3)
    noise = NoiseModel(p_gate2=2e-3, p_meas=1e-2)
    host = memory_experiment(code, rounds=3, noise=noise, decoder="dem",
                             batch=8192, seed=5, engine="frames")
    dev = memory_experiment(code, rounds=3, noise=noise, decoder="device-dem",
                            batch=8192, seed=5, engine="frames")
    # identical samples (same key consumption), near-identical decoders
    assert abs(host["logical_fail"] - dev["logical_fail"]) * 8192 < 8, (
        host["logical_fail"], dev["logical_fail"])
    assert np.isnan(dev["residual_syndrome"])


def test_jit_composability():
    """The pure decoder embeds inside a larger jit without retracing."""
    import jax.numpy as jnp

    g = _surface_graph(3)
    dec = make_obs_decoder(g)

    @jax.jit
    def pipeline(dets):
        obs, conv = dec(dets)
        return obs.sum(), conv.all()

    dets = np.zeros((8, g.num_nodes), np.uint8)
    dets[0, 0] = 1
    s, c = pipeline(jnp.asarray(dets))
    assert bool(c)


def test_sharded_fused_pipeline():
    """The fused sample+decode pipeline inside a shard_map over the
    virtual mesh: one psum of failure counts is the only collective."""
    from qcss_tpu.parallel.mesh import ShardedFrameMemory, make_mesh
    from qcss_tpu.sim.noise import NoiseModel

    mem = ShardedFrameMemory(
        surface_code(3), NoiseModel(p_gate2=2e-3, p_meas=1e-2), make_mesh())
    res = mem.fused_error_rate(rounds=3, batch=4096, seed=5)
    assert res["decoder"] == "device-dem"
    assert res["logical_fail"] < 0.01, res


class TestPallasStencilKernels:
    """The shift-stencil kernel against the other device kernels and the
    host union-find: stencil and packed-gather kernels share the packed
    adoption rule (min over comp << L | lanes), so their labels must be
    BIT-IDENTICAL; the unpacked kernel breaks equal-comp ties by slot
    instead, so it and the host decoder agree statistically; on weight
    <= t errors all must decode exactly."""

    def _graph(self, d, rounds):
        code = surface_code(d)
        return spacetime_graph(
            np.asarray(code.raw_parity_check_c2, np.uint8),
            code.z_operator_matrix(), rounds=rounds)

    @pytest.mark.parametrize("d", [3, 5])
    def test_full_kernel_bit_identical(self, d):
        from qcss_tpu.decode.device_uf import (_decode_packed,
                                               _decode_stencil,
                                               _decode_unpacked,
                                               build_device_graph)

        g = self._graph(d, d)
        dg = build_device_graph(g)
        assert dg.stencil is not None
        rng = np.random.default_rng(3)
        dets = (rng.random((128, g.num_nodes)) < 0.03).astype(np.uint8)
        labs_x, conv_x = _decode_stencil(dg, dets)
        labs_p, _ = _decode_packed(dg, dets)
        labs_u, conv_u = _decode_unpacked(dg, dets)
        np.testing.assert_array_equal(np.asarray(labs_x[0]),
                                      np.asarray(labs_p[0]))
        assert bool(np.all(np.asarray(conv_x)))
        assert bool(np.all(np.asarray(conv_u)))
        obs_x = np.asarray(labs_x[0]) & 1
        _, obs_h = UFDecoder(g).decode_batch(dets, want_corrections=False)
        # random detector patterns (not error-generated) carry heavy
        # shots on which different valid matchings disagree
        assert np.mean(obs_x == (np.asarray(labs_u[0]) & 1)) > 0.85
        assert np.mean(obs_x == (np.asarray(obs_h) & 1)) > 0.85

    def test_full_kernel_dem_graph(self):
        """Weighted circuit-level DEM graph (7 offsets): delta-stepped
        growth is bit-identical across the stencil and packed-gather
        layouts, and agrees with the unpacked kernel."""
        from qcss_tpu.decode.dem import (circuit_level_graph,
                                         extraction_gate_list)
        from qcss_tpu.decode.device_uf import (_decode_packed,
                                               _decode_stencil,
                                               _decode_unpacked,
                                               build_device_graph)

        code = surface_code(3)
        raw = code.raw_parity_check_c2
        g = circuit_level_graph(
            raw, extraction_gate_list(code, raw), rounds=3,
            p_gate2=2e-3, p_meas=1e-2, p_reset=0.0,
            logicals=code.z_operator_matrix())
        dg = build_device_graph(g)
        assert dg.stencil is not None
        rng = np.random.default_rng(5)
        dets = (rng.random((128, g.num_nodes)) < 0.02).astype(np.uint8)
        labs_x, _ = _decode_stencil(dg, dets)
        labs_p, _ = _decode_packed(dg, dets)
        labs_u, _ = _decode_unpacked(dg, dets)
        np.testing.assert_array_equal(np.asarray(labs_x[0]),
                                      np.asarray(labs_p[0]))
        assert np.mean((np.asarray(labs_x[0]) & 1)
                       == (np.asarray(labs_u[0]) & 1)) > 0.95

    def test_weight_le_t_exactness(self):
        """All weight <= t errors decode exactly through the stencil
        kernel and the host decoder (code-capacity d=5)."""
        from itertools import combinations

        from qcss_tpu.decode.device_uf import (_decode_stencil,
                                               build_device_graph)

        d = 5
        code = surface_code(d)
        h = np.asarray(code.raw_parity_check_c2, np.uint8)
        lz = np.asarray(code.z_operator_matrix(), np.uint8)
        g = _surface_graph(d)
        dg = build_device_graph(g)
        assert dg.stencil is not None
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
        par = ((errs @ lz.T) & 1)[:, 0]
        labs, conv = _decode_stencil(dg, syn)
        np.testing.assert_array_equal(np.asarray(labs[0]) & 1, par)
        assert bool(np.all(np.asarray(conv)))
        _, obs_h = UFDecoder(g).decode_batch(syn, want_corrections=False)
        np.testing.assert_array_equal(np.asarray(obs_h) & 1, par)

    def test_spilled_chunk_lane_bit_identical(self):
        """Lanes too wide to pack beside the cluster id (a streaming
        window with two carry lanes) decode through the unpacked kernel:
        a lane and its duplicate must agree bit-for-bit in one decode."""
        from qcss_tpu.decode.device_uf import build_device_graph, \
            decode_labels
        from qcss_tpu.decode.streaming import _window_graph

        code = surface_code(5)
        h = np.asarray(code.raw_parity_check_c2, np.uint8)
        lz = np.asarray(code.z_operator_matrix(), np.uint8) & 1
        g, meta = _window_graph(h, lz, 8, True, None, None)
        kind, sl = meta[:, 0], meta[:, 1]
        carry = np.where((kind == 1) & (sl == 3),
                         np.int64(1) << meta[:, 2], 0)
        dg = build_device_graph(g, extra_lanes=(carry, carry))
        assert dg.pack_shift is None and dg.stencil is None
        rng = np.random.default_rng(9)
        dets = (rng.random((128, g.num_nodes)) < 0.02).astype(np.uint8)
        labs, conv = decode_labels(dg, dets)
        np.testing.assert_array_equal(np.asarray(labs[1]),
                                      np.asarray(labs[2]))
        assert bool(np.all(np.asarray(conv)))


class TestDecodeLabelsDispatch:
    """`decode_labels` picks its kernel from the graph alone."""

    @staticmethod
    def _spy(monkeypatch):
        from qcss_tpu.decode import device_uf as du

        called = []
        for name in ("_decode_stencil", "_decode_packed",
                     "_decode_unpacked"):
            real = getattr(du, name)

            def spy(*a, _real=real, _name=name, **k):
                called.append(_name)
                return _real(*a, **k)
            monkeypatch.setattr(du, name, spy)
        return du, called

    def test_wide_lanes_take_unpacked_kernel(self, monkeypatch):
        """log2(V) + lane bits > 30: the unpacked kernel decodes every
        lane (a 29-bit extra lane overflows the packed word)."""
        du, called = self._spy(monkeypatch)
        g = _surface_graph(3)
        wide = np.int64(1) << (np.arange(g.num_edges) % 9 + 20)
        dg = du.build_device_graph(g, extra_lanes=(wide,))
        assert dg.pack_shift is None
        dets = np.zeros((4, g.num_nodes), np.uint8)
        dets[1, 0] = 1
        labs, conv = du.decode_labels(dg, dets)
        assert called == ["_decode_unpacked"]
        assert len(labs) == 2 and bool(np.all(np.asarray(conv)))

    @pytest.mark.parametrize("stencil,kernel", [
        (None, "_decode_stencil"), (False, "_decode_packed")])
    def test_packable_graph_kernels(self, monkeypatch, stencil, kernel):
        du, called = self._spy(monkeypatch)
        g = _surface_graph(3)
        dg = du.build_device_graph(g, stencil=stencil)
        dets = np.zeros((4, g.num_nodes), np.uint8)
        dets[2, 1] = 1
        du.decode_labels(dg, dets)
        assert called == [kernel]
