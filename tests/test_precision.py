"""Contractions that must be exact on a GPU.

A float32 matmul on an H100 may run in TF32, which keeps 11 significant
bits: integers above 2^11 round. Every float32 contraction whose result
must be exact (or match the CPU to summation order) pins
``Precision.HIGHEST``; these tests check the pin in the lowered program
(on the CPU backend), the values against exact host arithmetic, and —
marked ``gpu`` — the same values on a card (`chip_smoke.py` runs the same
checks there).
"""

from __future__ import annotations

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from qcss_tpu.codes.families import rotated_surface
from qcss_tpu.decode import bp, device_sparse
from qcss_tpu.decode.mld import MLDecoder
from qcss_tpu.decode.uf import UFDecoder, graph_from_checks
from qcss_tpu.ops import gf2_jax


def unpinned_f32_dots(lowered) -> list[str]:
    """StableHLO dot_general lines with a float32 result and no HIGHEST
    precision."""
    out = []
    for line in lowered.as_text().splitlines():
        if "dot_general" not in line:
            continue
        if re.search(r"->\s*tensor<[^>]*xf32>", line) and "HIGHEST" not in line:
            out.append(line.strip())
    return out


def _heavy_graph(d=11, seed=0):
    """Code-capacity matching graph with odd weights in [231, 255]: its
    shortest paths exceed 2^11 and are odd, so TF32 would round them."""
    rng = np.random.default_rng(seed)
    code = rotated_surface(d)
    g = graph_from_checks(code.raw_parity_check_c2, code.z_operator_matrix())
    return g.__class__(
        num_nodes=g.num_nodes, edges=g.edges, edge_qubit=g.edge_qubit,
        edge_obs=g.edge_obs, n_qubits=g.n_qubits,
        edge_weight=(231 + 2 * rng.integers(0, 13, g.num_edges)
                     ).astype(np.uint8))


def _lower_sparse_fetch():
    g = _heavy_graph(5)
    t = device_sparse.build_sparse_tables(g)
    tables = (jnp.asarray(t.dist), jnp.asarray(t.phi.astype(np.int32)),
              jnp.asarray(t.bdist), jnp.asarray(t.bside.astype(np.int32)))
    dets = jnp.zeros((4, g.num_nodes), jnp.uint8)
    return jax.jit(device_sparse._fetch_geometry,
                   static_argnums=1).lower(tables, 8, dets)


def _lower_osde():
    h_t = jnp.zeros((30, 10), jnp.uint8)
    f = jax.jit(bp._osde_device_kernel, static_argnums=(3, 4, 5, 6))
    return f.lower(h_t, jnp.zeros((4, 10), jnp.uint8),
                   jnp.zeros((4, 30), jnp.float32), 30, 2, 4, 4)


def _lower_mld():
    ml = MLDecoder.for_code(rotated_surface(3), p=0.05)
    return jax.jit(ml._scorer()).lower(
        jnp.zeros((4, ml.n), jnp.uint8), jnp.zeros((4, ml.n), jnp.float32))


def _lower_bp_totals():
    h = np.asarray(rotated_surface(3).raw_parity_check_c2, np.uint8)
    dec = bp.BPDecoder(h, 0.02, iters=2, layout="dense")
    return dec._run.lower(jnp.zeros((4, h.shape[0]), jnp.uint8))


def _lower_mod2():
    return jax.jit(gf2_jax.mod2_matmul).lower(
        jnp.zeros((4, 7), jnp.uint8), jnp.zeros((7, 3), jnp.uint8))


@pytest.mark.parametrize("site", [
    _lower_sparse_fetch, _lower_osde, _lower_mld, _lower_bp_totals,
    _lower_mod2], ids=["sparse_fetch", "osde_word_select", "mld_scores",
                       "bp_totals", "mod2_matmul"])
def test_float32_contractions_pin_highest(site):
    lowered = site()
    assert "dot_general" in lowered.as_text()
    assert unpinned_f32_dots(lowered) == []


def test_mod2_matmul_has_no_int8_dot():
    """XLA's GPU int8 GEMM mis-summed tiny shapes; the GF(2) matmul must
    not use it."""
    text = _lower_mod2().as_text()
    assert not re.search(r"dot_general.*tensor<[^>]*xi8>", text)


def test_sparse_fetch_exact_above_2048():
    """The one-hot fetch returns the APSP entries exactly when they
    exceed 2^11 (odd, so TF32 could not hold them)."""
    g = _heavy_graph(11)
    t = device_sparse.build_sparse_tables(g)
    reach = t.dist[t.dist < device_sparse.UNREACH]
    assert reach.max() > 2048 and (reach % 2 == 1).any()
    tables = (jnp.asarray(t.dist), jnp.asarray(t.phi.astype(np.int32)),
              jnp.asarray(t.bdist), jnp.asarray(t.bside.astype(np.int32)))
    rng = np.random.default_rng(1)
    D = 12
    dets = (rng.random((64, g.num_nodes)) < 0.08).astype(np.uint8)
    dm, bdm, _, _, valid, _ = jax.device_get(
        jax.jit(device_sparse._fetch_geometry, static_argnums=1)(
            tables, D, dets))
    for b in range(64):
        nz = np.nonzero(dets[b])[0][:D]
        k = nz.size
        assert valid[b].sum() == k
        want = t.dist[nz[:, None], nz[None, :]]
        np.fill_diagonal(want, device_sparse.UNREACH)
        np.testing.assert_array_equal(dm[b, :k, :k], want)
        np.testing.assert_array_equal(bdm[b, :k], t.bdist[nz])


def test_sparse_decoder_large_distances_match_host():
    """Sparse decoding on a graph whose distances exceed 2048 agrees with
    host union-find on the same weights (exact on weight <= 1 errors,
    statistically on random ones)."""
    g = _heavy_graph(7, seed=3)
    code = rotated_surface(7)
    h = np.asarray(code.raw_parity_check_c2, np.uint8)
    lz = np.asarray(code.z_operator_matrix(), np.uint8)
    rng = np.random.default_rng(2)
    errs = (rng.random((512, h.shape[1])) < 0.03).astype(np.uint8)
    errs[:h.shape[1]] = np.eye(h.shape[1], dtype=np.uint8)
    syn = (errs @ h.T) & 1
    par = ((errs @ lz.T) & 1)[:, 0]
    dec = device_sparse.make_sparse_obs_decoder(g, d_max=24)
    obs, conv = jax.device_get(dec(jnp.asarray(syn)))
    _, obs_h = UFDecoder(g).decode_batch(syn, want_corrections=False)
    w1 = np.arange(h.shape[1])
    np.testing.assert_array_equal(obs[w1] & 1, par[w1])
    np.testing.assert_array_equal(np.asarray(obs_h)[w1] & 1, par[w1])
    assert conv.mean() > 0.99
    agree = np.mean((obs[conv] & 1) == (np.asarray(obs_h)[conv] & 1))
    assert agree > 0.95, agree


# -- on a card -----------------------------------------------------------


@pytest.mark.gpu
def test_contractions_exact_on_gpu(gpu_device):
    import chip_smoke

    with jax.default_device(gpu_device):
        out = chip_smoke.phase_contractions(gpu_device)
    assert out["sparse_fetch_entries"] > 0
