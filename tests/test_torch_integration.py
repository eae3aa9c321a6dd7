"""The port's small core modules against the reference's, on the CPU:
`core/dbscan.py`, `core/integration.py`, the chunked planted generator
and the examples.

The contract is `tests/test_integration_dbscan.py`'s, held side by side:
- DBSCAN labels identical to the reference's on the same similarity
  matrices, and `msc_dbscan` labels identical on the reference's tensors;
- `collect_activation_tensor` and `routing_tensor` within 1e-6 (of the
  largest entry) of the reference's on the same numpy inputs, and the
  masks of `cluster_activations` and `cluster_experts` identical (router
  probabilities are synthetic: the port has no MoE router yet, ROADMAP
  item 12);
- the chunked generator's bounds and signal equal the reference's (its
  noise comes from a torch generator and cannot), and its slabs make a
  tensor of the planted shape;
- both examples run with `--device cpu`.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import MSCConfig as JConfig  # noqa: E402
from repro.core import PlantedSpec as JSpec  # noqa: E402
from repro.core import cluster_activations as jcluster_activations  # noqa: E402
from repro.core import cluster_experts as jcluster_experts  # noqa: E402
from repro.core import dbscan_from_similarity as jdbscan  # noqa: E402
from repro.core import make_planted_tensor as jplanted  # noqa: E402
from repro.core import make_planted_tensor_chunked as jchunked  # noqa: E402
from repro.core import msc_dbscan as jmsc_dbscan  # noqa: E402
from repro.core import routing_tensor as jrouting_tensor  # noqa: E402
from repro.core.integration import collect_activation_tensor as jcollect  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core import (MSCConfig, PlantedSpec,  # noqa: E402
                              cluster_activations, cluster_experts,
                              collect_activation_tensor,
                              dbscan_from_similarity,
                              make_planted_tensor_chunked, msc_dbscan,
                              routing_tensor)
from repro_torch.examples import msc_pipeline, quickstart  # noqa: E402

TOL = 1e-6


def _similarity(kind):
    if kind == "blocks":  # two clusters and a noise point
        c = np.eye(9)
        c[:4, :4] = 1.0
        c[4:8, 4:8] = 1.0
        return c
    if kind == "gate":  # too few points for min_samples
        c = np.eye(4)
        c[:2, :2] = 1.0
        return c
    rng = np.random.default_rng(int(kind[-1]))
    v = rng.normal(size=(30, 4))
    v[:10] += 4 * rng.normal(size=4)  # one dense group
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    return np.abs(v @ v.T)


@pytest.mark.parametrize("kind", ["blocks", "gate", "random0", "random1"])
@pytest.mark.parametrize("eps,min_samples", [(0.3, 3), (0.1, 2)])
def test_dbscan_labels_are_the_references(kind, eps, min_samples):
    c = _similarity(kind)
    np.testing.assert_array_equal(dbscan_from_similarity(c, eps, min_samples),
                                  jdbscan(c, eps, min_samples))


@pytest.mark.parametrize("m,gamma,seed", [(40, 80.0, 1), (30, 60.0, 2)])
def test_msc_dbscan_labels_are_the_references(m, gamma, seed):
    x = np.array(jplanted(jax.random.PRNGKey(seed), JSpec.paper(m, gamma)))
    want = jmsc_dbscan(jnp.asarray(x), JConfig(epsilon=1e-4), eps=0.4,
                       min_samples=3)
    got = msc_dbscan(bridge.tensor_from_numpy(x), MSCConfig(epsilon=1e-4),
                     eps=0.4, min_samples=3, device="cpu")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    planted = got[0][:m // 10]
    assert (planted == planted[0]).all() and planted[0] != -1


def _close(got, want):
    want = np.asarray(want, np.float64)
    err = (np.abs(np.asarray(got, np.float64) - want).max()
           / max(np.abs(want).max(), 1e-30))
    assert err <= TOL, err


def _activations():
    """Three near-identical layers and five independent ones."""
    rng = np.random.default_rng(0)
    base = rng.normal(size=(64, 32)).astype(np.float32)
    acts = [(40.0 * base + 0.5 * rng.normal(size=(64, 32))).astype(
        np.float32) for _ in range(3)]
    acts += [rng.normal(size=(2, 32, 32)).astype(np.float32)
             for _ in range(5)]
    return acts


def _router_probs():
    """Experts 0-2 fire on the same tokens in every layer."""
    rs = np.random.RandomState(0)
    probs = []
    for _ in range(6):
        logits = rs.randn(256, 12).astype(np.float32)
        logits[rs.rand(256) < 0.5, 0:3] += 8.0
        e = np.exp(logits - logits.max(axis=1, keepdims=True))
        probs.append((e / e.sum(axis=1, keepdims=True)).astype(np.float32))
    return probs


@pytest.mark.parametrize("max_tokens,max_features", [(512, 512), (40, 20)])
def test_collect_activation_tensor_is_the_references(max_tokens,
                                                     max_features):
    acts = _activations() + [np.full((2, 32, 32), 100.0, np.float32)]
    got = collect_activation_tensor(acts, max_tokens, max_features)
    want = jcollect([jnp.asarray(a) for a in acts], max_tokens, max_features)
    assert tuple(got.shape) == want.shape
    _close(got.numpy(), want)


@pytest.mark.parametrize("n_bins", [32, 7])
def test_routing_tensor_is_the_references(n_bins):
    probs = _router_probs()
    got = routing_tensor(probs, n_bins)
    want = jrouting_tensor([jnp.asarray(p) for p in probs], n_bins)
    assert tuple(got.shape) == want.shape == (6, 12, n_bins)
    _close(got.numpy(), want)


def test_cluster_activations_masks_are_the_references(tmp_path):
    acts = _activations()
    got = cluster_activations(acts, MSCConfig(epsilon=1e-4), device="cpu")
    want = jcluster_activations([jnp.asarray(a) for a in acts],
                                JConfig(epsilon=1e-4))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.mask.numpy(), np.asarray(w.mask))
    assert got[0].mask[:3].all() and not got[0].mask[3:].any()
    # over a mesh of one gloo rank: the flat schedule's masks, the same
    from repro_torch.launch import mesh as tmesh

    tmesh.join("cpu", rank=0, world_size=1, store_file=tmp_path / "store")
    try:
        on_mesh = cluster_activations(acts, MSCConfig(epsilon=1e-4),
                                      mesh=tmesh.make_msc_mesh("flat"))
    finally:
        tmesh.leave()
    for g, w in zip(on_mesh, got):
        assert torch.equal(g.mask, w.mask)


def test_cluster_experts_masks_are_the_references():
    probs = _router_probs()
    got = cluster_experts(probs, MSCConfig(epsilon=1e-4), n_bins=32,
                          device="cpu")
    want = jcluster_experts([jnp.asarray(p) for p in probs],
                            JConfig(epsilon=1e-4), n_bins=32)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.mask.numpy(), np.asarray(w.mask))
    assert got[1].mask[:3].all()


def _slabs(fn, key, spec, n_chunks):
    return [(lo, np.asarray(slab)) for lo, slab in fn(key, spec, n_chunks)]


@pytest.mark.parametrize("shape,n_chunks", [((20, 7, 9), 8), ((5, 6, 4), 8),
                                            ((31, 5, 5), 3)])
def test_chunked_generator_bounds_and_signal(shape, n_chunks):
    sizes = tuple(max(1, s // 5) for s in shape)
    spec, quiet = (PlantedSpec(shape, sizes, 30.0),
                   PlantedSpec(shape, sizes, 0.0))
    jspec, jquiet = JSpec(shape, sizes, 30.0), JSpec(shape, sizes, 0.0)
    gen = lambda: torch.Generator().manual_seed(4)  # noqa: E731
    got = _slabs(make_planted_tensor_chunked, gen(), spec, n_chunks)
    noise = _slabs(make_planted_tensor_chunked, gen(), quiet, n_chunks)
    key = jax.random.PRNGKey(4)
    want = _slabs(jchunked, key, jspec, n_chunks)
    want_noise = _slabs(jchunked, key, jquiet, n_chunks)
    assert [lo for lo, _ in got] == [lo for lo, _ in want]
    assert [s.shape for _, s in got] == [s.shape for _, s in want]
    for (_, g), (_, n), (_, w), (_, wn) in zip(got, noise, want, want_noise):
        np.testing.assert_allclose(g - n, w - wn, rtol=0, atol=1e-5)
    t = torch.cat([torch.from_numpy(s) for _, s in got])
    assert tuple(t.shape) == shape and torch.isfinite(t).all()


def test_quickstart_runs_on_the_cpu(capsys):
    assert quickstart.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "sequential == parallel: True" in out
    assert "recovery rate = 1.000" in out


def test_msc_pipeline_runs_on_the_cpu(capsys, tmp_path):
    path = tmp_path / "report.json"
    report = msc_pipeline.main(["--device", "cpu", "--m", "40", "--chunks",
                                "3", "--out", str(path)])
    assert report["recovery_rate"] == 1.0 and report["devices"] == 1
    assert report["cluster_sizes"] == [4, 4, 4]
    assert path.read_text().startswith("{")
    assert '"recovery_rate": 1.0' in capsys.readouterr().out
