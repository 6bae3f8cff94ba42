"""chip_smoke.py off the card: it refuses to run without a GPU, and its
comparison helpers accept matching tiny inputs and reject perturbed ones.
Backend names that would select removed code raise ValueError."""

import os
import pathlib
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest

from pointclouds_jax.core.cloud import make_cloud_arrays
from pointclouds_jax.pipelines.aerial import aerial_pipeline
from pointclouds_jax.pipelines.kitti import kitti_obstacle_pipeline
from pointclouds_jax.pipelines.parity import canon_clusters, clusters_equal

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402


def _run_smoke(args, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, "chip_smoke.py", *args], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


@pytest.mark.parametrize("args", [[], ["--four-cards"]],
                         ids=["one-card", "four-cards"])
def test_smoke_fails_without_gpu(args):
    res = _run_smoke(args, REPO)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_smoke_fails_alone(tmp_path):
    """In a directory holding only the script it fails (no GPU here; on a
    card its first repo import fails)."""
    (tmp_path / "chip_smoke.py").write_text(
        (REPO / "chip_smoke.py").read_text()
    )
    res = _run_smoke([], tmp_path)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def _clusters(seed=0):
    rng = np.random.default_rng(seed)
    return [
        (rng.random((n, 3)) * 10).astype(np.float32) for n in (40, 25, 25, 12)
    ]


def test_clusters_equal_accepts_reordered_same_sets():
    a = _clusters()
    rng = np.random.default_rng(1)
    b = [c[rng.permutation(len(c))] for c in a[::-1]]
    assert clusters_equal(a, b)
    assert [len(c) for c in canon_clusters(b)] == [40, 25, 25, 12]


def test_clusters_equal_rejects_perturbed_point():
    a = _clusters()
    b = [c.copy() for c in a]
    b[2][3, 1] = np.nextafter(b[2][3, 1], np.float32(np.inf))
    assert not clusters_equal(a, b)
    # ...unless the caller allows an ULP through rounding.
    assert clusters_equal(a, b, decimals=4)


def test_clusters_equal_rejects_moved_member():
    a = _clusters()
    b = [c.copy() for c in a]
    b[1] = np.vstack([b[1], b[0][:1]])
    b[0] = b[0][1:]
    assert not clusters_equal(a, b)
    assert not clusters_equal(a, a[:-1])


def test_icp_pair_is_rigid():
    src, tgt, rot, t = chip_smoke.icp_pair(500)
    np.testing.assert_allclose(src @ rot.T + t, tgt, atol=1e-5)
    np.testing.assert_allclose(rot @ rot.T, np.eye(3), atol=1e-12)


def _aerial_case(seed=42, scale=0.03):
    import bench
    from pointclouds_jax.pipelines.scenes import aerial_scene

    arrs = make_cloud_arrays(aerial_scene(seed=seed, scale=scale))
    out = aerial_pipeline(
        *bench.aerial_args(arrs, 0),
        **dict(bench.AERIAL_KWARGS, ds_cap=arrs.capacity,
               obstacle_cap=arrs.capacity),
    )
    return out


def test_check_moments_accepts_pipeline_and_rejects_perturbed():
    import bench

    out = _aerial_case()

    def run(normals):
        rep = chip_smoke.Report("cpu")
        chip_smoke.check_moments(
            rep, out.centroids, out.downsampled_valid, normals,
            out.normals_ok, bench.AERIAL_PARAMS["normals_cell"], 15,
            bench.AERIAL_VIEWPOINT, 48, "aerial",
        )
        return rep.failed

    assert run(out.normals) == []
    tilted = jnp.asarray(out.normals) + jnp.float32([0.05, 0.0, 0.0])
    tilted = tilted / jnp.linalg.norm(tilted, axis=1, keepdims=True)
    assert run(tilted) == ["aerial.normals_match_f64"]


@pytest.mark.parametrize(
    "name", ["sweep_xla", "xla", "pallas", "pallas_interpret", "auto"]
)
def test_removed_kitti_backend_raises(name):
    arrs = make_cloud_arrays(np.zeros((10, 3), np.float32))
    with pytest.raises(ValueError, match="unknown backend"):
        kitti_obstacle_pipeline(
            arrs.xyz, arrs.valid, np.float32(0.15), np.float32(2.0),
            np.float32(0.15), 0, np.float32(0.8), sor_backend=name,
        )


@pytest.mark.parametrize("name", ["sweep_xla", "auto", "kernel"])
def test_removed_aerial_backend_raises(name):
    arrs = make_cloud_arrays(np.zeros((10, 3), np.float32))
    with pytest.raises(ValueError, match="unknown backend"):
        aerial_pipeline(
            arrs.xyz, arrs.valid, np.float32(0.5), np.float32(3.0),
            np.float32(0.3), 0, np.float32(2.0),
            jnp.asarray([0.0, 0.0, 100.0], jnp.float32), backend=name,
        )
