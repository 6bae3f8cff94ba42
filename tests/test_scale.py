"""Scale validation: the reference's heavy integration tests
(ref: tests/real_world_pipeline.rs:192-286 hemisphere ICP ground-truth
recovery at reference scale, :422-479 2M-point scaling). Slow on CPU
(several minutes); run last in the suite."""

import numpy as np
import pytest

import pointclouds_jax as pc


def build_hemisphere(n, seed, radius):
    """Uniform upper-hemisphere samples (ref: real_world_pipeline.rs:58-80)."""
    rng = np.random.default_rng(seed)
    pts = []
    while len(pts) < n:
        p = rng.uniform(-1.0, 1.0, size=(n, 2)).astype(np.float32)
        r2 = (p**2).sum(axis=1)
        keep = p[r2 < 1.0]
        for px, py in keep:
            pts.append((px * radius, py * radius,
                        np.sqrt(1.0 - px * px - py * py) * radius))
            if len(pts) == n:
                break
    return np.asarray(pts, np.float32)


def test_icp_hemisphere_ground_truth_recovery():
    # Reference scale: 500 points, radius 5, ~2.9 deg rotation + small
    # translation; ICP must recover the inverse transform.
    target_pts = build_hemisphere(500, 99, 5.0)
    angle = 0.05
    c, s = np.cos(angle), np.sin(angle)
    rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    trans = np.array([0.3, -0.2, 0.1], np.float32)
    source_pts = target_pts @ rot.T + trans

    source = pc.PointCloud.from_numpy(np.ascontiguousarray(source_pts))
    target = pc.PointCloud.from_numpy(target_pts)
    result = pc.icp_point_to_point(
        source, target, max_iterations=100, tolerance=1e-6
    )
    assert result.converged
    assert result.rmse < 0.5
    recovered_t = np.asarray(result.translation)
    expected_t = -trans
    assert np.all(np.abs(recovered_t - expected_t) < 1.0)
    # rotation recovery: R_recovered ~ R^T
    recovered_r = np.asarray(result.rotation)
    assert np.allclose(recovered_r, rot.T, atol=0.05)


@pytest.mark.slow
def test_large_cloud_scaling_2m():
    # 2M uniform points, voxel -> SOR -> seeded RANSAC; asserts the chain
    # survives at scale with sane outputs (ref :422-479).
    n = 2_000_000
    rng = np.random.default_rng(12345)
    pts = np.column_stack(
        [
            rng.uniform(-100, 100, n),
            rng.uniform(-100, 100, n),
            rng.uniform(-2, 20, n),
        ]
    ).astype(np.float32)
    cloud = pc.PointCloud.from_numpy(np.ascontiguousarray(pts))
    ds = pc.voxel_downsample(cloud, 0.5)
    assert 0 < ds.len() < n

    cleaned = pc.statistical_outlier_removal(ds, 10, 2.0)
    assert 0 < cleaned.len() <= ds.len()

    plane = pc.ransac_plane_seeded(cleaned, 0.3, 200, 42)
    assert len(plane.inliers) > 0
